"""Times the stream-path train steps of zoo M and flagship M (64 x 6 s,
bf16, three repeats of chip_smoke.py's time_train with three timed steps)
for the checkout in the working directory, on one GPU:

    python3 <path>/tools/stream_train_timing.py <tag>

To compare two commits, run it in a checkout of each within one call on
one card, in turns (parent, change, change, parent); the kernels' build
directory (spiking_fullsubnet_torch/_build) can be copied from one
checkout to the other when their csrc/ is the same. Prints one line:
the tag, the card's name and power limit, and per model the [forward,
backward, total] ms of each repeat."""
import json
import sys
from dataclasses import replace

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from spiking_fullsubnet_torch.models.presets import flagship_m  # noqa: E402
from spiking_fullsubnet_torch.models.spiking_fullsubnet import (  # noqa: E402
    SpikingFullSubNet, separator_config, spiking_fullsubnet_apply)
from spiking_fullsubnet_torch.ops import gsu_kernels as gk  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
gk.build_kernels()
dev = torch.device("cuda")
base = replace(separator_config(norm_type="offline_laplace_norm", shared_weights=True, bn=True),
               scan_mode="auto", collect_layer_outputs=False)
model = SpikingFullSubNet.from_npz(str(cs.ZOO_M), base, device=dev)
flag_base = flagship_m(seed=0, device=dev, scan_mode="auto", collect_layer_outputs=False)["config"]
flag = SpikingFullSubNet.from_init(flag_base, seed=0, device=dev)
_, _, tb_noisy, tb_clean = cs.training_batches(dev)
res = {}
for rep in range(3):
    for name, cfg, m in [("zoo M stream", replace(base, compute_dtype="bfloat16"), model),
                         ("flagship M stream", replace(flag_base, compute_dtype="bfloat16"), flag)]:
        t = cs.time_train(spiking_fullsubnet_apply, cfg, m.param_tree(), m.state_tree(),
                          tb_noisy, tb_clean, cs.train_launches(8), iters=3)
        res.setdefault(name, []).append([round(t["forward_ms"], 3), round(t["backward_ms"], 3),
                                         round(t["total_ms"], 3)])
print(sys.argv[1], cs.card_name(), json.dumps(res), flush=True)
