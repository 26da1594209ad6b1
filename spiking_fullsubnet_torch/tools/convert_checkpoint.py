"""Convert a reference torch checkpoint to the ``.npz`` weights both
packages load (counterpart of ``tools/convert_checkpoint.py``):

    python -m spiking_fullsubnet_torch.tools.convert_checkpoint \\
        --torch_ckpt model_zoo/.../pytorch_model.bin \\
        --config recipes/intel_ndns/spiking_fullsubnet_freeze_phase/baseline_m.toml \\
        --output baseline_m.npz [--device cuda|cpu]

The TOML's ``[model]`` (or ``[model_g]``) section gives the config; the
checkpoint is read onto ``--device`` (``cuda`` unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse

from ..runtime.config import toml_load
from ..runtime.convert import import_spiking_fullsubnet, load_torch_state_dict, save_npz
from ..runtime.registry import instantiate


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--config", required=True, help="experiment TOML providing [model]")
    p.add_argument("--output", required=True, help="output .npz path")
    p.add_argument("--device", default="cuda", help="where the checkpoint is read: cuda or cpu")
    args = p.parse_args(argv)

    cfg = toml_load(args.config)
    model_cfg = cfg.get("model") or cfg["model_g"]
    bundle = instantiate(model_cfg["path"],
                         args={"seed": 0, "device": args.device} | model_cfg["args"])
    sd = load_torch_state_dict(args.torch_ckpt, args.device)
    params, state = import_spiking_fullsubnet(sd, bundle["config"])
    save_npz(args.output, {"params": params, "state": state})
    print(f"Wrote {args.output}")


if __name__ == "__main__":
    main()
