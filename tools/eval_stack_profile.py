#!/usr/bin/env python3
"""Times kernels A and F (spiking_fullsubnet_torch/csrc/gsu_stack_eval.cu,
gsu_stack_eval_x.cu: one kernel, csrc/gsu_eval_stack.cuh) side by side on one
GPU, each with its phase profile, at two bench shapes of PERF.md section 4
(batch 256 x 30 s, T = 3751, bf16, random weights and inputs from a seed):

    python3 tools/eval_stack_profile.py [T]

the fullband (A at zoo M served's 256 rows x 320 units, F at zoo M layered's
256 rows x 64 features -> 320) and section 0 (A in the collect path's units
form, 8 units x 256 rows x 224, every layer out; F at 2048 rows x 38
features -> 224). Each line is one JSON object: each kernel's milliseconds
(CUDA events, after one warm-up launch) and its SM cycles a step in each
phase beside its plan (gk.stack_profile, gk.stack_x_profile).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the port, beside tools/
from spiking_fullsubnet_torch.ops import gsu_kernels as gk  # noqa: E402
from tools.eval_plan_sweep import layers, ms  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("eval_stack_profile: no CUDA device", file=sys.stderr)
        return 2
    T = int(sys.argv[1]) if len(sys.argv) > 1 else 3751
    dev, io = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    for name, U, R, H, fin in [("fullband", 1, 256, 320, 64), ("section 0", 8, 256, 224, 38)]:
        lay, st = layers(g, H, 2, H)
        wihr, whh, coef = (t.to(dev) for t in gk.pack_stack(lay, st, H, io))
        xg0 = (torch.randn((U, T, R, H) if U > 1 else (T, R, H), generator=g) * 0.5).to(io).to(dev)
        a_args = (xg0, wihr, whh, coef, H, True, U > 1)
        a_prof = gk.stack_profile(*a_args)
        a_ms = ms(lambda: gk.gsu_stack_eval(*a_args))
        del xg0, a_args
        lay, st = layers(g, H, 2, fin)
        w = [t.to(dev) for t in gk.pack_stack_x(lay, st, H, io)]
        x = torch.rand(T, U * R, fin, generator=g).to(io).to(dev)
        f_prof = gk.stack_x_profile(x, *w, H, True)
        f_ms = ms(lambda: gk.gsu_stack_eval_x(x, *w, H, True))
        del x
        print(json.dumps({"stack": name, "A_ms": a_ms, "A": a_prof, "F_ms": f_ms, "F": f_prof}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
