#!/usr/bin/env python3
"""Times kernels A, B and F (spiking_fullsubnet_torch/csrc/gsu_stack_eval.cu,
gsu_sections_eval.cu, gsu_stack_eval_x.cu) on one GPU under each plan they
can take, at the bench shapes of PERF.md section 4 (batch 256 x 30 s,
T = 3751, bf16) with random weights and inputs from a seed:

    python3 tools/eval_plan_sweep.py [T]

A at zoo M served's fullband (256 rows x 320 units, the last layer out) and
at the collect path's four launches (flagship M: the fullband, then its
sections' units forms of 8, 3 and 2 units x 256 rows x 224, every layer
out), and F at zoo M layered's four stacks and cIRM-GSN's stack, for every
forced (columns a block, blocks a cluster) of ops/gsu_kernels.stack_x_plan
that puts at most two blocks on each of the card's SMs; B at zoo M's three sections
(8, 3 and 2 units of 2 x 224, per-utterance unit scales, the deep filter)
for every forced number of columns a block of sections_plan. Each line is
one JSON object: the shape, the plan and its milliseconds (CUDA events,
after one warm-up launch), the default plan marked.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the port, beside tools/
from spiking_fullsubnet_torch.ops import gsu_kernels as gk  # noqa: E402


def ms(fn, iters=2):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def layers(g, H, L, fin):
    out = []
    for k in range(L):
        n_in = fin if k == 0 else H
        out.append({"weight_ih": torch.randn(H, n_in, generator=g) / n_in ** 0.5,
                    "weight_hh": torch.randn(H, H, generator=g) / H ** 0.5,
                    "bias_ih": torch.randn(2 * H, generator=g) * 0.1})
    return out, [{} for _ in out]


def sweep_stack(kernel, name, shape, launch, plan_of):
    """One line a plan: ``plan_of(**kw)`` forced to every (N, cs) that
    fits, ``launch(plan)`` timed."""
    default = plan_of()
    for N in gk.STACK_X_COLS:
        for cs in gk.STACK_X_CLUSTERS:
            try:
                plan = plan_of(cols=N, cluster=cs)
            except ValueError:
                continue
            if plan["blocks"] > 2 * gk._sm_count(0):
                continue
            print(json.dumps({"kernel": kernel, "stack": name, "shape": shape, "N": N, "cs": cs,
                              "blocks": plan["blocks"],
                              "default": (N, cs) == (default["N"], default["cs"]),
                              "ms": ms(lambda: launch(plan))}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("eval_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    T = int(sys.argv[1]) if len(sys.argv) > 1 else 3751
    dev, io = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    sms = gk._sm_count(0)
    for name, U, R, H, collect in [("zoo M served fullband", 1, 256, 320, False),
                                   ("collect fullband", 1, 256, 320, True),
                                   ("collect section 0", 8, 256, 224, True),
                                   ("collect section 1", 3, 256, 224, True),
                                   ("collect section 2", 2, 256, 224, True)]:
        lay, st = layers(g, H, 2, H)
        wihr, whh, coef = (t.to(dev) for t in gk.pack_stack(lay, st, H, io))
        shape = (U, T, R, H) if U > 1 else (T, R, H)
        xg0 = (torch.randn(shape, generator=g) * 0.5).to(io).to(dev)
        sweep_stack("A", name, list(shape), lambda plan: gk._stack_a_launch(
            xg0, wihr, whh, coef, H, True, collect, plan),
            lambda **kw: gk._stack_a_plan(xg0, H, 2, True, **kw))
        del xg0
    for name, R, F, H in [("zoo M fullband", 256, 64, 320), ("zoo M section 0", 2048, 38, 224),
                          ("zoo M section 1", 768, 94, 224), ("zoo M section 2", 512, 158, 224),
                          ("cIRM-GSN", 256, 257, 256)]:
        lay, st = layers(g, H, 2, F)
        w = [t.to(dev) for t in gk.pack_stack_x(lay, st, H, io)]
        x = torch.rand(T, R, F, generator=g).to(io).to(dev)
        args = (x, *w, H, True)
        sweep_stack("F", name, [T, R, F, H], lambda plan: gk._stack_x_launch(*args, plan),
                    lambda **kw: gk.stack_x_plan(R, F, H, 2, True, io, sms=sms, **kw))
        del x
    B, H = 256, 224
    secs = []
    for n, aw, ctr, df, a0 in [(8, 34, 4, 5, 0), (3, 62, 32, 3, 17), (2, 94, 64, 1, 97)]:
        lay, st = layers(g, H, 2, H)
        wihr, whh, coef = gk.pack_stack(lay, st, H, io)
        P = 2 * df * ctr
        secs.append({"wa": (torch.randn(n, aw, H, generator=g) * 0.3).to(io).to(dev), "a0": a0,
                     "wb": (torch.randn(n, 64, H, generator=g) * 0.3).to(io).to(dev),
                     "wihr": wihr.to(dev), "whh": whh.to(dev), "coef": coef.float().to(dev),
                     "wproj": (torch.randn(H, P, generator=g) * 0.2).to(io).to(dev),
                     "bproj": (torch.randn(P, generator=g) * 0.1).to(dev), "ctr": ctr, "df": df})
    xa = torch.rand(T, B, 256, generator=g).to(io).to(dev)
    xb = torch.randn(T, B, 64, generator=g).to(io).to(dev)
    alpha = (torch.rand(B, 13, generator=g) + 0.5).to(dev)
    sre, sim = (torch.randn(T, B, 257, generator=g).to(dev) for _ in range(2))
    args = (secs, xa, xb, alpha, sre, sim, H, True, None)
    d = gk._sec_dims(secs, 64, H, True)
    default = gk.sections_plan(d, B, io, sms=sms)
    for cols in range(8, gk.EVAL_MAX_N + 1, 8):
        try:
            plan = gk.sections_plan(d, B, io, sms=sms, cols=cols)
        except ValueError:
            continue
        if plan["blocks"] > 2 * sms:
            continue
        print(json.dumps({"kernel": "B", "shape": [T, B, 13, H], "cols": cols,
                          "blocks": plan["blocks"], "default": cols == default["cols"],
                          "tiles": [(p["rt"], p["nbm"]) for p in plan["secs"]],
                          "ms": ms(lambda: gk._sections_launch(*args, plan))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
