"""Microbenchmark of one GSU layer: the plain scan against kernel D
(counterpart of ``tools/bench_gsu_kernel.py``):

    python -m spiking_fullsubnet_torch.tools.bench_gsu_kernel [--batch 64] [--time 512]
        [--hidden 320] [--input 320] [--no-shared] [--dtype float32|bfloat16]
        [--train] [--device cuda|cpu]

Forward: the plain scan (``ops/gsu.gsu_stack_apply``'s plain route, kernel
F's plain version over one layer) against kernel D with BN off (the kernel
that the JAX tool's ``gsu_layer_pallas`` runs), in µs a frame, with
``max|diff|`` of the spikes. With ``--train``, the gradient of ``sum(out²)``
through ``GSULayerTrain`` (kernels D, E and dW) against the plain scan's
autograd gradient. Kernels D, E and dW are also held against their plain
versions on identical inputs (the first ``CHECK_FRAMES`` frames: a rounding
flip at the threshold cascades along its row after that). Times come from
``runtime/timing.time_fn_per_iter``. On the CPU the kernels are their plain
versions.

``--t-blk`` is the JAX kernel's TPU time-block tiling. It has no
counterpart: kernels D and E lay out their blocks by ``train_plan``
(``ops/gsu_kernels.py``). It is accepted and ignored.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops import gsu_kernels as gk
from ..ops.gsu import GSULayerTrain, acc_dtype_for, gsu_layer_eval, gsu_stack_init
from ..runtime.timing import time_fn_per_iter
from ..runtime.device import resolve_device
from ._common import add_device

CHECK_FRAMES = 16


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--time", type=int, default=512)
    ap.add_argument("--hidden", type=int, default=320)
    ap.add_argument("--input", type=int, default=320)
    ap.add_argument("--t-blk", type=int, nargs="+", default=None,
                    help="the TPU kernel's time block: no counterpart (kernels D and E "
                         "take their layout from train_plan); ignored")
    ap.add_argument("--shared", action=argparse.BooleanOptionalAction, default=True,
                    help="--shared / --no-shared gate-cell weight tying")
    ap.add_argument("--train", action="store_true",
                    help="also time and check the gradient (kernels D, E and dW)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                    help="stream type")
    add_device(ap)
    return ap.parse_args(argv)


def build_inputs(args: argparse.Namespace, dev: torch.device):
    """(params, state, x): one GSU layer (``gsu_stack_init``, torch generator
    seeded 0, BN off) in the stream type, and ``x [T, B, F]`` from numpy's
    generator seeded 0."""
    dtype = getattr(torch, args.dtype)
    params, state = gsu_stack_init(torch.Generator().manual_seed(0), args.input, args.hidden, 1,
                                   shared_weights=args.shared, bn=False)
    params = {"layers": [{k: v.to(dev, dtype) for k, v in lp.items()}
                         for lp in params["layers"]]}
    x = np.random.default_rng(0).standard_normal((args.time, args.batch, args.input),
                                                 dtype=np.float32)
    return params, state, torch.from_numpy(x).to(dev, dtype)


def scan_forward(params, state, x, hidden: int, shared: bool) -> torch.Tensor:
    """The stack's spikes ``[T, B, H]`` on ``gsu_stack_apply``'s plain route
    (``stack_eval_x_plain``, what it runs on a CPU tensor), on any device."""
    packed = gk.pack_stack_x(params["layers"], state["layers"], hidden, x.dtype)
    return gk.stack_eval_x_plain(x, *packed, hidden, shared)[-1]


def layer_operands(params, x, hidden: int):
    """Kernel D's operands for the layer without BN: (xg in the stream type,
    W_hh^T, the bias as [2, H], the identity BN pair)."""
    lp = params["layers"][0]
    io, (T, B, F) = x.dtype, x.shape
    acc = acc_dtype_for(io)
    xg = (x.reshape(T * B, F).to(acc) @ lp["weight_ih"].to(acc).T).reshape(T, B, -1).to(io)
    whh = lp["weight_hh"].to(io).T.contiguous()
    b2 = lp["bias_ih"].to(acc).reshape(2, hidden).contiguous()
    bnp = torch.stack([torch.ones_like(b2[0]), torch.zeros_like(b2[0])])
    return xg, whh, b2, bnp


def kernel_forward(params, x, hidden: int, shared: bool) -> torch.Tensor:
    """The layer's spikes from kernel D with BN off (mode ``none``)."""
    xg, whh, b2, bnp = layer_operands(params, x, hidden)
    return gk.gsu_layer_train_fwd(xg, whh, b2, bnp, hidden, shared, "none")[0]


def _leaves(params) -> List[torch.Tensor]:
    lp = params["layers"][0]
    return [lp["weight_ih"], lp["weight_hh"], lp["bias_ih"]]


def _grad(loss_of, params) -> List[torch.Tensor]:
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    p = {"layers": [dict(zip(("weight_ih", "weight_hh", "bias_ih"), leaves))]}
    with torch.enable_grad():
        return list(torch.autograd.grad(loss_of(p), leaves))


def scan_grad(params, state, x, hidden: int, shared: bool) -> List[torch.Tensor]:
    """d sum(out²) / d (W_ih, W_hh, b) by autograd through the plain scan
    (``gsu_layer_eval``, the surrogate spike gradient)."""
    def loss(p):
        out = gsu_layer_eval(p["layers"][0], {}, x, hidden, shared)
        return (out.to(acc_dtype_for(x.dtype)) ** 2).sum()
    return _grad(loss, params)


def kernel_grad(params, x, hidden: int, shared: bool) -> List[torch.Tensor]:
    """The same gradient through ``GSULayerTrain`` (kernels D, E and dW)."""
    def loss(p):
        lp = p["layers"][0]
        acc = acc_dtype_for(x.dtype)
        T, B, F = x.shape
        xg = (x.reshape(T * B, F).to(acc) @ lp["weight_ih"].to(acc).T).reshape(T, B, -1)
        out, _ = GSULayerTrain.apply(xg.to(x.dtype), lp["weight_hh"], lp["bias_ih"], None, None,
                                     hidden, shared)
        return (out.to(acc) ** 2).sum()
    return _grad(loss, params)


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    den = ref.double().square().sum().sqrt().item()
    return (got.double() - ref.double()).square().sum().sqrt().item() / max(den, 1e-300)


def mismatch(got: torch.Tensor, ref: torch.Tensor) -> float:
    return (got.float() != ref.float()).float().mean().item()


def kernel_checks(params, x, hidden: int, shared: bool, train: bool) -> Dict[str, Any]:
    """Kernels D (and E and dW with ``train``) against their plain versions
    on identical inputs: D's spike mismatch over the whole sequence and its
    first ``CHECK_FRAMES`` frames and its membranes' largest error there;
    E's relative L2 on the first ``CHECK_FRAMES`` frames (D's outputs and
    the gradient of sum(out²) as its inputs), the largest over its four
    outputs; dW's relative L2 on E's plain dxg."""
    ops = layer_operands(params, x, hidden)
    spikes, y, stats = gk.gsu_layer_train_fwd(*ops, hidden, shared, "none")
    p_spikes, p_y, _ = gk.layer_train_fwd_plain(*ops, hidden, shared, "none")
    w = CHECK_FRAMES
    out = {"d_spike_mismatch": mismatch(spikes, p_spikes),
           "d_spike_mismatch_head": mismatch(spikes[:w], p_spikes[:w]),
           "d_y_max_abs_err_head": (y[:w].double() - p_y[:w].double()).abs().max().item()}
    if train:
        xg, whh, b2, bnp = ops
        gout = (2.0 * spikes.to(y.dtype)).to(xg.dtype)
        head = (xg[:w].contiguous(), y[:w].contiguous(), gout[:w].contiguous(),
                stats[:w].contiguous(), whh, b2, bnp, hidden, shared, "none")
        got, ref = gk.gsu_layer_train_bwd(*head), gk.layer_train_bwd_plain(*head)
        out["e_rel_l2_head"] = max(rel_l2(g, r) for g, r in zip(got, ref))
        out["dw_rel_l2_head"] = rel_l2(gk.gsu_train_dw(head[1], ref[0]),
                                       gk.train_dw_plain(head[1], ref[0]))
    return out


def run(argv=None) -> Dict[str, Any]:
    """Parse ``argv``, time and check; returns the numbers that ``main``
    prints, with the launches each kernel's wrapper counted in the timed
    runs (the checks against the plain versions come after)."""
    args = parse(argv)
    dev = resolve_device(args.device)
    H, T, shared = args.hidden, args.time, args.shared
    params, state, x = build_inputs(args, dev)
    counters = {"D": gk.gsu_layer_train_fwd, "E": gk.gsu_layer_train_bwd, "dW": gk.gsu_train_dw}
    before = {k: fn.launches for k, fn in counters.items()}
    calls = {"D": 0, "E": 0}  # the kernel calls this run made

    def counted(name, fn):
        def call(*a):
            calls[name] += 1
            if name == "E":
                calls["D"] += 1  # the loss's forward
            return fn(*a)
        return call

    res: Dict[str, Any] = {"shape": [T, args.batch, args.input, H], "dtype": args.dtype,
                           "shared": shared, "device": str(dev)}
    dt = time_fn_per_iter(lambda p, x: scan_forward(p, state, x, H, shared), (params, x))
    res["scan_fwd"] = {"us_per_frame": dt * 1e6 / T, "ms": dt * 1e3}
    ref = scan_forward(params, state, x, H, shared)
    kfwd = counted("D", lambda p, x: kernel_forward(p, x, H, shared))
    out = kfwd(params, x)
    dt = time_fn_per_iter(kfwd, (params, x))
    res["kernel_fwd"] = {"us_per_frame": dt * 1e6 / T, "ms": dt * 1e3,
                         "max_abs_diff": (out.double() - ref.double()).abs().max().item()}
    if args.train:
        ref_g = scan_grad(params, state, x, H, shared)
        dt = time_fn_per_iter(lambda p, x: scan_grad(p, state, x, H, shared), (params, x))
        res["scan_grad"] = {"us_per_frame": dt * 1e6 / T, "ms": dt * 1e3}
        kgrad = counted("E", lambda p, x: kernel_grad(p, x, H, shared))
        got_g = kgrad(params, x)
        dt = time_fn_per_iter(kgrad, (params, x))
        res["kernel_grad"] = {"us_per_frame": dt * 1e6 / T, "ms": dt * 1e3,
                              "rel_l2_vs_scan": [rel_l2(g, r) for g, r in zip(got_g, ref_g)]}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res["launches"] = {k: fn.launches - before[k] for k, fn in counters.items()}
    res["calls"] = {"D": calls["D"], "E": calls["E"], "dW": calls["E"]}
    res["checks"] = kernel_checks(params, x, H, shared, args.train)
    return res


def _line(name: str, r: Dict[str, float], extra: Optional[str] = None) -> str:
    return (f"{name:<20s} {r['us_per_frame']:8.3f} us/frame   total {r['ms']:.2f} ms"
            + (f"   {extra}" if extra else ""))


def main(argv=None) -> Dict[str, Any]:
    res = run(argv)
    print(f"GSU layer T, B, F, H = {res['shape']} {res['dtype']} shared={res['shared']} "
          f"on {res['device']}")
    print(_line("scan fwd:", res["scan_fwd"]))
    print(_line("kernel D fwd:", res["kernel_fwd"],
                f"max|diff|={res['kernel_fwd']['max_abs_diff']:.2e}"))
    if "scan_grad" in res:
        print(_line("scan grad:", res["scan_grad"]))
        print(_line("kernel D+E+dW grad:", res["kernel_grad"], "rel L2 vs scan " + ", ".join(
            f"{v:.2e}" for v in res["kernel_grad"]["rel_l2_vs_scan"])))
    print("against the plain versions: " + ", ".join(
        f"{k} {v:.3e}" for k, v in res["checks"].items()))
    print(f"launches {res['launches']} (calls {res['calls']})")
    return res


if __name__ == "__main__":
    main()
