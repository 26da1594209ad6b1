"""Profile the flagship forward and train step under ``torch.profiler``
(counterpart of ``tools/profile_trace.py``):

    python -m spiking_fullsubnet_torch.tools.profile_trace [--batch 8] [--seconds 2]
        [--train-batch N] [--train-seconds S] [--skip-train] [--trace-dir DIR]
        [--scan-mode auto] [--compute-dtype bfloat16|none] [--serving]
        [--summary FILE.md] [--device cuda|cpu]

Flagship M (``models/presets.flagship_m``, random weights from seed 0): the
eval forward (on the card with ``--serving``: kernel C, the monolith) and
the train step (the value and gradient of an L1 loss, no optimizer: on the
card kernels D, E and dW on every GSU layer), each once outside the
profiler (builds, allocator) and once inside it, with CPU and CUDA
activities. ``--trace-dir`` receives each one's Chrome trace
(``forward.json``, ``train_step.json``; open with Perfetto or
chrome://tracing). ``--summary`` writes a markdown table of each from
``key_averages()``: self device ms, calls and name of the top 25 ops and
kernels (self CPU ms on the CPU). The analytic cost comes from
``runtime/roofline``.

The JAX tool also prints XLA's ``cost_analysis`` of the compiled programs;
eager PyTorch compiles no program, so that line has no counterpart here.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..models.presets import flagship_m
from ..nn.core import tree_map
from ..ops import gsu_kernels as gk
from ..runtime.roofline import spiking_fullsubnet_cost
from ..runtime.device import resolve_device
from ._common import add_device

SR = 16000
TOP_N = 25
# each kernel's wrapper in ops/gsu_kernels -> the name of its __global__
# function, as a profiler row names it
KERNEL_ROWS = {"sfsb_monolith_serve": "monolith_kernel", "gsu_stack_eval": "stack_kernel",
               "gsu_stack_eval_x": "stack_kernel", "gsu_sections_eval": "sections_kernel",
               "gsu_layer_train_fwd": "train_fwd_kernel", "gsu_layer_train_bwd": "train_bwd_kernel",
               "gsu_train_dw": "train_dw_kernel"}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--train-batch", type=int, default=None,
                    help="train-step batch (default --batch; the serving batch 256 x 30 s "
                         "does not fit the train step's saved activations)")
    ap.add_argument("--train-seconds", type=float, default=None)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--scan-mode", default="auto")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--serving", action="store_true",
                    help="serving config: collect_layer_outputs=False (the monolith on the card)")
    ap.add_argument("--summary", default=None,
                    help="write a markdown table of each profile's top ops")
    add_device(ap)
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> Dict[str, int]:
    return {name: getattr(gk, name).launches for name in KERNEL_ROWS}


def profile_rows(prof, on_card: bool) -> Tuple[List[Tuple[str, float, int]], float]:
    """(name, self ms, calls) of every op and kernel the profile saw, by
    self device time on the card (self CPU time on the CPU), largest first;
    and the total ms. On the card an op that launches a kernel shows that
    kernel's time as its own too, so the total counts the kernels' rows
    only."""
    from torch.autograd import DeviceType

    rows, total = [], 0.0
    for ev in prof.key_averages():
        ms = (ev.self_device_time_total if on_card else ev.self_cpu_time_total) / 1e3
        rows.append((ev.key, ms, int(ev.count)))
        if not on_card or ev.device_type == DeviceType.CUDA:
            total += ms
    rows.sort(key=lambda r: -r[1])
    return rows, total


def profiled(name: str, fn, dev: torch.device, trace_dir) -> Dict[str, Any]:
    """Run ``fn`` once to warm up, then once under the profiler: its rows and
    total ms, the kernel launches each wrapper counted in the profiled run,
    and the Chrome trace's path."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    before = _launches()
    with profile(activities=acts) as prof:
        fn()
        _sync(dev)
    after = _launches()
    rows, total = profile_rows(prof, dev.type == "cuda")
    out = {"rows": rows, "total_ms": total,
           "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}
    if trace_dir:
        path = Path(trace_dir) / f"{name}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        out["trace"] = str(path)
    return out


def write_trace_summary(profiles: Dict[str, Dict[str, Any]], out_path, run_args: Dict,
                        on_card: bool, top_n: int = TOP_N) -> None:
    """A markdown table of each profile's top ``top_n`` rows: self ms, calls,
    name."""
    unit = "self CUDA ms" if on_card else "self CPU ms"
    lines = ["# Flagship M profile (torch.profiler key_averages)", "",
             "Run: `python -m spiking_fullsubnet_torch.tools.profile_trace "
             + " ".join(f"--{k.replace('_', '-')}" + ("" if v is True else f" {v}")
                        for k, v in run_args.items()
                        if v not in (None, False) and k != "summary") + "`", ""]
    for name, prof in profiles.items():
        lines += [f"## {name}", "", f"Total {unit}: **{prof['total_ms']:.3f}**; kernel launches "
                  f"counted by the wrappers: {prof['launches']}", "",
                  f"| {unit} | calls | op |", "|---|---|---|"]
        for op, ms, calls in prof["rows"][:top_n]:
            lines.append(f"| {ms:.3f} | {calls} | `{op[:110].replace('|', chr(92) + '|')}` |")
        lines.append("")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text("\n".join(lines))


def kernel_calls(rows: List[Tuple[str, float, int]], wrapper: str) -> int:
    """The calls of the rows whose name holds ``wrapper``'s kernel."""
    return sum(calls for op, _, calls in rows if KERNEL_ROWS[wrapper] in op)


def main(argv=None) -> Dict[str, Any]:
    args = parse(argv)
    dev = resolve_device(args.device)
    bundle = flagship_m(device=dev, scan_mode=args.scan_mode,
                        compute_dtype=None if args.compute_dtype == "none" else args.compute_dtype,
                        collect_layer_outputs=not args.serving)
    cfg, apply_fn = bundle["config"], bundle["apply"]
    params, state = bundle["params"], bundle["state"]
    noisy = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (args.batch, int(args.seconds * SR))) * 0.1).astype(np.float32)).to(dev)
    tb, tsec = args.train_batch or args.batch, args.train_seconds or args.seconds
    t_noisy = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (tb, int(tsec * SR))) * 0.1).astype(np.float32)).to(dev)
    t_clean = t_noisy * 0.5

    cost = spiking_fullsubnet_cost(cfg, SR)
    audio_seconds = args.batch * args.seconds
    res: Dict[str, Any] = {"device": str(dev), "analytic": {
        "gflop_per_audio_second": cost.flops_per_audio_second() / 1e9,
        "gflop_this_run": cost.flops_per_audio_second() * audio_seconds / 1e9}}
    print(f"analytic model cost: {res['analytic']['gflop_per_audio_second']:.3f} GFLOP / "
          f"audio-second ({res['analytic']['gflop_this_run']:.2f} GFLOP this run)")

    def forward():
        with torch.no_grad():
            return apply_fn(cfg, params, state, noisy, train=False)["enhanced_y"]

    def train_step():
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            out = apply_fn(cfg, leaves, state, t_noisy, train=True)
            loss = (out["enhanced_y"] - t_clean).abs().mean()
            flat = []
            tree_map(flat.append, leaves)
            return loss.detach(), torch.autograd.grad(loss, flat), out["state"]

    targets = {"forward": forward}
    if not args.skip_train:
        targets["train_step"] = train_step
    res["profiles"] = {name: profiled(name, fn, dev, args.trace_dir)
                       for name, fn in targets.items()}
    for name, prof in res["profiles"].items():
        print(f"[{name}] launches {prof['launches']}; top ops: " + "; ".join(
            f"{op[:60]} {ms:.3f} ms x{calls}" for op, ms, calls in prof["rows"][:5]))
    if args.trace_dir:
        print(f"profiler traces written to {args.trace_dir}")
    if args.summary:
        write_trace_summary(res["profiles"], args.summary, vars(args), dev.type == "cuda")
        print(f"per-op summary written to {args.summary}")
    return res


if __name__ == "__main__":
    main()
