"""Runner ``serve``: offline enhancement, one client in a closed loop. Each
batch is submitted when the previous one's output is ready; with
``seconds`` 0 each pool batch runs once, untimed.

``run`` returns the window's numbers and the program's answers: the enhanced
audio of ``check_rows`` utterances of each pool batch, drawn from the seed.
``fault`` plants a fault in the timed path for the checks' own tests and
readings: ``answer_altered`` (the answer is the input), ``late_zero`` and
``late_half`` (the last third of every answer zeroed or halved where it is
produced), ``state_reset`` (each clip run as two halves, the state dropped
at the middle).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any, Dict, List, Optional

import torch

from .. import check, reference, traffic, weights
from ..harness import Cell, make_weights, profiler, program_config, sync

FAULTS = ("answer_altered", "late_zero", "late_half", "state_reset")


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        fault: Optional[str] = None) -> Dict[str, Any]:
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import spiking_fullsubnet_apply

    if cell.chips != 1:
        raise SystemExit(f"{cell.name}: the serve runner drives one chip, not {cell.chips}")
    t = cell.traffic
    cfg = program_config(cell, "serve")
    params, state = make_weights(cell, seed, device)
    ref_weights = (weights.clone(params), weights.clone(state))
    pool = traffic.make_pool(t, seed, device)
    gen = torch.Generator().manual_seed(weights.seed_of(seed, "check"))
    rows = [torch.randperm(b["noisy"].shape[0], generator=gen)[:t["check_rows"]] for b in pool]

    def apply(x: torch.Tensor) -> torch.Tensor:
        return spiking_fullsubnet_apply(cfg, params, state, x, train=False)["enhanced_y"]

    def forward(x: torch.Tensor) -> torch.Tensor:
        if fault == "answer_altered":
            return x.clone()
        if fault == "state_reset":
            h = x.shape[-1] // 2
            return torch.cat([apply(x[:, :h]), apply(x[:, h:])], dim=-1)
        y = apply(x)
        if fault in ("late_zero", "late_half"):
            y[:, 2 * y.shape[-1] // 3:] *= 0.0 if fault == "late_zero" else 0.5
        return y

    # warm-up: every shape the pool holds, twice
    seen = set()
    for b, r in zip(pool, rows):
        if tuple(b["noisy"].shape) not in seen:
            seen.add(tuple(b["noisy"].shape))
            for _ in range(2):
                forward(b["noisy"].to(device)).index_select(0, r.to(device))
    rows = [r.to(device) for r in rows]
    sync(device)
    kept: List[Optional[torch.Tensor]] = [None] * len(pool)
    lat: List[float] = []
    shapes: List[tuple] = []
    audio = 0.0
    out: Dict[str, Any] = {"t_window": time.perf_counter()}
    with (profiler(device) if trace else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        i = 0
        while True:
            p = i % len(pool)
            b = pool[p]
            ts = time.perf_counter()
            y = forward(b["noisy"].to(device, non_blocking=True))
            kept[p] = y.index_select(0, rows[p])
            if b["noisy"].device != y.device:
                y = y.to(b["noisy"].device)  # a host-resident answer goes back to the host
            sync(device)
            te = time.perf_counter()
            lat.append(te - ts)
            shapes.append(tuple(b["noisy"].shape))
            audio += b["audio_s"]
            i += 1
            if (te - t0 >= seconds and i >= len(pool)) or (seconds == 0 and i == len(pool)):
                break
        window = te - t0
    out.update(units=i, window_s=window, prof=prof, audio_s_per_s=audio / window, shapes=shapes,
               e2e={"enhance_audio_s_per_s": audio / window,
                    "enhance_batch_ms_p50": statistics.median(lat) * 1e3})
    out["peak"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    inputs = [b["noisy"].index_select(0, r.to(b["noisy"].device)).to(device)
              for b, r in zip(pool, rows)]
    del pool, params, state, y
    answers = torch.cat(kept)
    del kept

    def ref_answers(ops: reference.Ops) -> torch.Tensor:
        p_ref, s_ref = ref_weights
        with torch.no_grad():
            return torch.cat([reference.forward(cell.geom, p_ref, s_ref, x, ops=ops)
                              for x in inputs])

    out["answers"] = answers
    out["reference"] = ref_answers
    out["compare"] = lambda a, b: check.serve_numbers(a, b, cell.check)
    return out
