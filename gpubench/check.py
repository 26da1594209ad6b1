"""The numbers that decide ``correct``: the checked utterances' enhanced
audio from the timed path against the plain reference's, each number held to
its limit. A cell's file (``cells/<cell>.json``) names the numbers it
compares under ``limits`` and gives their parameters.

The model is a spiking recurrent network: once one spike flips on a rounding
difference, that row's spike trains decorrelate, so two exact float32
computations (and float32 against float64) part after some frames, and a
pointwise comparison holds only over the start. Hence two kinds of number:

- ``enh_prefix_err``: the median over the utterances of the relative L2
  distance to the reference over each one's first ``prefix_samples``, where
  sound float32 agrees to round-off and a lower precision does not;
- ``enh_wave_err``: the same over the whole clip, for a cell whose rows stay
  together over most of it;
- ``enh_segment_rms_err``: the clip cut into segments of
  ``segment_samples``; per utterance and segment the gap between the
  program's RMS and the reference's, over the reference's RMS of the whole
  utterance; the median over the utterances, and the largest over the
  segments. Two float32 realisations that have parted still carry the same
  level in every segment; a segment that is lost, scaled or garbled in every
  row does not.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch


def rel_err_rows(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row ``||prog - ref|| / ||ref||`` in float64."""
    p, r = prog.double(), ref.double()
    return (p - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)


def prefix_err(prog: torch.Tensor, ref: torch.Tensor, cell: Dict[str, Any]) -> float:
    n = cell["prefix_samples"]
    return float(rel_err_rows(prog[:, :n], ref[:, :n]).median())


def wave_err(prog: torch.Tensor, ref: torch.Tensor, cell: Dict[str, Any]) -> float:
    return float(rel_err_rows(prog, ref).median())


def segment_rms_err(prog: torch.Tensor, ref: torch.Tensor, cell: Dict[str, Any]) -> float:
    def rms(x: torch.Tensor) -> torch.Tensor:
        return torch.stack([s.double().square().mean(-1).sqrt()
                            for s in x.split(cell["segment_samples"], dim=-1)], dim=1)

    whole = ref.double().square().mean(-1).sqrt().clamp_min(1e-30)
    gap = (rms(prog) - rms(ref)).abs() / whole[:, None]
    return float(gap.median(dim=0).values.max())


NUMBERS: Dict[str, Callable[[torch.Tensor, torch.Tensor, Dict[str, Any]], float]] = {
    "enh_prefix_err": prefix_err,
    "enh_wave_err": wave_err,
    "enh_segment_rms_err": segment_rms_err,
}


def serve_numbers(prog: torch.Tensor, ref: torch.Tensor, cell: Dict[str, Any]) -> Dict[str, float]:
    """The numbers the cell's file holds limits for, in its order."""
    return {k: NUMBERS[k](prog, ref, cell) for k in cell["limits"]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; a number without a limit is
    an error in the cell's file."""
    missing = [k for k in numbers if k not in limits]
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] and c["value"] == c["value"] for c in checks.values())
