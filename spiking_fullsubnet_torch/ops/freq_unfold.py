"""Frequency-axis unfolding into overlapping sub-band units, per section
and per bin (counterpart of ``spiking_fullsubnet_tpu/ops/freq_unfold.py``),
and the static gather
indices it reduces to (``_reflect_unfold_indices`` of
``spiking_fullsubnet_tpu/models/fused_forward.py:55-64``), which the
serving path folds into its one-hot layer-0 weights."""

from __future__ import annotations

import numpy as np
import torch


def reflect_unfold_indices(lo: int, hi: int, ctr: int, nbr: int, num_freqs: int) -> np.ndarray:
    """Gather indices ``[N, ctr + 2 nbr]`` of the section's reflect-padded
    frequency unfold, directly into the full ``[num_freqs]`` axis."""
    n = (hi - lo) // ctr
    width = ctr + 2 * nbr
    pos = lo - nbr + np.arange(n)[:, None] * ctr + np.arange(width)[None, :]
    pos = np.abs(pos)  # left reflect around bin 0
    over = pos - (num_freqs - 1)
    return np.where(over > 0, (num_freqs - 1) - over, pos)  # right reflect


def freq_unfold(x: torch.Tensor, lower_cutoff_freq: int, upper_cutoff_freq: int,
                ctr_freq: int, nbr_freq: int, num_freqs: int = 0) -> torch.Tensor:
    """``[B, C, F, T] -> [B, N, C, ctr + 2 nbr, T]``, N = section width /
    ctr: unit n reads the bins ``lo - nbr + n ctr ...`` of the section,
    reflect-padded at the spectrum's edges (``freq_unfold.py:15``), as one
    gather. With ``num_freqs`` the edges are those of a ``num_freqs``-bin
    spectrum whatever F is, and an index past a narrower ``x`` reads its last
    bin: the fused forward's gather of the tiled fullband output, which JAX
    clamps (``fused_forward.py:255-266, 313-324``)."""
    c, width = x.shape[1], x.shape[2]
    if c != 1:
        raise ValueError("Only mono audio is supported.")
    if (upper_cutoff_freq - lower_cutoff_freq) % ctr_freq != 0:
        raise ValueError(
            f"Section width must be divisible by ctr_freq: {ctr_freq=}, "
            f"{upper_cutoff_freq=}, {lower_cutoff_freq=}")
    idx = reflect_unfold_indices(lower_cutoff_freq, upper_cutoff_freq, ctr_freq, nbr_freq,
                                 num_freqs or width)
    if num_freqs:
        idx = np.minimum(idx, width - 1)
    out = x[:, :, torch.as_tensor(idx, device=x.device), :]  # [B, C, N, width, T]
    return out.transpose(1, 2)


def freq_unfold_per_bin(x: torch.Tensor, num_neighbors: int) -> torch.Tensor:
    """``[B, C, F, T] -> [B, F, C, 2 n + 1, T]``: every bin a sub-band unit
    of its ``n`` neighbours on each side, reflect-padded at the spectrum's
    edges (``freq_unfold.py:61-74``), as one gather."""
    b, c, f, t = x.shape
    if num_neighbors <= 0:
        return x.transpose(1, 2).reshape(b, f, c, 1, t)
    idx = reflect_unfold_indices(0, f, 1, num_neighbors, f)  # [F, 2 n + 1]
    return x[:, :, torch.as_tensor(idx, device=x.device), :].transpose(1, 2)
