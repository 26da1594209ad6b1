"""Static unfold indices (counterpart of ``_reflect_unfold_indices`` in
``spiking_fullsubnet_tpu/models/fused_forward.py:55-64``). The fused
single-scan forward itself is not ported yet (ROADMAP queue 1, item 12)."""

from __future__ import annotations

import numpy as np


def _reflect_unfold_indices(lo: int, hi: int, ctr: int, nbr: int, num_freqs: int) -> np.ndarray:
    """Gather indices ``[N, ctr + 2 nbr]`` of the section's reflect-padded
    frequency unfold, directly into the full ``[num_freqs]`` axis."""
    n = (hi - lo) // ctr
    width = ctr + 2 * nbr
    pos = lo - nbr + np.arange(n)[:, None] * ctr + np.arange(width)[None, :]
    pos = np.abs(pos)  # left reflect around bin 0
    over = pos - (num_freqs - 1)
    return np.where(over > 0, (num_freqs - 1) - over, pos)  # right reflect
