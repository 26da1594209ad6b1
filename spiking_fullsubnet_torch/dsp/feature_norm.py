"""Laplace feature norms of the layered forward (counterpart of
``spiking_fullsubnet_tpu/dsp/feature_norm.py``). Inputs are ``[B, C, F, T]``
or, for the sub-band units, ``[B, N, C, F, T]``."""

from __future__ import annotations

import torch

from .mask import EPSILON


def offline_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """Divide by the utterance-level mean over every axis but the first
    (``feature_norm.py:35``)."""
    mu = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
    return x / (mu + EPSILON)


def cumulative_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """Divide by the causal running mean over (F, t' <= t), leading axes
    flattened into the batch (``feature_norm.py:42``)."""
    *lead, f, t = x.shape
    xr = x.reshape(-1, f, t)
    cum_sum = torch.cumsum(xr.sum(dim=1), dim=-1)  # [B*C, T]
    entry_count = torch.arange(f, f * t + 1, f, dtype=x.dtype, device=x.device)[None, :]
    normed = xr / ((cum_sum / entry_count)[:, None, :] + EPSILON)
    return normed.reshape(*lead, f, t)


_NORMS = {
    "offline_laplace_norm": offline_laplace_norm,
    "cumulative_laplace_norm": cumulative_laplace_norm,
}


def norm_wrapper(norm_type: str):
    """Lookup by name (``feature_norm.py:153``)."""
    if norm_type not in _NORMS:
        raise NotImplementedError(
            f"norm {norm_type!r} is not ported yet (ROADMAP queue 1: remaining models and "
            f"recipes, the rest of dsp/feature_norm.py); ported: {sorted(_NORMS)}")
    return _NORMS[norm_type]
