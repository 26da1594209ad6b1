"""Deep filtering: a complex FIR filter along time, per frequency bin
(counterpart of ``spiking_fullsubnet_tpu/ops/deep_filter.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def deep_filter(complex_spec: torch.Tensor, coef: torch.Tensor, order: int,
                num_spks: int) -> torch.Tensor:
    """``complex_spec [B, C, F, T]`` complex, ``coef [B, C order, S, F, T, 2]``
    real (any float type; taken in the spectrum's real type) -> ``[B, C, S,
    F, T]`` complex (``deep_filter.py:28``). Tap d reads frame
    ``t - order + 1 + d``, so the oldest frame sits at tap 0; each tap is one
    shifted multiply-add, no ``[..., T, order]`` tap tensor (that of
    ``_time_unfold``, ``deep_filter.py:18``, is gigabytes at a serving
    batch)."""
    B, C, _, T = complex_spec.shape
    real = complex_spec.real.dtype
    cc = coef.reshape(B, C, order, *coef.shape[2:])  # [B, C, df, S, F, T, 2]
    padded = F.pad(complex_spec, (order - 1, 0))
    out = None
    for d in range(order):
        tap = padded[..., d:d + T][:, :, None]  # [B, C, 1, F, T]
        cd = cc[:, :, d].to(real)
        term = tap * torch.complex(cd[..., 0], cd[..., 1])
        out = term if out is None else out + term
    return out


def deep_filter_single(complex_spec: torch.Tensor, coefs: torch.Tensor,
                       frame_size: int) -> torch.Tensor:
    """Single-speaker deep filtering (``deep_filter.py:59-72``; freeze-phase
    model_low_freq.py:15-39): ``complex_spec [B, C, F, T]`` complex, ``coefs
    [B, C frame_size, F, T, 2]`` real -> ``[B, C, F, T]`` complex, tap d on
    frame ``t - frame_size + 1 + d`` as in ``deep_filter``. The taps are
    stacked and contracted in one einsum, as the JAX function does."""
    B, C, _, T = complex_spec.shape
    padded = F.pad(complex_spec, (frame_size - 1, 0))
    taps = torch.stack([padded[..., d:d + T] for d in range(frame_size)], dim=-1)
    cc = coefs.to(complex_spec.real.dtype)
    cc = torch.complex(cc[..., 0], cc[..., 1]).reshape(B, C, frame_size, *coefs.shape[2:4])
    return torch.einsum("bcftd,bcdft->bcft", taps, cc)
