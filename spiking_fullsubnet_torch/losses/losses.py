"""The denoise recipe's loss functions (counterpart of
``spiking_fullsubnet_tpu/losses/losses.py``; reference audiozen/loss.py)."""

from __future__ import annotations

from typing import Optional

import torch

from ..dsp.spectral import stft_complex

_F32_EPS = float(torch.finfo(torch.float32).eps)


def si_snr(input: torch.Tensor, target: torch.Tensor,
           eps: Optional[float] = None) -> torch.Tensor:
    """Scale-invariant SNR in dB, mean over the batch (``losses.py:17-32``);
    ``eps`` defaults to the machine epsilon of the input's type (float32's
    for other types)."""
    if input.shape != target.shape:
        raise ValueError(f"Shape mismatch: {tuple(input.shape)} vs {tuple(target.shape)}")
    if eps is None:
        eps = (torch.finfo(input.dtype).eps if input.dtype in (torch.float32, torch.float64)
               else _F32_EPS)
    s_input = input - input.mean(-1, keepdim=True)
    s_target = target - target.mean(-1, keepdim=True)
    dot = (s_target * s_input).sum(-1, keepdim=True)
    norm = (s_target ** 2).sum(-1, keepdim=True)
    proj = dot * s_target / norm
    e_noise = s_input - proj
    ratio = (proj ** 2).sum(-1) / ((e_noise ** 2).sum(-1) + eps)
    return (10.0 * torch.log10(ratio + eps)).mean()


def _loss_stft(y: torch.Tensor, win: int, stride: int, normalized: bool = False) -> torch.Tensor:
    """torch.stft as the MAE losses call it (``losses.py:40-50``): centred
    with reflect padding, win_length = n_fft."""
    return stft_complex(y.reshape(-1, y.shape[-1]), win, stride, win, pad_mode="reflect",
                        normalized=normalized)


def freq_mae(estimation: torch.Tensor, target: torch.Tensor, win: int = 2048,
             stride: int = 512) -> torch.Tensor:
    """L1 on the real and imaginary STFT coefficients (``losses.py:53-57``)."""
    est, ref = _loss_stft(estimation, win, stride), _loss_stft(target, win, stride)
    return (est.real - ref.real).abs().mean() + (est.imag - ref.imag).abs().mean()


def mag_mae(estimation: torch.Tensor, target: torch.Tensor, win: int = 2048,
            stride: int = 512) -> torch.Tensor:
    """L1 on the STFT magnitudes (``losses.py:60-64``)."""
    est, ref = _loss_stft(estimation, win, stride), _loss_stft(target, win, stride)
    return (est.abs() - ref.abs()).abs().mean()
