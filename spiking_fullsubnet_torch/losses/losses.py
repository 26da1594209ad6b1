"""Loss functions (counterpart of ``spiking_fullsubnet_tpu/losses/losses.py``;
reference audiozen/loss.py): the denoise recipe's and those a TOML's
``[loss_function]`` names."""

from __future__ import annotations

from typing import Optional, Sequence

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


def si_snr_loss(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Negated SI-SNR (SISNRLoss(return_neg=True))."""
    return -si_snr(input, target)


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


def multi_res_spec_loss(est: torch.Tensor, target: torch.Tensor, n_ffts: Sequence[int],
                        gamma: float = 1.0, factor: float = 1.0,
                        f_complex: Optional[float] = None) -> torch.Tensor:
    """Multi-resolution spectrogram loss (``losses.py:67-102``): normalized
    STFTs (hop n_fft / 4, reflect padding), compressed magnitudes
    ``|Y|^gamma``, MSE on the magnitudes and, with ``f_complex``, on the
    phase-kept complex values (averaged over re and im, as torch's
    view_as_real MSE)."""
    eps = (torch.finfo(est.dtype).eps if est.dtype in (torch.float32, torch.float64)
           else _F32_EPS)
    loss = torch.zeros((), dtype=est.dtype, device=est.device)
    for n_fft in n_ffts:
        y = stft_complex(est, n_fft, n_fft // 4, n_fft, pad_mode="reflect", normalized=True)
        s = stft_complex(target, n_fft, n_fft // 4, n_fft, pad_mode="reflect", normalized=True)
        y_abs, s_abs = y.abs(), s.abs()
        if gamma != 1.0:
            y_abs = y_abs.clamp_min(eps) ** gamma
            s_abs = s_abs.clamp_min(eps) ** gamma
        loss = loss + ((y_abs - s_abs) ** 2).mean() * factor
        if f_complex is not None:
            if gamma != 1.0:
                y = y_abs * torch.exp(1j * y.angle())
                s = s_abs * torch.exp(1j * s.angle())
            sq = (y.real - s.real) ** 2 + (y.imag - s.imag) ** 2
            loss = loss + sq.mean() / 2.0 * f_complex
    return loss


def l1_loss(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (input - target).abs().mean()


def mse_loss(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((input - target) ** 2).mean()


def combine_loss(input: torch.Tensor, target: torch.Tensor, n_ffts: Sequence[int],
                 gamma: float = 1.0, factor: float = 1.0,
                 f_complex: Optional[float] = None) -> torch.Tensor:
    """MultiResSpec + L1 (CombineLoss, ``losses.py:108-117``)."""
    return (multi_res_spec_loss(input, target, n_ffts, gamma, factor, f_complex)
            + l1_loss(input, target))
