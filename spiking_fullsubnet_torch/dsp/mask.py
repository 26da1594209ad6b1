"""Complex ideal ratio mask (cIRM) helpers and FullSubNet's drop-band
(counterpart of ``spiking_fullsubnet_tpu/dsp/mask.py``; reference
audiozen/acoustics/audio_feature.py:432-567). Differentiable torch ops on
any device."""

from __future__ import annotations

import numpy as np
import torch

EPSILON = float(np.finfo(np.float64).eps)  # np.finfo(float).eps, as the reference


def build_complex_ideal_ratio_mask(noisy_real: torch.Tensor, noisy_imag: torch.Tensor,
                                   clean_real: torch.Tensor, clean_imag: torch.Tensor
                                   ) -> torch.Tensor:
    """The compressed cIRM of a noisy and a clean spectrum, ``[..., 2]``
    (``mask.py:15``)."""
    denominator = noisy_real.square() + noisy_imag.square() + EPSILON
    mask_real = (noisy_real * clean_real + noisy_imag * clean_imag) / denominator
    mask_imag = (noisy_real * clean_imag - noisy_imag * clean_real) / denominator
    return compress_cirm(torch.stack((mask_real, mask_imag), dim=-1), k=10.0, c=0.1)


def compress_cirm(mask: torch.Tensor, k: float = 10.0, c: float = 0.1) -> torch.Tensor:
    """Compress a cIRM from (-inf, inf) to (-k, k) (``mask.py:25``)."""
    mask = torch.where(mask <= -100.0, torch.full_like(mask, -100.0), mask)
    return k * (1.0 - torch.exp(-c * mask)) / (1.0 + torch.exp(-c * mask))


def decompress_cirm(mask: torch.Tensor, k: float = 10.0, limit: float = 9.9) -> torch.Tensor:
    """The inverse of ``compress_cirm`` (``mask.py:31``), the mask clipped
    to ``±limit`` first (``jnp.clip``'s gradient: 1/2 on a bound)."""
    mask = torch.minimum(torch.maximum(mask, torch.full_like(mask, -limit)),
                         torch.full_like(mask, limit))
    return -k * torch.log((k - mask) / (k + mask))


def complex_mul(noisy_r, noisy_i, mask_r, mask_i):
    """``(a + bi)(c + di)`` on real and imaginary planes (``mask.py:37``)."""
    return noisy_r * mask_r - noisy_i * mask_i, noisy_r * mask_i + noisy_i * mask_r


def drop_band(x: torch.Tensor, num_groups: int = 2) -> torch.Tensor:
    """FullSubNet's frequency subsampling (``mask.py:44``): ``x [B, C, F,
    T]``, the batch in ``num_groups`` groups (rows g, g + G, ...), group g
    keeping the bins g, g + G, ...; the groups concatenated in order, so
    the batch comes back regrouped and F becomes F // G (F is first cut to
    a multiple of G)."""
    batch_size, _, num_freqs, _ = x.shape
    if num_groups <= 1:
        return x
    if batch_size <= num_groups:
        raise ValueError(f"Batch size ({batch_size}) must exceed num_groups ({num_groups}).")
    x = x[..., :num_freqs - num_freqs % num_groups, :]
    return torch.cat([x[g::num_groups][:, :, g::num_groups, :] for g in range(num_groups)], dim=0)
