"""The FullSubNet feature norms (counterpart of
``spiking_fullsubnet_tpu/dsp/feature_norm.py``; reference
audiozen/models/base_model.py:159-384). Inputs are ``[B, C, F, T]`` or, for
the sub-band units, ``[B, N, C, F, T]``. The first-order recurrence of the
forgetting norms is a loop over the frames (the JAX package's associative
scan: the same values, summed in another order)."""

from __future__ import annotations

import torch

from .mask import EPSILON


def _linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mu_t = a_t mu_{t-1} + b_t`` over the last axis, ``mu_{-1} = 0``
    (``feature_norm.py:19``)."""
    mu, out = torch.zeros_like(b[..., 0]), []
    for t in range(b.shape[-1]):
        mu = a[..., t] * mu + b[..., t]
        out.append(mu)
    return torch.stack(out, dim=-1)


def offline_laplace_norm(x: torch.Tensor, return_mu: bool = False):
    """Divide by the utterance-level mean over every axis but the first
    (``feature_norm.py:35``); with ``return_mu`` also the mean."""
    mu = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
    normed = x / (mu + EPSILON)
    return (normed, mu) if return_mu else normed


def cumulative_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """Divide by the causal running mean over (F, t' <= t), leading axes
    flattened into the batch (``feature_norm.py:42``)."""
    *lead, f, t = x.shape
    xr = x.reshape(-1, f, t)
    cum_sum = torch.cumsum(xr.sum(dim=1), dim=-1)  # [B*C, T]
    entry_count = torch.arange(f, f * t + 1, f, dtype=x.dtype, device=x.device)[None, :]
    normed = xr / ((cum_sum / entry_count)[:, None, :] + EPSILON)
    return normed.reshape(*lead, f, t)


def offline_gaussian_norm(x: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit (unbiased, ddof 1) standard deviation per utterance
    (``feature_norm.py:61``)."""
    axes = tuple(range(1, x.ndim))
    mu = x.mean(dim=axes, keepdim=True)
    n = x[0].numel()
    var = ((x - mu) ** 2).sum(dim=axes, keepdim=True) / max(n - 1, 1)
    return (x - mu) / (torch.sqrt(var) + EPSILON)


def cumulative_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Causal running mean and standard deviation over (F, t' <= t)
    (``feature_norm.py:76``)."""
    b, c, f, t = x.shape
    xr = x.reshape(b * c, f, t)
    cum_sum = torch.cumsum(xr.sum(dim=1), dim=-1)
    cum_pow_sum = torch.cumsum(xr.square().sum(dim=1), dim=-1)
    entry_count = torch.arange(f, f * t + 1, f, dtype=x.dtype, device=x.device)[None, :]
    cum_mean = cum_sum / entry_count
    cum_var = (cum_pow_sum - 2 * cum_mean * cum_sum) / entry_count + cum_mean ** 2
    cum_std = torch.sqrt(cum_var + EPSILON)
    return ((xr - cum_mean[:, None, :]) / cum_std[:, None, :]).reshape(b, c, f, t)


def _forgetting_alphas(t: int, sample_length: int, x: torch.Tensor) -> torch.Tensor:
    """``min((i - 1) / (i + 1), alpha)`` per frame i, alpha = (L - 1) / (L +
    1): frame 0's is -1, a quirk of the reference kept as it is."""
    alpha = (sample_length - 1) / (sample_length + 1)
    idx = torch.arange(t, dtype=x.dtype, device=x.device)
    return torch.clamp((idx - 1.0) / (idx + 1.0), max=alpha)


def forgetting_norm(x: torch.Tensor, sample_length: int = 192) -> torch.Tensor:
    """Divide by an exponentially forgetting mean of the frame means, its
    factor warming up over the first ``sample_length`` frames
    (``feature_norm.py:94``)."""
    b, c, f, t = x.shape
    xr = x.reshape(b, c * f, t)
    frame_mean = xr.mean(dim=1)  # [B, T]
    alp = _forgetting_alphas(t, sample_length, x)
    mu = _linear_recurrence(alp.expand_as(frame_mean), (1.0 - alp) * frame_mean)
    return (xr / (mu[:, None, :] + EPSILON)).reshape(b, c, f, t)


def hybrid_norm(x: torch.Tensor, sample_length: int = 192) -> torch.Tensor:
    """``x [B, F, T]`` divided by the forgetting mean over the first
    ``sample_length`` frames and the cumulative mean after
    (``feature_norm.py:124``)."""
    b, f, t = x.shape
    cum_sum = torch.cumsum(x.sum(dim=1), dim=-1)
    entry_count = torch.arange(f, f * t + 1, f, dtype=x.dtype, device=x.device)[None, :]
    cum_mean = cum_sum / entry_count  # [B, T]
    frame_mean = x.mean(dim=1)
    alp = _forgetting_alphas(t, sample_length, x)
    init_mu = _linear_recurrence(alp.expand_as(frame_mean), (1.0 - alp) * frame_mean)
    idx = torch.arange(t, device=x.device)[None, :]
    mu = torch.where(idx < sample_length, init_mu, cum_mean)
    return x / (mu[:, None, :] + EPSILON)


_NORMS = {
    "offline_laplace_norm": offline_laplace_norm,
    "cumulative_laplace_norm": cumulative_laplace_norm,
    "offline_gaussian_norm": offline_gaussian_norm,
    "cumulative_layer_norm": cumulative_layer_norm,
    "forgetting_norm": forgetting_norm,
}


def norm_wrapper(norm_type: str):
    """Lookup by name (``feature_norm.py:153``)."""
    if norm_type not in _NORMS:
        raise NotImplementedError(f"Unknown norm {norm_type!r}; choose from {sorted(_NORMS)}")
    return _NORMS[norm_type]
