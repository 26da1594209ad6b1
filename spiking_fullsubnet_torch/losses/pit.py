"""Permutation-invariant training (counterpart of
``spiking_fullsubnet_tpu/losses/pit.py``; reference audiozen/pit.py).

The permutations of a few sources are few, so the best one is found by one
product of the pairwise losses with every permutation's one-hot matrix,
with no data-dependent control flow. Everything is differentiable: the
minimum's gradient flows into the chosen permutation's pairs.
"""

from __future__ import annotations

from itertools import permutations
from typing import Callable, Tuple

import numpy as np
import torch


def pairwise_neg_sisdr(est: torch.Tensor, ref: torch.Tensor, zero_mean: bool = True,
                       eps: float = 1e-8) -> torch.Tensor:
    """Pairwise negative SI-SDR ``[B, n_est, n_ref]`` of ``[B, n_src, T]``
    estimates and references (``pit.py:20-34``)."""
    if ref.shape != est.shape or ref.ndim != 3:
        raise TypeError(f"Inputs must be [batch, n_src, time], got {tuple(ref.shape)} and "
                        f"{tuple(est.shape)}")
    if zero_mean:
        ref = ref - ref.mean(dim=2, keepdim=True)
        est = est - est.mean(dim=2, keepdim=True)
    s_est = est[:, :, None, :]  # [B, n_src, 1, T]
    s_ref = ref[:, None, :, :]  # [B, 1, n_src, T]
    dot = (s_est * s_ref).sum(dim=3, keepdim=True)
    energy = (s_ref ** 2).sum(dim=3, keepdim=True) + eps
    proj = dot * s_ref / energy
    e_noise = s_est - proj
    sdr = (proj ** 2).sum(dim=3) / ((e_noise ** 2).sum(dim=3) + eps)
    return -10.0 * torch.log10(sdr + eps)


def _permutations(num_sources: int) -> Tuple[np.ndarray, np.ndarray]:
    """(permutations ``[P, S]`` in itertools order, their one-hot matrices
    ``[P, S, S]`` with ``[p, i, perm[i]] = 1``)."""
    perms = np.array(list(permutations(range(num_sources))), dtype=np.int64)
    one_hot = np.zeros((len(perms), num_sources, num_sources), dtype=np.float32)
    for p, perm in enumerate(perms):
        one_hot[p, np.arange(num_sources), perm] = 1.0
    return perms, one_hot


def find_best_perm(pair_wise_losses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the least mean loss over the permutations ``[B]``, the best
    permutation ``[B, S]``) (``pit.py:37-49``); a tie takes the first
    permutation in itertools order, as ``argmin`` does."""
    num_sources = pair_wise_losses.shape[1]
    pwl = pair_wise_losses.transpose(-1, -2)  # dim 1 = sources, dim 2 = estimates
    perms, one_hot = _permutations(num_sources)
    one_hot = torch.from_numpy(one_hot).to(pwl.device, pwl.dtype)
    loss_set = torch.einsum("bij,pij->bp", pwl, one_hot) / num_sources
    min_loss_idx = torch.argmin(loss_set, dim=1)
    min_loss = loss_set.min(dim=1).values
    batch_indices = torch.from_numpy(perms).to(pwl.device)[min_loss_idx]  # [B, S]
    return min_loss, batch_indices


def reorder_source(source: torch.Tensor, batch_indices: torch.Tensor) -> torch.Tensor:
    """``source [B, S, ...]`` with each item's sources in the order of its
    permutation (``pit.py:52-54``)."""
    idx = batch_indices.reshape(*batch_indices.shape, *([1] * (source.ndim - 2)))
    return torch.take_along_dim(source, idx, dim=1)


def pit_wrapper(loss_func: Callable[..., torch.Tensor], est: torch.Tensor, ref: torch.Tensor,
                **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the batch mean of the least permutation loss, the estimates
    reordered by their best permutation) (``pit.py:57-63``)."""
    min_loss, batch_indices = find_best_perm(loss_func(est, ref, **kwargs))
    return min_loss.mean(), reorder_source(est, batch_indices)
