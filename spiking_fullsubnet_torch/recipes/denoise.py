"""The Intel N-DNS denoising recipe's training step (counterpart of
``spiking_fullsubnet_tpu/recipes/denoise.py`` and of the step the JAX
package's ``runtime/trainer.py`` wraps around it).

loss = freq_mae + mag_mae + 0.001 (100 - SI-SNR) against the clean audio
(``denoise.py:63-79``), its gradient, clipping by global norm and an AdamW
step with the registry's values (``runtime/registry.py:20-21``). The
trainer, data loading and checkpoints are not ported yet (ROADMAP queue 2,
training slice 3).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from ..losses.losses import freq_mae, mag_mae, si_snr


def denoise_loss(enhanced_y: torch.Tensor, clean_y: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The loss dict of ``training_step_fn`` (``denoise.py:63-79``)."""
    loss_freq_mae = freq_mae(enhanced_y, clean_y)
    loss_mag_mae = mag_mae(enhanced_y, clean_y)
    loss_sdr = si_snr(enhanced_y, clean_y)
    loss_sdr_norm = 0.001 * (100.0 - loss_sdr)
    return {"loss": loss_freq_mae + loss_mag_mae + loss_sdr_norm,
            "loss_freq_mae": loss_freq_mae, "loss_mag_mae": loss_mag_mae,
            "loss_sdr": loss_sdr, "loss_sdr_norm": loss_sdr_norm}


def adamw(parameters: Iterable[torch.Tensor], lr: float = 1e-3) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with the registry's values (betas (0.9, 0.999),
    eps 1e-8, weight decay 1e-2) over ``parameters``, made trainable."""
    params = [p.requires_grad_(True) for p in parameters]
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)


def train_step(apply: Callable, cfg, params, state, noisy: torch.Tensor, clean: torch.Tensor,
               optimizer: torch.optim.Optimizer, max_grad_norm: Optional[float] = 10.0
               ) -> Tuple[Dict[str, torch.Tensor], Any, Optional[torch.Tensor]]:
    """One training step: ``apply(cfg, params, state, noisy, train=True)``,
    the denoise loss against ``clean``, ``backward``, the gradients clipped
    by global norm ``max_grad_norm`` (``trainer.py:181-182``; skipped when
    it is 0 or None), then ``optimizer.step()`` on the tensors of ``params``
    that it holds. Returns (the detached loss dict, the new state with the
    updated BN running statistics, the gradients' global norm before
    clipping). torch's ``clip_grad_norm_`` divides by the norm plus 1e-6,
    optax's ``clip_by_global_norm`` by the norm alone."""
    optimizer.zero_grad(set_to_none=True)
    out = apply(cfg, params, state, noisy, train=True)
    losses = denoise_loss(out["enhanced_y"], clean)
    losses["loss"].backward()
    grad_norm = None
    if max_grad_norm:
        grad_norm = torch.nn.utils.clip_grad_norm_(
            [p for group in optimizer.param_groups for p in group["params"]], max_grad_norm)
    optimizer.step()
    return {k: v.detach() for k, v in losses.items()}, out["state"], grad_norm
