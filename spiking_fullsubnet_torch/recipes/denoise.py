"""The Intel N-DNS denoising recipe (counterpart of
``spiking_fullsubnet_tpu/recipes/denoise.py``): its training step and its
trainer.

loss = freq_mae + mag_mae + 0.001 (100 - SI-SNR) against the clean audio
(``denoise.py:63-79``), its gradient, clipping by global norm and an
optimizer step. ``train_step`` takes one such step; ``DenoiseTrainer``
runs the same step inside the epoch loop of ``runtime/trainer.Trainer``,
and validates with SI-SDR (the north-star metric), STOI, DNSMOS where
``onnxruntime`` imports and, when the forward collects its layers' spikes,
the synops and neuron ops.
"""

from __future__ import annotations

import csv
import logging
import math
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..dsp.io import save_wav
from ..losses.losses import freq_mae, mag_mae, si_snr
from ..metrics import SISDR, STOI, compute_neuronops, dnsmos_or_none, synops_device
from ..runtime.trainer import Trainer, optimizer_update

logger = logging.getLogger(__name__)


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


def accumulate_grads(apply: Callable, cfg, params, state, noisy: torch.Tensor,
                     clean: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], Any]:
    """``apply(cfg, params, state, noisy, train=True)``, the denoise loss
    against ``clean`` and its ``backward``, which adds the gradients into
    the weights' ``.grad``. Returns (the detached loss dict, the new state
    with the updated BN running statistics)."""
    out = apply(cfg, params, state, noisy, train=True)
    losses = denoise_loss(out["enhanced_y"], clean)
    losses["loss"].backward()
    return {k: v.detach() for k, v in losses.items()}, out["state"]


def train_step(apply: Callable, cfg, params, state, noisy: torch.Tensor, clean: torch.Tensor,
               optimizer: torch.optim.Optimizer, max_grad_norm: Optional[float] = 10.0
               ) -> Tuple[Dict[str, torch.Tensor], Any, torch.Tensor]:
    """One training step: the gradients zeroed, ``accumulate_grads``, then
    ``optimizer_update`` on the tensors of ``params`` that ``optimizer``
    holds. Returns (the detached loss dict, the new state with the updated
    BN running statistics, the gradients' global norm before clipping)."""
    optimizer.zero_grad(set_to_none=True)
    losses, new_state = accumulate_grads(apply, cfg, params, state, noisy, clean)
    return losses, new_state, optimizer_update(optimizer, max_grad_norm)


def write_metrics(rows, stem: Path) -> Dict[str, float]:
    """The per-utterance metric rows to ``<stem>.csv`` and the mean of each
    numeric column to ``<stem>_mean.csv``, as pandas writes them (columns in
    the order they first appear, a missing or NaN value empty, a column's mean
    over its non-NaN values). Returns the means."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    numeric = [c for c in columns
               if all(isinstance(row[c], (int, float)) for row in rows if c in row)]
    mean = {}
    for c in numeric:
        vals = [float(row[c]) for row in rows if c in row and not math.isnan(row[c])]
        mean[c] = sum(vals) / len(vals) if vals else float("nan")
    for path, table, cols in ((stem.with_name(stem.name + ".csv"), rows, columns),
                              (stem.with_name(stem.name + "_mean.csv"), [mean], numeric)):
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=cols)
            writer.writeheader()
            writer.writerows({k: "" if isinstance(v, float) and math.isnan(v) else v
                              for k, v in row.items()} for row in table)
    return mean


class DenoiseTrainer(Trainer):
    """The denoise recipe's trainer (``denoise.py:28-153``). DNSMOS scores
    each validation utterance where ``onnxruntime`` imports (``dns_mos``);
    without it validation runs without them, as the JAX recipe does."""

    north_star_metric = "si_sdr"
    # logged where DNSMOS is missing; a recipe that says nothing sets None
    dnsmos_warning = "onnxruntime unavailable — DNSMOS disabled for validation."

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.si_sdr = SISDR()
        self.stoi = STOI(sr=self.sr)
        self.dns_mos = dnsmos_or_none(self.sr)
        if self.dns_mos is None and self.dnsmos_warning:
            logger.warning(self.dnsmos_warning)

    def dnsmos_row(self, est: np.ndarray) -> Dict[str, float]:
        """DNSMOS's scores of one estimate (P808, OVRL, SIG, BAK), or none
        without ``onnxruntime``."""
        return self.dns_mos(est) if self.dns_mos is not None else {}

    def training_step(self, noisy: torch.Tensor, clean: torch.Tensor):
        return accumulate_grads(self.model_apply, self.model_config, self.params,
                                self.model_state, noisy, clean)

    @torch.no_grad()
    def eval_forward(self, noisy: torch.Tensor):
        """(enhanced audio, synops, neuron ops) of one eval forward; the
        last two None when the forward collects no layer outputs."""
        out = self.model_apply(self.model_config, self.params, self.model_state, noisy,
                               train=False)
        if "fb_all_layer_outputs" not in out:
            return out["enhanced_y"], None, None
        fb, sb = out["fb_all_layer_outputs"], out["sb_all_layer_outputs"]
        shared = bool(getattr(self.model_config, "shared_weights", True))
        return out["enhanced_y"], synops_device(fb, sb, shared), compute_neuronops(fb, sb)

    def enhance(self, noisy: np.ndarray) -> np.ndarray:
        """Enhance a [B, T] batch with the current weights (eval mode)."""
        return self.eval_forward(self.to_device(noisy))[0].float().cpu().numpy()

    def validation_step(self, batch, batch_idx, dataloader_idx=0):
        est, synops, neuronops = self.eval_forward(self.to_device(batch[0]))
        est = est.float().cpu().numpy()
        ref = np.asarray(batch[1])
        extra = {}
        if synops is not None:
            # per-batch cost proxies, repeated per utterance (reference
            # freeze trainer validation_step:117-137 does the same)
            extra = {"synops": float(synops), "neuron_ops": float(neuronops)}
        return [self.si_sdr(est[i], ref[i]) | self.stoi(est[i], ref[i]) | self.dnsmos_row(est[i])
                | extra for i in range(est.shape[0])]

    def validation_epoch_end(self, outputs, log_to_tensorboard=True):
        """The metrics CSV and its mean (reference recipe trainer.py:68-99):
        ``dl_<i>_epoch_<e>_<time>.csv`` and ``..._mean.csv``."""
        score = 0.0
        for dataloader_idx, dataloader_outputs in enumerate(outputs):
            rows = [row for step_out in dataloader_outputs for row in step_out]
            stem = (f"dl_{dataloader_idx}_epoch_{self.state.epochs_trained}_"
                    f"{self._get_time_now()}")
            mean = write_metrics(rows, self.metrics_dir / stem)
            logger.info("\n" + " | ".join(mean) + "\n" + " | ".join(f"{v:.4f}" for v in
                                                                   mean.values()))
            score += mean[self.north_star_metric]
            if log_to_tensorboard:
                for metric, value in mean.items():
                    self.writer.add_scalar(f"metrics_{dataloader_idx}/{metric}", value,
                                           self.state.epochs_trained)
        return score

    def test_step(self, batch, batch_idx, dataloader_idx=0):
        return self.validation_step(batch, batch_idx, dataloader_idx)

    def test_epoch_end(self, outputs):
        return self.validation_epoch_end(outputs, log_to_tensorboard=False)

    def predict_step(self, batch, batch_idx, dataloader_idx=0):
        mix_y = batch[0]
        names = (batch[-1] if isinstance(batch[-1], list)
                 else [f"b{batch_idx}_{i}" for i in range(len(mix_y))])
        est_y = self.enhance(mix_y)
        out_dir = self.enhanced_dir / f"dataloader_{dataloader_idx}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for i in range(est_y.shape[0]):
            save_wav(est_y[i], out_dir / str(names[i]).split("/")[-1], self.sr)
