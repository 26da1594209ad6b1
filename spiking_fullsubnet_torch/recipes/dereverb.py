"""The REVERB dereverberation recipe (counterpart of
``spiking_fullsubnet_tpu/recipes/dereverb.py``).

loss = freq_mae + mag_mae + time-domain L1 (``dereverb.py:45-58``).
Validation and test score SI-SDR and, where ``onnxruntime`` imports,
DNSMOS, whose OVRL is then the north-star metric; without it SI-SDR is
(``:30-38``).
Prediction writes the enhanced wavs under ``enhanced/dataloader_<i>/``,
mirroring the input tree relative to ``[predict] mix_root`` for
downstream ASR scoring (``:106-121``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..dsp.io import save_wav
from ..losses.losses import freq_mae, l1_loss, mag_mae
from .denoise import DenoiseTrainer


def dereverb_loss(enhanced_y: torch.Tensor, ref_y: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The loss dict of ``training_step_fn`` (``dereverb.py:45-58``)."""
    loss_freq_mae = freq_mae(enhanced_y, ref_y)
    loss_mag_mae = mag_mae(enhanced_y, ref_y)
    loss_time_mae = l1_loss(enhanced_y, ref_y)
    return {"loss": loss_freq_mae + loss_mag_mae + loss_time_mae,
            "loss_freq_mae": loss_freq_mae, "loss_mag_mae": loss_mag_mae,
            "loss_time_mae": loss_time_mae}


class DereverbTrainer(DenoiseTrainer):
    """The denoise trainer with the dereverberation loss, SI-SDR (and
    DNSMOS) in validation and test, and prediction that mirrors the input
    tree."""

    dnsmos_warning = "onnxruntime unavailable — falling back to si_sdr north star."

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.dns_mos is not None:
            self.north_star_metric = "OVRL"

    def training_step(self, mix_y: torch.Tensor, ref_y: torch.Tensor):
        out = self.model_apply(self.model_config, self.params, self.model_state, mix_y,
                               train=True)
        losses = dereverb_loss(out["enhanced_y"], ref_y)
        losses["loss"].backward()
        return {k: v.detach() for k, v in losses.items()}, out["state"]

    @torch.no_grad()
    def enhance(self, mix_y) -> np.ndarray:
        """The enhanced ``[B, T]`` batch of the current weights (eval)."""
        return self.model_apply(self.model_config, self.params, self.model_state,
                                self.to_device(mix_y), train=False)["enhanced_y"].float(
                                    ).cpu().numpy()

    def validation_step(self, batch, batch_idx, dataloader_idx=0):
        est, ref = self.enhance(batch[0]), np.asarray(batch[1])
        return [self.si_sdr(est[i], ref[i]) | self.dnsmos_row(est[i])
                for i in range(est.shape[0])]

    def predict_step(self, batch, batch_idx, dataloader_idx=0):
        mix_y = batch[0]
        paths = (batch[-1] if isinstance(batch[-1], list)
                 else [f"b{batch_idx}_{i}.wav" for i in range(len(mix_y))])
        mix_root = self.config.get("predict", {}).get("mix_root")
        est_y = self.enhance(mix_y)
        for i in range(est_y.shape[0]):
            p = Path(str(paths[i]))
            rel = p.relative_to(mix_root) if mix_root and str(p).startswith(str(mix_root)) \
                else Path(p.name)
            out_path = self.enhanced_dir / f"dataloader_{dataloader_idx}" / rel
            out_path.parent.mkdir(parents=True, exist_ok=True)
            save_wav(est_y[i], out_path, self.sr)
