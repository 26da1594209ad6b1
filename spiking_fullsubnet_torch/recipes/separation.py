"""The wsj0-mix two-speaker separation recipe (counterpart of
``spiking_fullsubnet_tpu/recipes/separation.py``): the trainer of the
Spiking-FullSubNet, Conv-TasNet and cIRM-LSTM recipes.

Training minimises the permutation-invariant negative SI-SDR of the
``[B, 2, T]`` estimates (``separation.py:39-43``); validation and test
reorder each estimate by its best permutation and score SI-SDR per item
over its speakers (``:45-65``), the north-star metric. DNSMOS needs
``onnxruntime`` and is not ported: the trainer takes the JAX recipe's
branch for its absence (``:26-31``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..losses.pit import pairwise_neg_sisdr, pit_wrapper
from .denoise import DenoiseTrainer


def separation_loss(enhanced_y: torch.Tensor, ref_y: torch.Tensor) -> torch.Tensor:
    """The PIT negative SI-SDR of ``[B, S, T]`` estimates against their
    references, the batch mean."""
    return pit_wrapper(pairwise_neg_sisdr, enhanced_y, ref_y)[0]


class SeparationTrainer(DenoiseTrainer):
    """The denoise trainer with the PIT loss and SI-SDR after the best
    permutation; its CSVs are the denoise recipe's (``:67-86``)."""

    dnsmos_warning = None  # the JAX recipe drops DNSMOS without a word

    def training_step(self, mix_y: torch.Tensor, ref_y: torch.Tensor):
        out = self.model_apply(self.model_config, self.params, self.model_state, mix_y,
                               train=True)
        loss = separation_loss(out["enhanced_y"], ref_y)
        loss.backward()
        return {"loss": loss.detach()}, out["state"]

    @torch.no_grad()
    def validation_step(self, batch, batch_idx, dataloader_idx=0):
        ref = self.to_device(batch[1])
        est = self.model_apply(self.model_config, self.params, self.model_state,
                               self.to_device(batch[0]), train=False)["enhanced_y"]
        _, est = pit_wrapper(pairwise_neg_sisdr, est, ref)
        est, ref_np = est.float().cpu().numpy(), np.asarray(batch[1])
        return [self.si_sdr(est[i], ref_np[i]) for i in range(est.shape[0])]

    def test_epoch_end(self, outputs):
        # logged to tensorboard, as the JAX recipe's test does
        return self.validation_epoch_end(outputs)

    def predict_step(self, batch, batch_idx, dataloader_idx=0):
        """Nothing: the JAX recipe writes no estimates (its base trainer's
        ``predict_step``)."""
