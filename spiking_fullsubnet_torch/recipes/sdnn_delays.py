"""The Intel N-DNS baseline recipe, the SDNN with delays (the port's copy of
``recipes/intel_ndns/sdnn_delays/trainer.py``, which imports the JAX
package; reference recipes/intel_ndns/sdnn_delays/trainer.py:25-50).

The model masks the noisy magnitude; the waveform takes the noisy phase;
the loss is ``lam * MSE(magnitude) + (100 - SI-SNR)`` with ``lam`` 0.001
(loss.py:8-33). Validation, test and prediction are the denoise recipe's,
without synops.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..dsp.spectral import istft, stft_complex
from ..losses.losses import mse_loss, si_snr
from .denoise import DenoiseTrainer


def sdnn_loss(apply, cfg, params, state, noisy: torch.Tensor, clean: torch.Tensor, n_fft: int,
              hop_length: int, win_length: int, lam: float = 0.001
              ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """The recipe's loss dict (``loss``, ``si_snr``) of one training
    forward of ``apply`` on ``noisy`` against ``clean``, and the new state."""
    spec = stft_complex(noisy, n_fft, hop_length, win_length)
    clean_mag = stft_complex(clean, n_fft, hop_length, win_length).abs()
    out = apply(cfg, params, state, spec.abs(), train=True)
    enh_mag = out["enhanced_mag"]
    clean_rec = istft((enh_mag, spec.angle()), n_fft, hop_length, win_length,
                      length=noisy.shape[-1], input_type="mag_phase")
    score = si_snr(clean_rec, clean)
    loss = lam * mse_loss(enh_mag, clean_mag) + (100.0 - score)
    return {"loss": loss, "si_snr": score}, out["state"]


class SdnnDelaysTrainer(DenoiseTrainer):
    """The denoise trainer with the SDNN's magnitude mask and loss."""

    lam = 0.001

    def training_step(self, noisy: torch.Tensor, clean: torch.Tensor):
        losses, state = sdnn_loss(self.model_apply, self.model_config, self.params,
                                  self.model_state, noisy, clean, self.n_fft, self.hop_length,
                                  self.win_length, self.lam)
        losses["loss"].backward()
        return {k: v.detach() for k, v in losses.items()}, state

    @torch.no_grad()
    def eval_forward(self, noisy: torch.Tensor):
        """(enhanced audio, None, None): the noisy phase on the enhanced
        magnitude; no synops (the denoise recipe's eval contract)."""
        spec = stft_complex(noisy, self.n_fft, self.hop_length, self.win_length)
        enh_mag = self.model_apply(self.model_config, self.params, self.model_state, spec.abs(),
                                   train=False)["enhanced_mag"]
        wave = istft((enh_mag, spec.angle()), self.n_fft, self.hop_length, self.win_length,
                     length=noisy.shape[-1], input_type="mag_phase")
        return wave, None, None
