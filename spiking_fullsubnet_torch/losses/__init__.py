"""Training losses (counterpart of ``spiking_fullsubnet_tpu/losses``; the
permutation-invariant ``pit.py`` comes with the separation recipe)."""

from .losses import (combine_loss, freq_mae, l1_loss, mag_mae, mse_loss, multi_res_spec_loss,
                     si_snr, si_snr_loss)
