"""Training losses (counterpart of ``spiking_fullsubnet_tpu/losses``)."""

from .losses import (combine_loss, freq_mae, l1_loss, mag_mae, mse_loss, multi_res_spec_loss,
                     si_snr, si_snr_loss)
from .pit import find_best_perm, pairwise_neg_sisdr, pit_wrapper, reorder_source
