"""Mask constants (counterpart of ``spiking_fullsubnet_tpu/dsp/mask.py``)."""

import numpy as np

EPSILON = float(np.finfo(np.float64).eps)  # np.finfo(float).eps, as the reference
