"""Evaluation metrics (counterpart of ``spiking_fullsubnet_tpu/metrics``).
DNSMOS needs ``onnxruntime`` and is not ported yet (ROADMAP queue 1)."""

from .metrics import PESQ, SISDR, STOI, si_sdr_value
from .neuromorphic import compute_neuronops, compute_synops, synops_device
