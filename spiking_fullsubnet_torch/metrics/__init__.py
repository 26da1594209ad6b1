"""Evaluation metrics (counterpart of ``spiking_fullsubnet_tpu/metrics``)."""

from .dnsmos import DNSMOS, dnsmos_or_none, pDNSMOS
from .metrics import PESQ, SISDR, STOI, si_sdr_value
from .neuromorphic import compute_neuronops, compute_synops, synops_device
