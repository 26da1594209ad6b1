"""Host input pipeline (counterpart of ``spiking_fullsubnet_tpu/data``): numpy
datasets and a one-process loader that yields numpy batches."""

from .base_dataset import BaseDataset
from .dns_audio import DNSAudio
from .loader import DataLoader, default_collate
from .synthetic import SyntheticNoisyDataset
