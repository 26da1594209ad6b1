"""Paired scp-list dataset of the REVERB-style recipes (counterpart of
``spiking_fullsubnet_tpu/data/scp_dataset.py``): noisy and clean paths
from ``.scp`` text files, an optional aligned random crop in training.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..dsp.io import load_wav, subsample
from .base_dataset import BaseDataset


class ScpDataset(BaseDataset):
    def __init__(self, noisy_scp: str, clean_scp: Optional[str] = None, sr: int = 16000,
                 sublen: Optional[float] = None, offset: int = 0, limit=None, train: bool = True):
        super().__init__()
        self.noisy_paths = self._offset_and_limit(self._load_dataset_in_txt(noisy_scp), offset,
                                                  limit)
        self.clean_paths = (self._offset_and_limit(self._load_dataset_in_txt(clean_scp), offset,
                                                   limit) if clean_scp else None)
        if self.clean_paths is not None and len(self.clean_paths) != len(self.noisy_paths):
            raise ValueError(f"noisy/clean scp length mismatch: {len(self.noisy_paths)} vs "
                             f"{len(self.clean_paths)}")
        self.sr = sr
        self.sublen = sublen
        self.train = train

    def __len__(self):
        return len(self.noisy_paths)

    def __getitem__(self, index: int):
        noisy_path = self.noisy_paths[index]
        noisy = load_wav(noisy_path, sr=self.sr).astype(np.float32)
        if self.clean_paths is None:
            return noisy, noisy_path
        clean = load_wav(self.clean_paths[index], sr=self.sr).astype(np.float32)
        n = min(len(noisy), len(clean))
        noisy, clean = noisy[:n], clean[:n]
        if self.train and self.sublen:
            ln = int(self.sublen * self.sr)
            noisy, start = subsample(noisy, ln, return_start_idx=True)
            clean = subsample(clean, ln, start_idx=start)
        return noisy, clean, noisy_path
