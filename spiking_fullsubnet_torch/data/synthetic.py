"""Synthetic sine+noise dataset for tests / smoke runs (no audio files needed):
a copy of ``spiking_fullsubnet_tpu/data/synthetic.py``.

This is the framework's own addition (the reference has no synthetic data);
it makes end-to-end recipe tests hermetic.
"""

from __future__ import annotations

import numpy as np

from .base_dataset import BaseDataset


class SyntheticNoisyDataset(BaseDataset):
    """Deterministic per-index modulated tones + gaussian noise pairs."""

    def __init__(
        self,
        num_samples: int = 32,
        duration: float = 2.0,
        sr: int = 16000,
        snr_db: float = 5.0,
        seed: int = 0,
        train: bool = True,
    ):
        self.num_samples = num_samples
        self.sr = sr
        self.n = int(duration * sr)
        self.snr_db = snr_db
        self.seed = seed
        self.train = train

    def __len__(self):
        return self.num_samples

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 100_003 + index)
        t = np.arange(self.n) / self.sr
        f0 = float(rng.uniform(120, 800))
        clean = 0.25 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t))
        # add a couple of harmonics for spectral structure
        clean = clean + 0.1 * np.sin(2 * np.pi * 2 * f0 * t) + 0.05 * np.sin(2 * np.pi * 3 * f0 * t)
        clean = clean.astype(np.float32)
        noise = rng.standard_normal(self.n).astype(np.float32)
        clean_rms = np.sqrt(np.mean(clean**2))
        noise_rms = np.sqrt(np.mean(noise**2))
        gain = clean_rms / (10 ** (self.snr_db / 20)) / (noise_rms + 1e-12)
        noisy = clean + gain * noise
        return noisy.astype(np.float32), clean, f"synthetic_{index}.wav"
