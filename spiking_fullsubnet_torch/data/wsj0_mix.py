"""wsj0-mix two-speaker separation datasets (counterpart of
``spiking_fullsubnet_tpu/data/wsj0_mix.py``).

Re-design of reference recipes/wsj0-mix/spiking_fullsubnet/dataloader.py:
mix/s1/s2 triplets from directories or scp lists, aligned random crops for
training. An item is (mix_f32[T], ref_f32[2, T], stem); the loader stacks
the references into ``[B, 2, T]`` and collates the stems into a list.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..dsp.io import find_files, load_wav, subsample
from .base_dataset import BaseDataset


class WSJ0MixDataset(BaseDataset):
    def __init__(self, mix_scp_or_dir, s1_scp_or_dir, s2_scp_or_dir, sr: int = 8000,
                 duration: float = 4, is_train: bool = True, limit: int = -1, offset: int = 0):
        super().__init__()

        def load_list(p):
            p = Path(p).expanduser().resolve()
            if p.is_dir():
                return find_files(p.as_posix())
            return [line for line in p.read_text().splitlines() if line]

        mix_list = load_list(mix_scp_or_dir)
        s1_list = load_list(s1_scp_or_dir)
        s2_list = load_list(s2_scp_or_dir)
        if offset > 0:
            mix_list, s1_list, s2_list = mix_list[offset:], s1_list[offset:], s2_list[offset:]
        if limit and limit > 0:
            mix_list, s1_list, s2_list = mix_list[:limit], s1_list[:limit], s2_list[:limit]

        self.mix_fpath_list = mix_list
        self.s1_fpath_list = s1_list
        self.s2_fpath_list = s2_list
        self.sr = sr
        self.sample_length = int(sr * duration)
        self.is_train = is_train

    def __len__(self):
        return len(self.mix_fpath_list)

    def __getitem__(self, index: int):
        stem = Path(self.mix_fpath_list[index]).stem
        mix_y = load_wav(self.mix_fpath_list[index])
        s1_y = load_wav(self.s1_fpath_list[index])
        s2_y = load_wav(self.s2_fpath_list[index])
        if self.is_train:
            # one crop start for the mixture and both sources (np.random)
            mix_y, start_idx = subsample(mix_y, self.sample_length, return_start_idx=True)
            s1_y = subsample(s1_y, self.sample_length, start_idx=start_idx)
            s2_y = subsample(s2_y, self.sample_length, start_idx=start_idx)
        ref_y = np.stack([s1_y, s2_y], axis=0).astype(np.float32)
        return mix_y.astype(np.float32), ref_y, stem


class SyntheticMixDataset(BaseDataset):
    """Two-speaker mixtures of modulated tones, item ``i`` from
    ``np.random.default_rng(seed * 7919 + i)``: the JAX package's arrays,
    item for item (for tests and runs without wsj0-mix)."""

    def __init__(self, num_samples=8, duration=1.0, sr=8000, seed=0, is_train=True):
        self.num_samples = num_samples
        self.n = int(duration * sr)
        self.sr = sr
        self.seed = seed
        self.is_train = is_train

    def __len__(self):
        return self.num_samples

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 7919 + index)
        t = np.arange(self.n) / self.sr
        f1, f2 = rng.uniform(100, 400), rng.uniform(500, 1200)
        s1 = (0.3 * np.sin(2 * np.pi * f1 * t) * (1 + 0.4 * np.sin(2 * np.pi * 2 * t))).astype(
            np.float32)
        s2 = (0.3 * np.sin(2 * np.pi * f2 * t) * (1 + 0.4 * np.cos(2 * np.pi * 3 * t))).astype(
            np.float32)
        return s1 + s2, np.stack([s1, s2]), f"mix_{index}"
