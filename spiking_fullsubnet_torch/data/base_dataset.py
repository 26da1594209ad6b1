"""Base dataset utilities for on-the-fly noisy mixing (a copy of
``spiking_fullsubnet_tpu/data/base_dataset.py``).

Re-design of reference audiozen/dataset/base_dataset.py:13-138, using the
framework's scipy-backed wav IO instead of soundfile/librosa.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from ..dsp.io import find_files, load_audio


class BaseDataset:
    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, index):  # pragma: no cover - abstract
        raise NotImplementedError

    @staticmethod
    def _load_dataset_from_text_and_dir_list(dataset_list: Union[str, Sequence[str]]) -> List[str]:
        """Collect wav paths from dirs and scp/txt lists (base_dataset.py:18-44)."""
        if isinstance(dataset_list, str):
            dataset_list = [dataset_list]
        fpath_list: List[str] = []
        for dataset in dataset_list:
            p = Path(dataset).expanduser().absolute()
            if p.is_dir():
                fpath_list += find_files(p.as_posix())
            elif p.is_file():
                with open(p) as f:
                    fpath_list += [line.rstrip("\n") for line in f]
            else:
                raise FileNotFoundError(f"File {p} not found.")
        return fpath_list

    @staticmethod
    def _load_dataset_in_txt(dataset_path, return_empty_if_not_exist: bool = False) -> List[str]:
        p = Path(dataset_path).expanduser().absolute()
        if p.is_file():
            with open(p) as f:
                return [line.rstrip("\n") for line in f]
        if return_empty_if_not_exist:
            return []
        raise FileNotFoundError(f"File {p} not found.")

    @staticmethod
    def _offset_and_limit(dataset_list, offset: int, limit: Optional[int]):
        dataset_list = dataset_list[offset:]
        if limit:
            dataset_list = dataset_list[:limit]
        return dataset_list

    @staticmethod
    def _parse_snr_range(snr_range) -> List[int]:
        assert len(snr_range) == 2, f"The range of SNR should be [low, high], not {snr_range}."
        assert snr_range[0] <= snr_range[-1], "The low SNR should not larger than high SNR."
        return list(range(snr_range[0], snr_range[-1] + 1))

    @staticmethod
    def _random_select_from(path_list, rng: Optional[np.random.Generator] = None):
        if rng is not None:
            return path_list[int(rng.integers(len(path_list)))]
        return path_list[np.random.randint(len(path_list))]

    def _select_noise_y(self, target_length: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Concatenate random noise files (with silence gaps) to target length
        (base_dataset.py:85-107)."""
        noise_y = np.zeros(0, dtype=np.float32)
        silence = np.zeros(int(self.sr * self.silence_length), dtype=np.float32)
        remaining = target_length
        while remaining > 0:
            noise_file = self._random_select_from(self.noise_path_list, rng)
            addition, _ = load_audio(noise_file, sr=self.sr)
            noise_y = np.append(noise_y, addition)
            remaining -= len(addition)
            if remaining > 0:
                sl = min(remaining, len(silence))
                noise_y = np.append(noise_y, silence[:sl])
                remaining -= sl
        if len(noise_y) > target_length:
            start = (
                int(rng.integers(len(noise_y) - target_length))
                if rng is not None
                else np.random.randint(len(noise_y) - target_length)
            )
            noise_y = noise_y[start : start + target_length]
        return noise_y
