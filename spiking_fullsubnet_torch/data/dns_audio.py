"""Intel N-DNS dataset: the DNSAudio contract (counterpart of
``spiking_fullsubnet_tpu/data/dns_audio.py``).

Re-design of recipes/intel_ndns/spiking_fullsubnet/dataloader.py:12-101:
glob ``root/noisy/*.wav``, derive clean paths via the fileid regex, pad/crop
to 30 s, draw a random aligned ``sublen``-second crop during training (one
``np.random.randint`` for the pair, as the JAX package draws it). Returns
(noisy_f32[T], clean_f32[T], noisy_path). With the native reader
(``native/wavio.py``) only the crop window is read, as the JAX package reads
it (``dns_audio.py:45, 72-90``): the same draw, zeros past the end of the
file, nothing past 30 s; without a C++ compiler each file is read whole
with scipy and cropped in numpy, to the same values.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from ..dsp.io import load_wav, subsample
from ..native import wavio as _native
from .base_dataset import BaseDataset


class DNSAudio(BaseDataset):
    def __init__(self, root: str = "./", limit=None, offset: int = 0, sublen: int = 6,
                 train: bool = True):
        super().__init__()
        self.root = root
        self.noisy_files = sorted(glob.glob(os.path.join(root, "noisy", "*.wav")))
        if offset > 0:
            self.noisy_files = self.noisy_files[offset:]
        if limit:
            self.noisy_files = self.noisy_files[:limit]

        self.file_id_from_name = re.compile(r"fileid_(\d+)")
        self.snr_from_name = re.compile(r"snr(-?\d+)")
        self.target_level_from_name = re.compile(r"tl(-?\d+)")
        self.source_info_from_name = re.compile("^(.*?)_snr")

        self.train = train
        self.sublen = sublen
        self.length = len(self.noisy_files)
        self.use_native = _native.native_available()

    def __len__(self) -> int:
        return self.length

    def _get_filenames(self, n: int):
        noisy_file = self.noisy_files[n % self.length]
        filename = os.path.basename(noisy_file)
        file_id = int(self.file_id_from_name.findall(filename)[0])
        clean_file = os.path.join(self.root, "clean", f"clean_fileid_{file_id}.wav")
        noise_file = os.path.join(self.root, "noise", f"noise_fileid_{file_id}.wav")
        metadata = {}
        for key, pat in [("snr", self.snr_from_name),
                         ("target_level", self.target_level_from_name)]:
            found = pat.findall(filename)
            if found:
                metadata[key] = int(found[0])
        src = self.source_info_from_name.findall(filename)
        if src:
            metadata["source_info"] = src[0]
        return noisy_file, clean_file, noise_file, metadata

    def __getitem__(self, n: int):
        noisy_file, clean_file, _, _ = self._get_filenames(n)
        sr = 16000
        num_samples = 30 * sr
        crop = self.sublen * sr

        if self.use_native:
            if self.train:
                # the draw of subsample(): one randint for the pair
                start = int(np.random.randint(num_samples - crop))
                return (_native.wav_read(noisy_file, offset=start, frames=crop, pad_to=crop)[0],
                        _native.wav_read(clean_file, offset=start, frames=crop, pad_to=crop)[0],
                        noisy_file)
            return (_native.wav_read(noisy_file, frames=num_samples, pad_to=num_samples)[0],
                    _native.wav_read(clean_file, frames=num_samples, pad_to=num_samples)[0],
                    noisy_file)

        def fix(y):
            if len(y) > num_samples:
                return y[:num_samples]
            return np.concatenate([y, np.zeros(num_samples - len(y), dtype=y.dtype)])

        noisy_audio = fix(load_wav(noisy_file)).astype(np.float32)
        clean_audio = fix(load_wav(clean_file)).astype(np.float32)
        if self.train:
            noisy_audio, start = subsample(noisy_audio, crop, return_start_idx=True)
            clean_audio = subsample(clean_audio, crop, start_idx=start)
        return noisy_audio, clean_audio, noisy_file
