"""The REVERB challenge datasets of ``recipes/reverb/spiking_fullsubnet``
(the port's own copy of that recipe's ``dataloader.py``, which imports the
JAX package). Scp lines are Kaldi's ``utt_id path``.

The recipe's TOML names them ``dataloader.<Dataset>``, relative to the
recipe directory; the CLI maps that module here
(``runtime/cli.RECIPE_MODULES``).
"""

from __future__ import annotations

import numpy as np

from ..data.base_dataset import BaseDataset
from ..dsp.io import load_wav, subsample


def _read_scp(path):
    with open(path) as f:
        return [line for line in f.read().splitlines() if line]


class EvaluationRealDataset(BaseDataset):
    """Reverberant utterances alone, for prediction: (wav, path)
    (``dataloader.py:19-30``)."""

    def __init__(self, scp_fpath):
        self.fpath_list = _read_scp(scp_fpath)

    def __len__(self):
        return len(self.fpath_list)

    def __getitem__(self, index):
        _, fpath = self.fpath_list[index].split()
        return load_wav(fpath).astype(np.float32), fpath


class EvaluationSimDataset(EvaluationRealDataset):
    """The simulated evaluation set, read as the real one
    (``dataloader.py:33-34``)."""


class SimTrainDataset(BaseDataset):
    """Paired reverberant and dry scps with aligned random crops:
    (rvb, dry, utt_id) (``dataloader.py:37-69``)."""

    def __init__(self, rvb_scp_fpath, dry_scp_fpath, duration_in_seconds=4.0, sr=16000,
                 limit=None, offset=0):
        self.rvb_fpath_list = _read_scp(rvb_scp_fpath)
        self.ref_fpath_list = _read_scp(dry_scp_fpath)
        if len(self.rvb_fpath_list) != len(self.ref_fpath_list):
            raise ValueError(f"scp length mismatch: {len(self.rvb_fpath_list)} != "
                             f"{len(self.ref_fpath_list)}")
        if offset > 0:
            self.rvb_fpath_list = self.rvb_fpath_list[offset:]
            self.ref_fpath_list = self.ref_fpath_list[offset:]
        if limit is not None and limit:
            self.rvb_fpath_list = self.rvb_fpath_list[:limit]
            self.ref_fpath_list = self.ref_fpath_list[:limit]
        self.duration_in_seconds = duration_in_seconds
        self.sr = sr

    def __len__(self):
        return len(self.rvb_fpath_list)

    def __getitem__(self, index):
        utt_id, rvb_fpath = self.rvb_fpath_list[index].split(" ")
        _, ref_fpath = self.ref_fpath_list[index].split(" ")
        rvb_y = load_wav(rvb_fpath).astype(np.float32)
        ref_y = load_wav(ref_fpath).astype(np.float32)
        if rvb_y.shape != ref_y.shape:
            raise ValueError(f"rvb/ref shape mismatch: {rvb_y.shape} != {ref_y.shape}")
        n = int(self.duration_in_seconds * self.sr)
        rvb_y, start_idx = subsample(rvb_y, n, return_start_idx=True)
        ref_y = subsample(ref_y, n, start_idx=start_idx)
        return rvb_y, ref_y, utt_id


class SimDTDataset(BaseDataset):
    """The simulated dev/eval set: (rvb, dry, utt_id), the dry path derived
    from the reverberant one (``far_test``/``near_test`` -> ``cln_test``,
    ``_ch1`` dropped), ``dry_scp_fpath`` read but not used
    (``dataloader.py:72-94``)."""

    def __init__(self, rvb_scp_fpath, dry_scp_fpath, sr=16000, limit=None, offset=0):
        self.rvb_fpath_list = _read_scp(rvb_scp_fpath)
        self.ref_fpath_list = _read_scp(dry_scp_fpath)
        if offset > 0:
            self.rvb_fpath_list = self.rvb_fpath_list[offset:]
        if limit is not None and limit:
            self.rvb_fpath_list = self.rvb_fpath_list[:limit]
        self.sr = sr

    def __len__(self):
        return len(self.rvb_fpath_list)

    def __getitem__(self, index):
        utt_id, rvb_fpath = self.rvb_fpath_list[index].split()
        ref_fpath = rvb_fpath.replace("far_test", "cln_test").replace("near_test", "cln_test")
        ref_fpath = ref_fpath.replace("_ch1", "")
        rvb_y = load_wav(rvb_fpath, sr=self.sr).astype(np.float32)
        ref_y = load_wav(ref_fpath, sr=self.sr).astype(np.float32)
        rvb_y = rvb_y[: ref_y.shape[0]]
        return rvb_y, ref_y, utt_id
