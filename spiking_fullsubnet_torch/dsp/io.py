"""Audio file IO and cropping for the host input pipeline (counterpart of
``spiking_fullsubnet_tpu/dsp/io.py``; reference audiozen/acoustics/io.py).

WAVs are read and written with ``scipy.io.wavfile`` and resampled with
``scipy.signal.resample_poly``: the JAX package's scipy path. Its native
reader (``native/wavio.py``) gives the same values and is not carried over.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def _to_float(y: np.ndarray) -> np.ndarray:
    if y.dtype == np.int16:
        return (y / 32768.0).astype(np.float32)
    if y.dtype == np.int32:
        return (y / 2147483648.0).astype(np.float32)
    if y.dtype == np.uint8:
        return ((y.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
    return y.astype(np.float32)


def _resample(y: np.ndarray, orig_sr: int, sr: int) -> np.ndarray:
    g = np.gcd(int(sr), int(orig_sr))
    return resample_poly(y, sr // g, orig_sr // g, axis=-1).astype(np.float32)


def load_wav(wav_path: Union[str, Path], sr: Optional[int] = None) -> np.ndarray:
    """Load a wav file as float32 [T] (mono) or [C, T]. Optionally resample."""
    orig_sr, y = wavfile.read(str(wav_path))
    y = _to_float(np.asarray(y))
    if y.ndim == 2:
        y = y.T  # [C, T]
    if sr is not None and sr != orig_sr:
        y = _resample(y, orig_sr, sr)
    return y


def save_wav(data, fpath: Union[str, Path], sr: int) -> None:
    """Write a float waveform to a 16-bit PCM wav, clipped to [-1, 1]
    (audio_feature.py:213-220)."""
    data = np.clip(np.asarray(data).reshape(-1), -1.0, 1.0)
    wavfile.write(str(fpath), sr, (data * 32767.0).astype(np.int16))


def load_audio(
    path: Union[str, Path],
    duration: Optional[float] = None,
    sr: Optional[int] = None,
    mode: str = "wrap",
    rng: Optional[np.random.Generator] = None,
    **kwargs,
) -> Tuple[np.ndarray, int]:
    """Load audio, optionally a random segment of ``duration`` seconds: a
    random offset when the file is longer, padding (``mode``, default
    "wrap") when shorter (reference io.py:9-60)."""
    orig_sr, y = wavfile.read(str(path))
    y = _to_float(np.asarray(y))
    if y.ndim == 2:
        y = y.T  # [C, T]
    y2 = y if y.ndim == 2 else y[None, :]

    if duration is not None:
        frame_duration = int(duration * orig_sr)
        t = y2.shape[-1]
        if frame_duration < t:
            offset = (int(rng.integers(t - frame_duration)) if rng is not None
                      else int(np.random.randint(t - frame_duration)))
            y2 = y2[:, offset: offset + frame_duration]
        elif frame_duration > t:
            y2 = np.pad(y2, ((0, 0), (0, frame_duration - t)), mode=mode, **kwargs)

    y = y2.flatten() if y2.shape[0] == 1 else y2
    if sr is not None and sr != orig_sr:
        y = _resample(y, orig_sr, sr)
        orig_sr = sr
    return y, orig_sr


def subsample(
    data: np.ndarray,
    subsample_length: int,
    start_idx: int = -1,
    return_start_idx: bool = False,
    rng: Optional[np.random.Generator] = None,
):
    """Sample an aligned crop from 1D data (reference io.py:62-104)."""
    if np.ndim(data) != 1:
        raise ValueError(f"Only support 1D data. The dim is {np.ndim(data)}")
    if subsample_length < 0:
        raise ValueError("subsample_length must be non-negative")

    data_len = len(data)
    if data_len > subsample_length:
        if start_idx < 0:
            if rng is not None:
                start_idx = int(rng.integers(data_len - subsample_length))
            else:
                start_idx = int(np.random.randint(data_len - subsample_length))
        data = data[start_idx: start_idx + subsample_length]
    elif data_len < subsample_length:
        data = np.pad(data, (0, subsample_length - data_len), "constant")
        start_idx = 0
    if return_start_idx:
        return data, start_idx
    return data


def find_files(path_or_path_list, offset: int = 0, limit: Optional[int] = None):
    """Collect wav paths from dirs, .wav files and list files
    (audio_feature.py:15-62)."""
    if not isinstance(path_or_path_list, list):
        path_or_path_list = [path_or_path_list]

    output_paths = []
    for path in path_or_path_list:
        path = Path(path).expanduser().resolve()
        if path.is_dir():
            output_paths += sorted(
                os.path.join(root, f)
                for root, _, files in os.walk(path)
                for f in files
                if f.lower().endswith(".wav")
            )
        elif path.is_file():
            if path.suffix == ".wav":
                output_paths.append(path.as_posix())
            else:
                with open(path) as f:
                    output_paths += [Path(line.rstrip("\n")).resolve().as_posix() for line in f]

    if offset > 0:
        output_paths = output_paths[offset:]
    if limit:
        output_paths = output_paths[:limit]
    return output_paths
