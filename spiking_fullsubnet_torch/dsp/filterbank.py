"""Bark-scale triangular filterbank (counterpart of
``spiking_fullsubnet_tpu/dsp/filterbank.py``, the port's own copy; reference
audiozen/acoustics/filterbank.py). numpy, as in the JAX package: the matrix
is a constant that a caller moves to its device."""

from __future__ import annotations

import numpy as np


def hz_to_bark(hz):
    return 26.81 / (1 + 1960.0 / hz) - 0.53


def bark_to_hz(bark):
    return 1960.0 / (26.81 / (0.53 + bark) - 1)


def bark_filter_bank(num_filters: int, n_fft: int, sr: int, low_freq: float,
                     high_freq: float) -> np.ndarray:
    """Triangular bark filterbank matrix [num_filters, n_fft//2+1] (filterbank.py:13-40)."""
    high_freq = high_freq or sr / 2
    if high_freq > sr / 2:
        raise ValueError("highfreq is greater than samplerate/2")

    low_bark = hz_to_bark(low_freq)
    high_bark = hz_to_bark(high_freq)
    barkpoints = np.linspace(low_bark, high_bark, num_filters + 2)
    bins = np.floor((n_fft + 1) * bark_to_hz(barkpoints) / sr)

    fbank = np.zeros([num_filters, n_fft // 2 + 1])
    for j in range(num_filters):
        for i in range(int(bins[j]), int(bins[j + 1])):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(int(bins[j + 1]), int(bins[j + 2])):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank
