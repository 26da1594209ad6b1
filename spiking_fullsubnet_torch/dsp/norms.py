"""Signal-level loudness / RMS utilities (host-side numpy, dataset prep path):
a copy of ``spiking_fullsubnet_tpu/dsp/norms.py``.

Re-design of reference audiozen/acoustics/audio_feature.py:73-196,350-429.
These run in the input pipeline on the host CPU, so they are numpy, not jnp.
"""

from __future__ import annotations

import numpy as np

EPSILON = float(np.finfo(float).eps)


def compute_rms(y: np.ndarray) -> float:
    """Root mean square (audio_feature.py:73-75)."""
    return float(np.sqrt(np.mean(y**2)))


def norm_amplitude(y: np.ndarray, scalar=None, eps: float = EPSILON):
    """Peak normalization (audio_feature.py:350-354)."""
    if not scalar:
        scalar = np.max(np.abs(y)) + eps
    return y / scalar, scalar


def is_clipped(y: np.ndarray, clipping_threshold: float = 0.999) -> bool:
    """(audio_feature.py:357-359)"""
    return bool((np.abs(y) > clipping_threshold).any())


def loudness_max_norm(y: np.ndarray, scalar=None, ref_mic: int = 0, eps: float = EPSILON):
    """Maximum loudness normalization (audio_feature.py:78-92)."""
    if not scalar:
        scalar = (np.max(np.abs(y)) if y.ndim == 1 else np.max(np.abs(y[ref_mic, :]))) + eps
    return y / scalar, scalar


def loudness_rms_norm(y: np.ndarray, scalar=None, lvl: float = -25, ref_mic: int = 0, eps: float = EPSILON):
    """RMS-based loudness normalization to lvl dBFS (audio_feature.py:95-122)."""
    if not scalar:
        current = compute_rms(y) if y.ndim == 1 else compute_rms(y[ref_mic, :])
        scalar = 10 ** (lvl / 20) / (current + eps)
    return y * scalar, scalar


def normalize_segmental_rms(audio, rms, target_lvl: float = -25, eps: float = EPSILON):
    """(audio_feature.py:159-172)"""
    scalar = 10 ** (target_lvl / 20) / (rms + eps)
    return audio * scalar


def active_rms(clean, noise, sr: int = 16000, energy_threshold: float = -50, eps: float = EPSILON):
    """Active-segment RMS of clean/noise (audio_feature.py:125-156)."""
    window_samples = int(sr * 100 / 1000)
    noise_active, clean_active = [], []
    for start in range(0, len(noise), window_samples):
        end = min(start + window_samples, len(noise))
        noise_win, clean_win = noise[start:end], clean[start:end]
        if compute_rms(noise_win) > energy_threshold:
            noise_active.append(noise_win)
            clean_active.append(clean_win)
    noise_rms = compute_rms(np.concatenate(noise_active)) if noise_active else eps
    clean_rms = compute_rms(np.concatenate(clean_active)) if clean_active else eps
    return clean_rms, noise_rms


def sxr2gain(meaningful, meaningless, desired_ratio: float, eps: float = EPSILON) -> float:
    """Gain on interference to reach a target SNR/SIR (audio_feature.py:175-195)."""
    return compute_rms(meaningful) / (10 ** (desired_ratio / 20)) / (compute_rms(meaningless) + eps)


def tune_dB_FS(y, target_dB_FS: float = -26, eps: float = EPSILON):
    """Scale signal RMS to target dBFS (audio_feature.py:362-382)."""
    rms = np.sqrt(np.mean(np.asarray(y) ** 2))
    scalar = 10 ** (target_dB_FS / 20) / (rms + eps)
    return y * scalar, rms, scalar


def activity_detector(audio, fs: int = 16000, activity_threshold: float = 0.13, target_level: float = -25, eps: float = EPSILON):
    """Fraction of frames above a smoothed energy threshold (audio_feature.py:385-429)."""
    audio, _ = loudness_rms_norm(audio, lvl=target_level)
    window_samples = int(fs * 50 / 1000)
    cnt = active_frames = 0
    prev_energy_prob = 0.0
    a, b, alpha_rel, alpha_att = -1, 0.2, 0.05, 0.8
    for start in range(0, len(audio), window_samples):
        win = audio[start : min(start + window_samples, len(audio))]
        frame_rms = 20 * np.log10(np.sum(win**2) + eps)
        frame_energy_prob = 1.0 / (1 + np.exp(-(a + b * frame_rms)))
        if frame_energy_prob > prev_energy_prob:
            smoothed = frame_energy_prob * alpha_att + prev_energy_prob * (1 - alpha_att)
        else:
            smoothed = frame_energy_prob * alpha_rel + prev_energy_prob * (1 - alpha_rel)
        if smoothed > activity_threshold:
            active_frames += 1
        prev_energy_prob = frame_energy_prob
        cnt += 1
    return active_frames / cnt if cnt else 0.0
