"""Waveform quality metrics (a copy of ``spiking_fullsubnet_tpu/metrics/metrics.py``).

SISDR replicates reference audiozen/metric.py:67-101 exactly (eps guards
included). STOI is a self-contained numpy implementation of the standard
algorithm (Taal et al. 2011) since pystoi is not available in this image;
PESQ delegates to the `pesq` wheel when importable and raises a clear error
otherwise (metric.py:42-64).
"""

from __future__ import annotations

import numpy as np


def _to_numpy(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def preprocessing(est, ref):
    """Flatten + shape check (metric.py:18-29)."""
    est, ref = _to_numpy(est), _to_numpy(ref)
    if est.ndim != 1 or ref.ndim != 1:
        est, ref = est.reshape(-1), ref.reshape(-1)
    if est.shape != ref.shape:
        raise ValueError(f"Shape mismatch: {est.shape} vs {ref.shape}")
    return est, ref


def si_sdr_value(estimate, target, reduce_mean: bool = True) -> float:
    """SI-SDR in dB (metric.py:67-101 semantics, incl. the eps placements)."""
    est, ref = _to_numpy(estimate).astype(np.float32), _to_numpy(target).astype(np.float32)
    eps = np.finfo(est.dtype).eps
    s_target = ref - ref.mean(axis=-1, keepdims=True)
    s_estimate = est - est.mean(axis=-1, keepdims=True)
    dot = np.sum(s_target * s_estimate, axis=-1, keepdims=True)
    norm = np.sum(s_target**2, axis=-1, keepdims=True)
    proj = (dot * s_target + eps) / (norm + eps)
    e_noise = s_estimate - proj
    ratio = (np.sum(proj**2, axis=-1) + eps) / (np.sum(e_noise**2, axis=-1) + eps)
    val = 10 * np.log10(ratio + eps)
    return float(np.mean(val)) if reduce_mean else val


class SISDR:
    def __call__(self, estimate, target, reduce_mean: bool = True):
        return {"si_sdr": si_sdr_value(estimate, target, reduce_mean)}


# ------------------------------------------------------------------ STOI

_STOI_SR = 10000
_STOI_NFFT = 512
_STOI_HOP = 256  # 50% overlap of 256-sample frames... (frame len 256, hop 128)
_STOI_FRAME = 256
_STOI_SHIFT = 128
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_N = 30  # analysis length in frames (384 ms)
_STOI_BETA = -15.0  # lower SDR bound dB
_STOI_DYN_RANGE = 40.0


def _resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    from scipy.signal import resample_poly

    g = np.gcd(int(orig_sr), int(target_sr))
    return resample_poly(x, target_sr // g, orig_sr // g)


def _thirdoct(sr, nfft, num_bands, min_freq):
    """Third-octave band matrix (standard STOI construction)."""
    f = np.linspace(0, sr, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=float)
    cf = 2 ** (k / 3) * min_freq
    lo = 2 ** ((2 * k - 1) / 6) * min_freq
    hi = 2 ** ((2 * k + 1) / 6) * min_freq
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_i = np.argmin((f - lo[i]) ** 2)
        fh_i = np.argmin((f - hi[i]) ** 2)
        obm[i, fl_i:fh_i] = 1
    return obm, cf


def _remove_silent_frames(x, y, dyn_range, frame_len, hop):
    w = np.hanning(frame_len + 2)[1:-1]
    n = 1 + (len(x) - frame_len) // hop
    frames_x = np.stack([x[i * hop : i * hop + frame_len] * w for i in range(n)])
    frames_y = np.stack([y[i * hop : i * hop + frame_len] * w for i in range(n)])
    energies = 20 * np.log10(np.linalg.norm(frames_x, axis=1) + np.finfo(float).eps)
    mask = (np.max(energies) - dyn_range - energies) < 0
    frames_x, frames_y = frames_x[mask], frames_y[mask]
    # overlap-add back
    out_len = frame_len + (len(frames_x) - 1) * hop
    x_out = np.zeros(out_len)
    y_out = np.zeros(out_len)
    for i, (fx, fy) in enumerate(zip(frames_x, frames_y)):
        x_out[i * hop : i * hop + frame_len] += fx
        y_out[i * hop : i * hop + frame_len] += fy
    return x_out, y_out


def _stft_mag(x, frame_len, hop, nfft):
    w = np.hanning(frame_len + 2)[1:-1]
    n = 1 + (len(x) - frame_len) // hop
    frames = np.stack([x[i * hop : i * hop + frame_len] * w for i in range(n)])
    return np.abs(np.fft.rfft(frames, n=nfft, axis=1))  # [T, F]


def stoi(ref: np.ndarray, est: np.ndarray, sr: int, extended: bool = False) -> float:
    """Short-Time Objective Intelligibility (Taal et al., 2011)."""
    ref, est = np.asarray(ref, float), np.asarray(est, float)
    if sr != _STOI_SR:
        ref = _resample(ref, sr, _STOI_SR)
        est = _resample(est, sr, _STOI_SR)
    ref, est = _remove_silent_frames(ref, est, _STOI_DYN_RANGE, _STOI_FRAME, _STOI_SHIFT)
    if len(ref) < _STOI_FRAME:
        return float("nan")

    obm, _ = _thirdoct(_STOI_SR, _STOI_NFFT, _STOI_NBANDS, _STOI_MINFREQ)
    X = np.sqrt(obm @ (_stft_mag(ref, _STOI_FRAME, _STOI_SHIFT, _STOI_NFFT).T ** 2))  # [bands, T]
    Y = np.sqrt(obm @ (_stft_mag(est, _STOI_FRAME, _STOI_SHIFT, _STOI_NFFT).T ** 2))

    if X.shape[1] < _STOI_N:
        return float("nan")

    if extended:
        corrs = []
        for m in range(_STOI_N, X.shape[1] + 1):
            Xs = X[:, m - _STOI_N : m]
            Ys = Y[:, m - _STOI_N : m]
            Xs = Xs / (np.linalg.norm(Xs, axis=1, keepdims=True) + np.finfo(float).eps)
            Ys = Ys / (np.linalg.norm(Ys, axis=1, keepdims=True) + np.finfo(float).eps)
            Xs = Xs - Xs.mean(axis=0, keepdims=True)
            Ys = Ys - Ys.mean(axis=0, keepdims=True)
            Xs = Xs / (np.linalg.norm(Xs, axis=0, keepdims=True) + np.finfo(float).eps)
            Ys = Ys / (np.linalg.norm(Ys, axis=0, keepdims=True) + np.finfo(float).eps)
            corrs.append(np.sum(Xs * Ys) / _STOI_N)
        return float(np.mean(corrs))

    d_sum = 0.0
    count = 0
    c = 10 ** (-_STOI_BETA / 20)
    for m in range(_STOI_N, X.shape[1] + 1):
        Xs = X[:, m - _STOI_N : m]  # [bands, N]
        Ys = Y[:, m - _STOI_N : m]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + np.finfo(float).eps
        )
        Ys_n = Ys * alpha
        Ys_n = np.minimum(Ys_n, Xs * (1 + c))
        xm = Xs - Xs.mean(axis=1, keepdims=True)
        ym = Ys_n - Ys_n.mean(axis=1, keepdims=True)
        rho = np.sum(xm * ym, axis=1) / (
            np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + np.finfo(float).eps
        )
        d_sum += np.sum(rho)
        count += len(rho)
    return float(d_sum / count)


class STOI:
    """STOI metric wrapper (metric.py:32-39)."""

    def __init__(self, sr: int = 16000) -> None:
        self.sr = sr

    def __call__(self, est, ref, extended: bool = False):
        est, ref = preprocessing(est, ref)
        return {"stoi": float(stoi(ref, est, self.sr, extended=extended))}


class PESQ:
    """PESQ metric wrapper (metric.py:42-64).

    Uses the `pesq` wheel (the compiled ITU-T P.862 reference code) when it
    is importable; otherwise falls back to the self-contained numpy
    implementation in pesq_p862.py (P.862-structured, documented
    approximations — see that module's docstring), so the metric always
    executes. `backend` forces one of "itu" / "numpy" / "auto".
    """

    def __init__(self, sr: int = 16000, mode: str = "wb", backend: str = "auto") -> None:
        if mode not in ("wb", "nb"):
            raise ValueError(f"Unsupported mode: {mode}. Expected 'wb' or 'nb'.")
        if backend not in ("auto", "itu", "numpy"):
            raise ValueError(f"Unsupported backend: {backend}.")
        self.sr = sr
        self.mode = mode
        self.backend = backend
        self._warned = False

    def __call__(self, est, ref):
        est, ref = preprocessing(est, ref)
        sr, mode = self.sr, self.mode
        if sr not in (8000, 16000) or (mode == "wb" and sr != 16000):
            ref = _resample(ref, sr, 16000)
            est = _resample(est, sr, 16000)
            sr = 16000
        backend = self.backend
        if backend in ("auto", "itu"):
            try:
                from pesq import pesq as pesq_backend

                return {
                    f"pesq_{mode}": float(pesq_backend(sr, ref, est, mode)),
                    "pesq_backend": "itu",
                }
            except ImportError:
                if backend == "itu":
                    raise ImportError(
                        "PESQ backend='itu' requires the `pesq` package "
                        "(ITU-T P.862 reference binary)."
                    )
        if not self._warned:
            import logging

            logging.getLogger(__name__).warning(
                "pesq wheel unavailable — scoring with the self-contained "
                "P.862-structured implementation (metrics/pesq_p862.py); "
                "values track but do not bit-match the ITU binary."
            )
            self._warned = True
        from .pesq_p862 import pesq_p862

        # pesq_backend makes persisted artifacts (CSVs, board rows)
        # self-describing: the numpy reconstruction tracks but does not
        # bit-match the ITU binary. String-valued, so numeric_only
        # aggregations skip it.
        return {
            f"pesq_{mode}": pesq_p862(ref, est, fs=sr, mode=mode),
            "pesq_backend": "numpy_p862",
        }
