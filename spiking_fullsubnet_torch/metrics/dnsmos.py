"""DNSMOS P.835 / P.808 perceptual quality predictors (a copy of
``spiking_fullsubnet_tpu/metrics/dnsmos.py``, which is plain numpy; reference
audiozen/metric.py:104-300).

The predictors are ONNX models run on the host CPU, never on the card;
``onnxruntime`` is optional: without it the classes raise ImportError at
construction, and the recipes run without DNSMOS (``dnsmos_or_none``).
``DNSMOS(..., sessions=(p835, p808))`` takes sessions built elsewhere
(objects with onnxruntime's ``.run(None, {"input_1": ...})``). The ONNX
files are Microsoft's DNSMOS release, in ``model_zoo/external/DNSMOS``
(``DNSMOS_MODEL_DIR`` / ``PDNSMOS_MODEL_DIR`` or ``model_dir`` override it).
The mel features, the 9.01 s windows and the polynomial MOS mapping follow
the reference, so that scores are comparable with the leaderboard.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_ZOO_EXTERNAL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "model_zoo", "external",
)

DEFAULT_MODEL_DIR = os.environ.get(
    "DNSMOS_MODEL_DIR", os.path.join(_ZOO_EXTERNAL, "DNSMOS")
)
DEFAULT_PDNSMOS_DIR = os.environ.get(
    "PDNSMOS_MODEL_DIR", os.path.join(_ZOO_EXTERNAL, "pDNSMOS")
)

_SAMPLERATE = 16000
_INPUT_LENGTH = 9.01


def _resample(x, orig_sr, target_sr):
    from scipy.signal import resample_poly

    g = np.gcd(int(orig_sr), int(target_sr))
    return resample_poly(x, target_sr // g, orig_sr // g)


def _mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """Slaney-style mel filterbank (librosa default), self-contained."""
    fmax = fmax or sr / 2

    def hz_to_mel(f):
        f = np.asarray(f, dtype=float)
        f_sp = 200.0 / 3
        mels = f / f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        log_region = f >= min_log_hz
        mels = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
        return mels

    def mel_to_hz(m):
        m = np.asarray(m, dtype=float)
        f_sp = 200.0 / 3
        freqs = f_sp * m
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        log_region = m >= min_log_mel
        freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
        return freqs

    # true rFFT bin frequencies: k * sr / n_fft. For the odd n_fft used by
    # the P.808 front-end (321) this is NOT linspace(0, sr/2) — the last bin
    # sits at 160*16000/321 = 7975.1 Hz (caught by the golden test against
    # an independent torch implementation; a linspace grid skews every
    # filter edge by up to 25 Hz).
    fftfreqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, len(fftfreqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights


def _melspectrogram(audio, sr=16000, n_fft=321, hop_length=160, n_mels=120):
    """librosa.feature.melspectrogram equivalent (power=2, centered reflect pad)."""
    pad = n_fft // 2
    x = np.pad(audio, pad, mode="reflect")
    n = 1 + (len(x) - n_fft) // hop_length
    window = np.hanning(n_fft + 1)[:-1]  # librosa uses a periodic hann
    frames = np.stack([x[i * hop_length : i * hop_length + n_fft] * window for i in range(n)])
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2  # [T, F]
    mel = _mel_filterbank(sr, n_fft, n_mels)
    return mel @ spec.T  # [n_mels, T]


def _power_to_db(s, ref=None, amin=1e-10, top_db=80.0):
    ref = np.max(s) if ref is None else ref
    log_spec = 10.0 * np.log10(np.maximum(amin, s)) - 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def _polyfit_vals(sig, bak, ovr, personalized=False):
    if personalized:
        p_ovr = np.poly1d([-0.00533021, 0.005101, 1.18058466, -0.11236046])
        p_sig = np.poly1d([-0.01019296, 0.02751166, 1.19576786, -0.24348726])
        p_bak = np.poly1d([-0.04976499, 0.44276479, -0.1644611, 0.96883132])
    else:
        p_ovr = np.poly1d([-0.06766283, 1.11546468, 0.04602535])
        p_sig = np.poly1d([-0.08397278, 1.22083953, 0.0052439])
        p_bak = np.poly1d([-0.13166888, 1.60915514, -0.39604546])
    return p_sig(sig), p_bak(bak), p_ovr(ovr)


class DNSMOS:
    """P.835 SIG/BAK/OVRL + P.808 MOS (metric.py:193-300).

    `sessions=(p835, p808)` injects pre-built inference sessions (objects
    with onnxruntime's `.run(None, {"input_1": ...})` interface) — used by
    the golden tests to pin the windowing/mel/polynomial protocol without
    onnxruntime, and usable to share sessions across workers.
    """

    def __init__(self, input_sr: int = 16000, device: int = -1,
                 model_dir: Optional[str] = None, sessions=None):
        if sessions is not None:
            self.p835_sess, self.p808_sess = sessions
            self.input_sr = input_sr
            return
        try:
            import onnxruntime as ort
        except ImportError as e:
            raise ImportError(
                "DNSMOS requires onnxruntime, which is not available in this "
                "environment. Install it or use a host that bundles it."
            ) from e
        if getattr(ort, "InferenceSession", None) is None:
            raise ImportError("onnxruntime is present but unusable (no InferenceSession).")
        model_dir = model_dir or DEFAULT_MODEL_DIR
        if device > -1:
            providers = [("CUDAExecutionProvider", {"device_id": device})]
        else:
            providers = ["CPUExecutionProvider"]
        self.p835_sess = ort.InferenceSession(os.path.join(model_dir, "sig_bak_ovr.onnx"), providers=providers)
        self.p808_sess = ort.InferenceSession(os.path.join(model_dir, "model_v8.onnx"), providers=providers)
        self.input_sr = input_sr

    def __call__(self, audio, return_p808: bool = True):
        audio = np.asarray(audio)
        if audio.ndim != 1:
            audio = audio.reshape(-1)
        if self.input_sr != _SAMPLERATE:
            audio = _resample(audio, self.input_sr, _SAMPLERATE)

        len_samples = int(_INPUT_LENGTH * _SAMPLERATE)
        while len(audio) < len_samples:
            audio = np.append(audio, audio)
        num_hops = int(np.floor(len(audio) / _SAMPLERATE) - _INPUT_LENGTH) + 1

        sig_seg, bak_seg, ovr_seg, p808_seg = [], [], [], []
        for idx in range(num_hops):
            seg = audio[int(idx * _SAMPLERATE) : int((idx + _INPUT_LENGTH) * _SAMPLERATE)]
            if len(seg) < len_samples:
                continue
            oi = {"input_1": seg.astype(np.float32)[None, :]}
            if return_p808:
                mel = _melspectrogram(seg[:-160]).astype(np.float32)
                mel = ((_power_to_db(mel) + 40) / 40).T[None, :, :]
                p808_seg.append(self.p808_sess.run(None, {"input_1": mel.astype(np.float32)})[0][0][0])
            sig_raw, bak_raw, ovr_raw = self.p835_sess.run(None, oi)[0][0]
            sig, bak, ovr = _polyfit_vals(sig_raw, bak_raw, ovr_raw)
            sig_seg.append(sig)
            bak_seg.append(bak)
            ovr_seg.append(ovr)

        out = {}
        if return_p808:
            out["P808"] = float(np.mean(p808_seg))
        out["OVRL"] = float(np.mean(ovr_seg))
        out["SIG"] = float(np.mean(sig_seg))
        out["BAK"] = float(np.mean(bak_seg))
        return out


class pDNSMOS:
    """Personalized DNSMOS (metric.py:104-190)."""

    def __init__(self, input_sr: int = 16000, model_dir: Optional[str] = None):
        try:
            import onnxruntime as ort
        except ImportError as e:
            raise ImportError("pDNSMOS requires onnxruntime.") from e
        if getattr(ort, "InferenceSession", None) is None:
            raise ImportError("onnxruntime is present but unusable (no InferenceSession).")
        model_dir = model_dir or DEFAULT_PDNSMOS_DIR
        self.sess = ort.InferenceSession(
            os.path.join(model_dir, "sig_bak_ovr.onnx"), providers=["CPUExecutionProvider"]
        )
        self.input_sr = input_sr

    def __call__(self, audio):
        audio = np.asarray(audio)
        if audio.ndim != 1:
            audio = audio.reshape(-1)
        if self.input_sr != _SAMPLERATE:
            audio = _resample(audio, self.input_sr, _SAMPLERATE)
        len_samples = int(_INPUT_LENGTH * _SAMPLERATE)
        while len(audio) < len_samples:
            audio = np.append(audio, audio)
        num_hops = int(np.floor(len(audio) / _SAMPLERATE) - _INPUT_LENGTH) + 1
        sig_seg, bak_seg, ovr_seg = [], [], []
        for idx in range(num_hops):
            seg = audio[int(idx * _SAMPLERATE) : int((idx + _INPUT_LENGTH) * _SAMPLERATE)]
            if len(seg) < len_samples:
                continue
            raw = self.sess.run(None, {"input_1": seg.astype(np.float32)[None, :]})[0][0]
            sig_seg.append(raw[0])
            bak_seg.append(raw[1])
            ovr_seg.append(raw[2])
        return {
            "pSIG": float(np.mean(sig_seg)),
            "pBAK": float(np.mean(bak_seg)),
            "pOVRL": float(np.mean(ovr_seg)),
        }


def dnsmos_or_none(input_sr: int = 16000) -> Optional[DNSMOS]:
    """``DNSMOS(input_sr)``, or None where ``onnxruntime`` does not import
    (the JAX recipes' ``try``/``except ImportError``)."""
    try:
        return DNSMOS(input_sr=input_sr)
    except ImportError:
        return None
