"""The port's DNSMOS (metrics/dnsmos.py) against the JAX package's, and its
use in the recipes.

- the mel filterbank (P.808's odd n_fft 321 and an even one), the mel
  spectrogram, the dB conversion and both polynomial mappings: equal to
  JAX's bit for bit (both are float64 numpy);
- DNSMOS and pDNSMOS on audio shorter than a window, one window and
  several, at 16 kHz and resampled from 8 kHz: every score equal, with the
  same fake sessions (their outputs depend on each window's samples, and
  P.808's on its mel features), and the sessions fed the same windows;
- the GAN trainers' ``batch_mos`` with a DNSMOS session: ``(score - 1) /
  4`` per target, equal to JAX's; without one, the clamped SI-SDR;
- the recipes build DNSMOS where ``onnxruntime`` imports and go without
  it otherwise, as JAX's do; with a session, a recipe's validation CSV
  carries its four columns;
- the real ONNX models, where ``onnxruntime`` is installed: the port's
  scores equal JAX's.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from spiking_fullsubnet_tpu.metrics import dnsmos as JD
from spiking_fullsubnet_tpu.recipes.gan import GanDenoiseTrainer as JaxGan

from spiking_fullsubnet_torch.metrics import dnsmos as PD
from spiking_fullsubnet_torch.recipes.gan import GanDenoiseTrainer as PortGan


@pytest.mark.parametrize("n_fft,n_mels", [(321, 120), (512, 64)])
def test_mel_filterbank_equals_jax(n_fft, n_mels):
    np.testing.assert_array_equal(PD._mel_filterbank(16000, n_fft, n_mels),
                                  JD._mel_filterbank(16000, n_fft, n_mels))


def test_mel_db_and_polynomials_equal_jax():
    x = np.random.default_rng(0).standard_normal(16000 * 2) * 0.1
    mel = PD._melspectrogram(x)
    np.testing.assert_array_equal(mel, JD._melspectrogram(x))
    assert mel.shape == (120, 1 + (len(x) + 2 * 160 - 321) // 160)
    np.testing.assert_array_equal(PD._power_to_db(mel), JD._power_to_db(mel))
    np.testing.assert_array_equal(PD._power_to_db(mel, ref=1.0, top_db=None),
                                  JD._power_to_db(mel, ref=1.0, top_db=None))
    raw = np.linspace(1.0, 5.0, 7)
    for personalized in (False, True):
        for got, ref in zip(PD._polyfit_vals(raw, raw + 0.1, raw - 0.1, personalized),
                            JD._polyfit_vals(raw, raw + 0.1, raw - 0.1, personalized)):
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(PD._resample(x, 8000, 16000), JD._resample(x, 8000, 16000))


class _P835:
    """A fake P.835 session: SIG, BAK, OVRL from the window's samples."""

    def __init__(self):
        self.fed = []

    def run(self, _none, feed):
        w = feed["input_1"]
        assert w.shape == (1, 144160) and w.dtype == np.float32
        self.fed.append(w.copy())
        return [np.array([[3.0 + w.mean() * 10, 2.0 + w.std() * 5, 2.5 + np.abs(w).max()]],
                         np.float32)]


class _P808:
    """A fake P.808 session: the mean of the normalized mel features."""

    def run(self, _none, feed):
        m = feed["input_1"]
        assert m.shape == (1, 900, 120) and m.dtype == np.float32
        return [np.array([[1.0 + float(m.mean())]], np.float32)]


@pytest.mark.parametrize("seconds,sr", [(3.0, 16000), (9.01, 16000), (11.5, 16000),
                                        (10.0, 8000)])
def test_dnsmos_and_pdnsmos_equal_jax_with_the_same_sessions(seconds, sr):
    audio = (np.random.default_rng(1).standard_normal(int(seconds * sr)) * 0.1).astype(np.float32)
    got_s, ref_s = (_P835(), _P808()), (_P835(), _P808())
    got = PD.DNSMOS(input_sr=sr, sessions=got_s)(audio)
    ref = JD.DNSMOS(input_sr=sr, sessions=ref_s)(audio)
    assert list(got) == ["P808", "OVRL", "SIG", "BAK"] and got == ref
    assert len(got_s[0].fed) == len(ref_s[0].fed) >= 1
    for a, b in zip(got_s[0].fed, ref_s[0].fed):
        np.testing.assert_array_equal(a, b)
    assert PD.DNSMOS(input_sr=sr, sessions=(_P835(), _P808()))(audio, return_p808=False) == \
        JD.DNSMOS(input_sr=sr, sessions=(_P835(), _P808()))(audio, return_p808=False)
    # pDNSMOS takes no sessions argument in either package: set its session
    p, j = object.__new__(PD.pDNSMOS), object.__new__(JD.pDNSMOS)
    p.sess, p.input_sr, j.sess, j.input_sr = _P835(), sr, _P835(), sr
    assert p(audio) == j(audio) and list(p(audio)) == ["pSIG", "pBAK", "pOVRL"]


@pytest.mark.parametrize("with_dnsmos", [True, False], ids=["dnsmos", "si_sdr"])
def test_gan_batch_mos_equals_jax(with_dnsmos):
    rng = np.random.default_rng(2)
    clean = (rng.standard_normal((3, 16000)) * 0.1).astype(np.float32)
    enh = (clean + rng.standard_normal((3, 16000)) * 0.05).astype(np.float32)
    targets = ["OVRL", "SIG", "BAK"]
    mos = lambda: PD.DNSMOS(sessions=(_P835(), _P808())) if with_dnsmos else None  # noqa: E731
    got = PortGan.batch_mos(SimpleNamespace(dns_mos=mos()), enh, clean, targets)
    ref = JaxGan.batch_mos(SimpleNamespace(dns_mos=mos()), enh, clean, targets)
    assert list(got) == targets
    for t in targets:
        assert got[t].shape == (3, 1) and got[t].dtype == np.float32
        np.testing.assert_array_equal(got[t], ref[t])
    if with_dnsmos:
        scores = PD.DNSMOS(sessions=(_P835(), _P808()))(enh[0], return_p808=False)
        assert got["SIG"][0, 0] == np.float32((scores["SIG"] - 1.0) / 4.0)


def _onnxruntime_usable() -> bool:
    """Whether ``onnxruntime`` imports with an ``InferenceSession`` (another
    test file may leave a stub module under its name)."""
    try:
        import onnxruntime
    except ImportError:
        return False
    return getattr(onnxruntime, "InferenceSession", None) is not None


def test_recipes_build_dnsmos_where_onnxruntime_imports(monkeypatch):
    from spiking_fullsubnet_torch.metrics import dnsmos_or_none
    if not _onnxruntime_usable():
        assert dnsmos_or_none(16000) is None
        with pytest.raises(ImportError, match="onnxruntime"):
            PD.DNSMOS()
        with pytest.raises(ImportError, match="onnxruntime"):
            PD.pDNSMOS()
    # a session built by the caller stands in for onnxruntime's
    monkeypatch.setattr(PD, "DNSMOS", lambda input_sr: ("built", input_sr))
    assert dnsmos_or_none(8000) == ("built", 8000)
    assert PD.DEFAULT_MODEL_DIR.endswith("model_zoo/external/DNSMOS")


def test_onnx_models_score_as_jax():
    if not _onnxruntime_usable():
        pytest.skip("onnxruntime is not installed: the ONNX models cannot run")
    audio = (np.random.default_rng(3).standard_normal(16000 * 10) * 0.1).astype(np.float32)
    assert PD.DNSMOS()(audio) == JD.DNSMOS()(audio)
    assert PD.pDNSMOS()(audio) == JD.pDNSMOS()(audio)


def test_validation_adds_the_dnsmos_columns(tmp_path, monkeypatch):
    from spiking_fullsubnet_torch.recipes import denoise
    from spiking_fullsubnet_torch.runtime import cli
    monkeypatch.setattr(denoise, "dnsmos_or_none",
                        lambda sr: PD.DNSMOS(input_sr=sr, sessions=(_P835(), _P808())))
    monkeypatch.chdir(tmp_path)
    recipe = Path(__file__).resolve().parent.parent / "recipes" / "intel_ndns" / "sdnn_delays"
    shutil.copy(recipe / "tiny_synthetic.toml", tmp_path / "tiny_synthetic.toml")
    t = cli.main(["-C", "tiny_synthetic.toml", "-M", "train", "--device", "cpu"],
                 recipe_dir=recipe)
    assert t.dns_mos is not None
    mean = sorted((tmp_path / "exp" / "tiny_synthetic" / "metrics").glob("*_mean.csv"))[-1]
    assert mean.read_text().splitlines()[0].split(",") == ["si_sdr", "stoi", "P808", "OVRL",
                                                           "SIG", "BAK"]
