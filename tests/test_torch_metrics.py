"""The port's metrics against spiking_fullsubnet_tpu.metrics.

SI-SDR, STOI (and extended STOI) and PESQ (the in-repo P.862 fallback,
wideband and narrowband) on the same numpy inputs, rtol 1e-6; synops and
neuron ops over a layered forward's collect lists in float64, the port's
lists from its own forward and the JAX package's from its own, on the
same weights.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu import metrics as JM
from spiking_fullsubnet_tpu.models import spiking_fullsubnet as JSF

from spiking_fullsubnet_torch import metrics as PM
from spiking_fullsubnet_torch.models import spiking_fullsubnet as PSF
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy


def _speech(seed, n=24000, sr=16000):
    """An AM harmonic stack (tests/test_spiking_fullsubnet.py:212-234's
    fixture) and a noisy copy of it."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    phase = 2 * np.pi * np.cumsum(120 + 20 * np.sin(2 * np.pi * 2.3 * t)) / sr
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t - 1.2))
    clean = 0.2 * env * sum(np.sin(k * phase) / k for k in range(1, 9))
    return clean, clean + 0.05 * rng.standard_normal(n)


@pytest.mark.parametrize("seed", [0, 1])
def test_sisdr_and_stoi_match_jax(seed):
    clean, noisy = _speech(seed)
    est = noisy.astype(np.float32)
    np.testing.assert_allclose(PM.SISDR()(est, clean)["si_sdr"], JM.SISDR()(est, clean)["si_sdr"],
                               rtol=1e-6)
    batch = np.stack([est, clean.astype(np.float32)])
    np.testing.assert_allclose(PM.si_sdr_value(batch, np.stack([clean, clean]), False),
                               JM.si_sdr_value(batch, np.stack([clean, clean]), False), rtol=1e-6)
    for extended in (False, True):
        got = PM.STOI(sr=16000)(est, clean, extended=extended)["stoi"]
        ref = JM.STOI(sr=16000)(est, clean, extended=extended)["stoi"]
        assert 0.0 < got < 1.0
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.isnan(PM.STOI(sr=16000)(est[:3000], clean[:3000])["stoi"])
    # torch tensors are accepted as the JAX metrics accept them
    assert PM.SISDR()(torch.from_numpy(est), torch.from_numpy(clean))["si_sdr"] == \
        PM.SISDR()(est, clean)["si_sdr"]


@pytest.mark.parametrize("mode,sr", [("wb", 16000), ("nb", 8000), ("nb", 16000)])
def test_pesq_fallback_matches_jax(mode, sr):
    clean, noisy = _speech(2, n=2 * sr, sr=sr)
    got = PM.PESQ(sr=sr, mode=mode, backend="numpy")(noisy, clean)
    ref = JM.PESQ(sr=sr, mode=mode, backend="numpy")(noisy, clean)
    assert got["pesq_backend"] == ref["pesq_backend"] == "numpy_p862"
    assert 1.0 <= got[f"pesq_{mode}"] <= 4.7
    np.testing.assert_allclose(got[f"pesq_{mode}"], ref[f"pesq_{mode}"], rtol=1e-6)
    with pytest.raises(ValueError, match="Unsupported mode"):
        PM.PESQ(mode="xb")


TINY = dict(n_fft=512, hop_length=128, win_length=512, fdrc=0.5, fb_input_size=64,
            fb_hidden_size=64, fb_num_layers=2, fb_proj_size=64, fb_output_activate_function=None,
            sb_hidden_size=32, sb_num_layers=2, freq_cutoffs=(0, 32, 128, 256),
            df_orders=(3, 2, 1), center_freq_sizes=(4, 32, 64), neighbor_freq_sizes=(15, 15, 15),
            bn=True, sequence_model="GSN")


@pytest.mark.parametrize("shared", [True, False])
def test_synops_over_layered_collect_lists_match_jax_f64(shared):
    jcfg = JSF.SpikingFullSubNetConfig(**TINY, shared_weights=shared)
    params, state = JSF.spiking_fullsubnet_init(jax.random.PRNGKey(4), jcfg)
    p64, s64 = (jax.tree.map(lambda x: np.asarray(x, np.float64), t) for t in (params, state))
    noisy = np.stack([_speech(s)[1] for s in (3, 4)])[:, :4000]
    ref = jax.jit(functools.partial(JSF.spiking_fullsubnet_apply, jcfg))(
        jax.tree.map(jnp.asarray, p64), jax.tree.map(jnp.asarray, s64), jnp.asarray(noisy))
    out = PSF.spiking_fullsubnet_apply(PSF.SpikingFullSubNetConfig(**TINY, shared_weights=shared),
                                       params_from_numpy(p64, "cpu"),
                                       params_from_numpy(s64, "cpu"), torch.from_numpy(noisy))
    fb, sb = out["fb_all_layer_outputs"], out["sb_all_layer_outputs"]
    jfb, jsb = ref["fb_all_layer_outputs"], ref["sb_all_layer_outputs"]
    assert len(fb) == len(jfb) and [len(s) for s in sb] == [len(s) for s in jsb]
    want = JM.compute_synops(jfb, jsb, shared)
    assert want > 0
    got = PM.compute_synops(fb, sb, shared)
    dev = PM.synops_device(fb, sb, shared)
    assert dev.dtype == torch.float64
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert dev.item() == got  # exact spike counts: the device sum is the host one
    assert PM.compute_neuronops(fb, sb) == JM.compute_neuronops(jfb, jsb)
