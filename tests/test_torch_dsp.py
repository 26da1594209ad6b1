"""The port's DSP and small helpers against the JAX package.

STFT/iSTFT tolerances: f64 atol 1e-9, f32 atol 1e-5 at audio amplitude
(0.1 rms). The STFT is held against the JAX package's matmul-DFT branch,
the one the port carries (it differs from the FFT branch only in the
frames past the natural count, which read the padded tail).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spiking_fullsubnet_tpu.dsp import spectral as S
from spiking_fullsubnet_tpu.dsp.mask import EPSILON as JAX_EPSILON
from spiking_fullsubnet_tpu.nn import core as jcore

from spiking_fullsubnet_torch.dsp import spectral as TS
from spiking_fullsubnet_torch.dsp.mask import EPSILON
from spiking_fullsubnet_torch.nn.core import cast_floating, output_activation

TOL = {np.float64: 1e-9, np.float32: 1e-5}


@pytest.fixture
def matmul_dft():
    old = S.DFT_MODE
    S.DFT_MODE = "matmul"
    yield
    S.DFT_MODE = old


def test_hann_window_and_num_frames():
    np.testing.assert_array_equal(TS.hann_window(512, torch.float64).numpy(),
                                  np.asarray(S.hann_window(512, jnp.float64)))
    np.testing.assert_allclose(TS.hann_window(400).numpy(), torch.hann_window(400).numpy(),
                               atol=3e-7)
    for n in (0, 1, 127, 128, 12345, 480000):
        assert TS.num_frames(n, 512, 128) == S.num_frames(n, 512, 128)
        assert TS.num_frames(n + 512, 512, 128, center=False) == S.num_frames(
            n + 512, 512, 128, center=False)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("extra", [0, 13])
def test_stft_tmajor_matches_jax(matmul_dft, dtype, extra):
    y = (np.random.default_rng(0).standard_normal((3, 12345)) * 0.1).astype(dtype)
    n = S.num_frames(12345, 512, 128) + extra
    re_j, im_j = S.stft_real_imag_tmajor(jnp.asarray(y), 512, 128, 512, n_frames_out=n)
    re, im = TS.stft_real_imag_tmajor(torch.from_numpy(y), 512, 128, 512, n_frames_out=n)
    assert re.shape == (n, 3, 257) and re.dtype == torch.from_numpy(y).dtype
    np.testing.assert_allclose(re.numpy(), np.asarray(re_j), atol=TOL[dtype])
    np.testing.assert_allclose(im.numpy(), np.asarray(im_j), atol=TOL[dtype])


def test_stft_bf16_matmul_matches_jax_matmul_dft(matmul_dft):
    """bf16-rounded DFT inputs with f32 sums in both packages."""
    y = (np.random.default_rng(1).standard_normal((2, 8000)) * 0.1).astype(np.float32)
    re_j, im_j = S.stft_real_imag_tmajor(jnp.asarray(y), 512, 128, 512,
                                         matmul_dtype="bfloat16")
    re, im = TS.stft_real_imag_tmajor(torch.from_numpy(y), 512, 128, 512,
                                      matmul_dtype=torch.bfloat16)
    np.testing.assert_allclose(re.numpy(), np.asarray(re_j), atol=1e-5)
    np.testing.assert_allclose(im.numpy(), np.asarray(im_j), atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("win_length,length", [(512, 12345), (512, None), (400, 12000)])
def test_istft_tmajor_matches_jax(dtype, win_length, length):
    """(512, ...) takes the COLA-constant fast path with its edge fix; a
    shorter window takes the envelope divide."""
    rng = np.random.default_rng(2)
    re = (rng.standard_normal((97, 2, 257)) * 0.1).astype(dtype)
    im = (rng.standard_normal((97, 2, 257)) * 0.1).astype(dtype)
    ref = S.istft_real_imag_tmajor(jnp.asarray(re), jnp.asarray(im), 512, 128, win_length,
                                   length=length)
    got = TS.istft_real_imag_tmajor(torch.from_numpy(re), torch.from_numpy(im), 512, 128,
                                    win_length, length=length)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL[dtype])


@pytest.mark.parametrize("hop", [128, 100])
def test_overlap_add_matches_jax(hop):
    frames = np.random.default_rng(3).standard_normal((2, 3, 11, 512))
    np.testing.assert_allclose(TS.overlap_add(torch.from_numpy(frames), hop).numpy(),
                               np.asarray(S.overlap_add(jnp.asarray(frames), hop)), atol=1e-12)


def test_stft_istft_roundtrip():
    y = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 9000)))
    re, im = TS.stft_real_imag_tmajor(y, 512, 128, 512)
    back = TS.istft_real_imag_tmajor(re, im, 512, 128, 512, length=9000)
    np.testing.assert_allclose(back.numpy(), y.numpy(), atol=1e-6)


def test_epsilon_cast_and_activations():
    assert EPSILON == JAX_EPSILON
    tree = {"a": torch.ones(2), "b": [torch.zeros(3, dtype=torch.float64),
                                      torch.arange(3)]}
    out = cast_floating(tree, torch.bfloat16)
    assert out["a"].dtype == out["b"][0].dtype == torch.bfloat16
    assert out["b"][1].dtype == torch.int64
    x = np.linspace(-8, 8, 33)
    for name in (None, False, "tanh", "Tanh", "sigmoid", "relu", "relu6", "leakyrelu"):
        np.testing.assert_allclose(
            output_activation(name)(torch.from_numpy(x)).numpy(),
            np.asarray(jcore.output_activation(name)(jnp.asarray(x))), atol=1e-12)
    with pytest.raises(NotImplementedError):
        output_activation("gelu")
