"""The port's denoise-recipe losses against spiking_fullsubnet_tpu.losses.

si_snr, freq_mae and mag_mae, their values and their gradients with
respect to the estimate, in float64 (rtol 1e-12; gradients within 1e-12
max|g|: the same formulas, sums and FFTs in another order) and float32
(rtol 1e-5; gradients within 1e-5 max|g|: float32 rounding of the two
FFT libraries); the STFT's reflect padding and normalisation that the MAE
losses use; the recipe's loss dict. Inputs are made with numpy from a seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu import losses as JL
from spiking_fullsubnet_tpu.dsp.spectral import stft_complex as jax_stft_complex

from spiking_fullsubnet_torch.dsp.spectral import hann_window, stft_complex
from spiking_fullsubnet_torch.losses import losses as PL
from spiking_fullsubnet_torch.recipes.denoise import denoise_loss

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _pair(dtype, seed=0, shape=(3, 6000)):
    rng = np.random.default_rng(seed)
    ref = (rng.standard_normal(shape) * 0.1).astype(dtype)
    est = (ref + 0.05 * rng.standard_normal(shape)).astype(dtype)
    return est, ref


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["si_snr", "freq_mae", "mag_mae"])
def test_loss_and_gradient_match_jax(name, dtype):
    est, ref = _pair(dtype, seed=len(name))
    val, grad = jax.value_and_grad(getattr(JL, name))(jnp.asarray(est), jnp.asarray(ref))
    t_est = torch.from_numpy(est).requires_grad_(True)
    got = getattr(PL, name)(t_est, torch.from_numpy(ref))
    got.backward()
    assert got.dtype == t_est.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(got.item(), float(val), rtol=tol)
    g = np.asarray(grad, np.float64)
    np.testing.assert_allclose(t_est.grad.double().numpy(), g, rtol=0,
                               atol=tol * np.abs(g).max())


@pytest.mark.parametrize("pad_mode", ["constant", "reflect"])
@pytest.mark.parametrize("normalized", [False, True])
def test_stft_complex_pad_mode_and_normalized_match_jax(pad_mode, normalized):
    y = np.random.default_rng(3).standard_normal((2, 3000))
    ref = jax_stft_complex(jnp.asarray(y), 512, 128, 512, pad_mode=pad_mode,
                           normalized=normalized)
    got = stft_complex(torch.from_numpy(y), 512, 128, 512, pad_mode=pad_mode,
                       normalized=normalized)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12)
    with pytest.raises(ValueError, match="pad_mode"):
        stft_complex(torch.from_numpy(y), 512, 128, 512, pad_mode="edge")


@pytest.mark.parametrize("pad_mode", ["constant", "reflect"])
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stft_complex_is_torch_stft_written_out(pad_mode, normalized, dtype):
    """stft_complex writes torch.stft's steps out (the centring pad, the
    windowed frames, the real FFT) so that its gradient is deterministic on
    a card: the same spectrum bit for bit, the same gradient to rounding."""
    x = torch.from_numpy(_pair(np.float64, seed=7, shape=(2, 5000))[0]).to(dtype)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ours = stft_complex(a, 512, 128, 512, pad_mode=pad_mode, normalized=normalized)
    theirs = torch.stft(b, 512, 128, 512, hann_window(512, dtype), center=True,
                        pad_mode=pad_mode, normalized=normalized, return_complex=True)
    assert torch.equal(ours, theirs)
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(ours.shape)).to(dtype)
    (ours.real * w + ours.imag * w.flip(-1)).sum().backward()
    (theirs.real * w + theirs.imag * w.flip(-1)).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=TOL[np.dtype(str(dtype)[6:]).type]
                               * b.grad.abs().max().item())


def test_denoise_loss_matches_the_recipe():
    """recipes/denoise.py:66-79: freq_mae + mag_mae + 0.001 (100 - SI-SNR)."""
    est, ref = _pair(np.float64, seed=9)
    je, jr = jnp.asarray(est), jnp.asarray(ref)
    want = {"loss_freq_mae": JL.freq_mae(je, jr), "loss_mag_mae": JL.mag_mae(je, jr),
            "loss_sdr": JL.si_snr(je, jr)}
    want["loss_sdr_norm"] = 0.001 * (100.0 - want["loss_sdr"])
    want["loss"] = want["loss_freq_mae"] + want["loss_mag_mae"] + want["loss_sdr_norm"]
    got = denoise_loss(torch.from_numpy(est), torch.from_numpy(ref))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-12)


LOSS_CASES = [
    ("multi_res_spec_loss", dict(n_ffts=(512, 256))),
    ("multi_res_spec_loss", dict(n_ffts=(256,), gamma=0.3, factor=2.0)),
    ("multi_res_spec_loss", dict(n_ffts=(512, 128), f_complex=0.5)),
    ("multi_res_spec_loss", dict(n_ffts=(256,), gamma=0.3, f_complex=0.3)),
    ("combine_loss", dict(n_ffts=(512, 256), gamma=0.3, f_complex=0.3)),
    ("combine_loss", dict(n_ffts=(128,))),
    ("l1_loss", dict()),
    ("mse_loss", dict()),
    ("si_snr_loss", dict()),
]


@pytest.mark.parametrize("name,kw", LOSS_CASES, ids=lambda v: str(v))
def test_toml_losses_and_gradients_match_jax_f64(name, kw):
    """The losses a [loss_function] path names, in float64: values rtol
    1e-10, gradients within 1e-10 max|g|."""
    est, ref = _pair(np.float64, seed=len(name) + len(kw), shape=(2, 4000))
    val, grad = jax.value_and_grad(lambda e: getattr(JL, name)(e, jnp.asarray(ref), **kw))(
        jnp.asarray(est))
    t_est = torch.from_numpy(est).requires_grad_(True)
    got = getattr(PL, name)(t_est, torch.from_numpy(ref), **kw)
    got.backward()
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), float(val), rtol=1e-10)
    g = np.asarray(grad)
    np.testing.assert_allclose(t_est.grad.numpy(), g, rtol=0, atol=1e-10 * np.abs(g).max())
