"""The port's building blocks (models/modules.py) and the small modules of
its surface against the JAX package in float64.

- every function of ``models/modules.py``, one case each: the JAX
  function's weights (its ``*_init`` from a PRNG key, cast to float64)
  carried across with ``params_from_numpy``, the same numpy-seeded inputs,
  the outputs within the tolerance each case states (1e-12 for the norms
  and the MVDR helpers, 1e-10 for the convolution stacks and the
  recurrences); the port's ``*_init`` gives the JAX tree's keys and shapes;
- ``dsp/filterbank.py`` equal to the JAX package's bit for bit,
  ``dsp/sslt.py`` within 1e-12, ``ops/deep_filter.deep_filter_single`` and
  ``nn/core.batch_norm_*`` within 1e-12, ``runtime/debug.clamp_inf_value``
  exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models import modules as JM

from spiking_fullsubnet_torch.models import modules as PM
from spiking_fullsubnet_torch.runtime.convert import flat_paths, params_from_numpy

KEY = jax.random.PRNGKey(7)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.complex128 if np.iscomplexobj(x)
                                             else np.float64), tree)


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in flat_paths(tree).items()}


def _cmp(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


RNG = np.random.default_rng(11)


def _x(*shape, positive=False):
    x = RNG.standard_normal(shape)
    return np.abs(x) if positive else x


# case -> init: (init function, args, kwargs) or None; fn: the function (the
# case's name before "-" by default); inputs; kw: its keyword arguments; tol
def _cases():
    c = {}
    c["cumulative_layer_norm_affine"] = dict(
        init=None, inputs=[_x(2, 16, 30, positive=True), _x(16), _x(16)], kw={}, tol=1e-12)
    for cum in (False, True):
        for mid in (False, True):
            c[f"cumulative_mag_spectral_norm-{cum}-{mid}"] = dict(
                init=None, fn="cumulative_mag_spectral_norm",
                inputs=[_x(2, 1, 16, 20, positive=True)],
                kw=dict(cumulative=cum, use_mid_freq_mu=mid), tol=1e-12)
    c["cumulative_norm"] = dict(init=None, inputs=[_x(2, 1, 16, 20, positive=True)], kw={},
                                tol=1e-12)
    for causal in (False, True):
        c[f"depth_conv1d-{causal}"] = dict(
            init=("depth_conv1d_init", (12, 20, 3), dict(causal=causal)),
            fn="depth_conv1d_apply", inputs=[_x(2, 12, 25)],
            kw=dict(kernel=3, dilation=2, padding=2, causal=causal), tol=1e-10)
        c[f"tcn_estimator-{causal}"] = dict(
            init=("tcn_estimator_init", (32, 8, 16, 24), dict(layer=2, stack=2, causal=causal)),
            fn="tcn_estimator_apply", inputs=[_x(2, 32, 40)],
            kw=dict(layer=2, stack=2, causal=causal), tol=1e-10)
    c["tac"] = dict(init=("tac_init", (16, 32), {}), fn="tac_apply",
                    inputs=[_x(2, 4, 16, 10)], kw={}, tol=1e-10)
    c["residual_lstm"] = dict(init=("residual_lstm_init", (16, 12, 20), {}),
                              fn="residual_lstm_apply", inputs=[_x(2, 16, 15)],
                              kw=dict(hidden_size=20), tol=1e-10)
    c["grouped_linear"] = dict(init=("grouped_linear_init", (16, 24), dict(groups=4)),
                               fn="grouped_linear_apply", inputs=[_x(5, 3, 16)],
                               kw=dict(groups=4), tol=1e-12)
    c["shared_group_gru"] = dict(
        init=("shared_group_gru_init", (16, 32), dict(num_layers=2, num_groups=4)),
        fn="shared_group_gru_apply", inputs=[_x(9, 3, 16)],
        kw=dict(hidden_size=32, num_groups=4), tol=1e-10)
    c["layer_norm_lstm"] = dict(init=("layer_norm_lstm_init", (12, 20), dict(num_layers=2)),
                                fn="layer_norm_lstm_apply", inputs=[_x(7, 3, 12)],
                                kw=dict(hidden_size=20), tol=1e-10)
    c["mogrifier_lstm"] = dict(init=("mogrifier_lstm_init", (12, 20), dict(mogrify_steps=3)),
                               fn="mogrifier_lstm_apply", inputs=[_x(7, 3, 12)],
                               kw=dict(hidden_size=20, mogrify_steps=3), tol=1e-10)
    c["causal_conformer_conv"] = dict(
        init=("causal_conformer_conv_init", (16,), dict(kernel_size=7)),
        fn="causal_conformer_conv_apply", inputs=[_x(2, 16, 30)], kw=dict(kernel_size=7),
        tol=1e-10)
    spec = _x(2, 4, 16, 30) + 1j * _x(2, 4, 16, 30)
    c["complex_outer"] = dict(init=None, inputs=[spec], kw={}, tol=1e-12)
    mask = RNG.uniform(0, 1, (2, 16, 30))
    c["spatial_covariance"] = dict(init=None, inputs=[spec, mask], kw={}, tol=1e-12)
    c["spatial_covariance-nomask"] = dict(init=None, fn="spatial_covariance", inputs=[spec],
                                          kw={}, tol=1e-12)
    a, b = (_x(2, 16, 4, 4) + 1j * _x(2, 16, 4, 4) for _ in range(2))
    phi_s, phi_n = (m @ m.conj().swapaxes(-1, -2) for m in (a, b))  # Hermitian, PSD
    c["mvdr_weights"] = dict(init=None, inputs=[phi_s, phi_n], kw=dict(ref_channel=1), tol=1e-9)
    c["apply_beamforming"] = dict(init=None, inputs=[spec, _x(2, 16, 4) + 1j * _x(2, 16, 4)],
                                  kw={}, tol=1e-12)
    return c


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_jax_f64(name):
    case = CASES[name]
    fn = case.get("fn", name.split("-")[0])
    args = []
    jargs = []
    if case["init"] is not None:
        init, iargs, ikw = case["init"]
        jp = _f64(getattr(JM, init)(KEY, *iargs, **ikw))
        jargs.append(jax.tree.map(jnp.asarray, jp))
        args.append(params_from_numpy(jp, "cpu"))
        # the port's init gives the JAX tree
        pp = getattr(PM, init)(torch.Generator().manual_seed(0), *iargs, **ikw)
        assert _shapes(pp) == _shapes(jp)
    jargs += [jnp.asarray(x) for x in case["inputs"]]
    args += [torch.from_numpy(np.array(x)) for x in case["inputs"]]
    # one compiled program: eager JAX would compile each of its operations
    ref = jax.jit(getattr(JM, fn), static_argnames=tuple(case["kw"]))(*jargs, **case["kw"])
    got = getattr(PM, fn)(*args, **case["kw"])
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            _cmp(g, r, case["tol"])
    else:
        _cmp(got, ref, case["tol"])


# ------------------------------------------------------------------ small modules


def test_filterbank_equals_jax_bitwise():
    from spiking_fullsubnet_tpu.dsp import filterbank as JF

    from spiking_fullsubnet_torch.dsp import filterbank as PF

    for args in ((24, 512, 16000, 20.0, 8000.0), (40, 1024, 48000, 50.0, None),
                 (8, 256, 8000, 100.0, 3000.0)):
        np.testing.assert_array_equal(PF.bark_filter_bank(*args), JF.bark_filter_bank(*args))
    hz = np.linspace(20, 8000, 37)
    np.testing.assert_array_equal(PF.hz_to_bark(hz), JF.hz_to_bark(hz))
    np.testing.assert_array_equal(PF.bark_to_hz(PF.hz_to_bark(hz)),
                                  JF.bark_to_hz(JF.hz_to_bark(hz)))


@pytest.mark.parametrize("include_r", [False, True])
@pytest.mark.parametrize("dims", [2, 3])
def test_sslt_matches_jax(dims, include_r):
    from spiking_fullsubnet_tpu.dsp import sslt as JT

    from spiking_fullsubnet_torch.dsp import sslt as PT

    cart = RNG.standard_normal((3, dims, 11))
    _cmp(PT.cart2sph(torch.from_numpy(cart), include_r), JT.cart2sph(jnp.asarray(cart),
                                                                       include_r), 1e-12)
    sph = RNG.uniform(-3, 3, (3, dims - 1, 11))
    _cmp(PT.sph2cart(torch.from_numpy(sph)), JT.sph2cart(jnp.asarray(sph)), 1e-12)


@pytest.mark.parametrize("frame_size", [1, 3])
def test_deep_filter_single_matches_jax(frame_size):
    from spiking_fullsubnet_tpu.ops.deep_filter import deep_filter_single as jdf

    from spiking_fullsubnet_torch.ops.deep_filter import deep_filter_single as pdf

    spec = RNG.standard_normal((2, 1, 9, 12)) + 1j * RNG.standard_normal((2, 1, 9, 12))
    coefs = RNG.standard_normal((2, frame_size, 9, 12, 2))
    _cmp(pdf(torch.from_numpy(spec), torch.from_numpy(coefs), frame_size),
         jdf(jnp.asarray(spec), jnp.asarray(coefs), frame_size), 1e-12)


def test_batch_norm_matches_jax():
    from spiking_fullsubnet_tpu.nn import core as JC

    from spiking_fullsubnet_torch.nn import core as PC

    jp, js = JC.batch_norm_init(6)
    pp, ps = PC.batch_norm_init(6)
    got, ref = flat_paths([pp, ps]), flat_paths([jp, js])
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    x = RNG.standard_normal((4, 5, 6)) * 3 + 1
    w = {"weight": RNG.standard_normal(6), "bias": RNG.standard_normal(6)}
    jm, jv = JC.batch_norm_stats(jnp.asarray(x))
    pm, pv = PC.batch_norm_stats(torch.from_numpy(x))
    _cmp(pm, jm, 1e-12)
    _cmp(pv, jv, 1e-12)
    _cmp(PC.batch_norm_apply(params_from_numpy(w, "cpu"), torch.from_numpy(x), pm, pv),
         JC.batch_norm_apply(jax.tree.map(jnp.asarray, w), jnp.asarray(x), jm, jv), 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_clamp_inf_value_matches_jax_exactly(dtype):
    from spiking_fullsubnet_tpu.runtime.debug import clamp_inf_value as jclamp

    from spiking_fullsubnet_torch.runtime.debug import clamp_inf_value as pclamp

    x = np.array([np.inf, -np.inf, np.nan, 1.5, -2.0, 1e300, -1e300])
    ref = np.asarray(jclamp(jnp.asarray(x), getattr(jnp, dtype)))
    got = pclamp(torch.from_numpy(x), getattr(torch, dtype)).numpy()
    np.testing.assert_array_equal(got, ref)
