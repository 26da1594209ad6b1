"""The port's layered forward (scan_mode="layered", the default of
separator_config, and what "auto" sends there) and kernel F's plain version
against the JAX package.

- plain kernel F (gsu_kernels.stack_eval_x_plain) against the JAX Pallas
  kernel gsu_stack_eval_pallas in interpret mode, f32 and bf16 io, shared
  and unshared weights, BN on and off, L = 1 and 3, 37 features, T < 8 and
  longer: every layer's spikes equal exactly (the layer-0 product sums in
  another order; at these shapes no spike sits on a tie);
- the port's gsu_stack_apply and sequence_model_apply against the JAX scan
  path in f64: spikes equal, real outputs atol 1e-12;
- zoo M at full width from baseline_m.npz, 1 x 2 s, f64, against the JAX
  layered forward: audio atol 3e-6 (tests/test_stream_forward.py:53), the
  deep-filter coefficients atol 1e-9 and every collected layer;
- tiny configs in f64: num_spks = 2, the norms with pre-LN that "auto"
  sends to layered, no norm;
- the speech-like fixture of tests/test_spiking_fullsubnet.py:212-234
  through the port's layered zoo M gains > 8 dB of SI-SDR (f32, bf16).
Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spiking_fullsubnet_tpu.ops.gsu_pallas as gp
from spiking_fullsubnet_tpu.models import sequence_model as JS
from spiking_fullsubnet_tpu.models import spiking_fullsubnet as J
from spiking_fullsubnet_tpu.ops.gsu import gsu_stack_apply as jax_gsu_stack_apply
from spiking_fullsubnet_tpu.ops.gsu import gsu_stack_init
from spiking_fullsubnet_tpu.runtime.convert import load_npz as jax_load_npz

from spiking_fullsubnet_torch.models import sequence_model as PS
from spiking_fullsubnet_torch.models import spiking_fullsubnet as P
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.ops.gsu import gsu_stack_apply
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy

ZOO_M = Path(__file__).resolve().parent.parent / "model_zoo/intel_ndns/spike_fsb/baseline_m.npz"
ZOO_KW = dict(norm_type="offline_laplace_norm", shared_weights=True, bn=True)
TINY_KW = dict(
    n_fft=128, hop_length=32, win_length=128,
    fb_input_size=16, fb_hidden_size=24, fb_proj_size=16,
    sb_hidden_size=20, freq_cutoffs=(0, 8, 32, 64),
    df_orders=(2, 1, 3), center_freq_sizes=(2, 8, 16),
    neighbor_freq_sizes=(3, 3, 3),
    fb_center_freq_sizes=(2, 8, 16), fb_neighbor_freq_sizes=(0, 0, 0),
    use_pre_layer_norm_fb=False, use_pre_layer_norm_sb=False,
    norm_type="offline_laplace_norm", bn=True, shared_weights=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions step through time in thousands of small ops; one
    thread each keeps them fast when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree, dtype=None):
    return jax.tree.map(lambda x: np.asarray(x, dtype), tree)


def _stack(H, fin, shared, bn, L, seed=1, dtype=np.float32):
    """JAX stack params/state as numpy, BN randomized so the fold matters."""
    params, state = gsu_stack_init(jax.random.PRNGKey(seed), input_size=fin, hidden_size=H,
                                   num_layers=L, shared_weights=shared, bn=bn)
    p, s = _np(params, dtype), _np(state, dtype)
    rng = np.random.default_rng(seed + 10)
    if bn:
        for lp, ls in zip(p["layers"], s["layers"]):
            lp["bn"]["weight"] = (1 + 0.1 * rng.standard_normal(H)).astype(dtype)
            lp["bn"]["bias"] = (0.1 * rng.standard_normal(H)).astype(dtype)
            ls["bn"]["running_mean"] = (0.1 * rng.standard_normal(H)).astype(dtype)
            ls["bn"]["running_var"] = np.exp(0.1 * rng.standard_normal(H)).astype(dtype)
    return p, s


# ------------------------------------------------------------------ kernel F


@pytest.mark.parametrize("io", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("L,T", [(1, 5), (3, 5), (3, 19)])
def test_stack_x_plain_matches_pallas_interpret(io, shared, bn, L, T, monkeypatch):
    monkeypatch.setattr(gp, "_INTERPRET", True)
    B, H, Fin = 6, 32, 37
    p, s = _stack(H, Fin, shared, bn, L)
    x = np.random.default_rng(L + T).standard_normal((T, B, Fin)).astype(np.float32)
    jx, jp = jnp.asarray(x), p
    if io == "bfloat16":  # the params reach the kernel as the compute cast left them
        jx = jx.astype(jnp.bfloat16)
        jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p)
    ref_out, ref_all, _ = gp.gsu_stack_eval_pallas(jp, s, jx, H, shared)
    tx = torch.from_numpy(x).to(getattr(torch, io))
    tp = params_from_numpy(_np(jp, np.float32), "cpu")
    if io == "bfloat16":
        tp = jax.tree.map(lambda a: a.to(torch.bfloat16), tp)
    packed = gk.pack_stack_x(tp["layers"], params_from_numpy(s, "cpu")["layers"], H, tx.dtype)
    counts = []
    got = gk.stack_eval_x_plain(tx, *packed, H, shared, spike_counts=counts)
    assert got.shape == (L, T, B, H) and got.dtype == tx.dtype
    assert len(ref_all) == L + 1
    for k in range(L):
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(ref_all[k + 1], np.float32))
    np.testing.assert_array_equal(got[-1].float().numpy(), np.asarray(ref_out, np.float32))
    assert counts == [float(got[k].float().sum()) for k in range(L)]
    assert 0.05 < float(got.float().mean()) < 0.95


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("bn", [True, False])
def test_gsu_stack_apply_matches_jax_scan_f64(shared, bn):
    T, B, H, Fin = 23, 5, 24, 19
    p, s = _stack(H, Fin, shared, bn, 3, seed=4, dtype=np.float64)
    x = np.random.default_rng(3).standard_normal((T, B, Fin))
    ref_out, ref_all, _ = jax_gsu_stack_apply(p, s, jnp.asarray(x), H, shared, backend="scan")
    before = gk.gsu_stack_eval_x.launches
    out, alo, state = gsu_stack_apply(params_from_numpy(p, "cpu"), params_from_numpy(s, "cpu"),
                                      torch.from_numpy(x), H, shared)
    assert gk.gsu_stack_eval_x.launches == before  # CPU tensors take the plain version
    assert len(alo) == len(ref_all) == 4 and out.dtype == torch.float64
    for a, b in zip(alo, ref_all):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    # training runs too (kernels D and E's plain versions; held against the
    # JAX scan in tests/test_torch_train_layer.py) and leaves F unlaunched
    before_d = gk.gsu_layer_train_fwd.launches
    tout, talo, tstate = gsu_stack_apply(params_from_numpy(p, "cpu"), state, torch.from_numpy(x),
                                         H, shared, train=True)
    assert gk.gsu_stack_eval_x.launches == before and gk.gsu_layer_train_fwd.launches == before_d
    assert tout.shape == out.shape and len(talo) == 4
    if bn:  # the running statistics moved
        assert not torch.equal(tstate["layers"][0]["bn"]["running_mean"],
                               state["layers"][0]["bn"]["running_mean"])


@pytest.mark.parametrize("pre_ln,act", [(True, "tanh"), (False, None)])
def test_sequence_model_apply_matches_jax_f64(pre_ln, act):
    kw = dict(input_size=21, hidden_size=24, num_layers=2, proj_size=10, shared_weights=False,
              bn=True, use_pre_layer_norm=pre_ln, output_activate_function=act)
    jcfg = JS.SequenceModelConfig(**kw, backend="scan")
    params, state = JS.sequence_model_init(jax.random.PRNGKey(2), jcfg)
    p, s = _np(params, np.float64), _np(state, np.float64)
    if pre_ln:
        rng = np.random.default_rng(8)
        p["pre_ln"]["weight"] = 1 + 0.2 * rng.standard_normal(21)
        p["pre_ln"]["bias"] = 0.2 * rng.standard_normal(21)
    x = np.abs(np.random.default_rng(9).standard_normal((3, 21, 17)))
    ref, ref_all, _ = JS.sequence_model_apply(jcfg, p, s, jnp.asarray(x))
    got, alo, _ = PS.sequence_model_apply(PS.SequenceModelConfig(**kw), params_from_numpy(p, "cpu"),
                                          params_from_numpy(s, "cpu"), torch.from_numpy(x))
    assert got.shape == (3, 10, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12)
    assert len(alo) == len(ref_all) == 4  # stack input, two layers, projection
    for a, b in zip(alo, ref_all):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)


# ------------------------------------------------------------------ the forward


def _record(monkeypatch, module, store):
    """Wrap a module's deep_filter to keep the coefficients it is given."""
    real = module.deep_filter

    def wrapped(spec, coef, order, num_spks):
        store.append(np.asarray(coef))
        return real(spec, coef, order, num_spks)

    monkeypatch.setattr(module, "deep_filter", wrapped)


def _compare_layers(got, ref, atol):
    """The collected outputs: nested lists of [T, rows, width] tensors."""
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _compare_layers(g, r, atol)
        return
    np.testing.assert_allclose(got.double().numpy(), np.asarray(ref, np.float64), atol=atol)


def _forward_matches_jax(jcfg, pcfg, params, state, noisy, monkeypatch, audio_atol=3e-6):
    coefs_j, coefs_p = [], []
    _record(monkeypatch, J, coefs_j)
    _record(monkeypatch, P, coefs_p)
    ref = J.spiking_fullsubnet_apply(jcfg, params, state, jnp.asarray(noisy))
    before = gk.gsu_stack_eval_x.launches
    out = P.spiking_fullsubnet_apply(pcfg, params_from_numpy(params, "cpu"),
                                     params_from_numpy(state, "cpu"), torch.from_numpy(noisy))
    assert gk.gsu_stack_eval_x.launches == before
    assert out["enhanced_y"].shape == ref["enhanced_y"].shape
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=audio_atol)
    if "enhanced_mag" in ref:
        np.testing.assert_allclose(out["enhanced_mag"].numpy(), np.asarray(ref["enhanced_mag"]),
                                   atol=1e-9)
    assert len(coefs_p) == len(coefs_j) == pcfg.num_sections
    for g, r in zip(coefs_p, coefs_j):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=1e-9)
    _compare_layers(out["fb_all_layer_outputs"], ref["fb_all_layer_outputs"], 1e-9)
    _compare_layers(out["sb_all_layer_outputs"], ref["sb_all_layer_outputs"], 1e-9)
    return out


def _tiny(dtype=np.float64, **change):
    cfg = J.SpikingFullSubNetConfig(**dict(TINY_KW, **change))
    params, state = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(7)
    for tree in [state["fb"]] + state["sb"]:
        for ls in tree["stack"]["layers"]:
            rm = ls["bn"]["running_mean"]
            ls["bn"]["running_mean"] = jnp.asarray(0.1 * rng.standard_normal(rm.shape))
    for p in [params["fb"]] + params["sb"]:
        if "pre_ln" in p:
            w = p["pre_ln"]["weight"]
            p["pre_ln"]["weight"] = jnp.asarray(1 + 0.2 * rng.standard_normal(w.shape))
            p["pre_ln"]["bias"] = jnp.asarray(0.2 * rng.standard_normal(w.shape))
    pcfg = P.SpikingFullSubNetConfig(**{k: v for k, v in cfg.__dict__.items()})
    return cfg, pcfg, _np(params, dtype), _np(state, dtype)


def test_zoo_m_full_width_layered_f64_matches_jax(monkeypatch):
    """The default config of separator_config (scan_mode="layered",
    collect_layer_outputs=True), the published checkpoint."""
    jcfg = J.separator_config(**ZOO_KW)
    pcfg = P.separator_config(**ZOO_KW)
    assert pcfg.scan_mode == jcfg.scan_mode == "layered"
    assert pcfg.__dict__ == jcfg.__dict__
    tpl = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    tree = jax_load_npz(str(ZOO_M), {"params": tpl[0], "state": tpl[1]})
    params, state = _np(tree["params"], np.float64), _np(tree["state"], np.float64)
    noisy = np.random.default_rng(3).standard_normal((1, 32000)) * 0.05
    out = _forward_matches_jax(jcfg, pcfg, params, state, noisy, monkeypatch)
    fb = out["fb_all_layer_outputs"]
    assert [tuple(t.shape) for t in fb] == [(251, 1, 64), (251, 1, 320), (251, 1, 320),
                                           (251, 1, 64)]
    assert [tuple(s[1].shape) for s in out["sb_all_layer_outputs"]] == [
        (251, 8, 224), (251, 3, 224), (251, 2, 224)]
    assert np.abs(out["enhanced_y"].numpy() - noisy).max() > 1e-3


@pytest.mark.parametrize("shared", [True, False])
def test_tiny_two_speakers_layered_f64_matches_jax(shared, monkeypatch):
    jcfg, pcfg, params, state = _tiny(num_spks=2, shared_weights=shared)
    noisy = np.random.default_rng(0).standard_normal((2, 3000)) * 0.1
    out = _forward_matches_jax(jcfg, pcfg, params, state, noisy, monkeypatch)
    assert out["enhanced_y"].shape == (2, 2, 3000) and "enhanced_mag" not in out


@pytest.mark.parametrize("norm", ["offline_laplace_norm", "cumulative_laplace_norm", None])
def test_tiny_norm_with_pre_ln_auto_takes_layered_f64(norm, monkeypatch):
    """A norm together with pre-LN misses the stream path and the fused one
    in "auto" (spiking_fullsubnet.py:263-275): the port runs it layered.
    No norm with pre-LN runs it layered by request."""
    jcfg, pcfg, params, state = _tiny(norm_type=norm, use_pre_layer_norm_fb=True,
                                      use_pre_layer_norm_sb=True,
                                      scan_mode="auto" if norm else "layered")
    noisy = np.random.default_rng(1).standard_normal((2, 2500)) * 0.1
    calls = []
    monkeypatch.setattr(P, "_layered_forward",
                        lambda *a, real=P._layered_forward: calls.append(1) or real(*a))
    _forward_matches_jax(jcfg, pcfg, params, state, noisy, monkeypatch)
    assert len(calls) == 1


def test_tiny_bf16_policy_close_to_jax(monkeypatch):
    """compute_dtype="bfloat16" without a norm: the magnitude is cast before
    the unfolds, the fullband output returns in bf16, the BN affine is
    rounded with the params. The two packages round their sums in other
    orders, so a stream may differ by a bf16 step and a spike may flip: the
    collected spikes agree to 1e-3 and the audio to 60 dB of SNR."""
    jcfg, pcfg, params, state = _tiny(np.float32, norm_type=None, compute_dtype="bfloat16")
    noisy = (np.random.default_rng(2).standard_normal((2, 3000)) * 0.1).astype(np.float32)
    # jax arrays: the JAX package's cast_floating casts only those
    ref = J.spiking_fullsubnet_apply(jcfg, jax.tree.map(jnp.asarray, params), state,
                                     jnp.asarray(noisy))
    out = P.spiking_fullsubnet_apply(pcfg, params_from_numpy(params, "cpu"),
                                     params_from_numpy(state, "cpu"), torch.from_numpy(noisy))
    assert out["enhanced_y"].dtype == torch.float32
    layers = [(out["fb_all_layer_outputs"], ref["fb_all_layer_outputs"])] + list(
        zip(out["sb_all_layer_outputs"], ref["sb_all_layer_outputs"]))
    for got, want in layers:
        for k in (1, 2):  # the two layers' spikes
            assert got[k].dtype == torch.bfloat16
            mism = np.mean(got[k].float().numpy() != np.asarray(want[k], np.float32))
            assert mism < 1e-3, mism
    a, b = out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"])
    assert 10 * np.log10(np.sum(b ** 2) / np.sum((a - b) ** 2)) > 60


def _speech_fixture():
    rng = np.random.default_rng(5)
    t = np.arange(32000) / 16000.0
    f0 = 120 + 20 * np.sin(2 * np.pi * 2.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    sig = sum(np.sin(k * phase) / k for k in range(1, 9))
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t - 1.2)) * np.exp(
        -0.5 * ((t % 1.0) - 0.5) ** 2 / 0.09)
    clean = (0.2 * env * sig).astype(np.float32)
    return clean, clean + 0.05 * rng.standard_normal(len(t)).astype(np.float32)


def _si_sdr(est, ref):
    alpha = np.dot(est, ref) / np.dot(ref, ref)
    return 10 * np.log10(np.sum((alpha * ref) ** 2) / np.sum((alpha * ref - est) ** 2))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_zoo_m_layered_si_sdr_gain(compute_dtype):
    cfg = replace(P.separator_config(**ZOO_KW), compute_dtype=compute_dtype)
    model = P.SpikingFullSubNet.from_npz(str(ZOO_M), cfg, device="cpu")
    clean, noisy = _speech_fixture()
    out = model(torch.from_numpy(noisy[None]))
    enh = out["enhanced_y"][0].numpy()
    assert enh.dtype == np.float32 and enh.shape == clean.shape and np.isfinite(enh).all()
    assert len(out["sb_all_layer_outputs"]) == 3
    gain = _si_sdr(enh, clean) - _si_sdr(noisy, clean)
    assert gain > 8.0, gain


@pytest.mark.parametrize("change,match", [
    ({"scan_mode": "fused", "norm_type": None, "band_axis": "band"}, "distributed training"),
])
def test_layered_uncovered_configs_raise_naming_the_roadmap_item(change, match):
    _, pcfg, params, state = _tiny(np.float32)
    with pytest.raises(NotImplementedError, match=match):
        P.spiking_fullsubnet_apply(replace(pcfg, **change), params_from_numpy(params, "cpu"),
                                   params_from_numpy(state, "cpu"), torch.zeros(1, 2000))


@pytest.mark.parametrize("change", [{"sb_shared_bottleneck": 8},
                                    {"norm_type": "offline_gaussian_norm"},
                                    {"sequence_model": "LIF"}],
                         ids=["shared_subband", "gaussian_norm", "lif"])
def test_layered_runs_the_configs_it_once_refused(change):
    """The configs the layered forward refused until the shared sub-band
    model, the other feature norms and the LIF backbone were ported, each
    against the JAX layered forward in f64: audio within 3e-6
    (tests/test_stream_forward.py:53)."""
    jcfg = J.SpikingFullSubNetConfig(**dict(TINY_KW, **change))
    params, state = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    params, state = _np(params, np.float64), _np(state, np.float64)
    noisy = np.random.default_rng(11).standard_normal((2, 2000)) * 0.1
    ref = jax.jit(lambda p, s, x: J.spiking_fullsubnet_apply(jcfg, p, s, x))(
        params, state, jnp.asarray(noisy))
    out = P.spiking_fullsubnet_apply(P.SpikingFullSubNetConfig(**jcfg.__dict__),
                                     params_from_numpy(params, "cpu"),
                                     params_from_numpy(state, "cpu"), torch.from_numpy(noisy))
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6, rtol=0)
