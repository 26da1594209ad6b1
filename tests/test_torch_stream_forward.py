"""The port's slices end to end (spiking_fullsubnet_apply, scan_mode="auto")
against the JAX package's stream forward.

Two-launch path (offline laplace norm, kernels A and B):
- tiny separator config, f64: the port against the JAX stream forward
  (its scan oracle on the CPU), enhanced_y atol 3e-6 as
  tests/test_stream_forward.py:53 (bounded by the f32 window of the
  COLA-folded iSTFT), enhanced_mag atol 1e-9;
- the same config in f32 against the JAX two-launch path with the Pallas
  kernels in interpret mode: SNR > 60 dB;
- zoo M at full width from baseline_m.npz, 1 x 2 s, f64: atol 3e-6;
- the speech-like fixture of tests/test_spiking_fullsubnet.py:212-234
  through the port gains > 8 dB of SI-SDR (f32 and the bf16 policy).
Monolith path (pre-LN and the cumulative norm, kernel C):
- tiny config, f64, against the JAX scan path: atol 3e-6;
- tiny config, f32, against the JAX monolith in interpret mode (lengths
  with round_up(T, 128) >= T + 3, a counter asserts that it ran): SNR >
  60 dB;
- zoo M with cumulative_laplace_norm 1 x 2 s and flagship M (random JAX
  weights) 1 x 1 s at full width, f64: atol 3e-6;
- zoo M with cumulative_laplace_norm gains > 8 dB of SI-SDR (f32, bf16).
Two-launch path in every norm mode, and the collect path:
- tiny configs that miss the monolith's gate (kernel B "cum", "ln",
  "raw"), eval with and without collect_layer_outputs and training with
  it, and the other paths' configs with collect, f64, against the JAX
  stream forward (its per-section scan in f64): audio atol 3e-6, the synops
  lists and new BN state atol 1e-9, each path's launches counted;
- f32 against the JAX two-launch path with its Pallas kernels in interpret
  mode (the monolith's configs at T = 127, round_up(T, 128) < T + 3):
  SNR > 60 dB; the collect path against the JAX per-section Pallas path:
  SNR > 60 dB, spike mismatch < 1e-3;
- zoo M and flagship M with collect at full width, f64: the whole synops
  contract.
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
from spiking_fullsubnet_tpu.models import spiking_fullsubnet as J
from spiking_fullsubnet_tpu.models.presets import flagship_m as jax_flagship_m
from spiking_fullsubnet_tpu.models.stream_forward import stream_supported as jax_stream_supported
from spiking_fullsubnet_tpu.runtime.convert import load_npz as jax_load_npz

from spiking_fullsubnet_torch.models import spiking_fullsubnet as P
from spiking_fullsubnet_torch.models import stream_forward as sf
from spiking_fullsubnet_torch.models.presets import flagship_m
from spiking_fullsubnet_torch.models.stream_forward import stream_supported
from spiking_fullsubnet_torch.runtime.convert import load_npz, params_from_numpy

ZOO_M = Path(__file__).resolve().parent.parent / "model_zoo/intel_ndns/spike_fsb/baseline_m.npz"
ZOO_KW = dict(norm_type="offline_laplace_norm", shared_weights=True, bn=True)
CUM_KW = dict(ZOO_KW, norm_type="cumulative_laplace_norm")
PRE_LN = dict(norm_type=None, use_pre_layer_norm_fb=True, use_pre_layer_norm_sb=True)
CUM = dict(norm_type="cumulative_laplace_norm")
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


def _cfgs(**kw):
    serve = dict(scan_mode="stream", collect_layer_outputs=False)
    return (J.SpikingFullSubNetConfig(**kw, **serve),
            P.SpikingFullSubNetConfig(**kw, scan_mode="auto", collect_layer_outputs=False))


def _tiny(dtype, shared=True, **change):
    jcfg, pcfg = _cfgs(**dict(TINY_KW, shared_weights=shared, **change))
    params, state = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)
    # randomize the BN fold and the pre-LN affine so they matter
    for tree in [state["fb"]] + state["sb"]:
        for ls in tree["stack"]["layers"]:
            rm = ls["bn"]["running_mean"]
            ls["bn"]["running_mean"] = jnp.asarray(0.1 * rng.standard_normal(rm.shape))
    for p in [params["fb"]] + params["sb"]:
        if "pre_ln" in p:
            w = p["pre_ln"]["weight"]
            p["pre_ln"]["weight"] = jnp.asarray(1 + 0.2 * rng.standard_normal(w.shape))
            p["pre_ln"]["bias"] = jnp.asarray(0.2 * rng.standard_normal(w.shape))
    to = lambda t: jax.tree.map(lambda x: np.asarray(x, dtype), t)  # noqa: E731
    return jcfg, pcfg, to(params), to(state)


def _snr(a, b):
    return 10 * np.log10(np.sum(b ** 2) / max(np.sum((a - b) ** 2), 1e-30))


def _port(pcfg, params, state, noisy):
    out = P.spiking_fullsubnet_apply(pcfg, params_from_numpy(params, "cpu"),
                                     params_from_numpy(state, "cpu"), torch.from_numpy(noisy))
    assert out["fb_all_layer_outputs"] == [] and out["sb_all_layer_outputs"] == []
    return out


@pytest.mark.parametrize("shared", [True, False])
def test_tiny_slice_f64_matches_jax_stream(shared):
    jcfg, pcfg, params, state = _tiny(np.float64, shared)
    noisy = np.random.default_rng(0).standard_normal((2, 4000)) * 0.1
    ref = J.spiking_fullsubnet_apply(jcfg, params, state, jnp.asarray(noisy))
    out = _port(pcfg, params, state, noisy)
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6)
    np.testing.assert_allclose(out["enhanced_mag"].numpy(), np.asarray(ref["enhanced_mag"]),
                               atol=1e-9)
    assert np.abs(out["enhanced_y"].numpy() - noisy).max() > 1e-3


def test_tiny_slice_f32_matches_jax_two_launch_interpret():
    jcfg, pcfg, params, state = _tiny(np.float32)
    noisy = (np.random.default_rng(1).standard_normal((2, 5005)) * 0.1).astype(np.float32)
    old = gp._INTERPRET
    gp._INTERPRET = True
    try:
        ref = J.spiking_fullsubnet_apply(jcfg, params, state, jnp.asarray(noisy))
    finally:
        gp._INTERPRET = old
    out = _port(pcfg, params, state, noisy)
    assert out["enhanced_y"].dtype == torch.float32
    assert _snr(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"])) > 60


def _zoo(dtype, path=ZOO_M, kw=ZOO_KW, **sizes):
    kw = dict(kw, **sizes)
    jcfg, pcfg = _cfgs(**{k: v for k, v in J.separator_config(**kw).__dict__.items()
                          if k not in ("scan_mode", "collect_layer_outputs")})
    tpl = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    tree = jax_load_npz(str(path), {"params": tpl[0], "state": tpl[1]})
    to = lambda t: jax.tree.map(lambda x: np.asarray(x, dtype), t)  # noqa: E731
    return jcfg, pcfg, to(tree["params"]), to(tree["state"])


def _port_matches_jax(jcfg, pcfg, params, state, noisy):
    ref = J.spiking_fullsubnet_apply(jcfg, params, state, jnp.asarray(noisy))
    out = _port(pcfg, params, state, noisy)
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6)


def test_zoo_m_full_width_f64_matches_jax():
    jcfg, pcfg, params, state = _zoo(np.float64)
    assert P.separator_config(**ZOO_KW) == replace(pcfg, scan_mode="layered",
                                                    collect_layer_outputs=True)
    noisy = np.random.default_rng(3).standard_normal((1, 32000)) * 0.05
    _port_matches_jax(jcfg, pcfg, params, state, noisy)


def test_zoo_s_full_width_f64_matches_jax():
    """The other shipped checkpoint (fb 240, sb 160, df orders 3/1/1) takes
    the same path."""
    jcfg, pcfg, params, state = _zoo(np.float64, ZOO_M.with_name("baseline_s.npz"),
                                     fb_hidden_size=240, sb_hidden_size=160,
                                     sb_df_orders=(3, 1, 1))
    noisy = np.random.default_rng(4).standard_normal((1, 16000)) * 0.05
    _port_matches_jax(jcfg, pcfg, params, state, noisy)


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
def test_zoo_m_si_sdr_gain_through_the_port(compute_dtype):
    _si_sdr_gain(ZOO_KW, compute_dtype)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_zoo_m_cumulative_norm_si_sdr_gain_through_the_monolith(compute_dtype, monkeypatch):
    calls = []
    real = sf.sfsb_monolith_serve
    monkeypatch.setattr(sf, "sfsb_monolith_serve", lambda *a: calls.append(1) or real(*a))
    _si_sdr_gain(CUM_KW, compute_dtype)
    assert len(calls) == 1


def _si_sdr_gain(kw, compute_dtype):
    cfg = replace(P.separator_config(**kw), scan_mode="auto",
                  collect_layer_outputs=False, compute_dtype=compute_dtype)
    model = P.SpikingFullSubNet.from_npz(str(ZOO_M), cfg, device="cpu")
    clean, noisy = _speech_fixture()
    enh = model(torch.from_numpy(noisy[None]))["enhanced_y"][0].numpy()
    assert enh.dtype == np.float32 and enh.shape == clean.shape and np.isfinite(enh).all()
    gain = _si_sdr(enh, clean) - _si_sdr(noisy, clean)
    assert gain > 8.0, gain


def test_stream_gate_matches_jax():
    base = J.separator_config(**ZOO_KW)
    variants = [{}, {"num_spks": 2}, {"norm_type": None}, {"norm_type": "cumulative_laplace_norm"},
                {"use_pre_layer_norm_sb": True}, {"fb_proj_size": 0}, {"sequence_model": "LSTM"},
                {"norm_type": "bogus"}]
    for v in variants:
        kw = {k: x for k, x in replace(base, **v).__dict__.items()}
        assert stream_supported(P.SpikingFullSubNetConfig(**kw)) == jax_stream_supported(
            replace(base, **v)), v


@pytest.mark.parametrize("change,match", [
    ({"scan_mode": "fused", "norm_type": None, "data_axis": "data"}, "distributed training"),
])
def test_uncovered_configs_raise_naming_the_roadmap_item(change, match):
    _, pcfg, params, state = _tiny(np.float32)
    cfg = replace(pcfg, **change)
    with pytest.raises(NotImplementedError, match=match):
        _port(cfg, params, state, np.zeros((1, 2000), np.float32))


def test_auto_sends_a_two_speaker_lif_config_to_the_layered_forward():
    """A config the stream gate refuses and the port refused until the LIF
    backbone was ported: ``"auto"`` takes the layered forward, as JAX's
    does; f64 audio within 3e-6."""
    _, pcfg = _cfgs(**dict(TINY_KW, num_spks=2, sequence_model="LIF"))
    jcfg = J.SpikingFullSubNetConfig(**pcfg.__dict__)  # "auto" on both
    assert not stream_supported(pcfg) and not jax_stream_supported(jcfg)
    params, state = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    to = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float64), t)  # noqa: E731
    noisy = np.random.default_rng(12).standard_normal((2, 2000)) * 0.1
    ref = J.spiking_fullsubnet_apply(jcfg, to(params), to(state), jnp.asarray(noisy))
    out = P.spiking_fullsubnet_apply(pcfg, params_from_numpy(to(params), "cpu"),
                                     params_from_numpy(to(state), "cpu"), torch.from_numpy(noisy))
    assert out["enhanced_y"].shape == (2, 2, 2000) and len(out["sb_all_layer_outputs"]) == 3
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6, rtol=0)


# ------------------------------------------------- two-launch in every mode, collect path

# configs that miss the monolith's gate (monolith_ok), one per mode of kernel B
GATE_MISSING = {
    "cum_fdrc": dict(CUM, fdrc=0.4),  # B "cum"
    "ln_fb_tanh": dict(PRE_LN, fb_output_activate_function="tanh"),  # B "ln"
    "raw_fb_tanh": dict(norm_type=None, fb_output_activate_function="tanh"),  # B "raw"
    "ln_sb_only": dict(norm_type=None, use_pre_layer_norm_sb=True),  # B "ln", fullband raw
    "ln_fb_only": dict(norm_type=None, use_pre_layer_norm_fb=True),  # B "raw", fullband LN
}
# configs of the other two paths, which the collect path and training also take
OTHERS = {"off": {}, "pre_ln": PRE_LN, "cum": CUM}
# eval without collect (two-launch), eval with collect, training with collect
PATH_CASES = ([(k, path) for k in GATE_MISSING for path in ("eval", "collect", "train")]
              + [(k, path) for k in OTHERS for path in ("collect", "train")])
# launches of (A, B, C) on each path: kernel A runs the fullband and each section
LAUNCHES = {"eval": (1, 1, 0), "collect": (4, 0, 0), "train": (0, 0, 0)}


def _count(monkeypatch, module, names):
    calls = {k: 0 for k in names}
    for k in names:
        real = getattr(module, k)

        def counted(*a, _k=k, _r=real, **kw):
            calls[_k] += 1
            return _r(*a, **kw)
        monkeypatch.setattr(module, k, counted)
    return calls


def _assert_lists_close(got, ref, what, atol=None, snr=None):
    """The synops lists: the same nesting and shapes; each entry within
    ``atol``, or spikes within the mismatch bound and the rest above ``snr``
    dB."""
    assert len(got) == len(ref), what
    for i, (g, r) in enumerate(zip(got, ref)):
        if isinstance(r, (list, tuple)):
            _assert_lists_close(g, r, f"{what}[{i}]", atol, snr)
            continue
        g, r = g.detach().double().numpy(), np.asarray(r, np.float64)
        assert g.shape == r.shape, (what, i, g.shape, r.shape)
        if atol is not None:
            np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=f"{what}[{i}]")
        elif np.isin(r, (0.0, 1.0)).all():
            assert np.mean(g != r) < 1e-3, (what, i)
        else:
            assert _snr(g, r) > snr, (what, i)


def _both(jcfg, pcfg, params, state, noisy, train):
    ref = J.spiking_fullsubnet_apply(jcfg, params, state, jnp.asarray(noisy), train=train)
    out = P.spiking_fullsubnet_apply(pcfg, params_from_numpy(params, "cpu"),
                                     params_from_numpy(state, "cpu"), torch.from_numpy(noisy),
                                     train=train)
    return ref, out


@pytest.mark.parametrize("name,path", PATH_CASES)
def test_gate_missing_and_collect_configs_match_jax_f64(name, path, monkeypatch):
    """The configs that miss the monolith's gate run on the two-launch path
    with kernel B in their mode (one launch each of A and B); with
    collect_layer_outputs=True eval runs the per-section path (kernel A four
    times) and training returns the lists too. Against the JAX stream
    forward in f64: enhanced_y atol 3e-6, enhanced_mag, the synops lists and
    the new BN state atol 1e-9."""
    jcfg, pcfg, params, state = _tiny(np.float64, **{**GATE_MISSING, **OTHERS}[name])
    assert sf.monolith_ok(pcfg) == (name in ("pre_ln", "cum"))
    collect, train = path != "eval", path == "train"
    jcfg = replace(jcfg, collect_layer_outputs=collect)
    pcfg = replace(pcfg, collect_layer_outputs=collect)
    calls = _count(monkeypatch, sf, ("gsu_stack_eval", "gsu_sections_eval", "sfsb_monolith_serve"))
    noisy = np.random.default_rng(8).standard_normal((2, 3000)) * 0.1
    ref, out = _both(jcfg, pcfg, params, state, noisy, train)
    assert tuple(calls.values()) == LAUNCHES[path]
    np.testing.assert_allclose(out["enhanced_y"].detach().numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6)
    np.testing.assert_allclose(out["enhanced_mag"].detach().numpy(),
                               np.asarray(ref["enhanced_mag"]), atol=1e-9)
    for key in ("fb_all_layer_outputs", "sb_all_layer_outputs"):
        _assert_lists_close(out[key], ref[key], key, atol=1e-9)
    if collect:
        assert len(out["fb_all_layer_outputs"]) == 4 and len(out["sb_all_layer_outputs"]) == 3
    if train:
        _assert_lists_close(jax.tree.leaves(out["state"]), jax.tree.leaves(ref["state"]),
                            "state", atol=1e-9)


# (name, samples): T = 127 frames for the monolith's configs, round_up(127, 128)
# < 127 + 3, so that the JAX dispatch takes its two-launch path for them too
F32_CASES = [("cum_fdrc", 5005), ("ln_fb_tanh", 5005), ("raw_fb_tanh", 5005),
             ("ln_sb_only", 5005), ("pre_ln", 4040), ("cum", 4040)]


@pytest.mark.parametrize("name,samples", F32_CASES)
def test_two_launch_f32_matches_jax_two_launch_interpret(name, samples, monkeypatch):
    """f32: the port's two-launch path (``_serve_two_launch``, which
    ``_serve`` takes for the gate-missing configs) against the JAX two-launch
    path with the Pallas kernels in interpret mode (a counter asserts that
    its sections kernel ran and its monolith did not): SNR > 60 dB."""
    jcfg, pcfg, params, state = _tiny(np.float32, shared=False,
                                      **{**GATE_MISSING, **OTHERS}[name])
    noisy = (np.random.default_rng(9).standard_normal((2, samples)) * 0.1).astype(np.float32)
    calls = _count(monkeypatch, gp, ("gsu_sections_eval_pallas", "sfsb_monolith_serve_pallas"))
    monkeypatch.setattr(gp, "_INTERPRET", True)
    ref = J.spiking_fullsubnet_apply(jcfg, params, state, jnp.asarray(noisy))
    assert calls == {"gsu_sections_eval_pallas": 1, "sfsb_monolith_serve_pallas": 0}
    port = _count(monkeypatch, sf, ("gsu_sections_eval",))
    out = sf._serve_two_launch(pcfg, params_from_numpy(params, "cpu"),
                               params_from_numpy(state, "cpu"), torch.from_numpy(noisy))
    assert port == {"gsu_sections_eval": 1}
    if name in GATE_MISSING:  # _serve dispatches them there
        same = _port(pcfg, params, state, noisy)
        assert torch.equal(same["enhanced_y"], out["enhanced_y"])
    assert out["enhanced_y"].dtype == torch.float32
    assert _snr(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"])) > 60


@pytest.mark.parametrize("name", ["off", "ln_fb_tanh", "cum_fdrc"])
def test_collect_f32_matches_jax_per_section_interpret(name, monkeypatch):
    """f32, collect_layer_outputs=True: the port's per-section path against
    the JAX per-section path with kernel A's Pallas kernel in interpret mode
    (``gsu_stack_eval_pallas_xg`` with collect_all, four launches): audio SNR
    > 60 dB, every collected spike tensor within a mismatch of 1e-3, the
    normed inputs and projections above 60 dB."""
    jcfg, pcfg, params, state = _tiny(np.float32, **{**GATE_MISSING, **OTHERS}[name])
    jcfg = replace(jcfg, collect_layer_outputs=True)
    pcfg = replace(pcfg, collect_layer_outputs=True)
    noisy = (np.random.default_rng(10).standard_normal((2, 4000)) * 0.1).astype(np.float32)
    calls = _count(monkeypatch, gp, ("gsu_stack_eval_pallas_xg",))
    monkeypatch.setattr(gp, "_INTERPRET", True)
    ref, out = _both(jcfg, pcfg, params, state, noisy, False)
    assert calls == {"gsu_stack_eval_pallas_xg": 4}
    assert _snr(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"])) > 60
    for key in ("fb_all_layer_outputs", "sb_all_layer_outputs"):
        _assert_lists_close(out[key], ref[key], key, snr=60)


@pytest.mark.parametrize("model", ["zoo_m", "flagship_m"])
def test_full_width_collect_f64_matches_jax(model, monkeypatch):
    """collect_layer_outputs=True at full width in f64, the whole synops
    contract: zoo M from baseline_m.npz (1 x 2 s) and flagship M with the
    preset's own collect (random JAX weights, 1 x 1 s) through "auto" run
    the per-section path (kernel A four times, B and C never) and match the
    JAX stream forward: audio atol 3e-6; every list entry's shape, order
    and values atol 1e-9."""
    if model == "zoo_m":
        jcfg, pcfg, params, state = _zoo(np.float64)
        samples = 32000
    else:
        jb = jax_flagship_m(seed=1)
        pcfg = flagship_m(device="cpu", scan_mode="auto")["config"]
        assert pcfg.collect_layer_outputs
        jcfg = replace(jb["config"], scan_mode="stream")
        to = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float64), t)  # noqa: E731
        params, state = to(jb["params"]), to(jb["state"])
        samples = 16000
    jcfg = replace(jcfg, collect_layer_outputs=True)
    pcfg = replace(pcfg, collect_layer_outputs=True)
    calls = _count(monkeypatch, sf, ("gsu_stack_eval", "gsu_sections_eval", "sfsb_monolith_serve"))
    noisy = np.random.default_rng(12).standard_normal((1, samples)) * 0.05
    ref, out = _both(jcfg, pcfg, params, state, noisy, False)
    assert tuple(calls.values()) == (4, 0, 0)
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6)
    assert [len(x) for x in out["sb_all_layer_outputs"]] == [4, 4, 4]
    for key in ("fb_all_layer_outputs", "sb_all_layer_outputs"):
        _assert_lists_close(out[key], ref[key], key, atol=1e-9)


# ------------------------------------------------------------------ monolith


@pytest.mark.parametrize("change", [PRE_LN, CUM], ids=["pre_ln", "cum"])
def test_tiny_monolith_f64_matches_jax_scan(change):
    jcfg, pcfg, params, state = _tiny(np.float64, **change)
    assert sf.monolith_ok(pcfg)
    noisy = np.random.default_rng(2).standard_normal((2, 3000)) * 0.1
    ref = J.spiking_fullsubnet_apply(jcfg, params, state, jnp.asarray(noisy))
    out = P.spiking_fullsubnet_apply(pcfg, params_from_numpy(params, "cpu"),
                                     params_from_numpy(state, "cpu"), torch.from_numpy(noisy))
    assert out["enhanced_mag"] is None and out["enhanced_y"].dtype == torch.float64
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6)
    assert np.abs(out["enhanced_y"].numpy() - noisy).max() > 1e-3


@pytest.mark.parametrize("change", [PRE_LN, CUM], ids=["pre_ln", "cum"])
def test_tiny_monolith_f32_matches_jax_monolith_interpret(change, monkeypatch):
    jcfg, pcfg, params, state = _tiny(np.float32, shared=False, **change)
    # T = 3900 // 32 + 1 = 122 frames: round_up(122, 128) >= 125, so the JAX
    # dispatch takes its monolith
    noisy = (np.random.default_rng(3).standard_normal((2, 3900)) * 0.1).astype(np.float32)
    calls = []
    real = gp.sfsb_monolith_serve_pallas
    monkeypatch.setattr(gp, "sfsb_monolith_serve_pallas",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(gp, "_INTERPRET", True)
    ref = J.spiking_fullsubnet_apply(jcfg, params, state, jnp.asarray(noisy))
    assert len(calls) == 1
    out = _port(pcfg, params, state, noisy)
    assert out["enhanced_y"].dtype == torch.float32
    assert _snr(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"])) > 60


def test_zoo_m_cumulative_norm_full_width_f64_matches_jax():
    jcfg, pcfg, params, state = _zoo(np.float64, kw=CUM_KW)
    assert sf.norm_mode(pcfg) == "cum" and sf.monolith_ok(pcfg)
    noisy = np.random.default_rng(5).standard_normal((1, 32000)) * 0.05
    _port_matches_jax(jcfg, pcfg, params, state, noisy)


def test_flagship_m_full_width_f64_matches_jax():
    jb = jax_flagship_m(seed=1)
    kw = {k: v for k, v in jb["config"].__dict__.items()
          if k not in ("scan_mode", "collect_layer_outputs")}
    jcfg, pcfg = _cfgs(**kw)
    assert sf.norm_mode(pcfg) == "ln" and sf.monolith_ok(pcfg)
    to = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float64), t)  # noqa: E731
    noisy = np.random.default_rng(6).standard_normal((1, 16000)) * 0.1
    _port_matches_jax(jcfg, pcfg, to(jb["params"]), to(jb["state"]), noisy)
