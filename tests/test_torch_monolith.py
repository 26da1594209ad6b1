"""Kernel C's plain version (spiking_fullsubnet_torch/ops/gsu_kernels.py:
monolith_serve_plain, through the port's monolith spec) against the JAX
package's sfsb_monolith_serve_pallas in interpret mode, and the port's init,
build and flagship preset against the JAX package's tree.

- tiny separator config (the TINY_KW of tests/test_torch_stream_forward.py
  with each norm), f32, B = 3 (not a multiple of 8), BN and pre-LN affine
  randomized: the enhanced hop chunks of both kernels agree to SNR > 60 dB
  (tests/test_stream_forward.py:85), for "ln", "cum" and "raw", shared and
  unshared weights. The JAX monolith runs only where round_up(T, 128) >=
  T + 3, so the lengths give T = 60, and a counter asserts that it ran;
- spiking_fullsubnet_init, build_separator and flagship_m give the JAX
  package's keys and shapes, uniform values inside their U(+-1/sqrt(fan))
  bounds, and the LayerNorm and BatchNorm defaults exactly.
The CUDA kernel is held against the plain version on a card by
tests/test_torch_cuda_kernels.py.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spiking_fullsubnet_tpu.ops.gsu_pallas as gp
from spiking_fullsubnet_tpu.models import spiking_fullsubnet as J
from spiking_fullsubnet_tpu.models.presets import flagship_m as jax_flagship_m

from spiking_fullsubnet_torch.models import spiking_fullsubnet as P
from spiking_fullsubnet_torch.models import stream_forward as sf
from spiking_fullsubnet_torch.models.presets import flagship_m
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy

TINY_KW = dict(
    n_fft=128, hop_length=32, win_length=128,
    fb_input_size=16, fb_hidden_size=24, fb_proj_size=16,
    sb_hidden_size=20, freq_cutoffs=(0, 8, 32, 64),
    df_orders=(2, 1, 3), center_freq_sizes=(2, 8, 16),
    neighbor_freq_sizes=(3, 3, 3),
    fb_center_freq_sizes=(2, 8, 16), fb_neighbor_freq_sizes=(0, 0, 0), bn=True)
NORMS = {
    "ln": dict(norm_type=None, use_pre_layer_norm_fb=True, use_pre_layer_norm_sb=True),
    "cum": dict(norm_type="cumulative_laplace_norm", use_pre_layer_norm_fb=False,
                use_pre_layer_norm_sb=False),
    "raw": dict(norm_type=None, use_pre_layer_norm_fb=False, use_pre_layer_norm_sb=False),
}
SAMPLES = 1900  # T = 60 frames of hop 32: round_up(60, 128) >= 63, the JAX monolith runs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret():
    old = gp._INTERPRET
    gp._INTERPRET = True
    yield
    gp._INTERPRET = old


def tiny_model(norm, shared, dtype=np.float32, seed=0):
    """(JAX cfg, port cfg, params, state) as numpy, with the BN fold and the
    pre-LN affine randomized so that both matter."""
    kw = dict(TINY_KW, **NORMS[norm], shared_weights=shared)
    jcfg = J.SpikingFullSubNetConfig(**kw, scan_mode="stream", collect_layer_outputs=False)
    pcfg = P.SpikingFullSubNetConfig(**kw, scan_mode="auto", collect_layer_outputs=False)
    params, state = J.spiking_fullsubnet_init(jax.random.PRNGKey(seed), jcfg)
    to = lambda t: jax.tree.map(lambda x: np.asarray(x, dtype), t)  # noqa: E731
    params, state = to(params), to(state)
    rng = np.random.default_rng(seed + 7)
    for tree in [state["fb"]] + state["sb"]:
        for ls in tree["stack"]["layers"]:
            ls["bn"]["running_mean"] = (0.1 * rng.standard_normal(
                ls["bn"]["running_mean"].shape)).astype(dtype)
    for p in [params["fb"]] + params["sb"]:
        if "pre_ln" in p:
            w = p["pre_ln"]["weight"]
            p["pre_ln"]["weight"] = (1 + 0.2 * rng.standard_normal(w.shape)).astype(dtype)
            p["pre_ln"]["bias"] = (0.2 * rng.standard_normal(w.shape)).astype(dtype)
    return jcfg, pcfg, params, state


class Recorder:
    """Wraps a module attribute: counts the calls and keeps the last result."""

    def __init__(self, monkeypatch, module, name):
        self.real, self.calls, self.out = getattr(module, name), 0, None
        monkeypatch.setattr(module, name, self)

    def __call__(self, *args, **kw):
        self.calls += 1
        self.out = self.real(*args, **kw)
        return self.out


def _snr(a, b):
    return 10 * np.log10(np.sum(b ** 2) / max(np.sum((a - b) ** 2), 1e-30))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("norm", ["ln", "cum", "raw"])
def test_monolith_plain_f32_matches_pallas_interpret(interpret, monkeypatch, norm, shared):
    jcfg, pcfg, params, state = tiny_model(norm, shared)
    noisy = (np.random.default_rng(1).standard_normal((3, SAMPLES)) * 0.1).astype(np.float32)
    jrec = Recorder(monkeypatch, gp, "sfsb_monolith_serve_pallas")
    prec = Recorder(monkeypatch, sf, "sfsb_monolith_serve")
    J.spiking_fullsubnet_apply(jcfg, params, state, jnp.asarray(noisy))
    out = P.spiking_fullsubnet_apply(pcfg, params_from_numpy(params, "cpu"),
                                     params_from_numpy(state, "cpu"), torch.from_numpy(noisy))
    assert jrec.calls == 1 and prec.calls == 1
    T = SAMPLES // 32 + 1
    got, ref = prec.out.numpy(), np.asarray(jrec.out)
    assert got.shape == (T + 3, 3, 32) and got.dtype == np.float32
    assert ref.shape[0] >= T + 3
    assert _snr(got, ref[:T + 3]) > 60
    assert out["enhanced_y"].shape == (3, SAMPLES) and out["enhanced_mag"] is None


def test_monolith_spec_statistics_columns():
    """Unit u's column sums to 1 over its unfold (counts / w_tot, fullband
    part included); column U is the fullband input's mean."""
    _, pcfg, params, state = tiny_model("cum", True, np.float64)
    p, s = params_from_numpy(params, "cpu"), params_from_numpy(state, "cpu")
    mono = sf.monolith_spec(pcfg, p["fb"], p["sb"], s, torch.float64, torch.float64, 10)
    U = sum(sec["wa"].shape[0] for sec in mono["secs"])
    tot = mono["sel_mag"].sum(0) + mono["sel_fb"].sum(0)
    np.testing.assert_allclose(tot.numpy(), np.ones(U + 1), rtol=1e-12)
    assert (mono["sel_mag"][pcfg.fb_input_size:, U] == 0).all()
    assert mono["wdft"].shape == (128, 130) and mono["widft"].shape == (130, 128)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _check_tree(port, jax_tree):
    fp, fj = _flat(port), _flat(jax_tree)
    assert sorted(fp) == sorted(fj)
    for k, x in fp.items():
        assert tuple(x.shape) == tuple(np.shape(fj[k])), k
        assert x.dtype == torch.float32, k
    return fp


def _check_values(fp, bounds):
    for k, x in fp.items():
        x = x.cpu().double()
        if k.endswith(("bn/weight", "running_var", "pre_ln/weight")):
            assert torch.equal(x, torch.ones_like(x)), k
        elif k.endswith(("bn/bias", "running_mean", "pre_ln/bias")):
            assert torch.equal(x, torch.zeros_like(x)), k
        else:
            b = bounds(k, x)
            assert x.abs().max() <= b and x.abs().max() > 0.8 * b, k
            if x.numel() > 1000:
                assert abs(x.mean().item()) < 0.05 * b, k


def _gsu_or_linear_bound(cfg):
    def bound(key, x):
        if "/proj/" in key:  # Linear: U(+-1/sqrt(fan_in)), fan_in = hidden
            return 1.0 / math.sqrt(x.shape[-1] if key.endswith("weight") else
                                   (cfg.fb_hidden_size if "/fb/" in key else cfg.sb_hidden_size))
        return 1.0 / math.sqrt(cfg.fb_hidden_size if "/fb/" in key else cfg.sb_hidden_size)
    return bound


def test_flagship_m_tree_matches_jax():
    b = flagship_m(seed=3, device="cpu", collect_layer_outputs=False)
    jb = jax_flagship_m(collect_layer_outputs=False)
    assert b["config"].__dict__ == jb["config"].__dict__
    assert b["apply"] is P.spiking_fullsubnet_apply
    fp = _check_tree({"params": b["params"], "state": b["state"]},
                     {"params": jb["params"], "state": jb["state"]})
    _check_values(fp, _gsu_or_linear_bound(b["config"]))
    assert sf.monolith_ok(b["config"]) and sf.norm_mode(b["config"]) == "ln"


def test_init_is_seeded_and_separator_tree_matches_jax():
    kw = dict(norm_type="cumulative_laplace_norm", shared_weights=False, bn=True,
              sb_output_activate_function=False, fb_num_center_freqs=[4, 32, 64])
    b = P.build_separator(seed=5, device="cpu", **kw)
    jb = J.build_separator(seed=0, **kw)
    assert b["config"].__dict__ == jb["config"].__dict__
    fp = _check_tree({"params": b["params"], "state": b["state"]},
                     {"params": jb["params"], "state": jb["state"]})
    _check_values(fp, _gsu_or_linear_bound(b["config"]))
    again = P.spiking_fullsubnet_init(5, b["config"], device="cpu")
    other = P.spiking_fullsubnet_init(6, b["config"], device="cpu")
    w = lambda p: p["sb"][1]["stack"]["layers"][0]["weight_hh"]  # noqa: E731
    assert torch.equal(w(again[0]), w(b["params"])) and not torch.equal(w(other[0]), w(b["params"]))
    m = P.SpikingFullSubNet.from_init(b["config"], seed=5, device="cpu")
    assert torch.equal(w(m.param_tree()), w(b["params"]))
    # the LIF backbone builds the JAX tree too (its refusal went with its port)
    lif = dict(TINY_KW, sequence_model="LIF")
    _check_tree({"params": P.build(seed=0, device="cpu", **lif)["params"]},
                {"params": J.build(seed=0, **lif)["params"]})
