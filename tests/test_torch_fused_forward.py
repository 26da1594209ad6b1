"""The port's fused forward (``scan_mode="fused"``,
``spiking_fullsubnet_torch/models/fused_forward.py``) against the JAX
package's, on the CPU, where it runs the single scan written out as a loop
over frames.

- f64, eval and train, the JAX test's small model
  (tests/test_fused_forward.py:33-44) at 2 x 0.125 s: ``enhanced_y``,
  ``enhanced_mag``, the state and every synops tensor within 1e-12 of the
  JAX fused forward; also with ``fb_proj_size=0`` (no ``fb_out`` entry, the
  spikes tiled) and ``num_spks=2`` (no ``enhanced_mag``);
- the gradients of an L1 loss through the train forward within 1e-10 of
  ``jax.grad``;
- the port's fused forward against the port's layered one to the same
  bounds, gradients included;
- the route a CUDA tensor takes (``fused_forward_layered``, the layered
  formulation with the fused forward's fullband gather), run here on the
  kernels' plain versions, against the single scan to the same bounds,
  gradients included, also at ``fb_proj_size=0``, where the fullband tile is
  128 bins wide and the layered forward's answer is another;
- the bf16 policy: finite float32 audio;
- the refusals: JAX's ``ValueError``s for a norm and for another backbone,
  and ``NotImplementedError`` for the band/data mesh axes;
- ``"auto"`` in eval on a no-norm GSN config that misses
  ``stream_supported`` (``fb_proj_size=0``) takes the fused forward, as in
  JAX.
Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models import spiking_fullsubnet as J
from spiking_fullsubnet_tpu.models.stream_forward import stream_supported as jax_stream_supported

from spiking_fullsubnet_torch.models import fused_forward as PF
from spiking_fullsubnet_torch.models import spiking_fullsubnet as P
from spiking_fullsubnet_torch.models.stream_forward import stream_supported
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy
from spiking_fullsubnet_torch.runtime.trainer import tensors_of

SMALL = dict(fb_hidden_size=32, sb_hidden_size=24, df_orders=(2, 1, 1), bn=True,
             shared_weights=True, scan_mode="fused")
SAMPLES = 2000


def _small(**change):
    jcfg = J.SpikingFullSubNetConfig(**dict(SMALL, **change))
    params, state = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)
    for tree in [state["fb"]] + state["sb"]:  # running statistics that matter in eval
        for ls in tree["stack"]["layers"]:
            rm = ls["bn"]["running_mean"]
            ls["bn"]["running_mean"] = jnp.asarray(0.1 * rng.standard_normal(rm.shape))
    to64 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float64), t)  # noqa: E731
    pcfg = P.SpikingFullSubNetConfig(**jcfg.__dict__)
    x = np.random.default_rng(0).standard_normal((2, SAMPLES)) * 0.1
    return jcfg, pcfg, to64(params), to64(state), x


def _port(pcfg, params, state, x, train, grad=False):
    p = params_from_numpy(params, "cpu")
    if grad:
        for t in tensors_of(p):
            t.requires_grad_(True)
    return P.spiking_fullsubnet_apply(pcfg, p, params_from_numpy(state, "cpu"),
                                      torch.from_numpy(x), train=train), p


def _jax(jcfg, params, state, x, train):
    """The JAX forward under ``jax.jit`` (eager, its compile takes ten times
    as long)."""
    fn = jax.jit(lambda p, s, y: J.spiking_fullsubnet_apply(jcfg, p, s, y, train=train))
    return fn(params, state, jnp.asarray(x))


def _np_leaves(tree):
    """The leaves of a torch or JAX tree in JAX's order, as numpy arrays."""
    return [x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in jax.tree.leaves(tree)]


def _assert_same(out, ref, atol=1e-12):
    """Two output dicts of the same forward (port or JAX): the audio, the
    magnitude, the state and every synops tensor."""
    for key in ("enhanced_y", "enhanced_mag", "state", "fb_all_layer_outputs",
                "sb_all_layer_outputs"):
        assert (key in out) == (key in ref), key
        got, want = _np_leaves(out.get(key)), _np_leaves(ref.get(key))
        assert len(got) == len(want), key
        for a, b in zip(got, want):
            assert a.shape == b.shape, key
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize("change", [{}, {"fb_proj_size": 0}, {"num_spks": 2}],
                         ids=["small", "fb_proj_size_0", "num_spks_2"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_f64_matches_jax_fused(train, change):
    jcfg, pcfg, params, state, x = _small(**change)
    ref = _jax(jcfg, params, state, x, train)
    out, _ = _port(pcfg, params, state, x, train)
    _assert_same(out, ref)
    if train:  # the running statistics moved
        moved = [float(np.abs(a.numpy() - b).max()) for a, b in
                 zip(tensors_of(out["state"]), jax.tree.leaves(state))]
        assert min(moved) > 0
    # the pre-LN input, two layers' spikes and, with a projection, fb_out
    assert len(out["fb_all_layer_outputs"]) == 3 + (pcfg.fb_proj_size > 0)
    assert ("enhanced_mag" in out) == (pcfg.num_spks == 1)


def _l1_target():
    return np.random.default_rng(1).standard_normal((2, SAMPLES)) * 0.05


def test_fused_grads_f64_match_jax():
    jcfg, pcfg, params, state, x = _small()
    target = _l1_target()

    def jloss(p):
        out = J.spiking_fullsubnet_apply(jcfg, p, jax.tree.map(jnp.asarray, state),
                                         jnp.asarray(x), train=True)
        return jnp.mean(jnp.abs(out["enhanced_y"] - target))

    jgrads = jax.jit(jax.grad(jloss))(params)
    out, p = _port(pcfg, params, state, x, True, grad=True)
    (out["enhanced_y"] - torch.from_numpy(target)).abs().mean().backward()
    pg = [t.grad for t in jax.tree.leaves(p)]
    jg = jax.tree.leaves(jgrads)
    assert len(pg) == len(jg)
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, rtol=0)
    assert max(float(g.abs().max()) for g in pg) > 1e-6


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_f64_matches_port_layered(train):
    _, pcfg, params, state, x = _small()
    target = torch.from_numpy(_l1_target())
    outs, grads = [], []
    for cfg in (pcfg, replace(pcfg, scan_mode="layered")):
        out, p = _port(cfg, params, state, x, train, grad=train)
        outs.append(out)
        if train:
            (out["enhanced_y"] - target).abs().mean().backward()
            grads.append([t.grad for t in jax.tree.leaves(p)])
    _assert_same(*outs)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10, rtol=0)


@pytest.mark.parametrize("change", [{}, {"fb_proj_size": 0}, {"num_spks": 2}],
                         ids=["small", "fb_proj_size_0", "num_spks_2"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_kernel_route_f64_matches_the_single_scan(train, change):
    _, pcfg, params, state, x = _small(**change)
    target = torch.from_numpy(_l1_target())
    outs, grads = [], []
    for route in (PF.fused_forward_plain, PF.fused_forward_layered):
        p = params_from_numpy(params, "cpu")
        for t in tensors_of(p):
            t.requires_grad_(train)
        out = route(pcfg, p, params_from_numpy(state, "cpu"), torch.from_numpy(x), train)
        outs.append(out)
        if train:
            (out["enhanced_y"] - target).abs().mean().backward()
            grads.append([t.grad for t in jax.tree.leaves(p)])
    _assert_same(*outs)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10, rtol=0)
    if change:  # the layered forward's tile and gather give another answer here
        lay = P.spiking_fullsubnet_apply(replace(pcfg, scan_mode="layered"),
                                         params_from_numpy(params, "cpu"),
                                         params_from_numpy(state, "cpu"), torch.from_numpy(x),
                                         train=train)
        gap = (lay["enhanced_y"] - outs[0]["enhanced_y"]).abs().max().item()
        assert (gap > 1e-3) == ("fb_proj_size" in change)


def test_fused_bf16_policy_gives_finite_f32_audio():
    _, pcfg, params, state, x = _small()
    p32 = params_from_numpy(jax.tree.map(lambda a: a.astype(np.float32), params), "cpu")
    s32 = params_from_numpy(jax.tree.map(lambda a: a.astype(np.float32), state), "cpu")
    cfg = replace(pcfg, compute_dtype="bfloat16")
    for train in (False, True):
        out = P.spiking_fullsubnet_apply(cfg, p32, s32,
                                         torch.from_numpy(x.astype(np.float32)), train=train)
        assert out["enhanced_y"].dtype == torch.float32
        assert torch.isfinite(out["enhanced_y"]).all()
        assert out["fb_all_layer_outputs"][1].dtype == torch.bfloat16  # spikes in bf16
        assert all(t.dtype == torch.float32 for t in tensors_of(out["state"]))


@pytest.mark.parametrize("change,exc,match", [
    ({"norm_type": "offline_laplace_norm"}, ValueError, "norm_type"),
    ({"sequence_model": "LSTM"}, ValueError, "GSN backbone"),
    ({"band_axis": "band"}, NotImplementedError, "ROADMAP queue 1: distributed training"),
    ({"data_axis": "data"}, NotImplementedError, "ROADMAP queue 1: distributed training"),
])
def test_fused_refusals(change, exc, match):
    _, pcfg, params, state, x = _small()
    cfg = replace(pcfg, **change)
    with pytest.raises(exc, match=match):
        P.spiking_fullsubnet_apply(cfg, params_from_numpy(params, "cpu"),
                                   params_from_numpy(state, "cpu"), torch.from_numpy(x))
    if exc is ValueError:  # the JAX fused forward's own message
        jcfg = J.SpikingFullSubNetConfig(**cfg.__dict__)
        with pytest.raises(exc, match=match):
            _jax(jcfg, params, state, x, False)


def test_auto_takes_fused_in_eval_where_the_stream_path_does_not(monkeypatch):
    jcfg, pcfg, params, state, x = _small(fb_proj_size=0, scan_mode="auto")
    assert not stream_supported(pcfg) and not jax_stream_supported(jcfg)
    seen = []
    real = PF.fused_forward_plain
    monkeypatch.setattr(PF, "fused_forward_plain",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    out, _ = _port(pcfg, params, state, x, False)
    assert seen == [1]
    _assert_same(out, _jax(jcfg, params, state, x, False))
    # training on a CPU tensor takes the layered path, as in JAX
    out, _ = _port(pcfg, params, state, x, True)
    assert seen == [1]
