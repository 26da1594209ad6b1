"""The port's layered training step against the JAX package.

- sequence_model_apply(train=True) (pre-LN, projection, output activation)
  against the JAX scan in f64: outputs within 1e-12, the new BN state within
  rtol 1e-12, every gradient leaf within 1e-9 max|g|;
- one whole training step (apply(train=True), the denoise recipe's loss,
  its gradient, clipping by global norm 10, AdamW with the registry's
  values) against the JAX package in f64: cIRM-GSN at tiny widths and zoo M
  at full width from baseline_m.npz, 1 x 0.5 s. Loss and norm within rtol
  1e-12, every gradient leaf within 1e-9 max|g|, the new BN state within
  rtol 1e-12, the parameters after the step within 1e-10;
- the dispatch: on a CPU tensor scan_mode="auto" with train=True takes the
  layered path, as JAX on a CPU does; the stream path trains too, with
  collect_layer_outputs=True as well (zoo M, f64, against the JAX stream
  forward).
The layer-level checks of kernels D and E are in test_torch_train_layer.py.
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
import optax

from spiking_fullsubnet_tpu.losses import freq_mae, mag_mae, si_snr
from spiking_fullsubnet_tpu.models import cirm_models as JC
from spiking_fullsubnet_tpu.models import sequence_model as JS
from spiking_fullsubnet_tpu.models import spiking_fullsubnet as J
from spiking_fullsubnet_tpu.runtime.convert import load_npz as jax_load_npz
from spiking_fullsubnet_tpu.runtime.registry import _optax_adamw

from spiking_fullsubnet_torch.models import cirm_models as PC
from spiking_fullsubnet_torch.models import sequence_model as PS
from spiking_fullsubnet_torch.models import spiking_fullsubnet as P
from spiking_fullsubnet_torch.recipes.denoise import adamw, train_step
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy

ZOO_M = Path(__file__).resolve().parent.parent / "model_zoo/intel_ndns/spike_fsb/baseline_m.npz"
ZOO_KW = dict(norm_type="offline_laplace_norm", shared_weights=True, bn=True)
H = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions step through time in many small ops; one thread
    each keeps them fast when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree, dtype=None):
    return jax.tree.map(lambda x: np.asarray(x, dtype), tree)


def _weights(shape, seed):
    return np.cos(np.arange(np.prod(shape)).reshape(shape) * 0.01 + seed)


def _close_by_max(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref,
                               atol=rel * (1e-30 + np.abs(ref).max()), rtol=0, err_msg=what)


def _grads_of(tree):
    return [t.grad.numpy() for t in jax.tree.leaves(tree)]


def _trainable(tree):
    tp = params_from_numpy(tree, "cpu")
    for t in jax.tree.leaves(tp):
        t.requires_grad_(True)
    return tp


def test_sequence_model_train_matches_jax_scan_f64():
    kw = dict(input_size=21, hidden_size=H, num_layers=2, proj_size=10, shared_weights=False,
              bn=True, use_pre_layer_norm=True, output_activate_function="tanh")
    jcfg = JS.SequenceModelConfig(**kw, backend="scan")
    params, state = JS.sequence_model_init(jax.random.PRNGKey(2), jcfg)
    p, s = _np(params, np.float64), _np(state, np.float64)
    rng = np.random.default_rng(8)
    p["pre_ln"]["weight"] = 1 + 0.2 * rng.standard_normal(21)
    p["pre_ln"]["bias"] = 0.2 * rng.standard_normal(21)
    x = np.abs(np.random.default_rng(9).standard_normal((3, 21, 17)))
    wv = _weights((3, 10, 17), 2.0)

    def loss(pp):
        out, _, ns = JS.sequence_model_apply(jcfg, pp, s, jnp.asarray(x), train=True)
        return jnp.sum(out * wv), (out, ns)

    (_, (ref, ref_state)), g = jax.value_and_grad(loss, has_aux=True)(p)
    tp = _trainable(p)
    out, alo, state = PS.sequence_model_apply(PS.SequenceModelConfig(**kw), tp,
                                              params_from_numpy(s, "cpu"), torch.from_numpy(x),
                                              train=True)
    (out * torch.from_numpy(wv)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-12)
    assert len(alo) == 4
    for a, r in zip(jax.tree.leaves(state), jax.tree.leaves(ref_state)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-12)
    assert len(jax.tree.leaves(g)) == len(jax.tree.leaves(tp)) == 14
    for got, r in zip(_grads_of(tp), jax.tree.leaves(g)):
        _close_by_max(got, r, 1e-9)


# ------------------------------------------------------------------ whole step

CLIP = 10.0


def _step_matches_jax(japply, jcfg, papply, pcfg, params, state, noisy, clean):
    """One training step of each package from the same f64 weights; returns
    the gradients' global norm."""

    def loss_fn(p):
        out = japply(jcfg, p, state, jnp.asarray(noisy), train=True)
        e, c = out["enhanced_y"], jnp.asarray(clean)
        return freq_mae(e, c) + mag_mae(e, c) + 0.001 * (100.0 - si_snr(e, c)), out["state"]

    jp = jax.tree.map(jnp.asarray, params)
    (ref_loss, ref_state), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    tx = optax.chain(optax.clip_by_global_norm(CLIP), _optax_adamw(1e-3))
    updates, _ = jax.jit(tx.update)(ref_g, tx.init(jp), jp)
    ref_params = optax.apply_updates(jp, updates)

    tp = params_from_numpy(params, "cpu")
    leaves = jax.tree.leaves(tp)
    losses, new_state, norm = train_step(papply, pcfg, tp, params_from_numpy(state, "cpu"),
                                         torch.from_numpy(noisy), torch.from_numpy(clean),
                                         adamw(leaves))
    np.testing.assert_allclose(losses["loss"].item(), float(ref_loss), rtol=1e-12)
    ref_norm = float(optax.global_norm(ref_g))
    np.testing.assert_allclose(norm.item(), ref_norm, rtol=1e-12)
    # the gradients as torch leaves them: clipped by CLIP / (norm + 1e-6)
    # where optax clips by CLIP / norm, a relative difference of at most
    # 1e-6 / norm (2e-9 at zoo M's norm of about 540), below the
    # comparison's own 1e-9 max|g|: compare with torch's factor on both
    coef = min(1.0, CLIP / (ref_norm + 1e-6))
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref_g), leaves):
        _close_by_max(g.grad.numpy(), coef * np.asarray(r), 1e-9, jax.tree_util.keystr(path))
    for a, r in zip(jax.tree.leaves(new_state), jax.tree.leaves(ref_state)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-12, atol=1e-15)
    moved = 0.0
    for a, r, p0 in zip(leaves, jax.tree.leaves(ref_params), jax.tree.leaves(params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), atol=1e-10, rtol=0)
        moved = max(moved, float(np.abs(np.asarray(r) - p0).max()))
    assert moved > 5e-4  # the step moved the weights by about lr
    return ref_norm


def test_cirm_gsn_tiny_step_matches_jax_f64():
    kw = dict(n_fft=128, hop_length=32, win_length=128, input_size=65, hidden_size=H,
              num_layers=2, proj_size=65, output_activate_function=None, df_order=3,
              use_pre_layer_norm_fb=True, bn=True, shared_weights=True, sequence_model="GSN",
              num_spks=1)
    jcfg = JC.CirmModelConfig(**kw)
    params, state = JC.cirm_model_init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(12)
    clean = rng.standard_normal((2, 3000)) * 0.1
    noisy = clean + 0.05 * rng.standard_normal((2, 3000))
    _step_matches_jax(JC.cirm_model_apply, jcfg, PC.cirm_model_apply, PC.CirmModelConfig(**kw),
                      _np(params, np.float64), _np(state, np.float64), noisy, clean)


def test_zoo_m_full_width_step_matches_jax_f64():
    """separator_config's default (scan_mode="layered"), the published
    checkpoint, one 0.5 s utterance: eight launches of D and E on the card."""
    jcfg, pcfg = J.separator_config(**ZOO_KW), P.separator_config(**ZOO_KW)
    assert pcfg.scan_mode == jcfg.scan_mode == "layered"
    tpl = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    tree = jax_load_npz(str(ZOO_M), {"params": tpl[0], "state": tpl[1]})
    rng = np.random.default_rng(4)
    clean = rng.standard_normal((1, 8000)) * 0.1
    noisy = clean + 0.05 * rng.standard_normal((1, 8000))
    norm = _step_matches_jax(J.spiking_fullsubnet_apply, jcfg, P.spiking_fullsubnet_apply, pcfg,
                             _np(tree["params"], np.float64), _np(tree["state"], np.float64),
                             noisy, clean)
    assert norm > CLIP  # the clip is exercised


# ------------------------------------------------------------------ dispatch


def test_auto_trains_layered_on_cpu_and_stream_training_raises(monkeypatch):
    """On a CPU tensor "auto" with train=True takes the layered path
    (spiking_fullsubnet.py:265-275: JAX on a CPU keeps the layered
    reference), even for a config the stream path supports; the stream
    path trains (tests/test_torch_stream_train.py), with the per-layer
    outputs collected too: in f64 its audio (atol 3e-6), lists and new BN
    state (atol 1e-9) equal the JAX stream forward's."""
    from spiking_fullsubnet_torch.models.stream_forward import stream_supported

    cfg = replace(P.separator_config(**ZOO_KW), scan_mode="auto", collect_layer_outputs=False)
    assert stream_supported(cfg)
    model = P.SpikingFullSubNet.from_npz(str(ZOO_M), cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    calls = []
    monkeypatch.setattr(P, "_layered_forward",
                        lambda *a, real=P._layered_forward: calls.append(a[-1]) or real(*a))
    params, state = model.param_tree(), model.state_tree()
    noisy = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 2400)) * 0.05).float()
    out = P.spiking_fullsubnet_apply(cfg, params, state, noisy, train=True)
    assert calls == [True] and out["enhanced_y"].requires_grad
    new_rm = out["state"]["sb"][0]["stack"]["layers"][0]["bn"]["running_mean"]
    assert not torch.equal(new_rm, state["sb"][0]["stack"]["layers"][0]["bn"]["running_mean"])
    assert not model(noisy)["enhanced_y"].requires_grad  # forward stays the no-grad eval

    stream = replace(cfg, scan_mode="stream", collect_layer_outputs=True)
    jcfg = J.SpikingFullSubNetConfig(**stream.__dict__)
    tpl = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    tree = _np(jax_load_npz(str(ZOO_M), {"params": tpl[0], "state": tpl[1]}), np.float64)
    x64 = noisy.double().numpy()
    ref = J.spiking_fullsubnet_apply(jcfg, tree["params"], tree["state"], jnp.asarray(x64),
                                     train=True)
    got = P.spiking_fullsubnet_apply(stream, params_from_numpy(tree["params"], "cpu"),
                                     params_from_numpy(tree["state"], "cpu"),
                                     torch.from_numpy(x64), train=True)
    np.testing.assert_allclose(got["enhanced_y"].detach().numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6)
    for key in ("fb_all_layer_outputs", "sb_all_layer_outputs", "state"):
        r_leaves = jax.tree.leaves(ref[key])
        assert len(jax.tree.leaves(got[key])) == len(r_leaves) > 0, key
        for g, r in zip(jax.tree.leaves(got[key]), r_leaves):
            assert tuple(g.shape) == tuple(r.shape), key
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=1e-9, rtol=0)
