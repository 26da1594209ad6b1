"""The port's shared sub-band ablation (``sb_shared_bottleneck``,
models/shared_subband.py) against the JAX package.

- the parameter tree: the JAX tree's keys and shapes, and the analytic
  count of tests/test_shared_subband.py;
- the eval forward on kernel F's plain version at that test's config (2 x
  3200 samples) and at zoo M widths with a bottleneck of 224 (1 x 0.25 s),
  in float64 against the JAX layered forward: audio within 3e-6
  (tests/test_stream_forward.py:53's bound), the deep-filter magnitude
  within 1e-9, every layer's spikes equal, and the shared stack's rows
  every section's units at once;
- one ``train_step`` (the denoise loss, its gradient, clipping by global
  norm 10, AdamW) at that test's config on 8 rows of 0.1 s, on D's and E's
  plain versions, against ``jax.value_and_grad`` + optax in float64: loss
  and norm within rtol 1e-12, every gradient leaf within 1e-9 of its
  largest, the new BN state (over every section's units) within 1e-12, the
  weights after the step within 1e-10.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from spiking_fullsubnet_tpu.losses import freq_mae, mag_mae, si_snr
from spiking_fullsubnet_tpu.models import spiking_fullsubnet as J
from spiking_fullsubnet_tpu.runtime.registry import _optax_adamw

from spiking_fullsubnet_torch.models import spiking_fullsubnet as P
from spiking_fullsubnet_torch.recipes.denoise import adamw, train_step
from spiking_fullsubnet_torch.runtime.convert import flat_paths, params_from_numpy

# tests/test_shared_subband.py's config
SHARED_KW = dict(n_fft=128, hop_length=32, win_length=128, fb_input_size=16, fb_hidden_size=24,
                 fb_num_layers=2, fb_proj_size=16, sb_hidden_size=20, sb_num_layers=2,
                 freq_cutoffs=(0, 16, 64), df_orders=(3, 1), center_freq_sizes=(4, 16),
                 neighbor_freq_sizes=(5, 5), bn=True, shared_weights=True,
                 sb_shared_bottleneck=12)
ZOO_KW = dict(norm_type="offline_laplace_norm", shared_weights=True, bn=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree, dtype=np.float64):
    return jax.tree.map(lambda x: np.asarray(x, dtype), tree)


def _configs(kind):
    if kind == "test config":
        jcfg = J.SpikingFullSubNetConfig(**SHARED_KW)
    else:  # zoo M widths as chip_smoke.py phase 13 runs them
        jcfg = replace(J.separator_config(**ZOO_KW), sb_shared_bottleneck=224)
    return jcfg, P.SpikingFullSubNetConfig(**jcfg.__dict__)


def _gsu_stack_params(input_size, hidden, layers, shared, bn, pre_ln, proj_in, proj_out):
    rows = hidden if shared else 2 * hidden
    n, fin = 0, input_size
    for _ in range(layers):
        n += rows * fin + rows * hidden + 2 * hidden + (2 * hidden if bn else 0)
        fin = hidden
    return n + (2 * input_size if pre_ln else 0) + proj_in * proj_out + proj_out


def test_parameter_tree_and_count_match_jax():
    jcfg, pcfg = _configs("test config")
    jp, js = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    pp, ps = P.spiking_fullsubnet_init(3, pcfg, device="cpu")
    for port, ref in ((pp, jp), (ps, js)):
        assert {k: tuple(v.shape) for k, v in flat_paths(port).items()} == \
            {k: tuple(np.shape(v)) for k, v in flat_paths(ref).items()}
    bt = pcfg.sb_shared_bottleneck
    expected = _gsu_stack_params(16, 24, 2, True, True, True, 24, 16)
    expected += _gsu_stack_params(bt, 20, 2, True, True, True, 20, bt)
    for i, (ctr, nbr, df) in enumerate(zip((4, 16), (5, 5), (3, 1))):
        expected += ((ctr + 2 * nbr) + pcfg.fb_ctrs[i] + 2 * pcfg.fb_nbrs[i]) * bt + bt
        expected += bt * ctr * 2 * df + ctr * 2 * df
    assert sum(t.numel() for t in flat_paths(pp).values()) == expected
    assert ps["sb"]["stack"]["stack"]["layers"][0]["bn"]["running_var"].shape == (20,)


def _randomized_state(state, rng):
    """BN running statistics moved off their init, so that the fold matters."""
    for ls in state["fb"]["stack"]["layers"] + state["sb"]["stack"]["stack"]["layers"]:
        ls["bn"]["running_mean"] = 0.1 * rng.standard_normal(ls["bn"]["running_mean"].shape)
    return state


@pytest.mark.parametrize("kind,shape", [("test config", (2, 3200)), ("zoo M", (1, 4000))])
def test_eval_forward_matches_jax_f64(kind, shape):
    jcfg, pcfg = _configs(kind)
    params, state = J.spiking_fullsubnet_init(jax.random.PRNGKey(1), jcfg)
    params, state = _np(params), _randomized_state(_np(state), np.random.default_rng(2))
    noisy = np.random.default_rng(3).standard_normal(shape) * 0.1
    ref = jax.jit(lambda p, s, x: J.spiking_fullsubnet_apply(jcfg, p, s, x))(
        params, state, jnp.asarray(noisy))
    out = P.spiking_fullsubnet_apply(pcfg, params_from_numpy(params, "cpu"),
                                     params_from_numpy(state, "cpu"), torch.from_numpy(noisy))
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6, rtol=0)
    np.testing.assert_allclose(out["enhanced_mag"].numpy(), np.asarray(ref["enhanced_mag"]),
                               atol=1e-9, rtol=0)
    n_units = sum((hi - lo) // c for lo, hi, c in zip(pcfg.freq_cutoffs, pcfg.freq_cutoffs[1:],
                                                       pcfg.center_freq_sizes))
    sb = out["sb_all_layer_outputs"]
    assert len(sb) == pcfg.num_sections and all(s is sb[0] for s in sb)
    assert sb[0][1].shape[1] == shape[0] * n_units  # the shared stack's rows
    for got, r in zip(out["fb_all_layer_outputs"] + sb[0],
                      list(ref["fb_all_layer_outputs"]) + list(ref["sb_all_layer_outputs"][0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=1e-9, rtol=0)


def _close_by_max(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref,
                               atol=rel * (1e-30 + np.abs(ref).max()), rtol=0, err_msg=what)


def test_one_train_step_matches_jax_f64():
    clip = 10.0
    jcfg, pcfg = _configs("test config")
    params, state = J.spiking_fullsubnet_init(jax.random.PRNGKey(4), jcfg)
    params, state = _np(params), _np(state)
    rng = np.random.default_rng(5)
    clean = rng.standard_normal((8, 1600)) * 0.1
    noisy = clean + 0.05 * rng.standard_normal((8, 1600))

    def loss_fn(p):
        out = J.spiking_fullsubnet_apply(jcfg, p, state, jnp.asarray(noisy), train=True)
        e, c = out["enhanced_y"], jnp.asarray(clean)
        return freq_mae(e, c) + mag_mae(e, c) + 0.001 * (100.0 - si_snr(e, c)), out["state"]

    jp = jax.tree.map(jnp.asarray, params)
    (ref_loss, ref_state), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    tx = optax.chain(optax.clip_by_global_norm(clip), _optax_adamw(1e-3))
    updates, _ = jax.jit(tx.update)(ref_g, tx.init(jp), jp)
    ref_params = optax.apply_updates(jp, updates)

    tp = params_from_numpy(params, "cpu")
    leaves = jax.tree.leaves(tp)
    losses, new_state, norm = train_step(P.spiking_fullsubnet_apply, pcfg, tp,
                                         params_from_numpy(state, "cpu"),
                                         torch.from_numpy(noisy), torch.from_numpy(clean),
                                         adamw(leaves))
    np.testing.assert_allclose(losses["loss"].item(), float(ref_loss), rtol=1e-12)
    ref_norm = float(optax.global_norm(ref_g))
    np.testing.assert_allclose(norm.item(), ref_norm, rtol=1e-12)
    coef = min(1.0, clip / (ref_norm + 1e-6))  # torch clips by clip / (norm + 1e-6)
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref_g), leaves):
        _close_by_max(g.grad.numpy(), coef * np.asarray(r), 1e-9, jax.tree_util.keystr(path))
    assert sum(float(np.abs(g.grad.numpy()).sum()) for g in jax.tree.leaves(tp["sb"]["lin_in"])) > 0
    for a, r in zip(jax.tree.leaves(new_state), jax.tree.leaves(ref_state)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-12, atol=1e-15)
    before = state["sb"]["stack"]["stack"]["layers"][0]["bn"]["running_mean"]
    assert np.abs(new_state["sb"]["stack"]["stack"]["layers"][0]["bn"]["running_mean"].numpy()
                  - before).max() > 0
    for a, r in zip(leaves, jax.tree.leaves(ref_params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), atol=1e-10, rtol=0)
