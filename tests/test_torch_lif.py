"""The port's LIF and ALIF neurons (ops/lif.py) and the LIF/ALIF backbones
of the sequence model against the JAX package, in float64.

- ``lif_sequence`` in every reset mode (soft or hard, the reset detached or
  not) and ``alif_sequence`` (soft and hard): spikes equal, the last
  membrane within 1e-12, and the gradients of a weighted sum of the spikes
  (the triangle surrogate through the recurrence) against ``jax.grad``
  within 1e-10;
- the dense SNN (``lif_dense_apply``, LIF and ALIF, the non-spiking
  readout and a spiking last layer): outputs and every weight's gradient
  within 1e-10;
- ``sequence_model_apply`` with ``"LIF"`` and ``"ALIF"`` (pre-LN and the
  projection), and an ALIF Spiking-FullSubNet at tiny widths against JAX's
  layered forward: audio within 3e-6 (tests/test_stream_forward.py:53's
  bound), every layer output within 1e-9; its tree against JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models import sequence_model as JS
from spiking_fullsubnet_tpu.models import spiking_fullsubnet as J
from spiking_fullsubnet_tpu.ops import lif as JL

from spiking_fullsubnet_torch.models import sequence_model as PS
from spiking_fullsubnet_torch.models import spiking_fullsubnet as P
from spiking_fullsubnet_torch.ops import lif as PL
from spiking_fullsubnet_torch.runtime.convert import flat_paths, params_from_numpy

T, B, F = 30, 3, 8
TINY_KW = dict(n_fft=128, hop_length=32, win_length=128, fb_input_size=16, fb_hidden_size=24,
               fb_proj_size=16, sb_hidden_size=20, freq_cutoffs=(0, 8, 32, 64),
               df_orders=(2, 1, 3), center_freq_sizes=(2, 8, 16), neighbor_freq_sizes=(3, 3, 3),
               fb_center_freq_sizes=(2, 8, 16), fb_neighbor_freq_sizes=(0, 0, 0),
               use_pre_layer_norm_fb=True, use_pre_layer_norm_sb=False,
               norm_type="offline_laplace_norm", sequence_model="ALIF")


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((T, B, F)) * 1.5 + 0.3, rng.standard_normal((T, B, F))


@pytest.mark.parametrize("hard_reset,detach_reset", [(False, False), (True, False),
                                                     (False, True), (True, True)],
                         ids=["soft", "hard", "soft_detached", "hard_detached"])
def test_lif_sequence_and_its_gradients_match_jax(hard_reset, detach_reset):
    x, w = _inputs(0)
    kw = dict(tau=2.0, v_threshold=1.0, hard_reset=hard_reset, detach_reset=detach_reset)
    s_ref, v_ref = JL.lif_sequence(jnp.asarray(x), **kw)
    g_ref = jax.grad(lambda xx: jnp.sum(JL.lif_sequence(xx, **kw)[0] * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    s, v = PL.lif_sequence(tx, **kw)
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(s_ref))
    assert 0.05 < float(s.detach().mean()) < 0.95
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(v_ref), atol=1e-12, rtol=0)
    (s * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_ref), atol=1e-10, rtol=0)


@pytest.mark.parametrize("hard_reset", [False, True], ids=["soft", "hard"])
def test_alif_sequence_and_its_gradients_match_jax(hard_reset):
    x, w = _inputs(1)
    kw = dict(tau=2.0, tau_adp=20.0, v_threshold=1.0, beta=1.8, hard_reset=hard_reset)
    s_ref, v_ref = JL.alif_sequence(jnp.asarray(x), **kw)
    g_ref = jax.grad(lambda xx: jnp.sum(JL.alif_sequence(xx, **kw)[0] * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    s, v = PL.alif_sequence(tx, **kw)
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(s_ref))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(v_ref), atol=1e-12, rtol=0)
    (s * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_ref), atol=1e-10, rtol=0)


@pytest.mark.parametrize("adaptive,last_layer_spikes", [(False, False), (True, False),
                                                         (True, True)],
                         ids=["lif_readout", "alif_readout", "alif_spikes"])
def test_dense_snn_and_its_gradients_match_jax(adaptive, last_layer_spikes):
    sizes = [F, 12, 10, 6]
    params = _f64(JL.lif_dense_init(jax.random.PRNGKey(2), sizes))
    pinit = PL.lif_dense_init(torch.Generator().manual_seed(2), sizes)
    assert {k: tuple(v.shape) for k, v in flat_paths(pinit).items()} == \
        {k: tuple(v.shape) for k, v in flat_paths(params).items()}
    x, _ = _inputs(3)
    x = x * 2.0
    w = np.random.default_rng(4).standard_normal((T, B, 6))
    kw = dict(adaptive=adaptive, last_layer_spikes=last_layer_spikes)

    def jloss(p):
        return jnp.sum(JL.lif_dense_apply(p, jnp.asarray(x), **kw)[0] * w)

    ref, ref_all = JL.lif_dense_apply(params, jnp.asarray(x), **kw)
    g = jax.grad(jloss)(params)
    tp = params_from_numpy(params, "cpu")
    for t in jax.tree.leaves(tp):
        t.requires_grad_(True)
    out, all_out = PL.lif_dense_apply(tp, torch.from_numpy(x), **kw)
    assert len(all_out) == len(ref_all) == 4
    for a, r in zip(all_out, ref_all):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), atol=1e-10, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    for (path, r), t in zip(jax.tree_util.tree_leaves_with_path(g), jax.tree.leaves(tp)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-10, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("model", ["LIF", "ALIF"])
def test_sequence_model_backbone_matches_jax(model):
    kw = dict(input_size=11, hidden_size=16, num_layers=2, sequence_model=model, proj_size=6,
              use_pre_layer_norm=True, output_activate_function="tanh")
    jcfg, pcfg = JS.SequenceModelConfig(**kw), PS.SequenceModelConfig(**kw)
    params, state = JS.sequence_model_init(jax.random.PRNGKey(5), jcfg)
    params = _f64(params)
    pp, ps = PS.sequence_model_init(torch.Generator().manual_seed(5), pcfg)
    assert ps == {"stack": {}} == jax.tree.map(np.asarray, state)
    assert {k: tuple(v.shape) for k, v in flat_paths(pp).items()} == \
        {k: tuple(v.shape) for k, v in flat_paths(params).items()}
    x = np.abs(np.random.default_rng(6).standard_normal((3, 11, 25))) * 3
    ref, ref_all, _ = JS.sequence_model_apply(jcfg, params, state, jnp.asarray(x))
    out, all_out, st = PS.sequence_model_apply(pcfg, params_from_numpy(params, "cpu"), ps,
                                               torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    assert len(all_out) == len(ref_all) == 3 and st == ps  # no projection in the list
    for a, r in zip(all_out, ref_all):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-12, rtol=0)


def test_alif_spiking_fullsubnet_matches_jax_layered_f64():
    jcfg = J.SpikingFullSubNetConfig(**TINY_KW)
    pcfg = P.SpikingFullSubNetConfig(**jcfg.__dict__)
    params, state = J.spiking_fullsubnet_init(jax.random.PRNGKey(7), jcfg)
    params = _f64(params)
    pp, ps = P.spiking_fullsubnet_init(7, pcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in flat_paths(pp).items()} == \
        {k: tuple(v.shape) for k, v in flat_paths(params).items()}
    noisy = np.random.default_rng(8).standard_normal((2, 3000)) * 0.3
    ref = jax.jit(lambda p, x: J.spiking_fullsubnet_apply(jcfg, p, state, x))(
        params, jnp.asarray(noisy))
    out = P.spiking_fullsubnet_apply(pcfg, params_from_numpy(params, "cpu"), ps,
                                     torch.from_numpy(noisy))
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6, rtol=0)
    got = out["fb_all_layer_outputs"] + [a for sec in out["sb_all_layer_outputs"] for a in sec]
    want = list(ref["fb_all_layer_outputs"]) + [a for sec in ref["sb_all_layer_outputs"]
                                                for a in sec]
    assert len(got) == len(want) == 12
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-9, rtol=0)
    rates = [float(a.mean()) for sec in out["sb_all_layer_outputs"] for a in sec[1:]]
    assert max(rates) > 0.0 and max(rates) < 1.0, rates  # the sub-band neurons fire
