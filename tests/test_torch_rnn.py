"""The port's LSTM and GRU (ops/rnn.py) and the LSTM sequence model against
the JAX package in float64.

- ``lstm_apply`` and ``gru_apply``, two layers, one and both directions:
  outputs within 1e-10, and the gradients of a weighted sum (inputs and
  every weight) against ``jax.grad`` within 1e-10;
- ``lstm_init`` and ``gru_init``: the JAX tree's keys and shapes, values
  within its bound 1/sqrt(H), and a seed that fixes them;
- ``sequence_model_apply`` with ``sequence_model="LSTM"`` (pre-LN,
  projection): the output within 1e-10, no layer outputs, the state as it
  came.
JAX's weights carry across through ``params_from_numpy``; inputs are made
with numpy from a seed.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models import sequence_model as JS
from spiking_fullsubnet_tpu.ops import rnn as JR

from spiking_fullsubnet_torch.models import sequence_model as PS
from spiking_fullsubnet_torch.ops import rnn as PR
from spiking_fullsubnet_torch.runtime.convert import flat_paths, params_from_numpy

F_IN, H, T, B = 6, 7, 13, 3
CELLS = {"lstm": (JR.lstm_init, JR.lstm_apply, PR.lstm_init, PR.lstm_apply, 4),
         "gru": (JR.gru_init, JR.gru_apply, PR.gru_init, PR.gru_apply, 3)}


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_rnn_and_its_gradients_match_jax_f64(cell, bidirectional):
    jinit, japply, _, papply, _ = CELLS[cell]
    p = _f64(jinit(jax.random.PRNGKey(3), F_IN, H, 2, bidirectional=bidirectional))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, B, F_IN))
    w = rng.standard_normal((T, B, H * (2 if bidirectional else 1)))

    def jloss(pp, xx):
        return jnp.sum(japply(pp, xx, H, bidirectional) * w)

    ref = np.asarray(japply(p, jnp.asarray(x), H, bidirectional))
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))

    tp = params_from_numpy(p, "cpu")
    leaves = jax.tree.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = papply(tp, tx, H, bidirectional)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-10, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), atol=1e-10, rtol=0)
    assert len(leaves) == len(jax.tree.leaves(jg_p)) == 4 * 2 * (2 if bidirectional else 1)
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(jg_p), leaves):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-10, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_init_tree_keys_shapes_and_bound(cell, bidirectional):
    jinit, _, pinit, _, gates = CELLS[cell]
    j = jinit(jax.random.PRNGKey(0), F_IN, H, 2, bidirectional=bidirectional)
    p = pinit(torch.Generator().manual_seed(4), F_IN, H, 2, bidirectional=bidirectional)
    jf, pf = flat_paths(j), flat_paths(p)
    assert {k: tuple(v.shape) for k, v in pf.items()} == {k: tuple(v.shape)
                                                          for k, v in jf.items()}
    assert pf["layers/0/fwd/weight_ih"].shape == (gates * H, F_IN)
    bound = 1.0 / math.sqrt(H)
    for k, v in pf.items():
        assert v.dtype == torch.float32 and float(v.abs().max()) <= bound, k
        assert float(v.abs().max()) > 0.8 * bound, k  # uniform over the whole range
    again = pinit(torch.Generator().manual_seed(4), F_IN, H, 2, bidirectional=bidirectional)
    other = pinit(torch.Generator().manual_seed(5), F_IN, H, 2, bidirectional=bidirectional)
    w = lambda t: t["layers"][1]["fwd"]["weight_hh"]  # noqa: E731
    assert torch.equal(w(again), w(p)) and not torch.equal(w(other), w(p))


def test_lstm_sequence_model_matches_jax_f64():
    kw = dict(input_size=F_IN, hidden_size=H, num_layers=2, sequence_model="LSTM",
              proj_size=5, use_pre_layer_norm=True, output_activate_function="tanh")
    jcfg = JS.SequenceModelConfig(**kw)
    params, state = JS.sequence_model_init(jax.random.PRNGKey(1), jcfg)
    p, s = _f64(params), _f64(state)
    p["pre_ln"]["weight"] = 1 + 0.2 * np.random.default_rng(2).standard_normal(F_IN)
    x = np.random.default_rng(3).standard_normal((B, F_IN, T))
    ref, ref_layers, _ = JS.sequence_model_apply(jcfg, p, s, jnp.asarray(x), train=True)
    out, layers, new_state = PS.sequence_model_apply(
        PS.SequenceModelConfig(**kw), params_from_numpy(p, "cpu"), params_from_numpy(s, "cpu"),
        torch.from_numpy(x), train=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-10, rtol=0)
    assert layers == [] and ref_layers == []
    assert new_state == {"stack": {}} and s == {"stack": {}}
    pp, _ = PS.sequence_model_init(torch.Generator().manual_seed(0), PS.SequenceModelConfig(**kw))
    assert {k: tuple(v.shape) for k, v in flat_paths(pp).items()} == {
        k: tuple(v.shape) for k, v in flat_paths(params).items()}
