"""The port's cIRM-GSN and cIRM-LSTM (models/cirm_models.py) against the
JAX package.

- tiny widths in f64, shared and unshared weights, one and two speakers:
  enhanced audio atol 3e-6 (tests/test_stream_forward.py:53), the
  magnitude atol 1e-9 and every collected layer (spikes exact);
- the recipe's widths (recipes/intel_ndns/cirm_gsn/default.toml: input
  257, 2 x 256 GSU with pre-LN, BN and shared weights, deep filter of
  order 3) in f64 from JAX weights, 1 x 0.5 s: the same tolerances;
- the init trees against the JAX package's: cIRM-GSN's, and cIRM-LSTM's
  (recipes/wsj0-mix/cirm_lstm/default.toml; its forward is held to JAX's
  in tests/test_torch_separation.py).
Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models import cirm_models as JC

from spiking_fullsubnet_torch.models import cirm_models as PC
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy

RECIPE = dict(n_fft=512, hop_length=128, win_length=512, fdrc=0.5, input_size=257,
              hidden_size=256, num_layers=2, proj_size=257, output_activate_function=False,
              df_order=3, use_pre_layer_norm_fb=True, bn=True, shared_weights=True,
              sequence_model="GSN", num_spks=1)
TINY = dict(RECIPE, n_fft=64, hop_length=16, win_length=64, input_size=33, hidden_size=24,
            proj_size=33)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree, dtype):
    return jax.tree.map(lambda x: np.asarray(x, dtype), tree)


def _jax_model(kw, seed=0):
    """JAX config, params and state as f64 numpy, BN and pre-LN randomized
    so that their folds matter."""
    b = JC.build(seed=seed, **kw)
    p, s = _np(b["params"], np.float64), _np(b["state"], np.float64)
    rng = np.random.default_rng(seed + 1)
    ln = p["fb"]["pre_ln"]
    ln["weight"] = 1 + 0.2 * rng.standard_normal(ln["weight"].shape)
    ln["bias"] = 0.2 * rng.standard_normal(ln["bias"].shape)
    for ls in s["fb"]["stack"]["layers"]:
        h = ls["bn"]["running_mean"].shape
        ls["bn"]["running_mean"] = 0.1 * rng.standard_normal(h)
        ls["bn"]["running_var"] = np.exp(0.1 * rng.standard_normal(h))
    return b["config"], p, s


def _matches_jax(kw, n_samples, seed=0):
    jcfg, p, s = _jax_model(kw, seed)
    pcfg = PC.CirmModelConfig(**{k: v for k, v in jcfg.__dict__.items()})
    noisy = np.random.default_rng(seed + 2).standard_normal((2, n_samples)) * 0.1
    ref = JC.cirm_model_apply(jcfg, p, s, jnp.asarray(noisy))
    before = gk.gsu_stack_eval_x.launches
    out = PC.cirm_model_apply(pcfg, params_from_numpy(p, "cpu"), params_from_numpy(s, "cpu"),
                              torch.from_numpy(noisy))
    assert gk.gsu_stack_eval_x.launches == before  # CPU tensors take the plain version
    assert out["enhanced_y"].shape == ref["enhanced_y"].shape
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6)
    assert ("enhanced_mag" in out) == ("enhanced_mag" in ref)
    if "enhanced_mag" in ref:
        np.testing.assert_allclose(out["enhanced_mag"].numpy(), np.asarray(ref["enhanced_mag"]),
                                   atol=1e-9)
    assert len(out["all_layer_outputs"]) == len(ref["all_layer_outputs"]) == 4
    for g, r in zip(out["all_layer_outputs"], ref["all_layer_outputs"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-9)
    for k in (1, 2):
        np.testing.assert_array_equal(out["all_layer_outputs"][k].numpy(),
                                      np.asarray(ref["all_layer_outputs"][k]))
    assert np.abs(out["enhanced_y"].numpy()[..., :n_samples] - (
        noisy if jcfg.num_spks == 1 else noisy[:, None])).max() > 1e-3


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("num_spks", [1, 2])
def test_tiny_cirm_gsn_f64_matches_jax(shared, num_spks):
    _matches_jax(dict(TINY, shared_weights=shared, num_spks=num_spks), 3000)


def test_recipe_widths_cirm_gsn_f64_matches_jax():
    _matches_jax(RECIPE, 8000, seed=3)


def test_init_tree_and_lstm_raises():
    """cIRM-GSN's init tree and, where the LSTM variant raised before it was
    ported, cIRM-LSTM's: the JAX package's keys and shapes."""
    b = PC.build(seed=4, device="cpu", **RECIPE)
    jb = JC.build(seed=0, **RECIPE)
    assert b["config"].__dict__ == jb["config"].__dict__

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v for k, x in tree.items() for k2, v in shapes(x, f"{prefix}{k}/").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v for i, x in enumerate(tree)
                    for k2, v in shapes(x, f"{prefix}{i}/").items()}
        return {prefix: tuple(tree.shape)}

    assert shapes({"p": b["params"], "s": b["state"]}) == shapes({"p": jb["params"],
                                                                   "s": jb["state"]})
    assert b["params"]["fb"]["proj"]["weight"].shape == (257 * 3 * 2, 256)
    lstm = dict(RECIPE, sequence_model="LSTM", bn=False, shared_weights=False, num_spks=2,
                pad_to_hop=True, n_fft=256, hop_length=64, win_length=256, input_size=129,
                proj_size=129)
    lb, jlb = PC.build(seed=4, device="cpu", **lstm), JC.build(seed=0, **lstm)
    assert lb["config"].__dict__ == jlb["config"].__dict__
    assert shapes({"p": lb["params"], "s": lb["state"]}) == shapes({"p": jlb["params"],
                                                                     "s": jlb["state"]})
    assert lb["params"]["fb"]["stack"]["layers"][1]["fwd"]["weight_hh"].shape == (4 * 256, 256)
    assert lb["params"]["fb"]["proj"]["weight"].shape == (129 * 2 * 3 * 2, 256)
    assert lb["state"] == {"fb": {"stack": {}}}
