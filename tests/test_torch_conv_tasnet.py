"""The port's Conv-TasNet (models/conv_tasnet.py) against the JAX package.

- the tiny recipe's configuration (recipes/wsj0-mix/conv_tasnet/
  tiny_synthetic.toml) and ``conv_tasnet_base`` (the recipe's
  default.toml, ``base = true``) on 0.25 s at 8 kHz in float64, from the
  JAX weights: the separated sources within 1e-9, the tiny one at a length
  the stride divides and at one that needs padding, the base one (the JAX
  side takes about 6 s an utterance on the CPU) on one padded utterance;
- ``build``: the JAX tree's keys and shapes, each convolution's values
  within its bound, the PReLU scalars and norms as JAX sets them, a seed
  that fixes the draw; its apply returns the JAX bundle's keys.
Inputs are made with numpy from a seed.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models import conv_tasnet as JT

from spiking_fullsubnet_torch.models import conv_tasnet as PT
from spiking_fullsubnet_torch.runtime.config import toml_load
from spiking_fullsubnet_torch.runtime.convert import flat_paths, params_from_numpy

RECIPE = Path(__file__).resolve().parent.parent / "recipes" / "wsj0-mix" / "conv_tasnet"
TINY = toml_load(RECIPE / "tiny_synthetic.toml")["model"]["args"]
BASE = toml_load(RECIPE / "default.toml")["model"]["args"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("args,batch,n_samples", [(TINY, 2, 2000), (TINY, 2, 2003),
                                                   (BASE, 1, 2003)],
                         ids=["tiny-stride_multiple", "tiny-padded", "base-padded"])
def test_conv_tasnet_matches_jax_f64(args, batch, n_samples):
    jb = JT.build(seed=1, **args)
    p = jax.tree.map(lambda x: np.asarray(x, np.float64), jb["params"])
    rng = np.random.default_rng(7)
    # PReLU slopes and norm affines off their init values, so that each matters
    for blk in p["blocks"]:
        blk["prelu1"] = rng.uniform(0.05, 0.5, 1)
        blk["norm2"]["weight"] = 1 + 0.2 * rng.standard_normal(blk["norm2"]["weight"].shape)
        blk["norm2"]["bias"] = 0.1 * rng.standard_normal(blk["norm2"]["bias"].shape)
    x = rng.standard_normal((batch, n_samples)) * 0.1
    ref = np.asarray(jb["apply"](jb["config"], p, {}, jnp.asarray(x))["enhanced_y"])
    pb = PT.build(seed=1, device="cpu", **args)
    assert pb["config"].__dict__ == jb["config"].__dict__
    out = pb["apply"](pb["config"], params_from_numpy(p, "cpu"), {}, torch.from_numpy(x))
    assert sorted(out) == ["all_layer_outputs", "enhanced_y", "state"]
    assert out["all_layer_outputs"] == [] and out["state"] == {}
    y = out["enhanced_y"].numpy()
    assert y.shape == ref.shape == (batch, 2, n_samples)
    np.testing.assert_allclose(y, ref, atol=1e-9, rtol=0)
    assert np.abs(ref).max() > 1e-3


@pytest.mark.parametrize("args", [TINY, BASE], ids=["tiny", "base"])
def test_build_tree_and_bounds(args):
    jb = JT.build(seed=0, **args)
    pb = PT.build(seed=3, device="cpu", **args)
    cfg = pb["config"]
    jf, pf = flat_paths(jb["params"]), flat_paths(pb["params"])
    assert {k: tuple(v.shape) for k, v in pf.items()} == {k: tuple(v.shape) for k, v in jf.items()}
    assert "res_out" not in pb["params"]["blocks"][-1] and "res_out" in pb["params"]["blocks"][-2]
    fan_in = {"encoder": cfg.enc_kernel_size, "input_conv": cfg.enc_num_feats,
              "conv1": cfg.msk_num_feats, "dconv": cfg.msk_kernel_size,
              "skip_out": cfg.msk_num_hidden_feats, "res_out": cfg.msk_num_hidden_feats,
              "output_conv": cfg.msk_num_feats, "decoder": cfg.enc_kernel_size}
    for k, v in pf.items():
        assert v.dtype == torch.float32, k
        parts = k.split("/")
        if "prelu" in k:
            assert torch.equal(v, torch.full((1,), 0.25)), k
        elif "norm" in k:
            assert torch.equal(v, torch.ones_like(v) if parts[-1] == "weight"
                               else torch.zeros_like(v)), k
        else:
            conv = parts[-2]
            bound = 1.0 / math.sqrt(fan_in[conv])
            assert float(v.abs().max()) <= bound, k
            assert float(v.abs().max()) > 0.5 * bound, k
    again = PT.build(seed=3, device="cpu", **args)["params"]
    other = PT.build(seed=4, device="cpu", **args)["params"]
    w = lambda t: t["blocks"][1]["dconv"]["weight"]  # noqa: E731
    assert torch.equal(w(again), w(pb["params"])) and not torch.equal(w(other), w(pb["params"]))
