"""The port's FullSubNet and what it stands on against the JAX package, in
float64: the feature norms (dsp/feature_norm.py), the cIRM helpers and
drop-band (dsp/mask.py), the per-bin unfold (ops/freq_unfold.py), the RNN
sequence model (models/rnn_sequence_model.py) and FullSubNet
(models/fullsubnet.py).

- the four norms the port lacked: within 1e-12 (the forgetting
  recurrence summed in another order than JAX's associative scan), frames
  0-3 (frame 0's factor is -1) and the switch at ``sample_length`` among
  them; ``norm_wrapper`` takes every name JAX's takes;
- the cIRM helpers and their gradients within 1e-12, ``decompress_cirm``
  on its clip bounds too; ``drop_band`` at B = 3 and 2 groups, F = 257
  (cut to 256): exact;
- ``freq_unfold_per_bin`` at 0, 3 and 15 neighbours: exact;
- the GRU and LSTM sequence models, one and both directions, with an
  output activation: outputs and the gradients of a weighted sum within
  1e-10;
- FullSubNet at its published widths (DNS-Interspeech-2020's train.toml:
  257 bins, look-ahead 2, LSTM, fb 512 with ReLU and no neighbours, sb 384
  with 15 neighbours, the offline laplace norm, drop-band in 2 groups) on
  3 x 12 frames, eval and training (drop-band), within 1e-10; ``build``'s
  tree against JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.dsp import feature_norm as JN
from spiking_fullsubnet_tpu.dsp import mask as JM
from spiking_fullsubnet_tpu.models import fullsubnet as JF
from spiking_fullsubnet_tpu.models import rnn_sequence_model as JR
from spiking_fullsubnet_tpu.ops.freq_unfold import freq_unfold_per_bin as jax_unfold_per_bin

from spiking_fullsubnet_torch.dsp import feature_norm as PN
from spiking_fullsubnet_torch.dsp import mask as PM
from spiking_fullsubnet_torch.models import fullsubnet as PF
from spiking_fullsubnet_torch.models import rnn_sequence_model as PR
from spiking_fullsubnet_torch.ops.freq_unfold import freq_unfold_per_bin
from spiking_fullsubnet_torch.runtime.convert import flat_paths, params_from_numpy

PUBLISHED = dict(num_freqs=257, look_ahead=2, sequence_model="LSTM", fb_num_neighbors=0,
                 sb_num_neighbors=15, fb_output_activate_function="ReLU",
                 sb_output_activate_function=False, fb_model_hidden_size=512,
                 sb_model_hidden_size=384, norm_type="offline_laplace_norm",
                 num_groups_in_drop_band=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.mark.parametrize("name", ["offline_gaussian_norm", "cumulative_layer_norm",
                                  "forgetting_norm", "hybrid_norm"])
def test_norms_match_jax(name):
    rng = np.random.default_rng(0)
    x = np.abs(rng.standard_normal((2, 1, 7, 30))) + 0.1
    kw = {"sample_length": 12} if name in ("forgetting_norm", "hybrid_norm") else {}
    if name == "hybrid_norm":
        x = x[:, 0]  # [B, F, T]
    got = getattr(PN, name)(torch.from_numpy(x), **kw).numpy()
    ref = np.asarray(getattr(JN, name)(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
    if name in ("forgetting_norm", "hybrid_norm"):
        # frames 0-3 by hand: alpha_0 = -1, so mu_0 = 2 m_0
        m = x.reshape(2, -1, 30).mean(axis=1)
        mu, expect = 0.0, []
        for t in range(4):
            a = min((t - 1) / (t + 1), 11 / 13)
            mu = a * mu + (1 - a) * m[:, t]
            expect.append(mu)
        np.testing.assert_allclose(x.reshape(2, -1, 30)[:, :, :4] / got.reshape(2, -1, 30)[:, :, :4],
                                   np.stack(expect, -1)[:, None, :].repeat(x[0].size // 30, 1),
                                   rtol=1e-9)
    if name == "hybrid_norm":  # the cumulative mean from sample_length on
        cum = np.cumsum(x.sum(1), -1) / (7 * np.arange(1, 31))
        np.testing.assert_allclose(x[..., 12:] / got[..., 12:],
                                   np.broadcast_to(cum[:, None, 12:], x[..., 12:].shape),
                                   rtol=1e-9)
    if name != "hybrid_norm":
        assert PN.norm_wrapper(name) is getattr(PN, name)
    assert sorted(PN._NORMS) == sorted(JN._NORMS)


def test_cirm_helpers_and_gradients_match_jax():
    rng = np.random.default_rng(1)
    nr, ni, cr, ci = (rng.standard_normal((2, 5, 9)) for _ in range(4))
    got = PM.build_complex_ideal_ratio_mask(*map(torch.from_numpy, (nr, ni, cr, ci)))
    ref = JM.build_complex_ideal_ratio_mask(*map(jnp.asarray, (nr, ni, cr, ci)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    m = np.concatenate([rng.standard_normal(20) * 12, [9.9, -9.9, 150.0, -150.0]])
    for fn in ("compress_cirm", "decompress_cirm"):
        w = rng.standard_normal(m.shape)
        tm = torch.from_numpy(m).requires_grad_(True)
        out = getattr(PM, fn)(tm)
        (out * torch.from_numpy(w)).sum().backward()
        ref = getattr(JM, fn)(jnp.asarray(m))
        g = jax.grad(lambda v: jnp.sum(getattr(JM, fn)(v) * w))(jnp.asarray(m))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-12, rtol=0)
        np.testing.assert_allclose(tm.grad.numpy(), np.asarray(g), atol=1e-12, rtol=1e-12)
    r, i = PM.complex_mul(*map(torch.from_numpy, (nr, ni, cr, ci)))
    jr, ji = JM.complex_mul(nr, ni, cr, ci)
    np.testing.assert_allclose(r.numpy(), jr, atol=1e-15)
    np.testing.assert_allclose(i.numpy(), ji, atol=1e-15)
    assert PM.EPSILON == JM.EPSILON


def test_drop_band_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 4, 257, 5))
    got = PM.drop_band(torch.from_numpy(x), num_groups=2).numpy()
    ref = np.asarray(JM.drop_band(jnp.asarray(x), num_groups=2))
    assert got.shape == (3, 4, 128, 5)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[2], x[1, :, 1:256:2])  # row 1 is group 1's, bins 1, 3, ...
    assert PM.drop_band(torch.from_numpy(x), num_groups=1) is not None
    with pytest.raises(ValueError, match="must exceed"):
        PM.drop_band(torch.from_numpy(x[:2]), num_groups=2)


@pytest.mark.parametrize("n", [0, 3, 15])
def test_freq_unfold_per_bin_matches_jax(n):
    x = np.random.default_rng(3).standard_normal((2, 1, 40, 6))
    got = freq_unfold_per_bin(torch.from_numpy(x), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_unfold_per_bin(jnp.asarray(x), n)))
    assert got.shape == (2, 40, 1, 2 * n + 1, 6)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_rnn_sequence_model_and_gradients_match_jax(cell, bidirectional):
    kw = dict(input_size=9, output_size=5, hidden_size=7, num_layers=2,
              bidirectional=bidirectional, sequence_model=cell, output_activate_function="Tanh")
    jcfg, pcfg = JR.RnnSequenceModelConfig(**kw), PR.RnnSequenceModelConfig(**kw)
    params = _f64(JR.rnn_sequence_model_init(jax.random.PRNGKey(4), jcfg))
    pinit = PR.rnn_sequence_model_init(torch.Generator().manual_seed(4), pcfg)
    assert {k: tuple(v.shape) for k, v in flat_paths(pinit).items()} == \
        {k: tuple(v.shape) for k, v in flat_paths(params).items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 9, 11))
    w = rng.standard_normal((3, 5, 11))
    ref = JR.rnn_sequence_model_apply(jcfg, params, jnp.asarray(x))
    g = jax.grad(lambda p: jnp.sum(JR.rnn_sequence_model_apply(jcfg, p, jnp.asarray(x)) * w))(
        params)
    tp = params_from_numpy(params, "cpu")
    for t in jax.tree.leaves(tp):
        t.requires_grad_(True)
    out = PR.rnn_sequence_model_apply(pcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-10, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    for (path, r), t in zip(jax.tree_util.tree_leaves_with_path(g), jax.tree.leaves(tp)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-10, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_drop_band"])
def test_fullsubnet_at_published_widths_matches_jax_f64(train):
    jb = JF.build(seed=0, **PUBLISHED)
    b = PF.build(seed=0, device="cpu", **PUBLISHED)
    assert b["config"].__dict__ == jb["config"].__dict__ and b["state"] == {}
    assert {k: tuple(v.shape) for k, v in flat_paths(b["params"]).items()} == \
        {k: tuple(v.shape) for k, v in flat_paths(jb["params"]).items()}
    params = _f64(jb["params"])
    x = np.abs(np.random.default_rng(6).standard_normal((3, 1, 257, 12)))
    ref = jax.jit(lambda p, m: jb["apply"](jb["config"], p, {}, m, train)["cirm"])(
        params, jnp.asarray(x))
    out = b["apply"](b["config"], params_from_numpy(params, "cpu"), {}, torch.from_numpy(x),
                     train)["cirm"]
    assert out.shape == ((3, 2, 128, 12) if train else (3, 2, 257, 12))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-10, rtol=0)
