"""The port's MetricGAN discriminator (``spiking_fullsubnet_torch/models/
discriminator.py``) against the JAX package's, on the CPU, in f64.

- on random weights (the JAX init) and on the in-repo
  ``model_zoo/intel_ndns/spike_fsb/baseline_{l,xl}_discriminator.npz``
  (read by the port's ``runtime/convert.load_npz``), in eval and in
  training: the score, and the spectral-norm ``u`` and ``v`` after one and
  after two passes (the second from the first's), within 1e-10;
- the gradients of a loss through two passes (as the discriminator step
  takes them) within 1e-10 of ``jax.grad``, ``u`` and ``v`` included (zero
  in training, where the power iteration runs without gradient);
- the port's init and ``build``: the JAX tree's keys, shapes and types,
  unit ``u`` and ``v``, weights inside their bounds.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models import discriminator as JD

from spiking_fullsubnet_torch.models import discriminator as PD
from spiking_fullsubnet_torch.runtime.convert import load_npz, params_from_numpy

ZOO = Path(__file__).resolve().parent.parent / "model_zoo" / "intel_ndns" / "spike_fsb"
B, FREQS, FRAMES = 2, 257, 40


def _weights(which):
    """JAX-tree weights as float64 numpy: the JAX init (ndf 8) or a zoo file."""
    if which == "random":
        tree = jax.tree.map(np.asarray, JD.discriminator_init(jax.random.PRNGKey(3), ndf=8))
    else:
        tree = jax.tree.map(lambda t: t.numpy(), load_npz(
            str(ZOO / f"baseline_{which}_discriminator.npz"), device="cpu"))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _mags(seed=0):
    rng = np.random.default_rng(seed)
    clean = np.abs(rng.standard_normal((B, FREQS, FRAMES)))
    return clean, clean + 0.3 * np.abs(rng.standard_normal((B, FREQS, FRAMES)))


def _np(tree):
    return [x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("which", ["random", "l", "xl"])
def test_discriminator_f64_matches_jax(which, train):
    w = _weights(which)
    clean, est = _mags()
    jp, pp = jax.tree.map(jnp.asarray, w), params_from_numpy(w, "cpu")
    japply = jax.jit(JD.discriminator_apply, static_argnames="train")
    for step in range(2):  # the second pass from the first's u and v
        js, jp = japply(jp, jnp.asarray(clean), jnp.asarray(est), train=train)
        ps, pp = PD.discriminator_apply(pp, torch.from_numpy(clean), torch.from_numpy(est),
                                        train=train)
        assert tuple(ps.shape) == (B, 1) and ps.dtype == torch.float64
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-10, rtol=0)
        for a, b in zip(_np(pp), _np(jp)):
            np.testing.assert_allclose(a, b, atol=1e-10, rtol=0)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(_np(pp), _np(w)))
    assert (moved > 1e-6) == train  # u and v move in training only
    assert 0.0 < float(ps.min()) and float(ps.max()) < 1.0


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("which", ["random", "xl"])
def test_discriminator_grads_f64_match_jax(which, train):
    w = _weights(which)
    clean, est = _mags(1)
    target = np.random.default_rng(2).uniform(size=(B, 1))

    def jloss(p):
        real, p2 = JD.discriminator_apply(p, clean, clean, train=train)
        fake, _ = JD.discriminator_apply(p2, clean, est, train=train)
        return jnp.mean((real - 1.0) ** 2) + jnp.mean((fake - target) ** 2)

    jg = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, w))
    pp = params_from_numpy(w, "cpu")
    leaves = jax.tree.leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    c, e = torch.from_numpy(clean), torch.from_numpy(est)
    real, p2 = PD.discriminator_apply(pp, c, c, train=train)
    fake, _ = PD.discriminator_apply(p2, c, e, train=train)
    ((real - 1.0).square().mean() + (fake - torch.from_numpy(target)).square().mean()).backward()
    for t, g in zip(leaves, jax.tree.leaves(jg)):
        got = np.zeros_like(np.asarray(g)) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), atol=1e-10, rtol=0)
    assert max(float(t.grad.abs().max()) for t in PD.discriminator_weights(pp)) > 1e-6


def test_init_and_build_match_the_jax_tree():
    jtree = jax.eval_shape(lambda: JD.discriminator_init(jax.random.PRNGKey(0), ndf=16))
    bundle = PD.build(seed=0, device="cpu")
    assert bundle["config"] == {"ndf": 16, "in_channel": 2} and bundle["state"] == {}
    assert bundle["apply"] is PD.discriminator_apply
    ptree = bundle["params"]
    assert jax.tree.structure(jax.tree.map(lambda x: 0, ptree)) == jax.tree.structure(
        jax.tree.map(lambda x: 0, jtree))
    for a, b in zip(jax.tree.leaves(ptree), jax.tree.leaves(jtree)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    for layer in PD.spectral_layers(ptree):
        for key in ("u", "v"):
            assert abs(float(torch.linalg.vector_norm(layer[key])) - 1.0) < 1e-6
        fan_in = layer["weight"][0].numel()
        assert float(layer["weight"].abs().max()) <= fan_in ** -0.5
    # the trainable tensors: every leaf but u and v
    n_uv = 2 * len(PD.spectral_layers(ptree))
    assert len(PD.discriminator_weights(ptree)) == len(jax.tree.leaves(ptree)) - n_uv
    assert not torch.equal(PD.build(seed=1, device="cpu")["params"]["fc1"]["weight"],
                           ptree["fc1"]["weight"])
    # the zoo files carry the same tree
    zoo = load_npz(str(ZOO / "baseline_l_discriminator.npz"), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, zoo)) == jax.tree.structure(
        jax.tree.map(lambda x: 0, jtree))
