"""The port's permutation-invariant training (losses/pit.py) against the
JAX package in float64.

- ``pairwise_neg_sisdr``, ``find_best_perm``, ``reorder_source`` and
  ``pit_wrapper`` for two and three sources, with and without the mean
  removed: values within 1e-10, permutations equal;
- a tie (two permutations of equal loss): both packages take the first in
  itertools order, as ``argmin`` does;
- the PIT loss's gradient against ``jax.grad`` within 1e-10.
Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.losses import pit as JP

from spiking_fullsubnet_torch.losses import (find_best_perm, pairwise_neg_sisdr, pit_wrapper,
                                             reorder_source)


def _pair(num_sources, seed):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((4, num_sources, 200))
    # estimates near a shuffled reference, so the best permutations differ by item
    est = np.stack([ref[b, rng.permutation(num_sources)] for b in range(4)])
    return est + 0.3 * rng.standard_normal(est.shape), ref


@pytest.mark.parametrize("zero_mean", [True, False])
@pytest.mark.parametrize("num_sources", [2, 3])
def test_pit_matches_jax_f64(num_sources, zero_mean):
    est, ref = _pair(num_sources, num_sources)
    jpw = np.asarray(JP.pairwise_neg_sisdr(jnp.asarray(est), jnp.asarray(ref), zero_mean=zero_mean))
    pw = pairwise_neg_sisdr(torch.from_numpy(est), torch.from_numpy(ref), zero_mean=zero_mean)
    assert pw.shape == (4, num_sources, num_sources)
    np.testing.assert_allclose(pw.numpy(), jpw, atol=1e-10, rtol=0)

    jmin, jidx = JP.find_best_perm(jnp.asarray(jpw))
    pmin, pidx = find_best_perm(torch.from_numpy(jpw.copy()))
    np.testing.assert_allclose(pmin.numpy(), np.asarray(jmin), atol=1e-10, rtol=0)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    assert len({tuple(r) for r in pidx.tolist()}) > 1  # the items take other permutations

    np.testing.assert_array_equal(reorder_source(torch.from_numpy(est), pidx).numpy(),
                                  np.asarray(JP.reorder_source(jnp.asarray(est), jidx)))
    jloss, jre = JP.pit_wrapper(JP.pairwise_neg_sisdr, jnp.asarray(est), jnp.asarray(ref),
                                zero_mean=zero_mean)
    loss, re = pit_wrapper(pairwise_neg_sisdr, torch.from_numpy(est), torch.from_numpy(ref),
                           zero_mean=zero_mean)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-10, rtol=0)
    np.testing.assert_array_equal(re.numpy(), np.asarray(jre))


@pytest.mark.parametrize("num_sources", [2, 3])
def test_tie_takes_the_first_permutation(num_sources):
    # every pair the same loss: every permutation ties
    pw = np.ones((2, num_sources, num_sources))
    pw[1, 0, 1] = pw[1, 1, 0] = 0.5  # item 1: the swap of sources 0 and 1 is best
    _, jidx = JP.find_best_perm(jnp.asarray(pw))
    loss, idx = find_best_perm(torch.from_numpy(pw))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0].tolist() == list(range(num_sources))
    assert idx[1].tolist()[:2] == [1, 0]


@pytest.mark.parametrize("num_sources", [2, 3])
def test_pit_loss_gradient_matches_jax_grad(num_sources):
    est, ref = _pair(num_sources, 10 + num_sources)
    jg = np.asarray(jax.grad(lambda e: JP.pit_wrapper(JP.pairwise_neg_sisdr, e,
                                                      jnp.asarray(ref))[0])(jnp.asarray(est)))
    e = torch.from_numpy(est).requires_grad_(True)
    pit_wrapper(pairwise_neg_sisdr, e, torch.from_numpy(ref))[0].backward()
    assert np.abs(jg).max() > 1e-3
    np.testing.assert_allclose(e.grad.numpy(), jg, atol=1e-10, rtol=0)
