"""Kernels D and E of the port's layered training step (their plain
versions, reached on the CPU) against the JAX package.

- plain kernel D (gsu_kernels.layer_train_fwd_plain) against the JAX Pallas
  kernel gsu_layer_pallas_train in interpret mode, f32: spikes exact, the
  per-step statistics and the new running statistics within rtol 1e-5 /
  atol 1e-6 (tests/test_gsu_pallas.py:69-71), over shared and unshared
  weights, BN on and off, R in {1, 5, 8} and T in {1, 17}; the affine (eval)
  mode against gsu_layer_pallas. One case goes to the JAX scan instead: with
  BN, R = 1 and T > 1 the Pallas kernel pads the batch to 8 rows, the seven
  padding rows are scaled by rsqrt(0 + eps) each step until they overflow,
  and their NaN reaches the real row through the masked sums (NaN * 0);
- the gradients of GSULayerTrain (kernel E's plain version) against jax.grad
  through gsu_layer_pallas_train in interpret mode (f32, atol 2e-3 max|g|,
  tests/test_gsu_pallas.py:92-95) and through the JAX scan in f64 (atol
  1e-9 max|g|: the same arithmetic, sums in another order), for xg,
  weight_hh, bias_ih and the BN affine; dx through the hoisted input
  projection (f32, atol 1e-4, tests/test_gsu_pallas.py:98-108);
- gsu_stack_apply(train=True) against the JAX scan in f64: every layer's
  spikes equal, the new BN state within rtol 1e-12, every gradient leaf and
  dx within 1e-9 max|g|;
- kernels D and E with bf16 streams (the stream-train path) against
  gsu_layer_pallas_train_padded with a bf16 xg_p in interpret mode: spikes
  equal, statistics within 1e-6, y to bf16 rounding, the gradients within
  a relative L2 of 1e-2 (the JAX kernel recomputes from its bf16 y; see the
  test).
Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spiking_fullsubnet_tpu.ops.gsu_pallas as gp
from spiking_fullsubnet_tpu.ops import gsu as JG

from spiking_fullsubnet_torch.ops import gsu as PG
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy

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


def _layer(shared, bn, R, T, seed, dtype=np.float32):
    """One layer's xg [T, R, rows], weight_hh [rows, H], bias_ih [2H] and
    (BN weight, bias) or (None, None), in torch layout."""
    G = H if shared else 2 * H
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((T, R, G)).astype(dtype)
    w = (rng.standard_normal((G, H)) / H ** 0.5).astype(dtype)
    b = (0.1 * rng.standard_normal(2 * H)).astype(dtype)
    if not bn:
        return xg, w, b, None, None
    return (xg, w, b, (1 + 0.1 * rng.standard_normal(H)).astype(dtype),
            (0.1 * rng.standard_normal(H)).astype(dtype))


def _kernel_args(xg, w, b, bw, bb):
    """The same layer in the kernel layout, as torch tensors."""
    bnp = (np.stack([bw, bb]) if bw is not None
           else np.stack([np.ones(H, xg.dtype), np.zeros(H, xg.dtype)]))
    return (torch.from_numpy(xg), torch.from_numpy(np.ascontiguousarray(w.T)),
            torch.from_numpy(b.reshape(2, H)), torch.from_numpy(bnp))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


def _weights(shape, seed):
    return np.cos(np.arange(np.prod(shape)).reshape(shape) * 0.01 + seed)


def _close_by_max(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref,
                               atol=rel * (1e-30 + np.abs(ref).max()), rtol=0, err_msg=what)


# ------------------------------------------------------------------ kernel D


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("R", [1, 5, 8])
@pytest.mark.parametrize("T", [1, 17])
def test_plain_d_matches_pallas_interpret(shared, bn, R, T, monkeypatch):
    monkeypatch.setattr(gp, "_INTERPRET", True)
    xg, w, b, bw, bb = _layer(shared, bn, R, T, seed=100 * R + T)
    spikes, y, stats = gk.layer_train_fwd_plain(*_kernel_args(xg, w, b, bw, bb), H, shared,
                                                "bn" if bn else "none")
    assert spikes.shape == y.shape == (T, R, H) and stats.shape == (T, 2, H)
    np.testing.assert_array_equal(spikes.numpy(), (y >= 0).float().numpy())
    running = {"running_mean": np.full(H, 0.1, np.float32),
               "running_var": np.full(H, 0.9, np.float32)}
    if bn and R == 1 and T > 1:  # see the module docstring: the JAX scan
        ref, ref_state = JG._gsu_layer_apply(
            {"weight_ih": None, "weight_hh": w, "bias_ih": b, "bn": {"weight": bw, "bias": bb}},
            {"bn": running},
            None, H, shared, train=True, precomputed_xg=jnp.asarray(xg))
        np.testing.assert_array_equal(spikes.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(stats[:, 1].numpy(), 0.0)
        ref_running = ref_state["bn"]
    else:
        ref, ref_stats = gp.gsu_layer_pallas_train(_j(xg), _j(w), _j(b), H, shared, _j(bw),
                                                   _j(bb))
        np.testing.assert_array_equal(spikes.numpy(), np.asarray(ref))
        if not bn:
            assert ref_stats is None
            return
        for k in range(2):
            np.testing.assert_allclose(stats[:, k].numpy(), np.asarray(ref_stats[k]),
                                       rtol=1e-5, atol=1e-6)
        ref_running = JG.bn_running_update(running, *ref_stats, R)
    if bn:
        got = PG.bn_running_update({k: torch.from_numpy(v) for k, v in running.items()},
                                   stats[:, 0], stats[:, 1], R)
        for k in running:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref_running[k]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shared", [True, False])
def test_plain_d_affine_matches_pallas_interpret(shared, monkeypatch):
    """Kernel D's eval mode (the folded affine of gsu_layer_pallas)."""
    monkeypatch.setattr(gp, "_INTERPRET", True)
    xg, w, b, scale, shift = _layer(shared, True, 6, 19, seed=3)
    ref = gp.gsu_layer_pallas(_j(xg), _j(w), _j(b), H, shared, _j(scale), _j(shift))
    spikes, y, stats = gk.layer_train_fwd_plain(*_kernel_args(xg, w, b, scale, shift), H, shared,
                                                "affine")
    np.testing.assert_array_equal(spikes.numpy(), np.asarray(ref))
    assert 0.05 < float(spikes.mean()) < 0.95 and not stats.any()


# ------------------------------------------------------------------ kernel E


def _layer_loss_jax(fn, shared, T, R):
    wv = _weights((T, R, H), 0.0)

    def loss(xg, w, b, bw, bb):
        spikes = fn(xg, w, b, bw, bb)
        return jnp.sum(jnp.sin(spikes * 1.7) * wv)
    return loss


def _layer_grads_port(xg, w, b, bw, bb, shared):
    leaves = [_t(a, True) for a in (xg, w, b, bw, bb)]
    spikes, stats = PG.GSULayerTrain.apply(*leaves, H, shared)
    assert not stats.requires_grad
    wv = torch.from_numpy(_weights(spikes.shape, 0.0)).to(spikes.dtype)
    (torch.sin(spikes * 1.7) * wv).sum().backward()
    return [None if t is None else t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("shared,bn,R", [(True, True, 5), (False, True, 8), (True, False, 5)])
def test_layer_grads_match_pallas_interpret_f32(shared, bn, R, monkeypatch):
    monkeypatch.setattr(gp, "_INTERPRET", True)
    T = 17
    args = _layer(shared, bn, R, T, seed=7 + R)

    def fwd(xg, w, b, bw, bb):
        return gp.gsu_layer_pallas_train(xg, w, b, H, shared, bw, bb)[0]

    n = 5 if bn else 3
    ref = jax.grad(_layer_loss_jax(fwd, shared, T, R), argnums=tuple(range(n)))(
        *[_j(a) for a in args])
    got = _layer_grads_port(*args, shared)
    for name, g, r in zip(("xg", "weight_hh", "bias_ih", "bn weight", "bn bias"), got, ref):
        _close_by_max(g, r, 2e-3, name)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("R", [1, 6])
def test_layer_grads_match_jax_scan_f64(shared, bn, R):
    T = 19
    args = _layer(shared, bn, R, T, seed=11 + R, dtype=np.float64)

    def fwd(xg, w, b, bw, bb):
        p = {"weight_ih": None, "weight_hh": w, "bias_ih": b}  # xg given: weight_ih unread
        s = {}
        if bw is not None:
            p["bn"] = {"weight": bw, "bias": bb}
            s["bn"] = {"running_mean": jnp.zeros(H), "running_var": jnp.ones(H)}
        return JG._gsu_layer_apply(p, s, None, H, shared, train=True, precomputed_xg=xg)[0]

    n = 5 if bn else 3
    ref = jax.grad(_layer_loss_jax(fwd, shared, T, R), argnums=tuple(range(n)))(
        *[_j(a) for a in args])
    got = _layer_grads_port(*args, shared)
    for name, g, r in zip(("xg", "weight_hh", "bias_ih", "bn weight", "bn bias"), got, ref):
        _close_by_max(g, r, 1e-9, name)


def _stack(Fin, shared, bn, L, seed, dtype):
    params, state = JG.gsu_stack_init(jax.random.PRNGKey(seed), input_size=Fin, hidden_size=H,
                                      num_layers=L, shared_weights=shared, bn=bn)
    p, s = _np(params, dtype), _np(state, dtype)
    rng = np.random.default_rng(seed + 10)
    for lp, ls in zip(p["layers"], s["layers"]):
        if bn:
            lp["bn"]["weight"] = (1 + 0.1 * rng.standard_normal(H)).astype(dtype)
            lp["bn"]["bias"] = (0.1 * rng.standard_normal(H)).astype(dtype)
            ls["bn"]["running_mean"] = (0.1 * rng.standard_normal(H)).astype(dtype)
    return p, s


def test_stack_dx_through_hoisted_matmul_matches_pallas_interpret(monkeypatch):
    monkeypatch.setattr(gp, "_INTERPRET", True)
    T, B, Fin = 13, 5, 20
    p, s = _stack(Fin, True, True, 2, seed=5, dtype=np.float32)
    x = np.random.default_rng(2).standard_normal((T, B, Fin)).astype(np.float32)
    ref = jax.grad(lambda xx: jnp.sum(jnp.tanh(
        gp.gsu_stack_apply_pallas(p, s, xx, H, True, True)[0])))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = PG.gsu_stack_apply(params_from_numpy(p, "cpu"), params_from_numpy(s, "cpu"), tx, H,
                             True, train=True)[0]
    torch.tanh(out).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref), atol=1e-4)


def _grads_of(tree):
    return [t.grad.numpy() for t in jax.tree.leaves(tree)]


def _trainable(tree):
    tp = params_from_numpy(tree, "cpu")
    for t in jax.tree.leaves(tp):
        t.requires_grad_(True)
    return tp


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("bn", [True, False])
def test_gsu_stack_apply_train_matches_jax_scan_f64(shared, bn):
    T, B, Fin = 21, 5, 13
    p, s = _stack(Fin, shared, bn, 2, seed=6, dtype=np.float64)
    x = np.random.default_rng(4).standard_normal((T, B, Fin))
    wv = _weights((T, B, H), 1.0)

    def loss(pp, xx):
        o, alo, ns = JG.gsu_stack_apply(pp, s, xx, H, shared, train=True, backend="scan")
        return jnp.sum(jnp.sin(o * 1.7) * wv), (alo, ns)

    (_, (ref_alo, ref_state)), (g_p, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    tp, tx = _trainable(p), torch.from_numpy(x).requires_grad_(True)
    out, alo, state = PG.gsu_stack_apply(tp, params_from_numpy(s, "cpu"), tx, H, shared,
                                         train=True)
    (torch.sin(out * 1.7) * torch.from_numpy(wv)).sum().backward()
    assert len(alo) == len(ref_alo) == 3
    for a, r in zip(alo[1:], ref_alo[1:]):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(r))
    assert jax.tree.structure(_np(ref_state)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), state))
    for a, r in zip(jax.tree.leaves(state), jax.tree.leaves(ref_state)):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-12)
    for g, r in zip(_grads_of(tp), jax.tree.leaves(g_p)):
        _close_by_max(g, r, 1e-9)
    _close_by_max(tx.grad.numpy(), g_x, 1e-9, "dx")


# ------------------------------------------------------------------ bf16 streams


def _bf16(a):
    """Values rounded to bfloat16 (by JAX), as float32 numpy."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _pad_lanes(a, H, shared, hp=128):
    """[T, R, rows] -> the JAX stream-train layout [T, R, G] (G = hp shared,
    else 2 hp), each half at its lane offset, zeros elsewhere."""
    T, R, _ = a.shape
    out = np.zeros((T, R, hp if shared else 2 * hp), a.dtype)
    out[..., :H] = a[..., :H]
    if not shared:
        out[..., hp:hp + H] = a[..., H:]
    return out


@pytest.mark.parametrize("shared,bn", [(True, True), (False, True), (True, False)])
def test_plain_de_bf16_streams_match_pallas_padded_interpret(shared, bn, monkeypatch):
    """Kernels D and E with bf16 streams (the stream-train path) against
    gsu_layer_pallas_train_padded with a bf16 xg_p in interpret mode, R = 16,
    T = 48 (two time blocks of 24 there), H = 24 (lanes padded to 128 on the
    JAX side only). D: spikes equal, statistics within 1e-6, the JAX kernel's
    bf16 y equal to the port's float32 y rounded to bf16. E (and the dW
    kernel): the JAX kernel saves y in bf16 and recomputes each step of a
    time block from it (only the block's first step from float32), the port
    keeps y float32, so the surrogate, the gates and BN's xhat see y rounded
    differently; dxg, dW, db and dgamma/dbeta within a relative L2 of 1e-2
    (measured: at most 3.1e-3; fed y rounded to bf16, the port's dxg comes
    within 2e-4 to 1.4e-3 of the JAX kernel's)."""
    monkeypatch.setattr(gp, "_INTERPRET", True)
    R, T = 16, 48
    xg, w, b, bw, bb = _layer(shared, bn, R, T, seed=21 + 2 * shared + bn)
    xg = _bf16(xg)
    gout = _bf16(np.random.default_rng(3).standard_normal((T, R, H)))
    bnargs = (_j(bw), _j(bb)) if bn else (None, None)

    def fwd(xg_p, w_, b_, bw_, bb_):
        return gp.gsu_layer_pallas_train_padded(xg_p, w_, b_, H, shared, bw_, bb_)

    xg_p = jnp.asarray(_pad_lanes(xg, H, shared)).astype(jnp.bfloat16)
    (ref_spikes, ref_stats), vjp = jax.vjp(fwd, xg_p, _j(w), _j(b), *bnargs)
    assert ref_spikes.dtype == jnp.bfloat16
    zero_stats = None if not bn else tuple(jnp.zeros_like(s) for s in ref_stats)
    g_pad = jnp.asarray(_pad_lanes(gout, H, True)).astype(jnp.bfloat16)
    ref_g = vjp((g_pad, zero_stats))
    # the kernel's saved y, through the same plan
    cfg = gp._make_cfg(T, R, H, shared, bn=bn, affine=False, train=True, save_res=True,
                       io="bfloat16")
    cfg = gp._make_cfg(T, R, H, shared, bn=bn, affine=False, train=True, save_res=True,
                       io="bfloat16", t_blk=gp._divisor_at_most(T, cfg.t_blk))
    assert cfg.n_t == 2
    _, ref_y, _, _ = gp._run_fwd(cfg, xg_p, gp._pack_w(_j(w), H, cfg.hp, cfg.g, shared),
                                 gp._pack_b2(_j(b), H, cfg.hp),
                                 gp._pack_pair(*bnargs, H, cfg.hp), save_res=True)

    leaves = [torch.from_numpy(xg).to(torch.bfloat16).requires_grad_(True)] + [
        _t(a, True) for a in (w, b, bw, bb)]
    spikes, stats = PG.GSULayerTrain.apply(*leaves, H, shared)
    assert spikes.dtype == torch.bfloat16 and stats.dtype == torch.float32
    np.testing.assert_array_equal(spikes.detach().float().numpy(),
                                  np.asarray(ref_spikes[..., :H].astype(jnp.float32)))
    # the port's y: kernel D's plain version on the same arguments
    kx, kw, kb2, kbnp = _kernel_args(xg, w, b, bw, bb)
    _, y, _ = gk.layer_train_fwd_plain(kx.to(torch.bfloat16), kw.to(torch.bfloat16), kb2, kbnp,
                                       H, shared, "bn" if bn else "none")
    assert y.dtype == torch.float32
    # the JAX y is the port's y rounded to bf16: equal, but for the few
    # membranes within a float32 rounding (1e-6 near 0, where c' - mean
    # cancels) of a bf16 midpoint, which round the other way
    ref_y = np.asarray(ref_y[..., :H].astype(jnp.float32))
    y = y.numpy()
    assert np.mean(_bf16(y) != ref_y) < 1e-3
    half_ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(y), 1e-30))) - 8)
    assert (np.abs(ref_y - y) <= half_ulp * (1 + 1e-4) + 1e-6).all()
    if bn:
        for k in range(2):
            np.testing.assert_allclose(stats[:, k].numpy(), np.asarray(ref_stats[k]),
                                       rtol=1e-6, atol=1e-6)
    spikes.backward(torch.from_numpy(gout).to(torch.bfloat16))
    assert leaves[0].grad.dtype == torch.bfloat16
    dxg_ref = np.asarray(ref_g[0].astype(jnp.float32))
    dxg_ref = (dxg_ref[..., :H] if shared
               else np.concatenate([dxg_ref[..., :H], dxg_ref[..., 128:128 + H]], -1))
    rels = {"dxg": _rel_l2(leaves[0].grad.float().numpy(), dxg_ref)}
    for name, t, r in zip(("dW", "db", "dgamma", "dbeta"), leaves[1:], ref_g[1:]):
        if t is not None:
            rels[name] = _rel_l2(t.grad.numpy(), r)
    assert max(rels.values()) < 1e-2, rels
