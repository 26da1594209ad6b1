"""The band group's exchange of kernels D and E in band mode (the peer and
group routes, ``ops/gsu_kernels``, ``parallel/mesh.py``), on the CPU.

- the route from fabricated topologies (``mesh.band_route``): ranks on
  cards of their own of one host, each pair with peer access, take "peer";
  ranks that share a card, a group across hosts, a pair of cards without
  peer access and a rank that does not see a peer's card take "staged";
- the exchange's buffer (``exchange_layout``): flags, signatures, receive
  slots and the error record in order, aligned and apart, at the sizes the
  kernels index (``csrc/gsu_train_mma.cuh``), and what it refuses;
- the sequence counter: over a section's layers, forward then backward,
  each rank's launches take the same first numbers, D 2T and E T apart,
  and every rank's launch arguments agree but for their rows;
- the plans: every rank of a group gets the same launch signature whatever
  its real rows, and ranks whose plans differ (rows, widths, stream type,
  weights), or whose T or BN count differ, get different signatures (the
  kernel fails a launch whose peers' signatures differ: error code 2);
- the group form on CPU tensors (the plain band versions of G ranks in
  lockstep) for G = 2 and 4, one of them with a rank of only pad rows
  (pad rows' gates nonzero, their spikes' gradient zero, as the gather
  leaves them), against the JAX package's unsharded train layer (``_gsu_layer_apply``
  with ``precomputed_xg``, ``jax.vjp`` for the backward) on the union of
  the real rows in float64: spikes exact; y (the JAX layer's traced
  membranes), dxg of the real rows, and dW, db and the BN affine's gradient
  summed over the ranks within 1e-12; the running statistics from the
  group's stats within 1e-12 of JAX's; every rank's stats equal.
Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spiking_fullsubnet_tpu.nn.module_tracer as jax_tracer
from spiking_fullsubnet_tpu.ops import gsu as JG

from spiking_fullsubnet_torch.ops import gsu as PG
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.parallel import mesh

A, B, C, D = "GPU-a", "GPU-b", "GPU-c", "GPU-d"


def _rank(host, uuid, reach):
    """One rank's ``card_info``: its card reaches the cards ``reach`` (and
    itself); cards it does not see are absent."""
    return {"host": host, "uuid": uuid, "access": dict({u: True for u in reach}, **{uuid: True})}


TOPOLOGIES = {
    "two cards with peer access": ([_rank("h", A, [B]), _rank("h", B, [A])], "peer"),
    "four cards all to all": ([_rank("h", u, [A, B, C, D]) for u in (A, B, C, D)], "peer"),
    "two ranks on one card": ([_rank("h", A, []), _rank("h", A, [])], "staged"),
    "two pairs on two cards": ([_rank("h", u, [A, B]) for u in (A, A, B, B)], "staged"),
    "a second host": ([_rank("h", A, [B]), _rank("h2", B, [A])], "staged"),
    "a pair without peer access": ([_rank("h", A, [B, C]), _rank("h", B, [A]),
                                    _rank("h", C, [A])], "staged"),
    "a rank that does not see a peer's card": ([
        _rank("h", A, [B]), {"host": "h", "uuid": B, "access": {B: True}}], "staged"),
}


@pytest.mark.parametrize("case", list(TOPOLOGIES))
def test_band_route_from_the_topology(case):
    infos, want = TOPOLOGIES[case]
    route, why = mesh.band_route(infos)
    assert route == want and route in mesh.BAND_ROUTES and why, (case, route, why)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_exchange_layout(G):
    lay = gk.exchange_layout(G)
    regions = [("flags", G * gk.BAND_MAX_BLK * 8), ("sig", 2 * G * gk.BAND_MAX_BLK * 4),
               ("recv", 2 * G * 2 * gk.BAND_MAX_H * 4), ("err", 8 * 4)]
    assert lay["flags"] == 0 and lay["sig"] == regions[0][1]
    for (name, size), (nxt, _) in zip(regions, regions[1:]):
        assert lay[name] + size <= lay[nxt], (name, nxt)
    assert lay["recv"] % 16 == 0 and lay["flags"] % 8 == 0  # 16-byte pushes, u64 flags
    assert lay["err"] + 32 <= lay["bytes"] and lay["bytes"] % 256 == 0
    # a block's slice of a slot: units J0 .. J0 + J of 16-unit blocks stay 16-byte aligned
    assert (lay["recv"] + 4 * gk.BAND_MAX_H) % 16 == 0


@pytest.mark.parametrize("G", [0, gk.BAND_MAX_G + 1])
def test_exchange_layout_refuses_group_sizes(G):
    with pytest.raises(ValueError):
        gk.exchange_layout(G)


def _exchanges(G):
    """Each rank's view of a group's exchange (fabricated addresses)."""
    lay = gk.exchange_layout(G)
    bases = [4096 * (g + 1) for g in range(G)]
    return [gk.BandExchange(G, r, bases, bases[r] + lay["err"]) for r in range(G)]


@pytest.mark.parametrize("G", [2, 4])
def test_sequence_counter_agrees_across_ranks(G):
    """A section of three layers at T = 7, then its backward in reverse:
    every rank's launch takes the same first sequence number, D's 2T after
    the one before and E's T; the arguments differ only in the rank's rows."""
    T, H, R = 7, 32, 16
    ranks = _exchanges(G)
    plan = {k: gk.train_plan(R, H, True, torch.float32, k) for k in ("fwd", "bwd")}
    rows_real = [R - 3 * g for g in range(G)]
    seqs = []
    for kernel in ["fwd"] * 3 + ["bwd"] * 3:
        args = [ex.launch_args(kernel, plan[kernel], T, {ex.rank: rows_real[ex.rank]}, 60)
                for ex in ranks]
        assert len({a.seq0 for a in args}) == 1 and len({a.sig for a in args}) == 1
        for ex, a in zip(ranks, args):
            assert a.G == G and a.rank == ex.rank and a.rows_global == 60
            assert a.rows_real[ex.rank] == rows_real[ex.rank] and a.err == ex.err
            assert [a.base[g] for g in range(G)] == ex.bases
        seqs.append(args[0].seq0)
    steps = [b - a for a, b in zip(seqs, seqs[1:])]
    assert seqs[0] == 1 and steps == [2 * T] * 3 + [T] * 2
    assert all(ex.seq == 1 + 3 * 2 * T + 3 * T for ex in ranks)
    assert gk.band_exchanges("fwd", T) == 2 * T and gk.band_exchanges("bwd", T) == T


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_every_rank_gets_the_same_plan(kernel):
    """Ranks of 24, 16 and 0 real rows of 24: one plan, and one signature in
    each rank's launch arguments."""
    R, H, T = 24, 224, 9
    plan = gk.train_plan(R, H, True, torch.float32, kernel)
    ranks = _exchanges(3)
    args = [ex.launch_args(kernel, plan, T, {ex.rank: r}, 40)
            for ex, r in zip(ranks, (24, 16, 0))]
    assert len({a.sig for a in args}) == 1
    assert args[0].sig == gk.band_signature(kernel, plan, T, 40)
    assert [a.rows_real[a.rank] for a in args] == [24, 16, 0]


@pytest.mark.parametrize("other", [dict(R=32), dict(H=160), dict(io=torch.bfloat16),
                                   dict(shared=False), dict(T=8), dict(rows_global=41)],
                         ids=["rows", "units", "stream type", "weights", "frames", "bn count"])
def test_plan_check_rejects_ranks_whose_plans_differ(other):
    """The signature that each block sends beside its sums differs between
    ranks whose launches are laid out differently."""
    base = dict(R=24, H=224, shared=True, io=torch.float32, T=9, rows_global=40)
    sigs = []
    for kw in (base, dict(base, **other)):
        plan = gk.train_plan(kw["R"], kw["H"], kw["shared"], kw["io"], "fwd")
        sigs.append(gk.band_signature("fwd", plan, kw["T"], kw["rows_global"]))
    assert sigs[0] != sigs[1]


class _Event:
    """A stand-in for the CUDA event behind a posted record."""

    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited, self.done = True, True


def test_exchange_record_is_read_without_waiting():
    """``poll`` reads the record's copy only once its event has passed and
    never waits; ``check`` waits; a failure once seen raises at every later
    poll, naming the rank, block, step and pass the kernel recorded."""
    ex = _exchanges(2)[0]
    ex.poll()  # nothing posted yet
    ex._rec = torch.tensor([1, 1, 3, 5, 0, 0, 0, 0], dtype=torch.int32)
    ev = _Event(False)
    ex._posted = (ev, "kernel D band (layer 2)")
    ex.poll()  # the copy has not landed: no wait, no error
    assert not ev.waited and ex.failed is None
    with pytest.raises(RuntimeError, match=r"kernel D band \(layer 2\): band exchange failed: "
                       r"rank 1, block 3, step 5, pass 0 waited past"):
        ex.check()
    assert ev.waited
    with pytest.raises(RuntimeError, match="unusable"):
        ex.poll()
    clean = _exchanges(2)[1]
    clean._rec = torch.zeros(8, dtype=torch.int32)
    clean._posted = (_Event(True), "kernel E band")
    clean.poll()
    assert clean.failed is None and clean._posted is None


# ---------------------------------------------------------------- the group form on the CPU

H_CPU, T_CPU = 16, 10


def _layer(shared, total, seed):
    G = H_CPU if shared else 2 * H_CPU
    rng = np.random.default_rng(seed)
    return {"xg": rng.standard_normal((T_CPU, total, G)) * 0.8,
            "whh": rng.standard_normal((H_CPU, G)) / np.sqrt(H_CPU),
            "bias": rng.standard_normal(2 * H_CPU) * 0.1,
            "bn_w": 1 + 0.1 * rng.standard_normal(H_CPU), "bn_b": 0.1 * rng.standard_normal(H_CPU),
            "rm": 0.1 * rng.standard_normal(H_CPU), "rv": rng.uniform(0.5, 1.5, H_CPU),
            "gout": rng.standard_normal((T_CPU, total, H_CPU)) * 0.1}


def _jax_layer(a, shared):
    """The JAX package's unsharded train layer on all rows: (spikes, its
    traced membranes y, new running state) and the vjp of the spikes at
    ``gout`` for xg, W_hh^T, the bias and the BN affine."""
    def params(whh_t, bias, bn_w, bn_b):
        return {"weight_ih": None, "weight_hh": whh_t, "bias_ih": bias,
                "bn": {"weight": bn_w, "bias": bn_b}}

    state = {"bn": {"running_mean": jnp.asarray(a["rm"]), "running_var": jnp.asarray(a["rv"])}}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    membranes = []
    orig = (JG._tracing, jax_tracer.trace_activation)
    JG._tracing = lambda: True
    jax_tracer.trace_activation = lambda name, x: membranes.append(np.asarray(x)) or x
    try:
        spikes, new_state = JG._gsu_layer_apply(
            params(j["whh"].T, j["bias"], j["bn_w"], j["bn_b"]), state, None, H_CPU, shared,
            train=True, precomputed_xg=j["xg"])
    finally:
        JG._tracing, jax_tracer.trace_activation = orig

    def fwd(xg, whh_t, bias, bn_w, bn_b):
        return JG._gsu_layer_apply(params(whh_t, bias, bn_w, bn_b), state, None, H_CPU, shared,
                                   train=True, precomputed_xg=xg)[0]

    _, vjp = jax.vjp(fwd, j["xg"], j["whh"].T, j["bias"], j["bn_w"], j["bn_b"])
    grads = vjp(j["gout"])
    return (np.asarray(spikes), membranes[0], jax.tree.map(np.asarray, new_state),
            [np.asarray(g) for g in grads])


SPLITS = {2: (7, 5), 4: (6, 5, 4, 0)}  # each rank's real rows; the last of G = 4 only pads


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "unshared"])
@pytest.mark.parametrize("G", [2, 4])
def test_group_form_on_the_cpu_matches_the_jax_layer_f64(G, shared):
    split = SPLITS[G]
    total, rows = sum(split), max(split)
    a = _layer(shared, total, seed=20 + G)
    spikes, y, new_state, (g_xg, g_whh_t, g_bias, g_bw, g_bb) = _jax_layer(a, shared)
    starts = np.cumsum([0] + list(split))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}

    def pad(x, k, fill=0.3):  # rank k's rows: its real rows, then pad rows
        part = x[:, starts[k]:starts[k + 1]]
        return torch.cat([part, part.new_full((T_CPU, rows - part.shape[1], x.shape[2]), fill)],
                         dim=1).contiguous()

    b2 = t["bias"].reshape(2, H_CPU)
    bnp = torch.stack([t["bn_w"], t["bn_b"]])
    xgs = [pad(t["xg"], k) for k in range(G)]
    before = gk.gsu_layer_train_fwd_band_group.launches
    fwd = gk.gsu_layer_train_fwd_band_group(xgs, t["whh"], b2, bnp, H_CPU, shared, split, total)
    bwd = gk.gsu_layer_train_bwd_band_group(xgs, [f[1] for f in fwd],
                                            [pad(t["gout"], k, 0.0) for k in range(G)],
                                            [f[2] for f in fwd], t["whh"], b2, bnp, H_CPU,
                                            shared, split, total)
    assert gk.gsu_layer_train_fwd_band_group.launches == before  # the plain versions launch none
    for k, ((sk, yk, stk), (dk, *_)) in enumerate(zip(fwd, bwd)):
        real, r = slice(starts[k], starts[k + 1]), split[k]
        np.testing.assert_array_equal(sk[:, :r].numpy(), spikes[:, real])
        np.testing.assert_allclose(yk[:, :r].numpy(), y[:, real], rtol=0, atol=1e-12)
        np.testing.assert_allclose(dk[:, :r].numpy(), g_xg[:, real], rtol=0, atol=1e-12)
        assert torch.equal(stk, fwd[0][2]) and bool(torch.isfinite(yk).all())
        assert bool((dk[:, r:] == 0).all())  # a pad row's gradient: none reaches it
    state = PG.bn_running_update({"running_mean": t["rm"], "running_var": t["rv"]},
                                 fwd[0][2][:, 0], fwd[0][2][:, 1], total)
    for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(state[key].numpy(), new_state["bn"][key], rtol=0, atol=1e-12)
    dw, db, dbn = (sum(b[i] for b in bwd) for i in (1, 2, 3))
    np.testing.assert_allclose(dw.T.numpy(), g_whh_t, rtol=0, atol=1e-12)
    np.testing.assert_allclose(db.reshape(-1).numpy(), g_bias, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dbn.numpy(), np.stack([g_bw, g_bb]), rtol=0, atol=1e-12)


def test_group_form_checks_its_ranks():
    x = torch.zeros(3, 4, H_CPU, dtype=torch.float64)
    w = torch.zeros(H_CPU, H_CPU, dtype=torch.float64)
    b = torch.zeros(2, H_CPU, dtype=torch.float64)
    with pytest.raises(ValueError):
        gk.gsu_layer_train_fwd_band_group([x, x], w, b, b, H_CPU, True, [4], 4)
