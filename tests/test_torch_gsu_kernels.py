"""The port's GSU kernels (spiking_fullsubnet_torch/ops/gsu_kernels.py)
against the JAX package.

- plain kernel A in f64 against the JAX scan oracle (_stack_eval_scan_xg):
  spikes equal exactly;
- plain kernel A in f32 against the Pallas xg kernel in interpret mode:
  spike mismatch < 1e-3 (tests/test_stream_forward.py:89), shared and
  unshared weights, BN on and off, 3-D and 4-D, collect_all;
- plain kernel B in f32 against the Pallas sections kernel in interpret
  mode, in every mode (unit scales per utterance, per frame, per frame
  with the pre-LN terms, none; with the deep filter or the projection out):
  enhanced re/im or projections SNR > 60 dB (test_stream_forward.py:85);
- the port's GSU layer and spike against ops/gsu.py.
The CUDA kernels themselves are held against the plain versions on a card
by tests/test_torch_cuda_kernels.py.
Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spiking_fullsubnet_tpu.ops.gsu_pallas as gp
from spiking_fullsubnet_tpu.models.stream_forward import _stack_eval_scan_xg
from spiking_fullsubnet_tpu.ops.gsu import _gsu_layer_apply, gsu_stack_init
from spiking_fullsubnet_tpu.ops.gsu import spike as jax_spike

from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.ops.gsu import gsu_layer_eval, spike
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions step through time in thousands of small ops; one
    thread each keeps them fast when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret():
    old = gp._INTERPRET
    gp._INTERPRET = True
    yield
    gp._INTERPRET = old


def _stack(H, fin, shared, bn, L=2, seed=1, dtype=np.float32):
    """JAX stack params/state as numpy, BN randomized so the fold matters."""
    params, state = gsu_stack_init(jax.random.PRNGKey(seed), input_size=fin, hidden_size=H,
                                   num_layers=L, shared_weights=shared, bn=bn)
    rng = np.random.default_rng(seed + 10)
    p = jax.tree.map(lambda x: np.asarray(x, dtype), params)
    s = jax.tree.map(lambda x: np.asarray(x, dtype), state)
    if bn:
        for lp, ls in zip(p["layers"], s["layers"]):
            lp["bn"]["weight"] = (1 + 0.1 * rng.standard_normal(H)).astype(dtype)
            lp["bn"]["bias"] = (0.1 * rng.standard_normal(H)).astype(dtype)
            ls["bn"]["running_mean"] = (0.1 * rng.standard_normal(H)).astype(dtype)
            ls["bn"]["running_var"] = np.exp(0.1 * rng.standard_normal(H)).astype(dtype)
    return p, s


def _pack(p, s, H, io):
    tp, ts = params_from_numpy(p, device="cpu"), params_from_numpy(s, device="cpu")
    return gk.pack_stack(tp["layers"], ts["layers"], H, io)


def _lane_pad(x, H, shared):
    """[..., rows] -> the Pallas kernels' 128-lane gate layout."""
    hp = -(-H // 128) * 128
    out = np.zeros(x.shape[:-1] + ((hp if shared else 2 * hp),), x.dtype)
    if shared:
        out[..., :H] = x
    else:
        out[..., :H] = x[..., :H]
        out[..., hp:hp + H] = x[..., H:]
    return out


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("bn", [True, False])
def test_stack_plain_f64_matches_scan_exactly(shared, bn):
    T, B, H = 29, 5, 24
    p, s = _stack(H, H, shared, bn, L=3, dtype=np.float64)
    G = H if shared else 2 * H
    xg0 = np.random.default_rng(0).standard_normal((T, B, G))
    _, outs, _ = _stack_eval_scan_xg(p, s, jnp.asarray(xg0), H, shared)
    got = gk.stack_eval_plain(torch.from_numpy(xg0), *_pack(p, s, H, torch.float64),
                              H, shared, collect_all=True)
    assert got.shape == (3, T, B, H)
    for k in range(3):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(outs[k]))
    assert 0.05 < float(got.mean()) < 0.95  # spikes are neither dead nor saturated


@pytest.mark.parametrize("shared,bn", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("units,collect", [(False, False), (False, True), (True, False),
                                           (True, True)])
def test_stack_plain_f32_matches_pallas_interpret(interpret, shared, bn, units, collect):
    T, R, H, U = 24, 8, 32, 3
    p, s = _stack(H, H, shared, bn)
    G = H if shared else 2 * H
    shape = (U, T, R, G) if units else (T, R, G)
    xg0 = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref_out, ref_all, _ = gp.gsu_stack_eval_pallas_xg(
        p, s, jnp.asarray(_lane_pad(xg0, H, shared)), H, shared, collect_all=collect)
    got = gk.gsu_stack_eval(torch.from_numpy(xg0), *_pack(p, s, H, torch.float32),
                            H, shared, collect_all=collect)
    ref = np.stack([np.asarray(x) for x in ref_all]) if collect else np.asarray(ref_out)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.mean(got.numpy() != ref) < 1e-3


def _sections_case(shared, seed=0):
    """Tiny two-section layout: (n, ctr, df, a0, aw) per section."""
    H, Fa, Fb, T, B = 32, 40, 16, 20, 3
    geo = [(3, 4, 3, 0, 22), (2, 8, 1, 14, 26)]
    rng = np.random.default_rng(seed)
    G = H if shared else 2 * H
    U = sum(g[0] for g in geo)
    W = sum(g[0] * g[1] for g in geo)
    secs_np = []
    for i, (n, ctr, df, a0, aw) in enumerate(geo):
        p, s = _stack(H, H, shared, True, seed=3 + i)
        wa = np.zeros((n, Fa, G), np.float32)
        wa[:, a0:a0 + aw] = rng.standard_normal((n, aw, G)) * 0.3
        wb = (rng.standard_normal((n, Fb, G)) * 0.3).astype(np.float32)
        P = 2 * df * ctr
        wproj = (rng.standard_normal((P, H)) * 0.2).astype(np.float32)
        bproj = (rng.standard_normal(P) * 0.1).astype(np.float32)
        secs_np.append(dict(p=p, s=s, wa=wa, wb=wb, wproj=wproj, bproj=bproj,
                            n=n, ctr=ctr, df=df, a0=a0, aw=aw))
    xa = rng.random((T, B, Fa)).astype(np.float32)
    xb = rng.standard_normal((T, B, Fb)).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, (B, U)).astype(np.float32)
    spec_re = rng.standard_normal((T, B, W + 1)).astype(np.float32)
    spec_im = rng.standard_normal((T, B, W + 1)).astype(np.float32)
    return H, secs_np, xa, xb, alpha, spec_re, spec_im


def _port_secs(secs_np, H, shared, io):
    secs = []
    for sc in secs_np:
        wihr, whh, coef = _pack(sc["p"], sc["s"], H, io)
        secs.append({
            "wa": torch.from_numpy(sc["wa"][:, sc["a0"]:sc["a0"] + sc["aw"]].copy()).to(io),
            "a0": sc["a0"], "wb": torch.from_numpy(sc["wb"]).to(io),
            "wihr": wihr, "whh": whh, "coef": coef.float(),
            "wproj": torch.from_numpy(sc["wproj"].T.copy()).to(io),
            "bproj": torch.from_numpy(sc["bproj"]), "ctr": sc["ctr"], "df": sc["df"]})
    return secs


def _snr(a, b):
    return 10 * np.log10(np.sum(b ** 2) / max(np.sum((a - b) ** 2), 1e-30))


SECTION_MODES = ("off", "cum", "ln", "raw")


def _section_scales(mode, T, B, U, seed=9):
    """Kernel B's unit scales in ``mode``: the port's (alpha, beta) and the
    JAX kernel's [T, B, Up] streams (None for "raw")."""
    rng = np.random.default_rng(seed)
    if mode == "raw":
        return None, None, None, None
    alpha = rng.uniform(0.5, 1.5, (B, U) if mode == "off" else (T, B, U)).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, (T, B, U)).astype(np.float32) if mode == "ln" else None
    up = -(-U // 8) * 8
    al = np.zeros((T, B, up), np.float32)
    be = np.zeros((T, B, up), np.float32)
    al[:, :, :U] = alpha[None] if mode == "off" else alpha
    if beta is not None:
        be[:, :, :U] = beta
    return alpha, beta, al, be


@pytest.mark.parametrize("df_mode", [True, False], ids=["df", "proj"])
@pytest.mark.parametrize("mode", SECTION_MODES)
@pytest.mark.parametrize("shared", [True, False])
def test_sections_plain_f32_matches_pallas_interpret(interpret, shared, mode, df_mode):
    """Every mode of kernel B: per-utterance alpha ("off"), per-frame alpha
    ("cum"), per-frame alpha with the pre-LN terms ``alpha ck - beta u + v``
    ("ln"), no scaling ("raw"); with the deep filter (enhanced spectrum) or
    without (each section's projection ``[n, T, B, P]``)."""
    H, secs_np, xa, xb, _, sre, sim = _sections_case(shared)
    T, B, _ = xa.shape
    U = sum(sc["n"] for sc in secs_np)
    alpha, beta, al, be = _section_scales(mode, T, B, U)
    G = H if shared else 2 * H
    rng = np.random.default_rng(11)
    uv = [(rng.standard_normal((2, G)) * 0.3).astype(np.float32) if mode == "ln" else None
          for _ in secs_np]
    spans, f0 = [], 0
    for sc in secs_np:
        w = sc["n"] * sc["ctr"]
        spans.append((jnp.asarray(sre[:, :, f0:f0 + w]), jnp.asarray(sim[:, :, f0:f0 + w])))
        f0 += w
    ref = gp.gsu_sections_eval_pallas(
        [sc["p"] for sc in secs_np], [sc["s"] for sc in secs_np],
        [_lane_pad(sc["wa"], H, shared) for sc in secs_np],
        [_lane_pad(sc["wb"], H, shared) for sc in secs_np],
        [None if x is None else (_lane_pad(x[0], H, shared), _lane_pad(x[1], H, shared))
         for x in uv],
        [sc["wproj"] for sc in secs_np], [sc["bproj"] for sc in secs_np],
        jnp.asarray(xa), jnp.asarray(xb), None if al is None else jnp.asarray(al),
        None if be is None else jnp.asarray(be), H, shared,
        sec_spec=spans if df_mode else None,
        sec_geom=[(sc["ctr"], sc["df"]) for sc in secs_np])
    secs = _port_secs(secs_np, H, shared, torch.float32)
    for sec, x in zip(secs, uv):
        if x is not None:
            sec["uv"] = torch.from_numpy(x)
    opt = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    got = gk.gsu_sections_eval(
        secs, torch.from_numpy(xa), torch.from_numpy(xb), opt(alpha),
        torch.from_numpy(sre) if df_mode else None, torch.from_numpy(sim) if df_mode else None,
        H, shared, beta=opt(beta))
    if df_mode:
        ref_re = np.concatenate([np.asarray(r) for r, _ in ref], axis=-1)
        ref_im = np.concatenate([np.asarray(i) for _, i in ref], axis=-1)
        assert got[0].shape == ref_re.shape == (T, B, f0)
        assert _snr(got[0].numpy(), ref_re) > 60
        assert _snr(got[1].numpy(), ref_im) > 60
        return
    assert len(got) == len(secs_np)
    for g, r, sc in zip(got, ref, secs_np):
        P = 2 * sc["df"] * sc["ctr"]
        assert g.shape == (sc["n"], T, B, P) and g.dtype == torch.float32
        assert _snr(g.numpy(), np.asarray(r)[..., :P]) > 60


def test_sections_wrapper_rejects_mismatched_modes():
    """Kernel B's plain version (the wrapper's CPU path) refuses pre-LN terms
    without a per-frame alpha and beta, a beta without them, and an alpha of
    another shape, as the kernel's wrapper does."""
    H, secs_np, xa, xb, alpha, sre, sim = _sections_case(True, seed=2)
    T, B, _ = xa.shape
    U = alpha.shape[1]
    secs = _port_secs(secs_np, H, True, torch.float32)
    args = (torch.from_numpy(xa), torch.from_numpy(xb))
    spec = (torch.from_numpy(sre), torch.from_numpy(sim))
    a3 = torch.ones(T, B, U)
    with pytest.raises(ValueError, match="beta"):
        gk.gsu_sections_eval(secs, *args, a3, *spec, H, True, beta=torch.zeros(T, B, U))
    with pytest.raises(ValueError, match="alpha shape"):
        gk.gsu_sections_eval(secs, *args, torch.ones(B, U + 1), *spec, H, True)
    secs[0]["uv"] = torch.zeros(2, H)
    with pytest.raises(ValueError, match="beta"):
        gk.gsu_sections_eval(secs, *args, a3, *spec, H, True)
    with pytest.raises(ValueError, match="per-frame"):
        gk.gsu_sections_eval(secs, *args, torch.from_numpy(alpha), *spec, H, True,
                             beta=torch.zeros(T, B, U))


@pytest.mark.parametrize("shared", [True, False])
def test_gsu_layer_eval_matches_jax(shared):
    T, B, H, F = 17, 4, 16, 12
    p, s = _stack(H, F, shared, True, L=1, dtype=np.float64)
    x = np.random.default_rng(2).standard_normal((T, B, F))
    ref, _ = _gsu_layer_apply(p["layers"][0], s["layers"][0], jnp.asarray(x), H, shared,
                              train=False)
    tp, ts = params_from_numpy(p, device="cpu"), params_from_numpy(s, device="cpu")
    got = gsu_layer_eval(tp["layers"][0], ts["layers"][0], torch.from_numpy(x), H, shared)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_spike_forward_and_surrogate_match_jax():
    x = np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 0.3, 1.0, 1.5])
    g = np.linspace(0.5, 2.0, x.size)
    ref_y, vjp = jax.vjp(jax_spike, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = spike(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ref_y))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-15)
    assert y[3] == 1.0  # -0.0 >= 0 fires


def test_cpu_wrappers_take_the_plain_path_and_do_not_count():
    H, secs_np, xa, xb, alpha, sre, sim = _sections_case(True, seed=4)
    a0, b0 = gk.gsu_stack_eval.launches, gk.gsu_sections_eval.launches
    gk.gsu_sections_eval(_port_secs(secs_np, H, True, torch.float32), torch.from_numpy(xa),
                         torch.from_numpy(xb), torch.from_numpy(alpha), torch.from_numpy(sre),
                         torch.from_numpy(sim), H, True)
    p, s = _stack(H, H, True, False)
    gk.gsu_stack_eval(torch.zeros(3, 8, H), *_pack(p, s, H, torch.float32), H, True)
    assert (gk.gsu_stack_eval.launches, gk.gsu_sections_eval.launches) == (a0, b0)


def test_plain_spike_counts_match_the_spikes():
    """The plain versions' spike counts (chip_smoke's operation counts) equal
    the spikes they emit; B's equal its stack run through plain A on the
    same gates, which also holds B's stack to A's."""
    T, R, H = 21, 6, 24
    p, s = _stack(H, H, True, True, L=3, dtype=np.float64)
    xg0 = torch.from_numpy(np.random.default_rng(5).standard_normal((T, R, H)))
    w = _pack(p, s, H, torch.float64)
    counts = []
    spikes = gk.stack_eval_plain(xg0, *w, H, True, collect_all=True, spike_counts=counts)
    assert counts == [float(spikes[k].sum()) for k in range(3)]

    H, secs_np, xa, xb, alpha, sre, sim = _sections_case(True, seed=6)
    secs = _port_secs(secs_np, H, True, torch.float64)
    xa_t, xb_t = torch.from_numpy(xa).double(), torch.from_numpy(xb).double()
    counts = []
    gk.sections_eval_plain(secs, xa_t, xb_t, torch.from_numpy(alpha).double(),
                           torch.from_numpy(sre).double(), torch.from_numpy(sim).double(),
                           H, True, spike_counts=counts)
    assert len(counts) == len(secs)
    u0 = 0
    for sec, got in zip(secs, counts):
        n, aw, a0 = sec["wa"].shape[0], sec["wa"].shape[1], sec["a0"]
        ck = (torch.einsum("tbp,npg->ntbg", xa_t[..., a0:a0 + aw], sec["wa"])
              + torch.einsum("tbq,nqg->ntbg", xb_t, sec["wb"]))
        al = torch.from_numpy(alpha[:, u0:u0 + n].T.copy()).double()[:, None, :, None]
        spikes = gk.stack_eval_plain((al * ck).contiguous(), sec["wihr"], sec["whh"],
                                     sec["coef"], H, True, collect_all=True)
        assert got == [float(spikes[k].sum()) for k in range(spikes.shape[0])]
        assert min(got) > 0
        u0 += n
