"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip without an NVIDIA GPU. This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

At these small shapes no near-threshold spike flips occur, so A's and F's
spikes must match exactly (mismatch < 1e-3 allows one stray flip), B's
enhanced spectrum and C's enhanced audio to f32 rounding (relative L2 <
1e-4; C in bf16 < 2e-3, see C_TOL). Kernel D's spikes likewise (one stray
flip allowed), its membranes and batch statistics within rtol 1e-5 up to
the first flip; kernel E and its weight-gradient kernel, fed the same
saved tensors as their plain versions (so no spike can flip), within a
relative L2 error of 1e-5.
"""

from __future__ import annotations

import pytest
import torch

from spiking_fullsubnet_torch.ops import gsu_kernels as gk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layers(H, shared, L, g, fin=None, bn=True):
    """Torch-layout stack weights and BN state, layer 0 over ``fin`` inputs."""
    G = H if shared else 2 * H
    layers, states = [], []
    for k in range(L):
        n_in = fin if (k == 0 and fin) else H
        layers.append({
            "weight_ih": torch.randn(G, n_in, generator=g) / n_in ** 0.5,
            "weight_hh": torch.randn(G, H, generator=g) / H ** 0.5,
            "bias_ih": torch.randn(2 * H, generator=g) * 0.1})
        states.append({})
        if bn:
            layers[-1]["bn"] = {"weight": 1 + 0.1 * torch.randn(H, generator=g),
                                "bias": 0.1 * torch.randn(H, generator=g)}
            states[-1]["bn"] = {"running_mean": 0.1 * torch.randn(H, generator=g),
                                "running_var": torch.rand(H, generator=g) + 0.5}
    return layers, states


def _stack(H, shared, L, io, dev, g):
    G = H if shared else 2 * H
    layers, states = [], []
    for _ in range(L):
        layers.append({
            "weight_ih": torch.randn(G, H, generator=g) / H ** 0.5,
            "weight_hh": torch.randn(G, H, generator=g) / H ** 0.5,
            "bias_ih": torch.randn(2 * H, generator=g) * 0.1,
            "bn": {"weight": 1 + 0.1 * torch.randn(H, generator=g),
                   "bias": 0.1 * torch.randn(H, generator=g)}})
        states.append({"bn": {"running_mean": 0.1 * torch.randn(H, generator=g),
                              "running_var": torch.rand(H, generator=g) + 0.5}})
    wihr, whh, coef = gk.pack_stack(layers, states, H, io)
    return wihr.to(dev), whh.to(dev), coef.float().to(dev)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("units", [False, True])
@pytest.mark.parametrize("collect", [False, True])
def test_stack_kernel_matches_plain(dev, io, shared, L, units, collect):
    g = torch.Generator().manual_seed(L)
    H = 40
    w = _stack(H, shared, L, io, dev, g)
    G = H if shared else 2 * H
    shape = (3, 50, 9, G) if units else (50, 13, G)
    x = torch.randn(shape, generator=g).to(io).to(dev)
    before = gk.gsu_stack_eval.launches
    got = gk.gsu_stack_eval(x, *w, H, shared, collect_all=collect)
    ref = gk.stack_eval_plain(x, *w, H, shared, collect_all=collect)
    torch.cuda.synchronize()
    assert gk.gsu_stack_eval.launches == before + 1
    assert got.shape == ref.shape and got.dtype == io
    assert (got != ref).float().mean().item() < 1e-3
    assert 0.05 < got.float().mean().item() < 0.95


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("L,T,R,Fin,H", [(1, 5, 13, 37, 40), (2, 50, 21, 64, 320),
                                         (2, 40, 17, 158, 224), (3, 30, 9, 257, 256),
                                         (4, 20, 8, 3, 512)])
def test_stack_x_kernel_matches_plain(dev, io, shared, bn, L, T, R, Fin, H):
    """Kernel F over its grid of options: the widths of the layered zoo-M
    stacks (fullband 64 -> 320, section 158 -> 224) and of cIRM-GSN (257 ->
    256), ragged row tiles, T < 8, L up to 4 and H up to 512."""
    g = torch.Generator().manual_seed(L * 100 + Fin)
    layers, states = _layers(H, shared, L, g, fin=Fin, bn=bn)
    w = [t.to(dev) for t in gk.pack_stack_x(layers, states, H, io)]
    x = torch.rand(T, R, Fin, generator=g).to(io).to(dev)
    before = gk.gsu_stack_eval_x.launches
    got = gk.gsu_stack_eval_x(x, *w, H, shared)
    ref = gk.stack_eval_x_plain(x, *w, H, shared)
    torch.cuda.synchronize()
    assert gk.gsu_stack_eval_x.launches == before + 1
    assert got.shape == ref.shape == (L, T, R, H) and got.dtype == io
    assert (got != ref).float().mean().item() < 1e-3
    assert 0.05 < got.float().mean().item() < 0.95


def test_stack_x_kernel_rows_are_independent(dev):
    """A row's spikes do not depend on its tile: the first rows alone give
    the same spikes as inside the whole batch."""
    g = torch.Generator().manual_seed(3)
    layers, states = _layers(224, True, 2, g, fin=38)
    w = [t.to(dev) for t in gk.pack_stack_x(layers, states, 224, torch.bfloat16)]
    x = torch.rand(60, 37, 38, generator=g).to(torch.bfloat16).to(dev)
    whole = gk.gsu_stack_eval_x(x, *w, 224, True)
    part = gk.gsu_stack_eval_x(x[:, :11].contiguous(), *w, 224, True)
    torch.cuda.synchronize()
    assert torch.equal(part, whole[:, :, :11])


def test_stack_x_wrapper_rejects_what_the_kernel_does_not_take(dev):
    g = torch.Generator().manual_seed(0)
    layers, states = _layers(16, True, 2, g, fin=12)
    w = [t.to(dev) for t in gk.pack_stack_x(layers, states, 16, torch.float32)]
    x = torch.randn(10, 8, 12, generator=g).to(dev)
    with pytest.raises(ValueError, match="dtype"):
        gk.gsu_stack_eval_x(x.double(), *w, 16, True)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gsu_stack_eval_x(x.transpose(0, 1), *w, 16, True)
    with pytest.raises(ValueError, match="shape"):
        gk.gsu_stack_eval_x(torch.randn(10, 8, 13, device=dev), *w, 16, True)
    with pytest.raises(ValueError, match="dtype"):
        gk.gsu_stack_eval_x(x.to(torch.bfloat16), *w, 16, True)  # f32 weights


def _sections(shared, io, dev, g, H=48):
    G = H if shared else 2 * H
    secs = []
    for n, ctr, df, a0, aw in [(3, 4, 3, 0, 22), (2, 8, 1, 14, 26), (2, 16, 2, 30, 33)]:
        wihr, whh, coef = _stack(H, shared, 2, io, dev, g)
        P = 2 * df * ctr
        secs.append({
            "wa": (torch.randn(n, aw, G, generator=g) * 0.3).to(io).to(dev), "a0": a0,
            "wb": (torch.randn(n, 16, G, generator=g) * 0.3).to(io).to(dev),
            "wihr": wihr, "whh": whh, "coef": coef,
            "wproj": (torch.randn(H, P, generator=g) * 0.2).to(io).to(dev),
            "bproj": (torch.randn(P, generator=g) * 0.1).to(dev), "ctr": ctr, "df": df})
    return secs


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
def test_sections_kernel_matches_plain(dev, io, shared):
    g = torch.Generator().manual_seed(7)
    H, T, B = 48, 40, 11
    secs = _sections(shared, io, dev, g, H)
    U = sum(s["wa"].shape[0] for s in secs)
    W = sum(s["wa"].shape[0] * s["ctr"] for s in secs)
    args = (torch.rand(T, B, 64, generator=g).to(io).to(dev),
            torch.randn(T, B, 16, generator=g).to(io).to(dev),
            (torch.rand(B, U, generator=g) + 0.5).to(dev),
            torch.randn(T, B, W + 1, generator=g).to(dev),
            torch.randn(T, B, W + 1, generator=g).to(dev))
    before = gk.gsu_sections_eval.launches
    got = gk.gsu_sections_eval(secs, *args, H, shared)
    ref = gk.sections_eval_plain(secs, *args, H, shared)
    torch.cuda.synchronize()
    assert gk.gsu_sections_eval.launches == before + 1
    num = sum((a - b).square().sum() for a, b in zip(got, ref))
    den = sum(b.square().sum() for b in ref)
    assert (num / den).sqrt().item() < 1e-4


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    g = torch.Generator().manual_seed(0)
    w = _stack(16, True, 2, torch.float32, dev, g)
    x = torch.randn(10, 8, 16, generator=g).to(dev)
    with pytest.raises(ValueError, match="dtype"):
        gk.gsu_stack_eval(x.double(), *w, 16, True)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gsu_stack_eval(x.transpose(0, 1), *w, 16, True)
    with pytest.raises(ValueError, match="shape"):
        gk.gsu_stack_eval(torch.randn(10, 8, 32, device=dev), *w, 16, True)
    with pytest.raises(ValueError, match="dtype"):
        gk.gsu_stack_eval(x.to(torch.bfloat16), *w, 16, True)  # f32 weights


def _mono(norm, shared, L, Lf, io, dev, g, S, H=40, Hf=48):
    """A small random kernel-C spec: n_fft 64 (hop 16), three sections
    (n, ctr, df, a0, aw) covering the 32 bins, fullband input 8, projection 8."""
    n_fft, Fin, Pfb = 64, 8, 8
    F = n_fft // 2
    G, Gf = (H, Hf) if shared else (2 * H, 2 * Hf)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    secs = []
    for n, ctr, df, a0, aw in [(3, 2, 3, 0, 7), (2, 4, 1, 3, 12), (2, 9, 2, 12, 20)]:
        wihr, whh, coef = _stack(H, shared, L, io, dev, g)
        P = 2 * df * ctr
        secs.append({
            "wa": (rn(n, aw, G) * 0.3).to(io).to(dev), "a0": a0,
            "wb": (rn(n, Pfb, G) * 0.3).to(io).to(dev), "uv": (rn(2, G) * 0.1).to(dev),
            "wihr": wihr, "whh": whh, "coef": coef,
            "wproj": (rn(H, P) * 0.2).to(io).to(dev), "bproj": (rn(P) * 0.1).to(dev),
            "ctr": ctr, "df": df})
    wihr, whh, coef = _stack(Hf, shared, Lf, io, dev, g)
    fb = {"wa": (rn(Fin, Gf) * 0.3).to(io).to(dev), "uv": (rn(2, Gf) * 0.1).to(dev),
          "wihr": wihr, "whh": whh, "coef": coef, "wproj": (rn(Hf, Pfb) * 0.2).to(io).to(dev),
          "bproj": (rn(Pfb) * 0.1).to(dev), "hidden": Hf}
    wdft, widft = gk.monolith_dft_matrices(n_fft, io, dev)
    return {"norm": norm, "n_fft": n_fft, "hop": n_fft // 4, "eps": 2.2e-16,
            "t_real": max(S - 3, 1), "wdft": wdft, "widft": widft,
            "sel_mag": (torch.rand(F, 8, generator=g) / F).to(dev),
            "sel_fb": (torch.rand(Pfb, 8, generator=g) / Pfb).to(dev),
            "fb": fb, "secs": secs, "hidden": H, "shared": shared}


def _rel_l2(got, ref):
    return ((got.double() - ref.double()).norm() / ref.double().norm()).item()


# bf16 streams are rounded inside (magnitude, fullband output, enhanced
# spectrum): where the kernel's and the plain version's f32 sums, taken in
# other orders, straddle a bf16 rounding boundary, the two round one bf16
# step (2^-8) apart, hence the looser bound.
C_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("norm", ["ln", "cum", "raw"])
@pytest.mark.parametrize("L", [1, 2, 3])
def test_monolith_kernel_matches_plain(dev, io, shared, norm, L):
    g = torch.Generator().manual_seed(11 * L)
    S, B = 40, 11  # two row tiles, the second ragged
    mono = _mono(norm, shared, L, 1 + L % 3, io, dev, g, S)
    chunks = (torch.randn(S + 3, B, 16, generator=g) * 0.1).to(io).to(dev)
    before = gk.sfsb_monolith_serve.launches
    got = gk.sfsb_monolith_serve(mono, chunks)
    ref = gk.monolith_serve_plain(mono, chunks)
    torch.cuda.synchronize()
    assert gk.sfsb_monolith_serve.launches == before + 1
    assert got.shape == ref.shape == (S, B, 16) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel_l2(got, ref) < C_TOL[io]


@pytest.mark.parametrize("S", [1, 2])
def test_monolith_kernel_short_sequences(dev, S):
    """T < df: the deep filter's older taps read no frame yet."""
    g = torch.Generator().manual_seed(S)
    mono = _mono("cum", True, 2, 2, torch.float32, dev, g, S)
    chunks = (torch.randn(S + 3, 3, 16, generator=g) * 0.1).to(dev)
    got = gk.sfsb_monolith_serve(mono, chunks)
    ref = gk.monolith_serve_plain(mono, chunks)
    torch.cuda.synchronize()
    assert _rel_l2(got, ref) < 1e-4


def test_monolith_wrapper_rejects_what_the_kernel_does_not_take(dev):
    g = torch.Generator().manual_seed(0)
    mono = _mono("ln", True, 2, 2, torch.float32, dev, g, 8)
    chunks = torch.randn(11, 4, 16, generator=g).to(dev)
    with pytest.raises(ValueError, match="dtype"):
        gk.sfsb_monolith_serve(mono, chunks.double())
    with pytest.raises(ValueError, match="dtype"):
        gk.sfsb_monolith_serve(mono, chunks.to(torch.bfloat16))  # f32 weights
    with pytest.raises(ValueError, match="contiguous"):
        gk.sfsb_monolith_serve(mono, chunks.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="n_fft"):
        gk.sfsb_monolith_serve(mono, torch.randn(11, 4, 8, device=dev))


# ------------------------------------------------------------------ kernels D and E

# (R, H, T): one row, a ragged tile, zoo M's fullband (64 x 320) and section
# 0 (512 x 224, eight blocks of 64 rows), T from 1 up
TRAIN_SHAPES = [(1, 24, 7), (5, 224, 40), (64, 320, 7), (512, 224, 40), (512, 320, 1),
                (64, 24, 40)]


def _train_layer(R, H, T, shared, mode, dev, seed):
    g = torch.Generator().manual_seed(seed)
    G = H if shared else 2 * H
    xg = torch.randn(T, R, G, generator=g)
    whh = torch.randn(H, G, generator=g) / H ** 0.5
    b2 = torch.randn(2, H, generator=g) * 0.1
    if mode == "bn":
        bnp = torch.stack([1 + 0.1 * torch.randn(H, generator=g), 0.1 * torch.randn(H, generator=g)])
    else:  # affine: an eval fold; none: unused
        bnp = torch.stack([torch.rand(H, generator=g) + 0.5, 0.1 * torch.randn(H, generator=g)])
    return [t.to(dev) for t in (xg, whh, b2, bnp)]


@pytest.mark.parametrize("mode", ["bn", "affine", "none"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("R,H,T", TRAIN_SHAPES)
def test_train_fwd_kernel_matches_plain(dev, mode, shared, R, H, T):
    args = _train_layer(R, H, T, shared, mode, dev, seed=R + H + T)
    before = gk.gsu_layer_train_fwd.launches
    got = gk.gsu_layer_train_fwd(*args, H, shared, mode)
    ref = gk.layer_train_fwd_plain(*args, H, shared, mode)
    torch.cuda.synchronize()
    assert gk.gsu_layer_train_fwd.launches == before + 1
    spikes, y, stats = got
    assert spikes.shape == y.shape == (T, R, H) and stats.shape == (T, 2, H)
    assert torch.equal(spikes, (y >= 0).float())
    flips = (spikes != ref[0]).any(-1).any(-1)
    first = int(flips.float().argmax()) if bool(flips.any()) else T
    assert (spikes != ref[0]).float().mean().item() < 1e-3
    # membranes and statistics agree to f32 rounding up to the first flip
    # (atol for membranes near 0, where (c' - mean) cancels)
    torch.testing.assert_close(y[:first], ref[1][:first], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[:first], ref[2][:first], rtol=1e-5, atol=1e-6)
    if mode != "bn":
        assert not stats.any()
    assert 0.02 < spikes.mean().item() < 0.98


def _rel(got, ref):
    return ((got.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("mode", ["bn", "none"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("R,H,T", TRAIN_SHAPES)
def test_train_bwd_kernels_match_plain(dev, mode, shared, R, H, T):
    xg, whh, b2, bnp = _train_layer(R, H, T, shared, mode, dev, seed=3 * R + H + T)
    _, y, stats = gk.layer_train_fwd_plain(xg, whh, b2, bnp, H, shared, mode)
    gout = torch.randn(T, R, H, generator=torch.Generator().manual_seed(T)).to(dev)
    args = (xg, y.contiguous(), gout, stats.contiguous(), whh, b2, bnp, H, shared, mode)
    before = (gk.gsu_layer_train_bwd.launches, gk.gsu_train_dw.launches)
    got = gk.gsu_layer_train_bwd(*args)
    ref = gk.layer_train_bwd_plain(*args)
    torch.cuda.synchronize()
    assert (gk.gsu_layer_train_bwd.launches, gk.gsu_train_dw.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    names = ("dxg", "dW", "db", "dbn")
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        if name == "dbn" and mode == "none":
            assert not a.any()
            continue
        if R == 1 and mode == "bn":
            # a batch of one: xhat and BN's backward are exactly 0, which the
            # plain version reproduces; the kernel's recomputed c' differs
            # from the saved mean by a rounding (about 1e-7 |c'|), which
            # rsqrt(eps) ~ 316 magnifies and dgamma = sum(dy xhat) adds up
            # over the steps (2e-4 seen at T = 7). Only dbeta = sum(dy) is
            # not zero.
            if name == "dbn":
                a, b = a[0], b[0]
                assert _rel(got[3][1], ref[3][1]) <= 1e-5
            assert not b.any() and a.abs().max().item() <= 1e-3, (name, a.abs().max())
            continue
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))
    # the weight-gradient kernel alone, on the plain version's dxg
    assert _rel(gk.gsu_train_dw(y, ref[0]), gk.train_dw_plain(y, ref[0])) <= 1e-5


def test_train_wrappers_reject_what_the_kernels_do_not_take(dev):
    xg, whh, b2, bnp = _train_layer(8, 16, 5, True, "bn", dev, seed=0)
    with pytest.raises(ValueError, match="dtype"):
        gk.gsu_layer_train_fwd(xg.double(), whh, b2, bnp, 16, True, "bn")
    with pytest.raises(ValueError, match="shape"):
        gk.gsu_layer_train_fwd(xg, whh, b2, bnp, 16, False, "bn")  # unshared wants 2H gates
    with pytest.raises(ValueError, match="mode"):
        gk.gsu_layer_train_fwd(xg, whh, b2, bnp, 16, True, "batch")
    with pytest.raises(ValueError, match="shared memory"):
        big = _train_layer(1024, 512, 2, True, "bn", dev, seed=1)
        gk.gsu_layer_train_fwd(*big, 512, True, "bn")
    _, y, stats = gk.gsu_layer_train_fwd(xg, whh, b2, bnp, 16, True, "bn")
    with pytest.raises(ValueError, match="affine"):
        gk.gsu_layer_train_bwd(xg, y, y, stats, whh, b2, bnp, 16, True, "affine")
