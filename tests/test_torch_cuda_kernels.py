"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip without an NVIDIA GPU. This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

At these small shapes no near-threshold spike flips occur, so A's and F's
spikes must match exactly (mismatch < 1e-3 allows one stray flip), B's
enhanced spectrum and C's enhanced audio to f32 rounding (relative L2 <
1e-4; C in bf16 < 2e-3, see C_TOL), B in each mode (unit scales per
utterance, per frame, with the pre-LN terms, none; the deep filter or the
projection out, the latter in bf16 < 2e-3, see B_PROJ_TOL). Kernel D's spikes likewise (one stray
flip allowed), its membranes and batch statistics within rtol 1e-5 up to
the first flip; kernel E and its weight-gradient kernel, fed the same
saved tensors as their plain versions (so no spike can flip), within a
relative L2 error of 1e-5. With bf16 streams D's arithmetic is float32 as
before (the same bounds); E rounds drg to bf16 at every step, and a drg
within a float32 rounding of a bf16 midpoint rounds the other way in the
kernel than in the plain version (1.8e-3 relative L2 seen at 5 rows with
BN), so E's outputs and the plain version's are each held against a float64
run of the plain version, which does not round drg: the kernel's error
within 3x (+1e-5) of the plain version's own. D
at baseline L's section rows (1024 and 1536 x 256) is held one step at a
time: every step recomputed in float64 from the kernel's own previous
membranes, the kernel within 3x (+1e-4) of the plain version's own error.
E's bf16 rounding points are also held directly, at 3 or 4 steps, against
a float64 run that rounds drg where the TPU kernel does: the kernel within
a quarter of the distance of a version that leaves the rounding out. D and
E at the edges of their unit split (a unit slice that does not divide H, R
not a multiple of 16, the most rows the plan takes at H 256 and H 320) are
held as at baseline L's rows, and two launches of each are bitwise equal.
A, B and F at the edges of their plans (ragged row tiles, A's tiles
across unit boundaries, unit groups of unequal size, H 40 and 48
unshared, F 3 and 257, H 512 with L 4, clusters of 2 and 4, A at T 1 and
5 and H 13) are held to the bounds above, and two launches of each are
bitwise equal; A's units form equals its 3-D form, and gates staged from
a misaligned address equal aligned ones, bit for bit. The recipe's loss gives the same gradient on every backward.
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


def _sections(shared, io, dev, g, H=48, n0=3):
    G = H if shared else 2 * H
    secs = []
    for n, ctr, df, a0, aw in [(n0, 4, 3, 0, 22), (2, 8, 1, 14, 26), (2, 16, 2, 30, 33)]:
        wihr, whh, coef = _stack(H, shared, 2, io, dev, g)
        P = 2 * df * ctr
        secs.append({
            "wa": (torch.randn(n, aw, G, generator=g) * 0.3).to(io).to(dev), "a0": a0,
            "wb": (torch.randn(n, 16, G, generator=g) * 0.3).to(io).to(dev),
            "wihr": wihr, "whh": whh, "coef": coef,
            "wproj": (torch.randn(H, P, generator=g) * 0.2).to(io).to(dev),
            "bproj": (torch.randn(P, generator=g) * 0.1).to(dev), "ctr": ctr, "df": df})
    return secs


# kernel B's projection out in bf16 (no deep filter) is rounded from f32 sums
# taken in another order than the plain version's: one bf16 step apart where
# they straddle a rounding boundary
B_PROJ_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}


def _section_scales(mode, secs, T, B, U, G, dev, g):
    """(alpha, beta) of kernel B's mode: "off" one scale per utterance and
    unit, "cum" per frame, "ln" per frame with the pre-LN terms (each
    section gets its "uv"), "raw" none."""
    if mode == "raw":
        return None, None
    if mode == "ln":
        for s in secs:
            s["uv"] = (torch.randn(2, G, generator=g) * 0.3).to(dev)
    alpha = (torch.rand((B, U) if mode == "off" else (T, B, U), generator=g) + 0.5).to(dev)
    beta = (torch.rand(T, B, U, generator=g) - 0.5).to(dev) if mode == "ln" else None
    return alpha, beta


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("mode", ["off", "cum", "ln", "raw"])
@pytest.mark.parametrize("df_mode", [True, False], ids=["df", "proj"])
def test_sections_kernel_matches_plain(dev, io, shared, mode, df_mode):
    """Kernel B in each of its modes (the unit scales per utterance, per
    frame, per frame with the pre-LN terms, none), with the deep filter
    (enhanced spectrum) or without (each section's projection in the
    stream type)."""
    g = torch.Generator().manual_seed(7)
    H, T, B = 48, 40, 11
    G = H if shared else 2 * H
    secs = _sections(shared, io, dev, g, H)
    U = sum(s["wa"].shape[0] for s in secs)
    W = sum(s["wa"].shape[0] * s["ctr"] for s in secs)
    alpha, beta = _section_scales(mode, secs, T, B, U, G, dev, g)
    xa = torch.rand(T, B, 64, generator=g).to(io).to(dev)
    xb = torch.randn(T, B, 16, generator=g).to(io).to(dev)
    spec = ((torch.randn(T, B, W + 1, generator=g).to(dev),
             torch.randn(T, B, W + 1, generator=g).to(dev)) if df_mode else (None, None))
    before = gk.gsu_sections_eval.launches
    got = gk.gsu_sections_eval(secs, xa, xb, alpha, *spec, H, shared, beta)
    ref = gk.sections_eval_plain(secs, xa, xb, alpha, *spec, H, shared, beta)
    torch.cuda.synchronize()
    assert gk.gsu_sections_eval.launches == before + 1
    if df_mode:
        num = sum((a - b).square().sum() for a, b in zip(got, ref))
        den = sum(b.square().sum() for b in ref)
        assert (num / den).sqrt().item() < 1e-4
        return
    assert len(got) == len(secs)
    for s, a, b in zip(secs, got, ref):
        assert a.shape == b.shape == (s["wa"].shape[0], T, B, s["wproj"].shape[1])
        assert a.dtype == b.dtype == io
        assert _rel_l2(a, b) < B_PROJ_TOL[io]


# kernel F at the edges of its plan (stack_x_plan): rows that do not fill a
# tile (R 1, 5, 13), H not a multiple of 16 with unshared weights, F 3 and
# 257, H 512 with L 4, the gate m-tiles split over a cluster of 2 (256 rows
# x 320, as the fullband) or 4 (21 rows x 320 unshared)
F_EDGES = {"R 1": (2, 9, 1, 38, 224, True), "R 5, H 40 unshared": (2, 12, 5, 37, 40, False),
           "R 13, H 48 unshared": (3, 10, 13, 20, 48, False), "F 3": (2, 12, 19, 3, 64, True),
           "F 257": (2, 8, 37, 257, 256, True), "H 512, L 4": (4, 6, 11, 38, 512, False),
           "cluster 2": (2, 10, 256, 64, 320, True), "cluster 4": (2, 10, 21, 64, 320, False)}


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(F_EDGES))
def test_stack_x_kernel_at_the_plan_edges(dev, case, io):
    L, T, R, Fin, H, shared = F_EDGES[case]
    g = torch.Generator().manual_seed(R * 7 + Fin)
    layers, states = _layers(H, shared, L, g, fin=Fin)
    w = [t.to(dev) for t in gk.pack_stack_x(layers, states, H, io)]
    x = torch.rand(T, R, Fin, generator=g).to(io).to(dev)
    plan = gk.stack_x_plan(R, Fin, H, L, shared, io)
    if case.startswith("cluster"):
        assert plan["cs"] == int(case[-1])
    got = gk.gsu_stack_eval_x(x, *w, H, shared)
    ref = gk.stack_eval_x_plain(x, *w, H, shared)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (L, T, R, H) and got.dtype == io
    assert (got != ref).float().mean().item() < 1e-3


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["R 13, H 48 unshared", "cluster 2"])
def test_stack_x_kernel_is_bitwise_deterministic(dev, case, io):
    """Two launches on the same inputs give the same spikes bit for bit."""
    L, T, R, Fin, H, shared = F_EDGES[case]
    g = torch.Generator().manual_seed(11)
    layers, states = _layers(H, shared, L, g, fin=Fin)
    w = [t.to(dev) for t in gk.pack_stack_x(layers, states, H, io)]
    x = torch.rand(4 * T, R, Fin, generator=g).to(io).to(dev)
    first, again = gk.gsu_stack_eval_x(x, *w, H, shared), gk.gsu_stack_eval_x(x, *w, H, shared)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


# kernel A at the edges of its plan (stack_x_plan over the U R (unit, row)
# columns), (U, T, R, H, L, shared): one row; tiles that cross unit
# boundaries with U R no multiple of the tile (3 x 13, 5 x 7, 8 x 33);
# unshared G = 2H; H 512 with L 4; the gate m-tiles split over a cluster of
# 2 (the served fullband's 256 rows x 320, and 8 units x 33 rows x 320) or
# 4 (21 rows x 320 unshared); T = 1 and T < 8; H 13, whose rows of 13
# gates stage one value a chunk
A_EDGES = {"R 1": (1, 9, 1, 224, 2, True),
           "U 3 x R 13, H 48 unshared": (3, 12, 13, 48, 2, False),
           "U 5 x R 7, H 40 unshared": (5, 10, 7, 40, 2, False),
           "H 512, L 4": (1, 6, 11, 512, 4, False),
           "cluster 2": (1, 10, 256, 320, 2, True),
           "U 8 x R 33, cluster 2": (8, 6, 33, 320, 2, True),
           "cluster 4": (1, 10, 21, 320, 2, False),
           "T 1": (2, 1, 13, 40, 2, True),
           "T 5": (3, 5, 9, 64, 3, True),
           "H 13": (2, 7, 9, 13, 2, True)}


def _a_edge_args(case, io, dev, T=None):
    U, T0, R, H, L, shared = A_EDGES[case]
    g = torch.Generator().manual_seed(U * 1000 + R + H)
    w = _stack(H, shared, L, io, dev, g)
    G = H if shared else 2 * H
    T = T or T0
    x = torch.randn((U, T, R, G) if U > 1 else (T, R, G), generator=g).to(io).to(dev)
    return (x, *w, H, shared)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(A_EDGES))
def test_stack_kernel_at_the_plan_edges(dev, case, io):
    """Kernel A's last layer and every layer (collect_all) against its plain
    version; the cluster cases run on the cluster they name."""
    args = _a_edge_args(case, io, dev)
    x, _, whh, _, H, shared = args
    if "cluster" in case:
        assert gk._stack_a_plan(x, H, whh.shape[0], shared)["cs"] == int(case[-1])
    for collect in (False, True):
        before = gk.gsu_stack_eval.launches
        got = gk.gsu_stack_eval(*args, collect_all=collect)
        ref = gk.stack_eval_plain(*args, collect_all=collect)
        torch.cuda.synchronize()
        assert gk.gsu_stack_eval.launches == before + 1
        assert got.shape == ref.shape and got.dtype == io
        assert (got != ref).float().mean().item() < 1e-3


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["U 3 x R 13, H 48 unshared", "U 8 x R 33, cluster 2"])
def test_stack_kernel_units_form_equals_the_3d_form(dev, case, io):
    """A column's spikes do not depend on its tile, its unit or its
    cluster: the units form [U, T, R, G] equals the 3-D form [T, U R, G] and
    one unit launched alone bit for bit, and collect_all's last layer
    equals the last layer alone."""
    x4, *w = _a_edge_args(case, io, dev)
    U, T, R, G = x4.shape
    got4 = gk.gsu_stack_eval(x4, *w)
    got3 = gk.gsu_stack_eval(x4.transpose(0, 1).reshape(T, U * R, G).contiguous(), *w)
    one = gk.gsu_stack_eval(x4[1:2].contiguous(), *w)
    all4 = gk.gsu_stack_eval(x4, *w, collect_all=True)
    torch.cuda.synchronize()
    assert torch.equal(got4.transpose(0, 1).reshape(T, U * R, -1), got3)
    assert torch.equal(one, got4[1:2])
    assert torch.equal(all4[-1], got4)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["U 3 x R 13, H 48 unshared", "cluster 2"])
def test_stack_kernel_is_bitwise_deterministic(dev, case, io):
    """Two launches on the same inputs give the same spikes bit for bit."""
    args = _a_edge_args(case, io, dev, T=40)
    for collect in (False, True):
        first = gk.gsu_stack_eval(*args, collect_all=collect)
        again = gk.gsu_stack_eval(*args, collect_all=collect)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
def test_stack_kernel_stages_misaligned_gates_in_narrower_chunks(dev, io):
    """Gates one element into their storage (not 16-byte aligned) are
    staged in narrower chunks, and give the same spikes bit for bit."""
    x, *w = _a_edge_args("U 3 x R 13, H 48 unshared", io, dev)
    shifted = torch.empty(x.numel() + 1, dtype=io, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    got, ref = gk.gsu_stack_eval(shifted, *w), gk.gsu_stack_eval(x, *w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_stack_wrapper_raises_beyond_the_plan(dev):
    """On the card nothing falls back to the plain version: H 513 or L 5
    raise."""
    for H, L in ((513, 2), (40, 5)):
        w = _stack(H, True, L, torch.float32, dev, torch.Generator().manual_seed(H + L))
        with pytest.raises(ValueError, match="H <= 512"):
            gk.gsu_stack_eval(torch.zeros(4, 8, H, device=dev), *w, H, True)


# kernel B at the edges of its plan (sections_plan): batches of 1 (a tile of
# 8 rows), 9 and 257 (ragged row tiles), H 40 unshared, a section of five
# units at 513 rows (its units go in groups of 3 and 2, the other sections'
# two units in one group: several units a block)
B_EDGES = {"B 1": (1, 48, True, 3), "B 9": (9, 48, True, 3), "B 257": (257, 48, True, 3),
           "H 40 unshared": (11, 40, False, 3), "five units": (513, 40, True, 5)}


def _b_edge_args(case, mode, df_mode, io, dev, T=12):
    B, H, shared, n0 = B_EDGES[case]
    g = torch.Generator().manual_seed(B + H + n0)
    G = H if shared else 2 * H
    secs = _sections(shared, io, dev, g, H, n0)
    U = sum(s["wa"].shape[0] for s in secs)
    W = sum(s["wa"].shape[0] * s["ctr"] for s in secs)
    alpha, beta = _section_scales(mode, secs, T, B, U, G, dev, g)
    xa = torch.rand(T, B, 64, generator=g).to(io).to(dev)
    xb = torch.randn(T, B, 16, generator=g).to(io).to(dev)
    spec = ((torch.randn(T, B, W + 1, generator=g).to(dev),
             torch.randn(T, B, W + 1, generator=g).to(dev)) if df_mode else (None, None))
    return (secs, xa, xb, alpha, *spec, H, shared, beta)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["off", "ln"])
@pytest.mark.parametrize("case", list(B_EDGES))
def test_sections_kernel_at_the_plan_edges(dev, case, mode, io):
    """The deep filter's enhanced spectrum within the bound of
    test_sections_kernel_matches_plain, and the projection mode's within
    B_PROJ_TOL, on the same inputs."""
    args = _b_edge_args(case, mode, True, io, dev)
    if case == "five units":
        plan = gk.sections_plan(gk._sec_dims(args[0], 16, args[6], args[7]), 513, io)
        assert sorted(nb for si, _, nb, _ in plan["groups"] if si == 0) == [2, 3]
    got, ref = gk.gsu_sections_eval(*args), gk.sections_eval_plain(*args)
    torch.cuda.synchronize()
    num = sum((a - b).square().sum() for a, b in zip(got, ref))
    den = sum(b.square().sum() for b in ref)
    assert (num / den).sqrt().item() < 1e-4
    secs, xa, xb, alpha, _, _, H, shared, beta = args
    pargs = (secs, xa, xb, alpha, None, None, H, shared, beta)
    for s, a, b in zip(secs, gk.gsu_sections_eval(*pargs), gk.sections_eval_plain(*pargs)):
        assert a.shape == b.shape == (s["wa"].shape[0], xa.shape[0], xa.shape[1],
                                      s["wproj"].shape[1])
        assert _rel_l2(a, b) < B_PROJ_TOL[io]


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["B 9", "five units"])
def test_sections_kernel_is_bitwise_deterministic(dev, case, io):
    """Two launches on the same inputs give the same spectrum bit for bit."""
    args = _b_edge_args(case, "ln", True, io, dev, T=40)
    first, again = gk.gsu_sections_eval(*args), gk.gsu_sections_eval(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_sections_wrapper_rejects_what_the_kernel_does_not_take(dev):
    g = torch.Generator().manual_seed(1)
    H, T, B = 16, 6, 3
    secs = _sections(True, torch.float32, dev, g, H)
    U = sum(s["wa"].shape[0] for s in secs)
    W = sum(s["wa"].shape[0] * s["ctr"] for s in secs)
    xa, xb = torch.rand(T, B, 64, device=dev), torch.randn(T, B, 16, device=dev)
    spec = (torch.randn(T, B, W, device=dev), torch.randn(T, B, W, device=dev))
    a3 = torch.ones(T, B, U, device=dev)
    with pytest.raises(ValueError, match="beta"):
        gk.gsu_sections_eval(secs, xa, xb, a3, *spec, H, True, torch.zeros_like(a3))
    with pytest.raises(ValueError, match="alpha shape"):
        gk.gsu_sections_eval(secs, xa, xb, torch.ones(B, U + 1, device=dev), *spec, H, True)
    with pytest.raises(ValueError, match="dtype"):
        gk.gsu_sections_eval(secs, xa, xb, a3.double(), *spec, H, True)
    with pytest.raises(ValueError, match="both or neither"):
        gk.gsu_sections_eval(secs, xa, xb, a3, spec[0], None, H, True)
    for s in secs:
        s["uv"] = torch.zeros(2, H, device=dev)
    with pytest.raises(ValueError, match="per-frame"):
        gk.gsu_sections_eval(secs, xa, xb, torch.ones(B, U, device=dev), *spec, H, True,
                             torch.zeros_like(a3))
    secs[0]["uv"] = torch.zeros(2, H + 1, device=dev)
    with pytest.raises(ValueError, match="shape"):
        gk.gsu_sections_eval(secs, xa, xb, a3, *spec, H, True, torch.zeros_like(a3))


def test_collect_path_units_spikes_equal_plain(dev, monkeypatch):
    """The collect path (eval with collect_layer_outputs=True) runs kernel A
    four times: the fullband stack in its 3-D form and each section in its
    4-D units form [n, T, B, G], every layer collected. Each launch's spikes
    equal the plain version's on the same gates (one stray flip allowed, as
    above), and the sections' collected spikes are those launches' rows in
    b-major order."""
    from spiking_fullsubnet_torch.models import stream_forward as sf
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import (SpikingFullSubNet,
                                                                    SpikingFullSubNetConfig)
    cfg = SpikingFullSubNetConfig(
        n_fft=128, hop_length=32, win_length=128, fb_input_size=16, fb_hidden_size=24,
        fb_proj_size=16, sb_hidden_size=20, freq_cutoffs=(0, 8, 32, 64), df_orders=(2, 1, 3),
        center_freq_sizes=(2, 8, 16), neighbor_freq_sizes=(3, 3, 3),
        fb_center_freq_sizes=(2, 8, 16), fb_neighbor_freq_sizes=(0, 0, 0),
        use_pre_layer_norm_fb=False, use_pre_layer_norm_sb=False,
        norm_type="offline_laplace_norm", bn=True, shared_weights=True, scan_mode="auto")
    assert cfg.collect_layer_outputs
    model = SpikingFullSubNet.from_init(cfg, seed=0, device=dev)
    seen = []
    real = sf.gsu_stack_eval
    monkeypatch.setattr(sf, "gsu_stack_eval",
                        lambda *a, **k: seen.append((a, k, real(*a, **k))) or seen[-1][2])
    noisy = torch.randn(3, 4000, generator=torch.Generator().manual_seed(2)).to(dev) * 0.1
    out = model(noisy)
    torch.cuda.synchronize()
    assert [a[0].ndim for a, _, _ in seen] == [3, 4, 4, 4]
    assert all(k.get("collect_all") for _, k, _ in seen)
    for a, k, got in seen:
        ref = gk.stack_eval_plain(*a, **k)
        assert got.shape == ref.shape and (got != ref).float().mean().item() < 1e-3
    for (a, _, got), lists in zip(seen[1:], out["sb_all_layer_outputs"]):
        n, T, B = a[0].shape[:3]
        for layer, spikes in zip(got, lists[1:-1]):
            assert torch.equal(spikes, layer.permute(1, 2, 0, 3).reshape(T, B * n, -1))


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


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_monolith_kernel_short_sequences(dev, S):
    """T < df: the deep filter's older taps read no frame yet; S below the
    kernel's pipeline depth (four stages: front, fullband, units, back)."""
    g = torch.Generator().manual_seed(S)
    mono = _mono("cum", True, 2, 2, torch.float32, dev, g, S)
    chunks = (torch.randn(S + 3, 3, 16, generator=g) * 0.1).to(dev)
    got = gk.sfsb_monolith_serve(mono, chunks)
    ref = gk.monolith_serve_plain(mono, chunks)
    torch.cuda.synchronize()
    assert _rel_l2(got, ref) < 1e-4


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 9, 257])
def test_monolith_kernel_ragged_batches(dev, io, B):
    """Batches that are not a multiple of the kernel's row tile (16 rows):
    one row, a ragged tile, and 17 tiles (more than one wave of clusters)."""
    g = torch.Generator().manual_seed(B)
    S = 12
    mono = _mono("ln", True, 2, 2, io, dev, g, S)
    chunks = (torch.randn(S + 3, B, 16, generator=g) * 0.1).to(io).to(dev)
    got = gk.sfsb_monolith_serve(mono, chunks)
    ref = gk.monolith_serve_plain(mono, chunks)
    torch.cuda.synchronize()
    assert got.shape == (S, B, 16) and torch.isfinite(got).all()
    assert _rel_l2(got, ref) < C_TOL[io]


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
def test_monolith_kernel_on_plans_for_less_shared_memory(dev, io, monkeypatch):
    """The plan's answers to a block that does not fit: under a 30,000-byte
    cap the float32 spec takes the 8-row tile, the bf16 one splits its unit
    blocks (7 blocks a cluster); the kernel follows either plan."""
    monkeypatch.setattr(gk, "SMEM_MAX", 30000)
    g = torch.Generator().manual_seed(5)
    S, B = 20, 11
    mono = _mono("cum", True, 2, 2, io, dev, g, S)
    chunks = (torch.randn(S + 3, B, 16, generator=g) * 0.1).to(io).to(dev)
    plan = gk.monolith_plan(mono, B, io)
    assert (plan["rt"], plan["nblk"]) == ((8, 5) if io == torch.float32 else (16, 7))
    got = gk.sfsb_monolith_serve(mono, chunks)
    ref = gk.monolith_serve_plain(mono, chunks)
    torch.cuda.synchronize()
    assert _rel_l2(got, ref) < C_TOL[io]


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
def test_monolith_kernel_is_bitwise_deterministic(dev, io):
    """Two launches on the same inputs give the same bits: every sum has a
    fixed order (no atomics)."""
    g = torch.Generator().manual_seed(3)
    S, B = 30, 40
    mono = _mono("cum", False, 2, 2, io, dev, g, S)
    chunks = (torch.randn(S + 3, B, 16, generator=g) * 0.1).to(io).to(dev)
    a = gk.sfsb_monolith_serve(mono, chunks)
    b = gk.sfsb_monolith_serve(mono, chunks)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_monolith_kernel_packs_a_spec_once(dev):
    """The first launch packs the spec's weights and keeps them on it; the
    next launch reuses that pack and gives the bits of a fresh spec's."""
    g = torch.Generator().manual_seed(4)
    S, B = 12, 9
    mono = _mono("ln", True, 2, 2, torch.bfloat16, dev, g, S)
    chunks = (torch.randn(S + 3, B, 16, generator=g) * 0.1).to(torch.bfloat16).to(dev)
    assert "packed" not in mono
    a = gk.sfsb_monolith_serve(mono, chunks)
    packed = mono["packed"]
    b = gk.sfsb_monolith_serve(mono, chunks)
    fresh = gk.sfsb_monolith_serve({k: v for k, v in mono.items() if k != "packed"}, chunks)
    torch.cuda.synchronize()
    assert mono["packed"] is packed
    assert torch.equal(a, b) and torch.equal(a, fresh)


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
        # two steps' spike bits of 2048 rows x 512 units: 256 KB a block
        big = _train_layer(2048, 512, 2, True, "bn", dev, seed=1)
        gk.gsu_layer_train_fwd(*big, 512, True, "bn")
    _, y, stats = gk.gsu_layer_train_fwd(xg, whh, b2, bnp, 16, True, "bn")
    with pytest.raises(ValueError, match="affine"):
        gk.gsu_layer_train_bwd(xg, y, y, stats, whh, b2, bnp, 16, True, "affine")


# ------------------------------------------------------------------ D and E: bf16 streams, row cap

BF16_SHAPES = [(5, 224, 40), (64, 320, 7), (512, 224, 40)]


def _bf16_layer(R, H, T, shared, mode, dev, seed):
    xg, whh, b2, bnp = _train_layer(R, H, T, shared, mode, dev, seed)
    return xg.to(torch.bfloat16), whh.to(torch.bfloat16), b2, bnp


@pytest.mark.parametrize("mode", ["bn", "affine", "none"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("R,H,T", BF16_SHAPES)
def test_train_fwd_kernel_bf16_streams_matches_plain(dev, mode, shared, R, H, T):
    args = _bf16_layer(R, H, T, shared, mode, dev, seed=R + H + T + 1)
    spikes, y, stats = gk.gsu_layer_train_fwd(*args, H, shared, mode)
    ref = gk.layer_train_fwd_plain(*args, H, shared, mode)
    torch.cuda.synchronize()
    assert spikes.dtype == ref[0].dtype == torch.bfloat16
    assert y.dtype == stats.dtype == ref[1].dtype == torch.float32
    assert torch.equal(spikes, (y >= 0).to(torch.bfloat16))
    flips = (spikes != ref[0]).any(-1).any(-1)
    first = int(flips.float().argmax()) if bool(flips.any()) else T
    assert (spikes != ref[0]).float().mean().item() < 1e-3
    torch.testing.assert_close(y[:first], ref[1][:first], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[:first], ref[2][:first], rtol=1e-5, atol=1e-6)
    assert 0.02 < spikes.float().mean().item() < 0.98


@pytest.mark.parametrize("mode", ["bn", "none"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("R,H,T", BF16_SHAPES)
def test_train_bwd_kernels_bf16_streams_match_plain(dev, mode, shared, R, H, T):
    xg, whh, b2, bnp = _bf16_layer(R, H, T, shared, mode, dev, seed=3 * R + H + T + 1)
    _, y, stats = gk.layer_train_fwd_plain(xg, whh, b2, bnp, H, shared, mode)
    gout = torch.randn(T, R, H, generator=torch.Generator().manual_seed(T)).to(
        dev, torch.bfloat16)
    args = (xg, y.contiguous(), gout, stats.contiguous(), whh, b2, bnp, H, shared, mode)
    got = gk.gsu_layer_train_bwd(*args)
    ref = gk.layer_train_bwd_plain(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == ref[0].dtype == torch.bfloat16
    _assert_bf16_e_close(args, got, ref, skip_dbn=mode == "none")
    # the weight-gradient kernel alone, on the plain version's bf16 dxg
    assert _rel(gk.gsu_train_dw(y, ref[0]), gk.train_dw_plain(y, ref[0])) <= 1e-5


def _assert_bf16_e_close(args, got, ref, skip_dbn=False):
    """Kernel E's outputs with bf16 streams (``got``) and its plain
    version's (``ref``), each against a float64 run of the plain version on
    the same inputs: the kernel within 3x (+1e-5) of the plain version's
    relative L2 error."""
    f64 = gk.layer_train_bwd_plain(*[a.double() if isinstance(a, torch.Tensor) else a
                                     for a in args])
    for name, a, b, o in zip(("dxg", "dW", "db", "dbn"), got, ref, f64):
        assert a.shape == b.shape and torch.isfinite(a.float()).all(), name
        if name == "dbn" and skip_dbn:
            assert not a.any()
            continue
        assert _rel(a, o) <= 3 * _rel(b, o) + 1e-5, (name, _rel(a, o), _rel(b, o), _rel(a, b))


def _step_errors(args, y, stats):
    """Largest |y - step| and statistics error of a BN layer's membranes
    ``y`` and statistics, each step recomputed in float64 from the same
    run's y[t-1] (h = c = 0 before the first step)."""
    xg, whh, b2, bnp, H, shared, _ = args
    yd = y.double()
    zero = torch.zeros_like(yd[:1])
    c_prev = torch.cat([zero, yd[:-1]])
    pre = xg.double() + torch.cat([zero, (yd[:-1] >= 0).double()]) @ whh.double()
    f = torch.sigmoid((pre if shared else pre[..., :H]) + b2[0].double())
    cy = f * c_prev + (1 - f) * ((pre if shared else pre[..., H:]) + b2[1].double())
    mean = cy.mean(1)
    var = (cy - mean[:, None]).square().mean(1)
    step = (cy - mean[:, None]) * torch.rsqrt(var + gk.BN_EPS)[:, None] * bnp[0].double() \
        + bnp[1].double()
    stats_err = max((stats[:, 0].double() - mean).abs().max().item(),
                    ((stats[:, 1].double() - var).abs() / (var + gk.BN_EPS)).max().item())
    return (yd - step).abs().max().item(), stats_err


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1024, 1536])
def test_train_kernels_take_baseline_l_section_rows(dev, io, R):
    """Baseline L's sections 0 and 1 at batch 64 (16 and 24 units) at H 256:
    beyond kernel D's old cap of 896 rows, within its 1792."""
    H, T, shared = 256, 12, True
    xg, whh, b2, bnp = _train_layer(R, H, T, shared, "bn", dev, seed=R)
    xg, whh = xg.to(io), whh.to(io)
    args = (xg, whh, b2, bnp, H, shared, "bn")
    spikes, y, stats = gk.gsu_layer_train_fwd(*args)
    ref = gk.layer_train_fwd_plain(*args)
    torch.cuda.synchronize()
    assert spikes.shape == (T, R, H) and torch.equal(spikes, (y >= 0).to(io))
    k_y, k_s = _step_errors(args, y, stats)
    p_y, p_s = _step_errors(args, ref[1], ref[2])
    assert k_y <= 3 * p_y + 1e-4 and k_s <= 3 * p_s + 1e-4, (k_y, p_y, k_s, p_s)
    gout = torch.randn(T, R, H, generator=torch.Generator().manual_seed(R)).to(dev, io)
    e_args = (xg, ref[1], gout, ref[2], whh, b2, bnp, H, shared, "bn")
    got, want = gk.gsu_layer_train_bwd(*e_args), gk.layer_train_bwd_plain(*e_args)
    torch.cuda.synchronize()
    if io == torch.bfloat16:
        _assert_bf16_e_close(e_args, got, want)
        return
    for name, a, b in zip(("dxg", "dW", "db", "dbn"), got, want):
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


# the unit split's edges (train_plan): a unit slice that does not divide H
# (H 40: blocks of 16, 16 and 8 units; H 200: six of 32 and one of 8), R not
# a multiple of 16, one row group, unshared weights, and the most rows the
# plan takes at H 256 and H 320 (kernel D's spike bits of two steps and its
# tiles fill 227 KB)
EDGE_SHAPES = [(37, 40, 9, True), (100, 200, 9, False), (13, 24, 5, False), (8, 48, 6, True),
               (3304, 256, 3, True), (2608, 320, 3, True), (1792, 256, 3, False)]


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,H,T,shared", EDGE_SHAPES)
def test_train_kernels_at_the_unit_split_edges(dev, io, R, H, T, shared):
    xg, whh, b2, bnp = _train_layer(R, H, T, shared, "bn", dev, seed=7 * R + H + T)
    xg, whh = xg.to(io), whh.to(io)
    args = (xg, whh, b2, bnp, H, shared, "bn")
    spikes, y, stats = gk.gsu_layer_train_fwd(*args)
    ref = gk.layer_train_fwd_plain(*args)
    torch.cuda.synchronize()
    assert spikes.shape == (T, R, H) and torch.equal(spikes, (y >= 0).to(io))
    assert (spikes != ref[0]).float().mean().item() < 1e-3
    k_y, k_s = _step_errors(args, y, stats)
    p_y, p_s = _step_errors(args, ref[1], ref[2])
    assert k_y <= 3 * p_y + 1e-4 and k_s <= 3 * p_s + 1e-4, (k_y, p_y, k_s, p_s)
    gout = torch.randn(T, R, H, generator=torch.Generator().manual_seed(R + H)).to(dev, io)
    e_args = (xg, ref[1], gout, ref[2], whh, b2, bnp, H, shared, "bn")
    got, want = gk.gsu_layer_train_bwd(*e_args), gk.layer_train_bwd_plain(*e_args)
    torch.cuda.synchronize()
    if io == torch.bfloat16:
        _assert_bf16_e_close(e_args, got, want)
        return
    for name, a, b in zip(("dxg", "dW", "db", "dbn"), got, want):
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,H,T,shared", [(512, 224, 40, True), (1536, 256, 12, True),
                                          (64, 320, 40, False)])
def test_train_kernels_are_bitwise_deterministic(dev, io, R, H, T, shared):
    """Two launches of D, and of E, on the same inputs give the same bits:
    every sum runs in a fixed order, with no atomics."""
    xg, whh, b2, bnp = _train_layer(R, H, T, shared, "bn", dev, seed=R + T)
    xg, whh = xg.to(io), whh.to(io)
    args = (xg, whh, b2, bnp, H, shared, "bn")
    d1, d2 = gk.gsu_layer_train_fwd(*args), gk.gsu_layer_train_fwd(*args)
    gout = torch.randn(T, R, H, generator=torch.Generator().manual_seed(R)).to(dev, io)
    e_args = (xg, d1[1], gout, d1[2], whh, b2, bnp, H, shared, "bn")
    e1, e2 = gk.gsu_layer_train_bwd(*e_args), gk.gsu_layer_train_bwd(*e_args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(d1, d2))
    assert all(torch.equal(a, b) for a, b in zip(e1, e2))


def test_train_wrappers_reject_mixed_stream_types(dev):
    xg, whh, b2, bnp = _train_layer(8, 16, 5, True, "bn", dev, seed=0)
    with pytest.raises(ValueError, match="whh: dtype"):
        gk.gsu_layer_train_fwd(xg.to(torch.bfloat16), whh, b2, bnp, 16, True, "bn")
    _, y, stats = gk.gsu_layer_train_fwd(xg, whh, b2, bnp, 16, True, "bn")
    with pytest.raises(ValueError, match="gout: dtype"):
        gk.gsu_layer_train_bwd(xg, y, y.to(torch.bfloat16), stats, whh, b2, bnp, 16, True, "bn")


# a direct witness of E's bf16 rounding points: a float64 run of the plain
# version that rounds drg to bf16 where the TPU kernel does (before dh =
# drg W^T and dW, gsu_pallas.py:449-460) is the oracle; beside the kernel,
# the plain version with bf16 streams but drg left unrounded before dh and
# dW (only its dxg store rounds), which a kernel that skipped or misplaced
# the rounding would match. Short sequences, so that the few drg within a
# float32 rounding of a bf16 midpoint (which round either way) cannot
# carry their one-ulp difference far (at 40 steps they move the plain
# version as far from the oracle as leaving the rounding out does; at 3 or 4
# steps it stays within a tenth of it).
BF16_ROUNDING_SHAPES = [(64, 320, 4), (512, 224, 4), (5, 224, 3)]


@pytest.mark.parametrize("mode", ["bn", "none"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("R,H,T", BF16_ROUNDING_SHAPES)
def test_train_bwd_kernel_bf16_rounds_drg_where_the_reference_does(dev, mode, shared, R, H, T):
    xg, whh, b2, bnp = _bf16_layer(R, H, T, shared, mode, dev, seed=5 * R + H + T)
    _, y, stats = gk.layer_train_fwd_plain(xg, whh, b2, bnp, H, shared, mode)
    gout = torch.randn(T, R, H, generator=torch.Generator().manual_seed(R + T)).to(
        dev, torch.bfloat16)
    args = (xg, y.contiguous(), gout, stats.contiguous(), whh, b2, bnp, H, shared, mode)
    got = gk.gsu_layer_train_bwd(*args)
    plain = gk.layer_train_bwd_plain(*args)
    unrounded = gk.layer_train_bwd_plain(*args, operands=torch.float32)
    oracle = gk.layer_train_bwd_plain(*[a.double() if isinstance(a, torch.Tensor) else a
                                        for a in args], operands=torch.bfloat16)
    torch.cuda.synchronize()
    for name, a, p, u, o in zip(("dxg", "dW", "db", "dbn"), got, plain, unrounded, oracle):
        if name == "dbn" and mode == "none":
            continue
        # the kernel's distance from the oracle, beside the plain version's
        # and the unrounded version's (1e-3 to 2e-3 at these shapes)
        k, q, m = _rel(a, o), _rel(p, o), _rel(u, o)
        assert k < 0.25 * m, (name, k, q, m)


# ------------------------------------------------------------------ the loss's gradient

def test_denoise_loss_gradient_is_deterministic_on_the_card(dev):
    """The recipe's loss (SI-SNR and the STFT MAE losses, whose STFT pads by
    reflection) gives the same gradient bit for bit on every backward:
    ``stft_complex`` writes the reflection out instead of calling
    torch.stft, whose reflect padding sums its gradient with atomic adds."""
    from spiking_fullsubnet_torch.recipes.denoise import denoise_loss
    g = torch.Generator().manual_seed(11)
    clean = (0.1 * torch.randn(8, 96000, generator=g)).to(dev)
    est = (clean + 0.05 * torch.randn(8, 96000, generator=g).to(dev)).requires_grad_(True)
    grads = []
    for _ in range(3):
        loss = denoise_loss(est, clean)["loss"]
        grads.append(torch.autograd.grad(loss, est)[0])
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])


# ------------------------------------------------------------------ the dW kernel

# (T, R, H, G): H and G not multiples of 16, G = 2H, one step, one row, and
# baseline L's section rows (1024 and 1536 x 256) over fewer steps
DW_SHAPES = [(40, 5, 37, 37), (40, 5, 37, 74), (1, 8, 24, 24), (30, 1, 24, 48),
             (101, 1024, 256, 256), (101, 1536, 256, 256), (751, 64, 320, 320)]


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,H,G", DW_SHAPES)
def test_train_dw_kernel_matches_plain_at_ragged_shapes(dev, io, T, R, H, G):
    g = torch.Generator().manual_seed(T + R + H + G)
    y = torch.randn(T, R, H, generator=g).to(dev)
    dxg = (torch.randn(T, R, G, generator=g) * 1e-2).to(io).to(dev)
    before = gk.gsu_train_dw.launches
    got = gk.gsu_train_dw(y, dxg)
    ref = gk.train_dw_plain(y, dxg.float())
    torch.cuda.synchronize()
    assert gk.gsu_train_dw.launches == before + 1
    assert got.shape == (H, G) and got.dtype == torch.float32
    if T == 1:
        assert not got.any()
        return
    # float32 streams keep float32's products through the three-way bf16
    # split (TF32 would give about 3e-4, the hi term alone about 1e-3)
    assert _rel(got, ref) < (1e-5 if io == torch.float32 else 1e-3)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
def test_train_dw_kernel_is_bitwise_deterministic(dev, io):
    """Split over 33 x 16 blocks, the partials added in a fixed order: two
    launches give the same bits."""
    g = torch.Generator().manual_seed(1)
    y = torch.randn(751, 512, 224, generator=g).to(dev)
    dxg = torch.randn(751, 512, 224, generator=g).to(io).to(dev)
    a, b = gk.gsu_train_dw(y, dxg), gk.gsu_train_dw(y, dxg)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
