"""The host-side plans of the port's CUDA kernels, checked on the CPU.

The dW kernel (csrc/gsu_train_bwd.cu) sums h_{t-1}^T dxg_t over the
(T-1) R rows in splits that ops/gsu_kernels.dw_split_plan lays out, and
splits a float32 dxg into three bf16 terms; kernel C (csrc/
sfsb_monolith_serve.cu) takes its whole layout from ops/gsu_kernels.
monolith_plan (row tile, cluster blocks, every block's shared memory) and
its weights from monolith_pack (mma fragments). None of this needs a GPU:

- dW's split plan covers each summed row exactly once at every main-path
  shape (flagship M and zoo M's eight layers, baseline L's 1024 and 1536
  rows, cIRM-GSN's 64 rows x 256, G = 2H, T = 1, R = 1), with the blocks a
  multiple of the H100's 132 SMs there;
- the three-way bf16 split reconstructs float32 values exactly (above
  about 2^-110);
- C's plan at flagship M, zoo M with the cumulative norm, the monolith
  configs of tests/test_torch_monolith.py and the card tests' spec: every
  unit in one block, blocks by section, tiles covering the batch, each
  block's regions inside its 232,448 bytes;
- the packed weights decode, lane by lane through mma.sync's fragment
  layout, to the matrices the kernel's accumulators expect;
- kernels D and E (csrc/gsu_train_fwd.cu, gsu_train_bwd.cu) split the
  units over a cluster as ops/gsu_kernels.train_plan lays out: every unit in
  one block, every shared-memory region inside 232,448 bytes, at every
  training shape and up to the rows the plan states, and a refusal beyond;
  train_pack's fragments, read through the accumulators' element mapping,
  give each unit's recurrent gates (D, E) and each unit's row of W_hh (E's
  dh), float32 weights as three bf16 terms that add up exactly;
- kernels A, B and F (csrc/gsu_eval_mma.cuh; A and F one kernel,
  csrc/gsu_eval_stack.cuh) at every bench and card-test shape: stack_x_plan
  (F's rows, A's (unit, row) columns) and sections_plan cover every column
  once, in one wave at the bench where the plan says so, and refuse what
  the kernels do not take; A's tiles that cross a unit boundary find each
  column through the kernel's own index arithmetic; stack_pack,
  stack_x_pack and sections_pack decode through the fragment layout, and
  A's layer-0 gates seed the accumulator rows those weights feed.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from spiking_fullsubnet_torch.models import spiking_fullsubnet as P
from spiking_fullsubnet_torch.models import stream_forward as sf
from spiking_fullsubnet_torch.models.presets import flagship_m
from spiking_fullsubnet_torch.ops import gsu_kernels as gk

ZOO_M = Path(__file__).resolve().parent.parent / "model_zoo/intel_ndns/spike_fsb/baseline_m.npz"
BLOCK_SMEM = 232448  # bytes of shared memory an H100 block can have
BF16, F32 = torch.bfloat16, torch.float32

# ------------------------------------------------------------------ dW

# (T, R, H, G) of the main paths at batch 64 x 6 s (T = 751)
DW_MAIN = {
    "fullband (flagship M, zoo M)": (751, 64, 320, 320),
    "section 0": (751, 512, 224, 224),
    "section 1": (751, 192, 224, 224),
    "section 2": (751, 128, 224, 224),
    "baseline L section 0": (751, 1024, 256, 256),
    "baseline L section 1": (751, 1536, 256, 256),
    "cIRM-GSN": (751, 64, 256, 256),
    "unshared, G = 2H": (751, 64, 224, 448),
}
DW_EDGE = {"T = 1": (1, 5, 24, 24), "R = 1": (30, 1, 24, 48), "ragged": (40, 5, 37, 74)}


def _covered(T, R, splits, chunk):
    """How many splits sum each of the K = (T-1) R rows."""
    K = (T - 1) * R
    seen = np.zeros(K, dtype=np.int64)
    for s in range(splits):
        seen[min(K, s * chunk):min(K, (s + 1) * chunk)] += 1
    return seen


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(DW_MAIN.values()) + list(DW_EDGE.values()),
                         ids=list(DW_MAIN) + list(DW_EDGE))
def test_dw_split_plan_covers_every_row_once(shape, io):
    T, R, H, G = shape
    splits, chunk = gk.dw_split_plan(T, R, H, G, io)
    assert splits >= 1 and chunk >= 1
    assert (_covered(T, R, splits, chunk) == 1).all()
    if shape in DW_MAIN.values():  # fills the card: a multiple of its SMs, enough rows a split
        tile = gk.DW_TILE[io]
        blocks = -(-H // tile) * -(-G // tile) * splits
        assert blocks % gk.H100_SMS == 0, blocks
        assert chunk >= gk.DW_MIN_ROWS


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e4])
def test_dw_three_way_bf16_split_is_exact(scale):
    """The dW kernel's float32 dxg as hi + mid + lo, each the bf16 rounding
    of what the terms before it leave: every residual is exact in float32
    and the three terms add back to the value exactly. (Below about 2^-110
    the lo term falls among the subnormals and keeps fewer bits: an error
    under 2^-133 a value.)"""
    x = (torch.from_numpy(np.random.default_rng(7).standard_normal(100000)) * scale).float()
    hi = x.bfloat16()
    r1 = x - hi.float()
    mid = r1.bfloat16()
    r2 = r1 - mid.float()
    lo = r2.bfloat16()
    assert torch.equal(r1.double(), x.double() - hi.double())
    assert torch.equal(r2.double(), r1.double() - mid.double())
    assert torch.equal(lo.float(), r2)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())


# ------------------------------------------------------------------ kernel C

# tests/test_torch_monolith.py's tiny configuration and its norms
TINY_KW = dict(
    n_fft=128, hop_length=32, win_length=128,
    fb_input_size=16, fb_hidden_size=24, fb_proj_size=16,
    sb_hidden_size=20, freq_cutoffs=(0, 8, 32, 64),
    df_orders=(2, 1, 3), center_freq_sizes=(2, 8, 16),
    neighbor_freq_sizes=(3, 3, 3),
    fb_center_freq_sizes=(2, 8, 16), fb_neighbor_freq_sizes=(0, 0, 0), bn=True)
TINY_NORMS = {
    "ln": dict(norm_type=None, use_pre_layer_norm_fb=True, use_pre_layer_norm_sb=True),
    "cum": dict(norm_type="cumulative_laplace_norm", use_pre_layer_norm_fb=False,
                use_pre_layer_norm_sb=False),
    "raw": dict(norm_type=None, use_pre_layer_norm_fb=False, use_pre_layer_norm_sb=False),
}


def _spec_of(cfg, model, seconds=0.1):
    """Kernel C's spec as the serving path builds it, for ``model`` at ``cfg``."""
    box = []

    def grab(mono, chunks):
        box.append(mono)
        raise StopIteration

    real = sf.sfsb_monolith_serve
    sf.sfsb_monolith_serve = grab
    try:
        with torch.no_grad():
            P.spiking_fullsubnet_apply(cfg, model.param_tree(), model.state_tree(),
                                       torch.zeros(1, int(16000 * seconds)))
    except StopIteration:
        pass
    finally:
        sf.sfsb_monolith_serve = real
    assert box, "the configuration did not take kernel C"
    return box[0]


def _card_test_spec(shared, L, Lf):
    """tests/test_torch_cuda_kernels.py's _mono geometry (n_fft 64, three
    sections), random weights on the CPU."""
    g = torch.Generator().manual_seed(0)
    H, Hf, n_fft, Fin, Pfb = 40, 48, 64, 8, 8
    G, Gf = (H, Hf) if shared else (2 * H, 2 * Hf)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    secs = []
    for n, ctr, df, a0, aw in [(3, 2, 3, 0, 7), (2, 4, 1, 3, 12), (2, 9, 2, 12, 20)]:
        secs.append({"wa": rn(n, aw, G), "a0": a0, "wb": rn(n, Pfb, G), "uv": rn(2, G),
                     "wihr": rn(max(L - 1, 1), H, G), "whh": rn(L, H, G), "coef": rn(L, 4, H),
                     "wproj": rn(H, 2 * df * ctr), "bproj": rn(2 * df * ctr), "ctr": ctr,
                     "df": df})
    fb = {"wa": rn(Fin, Gf), "uv": rn(2, Gf), "wihr": rn(max(Lf - 1, 1), Hf, Gf),
          "whh": rn(Lf, Hf, Gf), "coef": rn(Lf, 4, Hf), "wproj": rn(Hf, Pfb), "bproj": rn(Pfb),
          "hidden": Hf}
    wdft, widft = gk.monolith_dft_matrices(n_fft, torch.float32)
    return {"norm": "ln", "n_fft": n_fft, "hop": n_fft // 4, "eps": 2.2e-16, "t_real": 8,
            "wdft": wdft, "widft": widft, "sel_mag": rn(32, 8), "sel_fb": rn(Pfb, 8), "fb": fb,
            "secs": secs, "hidden": H, "shared": shared}


def _specs():
    """name -> a function giving the spec (built lazily: the full-width ones
    take a second)."""
    def flag():
        base = flagship_m(seed=0, device="cpu", scan_mode="auto",
                          collect_layer_outputs=False)["config"]
        return _spec_of(base, P.SpikingFullSubNet.from_init(base, seed=0, device="cpu"))

    def zoo_cum():
        cfg = replace(P.separator_config(norm_type="cumulative_laplace_norm",
                                         shared_weights=True, bn=True),
                      scan_mode="auto", collect_layer_outputs=False)
        return _spec_of(cfg, P.SpikingFullSubNet.from_npz(str(ZOO_M), cfg, device="cpu"))

    def tiny(norm, shared):
        def build():
            cfg = P.SpikingFullSubNetConfig(**TINY_KW, **TINY_NORMS[norm], shared_weights=shared,
                                            scan_mode="auto", collect_layer_outputs=False)
            return _spec_of(cfg, P.SpikingFullSubNet.from_init(cfg, seed=0, device="cpu"))
        return build

    out = {"flagship M": flag, "zoo M cumulative norm": zoo_cum}
    for norm in TINY_NORMS:
        for shared in (True, False):
            out[f"tiny {norm} {'shared' if shared else 'unshared'}"] = tiny(norm, shared)
    for shared in (True, False):
        for L in (1, 2, 3):
            out[f"card spec L{L} {'shared' if shared else 'unshared'}"] = (
                lambda shared=shared, L=L: _card_test_spec(shared, L, 1 + L % 3))
    return out


SPECS = _specs()
_CACHE = {}


def _spec(name):
    if name not in _CACHE:
        _CACHE[name] = SPECS[name]()
    return _CACHE[name]


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(SPECS))
def test_monolith_plan_fits_and_assigns_every_unit_once(name, io):
    mono = _spec(name)
    secs = mono["secs"]
    for B in (1, 9, 256, 257):
        plan = gk.monolith_plan(mono, B, io)
        rt, blocks = plan["rt"], plan["blocks"]
        assert rt in (8, 16) and plan["tiles"] * rt >= B > (plan["tiles"] - 1) * rt
        assert 3 <= plan["nblk"] == len(blocks) <= gk.MONO_MAX_BLOCKS
        assert [b["role"] for b in blocks[:2]] == ["io", "fullband"]
        assert all(b["role"] == "units" for b in blocks[2:])
        # every unit once, each block one section's consecutive units, at
        # most 64 columns (units x rows) a block
        seen = [np.zeros(int(s["wa"].shape[0]), dtype=np.int64) for s in secs]
        for b in blocks[2:]:
            n = int(secs[b["sec"]]["wa"].shape[0])
            assert 1 <= b["nb"] and b["jj0"] + b["nb"] <= n
            assert b["nb"] * rt <= gk.MONO_MAX_N
            seen[b["sec"]][b["jj0"]:b["jj0"] + b["nb"]] += 1
        assert all((s == 1).all() for s in seen)
        # shared memory: ordered 16-byte-aligned regions inside the block's
        # total, which fits the card beside the kernel's static counters
        for b in blocks:
            o = b["o"]
            assert all(x % 16 == 0 for x in o) and o == sorted(o) and o[-1] < b["smem"]
            assert b["smem"] + 128 <= BLOCK_SMEM


def test_monolith_plan_at_flagship_m_is_one_wave_of_six_block_clusters():
    """Flagship M at the bench's 256 rows: 16 row tiles of 16 rows and
    clusters of 6 blocks (the io and fullband blocks, four unit blocks: two
    of section 0's 8 units, section 1's 3, section 2's 2). An H100 holds 17
    such clusters at once (cudaOccupancyMaxActiveClusters, which
    chip_smoke.py prints), 15 of 8."""
    for io in (BF16, F32):
        plan = gk.monolith_plan(_spec("flagship M"), 256, io)
        assert (plan["rt"], plan["tiles"], plan["nblk"]) == (16, 16, 6)
        assert [(b["sec"], b["jj0"], b["nb"]) for b in plan["blocks"][2:]] == [
            (0, 0, 4), (0, 4, 4), (1, 0, 3), (2, 0, 2)]


# ------------------------------------------------------------------ C's packed weights


def _a_from_fragments(frag):
    """[Mt, Kt, 32, 8] mma.sync m16n8k16 A fragments back to A [16 Mt, 16 Kt],
    through the PTX ISA's layout: lane = 4 groupID + threadID_in_group;
    registers a0..a3 hold (row groupID, cols 2t, 2t+1), (row groupID + 8,
    same cols), (row groupID, cols 2t + 8, 2t + 9), (row groupID + 8, ...),
    the lower column in the lower half."""
    Mt, Kt = frag.shape[:2]
    a = torch.zeros(Mt * 16, Kt * 16, dtype=frag.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for reg in range(4):
            row = g + 8 * (reg % 2)
            col = 2 * t + 8 * (reg // 2)
            for half in range(2):
                for mt in range(Mt):
                    for kt in range(Kt):
                        a[mt * 16 + row, kt * 16 + col + half] = frag[mt, kt, lane, 2 * reg + half]
    return a


def _gate_columns(mt, H, shared):
    """The gate column of each of m-tile mt's 16 accumulator rows, as the
    kernel's gate_unit reads them (-1: a pad row)."""
    cols = []
    for r in range(16):
        if shared:
            j = 16 * mt + r
            cols.append(j if j < H else -1)
        else:
            j = 8 * mt + r % 8
            cols.append(-1 if j >= H else (j if r < 8 else H + j))
    return cols


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("kparts", [[20], [7, 12], [24, 24]])
def test_monolith_packed_weights_decode_to_the_gate_matrix(io, shared, kparts):
    """A layer-0 or recurrent gate matrix W [K, G] (K a concatenation of
    inputs, each padded to 16 rows) packed for kernel C: decoded through the
    fragment layout (bf16) or the [m-tile][k][16] layout (float32) and read
    through the accumulators' gate columns, it multiplies a padded input as
    W does."""
    H = 20
    G = H if shared else 2 * H
    g = torch.Generator().manual_seed(sum(kparts) + shared)
    w = torch.randn(sum(kparts), G, generator=g).to(io)
    flat, kt, mt = gk._pack_mat(w, kparts, (H, shared), io)
    if io == BF16:
        a = _a_from_fragments(flat.view(mt, kt, 32, 8))
    else:
        a = flat.view(mt, kt * 16, 16).permute(0, 2, 1).reshape(mt * 16, kt * 16)
    x = torch.randn(5, sum(kparts), generator=g).to(io)
    xp = torch.cat([torch.cat([part, part.new_zeros(5, -(-k // 16) * 16 - k)], dim=1)
                    for part, k in zip(x.split(kparts, dim=1), kparts)], dim=1)
    got = xp.double() @ a.double().T  # [5, 16 mt]: the accumulators' rows as columns
    ref = x.double() @ w.double()
    for q in range(mt):
        for r, col in enumerate(_gate_columns(q, H, shared)):
            if col < 0:
                assert not got[:, 16 * q + r].any()
            else:
                assert torch.equal(got[:, 16 * q + r], ref[:, col])


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
def test_monolith_packed_plain_matrix_keeps_column_order(io):
    """A DFT or projection matrix keeps its columns, padded to 16."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn(37, 21, generator=g).to(io)
    flat, kt, mt = gk._pack_mat(w, [37], None, io)
    assert (kt, mt) == (3, 2)
    if io == BF16:
        a = _a_from_fragments(flat.view(mt, kt, 32, 8))
    else:
        a = flat.view(mt, kt * 16, 16).permute(0, 2, 1).reshape(mt * 16, kt * 16)
    assert torch.equal(a[:21, :37], w.T) and not a[21:].any() and not a[:, 37:].any()


def test_monolith_pack_lays_every_matrix_once():
    """monolith_pack's table: every matrix at its own offset, one after the
    other, each a whole number of 16 x 16 tiles; a section's units' layer-0
    matrices equally sized and consecutive (the kernel steps between them)."""
    mono = _spec("tiny ln unshared")
    flat, table = gk.monolith_pack(mono, BF16)
    spans = sorted((off, off + kt * mt * 256) for off, kt, mt in table.values())
    assert spans[0][0] == 0 and spans[-1][1] == flat.numel()
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for i, s in enumerate(mono["secs"]):
        offs = [table[f"s{i}_win{jj}"][0] for jj in range(int(s["wa"].shape[0]))]
        assert len(set(np.diff(offs))) <= 1


# ------------------------------------------------------------------ D and E: the unit split

# (R, H) of every GSU layer that trains at batch 64 x 6 s (PERF.md section 4):
# flagship M and zoo M (fullband, sections 0-2), cIRM-GSN, baseline L's sections
TRAIN_MAIN = {"fullband": (64, 320), "section 0": (512, 224), "section 1": (192, 224),
              "section 2": (128, 224), "cIRM-GSN": (64, 256), "baseline L section 0": (1024, 256),
              "baseline L section 1": (1536, 256)}
# the most rows the plan takes (D's spike bits of two steps and its tiles fill
# the block), the former kernels' limits, and shapes it must refuse
TRAIN_MOST = {256: 3304, 320: 2608, 224: 3776}
TRAIN_FORMER = [(1792, 256), (1408, 320)]
TRAIN_REFUSED = [(3305, 256), (2609, 320), (2048, 512)]


def _regions(plan, kernel):
    """(name, start, size) of every shared-memory region the plan places."""
    nb, J, Rp, JT, nterm = plan["nblk"], plan["J"], plan["Rp"], plan["JT"], plan["nterm"]
    gtile = 1024 if (kernel == "fwd" and nterm == 3) else 512 * nterm
    bits = 2 * nb * Rp * 2 * JT if kernel == "fwd" else 0
    out = [("bits", plan["o_bits"], bits), ("vec", plan["o_vec"], 8 * J * 4),
           ("part", plan["o_part"], 2 * gk.TRAIN_WARPS * J * 4)]
    if kernel == "fwd":
        out.append(("pre", plan["o_pre"], gk.TRAIN_WARPS * 8 * plan["ngb"] * gk.TRAIN_PRE_LD * 4))
    else:
        assert plan["o_pre"] == -1
    if plan["o_wg"] >= 0:
        out.append(("wg", plan["o_wg"], plan["MT"] * plan["KT"] * gtile))
    if plan["o_wd"] >= 0:
        out.append(("wd", plan["o_wd"], plan["MTd"] * plan["KTg"] * 512 * nterm))
    out += [(f"state{k}", o, Rp * plan["ldJ"] * 4) for k, o in enumerate(plan["o_state"]) if o >= 0]
    return out


def _check_plan(plan, R, H, shared, kernel):
    J, nb = plan["J"], plan["nblk"]
    assert plan["fits"]
    assert J % 16 == 0 and J <= 32 and 1 <= nb <= gk.TRAIN_MAX_CLUSTER  # the row layout's 32 lanes
    assert (nb - 1) * J < H <= nb * J  # every unit in one block, no empty block
    assert plan["MT"] == (J // 16 if shared else J // 8) and plan["MTd"] == J // 16
    assert plan["KT"] * 16 >= H > plan["KT"] * 16 - 16
    assert plan["Rp"] % 8 == 0 and R <= plan["Rp"] < R + 8 and plan["ngb"] in (1, 2, 4)
    assert plan["ldJ"] >= J
    regs = sorted(_regions(plan, kernel), key=lambda r: r[1])
    assert all(start % 16 == 0 for _, start, _ in regs)
    assert all(a[1] + a[2] <= b[1] for a, b in zip(regs, regs[1:]))  # no overlap
    assert regs[-1][1] + regs[-1][2] == plan["smem"] <= BLOCK_SMEM


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(TRAIN_MAIN.values()), ids=list(TRAIN_MAIN))
def test_train_plan_splits_every_training_shape(shape, io, kernel):
    """At every main-path shape (shared weights, as every training config):
    the plan fits, every unit lies in one block, and the packed gate weights
    stay in shared memory for the whole sequence (D's gate columns, E's dh
    rows); D's membranes too up to section 0's 512 rows, and E's dh and dc
    at flagship M's and zoo M's sections with bf16 streams."""
    R, H = shape
    plan = gk.train_plan(R, H, True, io, kernel)
    _check_plan(plan, R, H, True, kernel)
    assert plan["o_wg" if kernel == "fwd" else "o_wd"] >= 0
    if kernel == "fwd" and R <= 512:
        assert plan["o_state"][0] >= 0
    if kernel == "bwd" and io == BF16 and (R, H) in ((512, 224), (192, 224), (128, 224)):
        assert min(plan["o_state"]) >= 0
    # the busiest warp's row groups: the fewest a batch size allows (every
    # training shape has room for D's tiles at that batch)
    NG = plan["Rp"] // 8
    busiest = -(-(-(-NG // plan["ngb"])) // gk.TRAIN_WARPS) * plan["ngb"]
    assert busiest == min(-(-(-(-NG // b)) // gk.TRAIN_WARPS) * b for b in (1, 2, 4))


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shared", [True, False])
def test_train_plan_takes_its_stated_rows_and_refuses_beyond(shared, io, kernel):
    """The rows the plan takes at H 224, 256 and 320 (TRAIN_LIMITS), the
    former kernels' limits (1792 rows at H 256, 1408 at H 320) and odd
    widths; the plan refuses one row group more, and H 512 at 2048 rows."""
    for H, R in TRAIN_MOST.items():
        _check_plan(gk.train_plan(R, H, shared, io, kernel), R, H, shared, kernel)
    for R, H in TRAIN_FORMER + [(37, 40), (100, 200), (13, 24), (1, 24), (5, 512)]:
        _check_plan(gk.train_plan(R, H, shared, io, kernel), R, H, shared, kernel)
    for R, H in TRAIN_REFUSED:  # D's spike bits; E keeps no bits in shared memory
        plan = gk.train_plan(R, H, shared, io, kernel)
        if kernel == "fwd":
            assert not plan["fits"] and gk._plan_c(plan, 5, "bn").smem > BLOCK_SMEM
        else:
            _check_plan(plan, R, H, shared, kernel)


def _acc_gates(mats, plan, h):
    """What the kernel's accumulators hold for the rows ``h [N, H]``: for
    each block and gate m-tile mt, A_mt h^T, read through the element
    mapping of csrc/gsu_train_mma.cuh (gate row gid + 8 (e / 2); shared:
    unit 16 mt + gid + 8 (e / 2); unshared: unit 8 mt + gid, its f gate at
    rows 0-7 and c at rows 8-15). Returns (pre_f, pre_c) [N, nblk J]."""
    nb, MT, KT, J = plan["nblk"], plan["MT"], plan["KT"], plan["J"]
    hp = torch.cat([h, h.new_zeros(h.shape[0], KT * 16 - h.shape[1])], dim=1)
    N = h.shape[0]
    pre_f = torch.zeros(N, nb * J, dtype=torch.float64)
    pre_c = torch.zeros(N, nb * J, dtype=torch.float64)
    for b in range(nb):
        for mt in range(MT):
            a = mats(b, mt)  # [16, KT 16]
            acc = hp @ a.T  # [N, 16]: the accumulators' gate rows as columns
            for gid in range(8):
                for half in range(2):
                    if plan["shared"]:
                        u = 16 * mt + gid + 8 * half
                        pre_f[:, b * J + u] = acc[:, gid + 8 * half]
                        pre_c[:, b * J + u] = acc[:, gid + 8 * half]
                    elif half == 0:
                        u = 8 * mt + gid
                        pre_f[:, b * J + u] = acc[:, gid]
                        pre_c[:, b * J + u] = acc[:, gid + 8]
    return pre_f, pre_c


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("H", [24, 40, 200])
def test_train_pack_gates_reach_each_unit_through_the_accumulators(H, shared, io, kernel):
    """D's and E's gate weights: a spike row h through the accumulators
    gives h @ W_hh at unit j's f and c columns (j and H + j unshared), zero
    past H. bf16 fragments (and E's float32 ones as hi + mid + lo, adding
    up to W_hh exactly), and D's float32 weights as floats [MT][KT 16][16]."""
    G = H if shared else 2 * H
    g = torch.Generator().manual_seed(H + shared)
    whh = torch.randn(H, G, generator=g).to(io)
    plan = gk.train_plan(5, H, shared, io, kernel)
    wg, _ = gk.train_pack(whh, plan, kernel)
    nt, K16 = plan["nterm"], plan["KT"] * 16
    if kernel == "fwd" and io == F32:
        assert wg.dtype == F32
        floats = wg.view(plan["nblk"], plan["MT"], K16, 16)
        terms = [lambda b, mt: floats[b, mt].T.double()]
    else:
        assert wg.dtype == BF16
        frags = wg.view(plan["nblk"], plan["MT"], plan["KT"], nt, 32, 8)
        terms = [lambda b, mt, t=t: _a_from_fragments(frags[b, mt, :, t].unsqueeze(0)).double()
                 for t in range(nt)]
    h = (torch.rand(6, H, generator=g) < 0.5).double()
    ref = h @ whh.double()
    total_f = total_c = 0
    for mats in terms:
        f, c = _acc_gates(mats, plan, h)
        total_f, total_c = total_f + f, total_c + c
    assert torch.equal(total_f[:, :H], ref[:, :H])
    assert torch.equal(total_c[:, :H], ref[:, :H] if shared else ref[:, H:])
    assert not total_f[:, H:].any() and not total_c[:, H:].any()


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("H", [24, 40, 200])
def test_train_pack_dh_rows_give_each_units_gradient(H, shared, io):
    """E's dh fragments: block b's m-tile mt, gate row gid + 8 (e / 2) is
    unit bJ + 16 mt + gid + 8 (e / 2); a drg row through them, its columns
    in the kernel's load order (lane t's k slots 2t, 2t + 1, 2t + 8, 2t + 9
    are columns 4t .. 4t + 3 of the tile), gives drg @ W_hh^T at that unit,
    zero past H (and for the padded gate columns)."""
    assert sorted(gk.DH_K_ORDER) == list(range(16))
    for t in range(4):
        assert [gk.DH_K_ORDER[s] for s in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)] == \
            [4 * t, 4 * t + 1, 4 * t + 2, 4 * t + 3]
    G = H if shared else 2 * H
    g = torch.Generator().manual_seed(3 * H + shared)
    whh = torch.randn(H, G, generator=g).to(io)
    plan = gk.train_plan(5, H, shared, io, "bwd")
    _, wd = gk.train_pack(whh, plan, "bwd")
    nt, KTg, J = plan["nterm"], plan["KTg"], plan["J"]
    frags = wd.view(plan["nblk"], plan["MTd"], KTg, nt, 32, 8)
    drg = torch.randn(6, G, generator=g).to(io).double()
    dp = torch.cat([drg, drg.new_zeros(6, KTg * 16 - G)], dim=1)
    # the mma's k slot s of tile kt holds drg's column 16 kt + DH_K_ORDER[s]
    order = torch.tensor([16 * kt + c for kt in range(KTg) for c in gk.DH_K_ORDER])
    dp = dp[:, order]
    got = torch.zeros(6, plan["nblk"] * J, dtype=torch.float64)
    for b in range(plan["nblk"]):
        for mt in range(plan["MTd"]):
            a = sum(_a_from_fragments(frags[b, mt, :, t].unsqueeze(0)).double() for t in range(nt))
            got[:, b * J + 16 * mt:b * J + 16 * mt + 16] = dp @ a.T
    ref = drg @ whh.double().T
    torch.testing.assert_close(got[:, :H], ref, rtol=1e-12, atol=1e-12)
    assert not got[:, H:].any()


# ------------------------------------------------------------------ B and F: the eval engine

# (R, F, H, L, shared) of every kernel-F launch of PERF.md section 4 (zoo M
# layered's four stacks, cIRM-GSN's one) and of the card tests
STACK_X_MAIN = {"zoo M fullband": (256, 64, 320, 2, True),
                "zoo M section 0": (2048, 38, 224, 2, True),
                "zoo M section 1": (768, 94, 224, 2, True),
                "zoo M section 2": (512, 158, 224, 2, True),
                "cIRM-GSN": (256, 257, 256, 2, True)}
STACK_X_CARD = [(13, 37, 40, 1), (21, 64, 320, 2), (17, 158, 224, 2), (9, 257, 256, 3),
                (8, 3, 512, 4), (37, 38, 224, 2), (11, 38, 224, 2), (5, 3, 40, 2),
                (1, 257, 48, 2), (257, 64, 320, 2), (64, 1024, 512, 4)]
STACK_X_REFUSED = [(8, 3, 513, 2), (8, 3, 40, 5), (8, 1025, 40, 2), (0, 3, 40, 2),
                   (8, 0, 40, 2)]


def _check_stack_x_plan(plan, R, F, H, L, shared):
    N, cs, mts = plan["N"], plan["cs"], plan["mts"]
    assert N in gk.STACK_X_COLS and cs in gk.STACK_X_CLUSTERS
    assert (plan["tiles"] - 1) * N < R <= plan["tiles"] * N  # every row in one tile
    assert plan["blocks"] == plan["tiles"] * cs
    assert mts == (-(-H // 16) if shared else -(-H // 8))
    assert (cs - 1) * plan["mpb"] < mts <= cs * plan["mpb"]  # every m-tile in one block
    es = 2 if plan["io"] == BF16 else 4
    Hp = plan["Hp"]
    assert Hp % 16 == 0 and H <= Hp < H + 16 and plan["ld_x"] >= F
    regs = [(plan["o_x"], 2 * N * plan["ld_x"] * es), (plan["o_spk"], 2 * L * N * (Hp + 8) * 2),
            (plan["o_mem"], L * N * (Hp + 4) * 4)]
    assert all(o % 16 == 0 for o, _ in regs)
    assert all(a[0] + a[1] <= b[0] for a, b in zip(regs, regs[1:]))
    assert regs[-1][0] + regs[-1][1] == plan["smem"] <= BLOCK_SMEM


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(STACK_X_MAIN.values()), ids=list(STACK_X_MAIN))
def test_stack_x_plan_at_the_main_paths_is_one_wave(shape, io):
    """Kernel F at each bench stack: every row and gate m-tile in one block,
    the regions inside 232,448 bytes, the blocks within the H100's 132 SMs
    (one wave), and a cluster only where a block's 16 warps would have more
    than one m-tile each (the fullband's 320 units)."""
    R, F, H, L, shared = shape
    plan = gk.stack_x_plan(R, F, H, L, shared, io)
    _check_stack_x_plan(dict(plan, io=io), R, F, H, L, shared)
    assert plan["blocks"] <= gk.SM_COUNT
    assert (plan["cs"] > 1) == (H == 320)
    assert -(-plan["mts"] // plan["cs"]) <= gk.EVAL_WARPS


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("shape", STACK_X_CARD, ids=[str(s) for s in STACK_X_CARD])
def test_stack_x_plan_at_the_card_tests_shapes(shape, shared, io):
    """The card tests' shapes (ragged row tiles, F 3-1024, H up to 512 with
    L 4, unshared weights): a plan that covers them, and one for every
    forced tile and cluster that fits."""
    R, F, H, L = shape
    _check_stack_x_plan(dict(gk.stack_x_plan(R, F, H, L, shared, io), io=io), R, F, H, L, shared)
    for N in gk.STACK_X_COLS:
        for cs in gk.STACK_X_CLUSTERS:
            try:
                plan = gk.stack_x_plan(R, F, H, L, shared, io, cols=N, cluster=cs)
            except ValueError:
                continue
            _check_stack_x_plan(dict(plan, io=io), R, F, H, L, shared)
            assert (plan["N"], plan["cs"]) == (N, cs)


@pytest.mark.parametrize("shape", STACK_X_REFUSED, ids=[str(s) for s in STACK_X_REFUSED])
def test_stack_x_plan_refuses_what_the_kernel_does_not_take(shape):
    R, F, H, L = shape
    with pytest.raises(ValueError, match="H 1..512"):
        gk.stack_x_plan(R, F, H, L, True, BF16)


def _stack_weights(L, H, shared, io, F=None):
    """Random (wih0 [F, G] when F, wihr, whh) of an L-layer stack."""
    G = H if shared else 2 * H
    g = torch.Generator().manual_seed(L + 10 * shared)
    wih0 = torch.randn(F, G, generator=g).to(io) if F else None
    wihr = torch.randn(max(L - 1, 1), H, G, generator=g).to(io)
    whh = torch.randn(L, H, G, generator=g).to(io)
    return wih0, wihr, whh


def _check_stack_pack(flat, table, wants, H, shared, io):
    """Every matrix of ``wants`` ({name: (W [K, G], k parts)}) at its own
    offset of ``flat``, one after the other; decoded through the fragment
    layout (bf16) or [m-tile][k][16] (float32) and read through the
    accumulators' gate columns it multiplies a padded input as W does,
    every pad row zero."""
    spans = sorted((off, off + kt * mt * 256) for off, kt, mt in table.values())
    assert spans[0][0] == 0 and spans[-1][1] == flat.numel()
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert set(table) == set(wants)
    g = torch.Generator().manual_seed(H)
    for name, (w, kparts) in wants.items():
        off, kt, mt = table[name]
        assert mt == (-(-H // 16) if shared else -(-H // 8))
        part = flat[off:off + kt * mt * 256]
        if io == BF16:
            a = _a_from_fragments(part.view(mt, kt, 32, 8))
        else:
            a = part.view(mt, kt * 16, 16).permute(0, 2, 1).reshape(mt * 16, kt * 16)
        x = torch.randn(3, sum(kparts), generator=g).to(io)
        xp = torch.cat([torch.cat([p, p.new_zeros(3, -(-k // 16) * 16 - k)], dim=1)
                        for p, k in zip(x.split(kparts, dim=1), kparts)], dim=1)
        got, ref = xp.double() @ a.double().T, x.double() @ w.double()
        for q in range(mt):
            for r, col in enumerate(_gate_columns(q, H, shared)):
                if col < 0:
                    assert not got[:, 16 * q + r].any()
                else:  # the same products, summed in another order
                    torch.testing.assert_close(got[:, 16 * q + r], ref[:, col], rtol=1e-12,
                                               atol=1e-12)


def _recurrent_wants(wihr, whh, H):
    """Layer 0's W_hh over h_0(t-1), each later layer's [W_ih; W_hh] over
    [h_{k-1}(t); h_k(t-1)]."""
    wants = {"rec0": (whh[0], [H])}
    for k in range(1, whh.shape[0]):
        wants[f"rec{k}"] = (torch.cat([wihr[k - 1], whh[k]]), [H, H])
    return wants


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("L", [1, 2, 4])
def test_stack_x_pack_decodes_to_the_stack(L, shared, io):
    """Kernel F's packed weights, decoded through the fragment layout (bf16)
    or [m-tile][k][16] (float32) and read through the accumulators' gate
    columns: layer 0's W_ih0 over x, each layer's recurrent product over
    [h_{k-1}(t); h_k(t-1)], every pad row zero."""
    H, F = 24, 19
    wih0, wihr, whh = _stack_weights(L, H, shared, io, F)
    flat, table = gk.stack_x_pack(wih0, wihr, whh, H, shared)
    _check_stack_pack(flat, table, {"in": (wih0, [F]), **_recurrent_wants(wihr, whh, H)}, H,
                      shared, io)


# ------------------------------------------------------------------ A: F's plan over (unit, row) columns

# (U, R, H, L, shared) of every kernel-A launch of PERF.md section 4: zoo M
# served's fullband (3-D, the last layer out) and the collect path's four
# (flagship M: the fullband, then each section's units form, every layer)
STACK_A_MAIN = {"zoo M served fullband": (1, 256, 320, 2, True),
                "flagship M collect section 0": (8, 256, 224, 2, True),
                "flagship M collect section 1": (3, 256, 224, 2, True),
                "flagship M collect section 2": (2, 256, 224, 2, True)}
# the card tests' shapes (tests/test_torch_cuda_kernels.py's A_EDGES), and
# units forms whose row count is no multiple of any tile
STACK_A_CARD = [(1, 1, 224, 2, True), (3, 13, 48, 2, False), (5, 7, 40, 2, False),
                (1, 11, 512, 4, False), (1, 256, 320, 2, True), (1, 21, 320, 2, False),
                (8, 33, 320, 2, True), (2, 13, 40, 2, True), (3, 9, 64, 3, True),
                (37, 1, 24, 1, True), (6, 50, 16, 2, False), (2, 9, 13, 2, True)]


def _a_gates(U, R, H, shared, T=2):
    G = H if shared else 2 * H
    return torch.empty((U, T, R, G) if U > 1 else (T, R, G))


def _fastdiv(d, n):
    """csrc/gsu_eval_mma.cuh's FastDiv: n / d by a 32-bit multiply-high and a
    shift, on numpy's uint64 (n < 2^31)."""
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    n = np.asarray(n, dtype=np.uint64)
    return ((((n * np.uint64(m)) >> np.uint64(32)) + n) >> np.uint64(s)).astype(np.int64)


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(STACK_A_MAIN.values()), ids=list(STACK_A_MAIN))
def test_stack_plan_of_kernel_a_is_one_wave(shape, io):
    """Kernel A at each bench launch: the U R (unit, row) columns in one
    wave of blocks, every gate m-tile in one block, the regions inside
    232,448 bytes; zoo M's served fullband (256 rows x 320 units, 20
    m-tiles) in 8 columns a block and clusters of 2."""
    U, R, H, L, shared = shape
    G = H if shared else 2 * H
    plan = gk._stack_a_plan(_a_gates(U, R, H, shared), H, L, shared)
    _check_stack_x_plan(dict(plan, io=io), U * R, G, H, L, shared)
    assert plan["blocks"] <= gk.SM_COUNT
    assert -(-plan["mts"] // plan["cs"]) <= gk.EVAL_WARPS
    if H == 320:
        assert (plan["N"], plan["cs"], plan["blocks"]) == (8, 2, 64)
    else:
        assert plan["cs"] == 1 and plan["N"] == (16 if U * R > 8 * gk.SM_COUNT else 8)


@pytest.mark.parametrize("shape", STACK_A_CARD + list(STACK_A_MAIN.values()),
                         ids=[str(s) for s in STACK_A_CARD] + list(STACK_A_MAIN))
def test_stack_plan_of_kernel_a_covers_every_column_once(shape):
    """Under every plan the kernel can take, its tiles cover each (unit,
    row) pair once, tiles crossing unit boundaries included, and the
    kernel's index arithmetic (FastDiv by R, G, the tile's output items and
    H's 8-unit groups) finds each column's gates and spikes at ((u T + t) R
    + r) of xg0 [U, T, R, G] and out [(L,) U, T, R, H]."""
    U, R, H, L, shared = shape
    G, T = (H if shared else 2 * H), 3
    hb = -(-H // 8)
    for N in gk.STACK_X_COLS:
        for cs in gk.STACK_X_CLUSTERS:
            try:
                plan = gk._stack_a_plan(_a_gates(U, R, H, shared, T), H, L, shared, cols=N,
                                        cluster=cs)
            except ValueError:
                continue
            seen = np.zeros(U * R, dtype=np.int64)
            for tile in range(plan["blocks"] // cs):
                col0 = tile * N
                cols = min(N, U * R - col0)
                assert cols >= 1
                c = col0 + np.arange(cols)
                seen[c] += 1
                u = _fastdiv(R, c)
                assert (u == c // R).all()
                # the staged items n G + k, and the output items q per + n hb + c8
                i = np.arange(cols * G)
                assert (_fastdiv(G, i) == i // G).all()
                per = cols * hb
                i = np.arange(L * per)
                assert (_fastdiv(per, i) == i // per).all()
                assert (_fastdiv(hb, i % per) == (i % per) // hb).all()
                for t in range(T):
                    rows = (u * T + t) * R + (c - u * R)
                    want = np.array([np.ravel_multi_index((cc // R, t, cc % R), (U, T, R))
                                     for cc in c])
                    assert (rows == want).all()
            assert (seen == 1).all(), (N, cs)


@pytest.mark.parametrize("case", ["H 513", "L 5", "shared memory"])
def test_stack_plan_of_kernel_a_refuses_what_the_kernel_does_not_take(case):
    """Beyond H 512 or L 4, or a forced tile whose regions pass 232,448
    bytes (64 columns at H 512 and L 4, unshared), the plan raises."""
    if case == "shared memory":
        with pytest.raises(ValueError, match="232,448 bytes"):
            gk._stack_a_plan(_a_gates(1, 64, 512, False), 512, 4, False, cols=64)
        return
    H, L = (513, 2) if case == "H 513" else (40, 5)
    with pytest.raises(ValueError, match="H 1..512"):
        gk._stack_a_plan(_a_gates(3, 8, H, True), H, L, True)


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("L", [1, 2, 4])
def test_stack_pack_decodes_to_the_stack(L, shared, io):
    """Kernel A's packed weights: the recurrent and inter-layer matrices of
    kernel F's pack, without its layer-0 input matrix."""
    H = 40
    _, wihr, whh = _stack_weights(L, H, shared, io)
    flat, table = gk.stack_pack(wihr, whh, H, shared)
    _check_stack_pack(flat, table, _recurrent_wants(wihr, whh, H), H, shared, io)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("H", [24, 40, 224, 320])
def test_kernel_a_seeds_each_accumulator_with_its_gate(H, shared):
    """csrc/gsu_eval_stack.cuh's seed_gates reads accumulator element (i,
    e) of m-tile mt from xg0's column (shared or e < 2 ? j : H + j), j =
    gate_unit(mt, gid, e): for every real accumulator row that is the gate
    column the packed weights give that row, so layer 0's pre-activation
    is xg0 plus the recurrent product, as in the plain version."""
    mts = -(-H // 16) if shared else -(-H // 8)
    for mt in range(mts):
        want = _gate_columns(mt, H, shared)
        for gid in range(8):
            for e in range(4):
                j = mt * 16 + gid + 8 * (e >> 1) if shared else mt * 8 + gid
                col = j if shared or e < 2 else H + j
                row = gid + 8 * (e >> 1)
                if want[row] >= 0:
                    assert col == want[row]
                else:  # a pad unit: the cell never reads it; the read stays in the tile's row
                    assert j >= H and col < -(-(H if shared else 2 * H) // 16) * 16 + 8


def _card_sections(n0=3, H=48, shared=True):
    """tests/test_torch_cuda_kernels.py's _sections geometry (xb of 16)."""
    G = H if shared else 2 * H
    g = torch.Generator().manual_seed(n0)
    secs = []
    for n, ctr, df, aw in [(n0, 4, 3, 22), (2, 8, 1, 26), (2, 16, 2, 33)]:
        P = 2 * df * ctr
        secs.append({"wa": torch.randn(n, aw, G, generator=g), "wb": torch.randn(n, 16, G, generator=g),
                     "wihr": torch.randn(1, H, G, generator=g), "whh": torch.randn(2, H, G, generator=g),
                     "wproj": torch.randn(H, P, generator=g), "ctr": ctr, "df": df, "a0": 0})
    return secs


def _zoo_sections():
    mono = _spec("zoo M cumulative norm")
    return gk._sec_dims(mono["secs"], int(mono["fb"]["wproj"].shape[1]), mono["hidden"],
                        mono["shared"])


def _check_sections_plan(plan, d, B, io, df_mode):
    es = 2 if io == BF16 else 4
    assert plan["cols"] % 8 == 0 and plan["cols"] <= gk.EVAL_MAX_N
    assert len(plan["groups"]) <= gk.SECTIONS_MAX_GROUPS
    start = 0
    for si, _, _, first in plan["groups"]:  # a group's tiles are consecutive blocks
        assert first == start
        start += plan["secs"][si]["tiles"]
    assert plan["blocks"] == start
    for si, s in enumerate(d["secs"]):
        sp = plan["secs"][si]
        rt = sp["rt"]
        assert rt in gk.SECTIONS_ROWS and (sp["tiles"] - 1) * rt < B <= sp["tiles"] * rt
        mine = [g for g in plan["groups"] if g[0] == si]
        units = [jj for _, jj0, nb, _ in mine for jj in range(jj0, jj0 + nb)]
        assert units == list(range(s["n"]))  # every unit in one group, in order
        sizes = [nb for _, _, nb, _ in mine]
        assert max(sizes) - min(sizes) <= 1 and max(sizes) * rt <= plan["cols"]
        assert sp["nbm"] == max(sizes) and sp["dr"] == s["df"] + 2
        assert sp["ld_in"] == sp["awp"] + -(-d["Fb"] // 16) * 16 + 8 and sp["awp"] >= s["aw"]
        offs, total = gk._sec_regions(d, s, rt, sp["nbm"], es, df_mode)
        assert all(sp[f"o_{k}"] == v for k, v in offs.items()) and sp["smem"] == total
        assert total <= plan["smem"] <= BLOCK_SMEM
        N, Hp = sp["nbm"] * rt, plan["Hp"]
        sizes = {"x": 2 * rt * sp["ld_in"] * es, "sc": 4 * N * 4,
                 "sp": sp["dr"] * 2 * N * s["ctr"] * 4 if df_mode else 0,
                 "spk": 2 * d["L"] * N * (Hp + 8) * 2, "mem": d["L"] * N * (Hp + 4) * 4,
                 "ys": N * s["P"] * 4}
        regs = sorted((offs[k], n) for k, n in sizes.items())
        assert all(o % 16 == 0 for o, _ in regs)
        assert all(a[0] + a[1] <= b[0] for a, b in zip(regs, regs[1:]))
        assert regs[-1][0] + regs[-1][1] <= total


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B", [1, 9, 256, 257])
def test_sections_plan_at_zoo_m(B, io):
    """Kernel B at zoo M's 13 units of 2 x 224 (the served path, 1 x 2 s up
    to the bench's 256 rows and a ragged 257): every unit in one group,
    groups even within a section, the regions inside 232,448 bytes, the
    blocks within two waves of the H100's 132 SMs; at 256 rows every block
    one unit x 16 rows (208 blocks)."""
    d = _zoo_sections()
    assert [s["n"] for s in d["secs"]] == [8, 3, 2]
    for df_mode in (True, False):
        plan = gk.sections_plan(d, B, io, df_mode)
        _check_sections_plan(plan, d, B, io, df_mode)
        assert plan["blocks"] <= gk.SECTIONS_WAVES * gk.SM_COUNT
    plan = gk.sections_plan(d, 256, io)
    assert plan["cols"] == 16 and plan["blocks"] == 208
    assert all((p["rt"], p["nbm"]) == (16, 1) for p in plan["secs"])


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("case", ["card", "five units", "flagship M", "H 512 L 4"])
def test_sections_plan_at_the_card_tests_shapes(case, shared, io):
    """The card tests' sections (B 1, 9, 11, 257, 513; a section of five
    units, whose groups at 513 rows cannot be even; H 40 and 48 unshared),
    flagship M's sections and H 512 with L 4."""
    if case == "flagship M":
        mono = _spec("flagship M")
        d = gk._sec_dims(mono["secs"], int(mono["fb"]["wproj"].shape[1]), mono["hidden"], shared)
    elif case == "H 512 L 4":
        d = dict(gk._sec_dims(_card_sections(H=512, shared=shared), 16, 512, shared), L=4)
    else:
        secs = _card_sections(5 if case == "five units" else 3, 40, shared)
        d = gk._sec_dims(secs, 16, 40, shared)
    for B in (1, 9, 11, 257, 513):
        for df_mode in (True, False):
            _check_sections_plan(gk.sections_plan(d, B, io, df_mode), d, B, io, df_mode)
    if case == "five units":
        plan = gk.sections_plan(d, 513, io)
        assert sorted(nb for si, _, nb, _ in plan["groups"] if si == 0) == [2, 3]


def test_sections_plan_refuses_what_the_kernel_does_not_take():
    d = gk._sec_dims(_card_sections(), 16, 48, True)
    for bad in (dict(d, H=513), dict(d, L=5), dict(d, secs=d["secs"] * 3), dict(d, secs=[])):
        with pytest.raises(ValueError, match="H 1..512"):
            gk.sections_plan(bad, 4, BF16)
    with pytest.raises(ValueError, match="B >= 1"):
        gk.sections_plan(d, 0, BF16)


@pytest.mark.parametrize("io", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shared", [True, False])
def test_sections_pack_decodes_to_each_units_matrices(shared, io):
    """Kernel B's packed weights: a unit's layer-0 matrix [wa; wb] read
    through the gate columns; a section's units' matrices equally sized and
    consecutive (the kernel steps between them); the projection keeps its
    columns; every matrix once, one after the other."""
    H = 40
    secs = [{k: v.to(io) if isinstance(v, torch.Tensor) else v for k, v in s.items()}
            for s in _card_sections(3, H, shared)]
    flat, table = gk.sections_pack(secs, H, shared)
    spans = sorted((off, off + kt * mt * 256) for off, kt, mt in table.values())
    assert spans[0][0] == 0 and spans[-1][1] == flat.numel()
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))

    def dense(name):
        off, kt, mt = table[name]
        part = flat[off:off + kt * mt * 256]
        if io == BF16:
            return _a_from_fragments(part.view(mt, kt, 32, 8)).double(), mt
        return part.view(mt, kt * 16, 16).permute(0, 2, 1).reshape(mt * 16, kt * 16).double(), mt

    g = torch.Generator().manual_seed(5)
    for i, s in enumerate(secs):
        n, aw = s["wa"].shape[:2]
        offs = [table[f"s{i}_win{jj}"][0] for jj in range(n)]
        assert len(set(np.diff(offs))) <= 1
        for jj in range(n):
            a, mt = dense(f"s{i}_win{jj}")
            x = torch.randn(2, aw + 16, generator=g).to(io).double()
            xp = torch.cat([x[:, :aw], x.new_zeros(2, -(-aw // 16) * 16 - aw), x[:, aw:]], dim=1)
            got = xp @ a.T
            ref = x @ torch.cat([s["wa"][jj], s["wb"][jj]]).double()
            for q in range(mt):
                for r, col in enumerate(_gate_columns(q, H, shared)):
                    if col < 0:
                        assert not got[:, 16 * q + r].any()
                    else:
                        torch.testing.assert_close(got[:, 16 * q + r], ref[:, col], rtol=1e-12,
                                                   atol=1e-12)
        a, _ = dense(f"s{i}_proj")
        P = s["wproj"].shape[1]
        assert torch.equal(a[:P, :H], s["wproj"].double().T) and not a[P:].any()
