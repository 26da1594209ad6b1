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
  layout, to the matrices the kernel's accumulators expect.
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
