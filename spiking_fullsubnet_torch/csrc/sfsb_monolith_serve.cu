// Kernel C: the whole serving model in one launch — audio hop chunks in,
// enhanced hop chunks out.
//
// Replaces spiking_fullsubnet_tpu/ops/gsu_pallas.py: _monolith_kernel
// (:1626), called by sfsb_monolith_serve_pallas (:1885, pallas_call :2114).
//
// Per step t, for each batch row (F1 = n_fft/2 + 1 bins, F = F1 - 1):
//   frame  = chunks t..t+3 (n_fft = 4 hop samples)
//   re, im = frame @ wdft                  windowed DFT (hann folded in)
//   mag    = sqrt(sqrt(re^2 + im^2))       fdrc = 0.5; mag_io = mag rounded
//   s1, s2 = mag @ sel_mag, mag^2 @ sel_mag   per-unit statistics; column U
//                                          is the fullband input's mean
//   fullband: xg = mag_io[:Fin] @ wa_fb, scaled per norm
//            ("ln": rstd xg - rstd mu u + v, "cum": xg / (running mean + eps))
//            -> L_f GSU layers -> fb_y = h @ wproj_fb + bproj_fb
//   unit scales: "ln" alpha = rstd, beta = rstd mu over the unit's unfold
//            (magnitude and fb_y); "cum" alpha = 1 / (running mean + eps)
//   unit u: xg = alpha (mag_io[a0:a0+aw] @ wa[u] + fb_io @ wb[u]) [- beta u + v]
//            -> L GSU layers -> y = h @ wproj + bproj [2 df ctr]
//            -> deep filter over the last df spectrum frames (oldest at tap 0)
//   yf     = enh_io @ widft (inverse DFT, window over the COLA constant 3/2),
//            zero for frames t >= t_real
//   out[t] = yf_t[0:hop] + yf_{t-1}[hop:2hop] + yf_{t-2}[2hop:3hop]
//            + yf_{t-3}[3hop:4hop]
// Streams and weights are f32 or bf16; accumulation, membranes, statistics,
// the deep filter and the overlap-add are f32.
//
// What bounds it on an H100: at flagship M (batch 256 x 30 s, T + 3 = 3754
// steps, fullband 2 x 320, 13 units of 2 x 224, DFT and inverse DFT of
// 512 x 257 x 2) the bytes are small (audio in and out, about 0.5 GB, and
// 3.7 MB of bf16 weights) and the products a few TFLOP: the card's peak
// rates allow a few milliseconds. What limits it is the chain of 3754
// dependent steps, each a sequence of dependent products whose weights
// stream from L2 (they fit the 50 MB L2 many times over, not one SM's
// shared memory).
//
// Design (the host's plan, ops/gsu_kernels.monolith_plan, sizes everything
// below and hands every shared-memory offset to the kernel; the numbers are
// an H100 80GB HBM3 at 700 W, chip_smoke.py):
//   - One wave. A thread-block cluster owns a tile of RT rows (16; 8 where
//     a block would not fit): an io block, a fullband block and the unit
//     blocks. A unit block holds as many of one section's units as 64
//     columns (units x rows) allow, so flagship M needs 6 blocks a cluster
//     and its 256 rows 16 clusters, all resident (the card holds 17 such
//     clusters, 15 of 7 or 8 blocks). One block per SM; each block's shared
//     memory holds only its own stage's buffers.
//   - A pipeline across the cluster: the io block runs step t's front
//     (chunk in, DFT, magnitude, the magnitude's statistics) and step
//     t - 3's back (inverse DFT, overlap-add), the fullband block step
//     t - 1 (fullband stack and projection, unit scales), the unit blocks
//     step t - 2. Each stage pushes its results into the next stages'
//     shared memory (distributed shared memory writes) in rings deep
//     enough for the steps in flight, and one cluster barrier a step
//     orders the hand-offs: a step costs the slowest block (the unit
//     blocks at flagship M), not the sum of the stages. The cumulative
//     norm's running sums stay in the fullband block, the deep filter's
//     past frames in each unit block's spectrum ring.
//   - A section's units together: one fetch of the section's stack and
//     projection weights serves all units of the block, batched as more
//     columns of the product; each unit's own layer-0 weights multiply the
//     section's shared input window.
//   - No per-load latency chain. Every product is W^T X with the weights as
//     the left operand and the rows (times units) as the right: on bf16,
//     mma.sync m16n8k16 bf16 -> f32, the weights packed by the host in
//     fragment order so that each warp reads one coalesced 512-byte
//     fragment a 16 x 16 tile straight from L2 into registers, two batches
//     of PF tiles in flight; dense right operands through ldmatrix. Each
//     weight is used once per step and block, so staging it in shared
//     memory would add a copy without reuse. Spikes (0 or 1) are exact in
//     bf16; the magnitude, fullband output and enhanced spectrum are
//     rounded to the stream type where the reference rounds them, so only
//     the order of the float32 sums changes. The float32 mode runs the
//     same schedule with CUDA-core FMAs producing the same per-thread
//     outputs (TF32 would round its operands); the statistics (over the
//     unrounded magnitude and fullband output) are float32 FMAs in both.
//   - Membranes live in shared memory, each owned by the thread whose
//     accumulators produce its gates (the gate columns are permuted by the
//     host so that an unshared unit's f and c gates meet in one thread);
//     spikes are bits, double-buffered by step parity.
#include <cooperative_groups.h>

#include "gsu_common.cuh"

namespace cg = cooperative_groups;
using namespace gsu;

constexpr int MAX_SEC = 8;
constexpr int MAX_BLK = 16;   // blocks per cluster (above 8: non-portable)
constexpr int NTHREADS = 512;  // 16 warps: fewer, with more registers each, measured slower
constexpr int NWARPS = NTHREADS / 32;
constexpr int PF_F = 8;  // weight tiles loaded ahead per warp (two batches in flight)
constexpr int PF_U = 2;  // unit blocks of 6 or 8 n-groups: their accumulators need the registers
constexpr float LN_EPS = 1e-5f;

enum { NORM_RAW = 0, NORM_LN = 1, NORM_CUM = 2 };

// A packed weight matrix W [K, M] used as W^T: kt 16-row k-tiles, mt
// 16-column m-tiles, at element offset off of the packed buffer. bf16:
// [mt][kt][32 lanes][8] mma A fragments; f32: [mt][16 kt][16].
struct MonoMat {
  long long off;
  int kt, mt;
};

// Mirrored by _MonoSecC in ops/gsu_kernels.py (same field order).
struct MonoSec {
  int n, a0, aw, ctr, df, P, u0, f0, dr, ld_aw, kt_aw;
  MonoMat rec[3], proj, win;   // win: unit 0's layer-0 matrix; unit jj's at + jj win_size
  long long win_size, uv, coef, bproj;  // uv, coef, bproj: offsets in the f32 arrays
};

// Mirrored by _MonoBlkC. o[]: byte offsets of the block's shared-memory
// regions (see each stage), smem its total. Block 0 is the io block (front
// and back), block 1 the fullband block, blocks 2.. the unit blocks.
struct MonoBlk {
  int sec, jj0, nb, smem;  // unit blocks: section, first unit in it, units
  int o[8];
};

// Mirrored by _MonoArgs in ops/gsu_kernels.py (same field order).
struct MonoArgs {
  const void* chunks;  // [S + 3, B, hop] io
  float* out;          // [S, B, hop]
  const void* w;       // packed weights (io)
  const float* sel_mag;  // [F, U + 1]
  const float* sel_fb;   // [Pfb, U + 1]
  const float* fb_uv;    // [2, Gf] ("ln")
  const float* fb_coef;  // [Lf, 4, Hf]
  const float* fb_bproj; // [Pfb]
  const float* uv;       // sections' f32 arrays, flat
  const float* coef;
  const float* bproj;
  unsigned long long* prof;  // optional [blocks][8] clock64 cycles per stage phase (null: off)
  int S, B, hop, n_fft, Fin, Pfb, U, W, H, L, Hf, Lf, shared, norm, t_real, n_sec;
  float eps;
  int rt, nblk, Hp, Hfp, ld_dft, ld_fin, ld_pfb, ld_idft;
  MonoMat dft, idft, fb_in, fb_rec[3], fb_proj;
  MonoSec sec[MAX_SEC];
  MonoBlk blk[MAX_BLK];
};

template <typename IO> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T> __device__ __forceinline__ T* at(char* base, int off) {
  return reinterpret_cast<T*>(base + off);
}

// Optional stage profile: thread 0 of each block adds the cycles since its
// previous mark to phase j (shared-memory counters, written out at the end).
__shared__ unsigned long long prof_acc[9];
__device__ __forceinline__ void mark(const MonoArgs& a, int j) {
  if (a.prof != nullptr && threadIdx.x == 0) {
    const unsigned long long now = clock64();
    prof_acc[j] += now - prof_acc[8];
    prof_acc[8] = now;
  }
}

// ---- the right operand X [n][k]: rows n (tile rows, or units x rows), k
// the summed index; two parts, k-tiles [0, split) from p0 and the rest from
// p1 (a concatenation of inputs, each padded to whole k-tiles).
template <typename IO>
struct XDense {
  const IO* p0;
  const IO* p1;
  int ld0, ld1, split;
  __device__ __forceinline__ const IO* row(int n, int kt) const {
    return kt < split ? p0 + (size_t)n * ld0 + kt * 16 : p1 + (size_t)n * ld1 + (kt - split) * 16;
  }
  // the B fragment of row n, k-tile kt for lane column tig: k = 2 tig, +1; +8, +9
  __device__ __forceinline__ void frag(int n, int kt, int tig, uint32_t& b0, uint32_t& b1) const {
    const IO* p = row(n, kt) + 2 * tig;
    b0 = *reinterpret_cast<const uint32_t*>(p);
    b1 = *reinterpret_cast<const uint32_t*>(p + 8);
  }
  // the B fragments of n-groups i and i + 1 at k-tile kt in one ldmatrix:
  // b = {b0, b1 of group i, b0, b1 of group i + 1} (bf16 only)
  __device__ __forceinline__ void frag2(int i, int kt, int lane, uint32_t (&b)[4]) const {
    const int mat = lane >> 3;
    const IO* p = row(i * 8 + (mat >> 1) * 8 + (lane & 7), kt) + (mat & 1) * 8;
    const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                 : "r"(addr));
  }
  __device__ __forceinline__ float val(int n, int kt, int k) const { return ld(row(n, kt) + k); }
};

// Spikes, one bit each: row n's k-tile kt is two bytes at kt 2.
struct XSpk {
  const uint8_t* p0;
  const uint8_t* p1;
  int ld0, ld1, split;
  __device__ __forceinline__ const uint8_t* row(int n, int kt) const {
    return kt < split ? p0 + (size_t)n * ld0 + kt * 2 : p1 + (size_t)n * ld1 + (kt - split) * 2;
  }
  // the B fragment as two bf16 0.0 / 1.0 pairs: v * 0x8001 & 0x10001 moves
  // bit 1 of v to bit 16, times 0x3F80 makes each set bit a bf16 1.0
  __device__ __forceinline__ void frag(int n, int kt, int tig, uint32_t& b0, uint32_t& b1) const {
    const uint32_t bits = *reinterpret_cast<const uint16_t*>(row(n, kt));
    b0 = ((((bits >> (2 * tig)) & 3u) * 0x8001u) & 0x10001u) * 0x3F80u;
    b1 = ((((bits >> (2 * tig + 8)) & 3u) * 0x8001u) & 0x10001u) * 0x3F80u;
  }
  __device__ __forceinline__ void frag2(int i, int kt, int lane, uint32_t (&b)[4]) const {
    frag(i * 8 + (lane >> 2), kt, lane & 3, b[0], b[1]);
    frag(i * 8 + 8 + (lane >> 2), kt, lane & 3, b[2], b[3]);
  }
  __device__ __forceinline__ float val(int n, int kt, int k) const {
    return (float)((row(n, kt)[k >> 3] >> (k & 7)) & 1u);
  }
};

// d = a b with a zero accumulator
__device__ __forceinline__ void mma_bf16_0(float (&d)[4], const uint4& a, uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// One product W^T X into acc for m-tile mt. Thread (gid = lane / 4, tig =
// lane % 4) holds acc[i][e] for m = 16 mt + gid + 8 (e / 2) and n = 8 i +
// 2 tig + e % 2 (the mma accumulator layout), in both modes.
//   nu units (nu > 1: the unit blocks' layer-0 inputs): unit q's matrix is
//   at + q ustride elements, multiplies X's n-groups [0, gpu) and adds into
//   acc groups [q gpu, (q + 1) gpu); nu == 1: X's and acc's groups [0, gpu).
// The tiles of every unit stream as one sequence through two register
// batches of PF fragments: one multiplies while the other is in flight.
// Each pair of k-tiles (each k-tile, across units) is summed from zero by
// the tensor core and then added to acc in float32: accumulating a long sum
// in the tensor core drops low bits of the small terms against the large
// running sum, and the spike chaos of the recurrence turns that into
// visible divergence from the reference.
struct GemmArgs {
  long long off, ustride;
  int kt, mt, nu, gpu;
};

template <int NG, int PF, typename XS>
__device__ __forceinline__ void gemm_tile(float (&acc)[NG][4], const __nv_bfloat16* w,
                                          const GemmArgs& g, const XS& xs, int = 0, int = 0) {
  static_assert(PF % 2 == 0, "k-tiles are multiplied in pairs");
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const uint4* base = reinterpret_cast<const uint4*>(w + g.off) + (size_t)g.mt * g.kt * 32 + lane;
  uint4 fa[PF], fb[PF];
  if (g.nu == 1) {
    // one matrix over X's n-groups [0, gpu): each pair of k-tiles summed
    // from zero by the tensor core, then added in float32
    const int KT = g.kt;
    auto load = [&](uint4 (&f)[PF], int k0) {
#pragma unroll
      for (int q = 0; q < PF; ++q)
        f[q] = k0 + q < KT ? __ldg(base + (size_t)(k0 + q) * 32) : make_uint4(0, 0, 0, 0);
    };
    auto mul = [&](const uint4 (&f)[PF], int k0) {
#pragma unroll
      for (int q = 0; q < PF; q += 2) {
        const int k = k0 + q;
        if (k >= KT) break;
        const bool two = k + 1 < KT;
#pragma unroll
        for (int i = 0; i < NG; i += 2) {
          if (i >= g.gpu) continue;
          if (i + 1 < NG && i + 1 < g.gpu) {
            uint32_t b[4], c[4];
            xs.frag2(i, k, lane, b);
            float d0[4], d1[4];
            mma_bf16_0(d0, f[q], b[0], b[1]);
            mma_bf16_0(d1, f[q], b[2], b[3]);
            if (two) {
              xs.frag2(i, k + 1, lane, c);
              mma_bf16(d0, f[q + 1], c[0], c[1]);
              mma_bf16(d1, f[q + 1], c[2], c[3]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][e] += d0[e];
              acc[i + 1][e] += d1[e];
            }
          } else {
            uint32_t b0, b1;
            xs.frag(i * 8 + gid, k, tig, b0, b1);
            float d[4];
            mma_bf16_0(d, f[q], b0, b1);
            if (two) {
              xs.frag(i * 8 + gid, k + 1, tig, b0, b1);
              mma_bf16(d, f[q + 1], b0, b1);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] += d[e];
          }
        }
      }
    };
    load(fa, 0);
    for (int k0 = 0; k0 < KT; k0 += 2 * PF) {
      load(fb, k0 + PF);
      mul(fa, k0);
      load(fa, k0 + 2 * PF);
      mul(fb, k0 + PF);
    }
    return;
  }
  // nu unit matrices, their tiles as one stream: each k-tile summed from zero
  const int T = g.nu * g.kt;
  const long long ustr = g.ustride >> 3;
  int lu = 0, lk = 0, mu = 0, mk = 0;  // (unit, k-tile) cursors of the loads and the products
  auto load = [&](uint4 (&f)[PF], int t0) {
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      f[q] = t0 + q < T ? __ldg(base + lu * ustr + (size_t)lk * 32) : make_uint4(0, 0, 0, 0);
      if (++lk == g.kt) { lk = 0; ++lu; }
    }
  };
  auto mul = [&](const uint4 (&f)[PF], int t0) {
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      if (t0 + q >= T) break;
      const int g0 = mu * g.gpu;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        if (i < g0 || i >= g0 + g.gpu) continue;
        uint32_t b0, b1;
        xs.frag((i - g0) * 8 + gid, mk, tig, b0, b1);
        float d[4];
        mma_bf16_0(d, f[q], b0, b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += d[e];
      }
      if (++mk == g.kt) { mk = 0; ++mu; }
    }
  };
  load(fa, 0);
  for (int t0 = 0; t0 < T; t0 += 2 * PF) {
    load(fb, t0 + PF);
    mul(fa, t0);
    load(fa, t0 + 2 * PF);
    mul(fb, t0 + PF);
  }
}

// float32: the same outputs with CUDA-core FMAs in k order. Each segment
// of a unit's k (ending at k = split, at every multiple of period and at
// its end) is summed from zero and then added to acc, so that every
// float32 sum is the one kernel C's earlier per-thread version took (a
// product per input block, sequential over k, then added).
template <int NG, int PF, typename XS>
__device__ __forceinline__ void gemm_tile(float (&acc)[NG][4], const float* w,
                                          const GemmArgs& g, const XS& xs, int split = 0,
                                          int period = 0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int K = g.kt * 16;
  float part[NG][4];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
  for (int u = 0; u < g.nu; ++u) {
    const float* wp = w + g.off + u * g.ustride + (size_t)g.mt * g.kt * 256 + gid;
    const int g0 = u * g.gpu;
    for (int kt = 0; kt < g.kt; ++kt) {
      float w0[16], w1[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        w0[q] = __ldg(wp + (kt * 16 + q) * 16);
        w1[q] = __ldg(wp + (kt * 16 + q) * 16 + 8);
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) {
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          if (i < g0 || i >= g0 + g.gpu) continue;
          const int n = (i - g0) * 8 + 2 * tig;
          const float x0 = xs.val(n, kt, q), x1 = xs.val(n + 1, kt, q);
          part[i][0] = fmaf(x0, w0[q], part[i][0]);
          part[i][1] = fmaf(x1, w0[q], part[i][1]);
          part[i][2] = fmaf(x0, w1[q], part[i][2]);
          part[i][3] = fmaf(x1, w1[q], part[i][3]);
        }
        const int k1 = kt * 16 + q + 1;
        if (k1 == split || k1 == K || (period > 0 && k1 % period == 0)) {
#pragma unroll
          for (int i = 0; i < NG; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][e] += part[i][e];
              part[i][e] = 0.f;
            }
        }
      }
    }
  }
}

__device__ __forceinline__ GemmArgs one(const MonoMat& m, int mt, int ng) {
  return GemmArgs{m.off, 0, m.kt, mt, 1, ng};
}

template <int NG>
__device__ __forceinline__ void zero_acc(float (&acc)[NG][4]) {
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// The gate column of accumulator element e of m-tile mt (the host's
// permutation): shared weights 16 units a tile, unit j's f and c one
// column; unshared 8 units a tile, rows 0-7 their f columns, 8-15 their c.
__device__ __forceinline__ int gate_unit(int mt, int gid, int e, int shared) {
  return shared ? mt * 16 + gid + 8 * (e >> 1) : mt * 8 + gid;
}
__device__ __forceinline__ int gate_mtiles(int H, int shared) {
  return shared ? (H + 15) / 16 : (H + 7) / 8;
}

// The cell update of the accumulators of one m-tile of layer k (pre-
// activations, all inputs summed): membranes mem [Hp][N] f32 of the layer,
// each owned by one thread; the new spikes as bits into bits [N][Hb] (a
// warp vote gathers each byte: 8 units of one row).
template <int NG>
__device__ __forceinline__ void cell_tile(const float (&acc)[NG][4], int mt, int ng, int H,
                                          int N, int Hb, int shared, const float* coef,
                                          float* mem, uint8_t* bits) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    if (i >= ng) continue;  // warp-uniform
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!shared && e >= 2) continue;
      const int j = gate_unit(mt, gid, e, shared);
      const int n = i * 8 + 2 * tig + (e & 1);
      bool spike = false;
      if (j < H) {
        const float pre_f = acc[i][e];
        const float pre_c = shared ? pre_f : acc[i][e + 2];
        const float c = cell(pre_f, pre_c, mem[(size_t)j * N + n], coef[j], coef[H + j],
                             coef[2 * H + j], coef[3 * H + j]);
        mem[(size_t)j * N + n] = c;
        spike = c >= 0.f;
      }
      const unsigned vote = __ballot_sync(0xffffffffu, spike);
      if (gid == 0) {  // lane tig gathers bits tig, tig + 4, ..., tig + 28: units 0-7, row n
        unsigned x = (vote >> tig) & 0x11111111u;
        x = (x | (x >> 3)) & 0x03030303u;
        x = (x | (x >> 6)) & 0x000F000Fu;
        x = (x | (x >> 12)) & 0xFFu;
        bits[(size_t)n * Hb + (shared ? 2 * mt + (e >> 1) : mt)] = (uint8_t)x;
      }
    }
  }
}

// Layers k >= 1 of a stack (layer 0 is the caller's: its inputs differ):
// gates = [h_{k-1}(t) | h_k(t-1)] @ [wihr_{k-1}; whh_k], then the cell.
// new_bits / old_bits: the spikes of step t and t - 1 (each [L][N][Hb]);
// mem [L][Hp][N].
template <int NG, int PF, typename IO>
__device__ void upper_layers(const IO* w, const MonoMat* rec, int L, int H, int Hp, int N,
                             int shared, const float* coef, float* mem, uint8_t* new_bits,
                             const uint8_t* old_bits) {
  const int warp = threadIdx.x >> 5, Hb = Hp / 8;
  const int mts = gate_mtiles(H, shared), ng = N / 8;
  for (int k = 1; k < L; ++k) {
    const XSpk xs{new_bits + (size_t)(k - 1) * N * Hb, old_bits + (size_t)k * N * Hb, Hb, Hb,
                  Hp / 16};
    for (int mt = warp; mt < mts; mt += NWARPS) {
      float acc[NG][4];
      zero_acc(acc);
      gemm_tile<NG, PF>(acc, w, one(rec[k], mt, ng), xs, Hp);
      cell_tile(acc, mt, ng, H, N, Hb, shared, coef + (size_t)k * 4 * H, mem + (size_t)k * Hp * N,
                new_bits + (size_t)k * N * Hb);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------- io block
// Front (step t) and back (step t - 3) of the pipeline. o[0] the frame X io
// [RT][ld_dft], after the DFT the magnitude f32 [F][RT]; o[1] spectrum f32
// [2 F1][RT]; o[2] sel_mag f32 [F][U + 1]; o[3] enhanced-spectrum ring io
// [2][RT][ld_idft] (re | im along k); o[4] pass-through ring f32 [4][re |
// im][F1 - W][RT]; o[5] this frame's inverse DFT f32 [n_fft][RT]; o[6] the
// earlier frames' tails f32 [6 hop][RT]: frame t-1's [hop, 4 hop), t-2's
// [2 hop, 4 hop), t-3's [3 hop, 4 hop).
template <typename IO, int RT>
__device__ void front_step(const MonoArgs& a, cg::cluster_group& cl, char* sm, int t, int row0) {
  constexpr int NG = RT / 8;
  const MonoBlk& bk = a.blk[0];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2,
            tig = lane & 3;
  const int hop = a.hop, n_fft = a.n_fft, F1 = n_fft / 2 + 1, F = F1 - 1;
  const int U1 = a.U + 1;
  const IO* chunks = static_cast<const IO*>(a.chunks);
  IO* frame = at<IO>(sm, bk.o[0]);
  float* mag = at<float>(sm, bk.o[0]);  // the frame's space, once the DFT has read it
  float* spec = at<float>(sm, bk.o[1]);
  // the frame of chunks t..t+3: sample k of every row, the loads before the stores
  for (int k = tid; k < n_fft; k += NTHREADS) {
    const IO* src = chunks + ((size_t)(t + k / hop) * a.B + row0) * hop + k % hop;
    IO v[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) v[r] = row0 + r < a.B ? src[(size_t)r * hop] : IO(0.f);
#pragma unroll
    for (int r = 0; r < RT; ++r) frame[(size_t)r * a.ld_dft + k] = v[r];
  }
  __syncthreads();
  mark(a, 0);
  // DFT: spectrum [2 F1][RT]
  const IO* w = static_cast<const IO*>(a.w);
  const XDense<IO> xf{frame, frame, a.ld_dft, a.ld_dft, 1 << 30};
  for (int mt = warp; mt < a.dft.mt; mt += NWARPS) {
    float acc[NG][4];
    zero_acc(acc);
    gemm_tile<NG, PF_F>(acc, w, one(a.dft, mt, NG), xf, 0, hop);
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 16 + gid + 8 * (e >> 1), n = i * 8 + 2 * tig + (e & 1);
        if (m < 2 * F1) spec[(size_t)m * RT + n] = acc[i][e];
      }
  }
  __syncthreads();
  mark(a, 1);
  // the magnitude [F][RT]; the pass-through bins
  const int npass = F1 - a.W;
  float* pass = at<float>(sm, bk.o[4]) + (size_t)(t & 3) * 2 * npass * RT;
  for (int idx = tid; idx < F1 * RT; idx += NTHREADS) {
    const int k = idx / RT, r = idx % RT;
    const float re = spec[idx], im = spec[(size_t)F1 * RT + idx];
    if (k >= a.W) {
      pass[(size_t)(k - a.W) * RT + r] = rnd<IO>(re);
      pass[(size_t)(npass + k - a.W) * RT + r] = rnd<IO>(im);
    }
    if (k < F) mag[idx] = sqrtf(sqrtf(re * re + im * im));
  }
  __syncthreads();
  mark(a, 2);
  // hand-offs: the fullband block's input, each unit block's window (io)
  // and spectrum bins (f32)
  IO* fb_x = cl.map_shared_rank(at<IO>(sm, a.blk[1].o[0]), 1) + (size_t)(t & 1) * RT * a.ld_fin;
  for (int k = tid; k < a.Fin; k += NTHREADS)
#pragma unroll
    for (int r = 0; r < RT; ++r) fb_x[(size_t)r * a.ld_fin + k] = IO(mag[(size_t)k * RT + r]);
  for (int b = 2; b < a.nblk; ++b) {
    const MonoBlk& ub = a.blk[b];
    const MonoSec& s = a.sec[ub.sec];
    IO* xm = cl.map_shared_rank(at<IO>(sm, ub.o[0]), b) + (size_t)(t % 3) * RT * s.ld_aw;
    for (int k = tid; k < s.aw; k += NTHREADS)
#pragma unroll
      for (int r = 0; r < RT; ++r) xm[(size_t)r * s.ld_aw + k] = IO(mag[(size_t)(s.a0 + k) * RT + r]);
    const int nbin = ub.nb * s.ctr, bin0 = s.f0 + ub.jj0 * s.ctr;
    float4* sp = reinterpret_cast<float4*>(cl.map_shared_rank(at<float>(sm, ub.o[3]), b) +
                                           (size_t)(t % s.dr) * 2 * nbin * RT);
    const float4* re4 = reinterpret_cast<const float4*>(spec + (size_t)bin0 * RT);
    const float4* im4 = reinterpret_cast<const float4*>(spec + (size_t)(F1 + bin0) * RT);
    const int n4 = nbin * RT / 4;
    for (int idx = tid; idx < n4; idx += NTHREADS) {
      sp[idx] = re4[idx];
      sp[n4 + idx] = im4[idx];
    }
  }
  // the magnitude's statistics (s2 only for "ln") into the fullband block
  if (a.norm != NORM_RAW) {
    const float* sel = at<float>(sm, bk.o[2]);
    float* st = cl.map_shared_rank(at<float>(sm, a.blk[1].o[1]), 1) + (size_t)(t & 1) * 2 * U1 * RT;
    const int nst = (a.norm == NORM_LN ? 2 : 1) * U1;
    for (int idx = tid; idx < nst * RT; idx += NTHREADS) {
      const int sc = idx / RT, r = idx % RT, sq = sc >= U1, c = sq ? sc - U1 : sc;
      float s = 0.f;
      for (int f = 0; f < F; ++f) {
        const float m = mag[(size_t)f * RT + r];
        s = fmaf(sq ? m * m : m, sel[(size_t)f * U1 + c], s);
      }
      st[(size_t)sc * RT + r] = s;
    }
  }
  mark(a, 3);
}

template <typename IO, int RT>
__device__ void back_step(const MonoArgs& a, char* sm, int t, int row0) {
  constexpr int NG = RT / 8;
  const MonoBlk& bk = a.blk[0];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2,
            tig = lane & 3;
  const int hop = a.hop, n_fft = a.n_fft, F1 = n_fft / 2 + 1;
  const int npass = F1 - a.W;
  IO* enh = at<IO>(sm, bk.o[3]) + (size_t)(t & 1) * RT * a.ld_idft;
  const float* pass = at<float>(sm, bk.o[4]) + (size_t)(t & 3) * 2 * npass * RT;
  float* yf = at<float>(sm, bk.o[5]);
  float* t1 = at<float>(sm, bk.o[6]);   // frame t-1 from hop: 3 hop
  float* t2 = t1 + (size_t)3 * hop * RT;  // frame t-2 from 2 hop: 2 hop
  float* t3 = t2 + (size_t)2 * hop * RT;  // frame t-3 from 3 hop: 1 hop
  for (int idx = tid; idx < npass * RT; idx += NTHREADS) {
    const int k = idx / RT, r = idx % RT;
    enh[(size_t)r * a.ld_idft + a.W + k] = IO(pass[(size_t)k * RT + r]);
    enh[(size_t)r * a.ld_idft + F1 + a.W + k] = IO(pass[(size_t)(npass + k) * RT + r]);
  }
  __syncthreads();
  mark(a, 4);
  if (t < a.t_real) {
    const IO* w = static_cast<const IO*>(a.w);
    const XDense<IO> xs{enh, enh, a.ld_idft, a.ld_idft, 1 << 30};
    for (int mt = warp; mt < a.idft.mt; mt += NWARPS) {
      float acc[NG][4];
      zero_acc(acc);
      gemm_tile<NG, PF_F>(acc, w, one(a.idft, mt, NG), xs);
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = mt * 16 + gid + 8 * (e >> 1), n = i * 8 + 2 * tig + (e & 1);
          if (m < n_fft) yf[(size_t)m * RT + n] = acc[i][e];
        }
    }
  } else {  // frames past the natural count leave the overlap-add
    for (int i = tid; i < n_fft * RT; i += NTHREADS) yf[i] = 0.f;
  }
  __syncthreads();
  mark(a, 5);
  for (int idx = tid; idx < hop * RT; idx += NTHREADS) {
    const int i = idx / RT, r = idx % RT, b = row0 + r;
    if (b < a.B) a.out[((size_t)t * a.B + b) * hop + i] = yf[idx] + t1[idx] + t2[idx] + t3[idx];
  }
  __syncthreads();
  for (int idx = tid; idx < hop * RT; idx += NTHREADS) t3[idx] = t2[(size_t)hop * RT + idx];
  __syncthreads();
  for (int idx = tid; idx < 2 * hop * RT; idx += NTHREADS) t2[idx] = t1[(size_t)hop * RT + idx];
  __syncthreads();
  for (int idx = tid; idx < 3 * hop * RT; idx += NTHREADS) t1[idx] = yf[(size_t)hop * RT + idx];
  mark(a, 6);
}

// ------------------------------------------------------------- fullband
// o[0] input ring io [2][RT][ld_fin]; o[1] statistics ring f32 [2][2][U+1]
// [RT]; o[2] spike bits [2 parities][Lf][RT][Hfp / 8]; o[3] membranes f32
// [Lf][Hfp][RT]; o[4] fb_y f32 [Pfb][RT]; o[5] sel_fb f32 [Pfb][U + 1];
// o[6] running sums f32 [U + 1][RT].
template <typename IO, int RT>
__device__ void fb_step(const MonoArgs& a, cg::cluster_group& cl, char* sm, int t) {
  constexpr int NG = RT / 8;
  const MonoBlk& bk = a.blk[1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2,
            tig = lane & 3;
  const int U = a.U, U1 = U + 1, Hf = a.Hf, Hfp = a.Hfp, Hb = Hfp / 8;
  const int Gf = a.shared ? Hf : 2 * Hf;
  const IO* w = static_cast<const IO*>(a.w);
  const IO* xin = at<IO>(sm, bk.o[0]) + (size_t)(t & 1) * RT * a.ld_fin;
  const float* s1m = at<float>(sm, bk.o[1]) + (size_t)(t & 1) * 2 * U1 * RT;
  const float* s2m = s1m + (size_t)U1 * RT;
  uint8_t* bits0 = at<uint8_t>(sm, bk.o[2]);
  uint8_t* new_bits = bits0 + (size_t)(t & 1) * a.Lf * RT * Hb;
  const uint8_t* old_bits = bits0 + (size_t)((t + 1) & 1) * a.Lf * RT * Hb;
  float* mem = at<float>(sm, bk.o[3]);
  float* fby = at<float>(sm, bk.o[4]);
  float* cum = at<float>(sm, bk.o[6]);
  const float inv_t = 1.f / (float)(t + 1);

  // layer 0: the input gates, scaled per norm, plus the recurrence
  const XDense<IO> xs_in{xin, xin, a.ld_fin, a.ld_fin, 1 << 30};
  const XSpk xs_h{old_bits, old_bits, Hb, Hb, 1 << 30};
  const int mts = gate_mtiles(Hf, a.shared);
  for (int mt = warp; mt < mts; mt += NWARPS) {
    float acc[NG][4];
    zero_acc(acc);
    gemm_tile<NG, PF_F>(acc, w, one(a.fb_in, mt, NG), xs_in);
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = i * 8 + 2 * tig + (e & 1);
        const int j = gate_unit(mt, gid, e, a.shared);
        const int col = (!a.shared && e >= 2) ? Hf + j : j;
        if (j >= Hf) continue;
        if (a.norm == NORM_LN) {
          const float mu = s1m[(size_t)U * RT + r];
          const float rstd = 1.f / sqrtf((s2m[(size_t)U * RT + r] - mu * mu) + LN_EPS);
          acc[i][e] = rstd * acc[i][e] - (rstd * mu) * a.fb_uv[col] + a.fb_uv[Gf + col];
        } else if (a.norm == NORM_CUM) {
          const float d = (cum[(size_t)U * RT + r] + s1m[(size_t)U * RT + r]) * inv_t + a.eps;
          acc[i][e] = acc[i][e] / d;
        }
      }
    gemm_tile<NG, PF_F>(acc, w, one(a.fb_rec[0], mt, NG), xs_h);
    cell_tile(acc, mt, NG, Hf, RT, Hb, a.shared, a.fb_coef, mem, new_bits);
  }
  __syncthreads();
  mark(a, 0);
  upper_layers<NG, PF_F>(w, a.fb_rec, a.Lf, Hf, Hfp, RT, a.shared, a.fb_coef, mem, new_bits,
                         old_bits);
  mark(a, 1);

  // projection; fb_io into every unit block's ring
  const XSpk xs_p{new_bits + (size_t)(a.Lf - 1) * RT * Hb, new_bits, Hb, Hb, 1 << 30};
  for (int mt = warp; mt < a.fb_proj.mt; mt += NWARPS) {
    float acc[NG][4];
    zero_acc(acc);
    gemm_tile<NG, PF_F>(acc, w, one(a.fb_proj, mt, NG), xs_p);
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = mt * 16 + gid + 8 * (e >> 1), r = i * 8 + 2 * tig + (e & 1);
        if (p < a.Pfb) fby[(size_t)p * RT + r] = acc[i][e] + a.fb_bproj[p];
      }
  }
  __syncthreads();
  for (int b = 2; b < a.nblk; ++b) {
    IO* xb = cl.map_shared_rank(at<IO>(sm, a.blk[b].o[1]), b) + (size_t)(t & 1) * RT * a.ld_pfb;
    for (int p = tid; p < a.Pfb; p += NTHREADS)
#pragma unroll
      for (int r = 0; r < RT; ++r) xb[(size_t)r * a.ld_pfb + p] = IO(fby[(size_t)p * RT + r]);
  }
  mark(a, 2);

  // unit scales: complete the statistics with the fullband part
  if (a.norm != NORM_RAW) {
    const float* sel = at<float>(sm, bk.o[5]);
    for (int idx = tid; idx < U1 * RT; idx += NTHREADS) {
      const int c = idx / RT, r = idx % RT;
      float s1f = 0.f, s2f = 0.f;
      for (int p = 0; p < a.Pfb; ++p) {
        const float v = fby[(size_t)p * RT + r], q = sel[(size_t)p * U1 + c];
        s1f = fmaf(v, q, s1f);
        if (a.norm == NORM_LN) s2f = fmaf(v * v, q, s2f);
      }
      float alpha, beta = 0.f;
      if (a.norm == NORM_LN) {
        const float mu = s1m[(size_t)c * RT + r] + s1f;
        const float var = (s2m[(size_t)c * RT + r] + s2f) - mu * mu;
        alpha = 1.f / sqrtf(var + LN_EPS);
        beta = alpha * mu;
      } else {
        const float cs = (cum[(size_t)c * RT + r] + s1m[(size_t)c * RT + r]) + s1f;
        cum[(size_t)c * RT + r] = cs;
        alpha = 1.f / (cs * inv_t + a.eps);
      }
      if (c >= U) continue;
      for (int b = 2; b < a.nblk; ++b) {
        const MonoBlk& ub = a.blk[b];
        const int q = c - (a.sec[ub.sec].u0 + ub.jj0);
        if (q < 0 || q >= ub.nb) continue;
        float* sc = cl.map_shared_rank(at<float>(sm, ub.o[2]), b) +
                    (size_t)(t & 1) * 2 * ub.nb * RT;
        sc[(size_t)q * RT + r] = alpha;
        sc[(size_t)(ub.nb + q) * RT + r] = beta;
      }
    }
  }
  mark(a, 3);
}

// ---------------------------------------------------------------- units
// o[0] window ring io [3][RT][ld_aw]; o[1] fb_io ring io [2][RT][ld_pfb];
// o[2] scale ring f32 [2][alpha | beta][nb][RT]; o[3] spectrum ring f32
// [dr][re | im][nb ctr][RT]; o[4] spike bits [2 parities][L][N][Hp / 8];
// o[5] membranes f32 [L][Hp][N]; o[6] projection f32 [N][P]. N = nb RT.
// NG: the block's n-groups (nb RT / 8) rounded up to an even count.
template <typename IO, int RT, int NG>
__device__ void unit_step(const MonoArgs& a, cg::cluster_group& cl, char* sm, int rank, int t) {
  constexpr int PF = NG <= 4 ? PF_F : PF_U;  // the fewer accumulators, the more loads in flight
  constexpr int GPU = RT / 8;                // n-groups of one unit
  const MonoBlk& bk = a.blk[rank];
  const MonoSec& s = a.sec[bk.sec];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2,
            tig = lane & 3;
  const int nb = bk.nb, N = nb * RT, ng = N / 8;
  const int H = a.H, Hp = a.Hp, Hb = Hp / 8, G = a.shared ? H : 2 * H, L = a.L;
  const IO* w = static_cast<const IO*>(a.w);
  const IO* xm = at<IO>(sm, bk.o[0]) + (size_t)(t % 3) * RT * s.ld_aw;
  const IO* xb = at<IO>(sm, bk.o[1]) + (size_t)(t & 1) * RT * a.ld_pfb;
  const float* al = at<float>(sm, bk.o[2]) + (size_t)(t & 1) * 2 * nb * RT;
  const float* be = al + (size_t)nb * RT;
  const float* spec = at<float>(sm, bk.o[3]);
  uint8_t* bits0 = at<uint8_t>(sm, bk.o[4]);
  uint8_t* new_bits = bits0 + (size_t)(t & 1) * L * N * Hb;
  const uint8_t* old_bits = bits0 + (size_t)((t + 1) & 1) * L * N * Hb;
  float* mem = at<float>(sm, bk.o[5]);
  float* ys = at<float>(sm, bk.o[6]);
  const float* uv = a.uv + s.uv;
  const float* coef = a.coef + s.coef;

  // layer 0: each unit's own input weights over the section's window and
  // fb_io (its rows), scaled; then the shared recurrence over every unit
  const XDense<IO> xs_in{xm, xb, s.ld_aw, a.ld_pfb, s.kt_aw};
  const XSpk xs_h{old_bits, old_bits, Hb, Hb, 1 << 30};
  const int mts = gate_mtiles(H, a.shared);
  for (int mt = warp; mt < mts; mt += NWARPS) {
    float acc[NG][4];
    zero_acc(acc);
    const GemmArgs g{s.win.off + (long long)bk.jj0 * s.win_size, s.win_size, s.win.kt, mt, nb, GPU};
    gemm_tile<NG, PF>(acc, w, g, xs_in, s.kt_aw * 16);
    if (a.norm != NORM_RAW) {
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        if (i >= ng) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = i * 8 + 2 * tig + (e & 1);
          const int j = gate_unit(mt, gid, e, a.shared);
          const int col = (!a.shared && e >= 2) ? H + j : j;
          if (j >= H) continue;
          acc[i][e] = al[n] * acc[i][e];
          if (a.norm == NORM_LN) acc[i][e] = acc[i][e] - be[n] * uv[col] + uv[G + col];
        }
      }
    }
    gemm_tile<NG, PF>(acc, w, one(s.rec[0], mt, ng), xs_h);
    cell_tile(acc, mt, ng, H, N, Hb, a.shared, coef, mem, new_bits);
  }
  __syncthreads();
  mark(a, 0);
  upper_layers<NG, PF>(w, s.rec, L, H, Hp, N, a.shared, coef, mem, new_bits, old_bits);
  mark(a, 1);

  // projection y = h_L @ wproj + bproj
  const XSpk xs_p{new_bits + (size_t)(L - 1) * N * Hb, new_bits, Hb, Hb, 1 << 30};
  const float* bproj = a.bproj + s.bproj;
  const int P = s.P;
  for (int mt = warp; mt < s.proj.mt; mt += NWARPS) {
    float acc[NG][4];
    zero_acc(acc);
    gemm_tile<NG, PF>(acc, w, one(s.proj, mt, ng), xs_p);
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      if (i >= ng) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = mt * 16 + gid + 8 * (e >> 1), n = i * 8 + 2 * tig + (e & 1);
        if (p < P) ys[(size_t)n * P + p] = acc[i][e] + bproj[p];
      }
    }
  }
  __syncthreads();
  mark(a, 2);

  // deep filter into the io block's enhanced spectrum: thread (bin f, row r)
  // for every unit of the block
  const int ctr = s.ctr, df = s.df, nbin = nb * ctr, F1 = a.n_fft / 2 + 1;
  const int bin0 = s.f0 + bk.jj0 * ctr;
  IO* enh = cl.map_shared_rank(at<IO>(sm, a.blk[0].o[3]), 0) + (size_t)(t & 1) * RT * a.ld_idft;
  for (int fr = tid; fr < ctr * RT; fr += NTHREADS) {
    const int f = fr / RT, r = fr % RT;
    for (int q = 0; q < nb; ++q) {
      const int n = q * RT + r, kb = q * ctr + f;
      const float* y = ys + (size_t)n * P;
      float er = 0.f, ei = 0.f;
      for (int d = 0; d < df; ++d) {
        const int tt = t - (df - 1 - d);  // the oldest frame pairs with tap 0
        if (tt < 0) continue;
        const float* sp = spec + (size_t)(tt % s.dr) * 2 * nbin * RT;
        const float tr = sp[(size_t)kb * RT + r], tm = sp[(size_t)(nbin + kb) * RT + r];
        const float cr = y[d * ctr + f], ci = y[(df + d) * ctr + f];
        er += tr * cr - tm * ci;
        ei += tr * ci + tm * cr;
      }
      enh[(size_t)r * a.ld_idft + bin0 + kb] = IO(er);
      enh[(size_t)r * a.ld_idft + F1 + bin0 + kb] = IO(ei);
    }
  }
  mark(a, 3);
}

template <typename IO, int RT>
__global__ void __launch_bounds__(NTHREADS, 1) monolith_kernel(const __grid_constant__ MonoArgs a) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int row0 = (int)(blockIdx.x / a.nblk) * RT;
  const MonoBlk& bk = a.blk[rank];
  float* smf = reinterpret_cast<float*>(sm);
  for (int i = threadIdx.x; i < bk.smem / 4; i += NTHREADS) smf[i] = 0.f;
  const int U1 = a.U + 1, F = a.n_fft / 2;
  if (a.norm != NORM_RAW) {  // the statistics columns stay resident
    if (rank == 0)
      for (int i = threadIdx.x; i < F * U1; i += NTHREADS) at<float>(sm, bk.o[2])[i] = a.sel_mag[i];
    else if (rank == 1)
      for (int i = threadIdx.x; i < a.Pfb * U1; i += NTHREADS) at<float>(sm, bk.o[5])[i] = a.sel_fb[i];
  }
  if (threadIdx.x < 9) prof_acc[threadIdx.x] = 0;
  const int ng = bk.nb * RT / 8;  // a unit block's n-groups
  cl.sync();
  mark(a, 8);
  for (int it = 0; it < a.S + 3; ++it) {
    if (rank == 0) {
      if (it < a.S) front_step<IO, RT>(a, cl, sm, it, row0);
      if (it >= 3) {
        __syncthreads();
        back_step<IO, RT>(a, sm, it - 3, row0);
      }
    } else if (rank == 1) {
      if (it >= 1 && it - 1 < a.S) fb_step<IO, RT>(a, cl, sm, it - 1);
    } else if (it >= 2 && it - 2 < a.S) {
      if (ng <= 2) unit_step<IO, RT, 2>(a, cl, sm, rank, it - 2);
      else if (ng <= 4) unit_step<IO, RT, 4>(a, cl, sm, rank, it - 2);
      else if (ng <= 6) unit_step<IO, RT, 6>(a, cl, sm, rank, it - 2);
      else unit_step<IO, RT, 8>(a, cl, sm, rank, it - 2);
    }
    cl.sync();  // this step's hand-offs are in place; every reader is done with the slots reused next
    mark(a, 7);  // the wait at the cluster barrier
  }
  if (a.prof != nullptr && threadIdx.x < 8) a.prof[(size_t)blockIdx.x * 8 + threadIdx.x] = prof_acc[threadIdx.x];
}

template <typename IO, int RT>
static cudaError_t config(const MonoArgs& a, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  auto kern = monolith_kernel<IO, RT>;
  int smem = 0;
  for (int b = 0; b < a.nblk; ++b) smem = a.blk[b].smem > smem ? a.blk[b].smem : smem;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (a.nblk > 8) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cfg = {};
  cfg.gridDim = dim3((unsigned)(((a.B + RT - 1) / RT) * a.nblk));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename IO, int RT>
static int launch_typed(const MonoArgs& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = config<IO, RT>(a, cfg, attr, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, monolith_kernel<IO, RT>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename IO, int RT>
static int max_clusters(const MonoArgs& a, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = config<IO, RT>(a, cfg, attr, 0);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(clusters, monolith_kernel<IO, RT>, &cfg);
}

#if !defined(MONO_BF16)
#error "build with -DMONO_BF16=0|1"
#endif
#if MONO_BF16
using MonoIO = __nv_bfloat16;
#else
using MonoIO = float;
#endif

static bool valid(int io_bf16, const MonoArgs& a) {
  return io_bf16 == MONO_BF16 && a.n_sec >= 1 && a.n_sec <= MAX_SEC && a.nblk >= 3 &&
         a.nblk <= MAX_BLK && a.nblk - 2 >= a.n_sec && (a.rt == 8 || a.rt == 16) &&
         a.H >= 1 && a.H <= 512 && a.Hf >= 1 && a.Hf <= 512 && a.L >= 1 && a.L <= 3 &&
         a.Lf >= 1 && a.Lf <= 3 && a.B >= 1 && a.S >= 1 && a.U >= 1 &&
         a.n_fft == 4 * a.hop && a.norm >= 0 && a.norm <= 2;
}

extern "C" {

// args: the streams, packed weights, sizes and the host's plan (MonoArgs).
// Returns the CUDA error code of the launch (0 on success).
int sfsb_monolith_launch(int io_bf16, const MonoArgs* args, void* stream) {
  if (!valid(io_bf16, *args)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return args->rt == 16 ? launch_typed<MonoIO, 16>(*args, s) : launch_typed<MonoIO, 8>(*args, s);
}

// The clusters of this plan the card holds at once
// (cudaOccupancyMaxActiveClusters) into *clusters; returns the CUDA error.
int sfsb_monolith_max_clusters(int io_bf16, const MonoArgs* args, int* clusters) {
  if (!valid(io_bf16, *args)) return (int)cudaErrorInvalidValue;
  return args->rt == 16 ? max_clusters<MonoIO, 16>(*args, clusters)
                        : max_clusters<MonoIO, 8>(*args, clusters);
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
