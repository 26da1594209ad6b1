// The eval engine of kernels B (gsu_sections_eval.cu), and A and F
// (gsu_stack_eval.cu, gsu_stack_eval_x.cu, one kernel in gsu_eval_stack.cuh):
// a block owns a tile of N columns, a column being one (row, unit) pair, and
// runs a whole L-layer GSU stack over T steps inside the block.
//
// - Products on the tensor cores: every product is W^T X with the weights
//   as the left operand, on mma.sync m16n8k16 bf16 -> f32. The host packs
//   each weight matrix in fragment order (ops/gsu_kernels._pack_mat), so a
//   warp reads one coalesced 512-byte fragment a 16 x 16 tile straight from
//   L2 into registers, two batches of PF tiles in flight. Each pair of
//   k-tiles is summed from zero by the tensor core and then added to the
//   accumulator in float32: a long running sum in the tensor core drops the
//   low bits of small terms (kernel C's finding).
// - float32 streams run the same schedule with CUDA-core FMAs (TF32 would
//   round the operands): each thread produces the same accumulator elements,
//   summing every product call from zero in k order.
// - Spikes (0 or 1, exact in bf16) are dense bf16 rows in shared memory,
//   double-buffered by step parity, so that every warp reads its B
//   fragments with one ldmatrix for two n-groups (kernel C keeps spikes as
//   bits, which each warp expands again: at B's and F's widths that
//   expansion made the warps issue-bound); the membranes live in shared
//   memory, each owned by the thread whose accumulators produce its gates
//   (the host permutes the gate columns so that an unshared unit's f and c
//   gates meet in one thread).
//
// The building blocks are kernel C's (sfsb_monolith_serve.cu), which keeps
// its own copy.
#pragma once

#include <cooperative_groups.h>

#include "gsu_common.cuh"

namespace gev {

namespace cg = cooperative_groups;
using gsu::cell;
using gsu::ld;

constexpr int NTHREADS = 512;  // 16 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int PFI = 16;  // staged input values a thread holds in registers ahead of their step

// A packed weight matrix W [K, M] used as W^T: kt 16-row k-tiles, mt
// 16-column m-tiles at element offset off of the packed buffer. bf16:
// [mt][kt][32 lanes][8] mma A fragments; f32: [mt][16 kt][16].
struct Mat {
  long long off;
  int kt, mt;
};

template <typename T> __device__ __forceinline__ T* at(char* base, int off) {
  return reinterpret_cast<T*>(base + off);
}

// Optional phase profile: thread 0 of each block adds the cycles since its
// previous mark to phase j (shared-memory counters, written out at the end).
__shared__ unsigned long long prof_acc[9];
__device__ __forceinline__ void mark(unsigned long long* prof, int j) {
  if (prof != nullptr && threadIdx.x == 0) {
    const unsigned long long now = clock64();
    prof_acc[j] += now - prof_acc[8];
    prof_acc[8] = now;
  }
}
__device__ __forceinline__ void prof_begin(unsigned long long* prof) {
  if (threadIdx.x < 9) prof_acc[threadIdx.x] = 0;
  __syncthreads();
  mark(prof, 8);
}
__device__ __forceinline__ void prof_end(unsigned long long* prof) {
  if (prof != nullptr && threadIdx.x < 8) prof[(size_t)blockIdx.x * 8 + threadIdx.x] = prof_acc[threadIdx.x];
}

// ---- the right operand X [n][k]: rows in shared memory, stride elements
// apart (whole k-tiles plus 8, so that eight rows' fragments fall on 32
// distinct banks); k-tiles [0, split) from p0, the rest from p1 (the
// recurrent products: layer k-1's spikes of step t, then layer k's of step
// t-1).
template <typename IO>
struct XDense {
  const IO* p0;
  const IO* p1;
  int stride, split;
  __device__ __forceinline__ const IO* row(int n, int kt) const {
    return kt < split ? p0 + (size_t)n * stride + kt * 16
                      : p1 + (size_t)n * stride + (kt - split) * 16;
  }
  // the B fragment of row n, k-tile kt for lane column tig: k = 2 tig, +1; +8, +9
  __device__ __forceinline__ void frag(int n, int kt, int tig, uint32_t& b0, uint32_t& b1) const {
    const IO* q = row(n, kt) + 2 * tig;
    b0 = *reinterpret_cast<const uint32_t*>(q);
    b1 = *reinterpret_cast<const uint32_t*>(q + 8);
  }
  // the B fragments of n-groups i and i + 1 at k-tile kt in one ldmatrix
  // (bf16 only): b = {b0, b1 of group i, b0, b1 of group i + 1}
  __device__ __forceinline__ void frag2(int i, int kt, int lane, uint32_t (&b)[4]) const {
    const int m = lane >> 3;
    const IO* q = row(i * 8 + (m >> 1) * 8 + (lane & 7), kt) + (m & 1) * 8;
    const unsigned addr = (unsigned)__cvta_generic_to_shared(q);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                 : "r"(addr));
  }
  __device__ __forceinline__ float val(int n, int kt, int k) const { return ld(row(n, kt) + k); }
};

// Spikes are 0.0 / 1.0 in bf16 (exact) in both stream types: rows [N][Hp +
// 8] of each layer, double-buffered by step parity, the pad units zero.
using Spk = __nv_bfloat16;
__device__ __forceinline__ int spk_stride(int Hp) { return Hp + 8; }

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
//   nu units (kernel B's layer-0 inputs): unit q's matrix is at + q ustride
//   elements, multiplies X's n-groups [0, gpu) and adds into acc groups
//   [q gpu, (q + 1) gpu); nu == 1: X's and acc's groups [0, gpu).
// The tiles stream through two register batches of PF fragments: one
// multiplies while the other is in flight.
struct GemmArgs {
  long long off, ustride;
  int kt, mt, nu, gpu;
};

__device__ __forceinline__ GemmArgs one(const Mat& m, int mt, int ng) {
  return GemmArgs{m.off, 0, m.kt, mt, 1, ng};
}

template <int NG, int PF, typename XS>
__device__ __forceinline__ void gemm_tile(float (&acc)[NG][4], const __nv_bfloat16* w,
                                          const GemmArgs& g, const XS& xs) {
  static_assert(PF % 2 == 0, "k-tiles are multiplied in pairs");
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const uint4* base = reinterpret_cast<const uint4*>(w + g.off) + (size_t)g.mt * g.kt * 32 + lane;
  uint4 fa[PF], fb[PF];
  if (g.nu == 1) {
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

// float32: the same outputs with CUDA-core FMAs. Each of a unit's input
// parts (k-tiles [0, xs.split) and the rest: the window and xb, or h_{k-1}
// and h_k) is summed from zero in k order and then added to acc, as the
// plain version sums each product before adding them.
template <int NG, int PF, typename XS>
__device__ __forceinline__ void gemm_tile(float (&acc)[NG][4], const float* w,
                                          const GemmArgs& g, const XS& xs) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  for (int u = 0; u < g.nu; ++u) {
    const float* wp = w + g.off + u * g.ustride + (size_t)g.mt * g.kt * 256 + gid;
    const int g0 = u * g.gpu;
    float part[NG][4];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
    for (int kt = 0; kt < g.kt; ++kt) {
      if (kt == xs.split) {
#pragma unroll
        for (int i = 0; i < NG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][e] += part[i][e];
            part[i][e] = 0.f;
          }
      }
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
      }
    }
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
  }
}

template <int NG>
__device__ __forceinline__ void zero_acc(float (&acc)[NG][4]) {
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// The gate column of accumulator element e of m-tile mt (the host's
// permutation, ops/gsu_kernels._gate_perm): shared weights 16 units a tile,
// unit j's f and c one column; unshared 8 units a tile, rows 0-7 their f
// columns, 8-15 their c.
__device__ __forceinline__ int gate_unit(int mt, int gid, int e, int shared) {
  return shared ? mt * 16 + gid + 8 * (e >> 1) : mt * 8 + gid;
}
__device__ __forceinline__ int gate_mtiles(int H, int shared) {
  return shared ? (H + 15) / 16 : (H + 7) / 8;
}

// The membranes of a layer: rows [N][Hp + 4] f32, so that a warp's 32
// elements (8 units x 4 column pairs) fall on 32 distinct banks.
__device__ __forceinline__ int mem_stride(int Hp) { return Hp + 4; }

// The cell update of the accumulators of one m-tile of layer k (pre-
// activations, all inputs summed): membranes mem [N][ms] f32 of the layer,
// each owned by one thread; each new spike goes to put(column n, unit j,
// 0.0 or 1.0).
template <int NG, typename Put>
__device__ __forceinline__ void cell_tile(const float (&acc)[NG][4], int mt, int ng, int H,
                                          int ms, int shared, const float* coef, float* mem,
                                          Put put) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  // a thread's elements belong to two units (shared: rows gid and gid + 8)
  // or one (unshared: its f and c gates): their coefficients are loaded once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && !shared) break;
    const int j = gate_unit(mt, gid, 2 * h, shared);
    if (j >= H) continue;
    const float b_f = coef[j], b_c = coef[H + j], scale = coef[2 * H + j], shift = coef[3 * H + j];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      if (i >= ng) continue;  // warp-uniform
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int e = 2 * h + e2, n = i * 8 + 2 * tig + e2;
        const float pre_f = acc[i][e];
        const float pre_c = shared ? pre_f : acc[i][e + 2];
        float* m = mem + (size_t)n * ms + j;
        const float c = cell(pre_f, pre_c, *m, b_f, b_c, scale, shift);
        *m = c;
        put(n, j, c >= 0.f ? 1.f : 0.f);
      }
    }
  }
}

// n / d for a divisor fixed for the whole launch, by a multiply and a shift
// (valid for n < 2^31): the staging and output loops divide item indices by
// row lengths every step.
struct FastDiv {
  uint32_t d, m, s;
  __device__ explicit FastDiv(uint32_t div) : d(div), s(0) {
    while ((1u << s) < d) ++s;
    m = (uint32_t)(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
  }
};

// Staged inputs: a step's n items (values, or chunks of them, that the
// next step reads from shared memory), item i of thread tid at i = tid + q
// NTHREADS. The first P of a thread's items are loaded into registers ahead
// (load), before the step's products, and stored (store) after them, so
// that their device round trips overlap the products; any further item is
// loaded and stored at once. get(i) reads item i, set(i, v) writes it.
template <typename V, int P>
struct StagedT {
  V v[P];
  template <typename Get>
  __device__ __forceinline__ void load(int n, Get get) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = threadIdx.x + q * NTHREADS;
      if (i < n) v[q] = get(i);
    }
  }
  template <typename Get, typename Set>
  __device__ __forceinline__ void store(int n, Get get, Set set) const {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = threadIdx.x + q * NTHREADS;
      if (i < n) set(i, v[q]);
    }
    for (int i = threadIdx.x + P * NTHREADS; i < n; i += NTHREADS) set(i, get(i));
  }
};
using Staged = StagedT<float, PFI>;

}  // namespace gev
