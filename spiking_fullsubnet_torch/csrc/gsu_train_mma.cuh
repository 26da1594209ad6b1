// Shared device code of the training kernels D (gsu_train_fwd.cu) and E
// (gsu_train_bwd.cu): the host's plan, the products of the recurrence, the
// per-unit reductions, the prefetches and the phase profile.
//
// Layout. A thread-block cluster of p.nblk blocks splits the H hidden units:
// block b owns units [b J, b J + J) (J a multiple of 16; the last block may
// own fewer) for all R rows. Its gate columns form the m side of
// mma.sync m16n8k16 (W^T as the left operand, packed by the host in
// fragment order: ops/gsu_kernels.train_pack) and the rows the n side, 8 a
// group, NGB groups a warp's batch. Shared weights: m-tile mt holds units
// 16 mt .. 16 mt + 15 of the block; unshared: units 8 mt .. 8 mt + 7, their
// f columns in rows 0-7 and their c columns in rows 8-15, so that one
// thread holds both gates of a unit. Thread (gid, tig) = (lane / 4, lane %
// 4) holds accumulator e of m-tile mt and row group n at gate row gid + 8
// (e / 2) and row 8 n + 2 tig + e % 2.
//
// The elementwise passes of both kernels take another layout, a warp a
// row and a lane a unit (two rows a warp when the block has 16 units), so
// that their accesses to [T, R, H] tensors are runs of the block's units.
//
// Spikes are bits, one byte for 8 units of a row, in slices by block:
// [block][Rp][2 JT] bytes (JT = J / 16), so that k-tile kt of the product
// (units 16 kt .. 16 kt + 15) is two bytes of one block's slice.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gsu_common.cuh"

namespace gsut {

using gsu::ld;
using gsu::st;

constexpr int NW = 16;             // warps a block
constexpr int NTHREADS = 32 * NW;
constexpr int MAX_MT = 4;          // gate m-tiles a block (32 units, unshared)
constexpr int MAX_CLUSTER = 16;     // blocks a cluster (above 8: non-portable)
constexpr int BLOCK_SMEM = 232448;  // 227 KB
constexpr float BN_EPS = 1e-5f;
enum Mode { MODE_NONE = 0, MODE_BN = 1, MODE_AFFINE = 2 };

// The host's plan (ops/gsu_kernels.train_plan; mirrored by _TrainPlanC,
// same field order). Byte offsets into the block's shared memory; -1: the
// region lies in device memory instead (the packed weights as the host
// gave them, the state in the kernel's scratch).
struct TrainPlan {
  int T, R, H, G, shared, mode;
  int nblk, J, JT, KT, KTg, MT, MTd, Rp, ldJ, ngb, nterm;
  int smem, o_bits, o_vec, o_part, o_wg, o_wd, o_pre;
  int o_state[2];
};

// bits 0 and 1 of x as a pair of bf16 1.0 / 0.0 (low half bit 0)
__device__ __forceinline__ uint32_t spread2(uint32_t x) {
  return (((x & 3u) * 0x8001u) & 0x10001u) * 0x3F80u;
}

// d = a b (zero accumulator) and d += a b: mma.sync m16n8k16 bf16 -> f32
__device__ __forceinline__ void mma0(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "f"(0.f));
}
__device__ __forceinline__ void mma1(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The block-local unit and row of accumulator e of m-tile mt, row group ng.
__device__ __forceinline__ int elem_unit(int shared, int mt, int gid, int e) {
  return shared ? 16 * mt + gid + 8 * (e >> 1) : 8 * mt + gid;
}
__device__ __forceinline__ int elem_row(int ng, int tig, int e) { return 8 * ng + 2 * tig + (e & 1); }
// unshared weights take accumulators 0 and 1 (f), with 2 and 3 their c gates
__device__ __forceinline__ bool elem_live(int shared, int e) { return shared || e < 2; }
// The recurrent gate product of m-tiles mt0, mt0 + 1 (i < nmt) for the warp's
// row groups ng0 .. ng0 + NGB - 1: acc[i][n] += W^T h over the KT k-tiles.
// wg: the block's fragments [MT][KT][NTERM][32] uint4; hb: the spike slices.
// float32 streams give each weight as three bf16 terms (hi, mid, lo: exact,
// ops/gsu_kernels.train_pack). Each k-tile (and each term) is summed from
// zero by the tensor core and then added in float32: the tensor core sums
// a tile's 16 products of 8-bit mantissas exactly, but it truncates when it
// adds a running sum (a pair of k-tiles chained in the accumulator parted
// float32 D from its plain version by 1.6e-5 after 23 steps in mode
// "affine"), and the spikes' chaos makes any bias visible.
template <int NGB, int NTERM>
__device__ __forceinline__ void gate_product(float (&acc)[2][NGB][4], const uint4* wg, int mt0,
                                             int nmt, const TrainPlan& p, const uint8_t* hb,
                                             int ng0, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const int NG = p.Rp >> 3, row_bytes = 2 * p.JT;
  int blk = 0, kk = 0;  // the k-tile's block and its k-tile within that block
  for (int kt = 0; kt < p.KT; ++kt) {
    const uint8_t* col = hb + (size_t)blk * p.Rp * row_bytes + 2 * kk;
    if (++kk == p.JT) {
      kk = 0;
      ++blk;
    }
    uint32_t b[NGB][2];
#pragma unroll
    for (int n = 0; n < NGB; ++n) {
      uint32_t bits = 0;
      if (ng0 + n < NG)
        bits = *reinterpret_cast<const uint16_t*>(col + (size_t)(8 * (ng0 + n) + gid) * row_bytes);
      b[n][0] = spread2(bits >> (2 * tig));
      b[n][1] = spread2(bits >> (2 * tig + 8));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= nmt) break;
      const uint4* w = wg + ((size_t)(mt0 + i) * p.KT + kt) * NTERM * 32 + lane;
      uint4 a[NTERM];
#pragma unroll
      for (int e = 0; e < NTERM; ++e) a[e] = w[e * 32];
#pragma unroll
      for (int n = 0; n < NGB; ++n) {
        float d[4];
        mma0(d, a[0], b[n][0], b[n][1]);
        if constexpr (NTERM > 1) {
          float d2[4], d3[4];
          mma0(d2, a[1], b[n][0], b[n][1]);
          mma0(d3, a[2], b[n][0], b[n][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] += d2[e] + d3[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += d[e];
      }
    }
  }
}

// float32 streams in kernel D: the gate product on the CUDA cores, summed
// in k order, so that each sum is the plain version's: torch.matmul's
// float32 product, like the former row-split kernel, adds the fired
// weights of k = 0, 1, ... in turn (fmaf(h, w, a) with h 0 or 1 is a + w
// or a, as here), and kernel D's chaos (BN, or the affine mode's gains above
// 1) turns any other order's roundings into visible drift. A lane takes one
// row of the warp's item and UPL = 4 NGB gate columns of each m-tile (4 /
// NGB lanes a row), so that one spike bit gates UPL additions of weights
// that every lane of the warp reads at once; the sums go straight into the
// warp's tile of pre-activations (pre [8 NGB rows][pre_ld], m-tile i at
// columns 16 i ..). wf: the block's gate columns as floats [MT][KT 16][16]
// (gate row m of m-tile mt at [mt][k][m]). At t = 0 (no product) the tile
// gets zeros.
template <int NGB>
__device__ __forceinline__ void gate_product_f32(float* pre, int pre_ld, const float* wf,
                                                 int mt0, int nmt, const TrainPlan& p,
                                                 const uint8_t* hb, int ng0, int lane,
                                                 bool product) {
  constexpr int LPR = 4 / NGB, UPL = 16 / LPR;  // lanes a row, columns a lane and m-tile
  const int row = lane / LPR, m0 = (lane % LPR) * UPL;
  const int NG = p.Rp >> 3, row_bytes = 2 * p.JT, K16 = p.KT * 16;
  const bool live = ng0 * 8 + row < NG * 8 && row < NGB * 8;
  float acc[2][UPL];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int m = 0; m < UPL; ++m) acc[i][m] = 0.f;
  if (product) {
    int blk = 0, kk = 0;
    for (int kt = 0; kt < p.KT; ++kt) {
      const uint8_t* col = hb + (size_t)blk * p.Rp * row_bytes + 2 * kk;
      if (++kk == p.JT) {
        kk = 0;
        ++blk;
      }
      const uint32_t bits =
          live ? *reinterpret_cast<const uint16_t*>(col + (size_t)(8 * ng0 + row) * row_bytes) : 0u;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const bool fire = (bits >> q) & 1u;
        const float x = fire ? 1.f : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i >= nmt) break;
          const float4* w = reinterpret_cast<const float4*>(
              wf + ((size_t)(mt0 + i) * K16 + 16 * kt + q) * 16 + m0);
#pragma unroll
          for (int v = 0; v < UPL / 4; ++v) {
            const float4 wv = w[v];
            if constexpr (NGB > 1) {  // 8 or 16 columns a lane: the adds under the spike
              if (fire) {
                acc[i][4 * v] += wv.x;
                acc[i][4 * v + 1] += wv.y;
                acc[i][4 * v + 2] += wv.z;
                acc[i][4 * v + 3] += wv.w;
              }
            } else {  // 4 columns a lane: fmaf with the spike as 1.0 or 0.0 (measured faster)
              acc[i][4 * v] = fmaf(x, wv.x, acc[i][4 * v]);
              acc[i][4 * v + 1] = fmaf(x, wv.y, acc[i][4 * v + 1]);
              acc[i][4 * v + 2] = fmaf(x, wv.z, acc[i][4 * v + 2]);
              acc[i][4 * v + 3] = fmaf(x, wv.w, acc[i][4 * v + 3]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int v = 0; v < UPL / 4; ++v)
      if (row < NGB * 8)
        *reinterpret_cast<float4*>(pre + row * pre_ld + 16 * i + m0 + 4 * v) =
            make_float4(acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2], acc[i][4 * v + 3]);
}

// Ask for the lines of R row segments, base + r stride .. + bytes, ahead of
// their use: into L1 (the next step's inputs of a block that reads them
// once, when they fit beside its shared memory) or L2. Without it every
// step's first touch of its inputs is a device-memory round trip a row.
template <bool L1>
__device__ __forceinline__ void prefetch_rows(const void* base, size_t stride, int bytes, int R) {
  for (int r = threadIdx.x; r < R; r += NTHREADS) {
    const char* p = static_cast<const char*>(base) + (size_t)r * stride;
    for (uintptr_t q = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(127);
         q < reinterpret_cast<uintptr_t>(p) + bytes; q += 128) {
      if constexpr (L1)
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(q));
      else
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(q));
    }
  }
}

// sum over the warps of part[w][u], in warp order
__device__ __forceinline__ float warp_sum(const float* part, int J, int u) {
  float s = 0.f;
#pragma unroll 4
  for (int w = 0; w < NW; ++w) s += part[w * J + u];
  return s;
}

// Optional phase profile (out non-null): thread 0 of each block adds the SM
// cycles since its previous mark to phase j, and writes out[block][NPROF]
// at the end (ops/gsu_kernels.train_profile).
constexpr int NPROF = 6;
struct PhaseClock {
  unsigned long long* out;
  unsigned long long acc[NPROF];
  unsigned long long last;
  __device__ __forceinline__ void start(unsigned long long* o) {
    out = threadIdx.x == 0 ? o : nullptr;
#pragma unroll
    for (int j = 0; j < NPROF; ++j) acc[j] = 0;
    last = out ? clock64() : 0;
  }
  __device__ __forceinline__ void mark(int j) {  // j a constant at every call
    if (out) {
      const unsigned long long now = clock64();
      acc[j] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void finish(int blk) {
    if (out)
#pragma unroll
      for (int j = 0; j < NPROF; ++j) out[blk * NPROF + j] = acc[j];
  }
};

// Allow the kernel a cluster of more than 8 blocks (16 on an H100) when the
// plan asks for one.
template <typename K>
inline cudaError_t allow_cluster(K kern, int nblk) {
  if (nblk <= 8) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Checks common to both launchers: the plan's geometry and its shared memory.
inline bool plan_ok(const TrainPlan& p) {
  if (p.H < 1 || p.H > 512 || p.R < 1 || p.nblk < 1 || p.nblk > MAX_CLUSTER || p.J < 16 ||
      p.J % 16 || p.JT != p.J / 16 || p.nblk * p.J < p.H || (p.nblk - 1) * p.J >= p.H ||
      p.KT != (p.H + 15) / 16 || p.MT > MAX_MT || p.MT != (p.shared ? p.JT : 2 * p.JT) ||
      p.Rp % 8 || p.Rp < p.R || (p.ngb != 1 && p.ngb != 2 && p.ngb != 4) ||
      p.G != (p.shared ? p.H : 2 * p.H) || p.ldJ < p.J)
    return false;
  return p.smem <= BLOCK_SMEM && p.o_bits == 0 && p.o_vec >= 0 && p.o_part >= 0;
}

}  // namespace gsut
