// Shared device code of the GSU kernels: typed loads and stores (every
// kernel; D and E through gsu_train_mma.cuh), the GSU cell step (A, C, and
// B and F through gsu_eval_mma.cuh), and kernel A's (gsu_stack_eval.cu)
// per-thread row-tile dot product and stack step.
//
// Kernel A's layout: a block owns RB rows (batch rows or sub-band unit rows)
// and one thread per hidden unit j. Row-tile activations live in shared
// memory input-major, x[i * RB + r], so one thread reads the RB values of
// input i with two 16-byte loads (all threads of a warp read the same
// address: a broadcast) and multiplies them by the single weight w[i][j] it
// loaded from global memory (coalesced across j, served from L2).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gsu {

constexpr int RB = 8;      // rows per block
constexpr int MAX_L = 4;   // layers per stack (template-instantiated 1..MAX_L)

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int KB = 16;     // weights loaded ahead per dot_rows batch

// acc[r] += x[r] * w for the RB rows of one input (two 16-byte smem loads).
__device__ __forceinline__ void fma_rows(const float* __restrict__ x, float w, float (&acc)[RB]) {
  static_assert(RB == 8, "fma_rows unpacks two float4 per input");
  const float4 p = reinterpret_cast<const float4*>(x)[0];
  const float4 q = reinterpret_cast<const float4*>(x)[1];
  const float xv[RB] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = fmaf(xv[r], w, acc[r]);
}

// a[r] = sum_i x[i*RB + r] * w[i*G + col]; a2 likewise with column col2
// when col2 >= 0 (the cell half of unshared weights). Sequential f32 sums
// over i. The weight loads are L2 round trips: KB of them are issued before
// their FMAs so that several are in flight per thread.
template <typename W>
__device__ __forceinline__ void dot_rows(const float* __restrict__ x, int n_in,
                                         const W* __restrict__ w, int G, int col,
                                         int col2, float (&a)[RB], float (&a2)[RB]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) { a[r] = 0.f; a2[r] = 0.f; }
  const bool two = col2 >= 0;
  int i = 0;
  for (; i + KB <= n_in; i += KB) {
    float w1[KB], w2[KB];
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      w1[q] = ld(w + (size_t)(i + q) * G + col);
      w2[q] = two ? ld(w + (size_t)(i + q) * G + col2) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      fma_rows(x + (i + q) * RB, w1[q], a);
      if (two) fma_rows(x + (i + q) * RB, w2[q], a2);
    }
  }
  for (; i < n_in; ++i) {
    fma_rows(x + i * RB, ld(w + (size_t)i * G + col), a);
    if (two) fma_rows(x + i * RB, ld(w + (size_t)i * G + col2), a2);
  }
}

// One GSU cell update with the eval BatchNorm folded to an affine:
// f = sigmoid(pre_f + b_f); c' = (f c + (1 - f)(pre_c + b_c)) scale + shift.
// expf is the precise one (no fast math): spike thresholds are sensitive.
__device__ __forceinline__ float cell(float pre_f, float pre_c, float c, float b_f,
                                      float b_c, float scale, float shift) {
  const float f = 1.f / (1.f + expf(-(pre_f + b_f)));
  const float g = pre_c + b_c;
  return (f * c + (1.f - f) * g) * scale + shift;
}

// Per-thread coefficients of hidden unit j: coef is [L][4][H] f32 rows
// (b_f, b_c, bn scale, bn shift).
template <int L>
__device__ __forceinline__ void load_coef(const float* __restrict__ coef, int H, int j,
                                          bool active, float (&cf)[L][4]) {
#pragma unroll
  for (int k = 0; k < L; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) cf[k][q] = active ? coef[(k * 4 + q) * H + j] : 0.f;
}

// One timestep of an L-layer stack for the block's RB rows.
//   px/pxc  layer-0 input gates of unit j (f and c halves; pxc unused when
//           shared); overwritten by the inter-layer products.
//   hs      [L][H][RB] spikes in shared memory: step t-1's on entry, step
//           t's on exit. c: the membranes after BN, in registers.
//   emit(k, r, spike) is called for every layer, row and active unit.
// Two barriers per layer: every thread has read layer k's old spikes before
// any is overwritten, and the new ones are visible before layer k+1 reads.
template <int L, typename W, typename Emit>
__device__ __forceinline__ void stack_step(float* hs, int H, int G, bool shared, int j,
                                           bool active, const W* __restrict__ wihr,
                                           const W* __restrict__ whh,
                                           const float (&cf)[L][4], float (&c)[L][RB],
                                           float (&px)[RB], float (&pxc)[RB], Emit emit) {
  const int j2 = shared ? -1 : H + j;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    float ph[RB], phc[RB];
    if (active) {
      if (k > 0)
        dot_rows(hs + (k - 1) * H * RB, H, wihr + (size_t)(k - 1) * H * G, G, j, j2, px, pxc);
      dot_rows(hs + k * H * RB, H, whh + (size_t)k * H * G, G, j, j2, ph, phc);
    }
    __syncthreads();
    if (active) {
      float hv[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float pre_f = px[r] + ph[r];
        const float pre_c = shared ? pre_f : pxc[r] + phc[r];
        const float cy = cell(pre_f, pre_c, c[k][r], cf[k][0], cf[k][1], cf[k][2], cf[k][3]);
        c[k][r] = cy;
        hv[r] = cy >= 0.f ? 1.f : 0.f;
        emit(k, r, hv[r]);
      }
      float4* dst = reinterpret_cast<float4*>(hs + (k * H + j) * RB);
      dst[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
      dst[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
    }
    __syncthreads();
  }
}

}  // namespace gsu
