// Kernel E: the reverse-time backward of kernel D (one GSU layer), and its
// weight gradient as a second kernel.
//
// Replaces spiking_fullsubnet_tpu/ops/gsu_pallas.py: _bwd_kernel (:358),
// run by _run_bwd (:469, pallas_call :499) from _gsu_train_bwd (:568). The
// TPU kernel accumulates dW_hh in its body (:454-456); here that product is
// train_dw_kernel below.
//
// Per step t, from T-1 down to 0, and row r: the gates are recomputed from
// y[t-1] (h = 0 and c = 0 before the first step, not spike(0) = 1):
// h_prev = (y[t-1] >= 0), c_prev = y[t-1], f and g as in kernel D. Then
//   dy  = (gout[t] + dh) max(1 - |y[t]|, 0) + dc    (triangle surrogate)
//   dc' = gamma rstd (dy - sum(dy)/R - xhat sum(dy xhat)/R)   mode "bn"
//         (xhat = (c' - mean) rstd, sums over all R rows), else dc' = dy
//   dpre_f = dc' (c_prev - g) f (1 - f), dpre_c = dc' (1 - f),
//   dc = dc' f, drg = dpre_f + dpre_c (shared) or [dpre_f, dpre_c],
//   dxg[t] = drg, dh = drg @ W_hh^T (dense: drg is not sparse),
// with db, dgamma = sum(dy xhat) and dbeta = sum(dy) summed over steps and
// rows. dW_hh = sum over t, r of h_prev^T drg is train_dw_kernel's, from the
// saved y and dxg. Two stream types, as kernel D: float32, or bfloat16 xg,
// gout, dxg and W_hh. With bf16 streams drg is rounded to bf16 before dh =
// drg @ W_hh^T and before dW, as the TPU kernel rounds its matmul operands
// (gsu_pallas.py:449-460); y, the carried dh and dc, db and dgamma/dbeta
// stay float32. Precise expf and 1/sqrtf, no fast math.
//
// What bounds it on an H100: as kernel D, the chain of 751 dependent steps
// (two products, the cell's backward and the BN sums each step), not the
// bytes (xg, y, gout read, dxg written) or the operations.
//
// Design: kernel D's unit split (gsu_train_mma.cuh): block b of one cluster
// owns units J_b for all R rows, so the BN sums over the rows are the
// block's own, in a fixed order, with no cluster barrier. Three kernels:
//   - train_bits_kernel packs the signs of y into bits ([T-1][block][Rp]
//     [2 JT] bytes, kernel D's layout);
//   - train_gates_kernel recomputes f and g of every step at once, a block
//     a (unit block, step) over the whole card: they depend on y alone, not
//     on the backward's recurrence. It is D's product (the block's gate
//     columns of W_hh as A fragments, h_{t-1} as bits; float32 weights as
//     three exact bf16 terms) and D's cell, into a [2][T][R][H] float32
//     scratch (0.7 GB at flagship M's section 0, 2.4 GB at baseline L's
//     1536 rows): this takes the product and the precise expf out of the
//     751-step chain;
//   - train_bwd_kernel runs the chain: per step, dy and the BN sums (a warp
//     a row, a lane a unit, so every [T, R, H] access is one run of the
//     block's units), the cell's backward into dxg[t], one cluster barrier,
//     then dh[:, J_b] = drg[R, G] @ W_hh[J_b, :]^T, which needs every
//     block's drg: it reads the whole dxg[t] from L2 (ld.global.cg; the
//     barrier orders the writes) as mma B fragments, 2-3 k-tiles ahead, a
//     lane's four values of a row in one 8- or 16-byte load (train_pack
//     orders dh's k slots to match), against its rows of W_hh as A
//     fragments in shared memory. float32 streams split both operands into
//     three exact bf16 terms and sum the six products above 2^-24.
// The row split with tensor cores (E's former layout) would read all of
// W_hh twice a step from L2 (2 H G bytes a block) and sum the BN terms
// across the cluster; the unit split reads R G bytes of drg a step, the
// same at flagship M's section 0 and less at the smaller sections, and the
// phase profile (train_profile) times that exchange. dh and dc stay in
// shared memory as far as the plan finds room, else in a device scratch;
// db, dgamma and dbeta are reduced per step in a fixed order and summed
// over the steps by one thread a unit. No atomics: the step is bitwise
// deterministic.
// Where it waits now: see PERF.md section 7 (the phase profile).
//
// train_dw_kernel: dW [H, G] = sum over n of h_prev[n]^T dxg[n], n over the
// T R rows (h_prev of rows n < R is zero): a matrix product with K = (T-1) R
// summed rows (384k at zoo M's section 0), M = H and N = G of 224-320.
// Bound on an H100 by bytes (y read in f32, dxg in the stream type), so the
// design must fill the card and keep the products off the CUDA cores:
//   - split-K: the host's plan (ops/gsu_kernels.dw_split_plan) cuts the
//     rows into `splits` chunks so that the 64 x 64 output tiles times the
//     splits are a multiple of the 132 SMs; each block writes its float32
//     partial to a scratch [splits, H, G], and a second kernel adds the
//     partials in split order. No atomics: the sum's order is fixed, so dW
//     is bitwise the same from run to run.
//   - tensor cores: h_prev is 0 or 1, exact in bf16; mma.sync m16n8k16
//     bf16 -> f32. bf16 streams multiply dxg as it is (the rounded drg);
//     float32 streams split each dxg value exactly into three bf16 terms
//     (hi + mid + lo) and multiply all three, hi into one float32
//     accumulator and mid and lo into a second, added at the end. This
//     keeps float32's value (TF32 would round dxg to 10 bits) at three
//     times the products, which the card has to spare: the bytes bound the
//     kernel, not the products. (CUDA-core FMAs would take the float32
//     products at 67 TFLOP/s, near the bytes' time at section 0.)
//   - staging through registers, not cp.async or TMA: neither operand is
//     multiplied as it lies in memory. y is float32 and becomes a bf16
//     spike (y >= 0), and float32 dxg becomes three bf16 terms, so each
//     value passes through a register on its way to shared memory. A copy
//     engine would land the raw bytes (y's twice the spikes' size) in
//     shared memory for a second pass to convert. So each thread loads the
//     next 32-row chunk into registers while the current one is multiplied,
//     then converts and stores it into the other of two buffers. The ring is
//     two chunks deep; a deeper one is not measured. At flagship M's
//     fullband (320 x 320: nine 128 x 128 tiles x 44 splits = 396 blocks, two
//     a SM) the grid runs 1.5 waves.
// Only the order of the float32 sums differs from the plain version.
//
// Band mode (train_bwd_kernel's BAND instance, gsu_train_bwd_band_launch),
// kernel D's band mode's backward: the recurrence's [sum dy, sum dy x-hat]
// of the rank's real rows is swapped with the band group once a step inside
// the kernel (band_exchange, gsu_train_mma.cuh); a real row's BN backward
// takes the group's sums over the group's real rows, a pad row's is gamma
// rstd dy; dgamma and dbeta keep the rank's own rows' share, db every row
// of the rank. The bits, the gates and dW run on the rank's rows as above.
#include <cooperative_groups.h>

#include <type_traits>

#include "gsu_train_mma.cuh"

namespace cg = cooperative_groups;
using namespace gsu;
using namespace gsut;

namespace {

constexpr int RS = 4;  // rows a warp loads at once in the recurrence's passes 1 and 2

// The warp's per-unit sums (a lane's units lane % upl and + 32, two rows'
// lanes added when upl is 16) into part[warp][u] and part2[warp][u].
__device__ __forceinline__ void block_partials(float* part, float* part2, float (&s0)[2],
                                               float (&s1)[2], int J, int upl, int warp,
                                               int lane) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (upl == 16) {
      s0[q] += __shfl_xor_sync(0xffffffffu, s0[q], 16);
      s1[q] += __shfl_xor_sync(0xffffffffu, s1[q], 16);
    }
    const int u = lane + 32 * q;
    if (lane < upl && u < J) {
      part[warp * J + u] = s0[q];
      part2[warp * J + u] = s1[q];
    }
  }
}

// the signs of y as bits: bits[t][b][r][q] for t < T1 = T - 1, bit k = (y[t][r][b J + 8 q
// + k] >= 0); zero past R rows and H units
__global__ void train_bits_kernel(const float* __restrict__ y, uint8_t* __restrict__ bits,
                                  int T1, int R, int H, int Rp, int J, int nblk) {
  const int JB = J / 8;
  const long long n = (long long)T1 * nblk * Rp * JB;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int q = (int)(i % JB);
    long long rest = i / JB;
    const int r = (int)(rest % Rp);
    rest /= Rp;
    const int b = (int)(rest % nblk);
    const long long t = rest / nblk;
    unsigned v = 0;
    if (r < R) {
      const int u0 = b * J + 8 * q;
      const float* yr = y + ((size_t)t * R + r) * H;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (u0 + k < H && yr[u0 + k] >= 0.f) v |= 1u << k;
    }
    bits[i] = (uint8_t)v;
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the three exact bf16 terms (hi, mid, lo) of two float32 values, as pairs
__device__ __forceinline__ void split_pair(float x, float y, uint32_t (&t)[3]) {
  const float hx = __bfloat162float(__float2bfloat16(x)), hy = __bfloat162float(__float2bfloat16(y));
  const float rx = x - hx, ry = y - hy;
  const float mx = __bfloat162float(__float2bfloat16(rx)), my = __bfloat162float(__float2bfloat16(ry));
  t[0] = bf16_pair(hx, hy);
  t[1] = bf16_pair(mx, my);
  t[2] = bf16_pair(rx - mx, ry - my);
}

// Four drg values of a row at gate columns g .. g + 3 (zero past G), from
// L2: one 8-byte (bf16) or 16-byte (float32) load where the row allows.
// train_pack permutes each 16-column k-tile of dh's weights so that lane
// tig's four k slots of the mma (2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9)
// are the four consecutive columns 16 kt + 4 tig .. + 3 of drg.
__device__ __forceinline__ uint2 drg_quad(const __nv_bfloat16* row, int g, int G, bool vec) {
  if (vec && g + 3 < G) return __ldcg(reinterpret_cast<const uint2*>(row + g));
  unsigned h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    h[q] = g + q < G ? __ldcg(reinterpret_cast<const unsigned short*>(row + g + q)) : 0u;
  return make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
}
__device__ __forceinline__ float4 drg_quad(const float* row, int g, int G, bool vec) {
  if (vec && g + 3 < G) return __ldcg(reinterpret_cast<const float4*>(row + g));
  return make_float4(g < G ? __ldcg(row + g) : 0.f, g + 1 < G ? __ldcg(row + g + 1) : 0.f,
                     g + 2 < G ? __ldcg(row + g + 2) : 0.f, g + 3 < G ? __ldcg(row + g + 3) : 0.f);
}
// the quad as B fragments (b0, b1) of each bf16 term
__device__ __forceinline__ void b_terms(uint2 v, uint32_t (&b)[2][1]) {
  b[0][0] = v.x;
  b[1][0] = v.y;
}
__device__ __forceinline__ void b_terms(float4 v, uint32_t (&b)[2][3]) {
  split_pair(v.x, v.y, b[0]);
  split_pair(v.z, v.w, b[1]);
}

// dh of m-tiles mt0, mt0 + 1 (i < nmt) of the block's units for the warp's
// row groups: acc[i][n] += W_hh[J_b, :] drg^T over the KTg k-tiles of gate
// columns. wd: the block's fragments [MTd][KTg][NTERM][32]; dx: dxg[t] [R][G],
// every block's columns, read from L2 PF k-tiles ahead (the raw values in
// the ring; float32's three terms split at use). float32 streams split both
// operands into three exact bf16 terms and sum the six products above
// 2^-24 (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid). Each k-tile is
// summed from zero and added in float32.
template <int NGB, typename IO>
__device__ __forceinline__ void dh_product(float (&acc)[2][NGB][4], const uint4* wd, int mt0,
                                           int nmt, const TrainPlan& p, const IO* dx, int ng0,
                                           int lane) {
  constexpr bool F32 = sizeof(IO) == 4;
  constexpr int NTERM = F32 ? 3 : 1;
  constexpr int PF = F32 ? 2 : 3;  // k-tiles in flight while one is multiplied
  using Raw = std::conditional_t<F32, float4, uint2>;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = p.G, KTg = p.KTg;
  // whole 4-column groups of every row on 8- or 16-byte boundaries
  const bool vec = G % 4 == 0 && (reinterpret_cast<uintptr_t>(dx) & 15) == 0;
  const IO* rows[NGB];
  bool live[NGB];
#pragma unroll
  for (int n = 0; n < NGB; ++n) {
    const int r = 8 * (ng0 + n) + gid;
    live[n] = r < p.R;
    rows[n] = dx + (size_t)(live[n] ? r : 0) * G;
  }
  Raw buf[PF + 1][NGB];
  auto load = [&](Raw (&f)[NGB], int kt) {
#pragma unroll
    for (int n = 0; n < NGB; ++n) {
      if (live[n] && kt < KTg) {
        f[n] = drg_quad(rows[n], 16 * kt + 4 * tig, G, vec);
      } else if constexpr (F32) {
        f[n] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        f[n] = make_uint2(0u, 0u);
      }
    }
  };
  auto mul = [&](const Raw (&f)[NGB], int kt) {
    uint32_t b[NGB][2][NTERM];
#pragma unroll
    for (int n = 0; n < NGB; ++n) b_terms(f[n], b[n]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= nmt) break;
      const uint4* w = wd + ((size_t)(mt0 + i) * KTg + kt) * NTERM * 32 + lane;
      uint4 a[NTERM];
#pragma unroll
      for (int e = 0; e < NTERM; ++e) a[e] = w[e * 32];
#pragma unroll
      for (int n = 0; n < NGB; ++n) {
        float d[4];
        mma0(d, a[0], b[n][0][0], b[n][1][0]);
        if constexpr (NTERM > 1) {
          float d2[4];
          mma0(d2, a[0], b[n][0][1], b[n][1][1]);  // hi mid
          mma1(d2, a[1], b[n][0][0], b[n][1][0]);  // mid hi
          mma1(d2, a[0], b[n][0][2], b[n][1][2]);  // hi lo
          mma1(d2, a[2], b[n][0][0], b[n][1][0]);  // lo hi
          mma1(d2, a[1], b[n][0][1], b[n][1][1]);  // mid mid
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] += d2[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += d[e];
      }
    }
  };
#pragma unroll
  for (int q = 0; q < PF; ++q) load(buf[q], q);
  for (int kt0 = 0; kt0 < KTg; kt0 += PF + 1) {
#pragma unroll
    for (int q = 0; q <= PF; ++q) {
      const int kt = kt0 + q;
      if (kt >= KTg) break;
      load(buf[(q + PF) % (PF + 1)], kt + PF);
      mul(buf[q], kt);
    }
  }
}

// The recomputed gates of every step, all at once: they depend on y alone,
// not on the backward's recurrence. Block (b, t) takes block b's units at
// step t for all R rows: D's product (bits of y[t-1], the gate fragments)
// and cell, f and g into fg [2][T][R][H] (float32).
template <typename IO, int NGB>
__global__ void __launch_bounds__(NTHREADS, 1)
train_gates_kernel(const IO* __restrict__ xg, const uint4* __restrict__ wgfrag,
                   const uint8_t* __restrict__ hbits, const float* __restrict__ b2,
                   float* __restrict__ fg, const TrainPlan p) {
  constexpr int NTERM = sizeof(IO) == 4 ? 3 : 1;
  const int b = blockIdx.x, t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int H = p.H, R = p.R, G = p.G, J = p.J, shared = p.shared;
  const int J0 = b * J, Jb = min(J, H - J0);
  const int NG = p.Rp >> 3, NB = (NG + NGB - 1) / NGB;
  const size_t step_bytes = (size_t)p.nblk * p.Rp * 2 * p.JT;
  const uint4* wg = wgfrag + (size_t)b * p.MT * p.KT * NTERM * 32;
  const uint8_t* hb = hbits + (t > 0 ? (size_t)(t - 1) * step_bytes : 0);
  const IO* xt = xg + (size_t)t * R * G;
  float* F = fg + (size_t)t * R * H;
  float* Gs = F + (size_t)p.T * R * H;
  const int nchunk = (p.MT + 1) / 2;
  for (int c = 0; c < nchunk; ++c) {
    const int nmt = min(2, p.MT - 2 * c);
    for (int bt = warp; bt < NB; bt += NW) {
      const int ng0 = bt * NGB;
      float acc[2][NGB][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < NGB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
      if (t > 0) gate_product<NGB, NTERM>(acc, wg, 2 * c, nmt, p, hb, ng0, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < NGB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!elem_live(shared, e) || i >= nmt) continue;
            const int u = elem_unit(shared, 2 * c + i, gid, e);
            const int r = elem_row(ng0 + n, tig, e);
            if (r >= R || u >= Jb) continue;
            const IO* x = xt + (size_t)r * G + J0 + u;
            const float pre_f = acc[i][n][e] + ld(x);
            const float pre_c = shared ? pre_f : acc[i][n][(e + 2) & 3] + ld(x + H);
            const size_t o = (size_t)r * H + J0 + u;
            F[o] = 1.f / (1.f + expf(-(pre_f + b2[J0 + u])));
            Gs[o] = pre_c + b2[H + J0 + u];
          }
    }
  }
}

// The reverse-time recurrence. Passes 1 and 2 take one row a warp at a
// time, a lane a unit (lane and lane + 32), so that every access to the
// [T, R, H] tensors is one contiguous run of the block's units; pass 3 (the
// dh product) takes the mma layout.
template <typename IO, int NGB, bool BAND>
__global__ void __launch_bounds__(NTHREADS, 1)
train_bwd_kernel(const float* __restrict__ y, const IO* __restrict__ gout,
                 const float* __restrict__ stats, const float* __restrict__ fg,
                 const uint4* __restrict__ wdfrag, const float* __restrict__ bnp, IO* dxg,
                 float* __restrict__ db, float* __restrict__ dbn, float* __restrict__ gstate,
                 unsigned long long* __restrict__ prof, const TrainPlan p, const BandX bx) {
  constexpr int NTERM = sizeof(IO) == 4 ? 3 : 1;
  extern __shared__ uint4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // band mode: cluster cl of the grid is band rank me on the cl-th of each
  // stacked tensor; the BN sums run over its leading rows_real rows and are
  // exchanged with the group, BN's count is the group's
  int me = 0, Rs = p.R;
  if constexpr (BAND) {
    const int cl = (int)blockIdx.x / p.nblk;
    const size_t TRH = (size_t)p.T * p.R * p.H;
    me = bx.rank + cl;
    Rs = bx.rows_real[me];
    y += cl * TRH;
    gout += cl * TRH;
    stats += (size_t)cl * p.T * 2 * p.H;
    fg += cl * 2 * TRH;
    dxg += (size_t)cl * p.T * p.R * p.G;
    db += (size_t)cl * 2 * p.H;
    dbn += (size_t)cl * 2 * p.H;
    gstate += (size_t)cl * p.nblk * 2 * p.Rp * p.ldJ;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int H = p.H, R = p.R, G = p.G, J = p.J, shared = p.shared;
  const bool bn = p.mode == MODE_BN;
  const int J0 = rank * J, Jb = min(J, H - J0);
  const int NG = p.Rp >> 3, NB = (NG + NGB - 1) / NGB;
  // [5][J]: gamma, mean, rstd, sum(dy), sum(dy xhat)
  float* vec = reinterpret_cast<float*>(sm + p.o_vec);
  float* part = reinterpret_cast<float*>(sm + p.o_part);  // [2][NW][J]
  float* part2 = part + NW * J;
  const size_t wd_n = (size_t)p.MTd * p.KTg * NTERM * 32;
  const uint4* wd = wdfrag + rank * wd_n;
  if (p.o_wd >= 0) {
    uint4* dst = reinterpret_cast<uint4*>(sm + p.o_wd);
    for (size_t i = tid; i < wd_n; i += NTHREADS) dst[i] = wd[i];
    wd = dst;
  }
  // per-element state [Rp][ldJ]: dh (dy within a step) and dc
  float* DH = p.o_state[0] >= 0 ? reinterpret_cast<float*>(sm + p.o_state[0])
                                : gstate + ((size_t)rank * 2) * p.Rp * p.ldJ;
  float* DC = p.o_state[1] >= 0 ? reinterpret_cast<float*>(sm + p.o_state[1])
                                : gstate + ((size_t)rank * 2 + 1) * p.Rp * p.ldJ;
  for (int i = tid; i < p.Rp * p.ldJ; i += NTHREADS) DH[i] = DC[i] = 0.f;
  for (int u = tid; u < J; u += NTHREADS) vec[u] = u < Jb ? bnp[J0 + u] : 0.f;
  __syncthreads();
  const float inv_n = 1.f / (float)(BAND ? bx.rows_global : R);
  const size_t RH = (size_t)R * H, TRH = (size_t)p.T * RH;
  // dh's m-tiles an item: two, or one when the pairs would leave warps idle
  const int cmd = p.MTd > 1 && (p.MTd + 1) / 2 * NB < NW ? 1 : 2;
  const int nchunk_d = (p.MTd + cmd - 1) / cmd;
  // passes 1 and 2: upl lanes a row (all 32, or 16 when J is 16, two rows an
  // instruction: rpi), units lane % upl and + 32 (qn of them); nslot row slots
  const int upl = J <= 16 ? 16 : 32, rpi = 32 / upl, qn = (J + 31) / 32;
  const int nslot = (R + rpi - 1) / rpi;
  const float* gamma = vec;
  const float* mean = vec + J;
  const float* rstd = vec + 2 * J;
  const float* sum_dy = vec + 3 * J;
  const float* sum_dyx = vec + 4 * J;
  float db_f = 0.f, db_c = 0.f, dgam = 0.f, dbet = 0.f;  // thread u's unit u
  // phases: 0 dy, 1 BN sums, 2 cell backward and dxg, 3 barrier, 4 dh, 5 block barrier
  PhaseClock clk;
  clk.start(prof);

  for (int t = p.T - 1; t >= 0; --t) {
    if (bn)
      for (int u = tid; u < J; u += NTHREADS) {
        const bool in = u < Jb;
        vec[J + u] = in ? stats[(size_t)t * 2 * H + J0 + u] : 0.f;
        vec[2 * J + u] = in ? 1.f / sqrtf(stats[((size_t)t * 2 + 1) * H + J0 + u] + BN_EPS) : 0.f;
      }
    if (t > 0) {  // the next step's inputs of the block's units, into L2
      const size_t on = (size_t)(t - 1) * RH + J0;
      const size_t rs = (size_t)H * sizeof(float);
      const int nb = Jb * (int)sizeof(float);
      prefetch_rows<false>(y + on, rs, nb, R);
      prefetch_rows<false>(gout + on, (size_t)H * sizeof(IO), Jb * (int)sizeof(IO), R);
      prefetch_rows<false>(fg + on, rs, nb, R);
      prefetch_rows<false>(fg + TRH + on, rs, nb, R);
      if (t > 1) prefetch_rows<false>(y + on - RH, rs, nb, R);
    }
    __syncthreads();
    const size_t ot = (size_t)t * RH;
    // pass 1: dy from the carried dh and dc; the rows' BN sums. A warp takes
    // rows warp, warp + NW, ..., RS of them at once: their loads first, so
    // that RS round trips to L2 are in flight together
    {
      float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
      for (int r0 = warp; r0 < nslot; r0 += NW * RS) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int u = lane % upl + 32 * q;
          if (q >= qn) break;
          float yv[RS], gv[RS], fv[RS], gg[RS], yp[RS], dh[RS], dc[RS];
#pragma unroll
          for (int i = 0; i < RS; ++i) {
            const int r = (r0 + i * NW) * rpi + lane / upl;
            yv[i] = gv[i] = fv[i] = gg[i] = yp[i] = dh[i] = dc[i] = 0.f;
            if (r >= R || u >= Jb) continue;
            const size_t o = ot + (size_t)r * H + J0 + u;
            yv[i] = y[o];
            gv[i] = ld(gout + o);
            dh[i] = DH[r * p.ldJ + u];
            dc[i] = DC[r * p.ldJ + u];
            if (bn) {
              fv[i] = fg[o];
              gg[i] = fg[TRH + o];
              yp[i] = t > 0 ? y[o - RH] : 0.f;
            }
          }
#pragma unroll
          for (int i = 0; i < RS; ++i) {
            const int r = (r0 + i * NW) * rpi + lane / upl;
            if (r >= R || u >= Jb) continue;
            const float surr = fmaxf(1.f - fabsf(yv[i]), 0.f);
            const float dy = (gv[i] + dh[i]) * surr + dc[i];
            DH[r * p.ldJ + u] = dy;
            if (bn && (!BAND || r < Rs)) {
              const float xhat = (fv[i] * yp[i] + (1.f - fv[i]) * gg[i] - mean[u]) * rstd[u];
              s0[q] += dy;
              s1[q] += dy * xhat;
            }
          }
        }
      }
      if (bn) block_partials(part, part2, s0, s1, J, upl, warp, lane);
    }
    clk.mark(0);
    if (bn) {
      __syncthreads();
      for (int u = tid; u < J; u += NTHREADS) {
        const float sdy = warp_sum(part, J, u), sdyx = warp_sum(part2, J, u);
        vec[3 * J + u] = sdy;
        vec[4 * J + u] = sdyx;
        dgam += sdyx;  // the rank's own rows' share
        dbet += sdy;
      }
      __syncthreads();
      if constexpr (BAND)  // [sum dy, sum dy x-hat] of the group, in place
        band_exchange<2>(bx, me, rank, J0, Jb, J, vec + 3 * J,
                         bx.seq0 + (unsigned long long)(p.T - 1 - t), t, 0);
    }
    clk.mark(1);
    // pass 2: the membrane gradient through BN and the cell; drg into dxg[t]
    IO* dxt = dxg + (size_t)t * R * G;
    {
      float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
      for (int r0 = warp; r0 < nslot; r0 += NW * RS) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int u = lane % upl + 32 * q;
          if (q >= qn) break;
          float fv[RS], gg[RS], yp[RS], dyv[RS];
#pragma unroll
          for (int i = 0; i < RS; ++i) {
            const int r = (r0 + i * NW) * rpi + lane / upl;
            fv[i] = gg[i] = yp[i] = dyv[i] = 0.f;
            if (r >= R || u >= Jb) continue;
            const size_t o = ot + (size_t)r * H + J0 + u;
            dyv[i] = DH[r * p.ldJ + u];
            fv[i] = fg[o];
            gg[i] = fg[TRH + o];
            yp[i] = t > 0 ? y[o - RH] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RS; ++i) {
            const int r = (r0 + i * NW) * rpi + lane / upl;
            if (r >= R || u >= Jb) continue;
            const int k = r * p.ldJ + u;
            const float f = fv[i], g = gg[i], dy = dyv[i], c_prev = yp[i];
            float dcr = dy;
            if (bn) {
              const float xhat = (f * c_prev + (1.f - f) * g - mean[u]) * rstd[u];
              dcr = gamma[u] * rstd[u] * (dy - inv_n * sum_dy[u] - xhat * (inv_n * sum_dyx[u]));
              if (BAND && r >= Rs) dcr = gamma[u] * rstd[u] * dy;  // a pad row: in no sum
            }
            const float dpre_f = dcr * (c_prev - g) * f * (1.f - f);
            const float dpre_c = dcr * (1.f - f);
            DC[k] = dcr * f;
            s0[q] += dpre_f;
            s1[q] += dpre_c;
            IO* dx = dxt + (size_t)r * G + J0 + u;
            if (shared) {
              st(dx, dpre_f + dpre_c);
            } else {
              st(dx, dpre_f);
              st(dx + H, dpre_c);
            }
          }
        }
      }
      block_partials(part, part2, s0, s1, J, upl, warp, lane);
    }
    clk.mark(2);
    cluster.sync();  // every block's dxg[t] written; the db partials complete
    clk.mark(3);
    for (int u = tid; u < J; u += NTHREADS) {
      db_f += warp_sum(part, J, u);
      db_c += warp_sum(part2, J, u);
    }
    // pass 3: dh of the block's units for step t - 1, from every block's drg
    if (t > 0) {
      for (int it = warp; it < nchunk_d * NB; it += NW) {  // (chunk, batch) pairs
        const int c = it / NB, ng0 = (it - c * NB) * NGB;
        const int nmt = min(cmd, p.MTd - cmd * c);
        float acc[2][NGB][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < NGB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
        dh_product<NGB, IO>(acc, wd, cmd * c, nmt, p, dxt, ng0, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < NGB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (i >= nmt) continue;
              const int u = elem_unit(1, cmd * c + i, gid, e);  // 16 units an m-tile
              const int r = elem_row(ng0 + n, tig, e);
              if (r < R && u < Jb) DH[r * p.ldJ + u] = acc[i][n][e];
            }
      }
    }
    clk.mark(4);
    __syncthreads();  // dh in place; part and vec free
    clk.mark(5);
  }
  for (int u = tid; u < Jb; u += NTHREADS) {
    db[J0 + u] = db_f;
    db[H + J0 + u] = db_c;
    dbn[J0 + u] = dgam;
    dbn[H + J0 + u] = dbet;
  }
  clk.finish(blockIdx.x);
}

// ---- train_dw_kernel: split-K tensor-core product, then a fixed-order sum ----
constexpr int DW_BK = 32;  // summed rows staged at once

// The block tile: bf16 streams 128 x 128 (eight warps of 64 x 32; y and dxg
// each read by two blocks of a split, through L2), float32 streams 64 x 64
// (four warps of 32 x 32: their three dxg terms need twice the shared
// memory and the accumulators). Mirrored by ops/gsu_kernels.DW_TILE.
template <typename IO> struct DwTile { static constexpr int m = 128, n = 128, threads = 256, per_sm = 2; };
template <> struct DwTile<float> { static constexpr int m = 64, n = 64, threads = 128, per_sm = 4; };

// The bf16 terms of a dxg value: bf16 streams are one term; a float32 value
// is split exactly into hi + mid + lo (each the bf16 rounding of what the
// terms before it leave; the residuals are exact in float32 and the last
// fits 8 bits), so three products of exact bf16 terms reproduce it. (Below
// about 2^-110 lo is subnormal and keeps fewer bits: under 2^-133 a value.)
template <typename IO> struct DwTerms { static constexpr int n = 1; };
template <> struct DwTerms<float> { static constexpr int n = 3; };

__device__ __forceinline__ void dw_split(float v, __nv_bfloat16 (&t)[1]) {
  t[0] = __float2bfloat16(v);
}
__device__ __forceinline__ void dw_split(float v, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16(v);
  const float r1 = v - __bfloat162float(t[0]);
  t[1] = __float2bfloat16(r1);
  t[2] = __float2bfloat16(r1 - __bfloat162float(t[1]));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8 j .. 8 j + 7
// give the row addresses of matrix j, register j receives it.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: one m16n8k16 bf16 product with float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// part[split][i][g] = sum over the split's rows n of (y[n][i] >= 0) dxg[n + R][g],
// n over the (T - 1) R rows of the flattened [T, R] sequence, rows [split
// chunk, min(K, (split + 1) chunk)). Both operands are staged as they lie in
// memory, a summed row per shared-memory row: hs[k][i] the spikes in bf16
// (0 or 1, exact), ds[term][k][g] dxg's bf16 terms; ldmatrix .trans gives
// the mma fragments. The next chunk's global loads are in registers while
// the current one is multiplied. Sums in float32 in a fixed order.
template <typename IO, bool VEC>
__global__ void __launch_bounds__(DwTile<IO>::threads, DwTile<IO>::per_sm)  // the plan's blocks a SM
train_dw_kernel(const float* __restrict__ y, const IO* __restrict__ dxg,
                float* __restrict__ part, long long K, int R, int H, int G, long long chunk,
                int tiles_g) {
  constexpr int NT = DwTerms<IO>::n;
  constexpr int BM = DwTile<IO>::m, BN = DwTile<IO>::n, THREADS = DwTile<IO>::threads;
  constexpr int LDM = BM + 8, LDN = BN + 8;  // staged rows of 272 or 144 bytes: the eight rows
                                             // of an ldmatrix fall on distinct banks
  constexpr int WN = THREADS / 32 / 2;       // warps along n; two along m
  constexpr int MT = BM / 2 / 16, NP = BN / WN / 16;  // a warp's m16 tiles, n16 pairs
  static_assert(BM == BN, "one staging layout for both operands");
  __shared__ __align__(16) __nv_bfloat16 hs[2][DW_BK][LDM];
  __shared__ __align__(16) __nv_bfloat16 ds[2][NT][DW_BK][LDN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int i0 = (blockIdx.x / tiles_g) * BM, g0 = (blockIdx.x % tiles_g) * BN;
  const long long k0 = (long long)blockIdx.y * chunk;
  const long long k1 = min(K, k0 + chunk);
  const int nchunks = k1 > k0 ? (int)((k1 - k0 + DW_BK - 1) / DW_BK) : 0;
  const int wm = (warp / WN) * (BM / 2), wn = (warp % WN) * (BN / WN);  // the warp's part
  // staging. Scalar: thread owns column c of the tile and rows r0 + RS q of
  // the chunk. VEC (H % 4 == 0, G % 8 == 0, aligned): 16-byte loads, four
  // columns of y (and of float32 dxg) or eight of bf16 dxg a load.
  constexpr int RS = THREADS / BM, NQ = DW_BK / RS;
  const int c = tid % BM, r0 = tid / BM;
  constexpr int YPR = BM / 4, YQ = DW_BK * YPR / THREADS;        // float4 of y a row, a thread
  constexpr int DV = sizeof(IO) == 2 ? 8 : 4;                     // dxg values a 16-byte load
  constexpr int DPR = BN / DV, DQ = DW_BK * DPR / THREADS;        // loads a row, a thread
  float yv[VEC ? 1 : NQ], dv[VEC ? 1 : NQ];
  float4 yq[VEC ? YQ : 1];
  uint4 dq[VEC ? DQ : 1];
  auto load = [&](long long kc) {
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < YQ; ++q) {
        const long long n = kc + tid / YPR + (THREADS / YPR) * q;
        const int i = i0 + 4 * (tid % YPR);
        yq[q] = (n < k1 && i < H) ? *reinterpret_cast<const float4*>(y + n * H + i)
                                  : make_float4(-1.f, -1.f, -1.f, -1.f);
      }
#pragma unroll
      for (int q = 0; q < DQ; ++q) {
        const long long n = kc + tid / DPR + (THREADS / DPR) * q;
        const int g = g0 + DV * (tid % DPR);
        dq[q] = (n < k1 && g < G) ? *reinterpret_cast<const uint4*>(dxg + (n + R) * G + g)
                                  : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const long long n = kc + r0 + RS * q;
        const bool in = n < k1;
        yv[q] = (in && i0 + c < H) ? y[n * H + i0 + c] : -1.f;
        dv[q] = (in && g0 + c < G) ? ld(dxg + (n + R) * G + g0 + c) : 0.f;
      }
    }
  };
  auto spike = [](float v) { return __float2bfloat16(v >= 0.f ? 1.f : 0.f); };
  auto store = [&](int buf) {
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < YQ; ++q) {
        const int r = tid / YPR + (THREADS / YPR) * q, col = 4 * (tid % YPR);
        __nv_bfloat16 h[4] = {spike(yq[q].x), spike(yq[q].y), spike(yq[q].z), spike(yq[q].w)};
        *reinterpret_cast<uint2*>(&hs[buf][r][col]) = *reinterpret_cast<const uint2*>(h);
      }
#pragma unroll
      for (int q = 0; q < DQ; ++q) {
        const int r = tid / DPR + (THREADS / DPR) * q, col = DV * (tid % DPR);
        if constexpr (NT == 1) {  // bf16 streams: the 16 bytes as they are
          *reinterpret_cast<uint4*>(&ds[buf][0][r][col]) = dq[q];
        } else {  // four float32 values, three bf16 terms each
          const float* v = reinterpret_cast<const float*>(&dq[q]);
          __nv_bfloat16 t[4][NT];
#pragma unroll
          for (int e = 0; e < 4; ++e) dw_split(v[e], t[e]);
#pragma unroll
          for (int m = 0; m < NT; ++m) {
            __nv_bfloat16 u[4] = {t[0][m], t[1][m], t[2][m], t[3][m]};
            *reinterpret_cast<uint2*>(&ds[buf][m][r][col]) = *reinterpret_cast<const uint2*>(u);
          }
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int r = r0 + RS * q;
        hs[buf][r][c] = spike(yv[q]);
        __nv_bfloat16 t[NT];
        dw_split(dv[q], t);
#pragma unroll
        for (int m = 0; m < NT; ++m) ds[buf][m][r][c] = t[m];
      }
    }
  };
  // acc takes the first term; float32's mid and lo terms go to acc2, whose
  // magnitude stays 2^-8 of acc's, so that their sums keep their low bits
  float acc[MT][2 * NP][4], acc2[NT == 1 ? 1 : MT][2 * NP][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < 2 * NP; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[a][b][e] = 0.f;
        if constexpr (NT > 1) acc2[a][b][e] = 0.f;
      }
  if (nchunks > 0) {
    load(k0);
    store(0);
  }
  __syncthreads();
  for (int ck = 0; ck < nchunks; ++ck) {
    const int buf = ck & 1;
    if (ck + 1 < nchunks) load(k0 + (long long)(ck + 1) * DW_BK);
    const int mj = lane >> 3, mr = lane & 7;  // this lane's ldmatrix row address
#pragma unroll
    for (int kk = 0; kk < DW_BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)  // A = h^T: a0 a1 a2 a3 = (k 0-7 | 8-15) x (m 0-7 | 8-15)
        ldsm_x4_t(af[mt], &hs[buf][kk + (mj >> 1) * 8 + mr][wm + mt * 16 + (mj & 1) * 8]);
#pragma unroll
      for (int e = 0; e < NT; ++e)
#pragma unroll
        for (int np = 0; np < NP; ++np) {  // B = dxg: b0 b1 of n-tiles 2 np and 2 np + 1
          uint32_t bf[4];
          ldsm_x4_t(bf, &ds[buf][e][kk + (mj & 1) * 8 + mr][wn + np * 16 + (mj >> 1) * 8]);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if constexpr (NT == 1) {
                mma_bf16(acc[mt][2 * np + h], af[mt], bf[2 * h], bf[2 * h + 1]);
              } else {
                mma_bf16(e == 0 ? acc[mt][2 * np + h] : acc2[mt][2 * np + h], af[mt], bf[2 * h],
                         bf[2 * h + 1]);
              }
            }
        }
    }
    if (ck + 1 < nchunks) store(buf ^ 1);
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * H * G;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wm + mt * 16 + gid + (e >> 1) * 8;
        const int g = g0 + wn + nt * 8 + 2 * tig + (e & 1);
        float v = acc[mt][nt][e];
        if constexpr (NT > 1) v += acc2[mt][nt][e];
        if (i < H && g < G) out[(size_t)i * G + g] = v;
      }
}

// dw[e] = sum over s = 0 .. splits - 1 of part[s][e], in that order.
__global__ void train_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                       long long n, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < splits; ++q) s += part[(size_t)q * n + e];
    dw[e] = s;
  }
}


// The signs of y as bits, then the gates of every step, on one rank's
// tensors (kernel E's first two kernels).
template <typename IO, int NGB>
cudaError_t launch_gates(const void* xg, const float* y, const void* wgfrag, uint8_t* hbits,
                         const float* b2, float* fg, const TrainPlan& p, cudaStream_t stream) {
  if (p.T >= 2) {
    const long long n = (long long)(p.T - 1) * p.nblk * p.Rp * (p.J / 8);
    const int blocks = (int)((n + 255) / 256 < 1056 ? (n + 255) / 256 : 1056);
    train_bits_kernel<<<blocks, 256, 0, stream>>>(y, hbits, p.T - 1, p.R, p.H, p.Rp, p.J,
                                                  p.nblk);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  train_gates_kernel<IO, NGB><<<dim3((unsigned)p.nblk, (unsigned)p.T), NTHREADS, 0, stream>>>(
      static_cast<const IO*>(xg), static_cast<const uint4*>(wgfrag), hbits, b2, fg, p);
  return cudaGetLastError();
}

template <typename IO, int NGB, bool BAND>
cudaError_t prepare_bwd(const TrainPlan& p) {
  auto kern = train_bwd_kernel<IO, NGB, BAND>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e == cudaSuccess) e = allow_cluster(kern, p.nblk);
  return e;
}

// Kernel E's three kernels; in band mode `clusters` ranks' stacked tensors,
// the bits and gates a rank at a time, then one launch of the recurrence.
template <typename IO, int NGB, bool BAND>
int launch_bwd(const void* xg, const float* y, const void* gout, const float* stats,
               const void* wgfrag, const void* wdfrag, uint8_t* hbits, const float* b2,
               const float* bnp, void* dxg, float* db, float* dbn, float* gstate, float* fg,
               unsigned long long* prof, const TrainPlan& p, const BandX& bx, int clusters,
               cudaStream_t stream) {
  const size_t TRH = (size_t)p.T * p.R * p.H;
  const size_t hbits_n = (size_t)(p.T > 1 ? p.T - 1 : 1) * p.nblk * p.Rp * (p.J / 8);
  for (int c = 0; c < clusters; ++c) {
    cudaError_t e = launch_gates<IO, NGB>(static_cast<const IO*>(xg) + c * (size_t)p.T * p.R * p.G,
                                          y + c * TRH, wgfrag, hbits + c * hbits_n, b2,
                                          fg + c * 2 * TRH, p, stream);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t e = prepare_bwd<IO, NGB, BAND>(p);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch L(p, clusters, stream);
  e = cudaLaunchKernelEx(&L.cfg, train_bwd_kernel<IO, NGB, BAND>, y,
                         static_cast<const IO*>(gout), stats, static_cast<const float*>(fg),
                         static_cast<const uint4*>(wdfrag), bnp, static_cast<IO*>(dxg), db, dbn,
                         gstate, prof, p, bx);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename IO, bool BAND>
int launch_bwd_io(const void* xg, const float* y, const void* gout, const float* stats,
                  const void* wg, const void* wd, uint8_t* hbits, const float* b2,
                  const float* bnp, void* dxg, float* db, float* dbn, float* gstate, float* fg,
                  unsigned long long* prof, const TrainPlan& p, const BandX& bx, int clusters,
                  cudaStream_t s) {
  if (p.ngb == 4)
    return launch_bwd<IO, 4, BAND>(xg, y, gout, stats, wg, wd, hbits, b2, bnp, dxg, db, dbn,
                                   gstate, fg, prof, p, bx, clusters, s);
  if (p.ngb == 2)
    return launch_bwd<IO, 2, BAND>(xg, y, gout, stats, wg, wd, hbits, b2, bnp, dxg, db, dbn,
                                   gstate, fg, prof, p, bx, clusters, s);
  return launch_bwd<IO, 1, BAND>(xg, y, gout, stats, wg, wd, hbits, b2, bnp, dxg, db, dbn,
                                 gstate, fg, prof, p, bx, clusters, s);
}

// How many clusters of the recurrence's band instance fit on the card at once.
template <typename IO, int NGB>
cudaError_t max_clusters_bwd(const TrainPlan& p, int* n) {
  cudaError_t e = prepare_bwd<IO, NGB, true>(p);
  if (e != cudaSuccess) return e;
  ClusterLaunch L(p, 1, nullptr);
  return cudaOccupancyMaxActiveClusters(n, train_bwd_kernel<IO, NGB, true>, &L.cfg);
}

bool bwd_plan_ok(const TrainPlan& p, int io) {
  return plan_ok(p) && p.T >= 1 && (p.mode == 0 || p.mode == 1) && io >= 0 && io <= 1 &&
         p.nterm == (io == 1 ? 1 : 3) && p.MTd == p.JT && p.KTg == (p.G + 15) / 16 &&
         p.o_wg == -1;
}

}  // namespace

extern "C" {

// io: 0 float32 streams, 1 bfloat16. xg [T, R, G] and gout [T, R, H] in the
// stream type; wgfrag and wdfrag W_hh's packed gate columns and unit rows
// (train_pack: [nblk][MT][KT][nterm][32] and [nblk][MTd][KTg][nterm][32] x
// 16 bytes, dh's k-tiles permuted); y [T, R, H], stats [T, 2, H], b2 and
// bnp [2, H] (bnp[0] = gamma) f32; out dxg [T, R, G] in the stream type, db
// and dbn [2, H] f32; scratch: hbits [max(T - 1, 1)][nblk][Rp][J / 8]
// bytes, gstate [nblk][2][Rp][ldJ] f32 (the state the plan leaves in device
// memory) and fg [2][T][R][H] f32 (the recomputed gates); prof null or
// [nblk][6] cycle counters. mode: 0 none, 1 batch-statistics BN. Three
// kernels: the signs of y as bits, the gates of every step, the
// recurrence (one cluster, sized by the plan, train_plan). Returns the
// CUDA error code of the launches.
int gsu_train_bwd_launch(int io, const void* xg, const float* y, const void* gout,
                         const float* stats, const void* wgfrag, const void* wdfrag,
                         void* hbits, const float* b2, const float* bnp, void* dxg, float* db,
                         float* dbn, float* gstate, float* fg, unsigned long long* prof,
                         const TrainPlan* plan, void* stream) {
  const TrainPlan& p = *plan;
  if (!bwd_plan_ok(p, io)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* hb = static_cast<uint8_t*>(hbits);
  const BandX none = {};
  if (io == 1)
    return launch_bwd_io<__nv_bfloat16, false>(xg, y, gout, stats, wgfrag, wdfrag, hb, b2, bnp,
                                               dxg, db, dbn, gstate, fg, prof, p, none, 1, s);
  return launch_bwd_io<float, false>(xg, y, gout, stats, wgfrag, wdfrag, hb, b2, bnp, dxg, db,
                                     dbn, gstate, fg, prof, p, none, 1, s);
}

// Kernel E in band mode (mode 1), the recurrence one launch a layer:
// `clusters` clusters, cluster c the band rank bx.rank + c on the c-th of
// each stacked tensor (xg and dxg [clusters][T, R, G], y and gout
// [clusters][T, R, H], stats [clusters][T, 2, H], db and dbn [clusters][2,
// H], hbits, gstate and fg [clusters] of the sizes above); the T exchanges
// (step t's the (T - 1 - t)-th) take sequence numbers bx.seq0 .. bx.seq0 +
// T - 1. The bits and gates run a rank at a time before it. db sums every
// row of the rank, dbn its real rows: the rank's shares. Returns the CUDA
// error code of the launches; a failed exchange shows in bx.err after it.
int gsu_train_bwd_band_launch(int io, const void* xg, const float* y, const void* gout,
                              const float* stats, const void* wgfrag, const void* wdfrag,
                              void* hbits, const float* b2, const float* bnp, void* dxg,
                              float* db, float* dbn, float* gstate, float* fg,
                              const TrainPlan* plan, const BandX* band, int clusters,
                              void* stream) {
  const TrainPlan& p = *plan;
  if (!bwd_plan_ok(p, io) || !band_ok(p, *band, clusters)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* hb = static_cast<uint8_t*>(hbits);
  if (io == 1)
    return launch_bwd_io<__nv_bfloat16, true>(xg, y, gout, stats, wgfrag, wdfrag, hb, b2, bnp,
                                              dxg, db, dbn, gstate, fg, nullptr, p, *band,
                                              clusters, s);
  return launch_bwd_io<float, true>(xg, y, gout, stats, wgfrag, wdfrag, hb, b2, bnp, dxg, db,
                                    dbn, gstate, fg, nullptr, p, *band, clusters, s);
}

// The clusters of the recurrence's band instance that the card holds at once.
int gsu_train_bwd_band_clusters(int io, const TrainPlan* plan, int* n) {
  const TrainPlan& p = *plan;
  if (!bwd_plan_ok(p, io)) return (int)cudaErrorInvalidValue;
  if (io == 1) {
    if (p.ngb == 4) return (int)max_clusters_bwd<__nv_bfloat16, 4>(p, n);
    if (p.ngb == 2) return (int)max_clusters_bwd<__nv_bfloat16, 2>(p, n);
    return (int)max_clusters_bwd<__nv_bfloat16, 1>(p, n);
  }
  if (p.ngb == 4) return (int)max_clusters_bwd<float, 4>(p, n);
  if (p.ngb == 2) return (int)max_clusters_bwd<float, 2>(p, n);
  return (int)max_clusters_bwd<float, 1>(p, n);
}

// io as above. y [T, R, H] f32 and dxg [T, R, G] in the stream type -> dw
// [H, G] f32, over `splits` splits of `chunk` summed rows each (the host's
// plan, ops/gsu_kernels.dw_split_plan). part is [splits, H, G] f32 scratch
// (unused, may be dw itself, when splits is 1). Returns the CUDA error code.
int gsu_train_dw_launch(int io, const float* y, const void* dxg, float* dw, float* part, int T,
                        int R, int H, int G, int splits, long long chunk, void* stream) {
  const long long K = (long long)(T - 1) * R;
  if (H < 1 || G < 1 || R < 1 || T < 1 || io < 0 || io > 1 || splits < 1 || chunk < 1 ||
      (long long)splits * chunk < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits == 1 ? dw : part;
  const bool vec = H % 4 == 0 && G % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dxg) % 16 == 0;  // 16-byte aligned rows
  const auto* d16 = static_cast<const __nv_bfloat16*>(dxg);
  const auto* d32 = static_cast<const float*>(dxg);
  if (io == 1) {
    using T = DwTile<__nv_bfloat16>;
    const int tiles_g = (G + T::n - 1) / T::n;
    const dim3 grid((unsigned)(((H + T::m - 1) / T::m) * tiles_g), (unsigned)splits);
    if (vec)
      train_dw_kernel<__nv_bfloat16, true><<<grid, T::threads, 0, s>>>(y, d16, dst, K, R, H, G, chunk, tiles_g);
    else
      train_dw_kernel<__nv_bfloat16, false><<<grid, T::threads, 0, s>>>(y, d16, dst, K, R, H, G, chunk, tiles_g);
  } else {
    using T = DwTile<float>;
    const int tiles_g = (G + T::n - 1) / T::n;
    const dim3 grid((unsigned)(((H + T::m - 1) / T::m) * tiles_g), (unsigned)splits);
    if (vec)
      train_dw_kernel<float, true><<<grid, T::threads, 0, s>>>(y, d32, dst, K, R, H, G, chunk, tiles_g);
    else
      train_dw_kernel<float, false><<<grid, T::threads, 0, s>>>(y, d32, dst, K, R, H, G, chunk, tiles_g);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long n = (long long)H * G;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  train_dw_reduce_kernel<<<blocks, 256, 0, s>>>(part, dw, n, splits);
  return (int)cudaGetLastError();
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
