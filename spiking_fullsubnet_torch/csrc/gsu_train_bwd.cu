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
// What bounds it on an H100: as kernel D, the serial chain of each step (a
// dot over H for the recomputed gates and one over G for dh, both through
// L2, and one cluster barrier for the BN sums), not bytes (xg, y, gout read,
// dxg written) or operations.
//
// Design: kernel D's cluster (up to 8 blocks over the rows, one thread per
// hidden unit, row tiles of 8 through gsu_common's dot_rows). One shared
// buffer per block holds the tiles' h_prev for the recompute, then their
// drg for dh = drg @ W_hh^T (W_hh^T given, so the weight loads coalesce).
// The carried dh and dc and the step's f and g live in a global scratch
// [4, R, H] (each thread reads and writes only its own unit's entries, so
// they stay in L2). The BN sums are per-block partials added across the
// cluster in rank order through distributed shared memory, double-buffered
// by the parity of t so that one cluster barrier a step suffices. db and
// dgamma/dbeta stay in registers and are written once at the end.
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
#include <cooperative_groups.h>

#include "gsu_common.cuh"

namespace cg = cooperative_groups;
using namespace gsu;

namespace {

constexpr int MAX_CLUSTER = 8;
constexpr float BN_EPS = 1e-5f;

// v rounded to the stream type and back (the identity for float32)
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename IO>
__global__ void __launch_bounds__(512)
train_bwd_kernel(const IO* __restrict__ xg, const float* __restrict__ y,
                 const IO* __restrict__ gout, const float* __restrict__ stats,
                 const IO* __restrict__ whh, const IO* __restrict__ whh_t,
                 const float* __restrict__ b2, const float* __restrict__ bnp,
                 IO* __restrict__ dxg, float* __restrict__ db, float* __restrict__ dbn,
                 float* __restrict__ scratch, int T, int R, int H, int shared, int bn,
                 int rows_blk) {
  extern __shared__ float4 smem4[];
  const int G = shared ? H : 2 * H;
  float* buf = reinterpret_cast<float*>(smem4);  // [tile][H][RB] h_prev, then [tile][G][RB] drg
  float* part = buf + (size_t)rows_blk * G;      // [2 parities][2][H] BN sums, [2][H] db
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = rank * rows_blk;
  const int nrows = max(0, min(rows_blk, R - row0));
  const int ntile = (nrows + RB - 1) / RB;
  const int j = threadIdx.x;
  const bool active = j < H;
  const int j2 = shared ? -1 : H + j;
  const float inv_n = 1.f / (float)R;
  const size_t RH = (size_t)R * H;
  float* dh = scratch;  // dL/dh_t from step t+1; holds dy within a step
  float* dc = scratch + RH;
  float* fs = scratch + 2 * RH;
  float* gs = scratch + 3 * RH;

  const float b_f = active ? b2[j] : 0.f, b_c = active ? b2[H + j] : 0.f;
  const float gamma = active ? bnp[j] : 0.f;
  float db_f = 0.f, db_c = 0.f, dgamma = 0.f, dbeta = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    // h_prev of the block's rows, input-major per tile
    for (int k = 0; k < rows_blk / RB && active; ++k) {
      float hv[RB];
      for (int r = 0; r < RB; ++r) {
        const int lr = k * RB + r;
        hv[r] = (t > 0 && lr < nrows &&
                 y[((size_t)(t - 1) * R + row0 + lr) * H + j] >= 0.f) ? 1.f : 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(buf + ((size_t)k * H + j) * RB);
      dst[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
      dst[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
    }
    __syncthreads();
    float mean = 0.f, rstd = 0.f;
    if (bn && active) {
      mean = stats[(size_t)t * 2 * H + j];
      rstd = 1.f / sqrtf(stats[((size_t)t * 2 + 1) * H + j] + BN_EPS);
    }
    // recompute the gates; dy; the block's BN partial sums
    float s_dy = 0.f, s_dyx = 0.f;
    if (active) {
      for (int k = 0; k < ntile; ++k) {
        float a[RB], a2[RB];
        dot_rows(buf + (size_t)k * H * RB, H, whh, G, j, j2, a, a2);
        const int nr = min(RB, nrows - k * RB);
        for (int r = 0; r < nr; ++r) {
          const int row = row0 + k * RB + r;
          const size_t i = (size_t)row * H + j;
          const IO* x = xg + ((size_t)t * R + row) * G;
          const float pre_f = ld(x + j) + a[r];
          const float pre_c = shared ? pre_f : ld(x + H + j) + a2[r];
          const float f = 1.f / (1.f + expf(-(pre_f + b_f)));
          const float g = pre_c + b_c;
          const size_t o = ((size_t)t * R + row) * H + j;
          const float surr = fmaxf(1.f - fabsf(y[o]), 0.f);
          const float dy = (ld(gout + o) + dh[i]) * surr + dc[i];
          fs[i] = f;
          gs[i] = g;
          dh[i] = dy;
          if (bn) {
            const float c_prev = t > 0 ? y[o - RH] : 0.f;
            const float xhat = (f * c_prev + (1.f - f) * g - mean) * rstd;
            s_dy += dy;
            s_dyx += dy * xhat;
          }
        }
      }
    }
    float sum_dy = 0.f, sum_dyx = 0.f;
    if (bn) {
      float* pp = part + (t & 1) * 2 * H;
      if (active) {
        pp[j] = s_dy;
        pp[H + j] = s_dyx;
      }
      cluster.sync();  // also: every thread has read h_prev before buf takes drg
      if (active)
        for (int b = 0; b < nblk; ++b) {
          const float* q = cluster.map_shared_rank(pp, b);
          sum_dy += q[j];
          sum_dyx += q[H + j];
        }
      dgamma += sum_dyx;
      dbeta += sum_dy;
    } else {
      __syncthreads();  // every thread has read h_prev before buf takes drg
    }
    // the membrane gradient through BN and the cell; drg into dxg and buf
    if (active) {
      for (int k = 0; k < ntile; ++k) {
        const int nr = min(RB, nrows - k * RB);
        for (int r = 0; r < nr; ++r) {
          const int row = row0 + k * RB + r;
          const size_t i = (size_t)row * H + j;
          const size_t o = ((size_t)t * R + row) * H + j;
          const float f = fs[i], g = gs[i], dy = dh[i];
          const float c_prev = t > 0 ? y[o - RH] : 0.f;
          float dcr = dy;
          if (bn) {
            const float xhat = (f * c_prev + (1.f - f) * g - mean) * rstd;
            dcr = gamma * rstd * (dy - inv_n * sum_dy - xhat * (inv_n * sum_dyx));
          }
          const float dpre_f = dcr * (c_prev - g) * f * (1.f - f);
          const float dpre_c = dcr * (1.f - f);
          dc[i] = dcr * f;
          db_f += dpre_f;
          db_c += dpre_c;
          IO* dx = dxg + ((size_t)t * R + row) * G;
          if (shared) {
            const float d = rnd(dpre_f + dpre_c, dx);
            st(dx + j, d);
            buf[((size_t)k * G + j) * RB + r] = d;
          } else {
            const float d_f = rnd(dpre_f, dx), d_c = rnd(dpre_c, dx);
            st(dx + j, d_f);
            st(dx + H + j, d_c);
            buf[((size_t)k * G + j) * RB + r] = d_f;
            buf[((size_t)k * G + H + j) * RB + r] = d_c;
          }
        }
      }
    }
    __syncthreads();  // drg is staged
    // dh_{t-1} = drg @ W_hh^T over the G gate columns
    if (active) {
      for (int k = 0; k < ntile; ++k) {
        float a[RB], unused[RB];
        dot_rows(buf + (size_t)k * G * RB, G, whh_t, H, j, -1, a, unused);
        const int nr = min(RB, nrows - k * RB);
        for (int r = 0; r < nr; ++r) dh[(size_t)(row0 + k * RB + r) * H + j] = a[r];
      }
    }
    __syncthreads();  // every thread has read drg before the next step stages h_prev
  }
  // db over every row: the cluster's partials, added by block 0 in rank order
  float* pe = part + 4 * H;
  if (active) {
    pe[j] = db_f;
    pe[H + j] = db_c;
  }
  cluster.sync();
  if (rank == 0 && active) {
    float sf = 0.f, sc = 0.f;
    for (int b = 0; b < nblk; ++b) {
      const float* q = cluster.map_shared_rank(pe, b);
      sf += q[j];
      sc += q[H + j];
    }
    db[j] = sf;
    db[H + j] = sc;
    dbn[j] = dgamma;  // every block holds the same cluster-wide sums
    dbn[H + j] = dbeta;
  }
  cluster.sync();  // no block leaves while block 0 reads its partials
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

template <typename IO>
int launch_bwd(const void* xg, const float* y, const void* gout, const float* stats,
               const void* whh, const void* whh_t, const float* b2, const float* bnp, void* dxg,
               float* db, float* dbn, float* scratch, int T, int R, int H, int shared, int mode,
               cudaStream_t stream) {
  const int G = shared ? H : 2 * H;
  int nblk = (R + RB - 1) / RB;
  nblk = nblk < MAX_CLUSTER ? nblk : MAX_CLUSTER;
  const int rows_blk = ((R + nblk - 1) / nblk + RB - 1) / RB * RB;
  const size_t smem = ((size_t)rows_blk * G + 6 * H) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  auto kern = train_bwd_kernel<IO>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nblk);
  cfg.blockDim = dim3((unsigned)((H + 31) / 32 * 32));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const IO*>(xg), y,
                         static_cast<const IO*>(gout), stats, static_cast<const IO*>(whh),
                         static_cast<const IO*>(whh_t), b2, bnp, static_cast<IO*>(dxg), db, dbn,
                         scratch, T, R, H, shared, mode, rows_blk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// io: 0 float32 streams, 1 bfloat16. xg [T, R, G], gout [T, R, H], whh
// [H, G] and whh_t [G, H] in the stream type; y [T, R, H], stats [T, 2, H],
// b2 and bnp [2, H] (bnp[0] = gamma) f32; out dxg [T, R, G] in the stream
// type, db and dbn [2, H] f32; scratch [4, R, H] f32, its first 2 R H zeroed
// by the caller. mode: 0 none, 1 batch-statistics BN. One cluster of
// min(8, ceil(R / 8)) blocks runs every row. Returns the CUDA error code of
// the launch.
int gsu_train_bwd_launch(int io, const void* xg, const float* y, const void* gout,
                         const float* stats, const void* whh, const void* whh_t,
                         const float* b2, const float* bnp, void* dxg, float* db, float* dbn,
                         float* scratch, int T, int R, int H, int shared, int mode,
                         void* stream) {
  if (H < 1 || H > 512 || R < 1 || T < 1 || (mode != 0 && mode != 1) || io < 0 || io > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io == 1)
    return launch_bwd<__nv_bfloat16>(xg, y, gout, stats, whh, whh_t, b2, bnp, dxg, db, dbn,
                                     scratch, T, R, H, shared, mode, s);
  return launch_bwd<float>(xg, y, gout, stats, whh, whh_t, b2, bnp, dxg, db, dbn, scratch, T,
                           R, H, shared, mode, s);
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
