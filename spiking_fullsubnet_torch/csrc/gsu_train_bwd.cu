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
// T R rows (h_prev of rows n < R is zero). A block owns a 32 x 64 tile of
// dW and walks every row in chunks of 32 staged in shared memory, skipping
// zero spikes; sums in float32 in row order (dxg in the stream type, so with
// bf16 streams the rounded drg). No library GEMM: the TPU kernel computes
// this product in its body.
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

constexpr int DW_TI = 32;   // dW rows (hidden inputs) a block owns
constexpr int DW_TG = 64;   // dW columns (gates) a block owns
constexpr int DW_TK = 32;   // rows of the sum staged at once
constexpr int DW_THREADS = 256;

// dw[i][g] = sum over n >= R of (y[n - R][i] >= 0) dxg[n][g], n over T R rows
// of the flattened [T, R] sequence. Thread (ti, tg) owns dw[i0 + ti][g0 + tg
// .. + 8].
template <typename IO>
__global__ void __launch_bounds__(DW_THREADS)
train_dw_kernel(const float* __restrict__ y, const IO* __restrict__ dxg,
                float* __restrict__ dw, int T, int R, int H, int G) {
  __shared__ float hsm[DW_TK][DW_TI];
  __shared__ float dsm[DW_TK][DW_TG];
  const int i0 = blockIdx.y * DW_TI, g0 = blockIdx.x * DW_TG;
  const int ti = threadIdx.x / (DW_TG / 8), tg = (threadIdx.x % (DW_TG / 8)) * 8;
  const long long N = (long long)T * R;
  float acc[8];
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;
  for (long long n0 = R; n0 < N; n0 += DW_TK) {
    for (int q = threadIdx.x; q < DW_TK * DW_TI; q += DW_THREADS) {
      const int kk = q / DW_TI, ii = q % DW_TI;
      const long long n = n0 + kk;
      hsm[kk][ii] = (n < N && i0 + ii < H && y[(n - R) * H + i0 + ii] >= 0.f) ? 1.f : 0.f;
    }
    for (int q = threadIdx.x; q < DW_TK * DW_TG; q += DW_THREADS) {
      const int kk = q / DW_TG, gg = q % DW_TG;
      const long long n = n0 + kk;
      dsm[kk][gg] = (n < N && g0 + gg < G) ? ld(dxg + n * G + g0 + gg) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < DW_TK; ++kk) {
      if (hsm[kk][ti] != 0.f) {  // spikes are 0 or 1: skip the silent ones
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] += dsm[kk][tg + q];
      }
    }
    __syncthreads();
  }
  if (i0 + ti < H)
    for (int q = 0; q < 8; ++q)
      if (g0 + tg + q < G) dw[(size_t)(i0 + ti) * G + g0 + tg + q] = acc[q];
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
// [H, G] f32. Returns the CUDA error code of the launch.
int gsu_train_dw_launch(int io, const float* y, const void* dxg, float* dw, int T, int R, int H,
                        int G, void* stream) {
  if (H < 1 || G < 1 || R < 1 || T < 1 || io < 0 || io > 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((G + DW_TG - 1) / DW_TG), (unsigned)((H + DW_TI - 1) / DW_TI));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io == 1)
    train_dw_kernel<<<grid, DW_THREADS, 0, s>>>(
        y, static_cast<const __nv_bfloat16*>(dxg), dw, T, R, H, G);
  else
    train_dw_kernel<<<grid, DW_THREADS, 0, s>>>(y, static_cast<const float*>(dxg), dw, T, R, H,
                                                G);
  return (int)cudaGetLastError();
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
