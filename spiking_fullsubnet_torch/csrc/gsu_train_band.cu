// Kernels D and E in band mode, the staged route: one GSU layer forward with
// batch-statistics BatchNorm, and its reverse-time backward, on a rank's rows
// of a section whose sub-band units are split over a band group of ranks.
//
// The staged route serves the band groups whose ranks cannot swap BN's sums
// inside a kernel (parallel/mesh.band_route): ranks that share one card in
// separate processes (without MPS their kernels do not run at the same
// time, so a kernel spinning on a peer's flag would wait on the time
// slicer) and groups across hosts. Every other group takes kernels D and E
// themselves in band mode, one launch a layer (gsu_train_fwd.cu,
// gsu_train_bwd.cu, the exchange in gsu_train_mma.cuh).
//
// Replaces, for the band-split sections of the fused forward,
// spiking_fullsubnet_tpu/ops/gsu_pallas.py: _fwd_kernel (:226, run by
// _run_fwd :290, pallas_call :339) and _bwd_kernel (:358, run by _run_bwd
// :469, pallas_call :499). The JAX package splits the units with GSPMD,
// which inserts the all-reduce of BN's statistics inside its scan; here the
// time loop is split at BN's reductions into launches a step, and the host
// sums the partial sums over the band group between them, on the stream
// (ops/gsu_kernels.gsu_layer_train_fwd_band / _bwd_band):
//
//   D, step t: gsu_band_fwd_cell   the products, the cell c' of every row
//                                  (kept in y[t]) and the real rows' sum of c'
//              -- group sum of the [H] sums --
//              gsu_band_fwd_var    the real rows' sum of (c' - mean)^2
//              -- group sum --
//              gsu_band_fwd_norm   y = (c' - mean) rstd gamma + beta, the
//                                  spikes, and stats[t] = (mean, var)
//   E, step t (T-1 down to 0):
//              gsu_band_bwd_dy     the gates again from y[t-1], dy and x-hat
//                                  of every row, and the real rows' sums of
//                                  dy x-hat and dy (added to the rank's dbn)
//              -- group sum of the [2, H] sums --
//              gsu_band_bwd_cell   the BN backward (a pad row's is gamma rstd
//                                  dy), the cell backward, dxg[t], the carried
//                                  dc and dh = drg W_hh^T, and db
//
// The rows are the rank's: its leading Rr rows are real, the rest pad units
// of a ragged section (they count in no sum; BN's count is the group's real
// rows, 1 / inv_n). The weight gradient is the unsharded kernel's dW
// (gsu_train_bwd.cu) on the rank's rows.
//
// Design: a block a row and a thread a unit (H <= 512), so that a row's
// spikes of the previous step are staged once in shared memory and the
// products h W_hh and drg W_hh^T read W in rows of the block's units; the
// sums over the rows are a thread a unit walking the rows in order, so
// that they do not depend on the schedule. Stream types float32 or
// bfloat16 (xg, W_hh, the spikes, gout and dxg); the membranes, the
// statistics and all cell arithmetic are float32, as in kernels D and E.
// Precise expf and 1/sqrtf. This is the simple form: each step's launches
// wait for the group's sums.
#include "gsu_common.cuh"

namespace {

using gsu::ld;
using gsu::st;

constexpr float BN_EPS = 1e-5f;
constexpr int MAX_H = 512;
constexpr int SUM_THREADS = 128;

template <typename IO>
__device__ __forceinline__ float rounded(float x);
template <>
__device__ __forceinline__ float rounded<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The previous step's spikes of row r (h = (y[t-1] >= 0), zero at t = 0)
// into shared memory.
__device__ __forceinline__ void stage_spikes(float* hs, const float* y, int t, int R, int H,
                                             int r) {
  const float* yp = y + ((size_t)(t - 1) * R + r) * H;
  for (int k = threadIdx.x; k < H; k += blockDim.x) hs[k] = t > 0 && yp[k] >= 0.f ? 1.f : 0.f;
  __syncthreads();
}

// f and g of unit u of one row: pre = xg + h W_hh (the product summed over
// k in order, then added), f = sigmoid(pre_f + b_f), g = pre_c + b_c.
template <typename IO>
__device__ __forceinline__ void gates(const IO* xrow, const IO* whh, const float* b2,
                                      const float* hs, bool product, int H, int G, int shared,
                                      int u, float& f, float& g) {
  float af = 0.f, ac = 0.f;
  if (product)
    for (int k = 0; k < H; ++k) {
      const float h = hs[k];
      af = fmaf(h, ld(whh + (size_t)k * G + u), af);
      if (!shared) ac = fmaf(h, ld(whh + (size_t)k * G + H + u), ac);
    }
  const float pf = ld(xrow + u) + af;
  const float pc = shared ? pf : ld(xrow + H + u) + ac;
  f = 1.f / (1.f + expf(-(pf + b2[u])));
  g = pc + b2[H + u];
}

template <typename IO>
__global__ void fwd_cell(const IO* __restrict__ xg, const IO* __restrict__ whh,
                         const float* __restrict__ b2, float* __restrict__ y, int t, int R,
                         int H, int shared) {
  __shared__ float hs[MAX_H];
  const int r = blockIdx.x, u = threadIdx.x, G = shared ? H : 2 * H;
  stage_spikes(hs, y, t, R, H, r);
  if (u >= H) return;
  float f, g;
  gates(xg + ((size_t)t * R + r) * G, whh, b2, hs, t > 0, H, G, shared, u, f, g);
  const float c = t > 0 ? y[((size_t)(t - 1) * R + r) * H + u] : 0.f;
  y[((size_t)t * R + r) * H + u] = f * c + (1.f - f) * g;
}

// sums[pass][u]: the real rows' sum of c' (pass 0), or of (c' - mean)^2
// with mean = sums[0][u] inv_n (pass 1)
__global__ void fwd_sum(const float* __restrict__ y, float* __restrict__ sums, int t, int R,
                        int Rr, int H, int pass, float inv_n) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= H) return;
  const float* yt = y + (size_t)t * R * H + u;
  float s = 0.f;
  if (pass == 0) {
    for (int r = 0; r < Rr; ++r) s += yt[(size_t)r * H];
  } else {
    const float mean = sums[u] * inv_n;
    for (int r = 0; r < Rr; ++r) {
      const float d = yt[(size_t)r * H] - mean;
      s += d * d;
    }
  }
  sums[pass * H + u] = s;
}

template <typename IO>
__global__ void fwd_norm(const float* __restrict__ bnp, const float* __restrict__ sums,
                         IO* __restrict__ spikes, float* __restrict__ y,
                         float* __restrict__ stats, int t, int R, int H, float inv_n) {
  const int r = blockIdx.x, u = threadIdx.x;
  if (u >= H) return;
  const float mean = sums[u] * inv_n, var = sums[H + u] * inv_n;
  const float rstd = 1.f / sqrtf(var + BN_EPS);
  const size_t o = ((size_t)t * R + r) * H + u;
  const float v = (y[o] - mean) * rstd * bnp[u] + bnp[H + u];
  y[o] = v;
  st(spikes + o, v >= 0.f ? 1.f : 0.f);  // -0.0 fires
  if (r == 0) {
    stats[(size_t)t * 2 * H + u] = mean;
    stats[((size_t)t * 2 + 1) * H + u] = var;
  }
}

// E's per-row work buffers, [8][R][H] float32
enum Work { W_DH = 0, W_DC, W_DY, W_XHAT, W_F, W_G, W_DPF, W_DPC };

template <typename IO>
__global__ void bwd_dy(const IO* __restrict__ xg, const float* __restrict__ y,
                       const IO* __restrict__ gout, const float* __restrict__ stats,
                       const IO* __restrict__ whh, const float* __restrict__ b2,
                       float* __restrict__ work, int t, int R, int H, int shared) {
  __shared__ float hs[MAX_H];
  const int r = blockIdx.x, u = threadIdx.x, G = shared ? H : 2 * H;
  stage_spikes(hs, y, t, R, H, r);
  if (u >= H) return;
  const size_t RH = (size_t)R * H, e = (size_t)r * H + u;
  float f, g;
  gates(xg + ((size_t)t * R + r) * G, whh, b2, hs, t > 0, H, G, shared, u, f, g);
  const float c = t > 0 ? y[(size_t)(t - 1) * RH + e] : 0.f;
  const float surr = fmaxf(1.f - fabsf(y[(size_t)t * RH + e]), 0.f);
  const float dy = (ld(gout + (size_t)t * RH + e) + work[W_DH * RH + e]) * surr +
                   work[W_DC * RH + e];
  const float rstd = 1.f / sqrtf(stats[((size_t)t * 2 + 1) * H + u] + BN_EPS);
  work[W_DY * RH + e] = dy;
  work[W_XHAT * RH + e] = (f * c + (1.f - f) * g - stats[(size_t)t * 2 * H + u]) * rstd;
  work[W_F * RH + e] = f;
  work[W_G * RH + e] = g;
}

// the real rows' sums of dy x-hat (sums[0]) and dy (sums[1]), also added to
// the rank's BN gradient
__global__ void bwd_sum(const float* __restrict__ work, float* __restrict__ sums,
                        float* __restrict__ dbn, int R, int Rr, int H) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= H) return;
  const size_t RH = (size_t)R * H;
  float sx = 0.f, sd = 0.f;
  for (int r = 0; r < Rr; ++r) {
    const float dy = work[W_DY * RH + (size_t)r * H + u];
    sx += dy * work[W_XHAT * RH + (size_t)r * H + u];
    sd += dy;
  }
  sums[u] = sx;
  sums[H + u] = sd;
  dbn[u] += sx;
  dbn[H + u] += sd;
}

template <typename IO>
__global__ void bwd_cell(const float* __restrict__ y, const float* __restrict__ stats,
                         const float* __restrict__ bnp, const IO* __restrict__ wt,
                         const float* __restrict__ sums, float* __restrict__ work,
                         IO* __restrict__ dxg, int t, int R, int Rr, int H, int shared,
                         float inv_n) {
  __shared__ float drg[2 * MAX_H];
  const int r = blockIdx.x, u = threadIdx.x, G = shared ? H : 2 * H;
  const size_t RH = (size_t)R * H, e = (size_t)r * H + u;
  if (u < H) {
    const float dy = work[W_DY * RH + e], xhat = work[W_XHAT * RH + e];
    const float f = work[W_F * RH + e], g = work[W_G * RH + e];
    const float rstd = 1.f / sqrtf(stats[((size_t)t * 2 + 1) * H + u] + BN_EPS);
    const float dcr = r < Rr ? bnp[u] * rstd * (dy - inv_n * sums[H + u] - xhat * (inv_n * sums[u]))
                             : bnp[u] * rstd * dy;
    const float c = t > 0 ? y[(size_t)(t - 1) * RH + e] : 0.f;
    const float dpf = dcr * (c - g) * f * (1.f - f);
    const float dpc = dcr * (1.f - f);
    work[W_DC * RH + e] = dcr * f;
    work[W_DPF * RH + e] = dpf;
    work[W_DPC * RH + e] = dpc;
    IO* dx = dxg + ((size_t)t * R + r) * G;
    if (shared) {
      st(dx + u, dpf + dpc);
      drg[u] = rounded<IO>(dpf + dpc);
    } else {
      st(dx + u, dpf);
      st(dx + H + u, dpc);
      drg[u] = rounded<IO>(dpf);
      drg[H + u] = rounded<IO>(dpc);
    }
  }
  __syncthreads();
  if (u >= H) return;
  float dh = 0.f;  // dh[r][u] = sum over the gate columns j of drg[j] W_hh[u][j]
  for (int j = 0; j < G; ++j) dh = fmaf(drg[j], ld(wt + (size_t)j * H + u), dh);
  work[W_DH * RH + e] = dh;
}

// db += the step's sums over every row of dpre_f and dpre_c
__global__ void bwd_db(const float* __restrict__ work, float* __restrict__ db, int R, int H) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= H) return;
  const size_t RH = (size_t)R * H;
  float sf = 0.f, sc = 0.f;
  for (int r = 0; r < R; ++r) {
    sf += work[W_DPF * RH + (size_t)r * H + u];
    sc += work[W_DPC * RH + (size_t)r * H + u];
  }
  db[u] += sf;
  db[H + u] += sc;
}

bool sizes_ok(int io, int t, int T, int R, int Rr, int H) {
  return io >= 0 && io <= 1 && T >= 1 && t >= 0 && t < T && R >= 1 && Rr >= 0 && Rr <= R &&
         H >= 1 && H <= MAX_H;
}

int row_threads(int H) { return (H + 31) / 32 * 32; }
int sum_blocks(int H) { return (H + SUM_THREADS - 1) / SUM_THREADS; }
int last_error() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

// Kernel D in band mode, step t (see the top of this file). io: 0 float32
// streams, 1 bfloat16. xg [T, R, G] and whh [H, G] in the stream type, b2
// and bnp [2, H] f32 (bnp = BN weight, bias); spikes [T, R, H] in the stream
// type, y [T, R, H] and stats [T, 2, H] f32; sums [2, H] f32, the step's
// partial sums, which the host sums over the group between the launches.
// Returns the CUDA error code (0 on success; cudaErrorInvalidValue for sizes
// out of range).
int gsu_band_fwd_cell(int io, const void* xg, const void* whh, const float* b2,
                      const float* bnp, void* spikes, float* y, float* stats, float* sums, int t,
                      int T, int R, int Rr, int H, int shared, void* stream) {
  if (!sizes_ok(io, t, T, R, Rr, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io == 1)
    fwd_cell<__nv_bfloat16><<<R, row_threads(H), 0, s>>>(
        static_cast<const __nv_bfloat16*>(xg), static_cast<const __nv_bfloat16*>(whh), b2, y, t,
        R, H, shared);
  else
    fwd_cell<float><<<R, row_threads(H), 0, s>>>(static_cast<const float*>(xg),
                                                  static_cast<const float*>(whh), b2, y, t, R, H,
                                                  shared);
  fwd_sum<<<sum_blocks(H), SUM_THREADS, 0, s>>>(y, sums, t, R, Rr, H, 0, 0.f);
  return last_error();
}

int gsu_band_fwd_var(int io, const void* xg, const void* whh, const float* b2, const float* bnp,
                     void* spikes, float* y, float* stats, float* sums, int t, int T, int R,
                     int Rr, int H, int shared, float inv_n, void* stream) {
  if (!sizes_ok(io, t, T, R, Rr, H)) return (int)cudaErrorInvalidValue;
  fwd_sum<<<sum_blocks(H), SUM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      y, sums, t, R, Rr, H, 1, inv_n);
  return last_error();
}

int gsu_band_fwd_norm(int io, const void* xg, const void* whh, const float* b2, const float* bnp,
                      void* spikes, float* y, float* stats, float* sums, int t, int T, int R,
                      int Rr, int H, int shared, float inv_n, void* stream) {
  if (!sizes_ok(io, t, T, R, Rr, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io == 1)
    fwd_norm<__nv_bfloat16><<<R, row_threads(H), 0, s>>>(
        bnp, sums, static_cast<__nv_bfloat16*>(spikes), y, stats, t, R, H, inv_n);
  else
    fwd_norm<float><<<R, row_threads(H), 0, s>>>(bnp, sums, static_cast<float*>(spikes), y,
                                                  stats, t, R, H, inv_n);
  return last_error();
}

// Kernel E in band mode, step t, from T-1 down to 0. xg, gout [T, R, H],
// whh [H, G] and wt = whh^T [G, H] in the stream type; y, stats, b2, bnp as
// D wrote and took them; dxg [T, R, G] in the stream type; db and dbn [2,
// H] f32, zeroed by the host and summed into; sums [2, H] the step's
// partial sums; work [8, R, H] f32, zeroed by the host (dh and dc carried,
// then the step's dy, x-hat, f, g, dpre_f, dpre_c).
int gsu_band_bwd_dy(int io, const void* xg, const float* y, const void* gout, const float* stats,
                    const void* whh, const void* wt, const float* b2, const float* bnp,
                    void* dxg, float* db, float* dbn, float* sums, float* work, int t, int T,
                    int R, int Rr, int H, int shared, float inv_n, void* stream) {
  if (!sizes_ok(io, t, T, R, Rr, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io == 1)
    bwd_dy<__nv_bfloat16><<<R, row_threads(H), 0, s>>>(
        static_cast<const __nv_bfloat16*>(xg), y, static_cast<const __nv_bfloat16*>(gout), stats,
        static_cast<const __nv_bfloat16*>(whh), b2, work, t, R, H, shared);
  else
    bwd_dy<float><<<R, row_threads(H), 0, s>>>(static_cast<const float*>(xg), y,
                                                static_cast<const float*>(gout), stats,
                                                static_cast<const float*>(whh), b2, work, t, R,
                                                H, shared);
  bwd_sum<<<sum_blocks(H), SUM_THREADS, 0, s>>>(work, sums, dbn, R, Rr, H);
  return last_error();
}

int gsu_band_bwd_cell(int io, const void* xg, const float* y, const void* gout,
                      const float* stats, const void* whh, const void* wt, const float* b2,
                      const float* bnp, void* dxg, float* db, float* dbn, float* sums,
                      float* work, int t, int T, int R, int Rr, int H, int shared, float inv_n,
                      void* stream) {
  if (!sizes_ok(io, t, T, R, Rr, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io == 1)
    bwd_cell<__nv_bfloat16><<<R, row_threads(H), 0, s>>>(
        y, stats, bnp, static_cast<const __nv_bfloat16*>(wt), sums, work,
        static_cast<__nv_bfloat16*>(dxg), t, R, Rr, H, shared, inv_n);
  else
    bwd_cell<float><<<R, row_threads(H), 0, s>>>(y, stats, bnp, static_cast<const float*>(wt),
                                                  sums, work, static_cast<float*>(dxg), t, R, Rr,
                                                  H, shared, inv_n);
  bwd_db<<<sum_blocks(H), SUM_THREADS, 0, s>>>(work, db, R, H);
  return last_error();
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
