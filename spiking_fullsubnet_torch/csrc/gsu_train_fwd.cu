// Kernel D: one GSU layer forward over the whole sequence, with
// batch-statistics BatchNorm (training), a folded affine (eval) or none,
// saving the membranes and the per-step statistics for the backward.
//
// Replaces spiking_fullsubnet_tpu/ops/gsu_pallas.py: _fwd_kernel (:226),
// run by _run_fwd (:290, pallas_call :339) for gsu_layer_pallas_train (:580)
// and gsu_layer_pallas (:531).
//
// Per step t and row r: pre = xg[t, r] + h_{t-1} @ W_hh; f = sigmoid(pre_f
// + b_f); c' = f c_{t-1} + (1 - f)(pre_c + b_c). Mode "bn": the mean and
// the biased variance of c' over all R rows (two passes: the mean, then the
// mean of (c' - mean)^2, each a sum times 1/R), y = (c' - mean) /
// sqrt(var + eps) gamma + beta; "affine": y = c' scale + shift; "none":
// y = c'. h_t = (y >= 0), c_t = y. Writes spikes [T, R, H], y [T, R, H] and,
// in mode "bn", stats [T, 2, H] = (mean, var). Two stream types, as the TPU
// kernel's _KCfg.io (gsu_pallas.py:129-133): float32, or bfloat16 xg, W_hh
// and spikes (the spike products sum bf16 weights in float32). The
// membranes y, the statistics and all cell arithmetic are float32 in both:
// the backward recomputes each step from y[t-1] over the whole sequence, so
// a bf16 y would compound its rounding over every step. Precise expf and
// 1/sqrtf, no fast math.
//
// What bounds it on an H100: the statistics cross every row at every step,
// so the rows of a stack cannot run as independent blocks (kernel A's and
// F's design). At the training shapes (batch 64 x 6 s, T = 751; up to 1536
// rows x 256 units) the bytes are small (xg read, spikes, y and stats
// written: under 2 GB) and the operations few (the spike products count
// only the spikes that fired); the limit is the serial chain of each step:
// H dependent weight loads through L2 per row tile, then two cluster-wide
// barriers for the statistics.
//
// Design: one thread-block cluster of up to 8 blocks runs the whole stack;
// block b owns a contiguous slice of the rows (a whole number of 8-row
// tiles), one thread per hidden unit j. The block's spikes of step t-1
// live in shared memory input-major per tile ([tile][H][8], gsu_common's
// dot_rows layout); that is all the shared memory holds beside two partial
// sums, so a block takes up to 224 rows at H 256 (1792 rows a stack). The
// membranes stay in global memory: a thread reads its own c_{t-1} back from
// y[t-1], which it wrote itself (no barrier needed), and keeps c' in y[t]
// between the statistics passes before it overwrites it with the
// normalised value. Each step a thread takes, tile by tile, its unit's
// recurrent products through dot_rows (each weight load from L2 feeds 8
// rows), the gates and c'. In mode "bn" each block then writes its per-unit
// partial sum of c' to shared memory; after cluster.sync() every block adds
// the cluster's partials through distributed shared memory in rank order
// (the same sums in every block), takes the mean, and does the same for the
// squared deviations. No atomics: the result does not depend on the
// schedule.
#include <cooperative_groups.h>

#include "gsu_common.cuh"

namespace cg = cooperative_groups;
using namespace gsu;

namespace {

constexpr int MAX_CLUSTER = 8;
constexpr float BN_EPS = 1e-5f;
enum Mode { MODE_NONE = 0, MODE_BN = 1, MODE_AFFINE = 2 };

template <typename IO>
__global__ void __launch_bounds__(512)
train_fwd_kernel(const IO* __restrict__ xg, const IO* __restrict__ whh,
                 const float* __restrict__ b2, const float* __restrict__ bnp,
                 IO* __restrict__ spikes, float* __restrict__ y, float* __restrict__ stats,
                 int T, int R, int H, int shared, int mode, int rows_blk) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [tile][H][RB] spikes of step t-1
  float* part = hs + (size_t)rows_blk * H;      // [2][H] the block's partial sums
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = rank * rows_blk;
  const int nrows = max(0, min(rows_blk, R - row0));
  const int ntile = (nrows + RB - 1) / RB;
  const int j = threadIdx.x;
  const bool active = j < H;
  const int G = shared ? H : 2 * H;
  const int j2 = shared ? -1 : H + j;
  const float inv_n = 1.f / (float)R;
  const size_t RH = (size_t)R * H;

  for (int i = threadIdx.x; i < rows_blk * H + 2 * H; i += blockDim.x) hs[i] = 0.f;
  const float b_f = active ? b2[j] : 0.f, b_c = active ? b2[H + j] : 0.f;
  const float p0 = active ? bnp[j] : 0.f, p1 = active ? bnp[H + j] : 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // c' of the block's rows into y[t]; s1 sums them for the batch mean
    float s1 = 0.f;
    if (active) {
      for (int k = 0; k < ntile; ++k) {
        float a[RB], a2[RB];
        dot_rows(hs + (size_t)k * H * RB, H, whh, G, j, j2, a, a2);
        const int nr = min(RB, nrows - k * RB);
        for (int r = 0; r < nr; ++r) {
          const int row = row0 + k * RB + r;
          const IO* x = xg + ((size_t)t * R + row) * G;
          const size_t o = ((size_t)t * R + row) * H + j;
          const float c_prev = t > 0 ? y[o - RH] : 0.f;  // this thread's own write
          const float pre_f = ld(x + j) + a[r];
          const float pre_c = shared ? pre_f : ld(x + H + j) + a2[r];
          const float f = 1.f / (1.f + expf(-(pre_f + b_f)));
          const float cy = f * c_prev + (1.f - f) * (pre_c + b_c);
          y[o] = cy;
          s1 += cy;
        }
      }
    }
    float mean = 0.f, rstd = 0.f;
    if (mode == MODE_BN) {
      if (active) part[j] = s1;
      cluster.sync();  // also: every thread has read hs before it is rewritten
      float s = 0.f;
      if (active)
        for (int b = 0; b < nblk; ++b) s += cluster.map_shared_rank(part, b)[j];
      mean = s * inv_n;
      float s2 = 0.f;
      if (active)
        for (int k = 0; k < ntile; ++k) {
          const int nr = min(RB, nrows - k * RB);
          for (int r = 0; r < nr; ++r) {
            const float d = y[((size_t)t * R + row0 + k * RB + r) * H + j] - mean;
            s2 += d * d;
          }
        }
      if (active) part[H + j] = s2;
      cluster.sync();
      float v = 0.f;
      if (active)
        for (int b = 0; b < nblk; ++b) v += cluster.map_shared_rank(part, b)[H + j];
      const float var = v * inv_n;
      rstd = 1.f / sqrtf(var + BN_EPS);
      if (rank == 0 && active) {
        stats[(size_t)t * 2 * H + j] = mean;
        stats[((size_t)t * 2 + 1) * H + j] = var;
      }
    } else {
      __syncthreads();  // every thread has read hs before it is rewritten
    }
    if (active) {
      for (int k = 0; k < ntile; ++k) {
        float hv[RB];
        for (int r = 0; r < RB; ++r) {
          hv[r] = 0.f;  // rows past the block's slice stay silent
          if (k * RB + r < nrows) {
            const size_t o = ((size_t)t * R + row0 + k * RB + r) * H + j;
            float yv = y[o];
            if (mode == MODE_BN)
              yv = (yv - mean) * rstd * p0 + p1;
            else if (mode == MODE_AFFINE)
              yv = yv * p0 + p1;
            hv[r] = yv >= 0.f ? 1.f : 0.f;  // -0.0 fires
            y[o] = yv;
            st(spikes + o, hv[r]);
          }
        }
        float4* dst = reinterpret_cast<float4*>(hs + ((size_t)k * H + j) * RB);
        dst[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
        dst[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
      }
    }
    __syncthreads();  // the new spikes are visible before the next step reads them
  }
  // no block leaves while another may still read its partial sums
  if (mode == MODE_BN) cluster.sync();
}

template <typename IO>
int launch(const void* xg, const void* whh, const float* b2, const float* bnp, void* spikes,
           float* y, float* stats, int T, int R, int H, int shared, int mode,
           cudaStream_t stream) {
  int nblk = (R + RB - 1) / RB;
  nblk = nblk < MAX_CLUSTER ? nblk : MAX_CLUSTER;
  const int rows_blk = ((R + nblk - 1) / nblk + RB - 1) / RB * RB;
  const size_t smem = ((size_t)rows_blk * H + 2 * H) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  auto kern = train_fwd_kernel<IO>;
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
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const IO*>(xg), static_cast<const IO*>(whh),
                         b2, bnp, static_cast<IO*>(spikes), y, stats, T, R, H, shared, mode,
                         rows_blk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// io: 0 float32 streams, 1 bfloat16. xg [T, R, G] and whh [H, G] in the
// stream type (G = H shared, else 2H with the f half first); b2 [2, H] and
// bnp [2, H] f32; spikes [T, R, H] in the stream type, y [T, R, H] and stats
// [T, 2, H] f32 (stats written in mode 1 only). mode: 0 none, 1
// batch-statistics BN, 2 affine. One cluster of min(8, ceil(R / 8)) blocks
// runs every row, each block's rows within 227 KB of shared memory (4 bytes
// a row and unit). Returns the CUDA error code of the launch (0 on success).
int gsu_train_fwd_launch(int io, const void* xg, const void* whh, const float* b2,
                         const float* bnp, void* spikes, float* y, float* stats, int T, int R,
                         int H, int shared, int mode, void* stream) {
  if (H < 1 || H > 512 || R < 1 || T < 0 || mode < 0 || mode > 2 || io < 0 || io > 1)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io == 1)
    return launch<__nv_bfloat16>(xg, whh, b2, bnp, spikes, y, stats, T, R, H, shared, mode, s);
  return launch<float>(xg, whh, b2, bnp, spikes, y, stats, T, R, H, shared, mode, s);
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
