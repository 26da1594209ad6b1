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
// the biased variance of c' over all R rows (two passes, the mean, then the
// mean of (c' - mean)^2, each a sum times 1/R), y = (c' - mean) /
// sqrt(var + eps) gamma + beta; "affine": y = c' scale + shift; "none":
// y = c'. h_t = (y >= 0), c_t = y. Writes spikes [T, R, H], y [T, R, H] and,
// in mode "bn", stats [T, 2, H] = (mean, var). Two stream types, as the TPU
// kernel's _KCfg.io (gsu_pallas.py:129-133): float32, or bfloat16 xg, W_hh
// and spikes. The membranes y, the statistics and all cell arithmetic are
// float32 in both: the backward recomputes each step from y[t-1], so a
// bf16 y would compound its rounding over every step. Precise expf and
// 1/sqrtf, no fast math.
//
// What bounds it on an H100: at the training shapes (batch 64 x 6 s,
// T = 751; up to 1536 rows x 256 units) the bytes are small (xg read,
// spikes, y and stats written: under 2 GB) and the products few (h is
// 0/1); the limit is the chain of 751 dependent steps, each a product, the
// cell, the statistics over every row and the spikes' exchange. The
// statistics cross every row at every step, so the rows cannot run as
// independent blocks.
//
// Design (the host's plan, ops/gsu_kernels.train_plan, sizes it; see
// gsu_train_mma.cuh for the layout):
//   - The units, not the rows, are split over a cluster of up to 16 blocks
//     (J units a block, 16 or 32; above 8 blocks a non-portable cluster,
//     which the H100 takes: twice the SMs of 8 blocks, and with J 16 a warp
//     takes two rows an instruction). A unit's statistics then lie in
//     one block: each block reduces its own rows in a fixed order (a lane
//     over its rows, then the warps in order), with no cluster barrier and
//     no atomics, so the result does not depend on the schedule.
//   - The block's gate columns of W_hh stay in shared memory for the whole
//     sequence, packed once a launch by the host (train_pack): bf16 as
//     mma.sync A fragments (14-25 KB at the shared training shapes).
//   - bf16 streams: h_{t-1} @ W_hh[:, J_b] is mma.sync m16n8k16 with the
//     spikes as B fragments built from bits (h is 0/1, exact in bf16); each
//     k-tile is summed from zero and added in float32 (kernel C sums pairs
//     of k-tiles so; one tile is safer still: the tensor core truncates
//     when it adds a running sum, and a pair of k-tiles chained in it
//     parted float32 D from its plain version).
//   - float32 streams: the same accumulators from CUDA-core FMAs over k in
//     order, the weights as floats in shared memory: each product is the
//     plain version's to the bit (torch.matmul's float32 product sums the
//     fired weights k = 0, 1, ... in turn, as the row-split kernel before
//     this one did; measured on the H100). Three exact bf16 terms on the tensor cores were faster but
//     summed in another order, and in mode "affine" (gains above 1) that
//     drifted 1.6e-5 from the plain version within 40 steps.
//   - The cell, the statistics, y and the spikes take a lane a unit and a
//     warp a row at a time: each warp passes its product's accumulators
//     through a tile in shared memory, so that every access to xg, y and the
//     spikes is one run of the block's units, and a warp vote over a row
//     gives 32 units' spike bits at once. The block's xg of the next step
//     is asked into L1 a step ahead.
//   - One cluster barrier a step: each block pushes its spike bits of step
//     t (R J / 8 bytes) into every other block's shared memory (distributed
//     shared memory, 16-byte stores), double-buffered by the parity of t,
//     then the barrier. After it every block reads all of h_t from its own
//     shared memory.
//   - The carried membrane c (R x J floats a block) stays in shared memory
//     when the plan finds room, else in a device-memory scratch that only
//     its owning thread touches (1536 rows at H 256: 196 KB a block).
// Where it waits now: see PERF.md section 7 (train_profile's phases).
//
// Band mode (the kernel's BAND instance, gsu_train_fwd_band_launch) also
// replaces _fwd_kernel under JAX's band sharding
// (spiking_fullsubnet_tpu/models/fused_forward.py:175-229): a rank of a band
// group holds some of every utterance's sub-band units as rows, and BN's
// statistics span the group's rows. The block sums its rank's leading
// rows_real rows, then swaps the sum with the same block of every other
// rank inside the kernel (band_exchange, gsu_train_mma.cuh: pushes over
// peer memory, a release flag, acquire spins on its own memory, the sum in
// rank order, so every rank holds the same statistics to the bit), twice a
// step (the mean, then the variance), with BN's count the group's real
// rows; pad rows are normalised with the group's statistics. One launch a
// layer: the host takes no step. Its bound is the same chain of steps plus
// two exchanges' latency a step (a few microseconds on one card, NVLink's
// on peer cards). Several ranks' clusters may share one launch on one card
// (the group form): cluster c is rank c, on the c-th of each stacked tensor.
#include <cooperative_groups.h>

#include "gsu_train_mma.cuh"

namespace cg = cooperative_groups;
using namespace gsut;

namespace {

constexpr int PRE_LD = 36;  // floats a row of a warp's pre-activation tile (conflict-free)
constexpr int RS = 8;       // rows whose xg a lane loads at once

template <typename IO, int NGB, bool BAND>
__global__ void __launch_bounds__(NTHREADS, 1)
train_fwd_kernel(const IO* __restrict__ xg, const uint4* __restrict__ wfrag,
                 const float* __restrict__ b2, const float* __restrict__ bnp,
                 IO* __restrict__ spikes, float* __restrict__ y, float* __restrict__ stats,
                 float* __restrict__ gstate, unsigned long long* __restrict__ prof,
                 const TrainPlan p, const BandX bx) {
  constexpr int NTERM = sizeof(IO) == 4 ? 3 : 1;
  extern __shared__ uint4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // band mode: cluster cl of the grid is band rank me, its tensors the
  // cl-th of the launch's (the group form stacks its ranks' rows); its BN
  // sums run over its leading rows_real rows, BN's count is the group's
  int me = 0, Rs = p.R;
  if constexpr (BAND) {
    const int cl = (int)blockIdx.x / p.nblk;
    me = bx.rank + cl;
    Rs = bx.rows_real[me];
    xg += (size_t)cl * p.T * p.R * p.G;
    spikes += (size_t)cl * p.T * p.R * p.H;
    y += (size_t)cl * p.T * p.R * p.H;
    stats += (size_t)cl * p.T * 2 * p.H;
    gstate += (size_t)cl * p.nblk * p.Rp * p.ldJ;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int H = p.H, R = p.R, G = p.G, J = p.J, shared = p.shared, mode = p.mode;
  const int J0 = rank * J, Jb = min(J, H - J0);
  const int NG = p.Rp >> 3, NB = (NG + NGB - 1) / NGB;
  const int row_bytes = 2 * p.JT, slice = p.Rp * row_bytes, step_bytes = p.nblk * slice;
  uint8_t* bits = reinterpret_cast<uint8_t*>(sm + p.o_bits);  // [2][nblk][Rp][2 JT]
  float* vec = reinterpret_cast<float*>(sm + p.o_vec);        // [6][J] b_f b_c p0 p1 mean rstd
  float* part = reinterpret_cast<float*>(sm + p.o_part);      // [NW][J]
  // uint4 of the block's gate weights: bf16 fragments, or float32 [MT][KT 16][16]
  const size_t wg_n = NTERM == 1 ? (size_t)p.MT * p.KT * 32 : (size_t)p.MT * p.KT * 64;
  const uint4* wg = wfrag + rank * wg_n;
  if (p.o_wg >= 0) {
    uint4* dst = reinterpret_cast<uint4*>(sm + p.o_wg);
    for (size_t i = tid; i < wg_n; i += NTHREADS) dst[i] = wg[i];
    wg = dst;
  }
  // c: the carried membrane [Rp][ldJ], each element owned by one thread
  float* cs = p.o_state[0] >= 0 ? reinterpret_cast<float*>(sm + p.o_state[0])
                                : gstate + (size_t)rank * p.Rp * p.ldJ;
  for (int i = tid; i < 2 * step_bytes / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(bits)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < p.Rp * p.ldJ; i += NTHREADS) cs[i] = 0.f;
  for (int u = tid; u < J; u += NTHREADS) {
    const bool in = u < Jb;
    vec[u] = in ? b2[J0 + u] : 0.f;
    vec[J + u] = in ? b2[H + J0 + u] : 0.f;
    vec[2 * J + u] = in ? bnp[J0 + u] : 0.f;
    vec[3 * J + u] = in ? bnp[H + J0 + u] : 0.f;
  }
  __syncthreads();
  cluster.sync();  // every block's buffers zeroed before any spikes arrive
  const float inv_n = 1.f / (float)(BAND ? bx.rows_global : R);
  float* mean = vec + 4 * J;
  const float* rstd = vec + 5 * J;
  // m-tiles a chunk: two, or one when the pairs would leave warps idle (a
  // block of few rows: the warps share out (chunk, batch) items)
  const int cm = p.MT > 1 && (p.MT + 1) / 2 * NB < NW ? 1 : 2;
  const int nchunk = (p.MT + cm - 1) / cm;
  // phases: 0 products and cell, 1 statistics, 2 y and spikes, 3 exchange
  PhaseClock clk;
  clk.start(prof);

  // each warp's tile of pre-activations [NGB 8 rows][PRE_LD], the product's
  // accumulators on their way from the mma layout to a lane a unit
  float* pre = reinterpret_cast<float*>(sm + p.o_pre) + (size_t)warp * NGB * 8 * PRE_LD;
  // the row layout: upl lanes a row (all 32, or 16 when J is 16, two rows
  // an instruction: rpi), units lane % upl and + 32 (qn of them)
  const int upl = J <= 16 ? 16 : 32, rpi = 32 / upl, qn = (J + 31) / 32;

  for (int t = 0; t < p.T; ++t) {
    const uint8_t* hb = bits + (t & 1) * step_bytes;
    uint8_t* nb = bits + ((t & 1) ^ 1) * step_bytes;
    const IO* xt = xg + (size_t)t * R * G;
    if (t + 1 < p.T) {  // the block's gates of the next step, into L1
      const IO* xn = xg + (size_t)(t + 1) * R * G + J0;
      prefetch_rows<true>(xn, (size_t)G * sizeof(IO), Jb * (int)sizeof(IO), R);
      if (!shared) prefetch_rows<true>(xn + H, (size_t)G * sizeof(IO), Jb * (int)sizeof(IO), R);
    }
    // pass 1: the products, then the cell of every element a lane a unit
    // (a chunk of 32 units: a warp a row; of 16 or fewer (unshared, or one
    // m-tile): lanes 16-31 on the odd rows), and the rows' sums of c'. The
    // warps share out (chunk, batch) pairs, so that a block of few rows
    // still keeps all of them busy.
    float s[4] = {0.f, 0.f, 0.f, 0.f};  // a lane's sums of c' by chunk
    for (int it = warp; it < nchunk * NB; it += NW) {
      const int c = it / NB, bt = it - c * NB;
      const int nmt = min(cm, p.MT - cm * c);
      const bool half = !shared || nmt == 1;  // warp-uniform
      const int hl = half ? lane & 15 : lane;
      const int uc = (shared ? 16 : 8) * cm * c + hl;  // this lane's unit
      const bool lane_in = (shared || hl < 8 * nmt) && uc < Jb;
      // the lane's gate columns in the tile: f, and c (unshared)
      const int colf = shared ? hl : 16 * (hl >> 3) + (hl & 7);
      const int ng0 = bt * NGB;
      if constexpr (NTERM == 1) {
        float acc[2][NGB][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < NGB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
        if (t > 0) gate_product<NGB, 1>(acc, wg, cm * c, nmt, p, hb, ng0, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < NGB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pre[elem_row(n, tig, e) * PRE_LD + 16 * i + gid + 8 * (e >> 1)] = acc[i][n][e];
      } else {
        gate_product_f32<NGB>(pre, PRE_LD, reinterpret_cast<const float*>(wg), cm * c, nmt, p,
                              hb, ng0, lane, t > 0);
      }
      __syncwarp();
      const int r0 = 8 * ng0;
      const int rstep = half ? 2 : 1;  // half: lanes 16-31 on the odd rows
      float sc = 0.f;
      // RS rows at a time, their xg loads first, so that they are in flight together
      for (int rb = half ? lane >> 4 : 0; rb < NGB * 8; rb += RS * rstep) {
        float xf[RS], xc[RS], cv[RS];
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          const int rr = rb + i * rstep, r = r0 + rr;
          xf[i] = xc[i] = cv[i] = 0.f;
          if (!lane_in || rr >= NGB * 8 || r >= R) continue;
          const IO* x = xt + (size_t)r * G + J0 + uc;
          xf[i] = ld(x);
          if (!shared) xc[i] = ld(x + H);
          cv[i] = cs[r * p.ldJ + uc];
        }
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          const int rr = rb + i * rstep, r = r0 + rr;
          if (!lane_in || rr >= NGB * 8 || r >= R) continue;
          const float pre_f = pre[rr * PRE_LD + colf] + xf[i];
          const float pre_c = shared ? pre_f : pre[rr * PRE_LD + colf + 8] + xc[i];
          const float f = 1.f / (1.f + expf(-(pre_f + vec[uc])));
          const float cy = f * cv[i] + (1.f - f) * (pre_c + vec[J + uc]);
          cs[r * p.ldJ + uc] = cy;
          if (!BAND || r < Rs) sc += cy;
        }
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        if (cc == c) s[cc] += sc;
      __syncwarp();  // the tile is read before the next item writes it
    }
    if (mode == MODE_BN)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nchunk) break;
        const int nmt = min(cm, p.MT - cm * c);
        const bool half = !shared || nmt == 1;
        const int hl = half ? lane & 15 : lane;
        const int uc = (shared ? 16 : 8) * cm * c + hl;
        float v = s[c];
        if (half) v += __shfl_xor_sync(0xffffffffu, v, 16);
        if ((!half || lane < 16) && uc < J && (shared || hl < 8 * nmt)) part[warp * J + uc] = v;
      }
    clk.mark(0);
    if (mode == MODE_BN) {
      __syncthreads();
      if constexpr (BAND) {  // the group's sum of c', then the mean
        for (int u = tid; u < J; u += NTHREADS) mean[u] = warp_sum(part, J, u);
        __syncthreads();
        band_exchange<1>(bx, me, rank, J0, Jb, J, mean, bx.seq0 + 2ull * t, t, 0);
        for (int u = tid; u < J; u += NTHREADS) mean[u] *= inv_n;
      } else {
        for (int u = tid; u < J; u += NTHREADS) mean[u] = warp_sum(part, J, u) * inv_n;
      }
      __syncthreads();
      // pass 2: the rows' sums of (c' - mean)^2, a lane a unit
      float s[2] = {0.f, 0.f};
      for (int bt = warp; bt < NB; bt += NW) {
        const int r0 = 8 * bt * NGB + lane / upl;
        for (int rb = 0; rb < NGB * 8; rb += RS * rpi) {
          float cv[RS][2];  // the rows' c', their loads in flight together
#pragma unroll
          for (int i = 0; i < RS; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int rr = rb + i * rpi, r = r0 + rr, u = lane % upl + 32 * q;
              cv[i][q] = q < qn && rr < NGB * 8 && r < Rs && u < Jb ? cs[r * p.ldJ + u] : 0.f;
            }
#pragma unroll
          for (int i = 0; i < RS; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int rr = rb + i * rpi, r = r0 + rr, u = lane % upl + 32 * q;
              if (q >= qn || rr >= NGB * 8 || r >= Rs || u >= Jb) continue;
              const float d = cv[i][q] - mean[u];
              s[q] += d * d;
            }
        }
      }
      if (rpi == 2) {  // the two rows' halves of a unit
        s[0] += __shfl_xor_sync(0xffffffffu, s[0], 16);
        s[1] += __shfl_xor_sync(0xffffffffu, s[1], 16);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (lane < upl && lane + 32 * q < J) part[warp * J + lane + 32 * q] = s[q];
      __syncthreads();
      float* rstd_w = vec + 5 * J;
      if constexpr (BAND) {  // the group's sum of (c' - mean)^2
        for (int u = tid; u < J; u += NTHREADS) rstd_w[u] = warp_sum(part, J, u);
        __syncthreads();
        band_exchange<1>(bx, me, rank, J0, Jb, J, rstd_w, bx.seq0 + 2ull * t + 1ull, t, 1);
      }
      for (int u = tid; u < J; u += NTHREADS) {
        const float var = (BAND ? rstd_w[u] : warp_sum(part, J, u)) * inv_n;
        rstd_w[u] = 1.f / sqrtf(var + BN_EPS);
        if (u < Jb) {
          stats[(size_t)t * 2 * H + J0 + u] = mean[u];
          stats[((size_t)t * 2 + 1) * H + J0 + u] = var;
        }
      }
      __syncthreads();
    } else {
      __syncthreads();  // pass 1's items give a row's units to other warps than pass 3
    }
    clk.mark(1);
    // pass 3: y and the spikes, a lane a unit (J 16: two rows a warp); the
    // spikes as bits (a warp vote over 32 lanes) into this block's slice of
    // the next buffer
    uint8_t* own = nb + rank * slice;
    for (int bt = warp; bt < NB; bt += NW) {
      const int r0 = 8 * bt * NGB;
      for (int rb = 0; rb < NGB * 8; rb += RS * rpi) {
        float cv[RS][2];  // the rows' c', their loads in flight together
#pragma unroll
        for (int i = 0; i < RS; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int rr = rb + i * rpi + lane / upl, r = r0 + rr, u = lane % upl + 32 * q;
            cv[i][q] = q < qn && rr < NGB * 8 && r < R && u < Jb ? cs[r * p.ldJ + u] : 0.f;
          }
#pragma unroll
        for (int i = 0; i < RS; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int rw = r0 + rb + i * rpi;  // the warp's first row of this vote
            if (q >= qn || rb + i * rpi >= NGB * 8 || rw >= p.Rp) break;  // warp-uniform
            const int r = rw + lane / upl, u = lane % upl + 32 * q;
            bool spike = false;
            if (r < R && u < Jb) {
              float yv = cv[i][q];
              if (mode == MODE_BN)
                yv = (yv - mean[u]) * rstd[u] * vec[2 * J + u] + vec[3 * J + u];
              else if (mode == MODE_AFFINE)
                yv = yv * vec[2 * J + u] + vec[3 * J + u];
              cs[r * p.ldJ + u] = yv;
              spike = yv >= 0.f;  // -0.0 fires
              const size_t o = ((size_t)t * R + r) * H + J0 + u;
              y[o] = yv;
              st(spikes + o, spike ? 1.f : 0.f);
            }
            const unsigned vote = __ballot_sync(0xffffffffu, spike);
            // byte k of the vote: row rw + k / (upl / 8), byte k % (upl / 8) + 4 q
            const int bpr = upl / 8, byte = lane % bpr + 4 * q;
            if (lane < 4 && byte < row_bytes)
              own[(rw + lane / bpr) * row_bytes + byte] = (uint8_t)(vote >> (8 * lane));
          }
      }
    }
    clk.mark(2);
    if (t + 1 == p.T) break;  // the last step's spikes feed no product
    __syncthreads();
    // this block's slice into every other block's buffer, then one barrier
    const int nv = slice / 16;
    const uint4* src = reinterpret_cast<const uint4*>(own);
    for (int i = tid; i < (p.nblk - 1) * nv; i += NTHREADS) {
      const int q = i / nv, v = i - q * nv;
      uint4* dst = cluster.map_shared_rank(const_cast<uint4*>(src), (rank + 1 + q) % p.nblk);
      dst[v] = src[v];
    }
    cluster.sync();
    clk.mark(3);
  }
  clk.finish(blockIdx.x);
}

template <typename IO, int NGB, bool BAND>
cudaError_t prepare(const TrainPlan& p) {
  auto kern = train_fwd_kernel<IO, NGB, BAND>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       p.smem);
  if (e == cudaSuccess) e = allow_cluster(kern, p.nblk);
  return e;
}

template <typename IO, int NGB, bool BAND>
int launch(const void* xg, const void* wfrag, const float* b2, const float* bnp, void* spikes,
           float* y, float* stats, float* gstate, unsigned long long* prof, const TrainPlan& p,
           const BandX& bx, int clusters, cudaStream_t stream) {
  cudaError_t e = prepare<IO, NGB, BAND>(p);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch L(p, clusters, stream);
  e = cudaLaunchKernelEx(&L.cfg, train_fwd_kernel<IO, NGB, BAND>, static_cast<const IO*>(xg),
                         static_cast<const uint4*>(wfrag), b2, bnp, static_cast<IO*>(spikes), y,
                         stats, gstate, prof, p, bx);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename IO, bool BAND>
int launch_io(const void* xg, const void* wfrag, const float* b2, const float* bnp,
              void* spikes, float* y, float* stats, float* gstate, unsigned long long* prof,
              const TrainPlan& p, const BandX& bx, int clusters, cudaStream_t s) {
  if (p.ngb == 4)
    return launch<IO, 4, BAND>(xg, wfrag, b2, bnp, spikes, y, stats, gstate, prof, p, bx,
                               clusters, s);
  if (p.ngb == 2)
    return launch<IO, 2, BAND>(xg, wfrag, b2, bnp, spikes, y, stats, gstate, prof, p, bx,
                               clusters, s);
  return launch<IO, 1, BAND>(xg, wfrag, b2, bnp, spikes, y, stats, gstate, prof, p, bx, clusters,
                             s);
}

// How many clusters of the band instance fit on the card at once.
template <typename IO, int NGB>
cudaError_t max_clusters(const TrainPlan& p, int* n) {
  cudaError_t e = prepare<IO, NGB, true>(p);
  if (e != cudaSuccess) return e;
  ClusterLaunch L(p, 1, nullptr);
  return cudaOccupancyMaxActiveClusters(n, train_fwd_kernel<IO, NGB, true>, &L.cfg);
}

}  // namespace

extern "C" {

// io: 0 float32 streams, 1 bfloat16. xg [T, R, G] in the stream type (G = H
// shared, else 2H with the f half first); wfrag the block's packed gate
// columns of W_hh (train_pack: [nblk][MT][KT][nterm][32] x 16 bytes); b2
// [2, H] and bnp [2, H] f32; spikes [T, R, H] in the stream type, y [T, R,
// H] and stats [T, 2, H] f32 (stats written in mode 1 only); gstate the
// plan's device-memory state ([nblk][Rp][ldJ] f32, unused when the plan
// keeps c in shared memory); prof null, or [nblk][6] cycle counters (the
// phase profile). mode: 0 none, 1 batch-statistics BN, 2 affine.
// The plan (train_plan) sizes the cluster and every shared-memory region;
// a plan beyond 227 KB a block or that does not match the shapes is
// refused. Returns the CUDA error code of the launch (0 on success).
int gsu_train_fwd_launch(int io, const void* xg, const void* wfrag, const float* b2,
                         const float* bnp, void* spikes, float* y, float* stats, float* gstate,
                         unsigned long long* prof, const TrainPlan* plan, void* stream) {
  const TrainPlan& p = *plan;
  if (!plan_ok(p) || p.T < 0 || p.mode < 0 || p.mode > 2 || io < 0 || io > 1 ||
      p.nterm != (io == 1 ? 1 : 3) || p.o_wd != -1)
    return (int)cudaErrorInvalidValue;
  if (p.T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BandX none = {};
  if (io == 1)
    return launch_io<__nv_bfloat16, false>(xg, wfrag, b2, bnp, spikes, y, stats, gstate, prof, p,
                                           none, 1, s);
  return launch_io<float, false>(xg, wfrag, b2, bnp, spikes, y, stats, gstate, prof, p, none, 1,
                                 s);
}

// Kernel D in band mode (mode 1 only), one launch a layer: `clusters`
// clusters, cluster c the band rank bx.rank + c on the c-th of each stacked
// tensor (xg [clusters][T, R, G], spikes and y [clusters][T, R, H], stats
// [clusters][T, 2, H], gstate [clusters][nblk][Rp][ldJ]); the 2T exchanges
// of the launch take sequence numbers bx.seq0 .. bx.seq0 + 2T - 1 (see
// gsu_train_mma.cuh). One cluster a process on peer cards, or the G ranks
// of a group on one card (the clusters must be co-resident:
// gsu_train_fwd_band_clusters). Returns the CUDA error code of the launch;
// a failed exchange shows in bx.err after it.
int gsu_train_fwd_band_launch(int io, const void* xg, const void* wfrag, const float* b2,
                              const float* bnp, void* spikes, float* y, float* stats,
                              float* gstate, const TrainPlan* plan, const BandX* band,
                              int clusters, void* stream) {
  const TrainPlan& p = *plan;
  if (!plan_ok(p) || p.T < 0 || io < 0 || io > 1 || p.nterm != (io == 1 ? 1 : 3) ||
      p.o_wd != -1 || !band_ok(p, *band, clusters))
    return (int)cudaErrorInvalidValue;
  if (p.T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io == 1)
    return launch_io<__nv_bfloat16, true>(xg, wfrag, b2, bnp, spikes, y, stats, gstate, nullptr,
                                          p, *band, clusters, s);
  return launch_io<float, true>(xg, wfrag, b2, bnp, spikes, y, stats, gstate, nullptr, p, *band,
                                clusters, s);
}

// The clusters of kernel D's band instance that the card holds at once.
int gsu_train_fwd_band_clusters(int io, const TrainPlan* plan, int* n) {
  const TrainPlan& p = *plan;
  if (!plan_ok(p) || io < 0 || io > 1) return (int)cudaErrorInvalidValue;
  if (io == 1) {
    if (p.ngb == 4) return (int)max_clusters<__nv_bfloat16, 4>(p, n);
    if (p.ngb == 2) return (int)max_clusters<__nv_bfloat16, 2>(p, n);
    return (int)max_clusters<__nv_bfloat16, 1>(p, n);
  }
  if (p.ngb == 4) return (int)max_clusters<float, 4>(p, n);
  if (p.ngb == 2) return (int)max_clusters<float, 2>(p, n);
  return (int)max_clusters<float, 1>(p, n);
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
