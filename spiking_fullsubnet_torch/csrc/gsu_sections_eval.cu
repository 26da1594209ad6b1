// Kernel B: every sub-band section of the serving path in one launch —
// layer-0 gates from the shared feature streams, the section's GSU stack,
// the output projection and the complex deep filter (or the projection
// itself).
//
// Replaces spiking_fullsubnet_tpu/ops/gsu_pallas.py: _sections_kernel
// (:1174), called by gsu_sections_eval_pallas (:1346, pallas_call :1602), in
// each of its modes.
//
// Per unit u (unit jj of section s) and step t, for each batch row b:
//   ck  = xa[t, b, a0:a0+aw] @ wa[u] + xb[t, b] @ wb[u]       (f32 sums)
//   xg0 = ck                                  alpha_mode 0 ("raw")
//       = alpha[b, u] ck                      alpha_mode 1 (one scale per utterance)
//       = alpha[t, b, u] ck                   alpha_mode 2 (per frame: "cum")
//       = alpha[t, b, u] ck - beta[t, b, u] uvec + vvec   (mode 2 with the
//         section's pre-LN fold "uv": "ln", :1218-1224)
//   L GSU layers (as kernel A), y = h_L @ Wproj + bproj        [P = 2 df ctr]
//   df_mode: enh[t, b, f0 + jj ctr + f] = sum_d X[t - (df-1-d)] * (y_re[d] + i y_im[d])
//   else:    proj[jj, t, b, :] = y in the stream type (:1296-1301)
// where X is the noisy spectrum (zero before the first frame): the oldest
// frame pairs with tap 0, as the reference's time unfold. The coefficient
// columns come in (c, d, fc) order (the caller permutes the projection).
//
// What bounds it on an H100: at the zoo-M bench shape (batch 256, T = 3751,
// 13 units of H = 224, dense one-hot layer-0 weights over the unit's window)
// the products are about 6 TFLOP in a strict recurrence over T; the streams
// (xa, xb, the spectrum in and the enhanced spectrum out) are about 4 GB; a
// per-frame alpha and beta add 2 x 4 bytes a (t, b, u).
// As for kernel A, the serial chain and the per-step weight reads through L2
// bound it, not the card's peak rates.
//
// Design: units are independent rows, so a block owns one unit and a tile of
// RB batch rows (grid: row tiles x units of all sections) and loops over T.
// Per step it stages the rows' input windows in shared memory, computes the
// layer-0 gates with its own unit's weights (the per-frame alpha and beta
// read as two f32 loads a row), runs the stack with spikes in shared memory
// and membranes in registers, and then either writes y to shared memory and
// applies the deep filter reading the df spectrum frames it needs straight
// from device memory (they were read by the same block df-1 steps before and
// sit in L1/L2), or writes y out. The [U, T, B, G] gate stream never exists,
// nor, in df_mode, the [U, T, B, P] coefficient stream. CUDA-core FMAs,
// sequential f32 sums.
#include "gsu_common.cuh"

using namespace gsu;

constexpr int MAX_SEC = 8;

struct SecInfo {
  int n, a0, aw, ctr, df, P, u0, f0, ln;
  // element offsets into the flat per-kind weight arrays, and of the
  // section's [n, T, B, P] block in out_proj (no df_mode)
  long long wa, wb, wihr, whh, coef, wproj, bproj, uv, oproj;
};

struct Secs {
  int n_sec;
  SecInfo s[MAX_SEC];
};

template <typename IO, int L>
__global__ void __launch_bounds__(512)
sections_kernel(Secs secs, int alpha_mode, int df_mode, const IO* __restrict__ xa,
                const IO* __restrict__ xb, const float* __restrict__ alpha,
                const float* __restrict__ beta, const float* __restrict__ spec_re,
                const float* __restrict__ spec_im, const IO* __restrict__ wa_all,
                const IO* __restrict__ wb_all, const float* __restrict__ uv_all,
                const IO* __restrict__ wihr_all, const IO* __restrict__ whh_all,
                const float* __restrict__ coef_all, const IO* __restrict__ wproj_all,
                const float* __restrict__ bproj_all, float* __restrict__ out_re,
                float* __restrict__ out_im, IO* __restrict__ out_proj, int T, int B, int Fa,
                int Fb, int Fs, int U, int W, int H, int shared, int x_cap) {
  extern __shared__ float4 smem4[];
  const int u = blockIdx.y;
  int si = 0;
  while (si + 1 < secs.n_sec && secs.s[si + 1].u0 <= u) ++si;
  const SecInfo sec = secs.s[si];
  const int jj = u - sec.u0;
  const int G = shared ? H : 2 * H;
  const int n_in = sec.aw + Fb;

  float* hs = reinterpret_cast<float*>(smem4);  // [L][H][RB] spikes
  float* xs = hs + L * H * RB;                  // [n_in][RB] input window
  float* ys = xs + x_cap * RB;                  // [RB][P] projection out (df_mode)

  const IO* wa = wa_all + sec.wa + (size_t)jj * sec.aw * G;
  const IO* wb = wb_all + sec.wb + (size_t)jj * Fb * G;
  const IO* wihr = wihr_all + sec.wihr;
  const IO* whh = whh_all + sec.whh;
  const IO* wproj = wproj_all + sec.wproj;
  const float* bproj = bproj_all + sec.bproj;

  const int row0 = blockIdx.x * RB;
  const int j = threadIdx.x;
  const bool active = j < H;
  const int j2 = shared ? -1 : H + j;
  const bool ln = sec.ln != 0 && alpha_mode == 2;

  for (int i = threadIdx.x; i < L * H * RB; i += blockDim.x) hs[i] = 0.f;
  float cf[L][4];
  load_coef<L>(coef_all + sec.coef, H, j, active, cf);
  // the pre-LN fold's column sums u and bias projection v, f and c halves
  float uf = 0.f, vf = 0.f, uc = 0.f, vc = 0.f;
  if (ln && active) {
    const float* uv = uv_all + sec.uv;
    uf = uv[j];
    vf = uv[G + j];
    if (!shared) {
      uc = uv[j2];
      vc = uv[G + j2];
    }
  }
  float c[L][RB];
  float al[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int b = row0 + r;
    al[r] = (alpha_mode == 1 && b < B) ? alpha[(size_t)b * U + u] : 0.f;
#pragma unroll
    for (int k = 0; k < L; ++k) c[k][r] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- stage the rows' inputs (coalesced reads, input-major smem) ----
    for (int idx = threadIdx.x; idx < RB * n_in; idx += blockDim.x) {
      const int r = idx / n_in, p = idx % n_in, b = row0 + r;
      float v = 0.f;
      if (b < B)
        v = p < sec.aw ? ld(xa + ((size_t)t * B + b) * Fa + sec.a0 + p)
                       : ld(xb + ((size_t)t * B + b) * Fb + (p - sec.aw));
      xs[p * RB + r] = v;
    }
    __syncthreads();

    // ---- layer-0 gates of this unit ----
    float px[RB], pxc[RB];
    if (active) {
      float qa[RB], qac[RB], qb[RB], qbc[RB];
      dot_rows(xs, sec.aw, wa, G, j, j2, qa, qac);
      dot_rows(xs + sec.aw * RB, Fb, wb, G, j, j2, qb, qbc);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float gf = qa[r] + qb[r], gc = qac[r] + qbc[r];
        if (alpha_mode == 1) {
          gf *= al[r];
          gc *= al[r];
        } else if (alpha_mode == 2) {
          // rows past B compute on row 0's scales; they are never written
          const int b = row0 + r < B ? row0 + r : 0;
          const size_t o = ((size_t)t * B + b) * U + u;
          const float a = alpha[o];
          gf *= a;
          gc *= a;
          if (ln) {
            const float be = beta[o];
            gf = gf - be * uf + vf;
            gc = gc - be * uc + vc;
          }
        }
        px[r] = gf;
        pxc[r] = gc;
      }
    }

    // ---- the section's stack (spikes land in hs[L-1]) ----
    stack_step<L>(hs, H, G, shared != 0, j, active, wihr, whh, cf, c, px, pxc,
                  [](int, int, float) {});

    // ---- output projection y = h_L @ Wproj + bproj: into shared memory
    // for the deep filter, or out as the section's [n, T, B, P] ----
    const float* hl = hs + (L - 1) * H * RB;
    for (int p = threadIdx.x; p < sec.P; p += blockDim.x) {
      float acc[RB], unused[RB];
      dot_rows(hl, H, wproj, sec.P, p, -1, acc, unused);
      const float bp = bproj[p];
      if (df_mode) {
#pragma unroll
        for (int r = 0; r < RB; ++r) ys[r * sec.P + p] = acc[r] + bp;
      } else {
        IO* o = out_proj + sec.oproj + ((size_t)jj * T + t) * B * sec.P;
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (row0 + r < B) st(o + (size_t)(row0 + r) * sec.P + p, acc[r] + bp);
      }
    }
    // without the deep filter, the next step's staging barrier orders the
    // projection's reads of hs before the stack rewrites them
    if (!df_mode) continue;
    __syncthreads();

    // ---- deep filter against the last df noisy frames ----
    const int ctr = sec.ctr, df = sec.df;
    for (int idx = threadIdx.x; idx < RB * ctr; idx += blockDim.x) {
      const int r = idx / ctr, f = idx % ctr, b = row0 + r;
      if (b >= B) continue;
      const int col = sec.f0 + jj * ctr + f;
      const float* y = ys + r * sec.P;
      float er = 0.f, ei = 0.f;
      for (int d = 0; d < df; ++d) {
        const int tt = t - (df - 1 - d);
        if (tt < 0) continue;
        const size_t o = ((size_t)tt * B + b) * Fs + col;
        const float tr = spec_re[o], tm = spec_im[o];
        const float cr = y[d * ctr + f], ci = y[(df + d) * ctr + f];
        er += tr * cr - tm * ci;
        ei += tr * ci + tm * cr;
      }
      const size_t oo = ((size_t)t * B + b) * W + col;
      out_re[oo] = er;
      out_im[oo] = ei;
    }
    // ys and xs are rewritten only after the next step's barriers
  }
}

#define SECTIONS_PARAMS                                                                        \
  const Secs &secs, int alpha_mode, int df_mode, const void *xa, const void *xb,              \
      const float *alpha, const float *beta, const float *spec_re, const float *spec_im,      \
      const void *wa, const void *wb, const float *uv, const void *wihr, const void *whh,     \
      const float *coef, const void *wproj, const float *bproj, float *out_re, float *out_im, \
      void *out_proj, int T, int B, int Fa, int Fb, int Fs, int U, int W, int H, int shared,  \
      int x_cap, int p_cap, cudaStream_t stream
#define SECTIONS_ARGS                                                                       \
  secs, alpha_mode, df_mode, xa, xb, alpha, beta, spec_re, spec_im, wa, wb, uv, wihr, whh,  \
      coef, wproj, bproj, out_re, out_im, out_proj, T, B, Fa, Fb, Fs, U, W, H, shared, x_cap, \
      p_cap, stream

template <typename IO, int L>
static int launch_typed(SECTIONS_PARAMS) {
  auto kern = sections_kernel<IO, L>;
  const size_t smem = ((size_t)L * H * RB + (size_t)x_cap * RB + (size_t)RB * p_cap) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + RB - 1) / RB, U);
  const int threads = (H + 31) / 32 * 32;
  kern<<<grid, threads, smem, stream>>>(
      secs, alpha_mode, df_mode, static_cast<const IO*>(xa), static_cast<const IO*>(xb), alpha,
      beta, spec_re, spec_im, static_cast<const IO*>(wa), static_cast<const IO*>(wb), uv,
      static_cast<const IO*>(wihr), static_cast<const IO*>(whh), coef,
      static_cast<const IO*>(wproj), bproj, out_re, out_im, static_cast<IO*>(out_proj), T, B,
      Fa, Fb, Fs, U, W, H, shared, x_cap);
  return (int)cudaGetLastError();
}

template <typename IO>
static int launch_l(int L, SECTIONS_PARAMS) {
  switch (L) {
    case 1: return launch_typed<IO, 1>(SECTIONS_ARGS);
    case 2: return launch_typed<IO, 2>(SECTIONS_ARGS);
    case 3: return launch_typed<IO, 3>(SECTIONS_ARGS);
    case 4: return launch_typed<IO, 4>(SECTIONS_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

constexpr int TABLE_COLS = 18;

extern "C" {

// sec_table: n_sec rows of TABLE_COLS int64 (n, a0, aw, ctr, df, P, u0, f0,
// ln, then the element offsets of wa, wb, wihr, whh, coef, wproj, bproj, uv
// in the flat weight arrays and of the section's block in out_proj).
// Streams: xa [T, B, Fa], xb [T, B, Fb] io type; alpha f32: unused
// (alpha_mode 0), [B, U] (1) or [T, B, U] (2); beta [T, B, U] f32, read by
// the sections with ln set (alpha_mode 2 only). df_mode 1: spec_re/spec_im
// [T, B, Fs] f32 in, out_re/out_im [T, B, W] f32 out; df_mode 0: out_proj
// holds each section's [n, T, B, P] in the io type. Weights per section:
// wa [n, aw, G], wb [n, Fb, G], wihr [max(L-1,1), H, G], whh [L, H, G],
// wproj [H, P] io type; uv [2, G] (ln), coef [L, 4, H], bproj [P] f32.
// Returns the CUDA error code of the launch (0 on success).
int gsu_sections_eval_launch(int io_bf16, int n_sec, const long long* sec_table,
                             int alpha_mode, int df_mode, const void* xa, const void* xb,
                             const float* alpha, const float* beta, const float* spec_re,
                             const float* spec_im, const void* wa, const void* wb,
                             const float* uv, const void* wihr, const void* whh,
                             const float* coef, const void* wproj, const float* bproj,
                             float* out_re, float* out_im, void* out_proj, int T, int B, int Fa,
                             int Fb, int Fs, int U, int W, int H, int L, int shared,
                             void* stream_ptr) {
  if (n_sec < 1 || n_sec > MAX_SEC || H < 1 || H > 512 || B < 1 || U < 1 || alpha_mode < 0 ||
      alpha_mode > 2)
    return (int)cudaErrorInvalidValue;
  Secs secs;
  secs.n_sec = n_sec;
  int x_cap = 0, p_cap = 0;
  for (int i = 0; i < n_sec; ++i) {
    const long long* q = sec_table + TABLE_COLS * i;
    SecInfo& si = secs.s[i];
    si.n = (int)q[0]; si.a0 = (int)q[1]; si.aw = (int)q[2]; si.ctr = (int)q[3];
    si.df = (int)q[4]; si.P = (int)q[5]; si.u0 = (int)q[6]; si.f0 = (int)q[7];
    si.ln = (int)q[8];
    si.wa = q[9]; si.wb = q[10]; si.wihr = q[11]; si.whh = q[12]; si.coef = q[13];
    si.wproj = q[14]; si.bproj = q[15]; si.uv = q[16]; si.oproj = q[17];
    if (si.ln && (alpha_mode != 2 || !beta)) return (int)cudaErrorInvalidValue;
    if (si.aw + Fb > x_cap) x_cap = si.aw + Fb;
    if (si.P > p_cap) p_cap = si.P;
  }
  if (df_mode ? !(spec_re && spec_im && out_re && out_im) : !out_proj)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (io_bf16)
    return launch_l<__nv_bfloat16>(L, SECTIONS_ARGS);
  return launch_l<float>(L, SECTIONS_ARGS);
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
