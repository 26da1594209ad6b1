// Kernel C: the whole serving model in one launch — audio hop chunks in,
// enhanced hop chunks out.
//
// Replaces spiking_fullsubnet_tpu/ops/gsu_pallas.py: _monolith_kernel
// (:1626), called by sfsb_monolith_serve_pallas (:1885, pallas_call :2114).
//
// Per step t, for each batch row (F1 = n_fft/2 + 1 bins, F = F1 - 1):
//   frame  = chunks t..t+3 (n_fft = 4 hop samples)
//   re, im = frame @ wdft                  windowed DFT (hann folded in)
//   mag    = sqrt(sqrt(re^2 + im^2))       fdrc = 0.5; mag_io = mag rounded
//   s1, s2 = mag @ sel_mag, mag^2 @ sel_mag   per-unit statistics; column U
//                                          is the fullband input's mean
//   fullband: xg = mag_io[:Fin] @ wa_fb, scaled per norm
//            ("ln": rstd xg - rstd mu u + v, "cum": xg / (running mean + eps))
//            -> L_f GSU layers -> fb_y = h @ wproj_fb + bproj_fb
//   unit scales: "ln" alpha = rstd, beta = rstd mu over the unit's unfold
//            (magnitude and fb_y); "cum" alpha = 1 / (running mean + eps)
//   unit u: xg = alpha (mag_io[a0:a0+aw] @ wa[u] + fb_io @ wb[u]) [- beta u + v]
//            -> L GSU layers -> y = h @ wproj + bproj [2 df ctr]
//            -> deep filter over the last df spectrum frames (oldest at tap 0)
//   yf     = enh_io @ widft (inverse DFT, window over the COLA constant 3/2),
//            zero for frames t >= t_real
//   out[t] = yf_t[0:hop] + yf_{t-1}[hop:2hop] + yf_{t-2}[2hop:3hop]
//            + yf_{t-3}[3hop:4hop]
// Streams and weights are f32 or bf16; accumulation, membranes, statistics,
// the deep filter and the overlap-add are f32.
//
// What bounds it on an H100: at flagship M (batch 256 x 30 s, T + 3 = 3754
// steps, fullband 2 x 320, 13 units of 2 x 224, DFT and inverse DFT of
// 512 x 257 x 2) the bytes are small (audio in and out, about 0.5 GB, and
// 2.6 MB of weights) and the products a few TFLOP: the card's peak rates
// allow a few milliseconds. What limits it is the serial chain of 3754
// dependent steps, each a sequence of dependent products (DFT, fullband
// stack, unit stacks, inverse DFT) whose weights stream from L2.
//
// Design: units that were independent in kernel B are coupled here (the
// fullband output and the statistics of a row feed all units of that row;
// the inverse DFT of a row needs every unit's deep filter), so a row tile's
// whole model advances in lock step, and its state (13 units x 2 layers x
// 224 membranes and spikes per row) does not fit one SM. A thread-block
// cluster of up to 8 blocks owns a tile of RB = 8 rows:
//   - block 0 keeps the chunk ring, computes the DFT, magnitude, statistics,
//     the fullband stack and projection and publishes them in its shared
//     memory; after the units have run it computes the inverse DFT and the
//     overlap-add and writes the hop chunk;
//   - blocks 1..7 hold the sub-band units (unit u on block 1 + u % 7), their
//     spikes, membranes and deep-filter rings in their own shared memory;
//     they read block 0's published values through distributed shared memory
//     and write their enhanced bins into block 0's shared memory.
// Two cluster barriers per step order the hand-offs. Every product is CUDA-
// core FMAs in f32 with one thread per output column and the row tile's
// inputs in shared memory (gsu_common.cuh), the GSU step is the one of
// kernels A and B. A later version can overlap block 0's inverse DFT with the
// units' next step and use tensor cores for the DFTs.
#include <cooperative_groups.h>

#include "gsu_common.cuh"

namespace cg = cooperative_groups;
using namespace gsu;

constexpr int MAX_SEC = 8;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr float LN_EPS = 1e-5f;

struct MonoSec {
  int n, a0, aw, ctr, df, P, u0, f0;
  // element offsets into the flat per-kind weight arrays
  long long wa, wb, uv, wihr, whh, coef, wproj, bproj;
};

// Mirrored by _MonoArgs in ops/gsu_kernels.py (same field order).
struct MonoArgs {
  const void* chunks;  // [S + 3, B, hop] io
  float* out;          // [S, B, hop]
  const void* wdft;    // [n_fft, 2 F1] io: cos | -sin, window folded
  const void* widft;   // [2 F1, n_fft] io: inverse DFT, window / 1.5 folded
  const float* sel_mag;  // [F, U + 1]
  const float* sel_fb;   // [Pfb, U + 1]
  const void* fb_wa;     // [Fin, Gf] io
  const float* fb_uv;    // [2, Gf] ("ln")
  const void* fb_wihr;   // [max(Lf - 1, 1), Hf, Gf] io
  const void* fb_whh;    // [Lf, Hf, Gf] io
  const float* fb_coef;  // [Lf, 4, Hf]
  const void* fb_wproj;  // [Hf, Pfb] io
  const float* fb_bproj; // [Pfb]
  // sections, flat (offsets in sec[]): wa [n, aw, G], wb [n, Pfb, G] io;
  // uv [2, G] f32; wihr, whh io; coef f32; wproj [H, P] io; bproj [P] f32
  const void* wa;
  const void* wb;
  const float* uv;
  const void* wihr;
  const void* whh;
  const float* coef;
  const void* wproj;
  const float* bproj;
  int S, B, hop, n_fft, Fin, Pfb, U, W, H, L, Hf, Lf, shared, norm, t_real, n_sec;
  float eps;
  int cluster, upc;  // blocks per cluster, units per unit block (set by the launcher)
  MonoSec sec[MAX_SEC];
};

enum { NORM_RAW = 0, NORM_LN = 1, NORM_CUM = 2 };

// Shared-memory offsets in floats. Block 0 and the unit blocks use their
// own layouts; every region is a multiple of RB floats (32 bytes).
struct Layout {
  int slots, spec, mag_io, mag32, magsq, s1m, s2m, hs_fb, cs_fb, fby, fbysq, fbio, alpha, beta,
      cum, enh, yf, cta0_end;
  int xs, ys, unit0, unit_stride, units_end;
};

__host__ __device__ inline Layout make_layout(const MonoArgs& a) {
  Layout l;
  const int F1 = a.n_fft / 2 + 1, F = F1 - 1, U1 = a.U + 1;
  int o = 0;
  l.slots = o;  o += 4 * a.hop * RB;          // chunk ring [4][hop][RB]
  l.spec = o;   o += 2 * F1 * RB;             // re | im [2 F1][RB]
  l.mag_io = o; o += F * RB;
  l.mag32 = o;  o += F * RB;
  l.magsq = o;  o += F * RB;
  l.s1m = o;    o += U1 * RB;
  l.s2m = o;    o += U1 * RB;
  l.hs_fb = o;  o += a.Lf * a.Hf * RB;        // fullband spikes [Lf][Hf][RB]
  l.cs_fb = o;  o += a.Lf * a.Hf * RB;        // fullband membranes
  l.fby = o;    o += a.Pfb * RB;
  l.fbysq = o;  o += a.Pfb * RB;
  l.fbio = o;   o += a.Pfb * RB;
  l.alpha = o;  o += U1 * RB;
  l.beta = o;   o += U1 * RB;
  l.cum = o;    o += U1 * RB;                 // running sums ("cum")
  l.enh = o;    o += 2 * F1 * RB;             // enhanced re | im, io-rounded
  l.yf = o;     o += 4 * a.n_fft * RB;        // inverse-DFT frames t..t-3
  l.cta0_end = o;
  int x_cap = 0, p_cap = 0, ring_cap = 0;
  for (int i = 0; i < a.n_sec; ++i) {
    const MonoSec& s = a.sec[i];
    x_cap = x_cap > s.aw + a.Pfb ? x_cap : s.aw + a.Pfb;
    p_cap = p_cap > s.P ? p_cap : s.P;
    ring_cap = ring_cap > s.df * s.ctr ? ring_cap : s.df * s.ctr;
  }
  o = 0;
  l.xs = o; o += x_cap * RB;                  // a unit's inputs [aw + Pfb][RB]
  l.ys = o; o += p_cap * RB;                  // its projection [RB][P]
  l.unit0 = o;
  // per unit: spikes [L][H][RB], membranes [L][H][RB], ring re | im [2][df][ctr][RB]
  l.unit_stride = 2 * a.L * a.H * RB + 2 * ring_cap * RB;
  o += a.upc * l.unit_stride;
  l.units_end = o;
  return l;
}

template <typename IO> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Block 0, first half of step t: chunk t + 3 in, DFT, magnitude,
// statistics, fullband stack and projection, unit scales.
template <typename IO, int LF>
__device__ void front_step(const MonoArgs& a, const Layout& lo, float* sm, int t, int row0) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int hop = a.hop, F1 = a.n_fft / 2 + 1, F = F1 - 1, U = a.U, U1 = U + 1;
  const IO* chunks = static_cast<const IO*>(a.chunks);
  {
    float* slot = sm + lo.slots + ((t + 3) & 3) * hop * RB;
    for (int idx = tid; idx < RB * hop; idx += nth) {
      const int r = idx / hop, i = idx % hop, b = row0 + r;
      slot[i * RB + r] = b < a.B ? ld(chunks + ((size_t)(t + 3) * a.B + b) * hop + i) : 0.f;
    }
  }
  __syncthreads();

  // ---- DFT over the four chunks of the frame, magnitude ----
  const IO* wdft = static_cast<const IO*>(a.wdft);
  for (int k = tid; k < F1; k += nth) {
    float re[RB], im[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) re[r] = im[r] = 0.f;
    for (int q = 0; q < 4; ++q) {
      float pr[RB], pi[RB];
      dot_rows(sm + lo.slots + ((t + q) & 3) * hop * RB, hop, wdft + (size_t)q * hop * 2 * F1,
               2 * F1, k, F1 + k, pr, pi);
#pragma unroll
      for (int r = 0; r < RB; ++r) { re[r] += pr[r]; im[r] += pi[r]; }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      sm[lo.spec + k * RB + r] = re[r];
      sm[lo.spec + (F1 + k) * RB + r] = im[r];
      if (k < F) {
        const float m = sqrtf(sqrtf(re[r] * re[r] + im[r] * im[r]));
        sm[lo.mag32 + k * RB + r] = m;
        sm[lo.magsq + k * RB + r] = m * m;
        sm[lo.mag_io + k * RB + r] = rnd<IO>(m);
      }
      if (k >= a.W) {  // the Nyquist bin passes through
        sm[lo.enh + k * RB + r] = rnd<IO>(re[r]);
        sm[lo.enh + (F1 + k) * RB + r] = rnd<IO>(im[r]);
      }
    }
  }
  __syncthreads();

  // ---- statistics of the magnitude (s2 only for "ln") ----
  if (a.norm != NORM_RAW) {
    const int nst = a.norm == NORM_LN ? 2 * U1 : U1;
    for (int idx = tid; idx < nst; idx += nth) {
      const int c = idx % U1;
      const bool sq = idx >= U1;
      float s[RB], unused[RB];
      dot_rows(sm + (sq ? lo.magsq : lo.mag32), F, a.sel_mag, U1, c, -1, s, unused);
#pragma unroll
      for (int r = 0; r < RB; ++r) sm[(sq ? lo.s2m : lo.s1m) + c * RB + r] = s[r];
    }
    __syncthreads();
  }

  // ---- fullband: layer-0 gates, the stack, the projection ----
  const int Hf = a.Hf, Gf = a.shared ? Hf : 2 * Hf;
  const int j = tid;
  const bool act = j < Hf;
  const int j2 = a.shared ? -1 : Hf + j;
  const float inv_t = 1.f / (float)(t + 1);
  float px[RB], pxc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) px[r] = pxc[r] = 0.f;
  if (act) {
    dot_rows(sm + lo.mag_io, a.Fin, static_cast<const IO*>(a.fb_wa), Gf, j, j2, px, pxc);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (a.norm == NORM_LN) {
        const float mu = sm[lo.s1m + U * RB + r];
        const float rstd = 1.f / sqrtf((sm[lo.s2m + U * RB + r] - mu * mu) + LN_EPS);
        px[r] = rstd * px[r] - (rstd * mu) * a.fb_uv[j] + a.fb_uv[Gf + j];
        if (!a.shared)
          pxc[r] = rstd * pxc[r] - (rstd * mu) * a.fb_uv[Hf + j] + a.fb_uv[Gf + Hf + j];
      } else if (a.norm == NORM_CUM) {
        const float d = (sm[lo.cum + U * RB + r] + sm[lo.s1m + U * RB + r]) * inv_t + a.eps;
        px[r] = px[r] / d;
        pxc[r] = pxc[r] / d;
      }
    }
  }
  {
    float cf[LF][4];
    load_coef<LF>(a.fb_coef, Hf, j, act, cf);
    float c[LF][RB];
#pragma unroll
    for (int k = 0; k < LF; ++k)
#pragma unroll
      for (int r = 0; r < RB; ++r) c[k][r] = act ? sm[lo.cs_fb + (k * Hf + j) * RB + r] : 0.f;
    stack_step<LF>(sm + lo.hs_fb, Hf, Gf, a.shared != 0, j, act,
                   static_cast<const IO*>(a.fb_wihr), static_cast<const IO*>(a.fb_whh), cf, c,
                   px, pxc, [](int, int, float) {});
    if (act)
#pragma unroll
      for (int k = 0; k < LF; ++k)
#pragma unroll
        for (int r = 0; r < RB; ++r) sm[lo.cs_fb + (k * Hf + j) * RB + r] = c[k][r];
  }
  const IO* fb_wproj = static_cast<const IO*>(a.fb_wproj);
  for (int p = tid; p < a.Pfb; p += nth) {
    float y[RB], unused[RB];
    dot_rows(sm + lo.hs_fb + (LF - 1) * Hf * RB, Hf, fb_wproj, a.Pfb, p, -1, y, unused);
    const float bp = a.fb_bproj[p];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float v = y[r] + bp;
      sm[lo.fby + p * RB + r] = v;
      sm[lo.fbysq + p * RB + r] = v * v;
      sm[lo.fbio + p * RB + r] = rnd<IO>(v);
    }
  }
  __syncthreads();

  // ---- unit scales: complete the statistics with the fullband part ----
  if (a.norm != NORM_RAW) {
    for (int c = tid; c < U1; c += nth) {
      float s1f[RB], s2f[RB], unused[RB];
      dot_rows(sm + lo.fby, a.Pfb, a.sel_fb, U1, c, -1, s1f, unused);
      if (a.norm == NORM_LN) {
        dot_rows(sm + lo.fbysq, a.Pfb, a.sel_fb, U1, c, -1, s2f, unused);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float mu = sm[lo.s1m + c * RB + r] + s1f[r];
          const float var = (sm[lo.s2m + c * RB + r] + s2f[r]) - mu * mu;
          const float rstd = 1.f / sqrtf(var + LN_EPS);
          sm[lo.alpha + c * RB + r] = rstd;
          sm[lo.beta + c * RB + r] = rstd * mu;
        }
      } else {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float cs = (sm[lo.cum + c * RB + r] + sm[lo.s1m + c * RB + r]) + s1f[r];
          sm[lo.cum + c * RB + r] = cs;
          sm[lo.alpha + c * RB + r] = 1.f / (cs * inv_t + a.eps);
        }
      }
    }
  }
}

// A unit block's step t: each of its units reads block 0's published
// values (s0, distributed shared memory), runs its gates, stack, projection
// and deep filter, and writes its enhanced bins into block 0.
template <typename IO, int L>
__device__ void unit_step(const MonoArgs& a, const Layout& lo, float* sm, float* s0, int t,
                          int rank) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int F1 = a.n_fft / 2 + 1, H = a.H, G = a.shared ? H : 2 * H, Pfb = a.Pfb;
  const int j = tid;
  const bool act = j < H;
  const int j2 = a.shared ? -1 : H + j;
  float* xs = sm + lo.xs;
  float* ys = sm + lo.ys;
  for (int q = 0; q < a.upc; ++q) {
    const int u = (rank - 1) + q * (a.cluster - 1);
    if (u >= a.U) break;
    int si = 0;
    while (si + 1 < a.n_sec && a.sec[si + 1].u0 <= u) ++si;
    const MonoSec sec = a.sec[si];
    const int jj = u - sec.u0, aw = sec.aw, ctr = sec.ctr, df = sec.df, P = sec.P;
    float* hs = sm + lo.unit0 + q * lo.unit_stride;
    float* cs = hs + L * H * RB;
    float* ring = cs + L * H * RB;  // [2][df][ctr][RB]

    // ---- stage: the magnitude window, the fullband output, frame t's bins ----
    for (int i = tid; i < aw * RB; i += nth) xs[i] = s0[lo.mag_io + sec.a0 * RB + i];
    for (int i = tid; i < Pfb * RB; i += nth) xs[aw * RB + i] = s0[lo.fbio + i];
    const int col0 = sec.f0 + jj * ctr;
    const int slot = t % df;
    for (int i = tid; i < ctr * RB; i += nth) {
      ring[slot * ctr * RB + i] = s0[lo.spec + col0 * RB + i];
      ring[(df + slot) * ctr * RB + i] = s0[lo.spec + (F1 + col0) * RB + i];
    }
    float al[RB], be[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      al[r] = a.norm != NORM_RAW ? s0[lo.alpha + u * RB + r] : 1.f;
      be[r] = a.norm == NORM_LN ? s0[lo.beta + u * RB + r] : 0.f;
    }
    __syncthreads();

    // ---- layer-0 gates of this unit ----
    float px[RB], pxc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) px[r] = pxc[r] = 0.f;
    if (act) {
      const IO* wa = static_cast<const IO*>(a.wa) + sec.wa + (size_t)jj * aw * G;
      const IO* wb = static_cast<const IO*>(a.wb) + sec.wb + (size_t)jj * Pfb * G;
      const float* uv = a.uv + sec.uv;
      float qa[RB], qac[RB], qb[RB], qbc[RB];
      dot_rows(xs, aw, wa, G, j, j2, qa, qac);
      dot_rows(xs + aw * RB, Pfb, wb, G, j, j2, qb, qbc);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float ck = qa[r] + qb[r], ckc = qac[r] + qbc[r];
        if (a.norm == NORM_RAW) {
          px[r] = ck;
          pxc[r] = ckc;
        } else {
          px[r] = al[r] * ck;
          pxc[r] = al[r] * ckc;
          if (a.norm == NORM_LN) {
            px[r] = px[r] - be[r] * uv[j] + uv[G + j];
            if (!a.shared) pxc[r] = pxc[r] - be[r] * uv[H + j] + uv[G + H + j];
          }
        }
      }
    }

    // ---- the unit's stack ----
    float cf[L][4];
    load_coef<L>(a.coef + sec.coef, H, j, act, cf);
    float c[L][RB];
#pragma unroll
    for (int k = 0; k < L; ++k)
#pragma unroll
      for (int r = 0; r < RB; ++r) c[k][r] = act ? cs[(k * H + j) * RB + r] : 0.f;
    stack_step<L>(hs, H, G, a.shared != 0, j, act, static_cast<const IO*>(a.wihr) + sec.wihr,
                  static_cast<const IO*>(a.whh) + sec.whh, cf, c, px, pxc,
                  [](int, int, float) {});
    if (act)
#pragma unroll
      for (int k = 0; k < L; ++k)
#pragma unroll
        for (int r = 0; r < RB; ++r) cs[(k * H + j) * RB + r] = c[k][r];

    // ---- projection y = h_L @ Wproj + bproj ----
    const IO* wproj = static_cast<const IO*>(a.wproj) + sec.wproj;
    const float* bproj = a.bproj + sec.bproj;
    for (int p = tid; p < P; p += nth) {
      float y[RB], unused[RB];
      dot_rows(hs + (L - 1) * H * RB, H, wproj, P, p, -1, y, unused);
#pragma unroll
      for (int r = 0; r < RB; ++r) ys[r * P + p] = y[r] + bproj[p];
    }
    __syncthreads();

    // ---- deep filter into block 0's enhanced spectrum ----
    for (int idx = tid; idx < RB * ctr; idx += nth) {
      const int r = idx / ctr, f = idx % ctr;
      const float* y = ys + r * P;
      float er = 0.f, ei = 0.f;
      for (int d = 0; d < df; ++d) {
        const int tt = t - (df - 1 - d);  // the oldest frame pairs with tap 0
        if (tt < 0) continue;
        const int sl = tt % df;
        const float tr = ring[(sl * ctr + f) * RB + r];
        const float tm = ring[((df + sl) * ctr + f) * RB + r];
        const float cr = y[d * ctr + f], ci = y[(df + d) * ctr + f];
        er += tr * cr - tm * ci;
        ei += tr * ci + tm * cr;
      }
      s0[lo.enh + (col0 + f) * RB + r] = rnd<IO>(er);
      s0[lo.enh + (F1 + col0 + f) * RB + r] = rnd<IO>(ei);
    }
    // xs and ys are rewritten only after the next unit's barriers
  }
}

// Block 0, second half of step t: inverse DFT, overlap-add, hop chunk out.
template <typename IO>
__device__ void back_step(const MonoArgs& a, const Layout& lo, float* sm, int t, int row0) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int hop = a.hop, n_fft = a.n_fft, half = n_fft / 2, F1 = half + 1;
  float* yf = sm + lo.yf + (t & 3) * n_fft * RB;
  if (t < a.t_real) {
    const IO* widft = static_cast<const IO*>(a.widft);
    for (int s = tid; s < half; s += nth) {
      float y1[RB], y2[RB];
      dot_rows(sm + lo.enh, 2 * F1, widft, n_fft, s, s + half, y1, y2);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        yf[s * RB + r] = y1[r];
        yf[(s + half) * RB + r] = y2[r];
      }
    }
  } else {  // frames past the natural count leave the overlap-add
    for (int i = tid; i < n_fft * RB; i += nth) yf[i] = 0.f;
  }
  __syncthreads();
  const float* f1 = sm + lo.yf + ((t + 3) & 3) * n_fft * RB;  // frame t - 1
  const float* f2 = sm + lo.yf + ((t + 2) & 3) * n_fft * RB;  // frame t - 2
  const float* f3 = sm + lo.yf + ((t + 1) & 3) * n_fft * RB;  // frame t - 3
  for (int idx = tid; idx < RB * hop; idx += nth) {
    const int r = idx / hop, i = idx % hop, b = row0 + r;
    if (b >= a.B) continue;
    a.out[((size_t)t * a.B + b) * hop + i] = yf[i * RB + r] + f1[(hop + i) * RB + r] +
                                             f2[(2 * hop + i) * RB + r] +
                                             f3[(3 * hop + i) * RB + r];
  }
}

template <typename IO, int L, int LF>
__global__ void __launch_bounds__(512) monolith_kernel(const MonoArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / a.cluster) * RB;
  const Layout lo = make_layout(a);
  float* s0 = cluster.map_shared_rank(sm, 0);  // block 0's shared memory

  const int total = rank == 0 ? lo.cta0_end : lo.units_end;
  for (int i = threadIdx.x; i < total; i += blockDim.x) sm[i] = 0.f;
  if (rank == 0) {  // chunks 0..2 fill the ring
    const IO* chunks = static_cast<const IO*>(a.chunks);
    for (int idx = threadIdx.x; idx < 3 * RB * a.hop; idx += blockDim.x) {
      const int c = idx / (RB * a.hop), rem = idx % (RB * a.hop);
      const int r = rem / a.hop, i = rem % a.hop, b = row0 + r;
      sm[lo.slots + (c * a.hop + i) * RB + r] =
          b < a.B ? ld(chunks + ((size_t)c * a.B + b) * a.hop + i) : 0.f;
    }
  }
  cluster.sync();
  for (int t = 0; t < a.S; ++t) {
    if (rank == 0) front_step<IO, LF>(a, lo, sm, t, row0);
    cluster.sync();  // block 0's values are published
    if (rank > 0) unit_step<IO, L>(a, lo, sm, s0, t, rank);
    cluster.sync();  // every unit's enhanced bins are in block 0
    if (rank == 0) back_step<IO>(a, lo, sm, t, row0);
  }
}

template <typename IO, int L, int LF>
static int launch_typed(const MonoArgs& a, cudaStream_t stream) {
  auto kern = monolith_kernel<IO, L, LF>;
  const Layout lo = make_layout(a);
  const int words = lo.cta0_end > lo.units_end ? lo.cta0_end : lo.units_end;
  const size_t smem = (size_t)words * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int widest = a.H > a.Hf ? a.H : a.Hf;
  widest = widest > 128 ? widest : 128;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((a.B + RB - 1) / RB) * a.cluster));
  cfg.blockDim = dim3((unsigned)((widest + 31) / 32 * 32));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  MonoArgs arg = a;
  void* params[] = {&arg};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern), params);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename IO, int L>
static int launch_lf(const MonoArgs& a, cudaStream_t s) {
  switch (a.Lf) {
    case 1: return launch_typed<IO, L, 1>(a, s);
    case 2: return launch_typed<IO, L, 2>(a, s);
    case 3: return launch_typed<IO, L, 3>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One library per stream type and sub-band depth (MONO_BF16, MONO_L given
// by the build), so that the builds of the nine (L, Lf) instances run in
// parallel processes.
#if !defined(MONO_BF16) || !defined(MONO_L)
#error "build with -DMONO_BF16=0|1 -DMONO_L=1|2|3"
#endif
#if MONO_BF16
using MonoIO = __nv_bfloat16;
#else
using MonoIO = float;
#endif

extern "C" {

// args: the streams, weights and sizes (see MonoArgs); the launcher sets
// the cluster size (min(8, U + 1)) and the units per unit block. Returns
// the CUDA error code of the launch (0 on success).
int sfsb_monolith_launch(int io_bf16, const MonoArgs* args, void* stream) {
  MonoArgs a = *args;
  if (io_bf16 != MONO_BF16 || a.L != MONO_L || a.n_sec < 1 || a.n_sec > MAX_SEC || a.H < 1 ||
      a.H > 512 || a.Hf < 1 || a.Hf > 512 || a.B < 1 || a.S < 1 || a.U < 1 ||
      a.n_fft != 4 * a.hop || a.norm < 0 || a.norm > 2)
    return (int)cudaErrorInvalidValue;
  a.cluster = a.U + 1 < MAX_CLUSTER ? a.U + 1 : MAX_CLUSTER;
  a.upc = (a.U + a.cluster - 2) / (a.cluster - 1);
  return launch_lf<MonoIO, MONO_L>(a, static_cast<cudaStream_t>(stream));
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
