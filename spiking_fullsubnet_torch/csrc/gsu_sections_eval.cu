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
//         section's pre-LN fold "uv": "ln", gsu_pallas.py:1218-1224)
//   L GSU layers (as kernel A), y = h_L @ Wproj + bproj        [P = 2 df ctr]
//   df_mode: enh[t, b, f0 + jj ctr + f] = sum_d X[t - (df-1-d)] * (y_re[d] + i y_im[d])
//   else:    proj[jj, t, b, :] = y in the stream type (gsu_pallas.py:1296-1301)
// where X is the noisy spectrum (zero before the first frame): the oldest
// frame pairs with tap 0, as the reference's time unfold. The coefficient
// columns come in (c, d, fc) order (the caller permutes the projection).
// Streams and weights are f32 or bf16; sums, membranes, the unit scales and
// the deep filter are f32; expf is the precise one.
//
// What bounds it on an H100: at the zoo-M bench shape (batch 256, T = 3751,
// 13 units of 2 x 224 in three sections, layer-0 weights one-hot scattered
// over each unit's window) the streams are about 4 GB (xa, xb, the spectrum
// in and the enhanced spectrum out; a per-frame alpha and beta add 2 x 4
// bytes a (t, b, u)) and the operations a few TFLOP once the spike products
// count only the fired spikes: a few milliseconds at the card's peaks. What
// limits it is the chain of T dependent steps, each a sequence of dependent
// products whose weights (a section's stack and projection, about 0.3 MB in
// bf16, plus each unit's layer-0 matrix) are read from L2 at every step.
// PR 1's design (a block a unit and 8 rows, a thread a hidden unit) waited
// on one L2 round trip a weight, then on a projection over P threads and a
// deep filter that read its spectrum frames from device memory.
//
// Design: kernel C's unit stage standing alone (gsu_eval_mma.cuh is the
// engine, shared with kernel F; the host's plan, ops/gsu_kernels.
// sections_plan, sets every size and shared-memory offset):
//   - A block owns one section's nb units times a tile of rt rows (8, 16 or
//     32; at most 64 columns, unit-major). A block's time grows faster than
//     its columns, so the plan gives every block about as many, the fewest
//     that fit two waves, each section taking the (rt, nb) with the fewest
//     blocks (zoo M at 256 rows: 208 blocks of 16 rows of one unit; one
//     wave of 32-row blocks measured 259 ms against 182). One fetch of the
//     section's stack and projection weights serves all of the block's
//     columns; each unit's own layer-0 matrix multiplies the rows' shared
//     input window.
//   - Every product on the tensor cores (bf16; float32 on the CUDA cores in
//     k order), weights packed in fragment order (sections_pack), streamed
//     from L2 with two batches of tiles in flight a warp; spikes as dense
//     bf16 rows in shared memory (one ldmatrix gives a warp two n-groups'
//     fragments); the projection H -> P is one more product into shared
//     memory.
//   - Step t + 1's inputs (the rows' windows of xa and xb, the per-frame
//     alpha and beta, the block's bins of the noisy spectrum) are asked for
//     at the start of step t, held in registers and stored after layer 0's
//     products; the deep filter reads its df past frames from a ring of
//     df + 2 spectrum frames in shared memory.
//   - The enhanced bins of a row are contiguous (units x centre bins), so
//     the deep filter's outputs are written in whole runs; rows past B are
//     masked and never written.
// Barriers: L + 1 a step (one after each layer, one after the projection).
// A column's arithmetic does not depend on the tile or the plan and nothing
// is summed across threads: two launches are bitwise equal.
#include "gsu_eval_mma.cuh"

using namespace gev;

constexpr int MAX_SEC = 8;
constexpr int MAX_L = 4;
constexpr int MAX_GROUPS = 128;

// Mirrored by _SecArgsC in ops/gsu_kernels.py (same field order). The
// offsets o_* are bytes into the block's shared memory, sized for the
// section's largest unit group nbm: the input tiles io [2][rt][ld_in] (the
// window's aw values, padded to 16, then xb's Fb, padded to 16), the unit
// scales f32 [2 steps][alpha | beta][nbm rt], the spectrum ring f32 [dr]
// [re | im][rt][nbm ctr], the spikes bf16 [2 parities][L][N][Hp + 8], the
// membranes f32 [L][N][Hp + 4], the projection f32 [N][P]; N = nbm rt.
struct SecArgs {
  int n, a0, aw, ctr, df, P, u0, f0, ln, awp, ld_in, dr, nbm, rt, tiles;
  int o_sc, o_sp, o_spk, o_mem, o_ys;
  Mat rec[MAX_L], proj, win;  // win: unit 0's layer-0 matrix; unit jj's at + jj win_size
  long long win_size, coef, bproj, uv, oproj;  // element offsets (f32 arrays; out_proj)
};

// Mirrored by _SectionsArgs.
struct SectionsArgs {
  const void* xa;  // [T, B, Fa] io
  const void* xb;  // [T, B, Fb] io
  const float* alpha;  // [B, U] (alpha_mode 1) or [T, B, U] (2)
  const float* beta;   // [T, B, U] (sections with ln)
  const float* spec_re;  // [T, B, Fs] (df_mode)
  const float* spec_im;
  const void* w;      // packed weights (io)
  const float* coef;  // sections' f32 arrays, flat
  const float* bproj;
  const float* uv;
  float* out_re;  // [T, B, W] (df_mode)
  float* out_im;
  void* out_proj;  // each section's [n, T, B, P] io (no df_mode)
  unsigned long long* prof;  // optional [blocks][8] clock64 cycles a phase (null: off)
  int T, B, Fa, Fb, Fs, U, W, H, L, shared, alpha_mode, df_mode;
  int blocks, Hp, n_sec, n_groups, smem;
  SecArgs sec[MAX_SEC];
  int grp[MAX_GROUPS][4];  // (section, first unit, units, first block) of each unit group
};

template <typename IO, int NG>
__device__ void sections_block(const SectionsArgs& a, char* sm, int g, int tile) {
  constexpr int PF = NG <= 4 ? 8 : 4;  // the fewer accumulators, the more loads in flight
  const SecArgs& s = a.sec[a.grp[g][0]];
  const int jj0 = a.grp[g][1], nb = a.grp[g][2];
  const int rt = s.rt, row0 = tile * rt, N = nb * rt, ng = N / 8, gpu = rt / 8;
  const int H = a.H, Hp = a.Hp, sst = spk_stride(Hp), ms = mem_stride(Hp);
  const int L = a.L, T = a.T, B = a.B, U = a.U;
  const int shared = a.shared, G = shared ? H : 2 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int Nm = s.nbm * rt, nbin = nb * s.ctr, nbinm = s.nbm * s.ctr;
  const int aw = s.aw, nin = aw + a.Fb, ld_in = s.ld_in, dr = s.dr, P = s.P;
  const int mts = gate_mtiles(H, shared);
  const bool ln = s.ln != 0 && a.alpha_mode == 2;
  const IO* xa = static_cast<const IO*>(a.xa);
  const IO* xb = static_cast<const IO*>(a.xb);
  const IO* w = static_cast<const IO*>(a.w);
  IO* xin = at<IO>(sm, 0);
  float* sc = at<float>(sm, s.o_sc);
  float* sp = at<float>(sm, s.o_sp);
  Spk* spk0 = at<Spk>(sm, s.o_spk);
  float* mem = at<float>(sm, s.o_mem);
  float* ys = at<float>(sm, s.o_ys);
  const float* uv = a.uv + s.uv;
  const float* coef = a.coef + s.coef;
  const float* bproj = a.bproj + s.bproj;
  const int ua = s.u0 + jj0;  // the block's first unit over all sections

  // step tt's staged items, in this order: the rows' input windows (rt x
  // nin), the per-frame scales (alpha, then beta: 2 x N), the spectrum bins
  // (re, then im: 2 x rt x nbin); rows past B read as zeros
  const int n_win = rt * nin;
  const int n_sc = a.alpha_mode == 2 ? (ln ? 2 : 1) * N : 0;
  const int n_sp = a.df_mode ? 2 * rt * nbin : 0;
  const int n_items = n_win + n_sc + n_sp;
  // (scalars and pointers copied out of the arguments, so that the
  // lambdas hold registers)
  const int a0 = s.a0, awp = s.awp, Fa = a.Fa, Fb = a.Fb, Fs = a.Fs;
  const int bin0 = s.f0 + jj0 * s.ctr;
  const FastDiv d_nin(nin), d_N(N), d_sp(rt * nbin), d_bin(nbin), d_rt(rt);
  const float* alpha = a.alpha;
  const float* beta = a.beta;
  const float* spec_re = a.spec_re;
  const float* spec_im = a.spec_im;
  auto get = [=](int tt) {
    return [=](int i) -> float {
      if (i < n_win) {
        const int r = d_nin.div(i), p = i - r * nin, b = row0 + r;
        if (b >= B) return 0.f;
        return p < aw ? ld(xa + ((size_t)tt * B + b) * Fa + a0 + p)
                      : ld(xb + ((size_t)tt * B + b) * Fb + (p - aw));
      }
      i -= n_win;
      if (i < n_sc) {
        const int which = d_N.div(i), n = i - which * N, q = d_rt.div(n), b = row0 + n - q * rt;
        if (b >= B) return 0.f;
        return (which ? beta : alpha)[((size_t)tt * B + b) * U + ua + q];
      }
      i -= n_sc;
      const int ri = d_sp.div(i), rem = i - ri * rt * nbin, r = d_bin.div(rem), c = rem - r * nbin;
      const int b = row0 + r;
      if (b >= B) return 0.f;
      return (ri ? spec_im : spec_re)[((size_t)tt * B + b) * Fs + bin0 + c];
    };
  };
  auto set = [=](int tt) {
    return [=](int i, float v) {
      if (i < n_win) {
        const int r = d_nin.div(i), p = i - r * nin;
        xin[(size_t)(tt & 1) * rt * ld_in + (size_t)r * ld_in + (p < aw ? p : awp + p - aw)] = IO(v);
        return;
      }
      i -= n_win;
      if (i < n_sc) {
        const int which = d_N.div(i), n = i - which * N;
        sc[((tt & 1) * 2 + which) * Nm + n] = v;
        return;
      }
      i -= n_sc;
      const int ri = d_sp.div(i), rem = i - ri * rt * nbin, r = d_bin.div(rem), c = rem - r * nbin;
      sp[((size_t)((tt % dr) * 2 + ri) * rt + r) * nbinm + c] = v;
    };
  };
  if (a.alpha_mode == 1)  // one scale per utterance and unit, in slot 0 for every step
    for (int n = tid; n < N; n += NTHREADS) {
      const int q = n / rt, b = row0 + n - q * rt;
      sc[n] = b < B ? alpha[(size_t)b * U + ua + q] : 0.f;
    }
  {
    auto g0 = get(0);
    auto s0 = set(0);
    for (int i = tid; i < n_items; i += NTHREADS) s0(i, g0(i));
  }
  __syncthreads();
  prof_begin(a.prof);
  Staged st;

  for (int t = 0; t < T; ++t) {
    Spk* nspk = spk0 + (size_t)(t & 1) * L * N * sst;
    const Spk* ospk = spk0 + (size_t)((t + 1) & 1) * L * N * sst;
    if (t + 1 < T) st.load(n_items, get(t + 1));
    mark(a.prof, 2);
    const float* al = sc + (a.alpha_mode == 2 ? (t & 1) * 2 * Nm : 0);
    const float* be = al + Nm;
    for (int k = 0; k < L; ++k) {
      Spk* dst = nspk + (size_t)k * N * sst;
      auto put = [&](int n, int j, float v) { dst[n * sst + j] = __float2bfloat16(v); };
      const float* ck = coef + (size_t)k * 4 * H;
      float* memk = mem + (size_t)k * N * ms;
      for (int mt = warp; mt < mts; mt += NWARPS) {
        float acc[NG][4];
        zero_acc(acc);
        if (k == 0) {
          // each unit's own matrix over the rows' window, then the scales
          const GemmArgs gw{s.win.off + (long long)jj0 * s.win_size, s.win_size, s.win.kt, mt, nb,
                            gpu};
          const IO* xk = xin + (size_t)(t & 1) * rt * ld_in;  // the window, then xb at awp
          gemm_tile<NG, PF>(acc, w, gw, XDense<IO>{xk, xk + awp, ld_in, awp / 16});
          if (a.alpha_mode != 0) {
            // accumulator rows gid and gid + 8: two gate columns (shared:
            // two units; unshared: one unit's f and c), their pre-LN terms
            float u[2] = {0.f, 0.f}, v[2] = {0.f, 0.f};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = gate_unit(mt, gid, 2 * h, shared);
              const int col = (!shared && h) ? H + j : j;
              if (ln && j < H) {
                u[h] = uv[col];
                v[h] = uv[G + col];
              }
            }
#pragma unroll
            for (int i = 0; i < NG; ++i) {
              if (i >= ng) continue;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int n = i * 8 + 2 * tig + (e & 1);
                acc[i][e] = al[n] * acc[i][e];
                if (ln) acc[i][e] = acc[i][e] - be[n] * u[e >> 1] + v[e >> 1];
              }
            }
          }
          gemm_tile<NG, PF>(acc, w, one(s.rec[0], mt, ng), XDense<Spk>{ospk, ospk, sst, 1 << 30});
        } else {
          const XDense<Spk> xs{nspk + (size_t)(k - 1) * N * sst, ospk + (size_t)k * N * sst, sst,
                               Hp / 16};
          gemm_tile<NG, PF>(acc, w, one(s.rec[k], mt, ng), xs);
        }
        mark(a.prof, 0);
        cell_tile(acc, mt, ng, H, ms, shared, ck, memk, put);
        mark(a.prof, 1);
      }
      if (k == 0 && t + 1 < T) st.store(n_items, get(t + 1), set(t + 1));
      __syncthreads();
      mark(a.prof, 2);
    }

    // the projection y = h_L @ Wproj + bproj into ys [N][P]
    const Spk* hl = nspk + (size_t)(L - 1) * N * sst;
    const XDense<Spk> xs_p{hl, hl, sst, 1 << 30};
    for (int mt = warp; mt < s.proj.mt; mt += NWARPS) {
      float acc[NG][4];
      zero_acc(acc);
      gemm_tile<NG, PF>(acc, w, one(s.proj, mt, ng), xs_p);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        if (i >= ng) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = mt * 16 + gid + 8 * (e >> 1), n = i * 8 + 2 * tig + (e & 1);
          if (p < P) ys[(size_t)n * P + p] = acc[i][e] + bproj[p];
        }
      }
    }
    mark(a.prof, 0);
    __syncthreads();
    mark(a.prof, 2);

    if (a.df_mode) {
      // deep filter against the last df frames of the ring: item (row r,
      // bin c of the block's nb ctr), so a row's outputs are one run
      const int ctr = s.ctr, df = s.df;
      const FastDiv d_ctr(ctr);
      for (int i = tid; i < rt * nbin; i += NTHREADS) {
        const int r = d_bin.div(i), c = i - r * nbin, b = row0 + r;
        if (b >= B) continue;
        const int q = d_ctr.div(c), f = c - q * ctr;
        const float* y = ys + (size_t)(q * rt + r) * P;
        float er = 0.f, ei = 0.f;
        for (int d = 0; d < df; ++d) {
          const int tt = t - (df - 1 - d);  // the oldest frame pairs with tap 0
          if (tt < 0) continue;
          const float* fr = sp + (size_t)((tt % dr) * 2) * rt * nbinm + (size_t)r * nbinm + c;
          const float tr = fr[0], tm = fr[(size_t)rt * nbinm];
          const float cr = y[d * ctr + f], ci = y[(df + d) * ctr + f];
          er += tr * cr - tm * ci;
          ei += tr * ci + tm * cr;
        }
        const size_t o = ((size_t)t * B + b) * a.W + s.f0 + jj0 * ctr + c;
        a.out_re[o] = er;
        a.out_im[o] = ei;
      }
    } else {
      // the projection out: item (unit q, row r, column p)
      IO* op = static_cast<IO*>(a.out_proj) + s.oproj;
      const FastDiv d_p(P);
      for (int i = tid; i < N * P; i += NTHREADS) {
        const int n = d_p.div(i), p = i - n * P, q = d_rt.div(n), b = row0 + n - q * rt;
        if (b >= B) continue;
        op[(((size_t)(jj0 + q) * T + t) * B + b) * P + p] = IO(ys[i]);
      }
    }
    mark(a.prof, 3);
    // ys and the rings are rewritten only after the next step's first barrier
  }
  prof_end(a.prof);
}

template <typename IO>
__global__ void __launch_bounds__(NTHREADS, 1) sections_kernel(const __grid_constant__ SectionsArgs a) {
  extern __shared__ float4 smem4[];
  int g = 0;  // the block's unit group, and its row tile in the group
  while (g + 1 < a.n_groups && a.grp[g + 1][3] <= (int)blockIdx.x) ++g;
  const int tile = (int)blockIdx.x - a.grp[g][3];
  for (int i = threadIdx.x; i < a.smem / 16; i += NTHREADS) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  char* sm = reinterpret_cast<char*>(smem4);
  const int ng = a.grp[g][2] * a.sec[a.grp[g][0]].rt / 8;
  if (ng <= 2) sections_block<IO, 2>(a, sm, g, tile);
  else if (ng <= 4) sections_block<IO, 4>(a, sm, g, tile);
  else sections_block<IO, 8>(a, sm, g, tile);
}

template <typename IO>
static int launch_typed(const SectionsArgs& a, cudaStream_t stream) {
  auto kern = sections_kernel<IO>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<a.blocks, NTHREADS, a.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// args: the streams, the packed weights, the sizes and the host's plan
// (SectionsArgs). Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue for what the kernel does not take (1..8 sections,
// H 1..512, L 1..4, B >= 1, at most 128 unit groups of at most 64 columns
// with rows in tiles of 8, 16 or 32, shared memory within 232,448 bytes, the
// streams each mode reads).
int gsu_sections_eval_launch(int io_bf16, const SectionsArgs* args, void* stream) {
  const SectionsArgs& a = *args;
  if (a.n_sec < 1 || a.n_sec > MAX_SEC || a.H < 1 || a.H > 512 || a.L < 1 || a.L > MAX_L ||
      a.B < 1 || a.U < 1 || a.T < 0 || a.alpha_mode < 0 || a.alpha_mode > 2 ||
      a.n_groups < 1 || a.n_groups > MAX_GROUPS || a.smem > 232448)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.n_sec; ++i) {
    const SecArgs& s = a.sec[i];
    if ((s.ln && (a.alpha_mode != 2 || !a.beta)) || (s.rt != 8 && s.rt != 16 && s.rt != 32) ||
        s.tiles * s.rt < a.B)
      return (int)cudaErrorInvalidValue;
  }
  for (int g = 0; g < a.n_groups; ++g) {
    const int* q = a.grp[g];
    if (q[0] < 0 || q[0] >= a.n_sec || q[2] < 1 || q[2] * a.sec[q[0]].rt > 64 ||
        q[3] != (g ? a.grp[g - 1][3] + a.sec[a.grp[g - 1][0]].tiles : 0))
      return (int)cudaErrorInvalidValue;
  }
  if (a.blocks != a.grp[a.n_groups - 1][3] + a.sec[a.grp[a.n_groups - 1][0]].tiles)
    return (int)cudaErrorInvalidValue;
  if (a.alpha_mode != 0 && !a.alpha) return (int)cudaErrorInvalidValue;
  if (a.df_mode ? !(a.spec_re && a.spec_im && a.out_re && a.out_im) : !a.out_proj)
    return (int)cudaErrorInvalidValue;
  if (a.T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return io_bf16 ? launch_typed<__nv_bfloat16>(a, s) : launch_typed<float>(a, s);
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
