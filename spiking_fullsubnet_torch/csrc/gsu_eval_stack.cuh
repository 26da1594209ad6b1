// The stack kernel of A (gsu_stack_eval.cu) and F (gsu_stack_eval_x.cu) on
// the eval engine (gsu_eval_mma.cuh): a block owns N columns and runs the
// whole L-layer GSU stack over T steps. A column is one row of the stack:
// F's rows, or A's (unit, row) pairs of its units form [U, T, R, G], taken
// unit-major, so a tile may cross a unit boundary (the 3-D forms are U = 1).
// Every staged value and every output is addressed through its column's
// ((u T + t) R + r), so a column's arithmetic does not depend on its tile,
// its unit or its cluster.
//
// Layer 0's gates: F multiplies the staged features x[t] by W_ih0 on the
// tensor cores inside the block (GATES = false); A is given them (GATES =
// true): the staged input is xg0[t]'s [N, G] slice in xg0's own column order
// (the f half, then the c half when unshared), and each thread seeds its
// accumulators from it through gate_unit before it adds the recurrent
// product, as the plain version adds h W_hh to xg0. Either way step t + 1's
// input is asked for at the start of step t, in chunks of up to 16 bytes
// held in registers, and stored into the other half of a double-buffered
// tile after layer 0's products.
//
// Kernel F's traced instance (TRACE = true: a library of its own, built from
// gsu_stack_eval_x.cu with STACK_TRACE=1, which the activation tracer of
// nn/module_tracer.py launches with StackArgs.trace set) also keeps,
// per layer, the extremes of |c| over the membranes its threads update and
// counts the non-finite ones: each thread reads back the membranes it has
// just stored (same thread, same shared-memory words: no barrier), keeps
// four values a layer in registers across the steps (fminf and fmaxf skip a
// NaN, so NaNs are counted apart and never read from the extremes), and at
// the end each warp reduces them by shuffles and its lane 0 folds them into
// the block's entries of the trace buffer with 32-bit atomics (|c| >= 0, so
// a float's bits order as the float). The untraced instance compiles none of
// it.
#pragma once

#include "gsu_eval_mma.cuh"

namespace gev {

constexpr int MAX_L = 4;

// Mirrored by _StackArgs in ops/gsu_kernels.py (same field order).
struct StackArgs {
  const void* x;       // the staged input [U, T, R, W] io: F's features (U = 1), A's gates
  const void* w;       // packed weights (io): F's in, then rec[0..L-1]
  const float* coef;   // [L, 4, H] (b_f, b_c, BN scale, BN shift)
  void* out;           // [L, U, T, R, H] io with collect_all, else [U, T, R, H] (the last layer)
  unsigned long long* prof;  // optional [blocks][8] clock64 cycles a phase (null: off)
  int T, R, U, W, H, L, shared, collect_all;
  // the plan: columns a block, blocks a cluster, m-tiles a block, H padded to
  // 16, the staged tile's row length, and byte offsets of the spikes and the
  // membranes (the staged tiles at 0), the block's total
  int N, cs, mpb, Hp, ld_x, o_spk, o_mem, smem;
  Mat in, rec[MAX_L];
  // kernel F's traced instance: [blocks][L][4] words a block owns and sets up
  // itself: min |c| and max |c| (float bits), non-finite and NaN counts over
  // its columns, units and steps (null: the untraced instance)
  unsigned* trace;
};

// One layer's running trace values of a thread.
struct TraceAcc {
  float mn, mx;
  unsigned bad, nan;
};

// The traced instance's look at the membranes cell_tile has just stored:
// the same elements as cell_tile's (a thread's units and columns), columns
// past the tile (n >= cols) and pad units left out.
template <int NG>
__device__ __forceinline__ void observe_tile(TraceAcc& tr, int mt, int ng, int H, int ms,
                                             int shared, const float* mem, int cols) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && !shared) break;
    const int j = gate_unit(mt, gid, 2 * h, shared);
    if (j >= H) continue;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      if (i >= ng) continue;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int n = i * 8 + 2 * tig + e2;
        if (n >= cols) continue;
        const float c = mem[(size_t)n * ms + j], a = fabsf(c);
        tr.mn = fminf(tr.mn, a);
        tr.mx = fmaxf(tr.mx, a);
        if (!isfinite(c)) {
          ++tr.bad;
          if (isnan(c)) ++tr.nan;
        }
      }
    }
  }
}

// 8 spikes of one row (16 bytes of bf16 in shared memory) out to dst, cnt
// of them (fewer at the end of a row): one 16- or two 16-byte stores where
// dst is aligned.
template <typename IO> __device__ __forceinline__ void store8(IO* dst, const Spk* src, int cnt);
template <> __device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* dst,
                                                                  const Spk* src, int cnt) {
  if (cnt == 8 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
  for (int q = 0; q < cnt; ++q) dst[q] = src[q];
}
template <> __device__ __forceinline__ void store8<float>(float* dst, const Spk* src, int cnt) {
  if (cnt == 8 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float f[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // bf16 to float: the bits in the high half
      f[2 * q] = __uint_as_float(w[q] << 16);
      f[2 * q + 1] = __uint_as_float(w[q] & 0xFFFF0000u);
    }
    reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
    return;
  }
  for (int q = 0; q < cnt; ++q) dst[q] = __bfloat162float(src[q]);
}

// A staged chunk: up to 16 bytes of one column's consecutive values, one
// load from device memory (read-only path) and one store into shared memory.
__device__ __forceinline__ uint4 ld_chunk(const void* p, int bytes) {
  switch (bytes) {
    case 16: return __ldg(reinterpret_cast<const uint4*>(p));
    case 8: {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      return make_uint4(q.x, q.y, 0u, 0u);
    }
    case 4: return make_uint4(__ldg(reinterpret_cast<const unsigned*>(p)), 0u, 0u, 0u);
    default: return make_uint4(__ldg(reinterpret_cast<const unsigned short*>(p)), 0u, 0u, 0u);
  }
}
__device__ __forceinline__ void st_chunk(void* p, const uint4& v, int bytes) {
  switch (bytes) {
    case 16: *reinterpret_cast<uint4*>(p) = v; break;
    case 8: *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<unsigned*>(p) = v.x; break;
    default: *reinterpret_cast<unsigned short*>(p) = (unsigned short)v.x;
  }
}

// A's layer-0 gates as the accumulators' starting values: element (i, e) of
// m-tile mt (gemm_tile's layout) is column n's gate of unit gate_unit, its f
// column or, unshared and e >= 2, its c column H + j, read from the staged
// tile xk [N][ld_x]. Pad units and columns past the tile read zeros or
// values that the cell never uses.
template <int NG, typename IO>
__device__ __forceinline__ void seed_gates(float (&acc)[NG][4], const IO* xk, int ld_x, int mt,
                                           int ng, int H, int shared) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    if (i >= ng) continue;  // warp-uniform
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = i * 8 + 2 * tig + (e & 1), j = gate_unit(mt, gid, e, shared);
      acc[i][e] = ld(xk + (size_t)n * ld_x + (shared || e < 2 ? j : H + j));
    }
  }
}

template <typename IO, int NG, bool GATES, bool TRACE>
__global__ void __launch_bounds__(NTHREADS, 1) stack_kernel(const __grid_constant__ StackArgs a) {
  constexpr int PF = NG <= 4 ? 8 : 4;  // the fewer accumulators, the more loads in flight
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const int cs = a.cs, rank = (int)cl.block_rank();
  const int N = a.N, ng = N / 8, H = a.H, Hp = a.Hp, sst = spk_stride(Hp), L = a.L, W = a.W;
  const int ms = mem_stride(Hp);
  const int T = a.T, R = a.R, ld_x = a.ld_x, shared = a.shared;
  const int col0 = (int)(blockIdx.x / cs) * N, cols = min(N, a.U * R - col0);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = rank * a.mpb, m1 = min(gate_mtiles(H, shared), m0 + a.mpb);
  const IO* x = static_cast<const IO*>(a.x);
  const IO* w = static_cast<const IO*>(a.w);
  IO* out = static_cast<IO*>(a.out);
  IO* xt = at<IO>(sm, 0);  // [2][N][ld_x]
  Spk* spk0 = at<Spk>(sm, a.o_spk);            // [2 parities][L][N][sst]
  float* mem = at<float>(sm, a.o_mem);         // [L][N][ms]

  for (int i = tid; i < a.smem / 16; i += NTHREADS) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  TraceAcc trace[MAX_L];
  if constexpr (TRACE) {
    for (int k = 0; k < MAX_L; ++k) trace[k] = TraceAcc{INFINITY, 0.f, 0u, 0u};
    // the block's entries: +inf, 0, 0, 0 a layer (the barriers below order
    // these stores before any atomic of the block)
    if (tid < L * 4)
      a.trace[(size_t)blockIdx.x * L * 4 + tid] = (tid & 3) == 0 ? __float_as_uint(INFINITY) : 0u;
  }
  // column n of the tile at step tt: row ((u T + tt) R + r) of x and out
  const FastDiv d_r(R);
  auto row_of = [=](int n, int tt) {
    const int c = col0 + n, u = d_r.div(c);
    return ((size_t)u * T + tt) * R + (c - u * R);
  };
  // step tt's staged items: chunks of cw values, the widest (up to 16
  // bytes) that divides W and the input's alignment (the tile's rows, ld_x
  // elements, are whole 16-byte units); column n's chunk q at i = n wc + q.
  // Columns past the tile keep their zeros.
  int cw = 16 / (int)sizeof(IO);
  while (cw > 1 && (W % cw != 0 || reinterpret_cast<uintptr_t>(x) % (cw * sizeof(IO)) != 0))
    cw >>= 1;
  const int cb = cw * (int)sizeof(IO), wc = W / cw, nx = cols * wc;
  const FastDiv d_wc(wc);
  auto get = [&](int tt) {
    return [=](int i) {
      const int n = d_wc.div(i);
      return ld_chunk(x + row_of(n, tt) * W + (i - n * wc) * cw, cb);
    };
  };
  auto set = [&](int tt) {
    IO* dst = xt + (size_t)(tt & 1) * N * ld_x;
    return [=](int i, const uint4& v) {
      const int n = d_wc.div(i);
      st_chunk(dst + (size_t)n * ld_x + (i - n * wc) * cw, v, cb);
    };
  };
  if (T > 0) {
    auto g0 = get(0);
    auto s0 = set(0);
    __syncthreads();
    for (int i = tid; i < nx; i += NTHREADS) s0(i, g0(i));
  }
  auto barrier = [&]() {
    if (cs > 1) cl.sync();  // also makes the pushed spikes visible across the cluster
    else __syncthreads();
  };
  barrier();  // every block of the cluster zeroed before any push into it
  prof_begin(a.prof);
  StagedT<uint4, PFI / 4> st;  // 16 registers, as the engine's PFI values
  // the layers written out: every one with collect_all, else the last
  const int k0 = a.collect_all ? 0 : L - 1, hb = (H + 7) / 8, per = cols * hb;
  const int n_out = (L - k0) * per;
  const size_t out_layer = (size_t)a.U * T * R;  // rows of one layer's output
  const FastDiv d_per(per), d_hb(hb);

  for (int t = 0; t < T; ++t) {
    Spk* nspk = spk0 + (size_t)(t & 1) * L * N * sst;
    const Spk* ospk = spk0 + (size_t)((t + 1) & 1) * L * N * sst;
    if (t + 1 < T) st.load(nx, get(t + 1));
    mark(a.prof, 2);
    for (int k = 0; k < L; ++k) {
      Spk* dst = nspk + (size_t)k * N * sst;
      auto put = [&](int n, int j, float v) {
        const Spk h = __float2bfloat16(v);
        if (cs == 1) {
          dst[n * sst + j] = h;
          return;
        }
        for (int r = 0; r < cs; ++r) cl.map_shared_rank(dst, r)[n * sst + j] = h;
      };
      const float* coef = a.coef + (size_t)k * 4 * H;
      float* memk = mem + (size_t)k * N * ms;
      TraceAcc tr;
      if constexpr (TRACE) tr = trace[k];
      for (int mt = m0 + warp; mt < m1; mt += NWARPS) {
        float acc[NG][4];
        if (k == 0) {
          const IO* xk = xt + (size_t)(t & 1) * N * ld_x;
          if constexpr (GATES) {
            seed_gates(acc, xk, ld_x, mt, ng, H, shared);
          } else {
            zero_acc(acc);
            gemm_tile<NG, PF>(acc, w, one(a.in, mt, ng), XDense<IO>{xk, xk, ld_x, 1 << 30});
          }
          gemm_tile<NG, PF>(acc, w, one(a.rec[0], mt, ng), XDense<Spk>{ospk, ospk, sst, 1 << 30});
        } else {
          zero_acc(acc);
          const XDense<Spk> xs{nspk + (size_t)(k - 1) * N * sst, ospk + (size_t)k * N * sst, sst,
                               Hp / 16};
          gemm_tile<NG, PF>(acc, w, one(a.rec[k], mt, ng), xs);
        }
        mark(a.prof, 0);
        cell_tile(acc, mt, ng, H, ms, shared, coef, memk, put);
        if constexpr (TRACE) observe_tile<NG>(tr, mt, ng, H, ms, shared, memk, cols);
        mark(a.prof, 1);
      }
      if constexpr (TRACE) trace[k] = tr;
      if (k == 0 && t + 1 < T) st.store(nx, get(t + 1), set(t + 1));
      barrier();
      mark(a.prof, 2);
    }
    // the written layers' spikes of step t, 8 units a store, the blocks of a
    // cluster taking turns
    for (int i = tid + rank * NTHREADS; i < n_out; i += NTHREADS * cs) {
      const int q = d_per.div(i), rem = i - q * per, n = d_hb.div(rem), c = rem - n * hb;
      store8<IO>(out + (q * out_layer + row_of(n, t)) * H + c * 8,
                 nspk + ((size_t)(k0 + q) * N + n) * sst + c * 8, min(8, H - c * 8));
    }
    mark(a.prof, 3);
  }
  prof_end(a.prof);
  if constexpr (TRACE) {
    const int lane = tid & 31;
    unsigned* entry = a.trace + (size_t)blockIdx.x * L * 4;
    for (int k = 0; k < L; ++k) {
      TraceAcc tr = trace[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        tr.mn = fminf(tr.mn, __shfl_xor_sync(0xFFFFFFFFu, tr.mn, o));
        tr.mx = fmaxf(tr.mx, __shfl_xor_sync(0xFFFFFFFFu, tr.mx, o));
        tr.bad += __shfl_xor_sync(0xFFFFFFFFu, tr.bad, o);
        tr.nan += __shfl_xor_sync(0xFFFFFFFFu, tr.nan, o);
      }
      if (lane == 0) {
        atomicMin(entry + 4 * k, __float_as_uint(tr.mn));
        atomicMax(entry + 4 * k + 1, __float_as_uint(tr.mx));
        atomicAdd(entry + 4 * k + 2, tr.bad);
        atomicAdd(entry + 4 * k + 3, tr.nan);
      }
    }
  }
}

template <typename IO, int NG, bool GATES, bool TRACE>
static int launch_ng(const StackArgs& a, cudaStream_t stream) {
  auto kern = stack_kernel<IO, NG, GATES, TRACE>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)(((a.U * a.R + a.N - 1) / a.N) * a.cs));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = (size_t)a.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename IO, bool GATES, bool TRACE>
static int launch_io(const StackArgs& a, cudaStream_t s) {
  switch (a.N) {
    case 8: return launch_ng<IO, 1, GATES, TRACE>(a, s);
    case 16: return launch_ng<IO, 2, GATES, TRACE>(a, s);
    case 32: return launch_ng<IO, 4, GATES, TRACE>(a, s);
    default: return launch_ng<IO, 8, GATES, TRACE>(a, s);
  }
}

// cudaErrorInvalidValue for what the kernel does not take: H 1..512, L 1..4,
// W 1..1024 (A: W = G, H shared or 2H), U, R >= 1, fewer than 2^31 columns,
// the plan's tiles within 232,448 bytes; a trace buffer given to an untraced
// library or missing in a traced one (only F has a traced instance).
template <bool GATES, bool TRACE>
static int launch_stack(int io_bf16, const StackArgs& a, void* stream) {
  const bool n_ok = a.N == 8 || a.N == 16 || a.N == 32 || a.N == 64;
  const bool cs_ok = a.cs == 1 || a.cs == 2 || a.cs == 4;
  const bool w_ok = GATES ? a.W == (a.shared ? a.H : 2 * a.H) : (a.W >= 1 && a.W <= 1024);
  if (a.H < 1 || a.H > 512 || a.L < 1 || a.L > MAX_L || !w_ok || a.U < 1 || a.R < 1 ||
      (long long)a.U * a.R > 0x7FFFFFFFLL || a.T < 0 || !n_ok || !cs_ok || a.smem > 232448 ||
      a.mpb < 1 || (a.trace != nullptr) != TRACE || (GATES && TRACE))
    return (int)cudaErrorInvalidValue;
  if (a.T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return io_bf16 ? launch_io<__nv_bfloat16, GATES, TRACE>(a, s) : launch_io<float, GATES, TRACE>(a, s);
}

}  // namespace gev
