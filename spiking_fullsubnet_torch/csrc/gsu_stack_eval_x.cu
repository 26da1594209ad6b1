// Kernel F: eval forward of an L-layer GSU stack from the raw features, the
// layer-0 input projection computed inside the kernel, every layer's spikes
// written out.
//
// Replaces spiking_fullsubnet_tpu/ops/gsu_pallas.py: _stack_eval_kernel
// (:756), called by gsu_stack_eval_pallas (:805, pallas_call :880).
//
// Per step t and layer k: pre = (k == 0 ? x[t] @ W_ih0 : h_{k-1} @ W_ih[k])
// + h_k @ W_hh[k]; f = sigmoid(pre_f + b_f); c = (f c + (1 - f)(pre_c + b_c))
// * scale + shift; h_k = (c >= 0). Streams and weights are f32 or bf16;
// sums, membranes and the folded eval BN are f32; expf is the precise one.
//
// What bounds it on an H100: at zoo M's layered forward (bf16, 256 x 30 s,
// T = 3751) the four launches (fullband 256 rows x 64 features -> 2 x 320;
// sections 2048 x 38, 768 x 94, 512 x 158 -> 2 x 224) move about 14 GB,
// almost all of it the collected spikes [L, T, R, H] (about 4 ms at
// 3.35 TB/s), and need a few hundred GOP once the spike products count only
// the spikes that fired. What limits it is the chain of T dependent steps,
// each a sequence of dependent products whose weights (0.3-0.6 MB a stack
// in bf16) are read from L2 at every step: PR 1's design (a thread a unit,
// a block a tile of 8 rows) waited on one L2 round trip a weight.
//
// Design (the host's plan, ops/gsu_kernels.stack_x_plan, sets the tile,
// the cluster and every shared-memory offset; gsu_eval_mma.cuh is the
// engine, shared with kernel B):
//   - A block owns N rows (8-64 columns): the fewest that let the row tiles
//     fill the card in one wave. Where the tiles leave SMs idle and a
//     block's 16 warps have more than one gate m-tile each (the fullband's
//     320 units, cIRM-GSN's 256 rows), a cluster of 2 or 4 blocks splits the
//     m-tiles: each block pushes its new spikes into every block of the
//     cluster (distributed shared memory) and one cluster barrier a layer
//     orders them.
//   - Every product on the tensor cores (bf16; float32 on the CUDA cores in
//     k order): the layer-0 product x[t] W_ih0 with the dense features as
//     the right operand, the recurrent and inter-layer products with the
//     spikes as dense bf16 rows in shared memory (one ldmatrix gives a
//     warp two n-groups' fragments); weights packed in fragment order
//     (stack_x_pack) and streamed from L2, two batches of tiles in flight a
//     warp.
//   - x[t + 1] is asked for at the start of step t, held in registers and
//     stored into the other half of a double-buffered tile after layer 0's
//     products, so its round trip is off the chain.
//   - The spikes of every layer go out after the step's last barrier, 8
//     units (16 or 32 bytes) a store, whole rows of H: the stores leave the
//     chain, which never waits on them.
// Barriers: L a step (one after each layer). Rows are independent: a row's
// arithmetic does not depend on the tile or the cluster, and nothing is
// summed across threads, so two launches are bitwise equal.
#include "gsu_eval_mma.cuh"

using namespace gev;

constexpr int MAX_L = 4;

// Mirrored by _StackXArgs in ops/gsu_kernels.py (same field order).
struct StackXArgs {
  const void* x;       // [T, R, F] io
  const void* w;       // packed weights (io): in, rec[0..L-1]
  const float* coef;   // [L, 4, H] (b_f, b_c, BN scale, BN shift)
  void* out;           // [L, T, R, H] io
  unsigned long long* prof;  // optional [blocks][8] clock64 cycles a phase (null: off)
  int T, R, F, H, L, shared;
  // the plan: columns a block, blocks a cluster, m-tiles a block, H padded to
  // 16, the x tile's row length, and byte offsets of the spikes and the
  // membranes (the x tiles at 0), the block's total
  int N, cs, mpb, Hp, ld_x, o_spk, o_mem, smem;
  Mat in, rec[MAX_L];
};

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

template <typename IO, int NG>
__global__ void __launch_bounds__(NTHREADS, 1) stack_x_kernel(const __grid_constant__ StackXArgs a) {
  constexpr int PF = NG <= 4 ? 8 : 4;  // the fewer accumulators, the more loads in flight
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const int cs = a.cs, rank = (int)cl.block_rank();
  const int N = a.N, ng = N / 8, H = a.H, Hp = a.Hp, sst = spk_stride(Hp), L = a.L, F = a.F;
  const int ms = mem_stride(Hp);
  const int T = a.T, R = a.R, ld_x = a.ld_x, shared = a.shared;
  const int row0 = (int)(blockIdx.x / cs) * N, rows = min(N, R - row0);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = rank * a.mpb, m1 = min(gate_mtiles(H, shared), m0 + a.mpb);
  const IO* x = static_cast<const IO*>(a.x);
  const IO* w = static_cast<const IO*>(a.w);
  IO* out = static_cast<IO*>(a.out);
  IO* xt = at<IO>(sm, 0);  // [2][N][ld_x]
  Spk* spk0 = at<Spk>(sm, a.o_spk);            // [2 parities][L][N][sst]
  float* mem = at<float>(sm, a.o_mem);         // [L][N][ms]

  for (int i = tid; i < a.smem / 16; i += NTHREADS) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // step tt's staged items: row n's feature k at i = n F + k, contiguous in
  // device memory; rows past R keep their zeros
  const int nx = rows * F;
  auto get = [&](int tt) {
    const IO* src = x + ((size_t)tt * R + row0) * F;
    return [=](int i) { return ld(src + i); };
  };
  const FastDiv d_f(F);
  auto set = [&](int tt) {
    IO* dst = xt + (size_t)(tt & 1) * N * ld_x;
    return [=](int i, float v) {
      const int n = d_f.div(i);
      dst[(size_t)n * ld_x + (i - n * F)] = IO(v);
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
  Staged st;
  const int n_out = L * rows * ((H + 7) / 8);
  const FastDiv d_per(rows * ((H + 7) / 8)), d_hb((H + 7) / 8);

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
      for (int mt = m0 + warp; mt < m1; mt += NWARPS) {
        float acc[NG][4];
        zero_acc(acc);
        if (k == 0) {
          const IO* xk = xt + (size_t)(t & 1) * N * ld_x;
          gemm_tile<NG, PF>(acc, w, one(a.in, mt, ng), XDense<IO>{xk, xk, ld_x, 1 << 30});
          gemm_tile<NG, PF>(acc, w, one(a.rec[0], mt, ng), XDense<Spk>{ospk, ospk, sst, 1 << 30});
        } else {
          const XDense<Spk> xs{nspk + (size_t)(k - 1) * N * sst, ospk + (size_t)k * N * sst, sst,
                               Hp / 16};
          gemm_tile<NG, PF>(acc, w, one(a.rec[k], mt, ng), xs);
        }
        mark(a.prof, 0);
        cell_tile(acc, mt, ng, H, ms, shared, coef, memk, put);
        mark(a.prof, 1);
      }
      if (k == 0 && t + 1 < T) st.store(nx, get(t + 1), set(t + 1));
      barrier();
      mark(a.prof, 2);
    }
    // every layer's spikes of step t, 8 units a store, the blocks of a
    // cluster taking turns
    for (int i = tid + rank * NTHREADS; i < n_out; i += NTHREADS * cs) {
      const int hb = (H + 7) / 8, per = rows * hb;
      const int k = d_per.div(i), rem = i - k * per, n = d_hb.div(rem), c = rem - n * hb;
      store8<IO>(out + (((size_t)k * T + t) * R + row0 + n) * H + c * 8,
                 nspk + ((size_t)k * N + n) * sst + c * 8, min(8, H - c * 8));
    }
    mark(a.prof, 3);
  }
  prof_end(a.prof);
}

template <typename IO, int NG>
static int launch_ng(const StackXArgs& a, cudaStream_t stream) {
  auto kern = stack_x_kernel<IO, NG>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)(((a.R + a.N - 1) / a.N) * a.cs));
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

template <typename IO>
static int launch_typed(const StackXArgs& a, cudaStream_t s) {
  switch (a.N) {
    case 8: return launch_ng<IO, 1>(a, s);
    case 16: return launch_ng<IO, 2>(a, s);
    case 32: return launch_ng<IO, 4>(a, s);
    default: return launch_ng<IO, 8>(a, s);
  }
}

extern "C" {

// args: the streams, the packed weights, the sizes and the host's plan
// (StackXArgs). Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue for what the kernel does not take (H 1..512, L
// 1..4, F 1..1024, R >= 1, the plan's tiles within 232,448 bytes).
int gsu_stack_eval_x_launch(int io_bf16, const StackXArgs* args, void* stream) {
  const StackXArgs& a = *args;
  const bool n_ok = a.N == 8 || a.N == 16 || a.N == 32 || a.N == 64;
  const bool cs_ok = a.cs == 1 || a.cs == 2 || a.cs == 4;
  if (a.H < 1 || a.H > 512 || a.L < 1 || a.L > MAX_L || a.F < 1 || a.F > 1024 || a.R < 1 ||
      a.T < 0 || !n_ok || !cs_ok || a.smem > 232448 || a.mpb < 1)
    return (int)cudaErrorInvalidValue;
  if (a.T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return io_bf16 ? launch_typed<__nv_bfloat16>(a, s) : launch_typed<float>(a, s);
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
