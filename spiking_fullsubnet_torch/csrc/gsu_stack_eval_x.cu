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
// accumulation, membranes and the folded eval BN are f32.
//
// What bounds it on an H100: like kernel A, a strict recurrence of T steps.
// At zoo M's layered forward (bf16, 256 x 30 s, T = 3751) the four launches
// (fullband 256 rows x 64 features; sections 2048 x 38, 768 x 94, 512 x 158;
// two layers of 320 or 224) move about 14 GB, almost all of it the collected
// spikes [L, T, R, H], about 4 ms at 3.35 TB/s, and need a few hundred GOP
// once the spike products count only the spikes that fired. The real limit
// is the serial chain of each step (F_in + 3 H dependent inputs at L = 2),
// every link an L2 round trip for a weight.
//
// Design: kernel A's (gsu_stack_eval.cu) with layer 0 fed from the raw
// features. One block per tile of RB rows, one thread per hidden unit, a
// loop over T inside the block. Each step the block stages its RB rows of
// x[t] (F_in values each, f32 or bf16) into shared memory input-major, and
// each thread takes the dense product with its column of W_ih0 in f32
// (dot_rows): no hoisted [T, R, G] gate tensor in device memory. Spikes of
// every layer stay in shared memory and membranes in registers for the
// whole sequence; the weights are read every step through L2, each load
// feeding RB rows. CUDA-core FMAs, sequential f32 sums, no fast math.
#include "gsu_common.cuh"

using namespace gsu;

template <typename IO, int L>
__global__ void __launch_bounds__(512)
stack_eval_x_kernel(const IO* __restrict__ x, const IO* __restrict__ wih0,
                    const IO* __restrict__ wihr, const IO* __restrict__ whh,
                    const float* __restrict__ coef, IO* __restrict__ out, int T, int R,
                    int F, int H, int shared) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [L][H][RB] spikes
  float* xs = hs + (size_t)L * H * RB;          // [F][RB] layer-0 inputs of step t
  const int row0 = blockIdx.x * RB;
  const int rows = min(RB, R - row0);
  const int j = threadIdx.x;
  const bool active = j < H;
  const int G = shared ? H : 2 * H;
  const int j2 = shared ? -1 : H + j;

  for (int i = threadIdx.x; i < (L * H + F) * RB; i += blockDim.x) hs[i] = 0.f;
  float cf[L][4];
  load_coef<L>(coef, H, j, active, cf);
  float c[L][RB];
#pragma unroll
  for (int k = 0; k < L; ++k)
#pragma unroll
    for (int r = 0; r < RB; ++r) c[k][r] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // Stage the tile's rows of x[t]: contiguous in device memory (q = r F + i),
    // input-major in shared memory. Rows past R keep their zeros. Every read
    // of step t-1's xs finished before stack_step's first barrier.
    const IO* xt = x + ((size_t)t * R + row0) * F;
    for (int q = threadIdx.x; q < rows * F; q += blockDim.x) {
      const int r = q / F;
      xs[(q - r * F) * RB + r] = ld(xt + q);
    }
    __syncthreads();
    float px[RB], pxc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) px[r] = pxc[r] = 0.f;
    if (active) dot_rows(xs, F, wih0, G, j, j2, px, pxc);
    stack_step<L>(hs, H, G, shared != 0, j, active, wihr, whh, cf, c, px, pxc,
                  [&](int k, int r, float hv) {
                    if (r < rows)
                      st(out + (((size_t)k * T + t) * R + row0 + r) * H + j, hv);
                  });
  }
}

template <typename IO, int L>
static int launch_typed(const void* x, const void* wih0, const void* wihr, const void* whh,
                        const float* coef, void* out, int T, int R, int F, int H, int shared,
                        cudaStream_t stream) {
  auto kern = stack_eval_x_kernel<IO, L>;
  const size_t smem = (size_t)(L * H + F) * RB * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((R + RB - 1) / RB);
  const int threads = (H + 31) / 32 * 32;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const IO*>(wih0), static_cast<const IO*>(wihr),
      static_cast<const IO*>(whh), coef, static_cast<IO*>(out), T, R, F, H, shared);
  return (int)cudaGetLastError();
}

template <typename IO>
static int launch_l(int L, const void* x, const void* wih0, const void* wihr, const void* whh,
                    const float* coef, void* out, int T, int R, int F, int H, int shared,
                    cudaStream_t s) {
  switch (L) {
    case 1: return launch_typed<IO, 1>(x, wih0, wihr, whh, coef, out, T, R, F, H, shared, s);
    case 2: return launch_typed<IO, 2>(x, wih0, wihr, whh, coef, out, T, R, F, H, shared, s);
    case 3: return launch_typed<IO, 3>(x, wih0, wihr, whh, coef, out, T, R, F, H, shared, s);
    case 4: return launch_typed<IO, 4>(x, wih0, wihr, whh, coef, out, T, R, F, H, shared, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// x [T, R, F], wih0 [F, G], wihr [max(L-1,1), H, G], whh [L, H, G] in the io
// type (bf16 when io_bf16, else f32); coef [L, 4, H] f32 = (b_f, b_c, BN
// scale, BN shift); out [L, T, R, H] in the io type. G = H (shared) or 2H
// (f half first). Returns the CUDA error code of the launch (0 on success).
int gsu_stack_eval_x_launch(int io_bf16, const void* x, const void* wih0, const void* wihr,
                            const void* whh, const float* coef, void* out, int T, int R, int F,
                            int H, int L, int shared, void* stream) {
  if (H < 1 || H > 512 || T < 0 || R < 1 || F < 1) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    return launch_l<__nv_bfloat16>(L, x, wih0, wihr, whh, coef, out, T, R, F, H, shared, s);
  return launch_l<float>(L, x, wih0, wihr, whh, coef, out, T, R, F, H, shared, s);
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
