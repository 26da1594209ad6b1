// Kernel A: eval forward of an L-layer GSU stack with layer 0's input gates
// given (xg0 = the hoisted layer-0 projection, computed outside).
//
// Replaces spiking_fullsubnet_tpu/ops/gsu_pallas.py: _stack_eval_xg_kernel
// (:923), called by gsu_stack_eval_pallas_xg (:997, pallas_call :1140).
//
// Per step t and layer k: pre = (k == 0 ? xg0[t] : h_{k-1} @ W_ih[k]) +
// h_k @ W_hh[k]; f = sigmoid(pre_f + b_f); c = (f c + (1 - f)(pre_c + b_c))
// * scale + shift; h_k = (c >= 0). Streams and weights are f32 or bf16;
// accumulation, membranes and BN are f32.
//
// What bounds it on an H100: the work is a strict recurrence of T steps,
// each a [rows, H] x [H, G] product per layer. At the zoo-M fullband shape
// (rows 256, H = G = 320, L = 2, T = 3751) the dense products are 590 GFLOP
// and the streams 1.2 GB in bf16 — well under a millisecond at peak — so the
// real limit is the serial chain: every step waits on the previous one,
// and the weights (3 x 320^2 values, 1.2 MB in f32) do not fit in one SM's
// shared memory.
//
// Design: one block per tile of RB rows (and per sub-band unit in the 4-D
// form), one thread per hidden unit, a loop over T inside the block. Spikes
// of the tile stay in shared memory and membranes in registers for the whole
// sequence; only xg0 is read and the spikes written. The weights are read
// every step through L2 (each load feeds RB rows). CUDA-core FMAs, no tensor
// cores: simple and exact in f32 order; a later version can stage weight
// tiles through shared memory and use wgmma.
#include "gsu_common.cuh"

using namespace gsu;

template <typename IO, int L>
__global__ void __launch_bounds__(512)
stack_eval_kernel(const IO* __restrict__ xg0, const IO* __restrict__ wihr,
                  const IO* __restrict__ whh, const float* __restrict__ coef,
                  IO* __restrict__ out, int T, int R, int H, int shared, int collect_all) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [L][H][RB]
  const int U = gridDim.y, u = blockIdx.y;
  const int row0 = blockIdx.x * RB;
  const int j = threadIdx.x;
  const bool active = j < H;
  const int G = shared ? H : 2 * H;

  for (int i = threadIdx.x; i < L * H * RB; i += blockDim.x) hs[i] = 0.f;
  float cf[L][4];
  load_coef<L>(coef, H, j, active, cf);
  float c[L][RB];
#pragma unroll
  for (int k = 0; k < L; ++k)
#pragma unroll
    for (int r = 0; r < RB; ++r) c[k][r] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float px[RB], pxc[RB];
    const size_t step = ((size_t)u * T + t) * R;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int row = row0 + r;
      px[r] = pxc[r] = 0.f;
      if (active && row < R) {
        const IO* x = xg0 + (step + row) * G;
        px[r] = ld(x + j);
        pxc[r] = shared ? px[r] : ld(x + H + j);
      }
    }
    stack_step<L>(hs, H, G, shared != 0, j, active, wihr, whh, cf, c, px, pxc,
                  [&](int k, int r, float hv) {
                    const int row = row0 + r;
                    if (row >= R) return;
                    if (collect_all)
                      st(out + (((size_t)k * U * T) * R + step + row) * H + j, hv);
                    else if (k == L - 1)
                      st(out + (step + row) * H + j, hv);
                  });
  }
}

template <typename IO, int L>
static int launch_typed(const void* xg0, const void* wihr, const void* whh, const float* coef,
                        void* out, int U, int T, int R, int H, int shared, int collect_all,
                        cudaStream_t stream) {
  auto kern = stack_eval_kernel<IO, L>;
  const size_t smem = (size_t)L * H * RB * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((R + RB - 1) / RB, U);
  const int threads = (H + 31) / 32 * 32;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const IO*>(xg0), static_cast<const IO*>(wihr), static_cast<const IO*>(whh),
      coef, static_cast<IO*>(out), T, R, H, shared, collect_all);
  return (int)cudaGetLastError();
}

template <typename IO>
static int launch_l(int L, const void* xg0, const void* wihr, const void* whh,
                    const float* coef, void* out, int U, int T, int R, int H, int shared,
                    int collect_all, cudaStream_t s) {
  switch (L) {
    case 1: return launch_typed<IO, 1>(xg0, wihr, whh, coef, out, U, T, R, H, shared, collect_all, s);
    case 2: return launch_typed<IO, 2>(xg0, wihr, whh, coef, out, U, T, R, H, shared, collect_all, s);
    case 3: return launch_typed<IO, 3>(xg0, wihr, whh, coef, out, U, T, R, H, shared, collect_all, s);
    case 4: return launch_typed<IO, 4>(xg0, wihr, whh, coef, out, U, T, R, H, shared, collect_all, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// xg0 [U, T, R, G] (U = 1 for the 3-D form), wihr [max(L-1,1), H, G],
// whh [L, H, G] in the io type (bf16 when io_bf16, else f32); coef [L, 4, H]
// f32; out [L, U, T, R, H] with collect_all, else [U, T, R, H].
// Returns the CUDA error code of the launch (0 on success).
int gsu_stack_eval_launch(int io_bf16, const void* xg0, const void* wihr, const void* whh,
                          const float* coef, void* out, int U, int T, int R, int H, int L,
                          int shared, int collect_all, void* stream) {
  if (H < 1 || H > 512 || U < 1 || T < 0 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    return launch_l<__nv_bfloat16>(L, xg0, wihr, whh, coef, out, U, T, R, H, shared, collect_all, s);
  return launch_l<float>(L, xg0, wihr, whh, coef, out, U, T, R, H, shared, collect_all, s);
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
