// Shared device code of the GSU kernels: typed loads and stores (every
// kernel; D and E through gsu_train_mma.cuh) and the GSU cell step (C, and
// A, B and F through gsu_eval_mma.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gsu {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One GSU cell update with the eval BatchNorm folded to an affine:
// f = sigmoid(pre_f + b_f); c' = (f c + (1 - f)(pre_c + b_c)) scale + shift.
// expf is the precise one (no fast math): spike thresholds are sensitive.
__device__ __forceinline__ float cell(float pre_f, float pre_c, float c, float b_f,
                                      float b_c, float scale, float shift) {
  const float f = 1.f / (1.f + expf(-(pre_f + b_f)));
  const float g = pre_c + b_c;
  return (f * c + (1.f - f) * g) * scale + shift;
}

}  // namespace gsu
