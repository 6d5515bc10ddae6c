// Shared helpers for the port's hand-written kernels: element conversion,
// the masking constant and the dtype codes the Python wrappers pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// -0.7 * FLT_MAX: the masking constant of the TPU kernels. A finite value
// (not -inf) keeps exp(m_prev - m_new) well defined before any live key.
#define REPRO_NEG_INF (-0.7f * 3.402823466e+38f)

// dtype codes shared with kernels/_cuda.py
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
