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

// 16-byte asynchronous copy global -> shared (sm_80+). With ``in`` false
// nothing is read and the 16 shared bytes are zero-filled; ``src`` must
// still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise ``kernel``'s dynamic shared memory limit past the 48 KB default to
// ``bytes`` (a constant per kernel), once per device: the attribute is per
// function and device. ``done`` is the caller's per-kernel flag word, one
// bit a device; device indices >= 64 set it on every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned long long& done, int device,
                       size_t bytes) {
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (done & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done |= bit;
  return err;
}
