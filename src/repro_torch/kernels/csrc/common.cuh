// Shared helpers for the port's hand-written kernels: element conversion,
// the masking constant and the dtype codes the Python wrappers pass, warp
// reductions, cp.async, and the mbarrier / tensor-map helpers of a ring fed
// by the copy engine (TMA).
#pragma once

#include <cuda.h>   // CUtensorMap and its encoder's types (no driver link)
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

// -- mbarriers and bulk asynchronous copies (sm_90) --------------------------
//
// A ring of stages in shared memory fed by the copy engine: each stage has a
// "full" mbarrier (count 1) and an "empty" one (count: the consumers that
// arrive). For stage s of the ring's slot s % depth, in round r = s / depth:
//   producer: if r > 0, mbar_wait(empty, (r - 1) & 1); one thread calls
//             mbar_expect(full, bytes) (it arrives and adds the bytes the
//             copies will bring), then issues the copies (tma_load_3d(...,
//             full)), whose boxes sum to exactly those bytes;
//   consumer: mbar_wait(full, r & 1); read the stage; mbar_arrive(empty).
// A wait on parity p returns once the barrier's phase of parity p has
// completed: a fresh barrier is in phase 0, so a wait on 1 returns at once
// and a wait on 0 blocks until the first phase completes. One thread inits
// every barrier, then mbar_init_fence() and __syncthreads() before use.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the inits visible to the copy engine (the async proxy).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive once and expect ``bytes`` more of bulk copies in this phase.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Block until the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 3-D tensor map, at element coordinates (x, y, z) (x the
// innermost), copied global -> shared by the copy engine, completing on
// ``bar``'s expected bytes: the whole box's, elements past the tensor's
// edge arriving as zeros. ``dst`` 128-byte aligned; ``map`` a kernel
// parameter (``const __grid_constant__ CUtensorMap``).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int x, int y, int z,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

// The driver's tensor-map encoder, looked up once through the runtime (no
// link against the driver library); null where the driver has none.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of the contiguous fp32 array ``base`` of shape (n2, n1, n0)
// (n0 innermost) in boxes of (b2, b1, b0) elements, no swizzle: a box
// lands in shared memory as b2 x b1 rows of b0 floats. ``base`` and n0 * 4
// must be multiples of 16 bytes, each box extent at most 256.
inline cudaError_t tile_map_3d(CUtensorMap* map, const float* base,
                               long long n2, long long n1, long long n0,
                               int b2, int b1, int b0) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1,
                              (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)n0 * 4,
                                 (cuuint64_t)(n0 * n1) * 4};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1,
                             (cuuint32_t)b2};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
