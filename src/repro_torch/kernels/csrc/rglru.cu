// RG-LRU gated linear recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru.py (`rglru_btc`, body
// `_kernel`). Same contract: a/b (B,T,C) fp32, h0 (B,C) fp32; h (B,T,C) fp32
// and h_T (B,C) fp32 with h_t = a_t * h_{t-1} + b_t per channel.
//
// What bounds it on the H100: bytes. Each element of a and b is read once
// and each element of h written once, against two operations per element:
// at recurrentgemma-2b's prefill (B 8, T 2560, C 2560) that is 629 MB,
// 0.19 ms at 3.35 TB/s. At decode (T = 1) it moves 0.4 MB and the launch
// sets its time.
//
// Design: the TPU grid (B, channel blocks, time blocks) carried h across
// its sequential time axis in VMEM scratch. Here nothing carries over
// between blocks, so one thread owns one (b, c) channel and walks all T
// tokens itself, holding h in a register. Neighbouring threads take
// neighbouring c, so every load of a[b,t,:] / b[b,t,:] and every store of
// h[b,t,:] is coalesced. The token loop runs in groups of U: the loads of
// group g+1 are issued before group g's chain of dependent steps, so they
// are in flight while it runs. Each step is __fadd_rn(__fmul_rn(a, h), b):
// no FMA contraction, so the kernel rounds exactly as the plain version's
// separate multiply and add do. Any T >= 1; T = 1 is the decode step. With
// B*C threads (20,480 at the prefill, 160 blocks for 132 SMs) the kernel
// is latency-bound; splitting T across blocks with a second pass (a scan
// of the per-block (prod a, h) pairs) is the later redesign.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int U = 16;   // tokens per group of loads in flight

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ h,
             float* __restrict__ h_T, int T, int C) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const long long row = blockIdx.y;
  const long long base = row * T * C + c;      // (b, 0, c)
  float hv = h0[row * C + c];

  const int full = T - T % U;                  // tokens in whole groups
  float an[U], bn[U];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      an[i] = a[base + (long long)i * C];
      bn[i] = b[base + (long long)i * C];
    }
  }
  for (int t0 = 0; t0 < full; t0 += U) {
    float ac[U], bc[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      ac[i] = an[i];
      bc[i] = bn[i];
    }
    if (t0 + U < full) {                       // next group, in flight
      const long long off = base + (long long)(t0 + U) * C;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        an[i] = a[off + (long long)i * C];
        bn[i] = b[off + (long long)i * C];
      }
    }
    const long long off = base + (long long)t0 * C;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      hv = step(ac[i], hv, bc[i]);
      h[off + (long long)i * C] = hv;
    }
  }
  for (int t = full; t < T; ++t) {             // the ragged tail
    const long long off = base + (long long)t * C;
    hv = step(a[off], hv, b[off]);
    h[off] = hv;
  }
  h_T[row * C + c] = hv;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_rglru(const void* a, const void* b, const void* h0,
                           void* h, void* h_T, int B, int T, int C,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_T), T, C);
  return cudaGetLastError();
}
