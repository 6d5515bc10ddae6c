// RG-LRU gated linear recurrence and its gradient, for Hopper (sm_90a).
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
//
// The gradient (`rglru_bwd_kernel`, `RGLRU.backward` in kernels/rglru.py):
// with g_t = dL/dh_t through every later step, g_{T} = gT,
//   g_t = a_{t+1} g_{t+1} + gh_t   (a_T = 1),
//   db_t = g_t,  da_t = g_t h_{t-1}  (h_{-1} = h0),  dh0 = a_0 g_0.
// gh (B,T,C) and gT (B,C) may be absent (null: zeros). One thread owns a
// (b, c) channel and walks t = T-1 .. 0, reading a_{t+1}, gh_t and h_{t-1}
// backwards in groups of U loads in flight, as the forward does, and
// writing da_t and db_t: 5 B T C fp32 moved, 3 operations an element, so
// bytes bound it (0.31 ms at 8 x 2560 x 2560). Each step rounds as the
// plain version (`rglru_bwd_ref`) does, __fadd_rn(__fmul_rn(a, g), gh)
// and __fmul_rn(g, h), so the gradients are bitwise the plain version's.
// No flip, concatenation or temporary around it: one launch a backward.

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


// The gradient: one thread a (b, c) channel, t = T-1 .. 0 (see the top).
__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ h0, const float* __restrict__ gh,
                 const float* __restrict__ gT, float* __restrict__ da,
                 float* __restrict__ db, float* __restrict__ dh0, int T,
                 int C) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const long long row = blockIdx.y;
  const long long base = row * T * C + c;      // (b, 0, c)
  const float hinit = h0[row * C + c];
  float g = gT != nullptr ? gT[row * C + c] : 0.f;

  // token t's a_{t+1}, gh_t and h_{t-1}
  auto load = [&](int t, float& an, float& gv, float& hp) {
    const long long off = base + (long long)t * C;
    an = t + 1 < T ? a[off + C] : 1.f;
    gv = gh != nullptr ? gh[off] : 0.f;
    hp = t > 0 ? h[off - C] : hinit;
  };
  auto back = [&](int t, float an, float gv, float hp) {
    const long long off = base + (long long)t * C;
    g = step(an, g, gv);
    db[off] = g;
    da[off] = __fmul_rn(g, hp);
  };

  const int rag = T % U;                       // tokens 0 .. rag-1 last
  float an[U], gv[U], hp[U];
  if (T >= U) {
#pragma unroll
    for (int i = 0; i < U; ++i) load(T - 1 - i, an[i], gv[i], hp[i]);
  }
  for (int t1 = T - 1; t1 >= rag; t1 -= U) {  // tokens t1 .. t1-U+1
    float ac[U], gc[U], hc[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      ac[i] = an[i];
      gc[i] = gv[i];
      hc[i] = hp[i];
    }
    if (t1 - U >= rag) {                       // next group, in flight
#pragma unroll
      for (int i = 0; i < U; ++i) load(t1 - U - i, an[i], gv[i], hp[i]);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) back(t1 - i, ac[i], gc[i], hc[i]);
  }
  for (int t = rag - 1; t >= 0; --t) {         // the ragged head
    float a1, g1, h1;
    load(t, a1, g1, h1);
    back(t, a1, g1, h1);
  }
  dh0[row * C + c] = __fmul_rn(a[base], g);
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

// The gradient of repro_rglru at the upstream gh (B,T,C) and gT (B,C),
// either null for zero, from the forward's a, h (B,T,C) and h0 (B,C): da,
// db (B,T,C) and dh0 (B,C), all fp32. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int repro_rglru_bwd(const void* a, const void* h, const void* h0,
                               const void* gh, const void* gT, void* da,
                               void* db, void* dh0, int B, int T, int C,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + THREADS - 1) / THREADS, B);
  rglru_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(gh),
      static_cast<const float*>(gT), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), T, C);
  return cudaGetLastError();
}
