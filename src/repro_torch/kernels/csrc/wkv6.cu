// RWKV-6 (Finch) WKV recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py (`wkv6_bhtk`, body
// `_kernel`). Same contract: r/k/v (B,H,T,K) in fp32 or bf16, logw (B,H,T,K)
// fp32, u (H,K) fp32, s0 (B,H,K,K) fp32; y (B,H,T,K) in r's dtype and s_T
// (B,H,K,K) in fp32, with
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T.
//
// What bounds it on the H100. At decode (T = 1) it is bytes: the (K,K) fp32
// state is read and written once per (b, h) and dominates (16.8 MB at B 8,
// H 64, K 64, ~5 us at 3.35 TB/s), against 4K^2 operations per (b, h).
// At prefill (T = 512 at the same B, H, K) bytes and fp32 operations are
// about even: ~0.22 GB of r/k/v/y/logw/state against ~4.3 GFLOP, both
// ~0.065 ms at the card's peak rates.
//
// Design: the TPU kernel walked a sequential chunk axis, carrying S in VMEM
// scratch, and turned each chunk's work into MXU products. Here nothing
// carries over between blocks, so one block owns one (b, h) and walks all
// its tokens itself. Each column v of S evolves on its own:
//   S[:,v] <- exp(logw_t) * S[:,v] + k_t v_t[v],
//   y_t[v] = sum_k r_t[k] (S[k,v] + u[k] k_t[k] v_t[v]),
// so K threads each hold one column in K fp32 registers, and the state
// never leaves registers between s0 and s_T. For each token the block
// stages r_t, k_t and exp(logw_t) in shared memory (the exponent once per
// token and k, not per thread), double-buffered: token t+1 is loaded into
// registers before token t's FMAs and stored into the other buffer after
// them, so one barrier per token suffices and the loads overlap the math.
// It takes any T >= 1, with no padding and no chunk divisibility, and is
// exact token-serial arithmetic in fp32. The chunked tensor-core form (the
// TPU kernel's per-chunk products as mma/wgmma) is the later redesign.

#include "common.cuh"

namespace {

template <typename T, int K>
__global__ void __launch_bounds__(K)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_T, int H, int n_tok) {
  __shared__ float r_s[2][K], k_s[2][K], w_s[2][K], u_s[K];
  const int bh = blockIdx.x, h = bh % H, j = threadIdx.x;
  const long long base = (long long)bh * n_tok * K;   // (b, h, 0, 0)
  const long long sbase = (long long)bh * K * K;

  float S[K];                       // column j of the state: S[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < K; ++i) S[i] = s0[sbase + i * K + j];
  u_s[j] = u[h * K + j];
  r_s[0][j] = to_f(r[base + j]);
  k_s[0][j] = to_f(k[base + j]);
  w_s[0][j] = expf(logw[base + j]);
  float vj = to_f(v[base + j]);
  __syncthreads();

  for (int t = 0; t < n_tok; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < n_tok;
    float rn = 0.f, kn = 0.f, lwn = 0.f, vn = 0.f;
    if (more) {                     // next token's loads, in flight
      const long long off = base + (long long)(t + 1) * K + j;
      rn = to_f(r[off]);
      kn = to_f(k[off]);
      lwn = logw[off];
      vn = to_f(v[off]);
    }
    // four partial sums break the dependent-add chain over i
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float kv = k_s[cur][i] * vj;
      acc[i & 3] += r_s[cur][i] * (S[i] + u_s[i] * kv);
      S[i] = w_s[cur][i] * S[i] + kv;
    }
    y[base + (long long)t * K + j] =
        from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    if (more) {                     // the buffer token t-1 used is free
      r_s[cur ^ 1][j] = rn;
      k_s[cur ^ 1][j] = kn;
      w_s[cur ^ 1][j] = expf(lwn);
      vj = vn;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < K; ++i) s_T[sbase + i * K + j] = S[i];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* y,
                   void* s_T, int B, int H, int n_tok, int K,
                   cudaStream_t stream) {
  const dim3 grid(B * H);
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* lp = static_cast<const float*>(logw);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(s0);
  T* yp = static_cast<T*>(y);
  float* op = static_cast<float*>(s_T);
  switch (K) {
    case 16:
      wkv6_kernel<T, 16><<<grid, 16, 0, stream>>>(rp, kp, vp, lp, up, sp, yp,
                                                  op, H, n_tok);
      break;
    case 64:
      wkv6_kernel<T, 64><<<grid, 64, 0, stream>>>(rp, kp, vp, lp, up, sp, yp,
                                                  op, H, n_tok);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* logw, const void* u, const void* s0,
                          void* y, void* s_T, int B, int H, int n_tok, int K,
                          int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch<float>(r, k, v, logw, u, s0, y, s_T, B, H, n_tok, K, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(r, k, v, logw, u, s0, y, s_T, B, H, n_tok, K,
                                 s);
  return cudaErrorInvalidValue;
}
