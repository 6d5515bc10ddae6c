// Blocked online-softmax (flash) attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_bhsd`, body `_kernel`). Same contract: q (B,H,Sq,hd),
// k/v (B,KV,Sk,hd) with GQA kv head = h / (H/KV); scale 1/sqrt(hd) applied
// once to q.k; optional tanh softcap; causal and local-window masks; the
// pre-pad lengths seq_q/seq_k mask rows and columns; a q row with no live
// key (or past seq_q) writes zeros (l floored at 1e-20); fully masked key
// blocks are skipped; the output has q's dtype.
//
// What bounds it on the H100: at the protein models' sizes (S 32-96, hd 32)
// neither bytes nor operations. A FoldScore launch (4-24 rows x 8 heads x 32
// tokens) moves well under 2 MB and does under 0.1 GFLOP, so it is far from
// both the 3.35 TB/s and the tensor-core rate; the launch and the host set
// its time. At long sequences it is bound by operations, and the products
// below run on the CUDA cores in fp32, not on the tensor cores: at
// recurrentgemma-2b's prefill (8 rows x 10 heads x 2560 queries, hd 256,
// MQA, window 2048) a launch does ~0.26 TFLOP on live (q, k) pairs. Its
// decode form (Sq = 1 over up to 2048 cached keys) is bound by the K/V
// bytes, ~4 MB per row, read once per head.
//
// Design: the TPU grid (B, H, q-blocks, k-blocks) carried (m, l, acc) across
// its sequential k-block axis. Here one block owns one (b, h, q-block) and
// loops over k-blocks itself, stopping at the causal limit and skipping
// blocks wholly outside the window. Q, the K/V tile, the score tile and acc
// live in shared memory in fp32; Q.K^T and P.V are plain loops over shared
// memory (K rows padded by one float against bank conflicts). Tiles are
// templated per head dim so that static shared memory stays under 48 KB;
// head dim 256 takes 8 x 8 tiles. A later PR can move the two products onto
// wgmma (and pack the heads of one KV head into a block for MQA decode);
// this one keeps the kernel simple.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ bool is_live(int row, int col, int seq_q,
                                        int seq_k, int causal, int window) {
  bool ok = row < seq_q && col < seq_k;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && col > row - window;
  return ok;
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int Sq, int Sk, int seq_q, int seq_k, int causal, int window,
                 float softcap, float scale) {
  __shared__ float q_s[BQ][HD];
  __shared__ float k_s[BK][HD + 1];
  __shared__ float v_s[BK][HD];
  __shared__ float s_s[BQ][BK + 1];
  __shared__ float acc_s[BQ][HD];
  __shared__ float m_s[BQ], l_s[BQ], a_s[BQ];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* qb = q + ((long long)b * H + h) * Sq * HD;
  const T* kb = k + ((long long)b * KV + kvh) * Sk * HD;
  const T* vb = v + ((long long)b * KV + kvh) * Sk * HD;

  for (int i = tid; i < BQ * HD; i += nt) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    q_s[r][d] = row < Sq ? to_f(qb[(long long)row * HD + d]) : 0.f;
    acc_s[r][d] = 0.f;
  }
  for (int r = tid; r < BQ; r += nt) {
    m_s[r] = REPRO_NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int n_kb = (seq_k + BK - 1) / BK;
  for (int kbi = 0; kbi < n_kb; ++kbi) {
    const int k0 = kbi * BK;
    if (causal && k0 > q0 + BQ - 1) break;                 // causal limit
    if (window > 0 && k0 + BK - 1 <= q0 - window) continue;  // outside window

    for (int i = tid; i < BK * HD; i += nt) {
      const int j = i / HD, d = i % HD, col = k0 + j;
      const bool in = col < Sk;
      k_s[j][d] = in ? to_f(kb[(long long)col * HD + d]) : 0.f;
      v_s[j][d] = in ? to_f(vb[(long long)col * HD + d]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < BQ * BK; i += nt) {
      const int r = i / BK, j = i % BK;
      float s = REPRO_NEG_INF;
      if (is_live(q0 + r, k0 + j, seq_q, seq_k, causal, window)) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc += q_s[r][d] * k_s[j][d];
        s = acc * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      s_s[r][j] = s;
    }
    __syncthreads();

    // online softmax update, one warp per query row
    for (int r = warp; r < BQ; r += nw) {
      const int row = q0 + r;
      float cm = REPRO_NEG_INF;
      for (int j = lane; j < BK; j += 32) cm = fmaxf(cm, s_s[r][j]);
      cm = warp_max(cm);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, cm);
      float ps = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p =
            is_live(row, k0 + j, seq_q, seq_k, causal, window)
                ? expf(s_s[r][j] - m_new)
                : 0.f;
        s_s[r][j] = p;
        ps += p;
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + ps;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < BQ * HD; i += nt) {
      const int r = i / HD, d = i % HD;
      float a = acc_s[r][d] * a_s[r];
#pragma unroll
      for (int j = 0; j < BK; ++j) a += s_s[r][j] * v_s[j][d];
      acc_s[r][d] = a;
    }
    __syncthreads();
  }

  T* ob = o + ((long long)b * H + h) * Sq * HD;
  for (int i = tid; i < BQ * HD; i += nt) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    if (row < Sq)
      ob[(long long)row * HD + d] =
          from_f<T>(acc_s[r][d] / fmaxf(l_s[r], 1e-20f));
  }
}

template <typename T, int HD, int BQ, int BK>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int H, int KV, int Sq, int Sk, int seq_q, int seq_k, int causal,
            int window, float softcap, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD, BQ, BK><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Sk, seq_q,
      seq_k, causal, window, softcap, 1.f / sqrtf(static_cast<float>(HD)));
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Sk, int hd,
                        int seq_q, int seq_k, int causal, int window,
                        float softcap, cudaStream_t s) {
  // tiles sized so every variant's static shared memory stays under 48 KB
  switch (hd) {
    case 16:
      launch<T, 16, 32, 32>(q, k, v, o, B, H, KV, Sq, Sk, seq_q, seq_k,
                            causal, window, softcap, s);
      break;
    case 32:
      launch<T, 32, 32, 32>(q, k, v, o, B, H, KV, Sq, Sk, seq_q, seq_k,
                            causal, window, softcap, s);
      break;
    case 64:
      launch<T, 64, 32, 32>(q, k, v, o, B, H, KV, Sq, Sk, seq_q, seq_k,
                            causal, window, softcap, s);
      break;
    case 128:
      launch<T, 128, 16, 16>(q, k, v, o, B, H, KV, Sq, Sk, seq_q, seq_k,
                             causal, window, softcap, s);
      break;
    case 256:   // 8 x 8 tiles: ~33 KB (16 x 16 would take ~66 KB)
      launch<T, 256, 8, 8>(q, k, v, o, B, H, KV, Sq, Sk, seq_q, seq_k,
                           causal, window, softcap, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int KV, int Sq, int Sk, int hd,
                                     int seq_q, int seq_k, int causal,
                                     int window, float softcap, int dtype,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    err = dispatch_hd<float>(q, k, v, o, B, H, KV, Sq, Sk, hd, seq_q, seq_k,
                             causal, window, softcap, s);
  else if (dtype == REPRO_BF16)
    err = dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, hd, seq_q,
                                     seq_k, causal, window, softcap, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
