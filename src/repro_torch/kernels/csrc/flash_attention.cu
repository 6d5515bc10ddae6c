// Blocked online-softmax (flash) attention forward, for Hopper (sm_90a): the
// sequence forms (Sq > 1). The one-query decode form is flash_decode.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_bhsd`, body `_kernel`). Same contract: q (B,H,Sq,hd),
// k/v (B,KV,Sk,hd) with GQA kv head = h / (H/KV); scale 1/sqrt(hd) applied
// once to q.k; optional tanh softcap; causal and local-window masks; the
// pre-pad lengths seq_q/seq_k mask rows and columns; a q row with no live
// key (or past seq_q) writes zeros (l floored at 1e-20); fully masked key
// blocks are skipped; the output has q's dtype.
//
// Two kernels, chosen by dtype:
//
// fp32 (`flash_fwd_f32_kernel`, recurrentgemma-2b's prefill). Bound by
// operations: at 8 rows x 10 heads x 2560 queries, hd 256, MQA, window 2048
// a launch does 0.258 TFLOP on live (q, k) pairs, 3.85 ms at the 67 TFLOP/s
// fp32 rate of the CUDA cores (TF32 tensor cores would miss the 2e-5
// tolerance). The design feeds the FMA units from registers: a block of 256
// threads owns 64 queries, with Q, a 64-key K tile, a V tile and P in
// dynamic shared memory (214 KB at hd 256). K and V have one buffer each,
// and their cp.async loads alternate with the compute: the next K tile
// loads during the softmax and P.V, the next V tile during Q.K^T. In Q.K^T
// each thread owns a 4 x 4 micro-tile of S, rows ty + 16i and keys tx +
// 16j, fed by float4 loads: 8 loads per 64 FMAs instead of two per FMA,
// with K rows padded so a warp's loads hit distinct banks. The 16 threads of a row
// form half a warp, so its max and sum are shuffles. P is staged once in
// shared memory; for P.V each thread owns the same 4 rows x hd/16 dims of the
// accumulator in registers (64 floats at hd 256), reading V as float4.
//
// bf16 (`flash_fwd_kernel`, the protein models' S 32-96 at hd 32, where a
// launch moves under 2 MB and the launch and the host set its time). Q, the
// K/V tile, the score tile and acc live in static shared memory in fp32 and
// Q.K^T and P.V are plain loops over it; head dim 256 takes 8 x 8 tiles to
// stay under 48 KB. Its redesign onto mma.sync is next in ROADMAP Queue 2.

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

// ---------------------------------------------------------------------------
// fp32: register-tiled on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;   // 16 x 16: ty a row group, tx a key group
constexpr int F32_BQ = 64;         // queries a block

constexpr int F32_BK = 64;         // keys a tile

template <int HD>
struct F32Tile {
  static constexpr int NJ = F32_BK / 16;             // S columns a thread
  static constexpr int VW = HD >= 64 ? 4 : HD / 16;  // dims a V load
  static constexpr int NV = HD / (16 * VW);          // V loads a key
  static constexpr int QLD = HD + 4;  // Q and K row strides in floats: rows
  static constexpr int KLD = HD + 4;  // 4 banks apart
  static constexpr int PLD = F32_BK + 16;  // P rows 16 banks apart
  static constexpr size_t SMEM =
      4 * ((size_t)F32_BQ * QLD + (size_t)F32_BK * (KLD + HD) +
           (size_t)F32_BQ * PLD);
};

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VW]) {
  if constexpr (VW == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (VW == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int H, int KV, int Sq, int Sk, int seq_q, int seq_k,
                     int causal, int window, float softcap, float scale) {
  using T = F32Tile<HD>;
  constexpr int BQ = F32_BQ, BK = F32_BK, NJ = T::NJ, VW = T::VW;
  constexpr int NV = T::NV, QLD = T::QLD, KLD = T::KLD, PLD = T::PLD;
  constexpr int C4 = HD / 4;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                  // [BQ][QLD]
  float* ks = qs + BQ * QLD;        // [BK][KLD]
  float* vs = ks + BK * KLD;        // [BK][HD]
  float* ps = vs + BK * HD;         // [BQ][PLD]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* qb = q + ((long long)b * H + h) * Sq * HD;
  const float* kb = k + ((long long)b * KV + kvh) * Sk * HD;
  const float* vb = v + ((long long)b * KV + kvh) * Sk * HD;

  // the key tiles that hold a live key of some live row of this block
  const int row_hi = min(q0 + BQ, seq_q) - 1;
  int t_lo = 0, t_hi = (seq_k + BK - 1) / BK;
  if (causal) t_hi = min(t_hi, row_hi / BK + 1);
  if (window > 0) t_lo = max(0, q0 - window + 1) / BK;
  const int n_t = row_hi < q0 ? 0 : t_hi - t_lo;

  float acc[4][NV * VW], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NV * VW; ++e) acc[i][e] = 0.f;
  }

  // one commit group per K tile and per V tile (empty past the last), so
  // that waiting for all but the newest group waits for the older tile
  const int t_end = t_lo + n_t;
  auto load_rows = [&](float* dst, int ld, const float* src, int t) {
    if (t < t_end) {
      const int k0 = t * BK;
      for (int i = tid; i < BK * C4; i += F32_THREADS) {
        const int j = i / C4, off = (i % C4) * 4;
        const bool in = k0 + j < Sk;
        cp_async16(dst + j * ld + off,
                   src + (long long)(in ? k0 + j : 0) * HD + off, in);
      }
    }
    cp_async_commit();
  };
  if (n_t > 0) {
    for (int i = tid; i < BQ * C4; i += F32_THREADS) {
      const int r = i / C4, off = (i % C4) * 4;
      const bool in = q0 + r < Sq;
      cp_async16(qs + r * QLD + off,
                 qb + (long long)(in ? q0 + r : 0) * HD + off, in);
    }
    load_rows(ks, KLD, kb, t_lo);     // group: Q and K(t_lo)
    load_rows(vs, HD, vb, t_lo);      // group: V(t_lo)
  }

  for (int t = t_lo; t < t_end; ++t) {
    cp_async_wait<1>();               // K(t) is in; V(t) may be in flight
    __syncthreads();

    // S = Q K^T: rows ty + 16i, keys tx + 16j
    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QLD + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * KLD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    __syncthreads();                  // K is free: the next tile loads
    load_rows(ks, KLD, kb, t + 1);

    // online softmax; a row's 16 threads are one half of a warp
    const int k0 = t * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = is_live(row, k0 + tx + 16 * j, seq_q, seq_k, causal, window)
                      ? x
                      : REPRO_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = is_live(row, col, seq_q, seq_k, causal, window)
                            ? expf(s[i][j] - m_new)
                            : 0.f;
        ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NV * VW; ++e) acc[i][e] *= alpha;
    }
    cp_async_wait<1>();               // V(t) is in; K(t+1) may be in flight
    __syncthreads();

    // O += P V: rows ty + 16i, dims n * 16 * VW + tx * VW + e
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float x[VW];
        load_vec<VW>(vs + c * HD + n * 16 * VW + tx * VW, x);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][n * VW + e] = fmaf(pr[i], x[e], acc[i][n * VW + e]);
      }
    }
    __syncthreads();                  // V and P are free
    load_rows(vs, HD, vb, t + 1);
  }

  float* ob = o + ((long long)b * H + h) * Sq * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float lf = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        ob[(long long)row * HD + n * 16 * VW + tx * VW + e] =
            acc[i][n * VW + e] / lf;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Sk, int seq_q,
                       int seq_k, int causal, int window, float softcap,
                       int device, cudaStream_t stream) {
  constexpr size_t smem = F32Tile<HD>::SMEM;
  static unsigned long long smem_set = 0;
  cudaError_t err =
      allow_smem(flash_fwd_f32_kernel<HD>, smem_set, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + F32_BQ - 1) / F32_BQ, H, B);
  flash_fwd_f32_kernel<HD><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, Sq, Sk,
      seq_q, seq_k, causal, window, softcap,
      1.f / sqrtf(static_cast<float>(HD)));
  return cudaSuccess;
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int KV, int Sq, int Sk,
                         int hd, int seq_q, int seq_k, int causal, int window,
                         float softcap, int device, cudaStream_t s) {
#define REPRO_F32_CASE(HD)                                                \
  case HD:                                                                \
    return launch_f32<HD>(q, k, v, o, B, H, KV, Sq, Sk, seq_q, seq_k,     \
                          causal, window, softcap, device, s);
  switch (hd) {
    REPRO_F32_CASE(16)
    REPRO_F32_CASE(32)
    REPRO_F32_CASE(64)
    REPRO_F32_CASE(128)
    REPRO_F32_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_F32_CASE
}

}  // namespace

// Sq > 1: the register-tiled kernel for fp32, the shared-memory kernel for
// bf16. Returns cudaGetLastError() after the launch (0 = launched).
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
    err = dispatch_f32(q, k, v, o, B, H, KV, Sq, Sk, hd, seq_q, seq_k,
                       causal, window, softcap, device, s);
  else if (dtype == REPRO_BF16)
    err = dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, hd, seq_q,
                                     seq_k, causal, window, softcap, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
