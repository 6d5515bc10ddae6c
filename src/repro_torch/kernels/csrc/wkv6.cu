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
// Two kernels, chosen by the number of tokens. Both are exact token-serial
// arithmetic in fp32, the state never leaving registers between s0 and s_T;
// the TPU kernel's chunked form (pairwise decays within a chunk as
// differences of prefix sums) is not used, because where logw sits at its
// floor -e^5 those differences lose ~5e-4 to fp32 rounding. Nor do the
// tensor cores help: the state is fp32 and held to atol 1e-4 / rtol 1e-3,
// and rounding the decayed k to bf16 for an mma would cost ~4e-3 relative
// a term. So the prefill kernel spends the card's parallelism, shared
// memory and asynchronous copies, not its tensor cores.
//
// Decode, T = 1 (`wkv6_kernel`, 75% of its byte bound). One block owns one
// (b, h); K threads each hold one column of S in K fp32 registers (each
// column evolves on its own). r_t, k_t and exp(logw_t) are staged in shared
// memory, double-buffered, one barrier a token.
//
// Prefill, T > 1 (`wkv6_prefill_kernel`). At 8 x 64 x 512 x 64 the work is
// 3 fp32 instructions a state element a token (y's FMA, k v's multiply,
// the decay's FMA), 3.2 G instructions, ~0.1 ms on the 132 SMs' FMA pipes;
// the decode kernel's one block of 64 threads a (b, h), a barrier a token
// and four shared loads per element ran at 17% of the byte bound. Here:
// - The bonus is hoisted: y_t[j] = sum_i r_i S_ij + beta_t v_j with beta_t =
//   sum_i r_i u_i k_i, computed once a token while staging.
// - A thread owns a 8 x 4 (rows x columns) tile of S at K = 64: 128
//   threads a block, 32 state registers a thread, ~4 blocks an SM. Per
//   token it reads its 8 rows of r, exp(logw), k and its 4 values of v
//   (7 16-byte shared loads, bank-free: a warp's 8 row groups read 128
//   contiguous bytes) for 96 FMA-class instructions. Rows of a thread are
//   in groups of 4 (rows 4 rg .. 4 rg + 3 and 32 + 4 rg ..).
// - y_t[j] is summed over the 8 row-group lanes of a column group in a
//   fixed order: two exchange steps that each halve the columns a lane
//   holds (xor 4, then xor 2), then one add (xor 1); four shuffles a token.
// - Chunks of C = 16 tokens of r, k, v and logw arrive in shared memory by
//   16-byte cp.async, the next chunk in flight while the current one is
//   computed; one staging pass a chunk widens them to fp32, takes
//   exp(logw) and beta once a (token, row), and there are two barriers a
//   chunk, none a token. y goes to shared memory and out coalesced a chunk
//   later. 31 KB of static shared memory (bf16), 37 KB (fp32).
// - The token loop is unrolled by 4, so one token's loads and shuffles
//   overlap the others' FMAs.
// On the H100 it runs at ~2.5x the FMA pipes' instruction-rate bound
// (PERF.md, chip_smoke.py phase 2b); tiles of 8 x 8 and 4 x 4 a thread,
// and a shorter unrolling, ran slower.
// Any T >= 1 (the last chunk may be short), no padding. wkv6_serial_ref in
// rwkv6.py repeats this order of operations in plain PyTorch.

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

template <int K>
struct WkvTile {
  static constexpr int NRG = K == 64 ? 8 : 4;  // row groups (lanes) a column
  static constexpr int COLS = 4;               // columns a thread
  static constexpr int LOG_COLS = 2;
  static constexpr int ROWS = K / NRG;         // rows a thread
  static constexpr int NT = NRG * (K / COLS);  // threads a block
  static constexpr int C = 16;                 // tokens a chunk
  static constexpr int L = K < 32 ? K : 32;    // lanes a token when staging
};

template <typename T, int K>
__global__ void __launch_bounds__(WkvTile<K>::NT)
wkv6_prefill_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ logw,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    T* __restrict__ y, float* __restrict__ s_T, int H,
                    int n_tok) {
  using W = WkvTile<K>;
  constexpr int NRG = W::NRG, COLS = W::COLS, ROWS = W::ROWS, NT = W::NT;
  constexpr int LOG_COLS = W::LOG_COLS;
  constexpr int C = W::C, L = W::L, EPP = 16 / (int)sizeof(T);
  constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1;
  static_assert(COLS % 4 == 0 && COLS == 1 << LOG_COLS && NRG % COLS == 0 &&
                    ROWS % 4 == 0, "tile shape");
  // raw chunk, as cp.async lands it
  __shared__ __align__(16) T r_raw[C * K], k_raw[C * K], v_raw[C * K];
  __shared__ __align__(16) float lw_raw[C * K];
  // the chunk the threads compute on, in fp32; w = exp(logw)
  __shared__ __align__(16) float r_s[C * K], w_s[C * K], k_s[C * K],
      v_s[C * K], y_s[C * K];
  __shared__ float beta_s[C], u_s[K];

  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int rg = tid % NRG, cg = tid / NRG;
  const long long base = (long long)bh * n_tok * K;   // (b, h, 0, 0)
  const long long sbase = (long long)bh * K * K;

  auto row_of = [](int q, int rgi, int e) { return q * NRG * 4 + rgi * 4 + e; };
  float S[ROWS][COLS];              // S[row_of(q, rg, e)][cg * COLS + c]
#pragma unroll
  for (int q = 0; q < ROWS / 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < COLS; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(
            s0 + sbase + (long long)row_of(q, rg, e) * K + cg * COLS + c);
        S[q * 4 + e][c] = x.x; S[q * 4 + e][c + 1] = x.y;
        S[q * 4 + e][c + 2] = x.z; S[q * 4 + e][c + 3] = x.w;
      }
  for (int i = tid; i < K; i += NT) u_s[i] = u[h * K + i];

  const int n_ch = (n_tok + C - 1) / C;
  auto load_raw = [&](int ch) {     // tokens past n_tok are zero-filled
    const long long off = base + (long long)ch * C * K;
    for (int p = tid; p < C * K / EPP; p += NT) {
      const bool in = ch * C + p * EPP / K < n_tok;
      const long long src = in ? off + (long long)p * EPP : base;
      cp_async16(r_raw + p * EPP, r + src, in);
      cp_async16(k_raw + p * EPP, k + src, in);
      cp_async16(v_raw + p * EPP, v + src, in);
    }
    for (int p = tid; p < C * K / 4; p += NT) {
      const bool in = ch * C + p * 4 / K < n_tok;
      cp_async16(lw_raw + p * 4, logw + (in ? off + p * 4 : base), in);
    }
    cp_async_commit();
  };
  load_raw(0);

  for (int ch = 0; ch < n_ch; ++ch) {
    const int t0 = ch * C, nt = min(C, n_tok - t0);
    cp_async_wait<0>();
    __syncthreads();                // chunk ch is in; chunk ch-1 is computed
    if (ch > 0)                     // chunk ch-1's y, a full chunk
      for (int e = tid; e < C * K; e += NT)
        y[base + (long long)(t0 - C) * K + e] = from_f<T>(y_s[e]);
    // stage: widen, exp(logw), beta_t = sum_i r_i u_i k_i (L lanes a token)
    for (int t = tid / L; t < C; t += NT / L) {
      float part = 0.f;
#pragma unroll
      for (int i = tid % L; i < K; i += L) {
        const int e = t * K + i;
        const float ri = to_f(r_raw[e]), ki = to_f(k_raw[e]);
        r_s[e] = ri;
        k_s[e] = ki;
        v_s[e] = to_f(v_raw[e]);
        w_s[e] = expf(lw_raw[e]);
        part = fmaf(ri * u_s[i], ki, part);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(MASK, part, off);
      if (tid % L == 0) beta_s[t] = part;
    }
    __syncthreads();                // staged; the raw buffer is free
    if (ch + 1 < n_ch) load_raw(ch + 1);

#pragma unroll 4
    for (int t = 0; t < nt; ++t) {  // four at a time: a token's loads and
      const float* rt = r_s + t * K; // shuffles overlap the others' FMAs
      const float* wt = w_s + t * K;
      const float* kt = k_s + t * K;
      float vv[COLS], a[COLS];
#pragma unroll
      for (int c = 0; c < COLS; c += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(v_s + t * K + cg * COLS + c);
        vv[c] = v4.x; vv[c + 1] = v4.y; vv[c + 2] = v4.z; vv[c + 3] = v4.w;
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) a[c] = 0.f;
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const int i0 = row_of(q, rg, 0);
        const float4 r4 = *reinterpret_cast<const float4*>(rt + i0);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + i0);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + i0);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            float& s = S[q * 4 + e][c];
            a[c] = fmaf(rr[e], s, a[c]);
            s = fmaf(ww[e], s, kk[e] * vv[c]);
          }
      }
      // sum a over the NRG row-group lanes: LOG_COLS steps that each halve
      // the columns a lane holds (xor NRG/2: the upper half of the lanes
      // keeps the upper half of the columns; then xor NRG/4, ...), then add
      // the lanes left; the lane ends with column sel
      int sel = 0;
#pragma unroll
      for (int step = 0; step < LOG_COLS; ++step) {
        const int half = COLS >> (step + 1), off = NRG >> (step + 1);
        const bool up = rg & off;
#pragma unroll
        for (int c = 0; c < half; ++c) {
          const float send = up ? a[c] : a[c + half];
          a[c] = (up ? a[c + half] : a[c]) + __shfl_xor_sync(MASK, send, off);
        }
        sel += up ? half : 0;
      }
#pragma unroll
      for (int off = NRG / COLS / 2; off > 0; off >>= 1)
        a[0] += __shfl_xor_sync(MASK, a[0], off);
      float vc = vv[0];
#pragma unroll
      for (int c = 1; c < COLS; ++c) vc = sel == c ? vv[c] : vc;
      if (rg % (NRG / COLS) == 0)
        y_s[t * K + cg * COLS + sel] = a[0] + beta_s[t] * vc;
    }
  }

  __syncthreads();                  // the last chunk's y
  const int t_last = (n_ch - 1) * C;
  for (int e = tid; e < (n_tok - t_last) * K; e += NT)
    y[base + (long long)t_last * K + e] = from_f<T>(y_s[e]);
#pragma unroll
  for (int q = 0; q < ROWS / 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < COLS; c += 4)
        *reinterpret_cast<float4*>(s_T + sbase +
                                   (long long)row_of(q, rg, e) * K +
                                   cg * COLS + c) =
            make_float4(S[q * 4 + e][c], S[q * 4 + e][c + 1],
                        S[q * 4 + e][c + 2], S[q * 4 + e][c + 3]);
}

template <typename T, int K>
void launch_k(const void* r, const void* k, const void* v, const void* logw,
              const void* u, const void* s0, void* y, void* s_T, int B,
              int H, int n_tok, cudaStream_t stream) {
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* lp = static_cast<const float*>(logw);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(s0);
  T* yp = static_cast<T*>(y);
  float* op = static_cast<float*>(s_T);
  if (n_tok == 1)
    wkv6_kernel<T, K><<<B * H, K, 0, stream>>>(rp, kp, vp, lp, up, sp, yp, op,
                                               H, n_tok);
  else
    wkv6_prefill_kernel<T, K><<<B * H, WkvTile<K>::NT, 0, stream>>>(
        rp, kp, vp, lp, up, sp, yp, op, H, n_tok);
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* y,
                   void* s_T, int B, int H, int n_tok, int K,
                   cudaStream_t stream) {
  switch (K) {
    case 16:
      launch_k<T, 16>(r, k, v, logw, u, s0, y, s_T, B, H, n_tok, stream);
      break;
    case 64:
      launch_k<T, 64>(r, k, v, logw, u, s0, y, s_T, B, H, n_tok, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// T = 1: the decode kernel; T > 1: the prefill kernel. Returns
// cudaGetLastError() after the launch (0 = launched).
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
