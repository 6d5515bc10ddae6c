// Attention's gradient, for Hopper (sm_90a): dq, dk and dv of the flash
// forward (flash_attention.cu) from (q, k, v, o, dO).
//
// The contract of `flash_attention_bwd_bhsd` (kernels/flash_attention.py):
// q, o, dO (B,H,Sq,hd) and k, v (B,KV,Sk,hd), all fp32 or all bf16, GQA kv
// head = h / (H/KV); the causal and local-window masks compare key j with
// the query's position row + q_off; keys past seq_k are dead (every query
// row is live: the gradient has no seq_q). With qs = q / sqrt(hd) (the
// scale folded into q, as the reference folds it) and s = qs . k:
//   lse   = the row's log-sum-exp of s over its live keys,
//   delta = (dO . o).sum(-1),
//   p     = exp(s - lse) on a live pair, else 0,
//   dv    = p^T dO,  dp = dO v^T,  ds = p (dp - delta),
//   dk    = ds^T qs, dq = (ds k) / sqrt(hd),
// all in fp32 on the CUDA cores, each gradient written in its input's
// dtype. A row with no live key gets lse = NEG_INF + log(1e-20) and zero
// gradients; a key past seq_k, or one that no row reads, zero dk and dv.
// This is `attention_lse` + `attention_bwd`, the port's plain version of
// the reference's `_flash_xla_bwd_inner`; `attention_bwd_tiled_ref` repeats
// this file's tiles and order of sums.
//
// What it replaces. The TPU package has no backward kernel: it trains
// attention through XLA's custom VJP (`_flash_xla`, models/attention.py).
// This is the gradient of the function its Pallas kernel
// src/repro/kernels/flash_attention.py (`flash_attention_bhsd`) computes,
// which `FlashAttention.backward` launches on CUDA tensors in place of the
// plain backward.
//
// What bounds it on the H100. `cost.flash_bwd_work` counts 10 hd operations
// a live pair (s, dv, dp, dq, dk); this kernel does 16 hd (s once more for
// lse, and s and dp again for dq). At recurrentgemma-2b's 8 x 10/1 x 2560,
// hd 256, window 2048, fp32, that is 0.64 TFLOP of the formula, 9.6 ms at
// the 67 TFLOP/s fp32 rate, against 0.2 GB of inputs and gradients: bounded
// by operations. TF32 tensor cores would miss the 2e-5 tolerance; the bf16
// form computes in fp32 as well (it is small and bound by latency).
//
// Design: three kernels in one counted launch, no float atomics, every sum
// in a fixed order, so two calls give the same bits.
// - Rows are the (query, head) pairs of a KV head, row r = query r / G of
//   head kvh * G + r % G (the bf16 forward kernel's rows): one K/V tile in
//   shared memory serves all G query heads of the group (recurrentgemma-2b's
//   MQA G = 10), and any G fills a tile.
// - (a) `flash_bwd_lse_kernel`, one block a (tile of BQ = 64 rows, KV head,
//   b): delta from o and dO, then lse by an online pass over the live
//   tiles of BKA = 64 keys (`live_key_tiles`), K double-buffered by
//   cp.async (fp32), a thread a 4 x 4 micro-tile of S (the fp32 forward
//   kernel's), a row's 16 threads half a warp.
// - (b) `flash_bwd_dkv_kernel`, one block a (tile of BK = 32 keys, KV head,
//   b): the tile's K and V stay in shared memory and its dK and dV in
//   registers (64 floats a thread at hd 256) while the block walks the row
//   tiles that hold a live row for it (`live_query_tiles`), in order; the
//   G heads' rows are summed inside the block, never across blocks. The
//   next row tile's dO loads during the dK sum, its Q during its dP.
// - (c) `flash_bwd_dq_kernel`, one block a (row tile, KV head, b): the
//   tile's qs and dO stay in shared memory and its dq in registers while the
//   block walks its live key tiles in order; the next V tile loads during
//   the dq sum, the next K during the next dP.
// - Bound by shared memory's 128 bytes a clock before the FMA units, so
//   each layout keeps a warp's loads few and wide (16-byte loads from rows
//   padded by 4 floats, on distinct banks). S and dP (64 x 32): a thread a
//   4 x 2 micro-tile, a warp a 16 x 16 block whose loads read 4
//   consecutive Q or dO rows and 8 K or V rows, 6 wavefronts for 1024 FMAs.
//   dK and dV in (b): a warp all 32 keys over hd / 8 dims, a lane 4 keys x
//   hd / 32 dims; per row 3 wavefronts of P or dS and dO or Q for 1024
//   FMAs. dq in (c): a warp 16 rows over hd / 2 dims, a lane 4 rows x hd /
//   16 dims, dS stored transposed so that a lane's 4 rows are one load.
// - Dead tiles are never loaded: a block walks only the tiles that may hold
//   a live pair; a masked pair inside a tile contributes an exact 0.
// Shared memory at hd 256: (a) 195 KB, (b) 215.5 KB, (c) 204 KB, one block
// an SM; bf16 tiles are widened to fp32 as they are staged, synchronously.

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;   // 16 x 16: ty a row group, tx a key group
constexpr int BQ = 64;         // rows a tile
constexpr int BK = 32;         // keys a tile of (b) and (c)
constexpr int BKA = 64;        // keys a tile of (a)
constexpr int LDP = BK + 8;    // P and dS rows [row][key]: 8 banks apart
constexpr int LDT = BQ + 4;    // dS rows [key][row] in (c): 4 banks apart

template <int HD>
struct BwdTile {
  static constexpr int LD = HD + 4;   // Q, dO, K and V rows: 4 banks apart
  static constexpr int VW = HD >= 64 ? 4 : HD / 16;   // dims a vector load
  static constexpr int NV = HD / (16 * VW);           // vector loads a row
  static constexpr int ND = NV * VW;                  // dims a thread sums
  // (b)'s sums: a lane's keys (KT) and dims (DT), of a warp's hd / 8 dims
  static constexpr int KT = HD >= 32 ? 4 : 2;
  static constexpr int DT = HD / 8 / KT;
  static constexpr size_t ROWS = (size_t)BQ * LD;     // floats of a row tile
  static constexpr size_t KEYS = (size_t)BK * LD;     // floats of a key tile
  static constexpr size_t KEYS_A = (size_t)BKA * LD;  // of (a)'s key tile
  // (a): Q, two K tiles; (b): K, V, Q, dO, P, dS, lse, delta; (c): Q, dO,
  // K, V, dS, lse, delta
  static constexpr size_t SMEM_LSE = 4 * (ROWS + 2 * KEYS_A);
  static constexpr size_t SMEM_DKV =
      4 * (2 * KEYS + 2 * ROWS + 2 * (size_t)BQ * LDP + 2 * BQ);
  static constexpr size_t SMEM_DQ =
      4 * (2 * ROWS + 2 * KEYS + (size_t)BK * LDT + 2 * BQ);
};

struct Geo {
  int H, KV, G, Sq, Sk, seq_k, causal, window, q_off;
  float scale;
};

__device__ __forceinline__ bool live_pair(const Geo& g, int query, int key) {
  const int p = query + g.q_off;   // the query's global position
  bool ok = key < g.seq_k;
  if (g.causal) ok = ok && key <= p;
  if (g.window > 0) ok = ok && key > p - g.window;
  return ok;
}

// element offset of row r of (b, kvh) in q, o, dO (B,H,Sq,hd), over hd
__device__ __forceinline__ long long row_of(const Geo& g, int b, int kvh,
                                            int r) {
  return ((long long)b * g.H + (long long)kvh * g.G + r % g.G) * g.Sq +
         r / g.G;
}

// the tiles [t_lo, t_hi) of bk keys a row tile from r0 may read
// (live_key_tiles)
template <int bk = BK>
__device__ __forceinline__ int2 key_tiles(const Geo& g, int r0) {
  const int n_rows = g.G * g.Sq;
  const int row_lo = r0 / g.G;
  const int row_hi = (min(r0 + BQ, n_rows) - 1) / g.G;
  int t_lo = 0, t_hi = (g.seq_k + bk - 1) / bk;
  if (g.causal) t_hi = min(t_hi, (row_hi + g.q_off) / bk + 1);
  if (g.window > 0) t_lo = max(0, row_lo + g.q_off - g.window + 1) / bk;
  return make_int2(t_lo, row_hi < row_lo ? t_lo : max(t_lo, t_hi));
}

// the row tiles [u_lo, u_hi) that may hold a live row for keys k0.. of a
// key tile (live_query_tiles): queries from the first that the causal mask
// lets read key k0 to the last whose window reaches the tile's last key
__device__ __forceinline__ int2 row_tiles(const Geo& g, int k0) {
  const int key_hi = min(k0 + BK, g.seq_k) - 1;
  if (key_hi < k0) return make_int2(0, 0);
  const int lo = g.causal ? max(0, k0 - g.q_off) : 0;
  int hi = g.Sq;
  if (g.window > 0) hi = min(hi, key_hi - g.q_off + g.window);
  if (hi <= lo) return make_int2(0, 0);
  return make_int2((int)((long long)lo * g.G / BQ),
                   (int)(((long long)hi * g.G + BQ - 1) / BQ));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
  return make_float4(to_f(h[0]), to_f(h[1]), to_f(h[2]), to_f(h[3]));
}

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VW]) {
  if constexpr (VW == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 c = *reinterpret_cast<const float4*>(p + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
  } else if constexpr (VW == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (VW == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

// Stage n rows of hd elements into dst (rows LD floats apart) as fp32: row
// j from src + off(j) (off(j) < 0: zeros). fp32 rows come by cp.async (the
// caller commits and waits; `rescale` then applies ``scale``), bf16 rows by
// 16-byte loads widened and multiplied by ``scale`` here.
template <typename T, int HD, typename Off>
__device__ __forceinline__ void stage(float* dst, const T* src, int n,
                                      Off off, float scale) {
  constexpr int LD = BwdTile<HD>::LD;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int C = HD / 4;
    for (int i = threadIdx.x; i < n * C; i += THREADS) {
      const int j = i / C, d = (i % C) * 4;
      const long long o = off(j);
      cp_async16(dst + j * LD + d, src + (o < 0 ? 0 : o + d), o >= 0);
    }
  } else {
    constexpr int C = HD / 8;
    for (int i = threadIdx.x; i < n * C; i += THREADS) {
      const int j = i / C, d = (i % C) * 8;
      const long long o = off(j);
      float x[8];
      if (o >= 0) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + o + d);
        const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = to_f(h[e]) * scale;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
      *reinterpret_cast<float4*>(dst + j * LD + d) =
          make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(dst + j * LD + d + 4) =
          make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

// After the cp.async groups of an fp32 `stage` are waited for: multiply the
// pieces this thread staged by ``scale`` (its own copies are visible to it).
template <typename T, int HD>
__device__ __forceinline__ void rescale(float* dst, int n, float scale) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int LD = BwdTile<HD>::LD, C = HD / 4;
    for (int i = threadIdx.x; i < n * C; i += THREADS) {
      float4* p = reinterpret_cast<float4*>(dst + (i / C) * LD + (i % C) * 4);
      float4 x = *p;
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
      *p = x;
    }
  }
}

// lse and delta of the tile's rows r0.. into shared memory (0 past the end)
__device__ __forceinline__ void stage_rows_stats(const Geo& g, int b, int kvh,
                                                 int r0, const float* lse,
                                                 const float* delta,
                                                 float* lse_s, float* dl_s) {
  const int j = threadIdx.x;
  if (j < BQ) {
    const int r = r0 + j;
    const bool in = r < g.G * g.Sq;
    const long long i = in ? row_of(g, b, kvh, r) : 0;
    lse_s[j] = in ? lse[i] : 0.f;
    dl_s[j] = in ? delta[i] : 0.f;
  }
}

// acc[i][j] = xs[ra + 4i] . ys[ka + 8j] (rows LD floats apart), over hd in
// steps of 4, sequential fp32 FMAs: a (b)/(c) thread's 4 x 2 micro-tile of a
// 64 x 32 product, its rows and keys strided so that each of a warp's loads
// reads 4 (rows) or 8 (keys) consecutive rows, on distinct banks
template <int HD>
__device__ __forceinline__ void dots(const float* xs, const float* ys, int ra,
                                     int ka, float (&acc)[4][2]) {
  constexpr int LD = BwdTile<HD>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], c[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(xs + (ra + 4 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 2; ++j) c[j] = load4(ys + (ka + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[i][j] = fmaf(a[i].x, c[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, c[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, c[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, c[j].w, acc[i][j]);
      }
  }
}

// The products' thread layout in (b) and (c): warp w owns rows (w / 2) 16 ..
// + 15 and keys (w % 2) 16 .. + 15 of the tile; lane l rows ra + 4i (ra =
// that + l / 8) and keys ka + 8j (ka = that + l % 8).
__device__ __forceinline__ int2 dots_origin() {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  return make_int2((w / 2) * 16 + l / 8, (w % 2) * 16 + l % 8);
}

// p and ds of a thread's micro-tile (tile rows ra + 4i from r0, keys ka + 8j
// from k0): p = exp(s - lse) and ds = p (dp - delta) on a live pair, exact
// zeros elsewhere; p to ps[row][key] (if given), ds to dss[row][key] (rows
// LDP apart) or, TRANS, to dss[key][row] (rows LDT apart)
template <bool TRANS>
__device__ __forceinline__ void probs(const Geo& g, int r0, int k0, int ra,
                                      int ka, const float (&s)[4][2],
                                      const float (&dp)[4][2],
                                      const float* lse_s, const float* dl_s,
                                      float* ps, float* dss) {
  const int n_rows = g.G * g.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ra + 4 * i, r = r0 + rr;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cc = ka + 8 * j;
      const bool live = r < n_rows && live_pair(g, r / g.G, k0 + cc);
      const float p = live ? expf(s[i][j] - lse_s[rr]) : 0.f;
      const float ds = live ? p * (dp[i][j] - dl_s[rr]) : 0.f;
      if (ps != nullptr) ps[rr * LDP + cc] = p;
      if constexpr (TRANS)
        dss[cc * LDT + rr] = ds;
      else
        dss[rr * LDP + cc] = ds;
    }
  }
}

// ---------------------------------------------------------------------------
// (a) lse and delta
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_lse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ o, const T* __restrict__ dO,
                     float* __restrict__ lse, float* __restrict__ delta,
                     Geo g) {
  using Tl = BwdTile<HD>;
  constexpr int LD = Tl::LD;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                       // [BQ][LD]
  float* kbuf = qs + Tl::ROWS;          // [2][BKA][LD]
  const int r0 = blockIdx.x * BQ, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_rows = g.G * g.Sq;
  const long long kv0 = ((long long)b * g.KV + kvh) * g.Sk;

  // delta: a row's 16 threads (half a warp) split its dims
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    float sum = 0.f;
    if (r < n_rows) {
      const long long base = row_of(g, b, kvh, r) * HD;
      for (int d = tx * 4; d < HD; d += 64) {
        const float4 x = load4(o + base + d), y = load4(dO + base + d);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tx == 0 && r < n_rows) delta[row_of(g, b, kvh, r)] = sum;
  }

  const int2 tr = key_tiles<BKA>(g, r0);
  auto r_off = [&](int j) {
    return r0 + j < n_rows ? row_of(g, b, kvh, r0 + j) * HD : -1ll;
  };
  auto k_at = [&](int t) {
    return [=](int j) {
      const int key = t * BKA + j;
      return key < g.Sk ? (kv0 + key) * HD : -1ll;
    };
  };
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
  }
  if (tr.y > tr.x) {
    stage<T, HD>(qs, q, BQ, r_off, g.scale);
    stage<T, HD>(kbuf, k, BKA, k_at(tr.x), 1.f);
  }
  cp_async_commit();
  for (int t = tr.x; t < tr.y; ++t) {
    const float* ks = kbuf + ((t - tr.x) & 1) * Tl::KEYS_A;
    if (t + 1 < tr.y)
      stage<T, HD>(kbuf + ((t + 1 - tr.x) & 1) * Tl::KEYS_A, k, BKA,
                   k_at(t + 1), 1.f);
    cp_async_commit();
    cp_async_wait<1>();                 // Q and K(t) are in
    if (t == tr.x) rescale<T, HD>(qs, BQ, g.scale);
    __syncthreads();
    // s[i][j] = qs[ty + 16i] . ks[tx + 16j]: a 4 x 4 micro-tile, a row's
    // 64 keys in one half warp, so its max and sum are shuffles
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = load4(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }
    const int k0 = t * BKA;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 16 * i;
      bool live[4];
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        live[j] = r < n_rows && live_pair(g, r / g.G, k0 + tx + 16 * j);
        if (live[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (live[j]) sum += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
    __syncthreads();                    // K(t)'s buffer is free
  }
  cp_async_wait<0>();
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 16 * i;
      if (r < n_rows)
        lse[row_of(g, b, kvh, r)] = m[i] + logf(fmaxf(l[i], 1e-20f));
    }
  }
}

// ---------------------------------------------------------------------------
// (b) dk and dv, a key tile a block
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Geo g) {
  using Tl = BwdTile<HD>;
  constexpr int LD = Tl::LD, KT = Tl::KT, DT = Tl::DT, DW = HD / 8;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                       // [BK][LD]
  float* vs = ks + Tl::KEYS;            // [BK][LD]
  float* qs = vs + Tl::KEYS;            // [BQ][LD]
  float* dos = qs + Tl::ROWS;           // [BQ][LD]
  float* ps = dos + Tl::ROWS;           // [BQ][LDP]
  float* dss = ps + BQ * LDP;           // [BQ][LDP]
  float* lse_s = dss + BQ * LDP;        // [BQ]
  float* dl_s = lse_s + BQ;             // [BQ]
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = g.G * g.Sq;
  const long long kv0 = ((long long)b * g.KV + kvh) * g.Sk;
  const int2 org = dots_origin();
  // the sums' layout: warp w owns dims w DW .. + DW - 1 of all 32 keys;
  // lane l keys kl KT .. + KT - 1 and dims w DW + dl DT .. + DT - 1
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kl = lane / KT, dl = lane % KT;
  const int d0 = w * DW + dl * DT;

  float dka[KT][DT], dva[KT][DT];
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int e = 0; e < DT; ++e) dka[i][e] = dva[i][e] = 0.f;

  const int2 ut = row_tiles(g, k0);
  auto r_off = [&](int u) {
    return [=](int j) {
      const int r = u * BQ + j;
      return r < n_rows ? row_of(g, b, kvh, r) * HD : -1ll;
    };
  };
  // groups: {K, V, dO(u), stats(u)} then {Q(u)}; dO(u + 1) loads during
  // the dk sum, Q(u + 1) during the next tile's dp
  if (ut.y > ut.x) {
    auto k_off = [&](int j) {
      return k0 + j < g.Sk ? (kv0 + k0 + j) * HD : -1ll;
    };
    stage<T, HD>(ks, k, BK, k_off, 1.f);
    stage<T, HD>(vs, v, BK, k_off, 1.f);
    stage<T, HD>(dos, dO, BQ, r_off(ut.x), 1.f);
    stage_rows_stats(g, b, kvh, ut.x * BQ, lse, delta, lse_s, dl_s);
    cp_async_commit();
    stage<T, HD>(qs, q, BQ, r_off(ut.x), g.scale);
    cp_async_commit();
  }
  for (int u = ut.x; u < ut.y; ++u) {
    const int r0 = u * BQ;
    cp_async_wait<1>();                 // K, V, dO(u) are in
    __syncthreads();
    float s[4][2], dp[4][2];
    dots<HD>(dos, vs, org.x, org.y, dp);
    cp_async_wait<0>();                 // Q(u) is in
    rescale<T, HD>(qs, BQ, g.scale);
    __syncthreads();
    dots<HD>(qs, ks, org.x, org.y, s);
    probs<false>(g, r0, k0, org.x, org.y, s, dp, lse_s, dl_s, ps, dss);
    __syncthreads();

    // dv[key] += p[row][key] dO[row], then dk[key] += ds[row][key]
    // qs[row], rows in order
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pr[KT], x[DT];
      load_vec<KT>(ps + c * LDP + kl * KT, pr);
      load_vec<DT>(dos + c * LD + d0, x);
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int e = 0; e < DT; ++e) dva[i][e] = fmaf(pr[i], x[e], dva[i][e]);
    }
    __syncthreads();                    // dO(u) and the stats are free
    if (u + 1 < ut.y) {
      stage<T, HD>(dos, dO, BQ, r_off(u + 1), 1.f);
      stage_rows_stats(g, b, kvh, r0 + BQ, lse, delta, lse_s, dl_s);
    }
    cp_async_commit();
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float dr[KT], y[DT];
      load_vec<KT>(dss + c * LDP + kl * KT, dr);
      load_vec<DT>(qs + c * LD + d0, y);
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int e = 0; e < DT; ++e) dka[i][e] = fmaf(dr[i], y[e], dka[i][e]);
    }
    __syncthreads();                    // Q(u), P and dS are free
    if (u + 1 < ut.y) stage<T, HD>(qs, q, BQ, r_off(u + 1), g.scale);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < KT; ++i) {
    const int key = k0 + kl * KT + i;
    if (key >= g.Sk) continue;
    const long long base = (kv0 + key) * HD + d0;
#pragma unroll
    for (int e = 0; e < DT; ++e) {
      dk[base + e] = from_f<T>(dka[i][e]);
      dv[base + e] = from_f<T>(dva[i][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dq, a row tile a block
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Geo g) {
  using Tl = BwdTile<HD>;
  constexpr int LD = Tl::LD, VW = Tl::VW, NV = Tl::NV, ND = Tl::ND;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                       // [BQ][LD]
  float* dos = qs + Tl::ROWS;           // [BQ][LD]
  float* ks = dos + Tl::ROWS;           // [BK][LD]
  float* vs = ks + Tl::KEYS;            // [BK][LD]
  float* dst = vs + Tl::KEYS;           // [BK][LDT]: dS transposed
  float* lse_s = dst + BK * LDT;        // [BQ]
  float* dl_s = lse_s + BQ;             // [BQ]
  const int r0 = blockIdx.x * BQ, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = g.G * g.Sq;
  const long long kv0 = ((long long)b * g.KV + kvh) * g.Sk;
  const int2 org = dots_origin();
  // the sum's layout: warp w owns rows (w / 2) 16 .. + 15 and dims (w % 2)
  // hd / 2 .. of them; lane l rows rq .. rq + 3 (rq = that + 4 (l / 8)) and
  // dims dq0 + n 8 VW + e (dq0 = that + (l % 8) VW)
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rq = (w / 2) * 16 + 4 * (lane / 8);
  const int dq0 = (w % 2) * (HD / 2) + (lane % 8) * VW;

  float dqa[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < ND; ++e) dqa[i][e] = 0.f;

  const int2 tr = key_tiles(g, r0);
  auto k_at = [&](int t) {
    return [=](int j) {
      const int key = t * BK + j;
      return key < g.Sk ? (kv0 + key) * HD : -1ll;
    };
  };
  // groups: {Q, dO, stats, V(t)} then {K(t)}; V(t + 1) loads during the dq
  // sum, K(t + 1) during the next tile's dp
  if (tr.y > tr.x) {
    auto r_off = [&](int j) {
      return r0 + j < n_rows ? row_of(g, b, kvh, r0 + j) * HD : -1ll;
    };
    stage<T, HD>(qs, q, BQ, r_off, g.scale);
    stage<T, HD>(dos, dO, BQ, r_off, 1.f);
    stage_rows_stats(g, b, kvh, r0, lse, delta, lse_s, dl_s);
    stage<T, HD>(vs, v, BK, k_at(tr.x), 1.f);
    cp_async_commit();
    stage<T, HD>(ks, k, BK, k_at(tr.x), 1.f);
    cp_async_commit();
  }
  for (int t = tr.x; t < tr.y; ++t) {
    const int k0 = t * BK;
    cp_async_wait<1>();                 // V(t) (and Q, dO) are in
    if (t == tr.x) rescale<T, HD>(qs, BQ, g.scale);
    __syncthreads();
    float s[4][2], dp[4][2];
    dots<HD>(dos, vs, org.x, org.y, dp);
    cp_async_wait<0>();                 // K(t) is in
    __syncthreads();
    dots<HD>(qs, ks, org.x, org.y, s);
    probs<true>(g, r0, k0, org.x, org.y, s, dp, lse_s, dl_s, nullptr, dst);
    __syncthreads();                    // V(t) is free
    if (t + 1 < tr.y) stage<T, HD>(vs, v, BK, k_at(t + 1), 1.f);
    cp_async_commit();

    // dq[row] += ds[row][key] k[key], keys in order
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 d4 = load4(dst + c * LDT + rq);
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float x[VW];
        load_vec<VW>(ks + c * LD + dq0 + n * 8 * VW, x);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            dqa[i][n * VW + e] = fmaf(dr[i], x[e], dqa[i][n * VW + e]);
      }
    }
    __syncthreads();                    // K(t) and dS are free
    if (t + 1 < tr.y) stage<T, HD>(ks, k, BK, k_at(t + 1), 1.f);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + rq + i;
    if (r >= n_rows) continue;
    const long long base = row_of(g, b, kvh, r) * HD + dq0;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        dq[base + n * 8 * VW + e] = from_f<T>(dqa[i][n * VW + e] * g.scale);
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dO, void* dq, void* dk,
                       void* dv, float* lse, float* delta, int B,
                       const Geo& g, int device, cudaStream_t stream) {
  using Tl = BwdTile<HD>;
  static unsigned long long set_lse = 0, set_dkv = 0, set_dq = 0;
  cudaError_t err = allow_smem(flash_bwd_lse_kernel<T, HD>, set_lse, device,
                               Tl::SMEM_LSE);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dkv_kernel<T, HD>, set_dkv, device,
                     Tl::SMEM_DKV);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_kernel<T, HD>, set_dq, device,
                     Tl::SMEM_DQ);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dO);
  const long long n_rows = (long long)g.G * g.Sq;
  const dim3 rows((unsigned)((n_rows + BQ - 1) / BQ), g.KV, B);
  const dim3 keys((unsigned)((g.Sk + BK - 1) / BK), g.KV, B);
  if (rows.x > 0) {
    flash_bwd_lse_kernel<T, HD><<<rows, THREADS, Tl::SMEM_LSE, stream>>>(
        qt, kt, static_cast<const T*>(o), dot, lse, delta, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (keys.x > 0) {
    flash_bwd_dkv_kernel<T, HD><<<keys, THREADS, Tl::SMEM_DKV, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (rows.x > 0) {
    flash_bwd_dq_kernel<T, HD><<<rows, THREADS, Tl::SMEM_DQ, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* dO, void* dq, void* dk,
                         void* dv, float* lse, float* delta, int B, int hd,
                         const Geo& g, int device, cudaStream_t s) {
#define REPRO_BWD_CASE(HD)                                                 \
  case HD:                                                                 \
    return launch_bwd<T, HD>(q, k, v, o, dO, dq, dk, dv, lse, delta, B, g, \
                             device, s);
  switch (hd) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}

}  // namespace

// dq, dk, dv (in the inputs' dtype) from q, k, v, o, dO, all contiguous;
// lse and delta are fp32 scratch of B * H * Sq each. Three kernels on
// ``stream``; returns the first launch error (0 = launched).
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dO, void* dq,
                               void* dk, void* dv, void* lse, void* delta,
                               int B, int H, int KV, int Sq, int Sk, int hd,
                               int seq_k, int causal, int window, int q_off,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  const Geo g{H, KV, H / KV, Sq, Sk, seq_k, causal, window, q_off,
              1.f / sqrtf(static_cast<float>(hd))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == REPRO_F32)
    return dispatch_bwd<float>(q, k, v, o, dO, dq, dk, dv, l, d, B, hd, g,
                               device, s);
  if (dtype == REPRO_BF16)
    return dispatch_bwd<bf16>(q, k, v, o, dO, dq, dk, dv, l, d, B, hd, g,
                              device, s);
  return cudaErrorInvalidValue;
}
