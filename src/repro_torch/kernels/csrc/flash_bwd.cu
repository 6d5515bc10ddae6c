// Attention's gradient, for Hopper (sm_90a): dq, dk and dv of the flash
// forward (flash_attention.cu) from (q, k, v, o, dO) and the forward's lse.
//
// The contract of `flash_attention_bwd_bhsd` (kernels/flash_attention.py):
// q, o, dO (B,H,Sq,hd) and k, v (B,KV,Sk,hd), all fp32 or all bf16, GQA kv
// head = h / (H/KV); lse (B,H,Sq) fp32, each row's log-sum-exp of its live
// scaled scores as the forward kernels write it (`return_lse`); the causal
// and local-window masks compare key j with the query's position row +
// q_off; keys past seq_k are dead (every query row is live: the gradient
// has no seq_q). With s = (q . k) scale, scale = 1 / sqrt(hd), in fp32 (the
// forward's scores):
//   delta = (dO . o).sum(-1),
//   p     = exp(s - lse) on a live pair, else 0,
//   dv    = p^T dO,  dp = dO v^T,  ds = p (dp - delta),
//   dk    = (ds^T q) scale, dq = (ds k) scale,
// each gradient written in its input's dtype; a row with no live key (lse
// = NEG_INF + log(1e-20)) gets zero dq, a key past seq_k or that no row
// reads zero dk and dv. This is `attention_bwd`, the port's plain version
// of the reference's `_flash_xla_bwd_inner`, which also reads the lse its
// forward saved; `attention_bwd_tiled_ref` repeats this file's tiles,
// order of sums and roundings.
//
// What it replaces. The TPU package has no backward kernel: it trains
// attention through XLA's custom VJP (`_flash_xla`, models/attention.py).
// This is the gradient of the function its Pallas kernel
// src/repro/kernels/flash_attention.py (`flash_attention_bhsd`) computes,
// which `FlashAttention.backward` launches on CUDA tensors in place of the
// plain backward.
//
// What bounds it on the H100. `cost.flash_bwd_work` counts 10 hd operations
// a live pair (s, dv, dp, dq, dk); this kernel does 14 (s and dp once more
// for dq), all on the tensor cores, so at the training shapes both forms
// are bound by operations at the tensor cores' rates:
// - bf16: `mma.sync.m16n8k16`, bf16 in, fp32 accumulate. P and dS are
//   rounded to bf16 before their products, as FlashAttention-2 and the
//   forward's P are (2^-9 relative a term, inside the 2e-2 tolerance).
// - fp32: `mma.sync.m16n8k8` in TF32 with a three-product split: each
//   operand x is hi = x rounded to TF32 and lo = x - hi (read by the tensor
//   cores to TF32), and a . b takes lo.hi' + hi.lo' + hi.hi' (CUTLASS's
//   `OpMultiplyAddFastF32`). One TF32 product keeps 11 bits and misses the
//   2e-5 tolerance; the split keeps about 21, fp32's order (errors near
//   2e-6 of each gradient's max), at three times the tensor work: 495 / 3
//   = 165 TFLOP/s of fp32 products (`roofline.PEAK_FLOPS_SPLIT_TF32`, the
//   fp32 form's bound), still ahead of the 67 TFLOP/s of fp32 FMA that
//   bounded the CUDA-core kernel before it. The split is made in registers after
//   the shared-memory load, so tiles do not double. The tensor cores'
//   fp32 accumulation truncates: summed into one accumulator over a long
//   sequence (25,600 rows into a dV) it drifts 2e-4 of the max, so every
//   sum runs in short partials on the tensor cores (a step, or 4 k-steps),
//   each added to its total in fp32.
// Measured (chip_smoke.py's gradient records, PERF.md): the fp32 form runs
// under sdpa's backward, the bf16 one within 1.4-2.1x of it; both far from
// their bounds, reckoned held by the latency of a block's walk of
// dependent steps (the card has no profiler of stalls).
//
// Design: three kernels in one counted launch (five where walks are cut),
// no float atomics, every sum in a fixed order, so two calls give the same
// bits.
// - Rows are the (query, head) pairs of a KV head, row r = query r / G of
//   head kvh * G + r % G (the forward's rows): one K/V tile in shared
//   memory serves all G query heads of the group (recurrentgemma-2b's MQA
//   G = 10), and any G fills a tile.
// - (a) `flash_bwd_delta_kernel`: delta of each row, fp32, a row's 16-byte
//   pieces over up to 32 lanes. lse is the forward's: no pass over K.
// - (b) `flash_bwd_dkv_kernel`, one block a (tile of 64 keys, KV head,
//   segment, b), a warp 16 keys: K and V stay in shared memory (bf16 at hd
//   <= 64: their fragments in registers) while the block walks its row
//   tiles of `STEP` rows that hold a live row for the keys
//   (`live_query_tiles`), in order, Q and dO double-buffered by cp.async.
//   A warp takes S^T = K Q^T and dP^T = V dO^T into registers, P^T and
//   dS^T on the fragments, and feeds them as the A operand of dV += P^T dO
//   and dK += dS^T Q (the accumulator's layout is the A fragment's: bf16
//   packs two, TF32 permutes k the same way in A and B), so P and dS never
//   touch shared memory.
// - (c) `flash_bwd_dq_kernel`, one block a (tile of 64 rows, KV head,
//   segment, b), a warp 16 rows: Q and dO stay in shared memory (bf16 at
//   hd <= 64: in registers) while the block walks its live key tiles of
//   `STEP` keys in order (`live_key_tiles`), K and V double-buffered: S = Q
//   K^T, dP = dO V^T, dS on the fragments, dq += dS K.
// - Segments: causal, the first key tile walks every row tile and the last
//   a few, and one block's walk of dependent steps set the launch's time.
//   (b) cuts every key tile's walk into runs of `seg` row tiles, at most 4
//   for the longest, each a block writing fp32 sums; (b')
//   `flash_bwd_dkv_sum_kernel` adds them in segment order. (c) does the
//   same (`flash_bwd_dq_sum_kernel`, (c')) only where its grid is short.
//   The cuts are the caller's, from the shapes alone (`bwd_segments`,
//   flash_attention.py); the kernel takes them as given.
// - hd 256: dK and dV of 16 keys take 128 + 128 fp32 registers a lane, so
//   two warps share a warp's keys (rows), each half the dims: each sums
//   the scores over its half, the pair swaps the partial scores through
//   shared memory and both add them in one order, then each accumulates
//   its half. 8 warps a block, no score recomputed.
// - `STEP` is 64 at small hd (bf16 <= 64, fp32 <= 32), 32 at the next and
//   16 above, so the held tiles, two stages of the walked ones, (b)'s lse
//   and delta and the pairs' exchange fit one SM: at hd 256 fp32 (b) and
//   (c) take 212 KB. Shared rows are padded by 16 bytes, so ldmatrix's 8
//   row addresses and TF32's scalar B loads (rows 2t, 2t + 1, column g)
//   hit distinct banks.
// - Tiles with no live pair are never loaded; a warp whose 16 keys (rows)
//   have no live pair in a loaded tile skips its products, and masks are
//   applied only where the warp's pairs cross a causal, window, seq_k or
//   row edge: a masked pair contributes an exact 0.

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HELD = 64;             // keys a (b) block, rows a (c) block
constexpr int DELTA_THREADS = 256;   // threads a block of (a) and (b')

template <typename T, int HD>
struct Bwd {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int E = 16 / sizeof(T);    // elements a 16-byte piece
  static constexpr int LD = HD + E;           // shared row stride: 16 B pad
  // rows (keys) a step: two stages of them beside the held tiles fit one
  // SM, and the fp32 products' registers (their TF32 halves) one thread
  static constexpr int STEP = HD <= (F32 ? 32 : 64) ? 64
                              : HD <= (F32 ? 64 : 128) ? 32 : 16;
  static constexpr int NS = STEP / 8;         // score n-tiles a step
  // warps that share a warp's 16 keys (rows), each a slice of hd: at hd 256
  // two, so that a lane holds 64 + 64 of dK and dV, not 128 + 128
  static constexpr int D = HD > 128 ? 2 : 1;
  static constexpr int WARPS = 4 * D, THREADS = 32 * WARPS;
  static constexpr int HW = HD / D;           // dims a warp's slice
  static constexpr int ND = HW / 8;           // accumulator n-tiles
  static constexpr int KSD = HW / (F32 ? 8 : 16);   // k-steps over a slice
  static constexpr bool KEEP = !F32 && HD <= 64;    // held fragments in regs
  // blocks an SM should keep, (c)'s and (b)'s: bf16 at small hd caps its
  // registers for three, so that a warp's dependent steps overlap others'
  // ((b) at hd 32 and 16 fits three uncapped)
  static constexpr int MINB = !F32 && HD <= 64 ? 3 : 1;
  static constexpr int MINB_DKV = !F32 && HD == 64 ? 3 : 1;
  static constexpr int KA = KEEP ? KSD : 1;
  static constexpr size_t HELD_B = sizeof(T) * HELD * LD;
  static constexpr size_t STEP_B = sizeof(T) * STEP * LD;
  // the partial scores a warp hands its partner (D = 2): two arrays
  static constexpr size_t XCH_B = D > 1 ? 16 * 32 * 2 * NS * WARPS : 0;
  // (b): K, V, two stages of Q and dO, of lse and delta; (c): Q, dO, two
  // stages of K and V; both the exchange
  static constexpr size_t SMEM_DKV =
      2 * HELD_B + 4 * STEP_B + 4 * STEP * sizeof(float) + XCH_B;
  static constexpr size_t SMEM_DQ = 2 * HELD_B + 4 * STEP_B + XCH_B;
};

struct Geo {
  int H, KV, G, Sq, Sk, seq_k, causal, window, q_off;
  float scale;
  int seg, nseg;   // (b)'s row tiles a segment, segments a key tile at most
  int qseg, qnseg; // (c)'s key tiles a segment, segments a row tile at most
};

__device__ __forceinline__ bool live_pair(const Geo& g, int query, int key) {
  const int p = query + g.q_off;   // the query's global position
  bool ok = key < g.seq_k;
  if (g.causal) ok = ok && key <= p;
  if (g.window > 0) ok = ok && key > p - g.window;
  return ok;
}

// Whether some (all) of the pairs of queries qlo..qhi and keys klo..khi
// are live, for the warp-level skip (mask) decisions.
__device__ __forceinline__ bool any_live(const Geo& g, int qlo, int qhi,
                                         int klo, int khi) {
  return qlo <= qhi && klo < g.seq_k && (!g.causal || klo <= qhi + g.q_off) &&
         (g.window <= 0 || khi > qlo + g.q_off - g.window);
}

__device__ __forceinline__ bool all_live(const Geo& g, int qlo, int qhi,
                                         int klo, int khi) {
  return khi < g.seq_k && (!g.causal || khi <= qlo + g.q_off) &&
         (g.window <= 0 || klo > qhi + g.q_off - g.window);
}

// element offset of row r of (b, kvh) in q, o, dO (B,H,Sq,hd), over hd;
// also the index of its lse and delta
__device__ __forceinline__ long long row_of(const Geo& g, int b, int kvh,
                                            int r) {
  const int query = r / g.G;
  return ((long long)b * g.H + (long long)kvh * g.G + (r - query * g.G)) *
             g.Sq + query;
}

// the key tiles [t_lo, t_hi) of bk keys that rows r0.. r0 + HELD - 1 may
// read (live_key_tiles)
__device__ __forceinline__ int2 key_tiles(const Geo& g, int r0, int bk) {
  const int n_rows = g.G * g.Sq;
  const int row_lo = r0 / g.G;
  const int row_hi = ((r0 + HELD < n_rows ? r0 + HELD : n_rows) - 1) / g.G;
  int t_lo = 0, t_hi = (g.seq_k + bk - 1) / bk;
  if (g.causal && (row_hi + g.q_off) / bk + 1 < t_hi)
    t_hi = (row_hi + g.q_off) / bk + 1;
  if (g.window > 0 && row_lo + g.q_off - g.window + 1 > 0)
    t_lo = (row_lo + g.q_off - g.window + 1) / bk;
  return make_int2(t_lo, row_hi < row_lo || t_hi < t_lo ? t_lo : t_hi);
}

// the row tiles [u_lo, u_hi) of bq rows that may hold a live row for keys
// k0.. k0 + HELD - 1 (live_query_tiles): queries from the first that the
// causal mask lets read key k0 to the last whose window reaches the tile's
// last key
__device__ __forceinline__ int2 row_tiles(const Geo& g, int k0, int bq) {
  const int key_hi = (k0 + HELD < g.seq_k ? k0 + HELD : g.seq_k) - 1;
  if (key_hi < k0) return make_int2(0, 0);
  const int lo = g.causal && k0 > g.q_off ? k0 - g.q_off : 0;
  int hi = g.Sq;
  if (g.window > 0 && key_hi - g.q_off + g.window < hi)
    hi = key_hi - g.q_off + g.window;
  if (hi <= lo) return make_int2(0, 0);
  return make_int2((int)((long long)lo * g.G / bq),
                   (int)(((long long)hi * g.G + bq - 1) / bq));
}

// 4-byte asynchronous copy (zero-filled when ``in`` is false)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// the two warps of pair ``id`` (1-4; 0 is __syncthreads') meet
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// n rows of hd elements of two tensors at the same offsets (Q and dO, K
// and V) into d1, d2 (rows LD apart) by 16-byte cp.async: row j from s1,
// s2 + off(j) (off(j) < 0: zeros), each thread's rows' offsets computed
// once for both; the caller commits and waits
template <typename T, int HD, typename Off>
__device__ __forceinline__ void load_rows2(T* d1, const T* s1, T* d2,
                                           const T* s2, int n, Off off) {
  using Tl = Bwd<T, HD>;
  constexpr int LD = Tl::LD, E = Tl::E, C = HD / E;
  static_assert(Tl::THREADS % C == 0, "a thread's pieces share a column");
  const int d = (threadIdx.x % C) * E;
  for (int j = threadIdx.x / C; j < n; j += Tl::THREADS / C) {
    const long long o = off(j);
    const long long at = o < 0 ? 0 : o + d;
    cp_async16(d1 + j * LD + d, s1 + at, o >= 0);
    cp_async16(d2 + j * LD + d, s2 + at, o >= 0);
  }
}

// ldmatrix lane offsets (elements) into a tile of rows LD apart: A from 16
// rows over a k-step; B (two n-tiles) from rows n over a k-step; B (two
// n-tiles of columns) from rows k by .trans (bf16)
template <typename T, int HD>
__device__ __forceinline__ int a_offset(int lane) {
  constexpr int LD = Bwd<T, HD>::LD, E = Bwd<T, HD>::E;
  return (lane % 8 + 8 * (lane / 8 % 2)) * LD + E * (lane / 16);
}

template <typename T, int HD>
__device__ __forceinline__ int b_offset(int lane) {
  constexpr int LD = Bwd<T, HD>::LD, E = Bwd<T, HD>::E;
  return (lane % 8 + 8 * (lane / 16)) * LD + E * (lane / 8 % 2);
}

// the A fragments of a warp's 16 rows of ``a`` over hd, to keep
template <typename T, int HD>
__device__ __forceinline__ void hold_frags(unsigned (&f)[Bwd<T, HD>::KA][4],
                                           const T* a) {
  const int off = a_offset<T, HD>(threadIdx.x % 32);
#pragma unroll
  for (int s = 0; s < Bwd<T, HD>::KA; ++s) ldmatrix_x4(f[s], a + off + 16 * s);
}

// c (16 x 8 NS, fp32) = A (the warp's 16 rows at ``a``, or the kept
// fragments ``af``) . B^T (the 8 NS rows at ``bt``), over the hd slice
// that starts at both pointers, in k-steps
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&c)[Bwd<T, HD>::NS][4],
                                       const unsigned (&af)[Bwd<T, HD>::KA][4],
                                       const T* a, const T* bt) {
  using Tl = Bwd<T, HD>;
  constexpr int LD = Tl::LD, NS = Tl::NS;
  const int lane = threadIdx.x % 32;
  const int ao = a_offset<T, HD>(lane), bo = b_offset<T, HD>(lane);
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  if constexpr (!Tl::F32) {
#pragma unroll
    for (int s = 0; s < Tl::KSD; ++s) {
      unsigned x[4];
      if constexpr (Tl::KEEP) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = af[s][e];
      } else {
        ldmatrix_x4(x, a + ao + 16 * s);
      }
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        unsigned y[4];
        ldmatrix_x4(y, bt + n * 8 * LD + bo + 16 * s);
        mma_bf16_free(c[n], x, y[0], y[1]);
        mma_bf16_free(c[n + 1], x, y[2], y[3]);
      }
    }
  } else {
    // PI partial sums side by side (k-step s into partial s % PI), so that
    // PI NS chains of products are in flight, each of at most 4 k-steps
    // on the tensor cores before it is added to c in fp32: the tensor
    // cores' accumulation truncates, a bias that grows with the number of
    // products one accumulator takes
    constexpr int PI = NS <= 2 ? 4 : NS <= 4 ? 2 : 1;
    constexpr int CH = 4 * PI < Tl::KSD ? 4 * PI : Tl::KSD;
#pragma unroll
    for (int s0 = 0; s0 < Tl::KSD; s0 += CH) {
      float part[PI][NS][4];
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][n][e] = 0.f;
#pragma unroll
      for (int s = s0; s < s0 + CH; ++s) {
        const int i = (s - s0) % PI;
        unsigned x[4], xh[4], xl[4];
        ldmatrix_x4(x, a + ao + 8 * s);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(x[e], xh[e], xl[e]);
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          unsigned y[4], yh[4], yl[4];
          ldmatrix_x4(y, bt + n * 8 * LD + bo + 8 * s);
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(y[e], yh[e], yl[e]);
          mma_tf32x3(part[i][n], xh, xl, yh[0], yh[1], yl[0], yl[1]);
          mma_tf32x3(part[i][n + 1], xh, xl, yh[2], yh[3], yl[2], yl[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < PI && i < CH; ++i)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n][e] += part[i][n][e];
    }
  }
}

// With D = 2: the two warps of a pair (``warp`` and ``warp`` ^ 4, the same
// 16 keys or rows, dims split) swap their partial scores ``c0``, ``c1``
// through ``xch`` and both take slice 0's + slice 1's, in that order, so
// that both hold the same bits.
template <typename T, int HD>
__device__ __forceinline__ void combine(float (&c0)[Bwd<T, HD>::NS][4],
                                        float (&c1)[Bwd<T, HD>::NS][4],
                                        float4* xch, int warp) {
  using Tl = Bwd<T, HD>;
  constexpr int NS = Tl::NS;
  if constexpr (Tl::D > 1) {
    const int lane = threadIdx.x % 32;
    float4* mine = xch + warp * 2 * NS * 32 + lane;
    const float4* other = xch + (warp ^ 4) * 2 * NS * 32 + lane;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mine[n * 32] = make_float4(c0[n][0], c0[n][1], c0[n][2], c0[n][3]);
      mine[(NS + n) * 32] =
          make_float4(c1[n][0], c1[n][1], c1[n][2], c1[n][3]);
    }
    pair_sync(1 + warp % 4);
    const bool first = warp < 4;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float4 x = other[n * 32], y = other[(NS + n) * 32];
      const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c0[n][e] = first ? c0[n][e] + xs[e] : xs[e] + c0[n][e];
        c1[n][e] = first ? c1[n][e] + ys[e] : ys[e] + c1[n][e];
      }
    }
  }
}

// acc (16 x the warp's hd slice) += C (the 16 x 8 NS fragments ``c``, as
// A) . B (the 8 NS rows at ``bt``, the slice's columns from there): the
// score fragments are the A operand, bf16 two packed, TF32 with k permuted
// (k t <-> column 2t, k t + 4 <-> 2t + 1, in A and in B's rows alike)
template <typename T, int HD>
__device__ __forceinline__ void accumulate(float (&acc)[Bwd<T, HD>::ND][4],
                                           const float (&c)[Bwd<T, HD>::NS][4],
                                           const T* bt) {
  using Tl = Bwd<T, HD>;
  constexpr int LD = Tl::LD, ND = Tl::ND, NS = Tl::NS;
  const int lane = threadIdx.x % 32;
  if constexpr (!Tl::F32) {
    const int vo = a_offset<T, HD>(lane);
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const unsigned a[4] = {pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                             pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                             pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                             pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        unsigned y[4];
        ldmatrix_x4_trans(y, bt + kk * 16 * LD + vo + 8 * n);
        mma_bf16_free(acc[n], a, y[0], y[1]);
        mma_bf16_free(acc[n + 1], a, y[2], y[3]);
      }
    }
  } else {
    // each pair of k-steps summed on the tensor cores from zero, then
    // added to acc in fp32: acc takes every row (key) of a long sequence,
    // where the tensor cores' truncating accumulation would drift
    const float* b0 = bt + 2 * (lane % 4) * LD + lane / 4;
#pragma unroll
    for (int k0 = 0; k0 < NS; k0 += 2) {
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x[4] = {c[k0 + j][0], c[k0 + j][2], c[k0 + j][1],
                            c[k0 + j][3]};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__float_as_uint(x[e]), ah[j][e], al[j][e]);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* p = b0 + (k0 + j) * 8 * LD + n * 8;
          unsigned h0, l0, h1, l1;
          split_tf32(__float_as_uint(p[0]), h0, l0);
          split_tf32(__float_as_uint(p[LD]), h1, l1);
          mma_tf32x3(part, ah[j], al[j], h0, h1, l0, l1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
      }
    }
  }
}

// exp(x): fp32's correctly rounded-ish expf; bf16's P and dS are rounded
// to bf16 after it, so the fast approximation (ex2.approx, a few ulp) will
// do there
template <typename T>
__device__ __forceinline__ float exp_of(float x) {
  if constexpr (std::is_same<T, float>::value)
    return expf(x);
  else
    return __expf(x);
}

// two adjacent gradient elements, rounded to T
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}

// ---------------------------------------------------------------------------
// (a) delta
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                       float* __restrict__ delta, long long n_all) {
  constexpr int E = Bwd<T, HD>::E, C = HD / E;    // 16-byte pieces a row
  constexpr int TPR = C < 32 ? C : 32;            // lanes a row
  const long long row =
      ((long long)blockIdx.x * DELTA_THREADS + threadIdx.x) / TPR;
  const int part = threadIdx.x % TPR;
  float sum = 0.f;
  if (row < n_all) {
    for (int c = part; c < C; c += TPR) {
      const long long at = row * HD + c * E;
      const uint4 x = *reinterpret_cast<const uint4*>(o + at);
      const uint4 y = *reinterpret_cast<const uint4*>(dO + at);
      const T* xs = reinterpret_cast<const T*>(&x);
      const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
      for (int e = 0; e < E; ++e) sum = fmaf(to_f(xs[e]), to_f(ys[e]), sum);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0 && row < n_all) delta[row] = sum;
}

// ---------------------------------------------------------------------------
// (b) dk and dv, a key tile a block
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(Bwd<T, HD>::THREADS, Bwd<T, HD>::MINB_DKV)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ part, Geo g) {
  using Tl = Bwd<T, HD>;
  constexpr int LD = Tl::LD, STEP = Tl::STEP, NS = Tl::NS, ND = Tl::ND;
  extern __shared__ __align__(16) unsigned char sm[];
  T* ks = reinterpret_cast<T*>(sm);           // [HELD][LD]
  T* vs = ks + HELD * LD;                     // [HELD][LD]
  T* qs = vs + HELD * LD;                     // [2][STEP][LD]
  T* dos = qs + 2 * STEP * LD;                // [2][STEP][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * STEP * LD);  // [2][STEP]
  float* dl_s = lse_s + 2 * STEP;             // [2][STEP]
  float4* xch = reinterpret_cast<float4*>(dl_s + 2 * STEP);
  const int k0 = blockIdx.x * HELD, b = blockIdx.z;
  const int kvh = blockIdx.y % g.KV, seg = blockIdx.y / g.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int kw0 = k0 + (warp % 4) * 16;       // this warp's keys, 16
  const int d0 = (warp / 4) * Tl::HW;         // and its slice of hd
  const int n_rows = g.G * g.Sq;
  const long long kv0 = ((long long)b * g.KV + kvh) * g.Sk;

  float dva[ND][4], dka[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[n][e] = dka[n][e] = 0.f;

  // this block's segment of the key tile's row tiles
  int2 ut = row_tiles(g, k0, STEP);
  const int u_end = min(ut.y, ut.x + (seg + 1) * g.seg);
  ut.x += seg * g.seg;
  ut.y = u_end;
  if (g.nseg > 1 && ut.y <= ut.x) return;     // nothing to add: (b') skips
  // Q(u), dO(u), lse(u), delta(u) into stage st
  auto load_step = [&](int u, int st) {
    auto r_off = [=](int j) {
      const int r = u * STEP + j;
      return r < n_rows ? row_of(g, b, kvh, r) * HD : -1ll;
    };
    load_rows2<T, HD>(qs + st * STEP * LD, q, dos + st * STEP * LD, dO, STEP,
                      r_off);
    const int j = threadIdx.x, r = u * STEP + j;
    if (j < STEP) {
      const bool in = r < n_rows;
      const long long i = in ? row_of(g, b, kvh, r) : 0;
      cp_async4(lse_s + st * STEP + j, lse + i, in);
      cp_async4(dl_s + st * STEP + j, delta + i, in);
    }
  };
  if (ut.y > ut.x) {                          // group: K, V and step 0
    auto k_off = [&](int j) {
      return k0 + j < g.Sk ? (kv0 + k0 + j) * HD : -1ll;
    };
    load_rows2<T, HD>(ks, k, vs, v, HELD, k_off);
    load_step(ut.x, 0);
  }
  cp_async_commit();

  const T* kw = ks + (warp % 4) * 16 * LD + d0;
  const T* vw = vs + (warp % 4) * 16 * LD + d0;
  unsigned kf[Tl::KA][4], vf[Tl::KA][4];
  for (int u = ut.x; u < ut.y; ++u) {
    const int st = (u - ut.x) & 1;
    if (u + 1 < ut.y) load_step(u + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                       // step u (and K, V) are in
    __syncthreads();
    if constexpr (Tl::KEEP) {
      if (u == ut.x) {
        hold_frags<T, HD>(kf, kw);
        hold_frags<T, HD>(vf, vw);
      }
    }
    const int r0 = u * STEP, r_end = min(r0 + STEP, n_rows);
    const int qlo = r0 / g.G, qhi = (r_end - 1) / g.G;
    if (any_live(g, qlo, qhi, kw0, kw0 + 15)) {   // the pair's, uniform
      const bool edge =
          r0 + STEP > n_rows || !all_live(g, qlo, qhi, kw0, kw0 + 15);
      const T* qt = qs + st * STEP * LD;
      const T* dt = dos + st * STEP * LD;
      const float* ls = lse_s + st * STEP;
      const float* dls = dl_s + st * STEP;
      float s[NS][4], dp[NS][4];
      scores<T, HD>(s, kf, kw, qt + d0);      // S^T: keys x the step's rows
      scores<T, HD>(dp, vf, vw, dt + d0);     // dP^T
      combine<T, HD>(s, dp, xch, warp);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * tq + (e & 1);     // the step's row
          const bool live =
              !edge || (r0 + col < n_rows &&
                        live_pair(g, (r0 + col) / g.G, kw0 + gq + 8 * (e / 2)));
          const float p =
              live ? exp_of<T>(s[n][e] * g.scale - ls[col]) : 0.f;
          dp[n][e] = live ? p * (dp[n][e] - dls[col]) : 0.f;
          s[n][e] = p;
        }
      accumulate<T, HD>(dva, s, dt + d0);     // dV += P^T dO
      accumulate<T, HD>(dka, dp, qt + d0);    // dK += dS^T Q
    }
    __syncthreads();                          // stage st is free for u + 2
  }
  cp_async_wait<0>();

  // one segment: the gradients; several: this segment's fp32 sums,
  // segment-major in ``part`` (dK's, then dV's), for (b') to add
  const long long kv_all = (long long)gridDim.z * g.KV * g.Sk * HD;
  float* pk = part + seg * 2 * kv_all;
  float* pv = pk + kv_all;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw0 + gq + 8 * h;
    if (key >= g.Sk) continue;
    const long long base = (kv0 + key) * HD + d0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (g.nseg > 1) {
        store2(pv + base + 8 * n, dva[n][2 * h], dva[n][2 * h + 1]);
        store2(pk + base + 8 * n, dka[n][2 * h], dka[n][2 * h + 1]);
      } else {
        store2(dv + base + 8 * n, dva[n][2 * h], dva[n][2 * h + 1]);
        store2(dk + base + 8 * n, dka[n][2 * h] * g.scale,
               dka[n][2 * h + 1] * g.scale);
      }
    }
  }
}

// (b') dk and dv from the segments' sums of each key, in segment order (the
// key tile's own count of segments), dk times the scale; one segment a
// launch skips this kernel
template <typename T, int HD>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_dkv_sum_kernel(const float* __restrict__ part, T* __restrict__ dk,
                         T* __restrict__ dv, long long kv_all, Geo g) {
  const long long i = ((long long)blockIdx.x * DELTA_THREADS + threadIdx.x) * 2;
  if (i >= kv_all) return;
  const int key = (int)((i / HD) % g.Sk);
  const int2 ut = row_tiles(g, key / HELD * HELD, Bwd<T, HD>::STEP);
  const int n = (ut.y - ut.x + g.seg - 1) / g.seg;
  float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
  for (int s = 0; s < n; ++s) {
    const float* at = part + 2 * s * kv_all + i;
    const float2 a = *reinterpret_cast<const float2*>(at);
    const float2 c = *reinterpret_cast<const float2*>(at + kv_all);
    k0 += a.x;
    k1 += a.y;
    v0 += c.x;
    v1 += c.y;
  }
  store2(dk + i, k0 * g.scale, k1 * g.scale);
  store2(dv + i, v0, v1);
}

// ---------------------------------------------------------------------------
// (c) dq, a row tile a block
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(Bwd<T, HD>::THREADS, Bwd<T, HD>::MINB)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    float* __restrict__ part, Geo g) {
  using Tl = Bwd<T, HD>;
  constexpr int LD = Tl::LD, STEP = Tl::STEP, NS = Tl::NS, ND = Tl::ND;
  extern __shared__ __align__(16) unsigned char sm[];
  T* qs = reinterpret_cast<T*>(sm);           // [HELD][LD]
  T* dos = qs + HELD * LD;                    // [HELD][LD]
  T* ks = dos + HELD * LD;                    // [2][STEP][LD]
  T* vs = ks + 2 * STEP * LD;                 // [2][STEP][LD]
  float4* xch = reinterpret_cast<float4*>(vs + 2 * STEP * LD);
  const int r0 = blockIdx.x * HELD, b = blockIdx.z;
  const int kvh = blockIdx.y % g.KV, seg = blockIdx.y / g.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int rw0 = r0 + (warp % 4) * 16;       // this warp's rows, 16
  const int d0 = (warp / 4) * Tl::HW;         // and its slice of hd
  const int n_rows = g.G * g.Sq;
  const long long kv0 = ((long long)b * g.KV + kvh) * g.Sk;

  float ls[2], dls[2];                        // rows rw0 + gq, + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw0 + gq + 8 * h;
    const bool in = r < n_rows;
    const long long i = in ? row_of(g, b, kvh, r) : 0;
    ls[h] = in ? lse[i] : 0.f;
    dls[h] = in ? delta[i] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // this block's segment of the row tile's key tiles
  int2 tr = key_tiles(g, r0, STEP);
  const int t_end = min(tr.y, tr.x + (seg + 1) * g.qseg);
  tr.x += seg * g.qseg;
  tr.y = t_end;
  if (g.qnseg > 1 && tr.y <= tr.x) return;    // nothing to add: (c') skips
  auto load_step = [&](int t, int st) {       // K(t), V(t) into stage st
    auto k_at = [=](int j) {
      const int key = t * STEP + j;
      return key < g.Sk ? (kv0 + key) * HD : -1ll;
    };
    load_rows2<T, HD>(ks + st * STEP * LD, k, vs + st * STEP * LD, v, STEP,
                      k_at);
  };
  if (tr.y > tr.x) {                          // group: Q, dO and step 0
    auto r_off = [&](int j) {
      return r0 + j < n_rows ? row_of(g, b, kvh, r0 + j) * HD : -1ll;
    };
    load_rows2<T, HD>(qs, q, dos, dO, HELD, r_off);
    load_step(tr.x, 0);
  }
  cp_async_commit();

  const T* qw = qs + (warp % 4) * 16 * LD + d0;
  const T* dw = dos + (warp % 4) * 16 * LD + d0;
  unsigned qf[Tl::KA][4], df[Tl::KA][4];
  const int r_end = min(rw0 + 16, n_rows);
  const int qlo = rw0 / g.G, qhi = (r_end - 1) / g.G;
  for (int t = tr.x; t < tr.y; ++t) {
    const int st = (t - tr.x) & 1;
    if (t + 1 < tr.y) load_step(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                       // step t (and Q, dO) are in
    __syncthreads();
    if constexpr (Tl::KEEP) {
      if (t == tr.x) {
        hold_frags<T, HD>(qf, qw);
        hold_frags<T, HD>(df, dw);
      }
    }
    const int k0 = t * STEP;
    if (r_end > rw0 && any_live(g, qlo, qhi, k0, k0 + STEP - 1)) {
      const bool edge =
          rw0 + 16 > n_rows || !all_live(g, qlo, qhi, k0, k0 + STEP - 1);
      const T* kt = ks + st * STEP * LD;
      const T* vt = vs + st * STEP * LD;
      float s[NS][4], dp[NS][4];
      scores<T, HD>(s, qf, qw, kt + d0);      // S: rows x the step's keys
      scores<T, HD>(dp, df, dw, vt + d0);     // dP
      combine<T, HD>(s, dp, xch, warp);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, r = rw0 + gq + 8 * h;
          const bool live =
              !edge || (r < n_rows &&
                        live_pair(g, r / g.G, k0 + n * 8 + 2 * tq + (e & 1)));
          const float p = live ? exp_of<T>(s[n][e] * g.scale - ls[h]) : 0.f;
          dp[n][e] = live ? p * (dp[n][e] - dls[h]) : 0.f;
        }
      accumulate<T, HD>(acc, dp, kt + d0);    // dq += dS K
    }
    __syncthreads();                          // stage st is free for t + 2
  }
  cp_async_wait<0>();

  // one segment: dq; several: this segment's fp32 sums, segment-major in
  // ``part``, for (c') to add
  float* pq = part + seg * (long long)gridDim.z * g.H * g.Sq * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw0 + gq + 8 * h;
    if (r >= n_rows) continue;
    const long long base = row_of(g, b, kvh, r) * HD + d0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (g.qnseg > 1)
        store2(pq + base + 8 * n, acc[n][2 * h], acc[n][2 * h + 1]);
      else
        store2(dq + base + 8 * n, acc[n][2 * h] * g.scale,
               acc[n][2 * h + 1] * g.scale);
    }
  }
}

// (c') dq from the segments' sums of each row, in segment order (its row
// tile's own count of segments), times the scale
template <typename T, int HD>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_dq_sum_kernel(const float* __restrict__ part, T* __restrict__ dq,
                        long long q_all, Geo g) {
  const long long i = ((long long)blockIdx.x * DELTA_THREADS + threadIdx.x) * 2;
  if (i >= q_all) return;
  const long long row = i / HD;               // (b, h, query)
  const int query = (int)(row % g.Sq), h = (int)(row / g.Sq % g.H);
  const int r = query * g.G + h % g.G;        // its (query, head) row
  const int2 tr = key_tiles(g, r / HELD * HELD, Bwd<T, HD>::STEP);
  const int n = (tr.y - tr.x + g.qseg - 1) / g.qseg;
  float a0 = 0.f, a1 = 0.f;
  for (int s = 0; s < n; ++s) {
    const float2 a = *reinterpret_cast<const float2*>(part + s * q_all + i);
    a0 += a.x;
    a1 += a.y;
  }
  store2(dq + i, a0 * g.scale, a1 * g.scale);
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dO, const float* lse,
                       float* delta, float* kpart, float* qpart, void* dq,
                       void* dk, void* dv, int B, const Geo& g, int device,
                       cudaStream_t stream) {
  using Tl = Bwd<T, HD>;
  static unsigned long long set_dkv = 0, set_dq = 0;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, HD>, set_dkv, device,
                               Tl::SMEM_DKV);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_kernel<T, HD>, set_dq, device, Tl::SMEM_DQ);
  if (err != cudaSuccess) return err;
  if ((g.nseg > 1 && kpart == nullptr) || (g.qnseg > 1 && qpart == nullptr))
    return cudaErrorInvalidValue;
  const long long kv_all = (long long)B * g.KV * g.Sk * HD;
  const long long q_all = (long long)B * g.H * g.Sq * HD;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dO);
  const long long n_all = (long long)B * g.H * g.Sq;
  constexpr int C = HD / Tl::E, TPR = C < 32 ? C : 32;
  constexpr int PER = DELTA_THREADS / TPR;    // rows a delta block
  if (n_all > 0) {
    flash_bwd_delta_kernel<T, HD>
        <<<(unsigned)((n_all + PER - 1) / PER), DELTA_THREADS, 0, stream>>>(
            static_cast<const T*>(o), dot, delta, n_all);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 keys((unsigned)((g.Sk + HELD - 1) / HELD), g.KV * g.nseg, B);
  if (keys.x > 0) {
    flash_bwd_dkv_kernel<T, HD><<<keys, Tl::THREADS, Tl::SMEM_DKV, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), kpart, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (g.nseg > 1) {
      const long long n2 = kv_all / 2;
      flash_bwd_dkv_sum_kernel<T, HD>
          <<<(unsigned)((n2 + DELTA_THREADS - 1) / DELTA_THREADS),
             DELTA_THREADS, 0, stream>>>(kpart, static_cast<T*>(dk),
                                         static_cast<T*>(dv), kv_all, g);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  const long long n_rows = (long long)g.G * g.Sq;
  const dim3 rows((unsigned)((n_rows + HELD - 1) / HELD), g.KV * g.qnseg, B);
  if (rows.x > 0) {
    flash_bwd_dq_kernel<T, HD><<<rows, Tl::THREADS, Tl::SMEM_DQ, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), qpart, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (g.qnseg > 1) {
      const long long n2 = q_all / 2;
      flash_bwd_dq_sum_kernel<T, HD>
          <<<(unsigned)((n2 + DELTA_THREADS - 1) / DELTA_THREADS),
             DELTA_THREADS, 0, stream>>>(qpart, static_cast<T*>(dq), q_all,
                                         g);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* dO, const float* lse,
                         float* delta, float* kpart, float* qpart, void* dq,
                         void* dk, void* dv, int B, int hd, const Geo& g,
                         int device, cudaStream_t s) {
#define REPRO_BWD_CASE(HD)                                                \
  case HD:                                                                \
    return launch_bwd<T, HD>(q, k, v, o, dO, lse, delta, kpart, qpart, dq, \
                             dk, dv, B, g, device, s);
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

// dq, dk, dv (in the inputs' dtype) from q, k, v, o, dO, all contiguous,
// and lse (fp32 B * H * Sq, the forward's); delta is fp32 scratch of B * H
// * Sq. The walks are cut as the caller says (`bwd_segments`): seg row
// tiles a dK/dV segment, nseg segments a key tile at most, and qseg key
// tiles a dq segment, qnseg segments a row tile at most; ``kpart`` is fp32
// scratch of 2 * nseg * B * KV * Sk * hd floats, ``qpart`` of qnseg * B * H
// * Sq * hd (each null when its walk is one segment). Three to five
// kernels on ``stream``; returns the first launch error (0 = launched).
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dO,
                               const void* lse, void* dq, void* dk, void* dv,
                               void* delta, void* kpart, void* qpart, int B,
                               int H, int KV, int Sq, int Sk, int hd,
                               int seq_k, int causal, int window, int q_off,
                               int seg, int nseg, int qseg, int qnseg,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (KV <= 0 || H % KV || seg < 1 || nseg < 1 || qseg < 1 || qnseg < 1)
    return cudaErrorInvalidValue;
  const Geo g{H,     KV,     H / KV, Sq,    Sk,  seq_k,
              causal, window, q_off, 1.f / sqrtf(static_cast<float>(hd)),
              seg,   nseg,   qseg,   qnseg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float* kp = static_cast<float*>(kpart);
  float* qp = static_cast<float*>(qpart);
  if (dtype == REPRO_F32)
    return dispatch_bwd<float>(q, k, v, o, dO, l, d, kp, qp, dq, dk, dv, B,
                               hd, g, device, s);
  if (dtype == REPRO_BF16)
    return dispatch_bwd<bf16>(q, k, v, o, dO, l, d, kp, qp, dq, dk, dv, B,
                              hd, g, device, s);
  return cudaErrorInvalidValue;
}
