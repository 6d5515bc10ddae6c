// Blocked online-softmax (flash) attention forward, for Hopper (sm_90a): the
// sequence forms (Sq > 1). The one-query decode form is flash_decode.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_bhsd`, body `_kernel`). Same contract: q (B,H,Sq,hd),
// k/v (B,KV,Sk,hd) with GQA kv head = h / (H/KV); scale 1/sqrt(hd) applied
// once to q.k; optional tanh softcap; causal and local-window masks; the
// pre-pad lengths seq_q/seq_k mask rows and columns; a q row with no live
// key (or past seq_q) writes zeros (l floored at 1e-20); fully masked key
// blocks are skipped; the output has q's dtype. Beyond the TPU kernel,
// q_off is the global position of query row 0 (a rank's chunk of a
// context-parallel sequence): the causal and window masks and the live
// tile range compare key j with position row + q_off, while seq_q still
// counts local rows. So a chunk computes the whole call's rows [q_off,
// q_off + Sq) and skips the tiles dead to them: the first of four causal
// chunks loads a quarter of the last one's tiles.
//
// Both kernels also write each row's log-sum-exp, m + log(l) with l floored
// as in the divide, when given an ``lse`` pointer: `FlashAttention` keeps it
// for the gradient kernel (flash_bwd.cu), as the reference's forward keeps
// its residual. The store is one float a row in the epilogue; nothing else
// changes, and a null pointer gives the same o bit for bit.
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
// bf16 (`flash_fwd_mma_kernel`, the protein models' S 31-96 at hd 32,
// FoldScore's masked predict_batch and ProGen's GQA admission prefill). A
// launch moves under 2 MB (0.000078 ms at 3.35 TB/s at predict_batch's 4 x 8
// x 32), so it is bound by latency: the launch, one round trip to device
// memory and the chain of dependent steps between them. The design keeps that
// chain short and puts the products on the tensor cores (FlashAttention-2
// style, mma.sync m16n8k16, bf16 in, fp32 accumulate):
//
// - A block of 4 warps owns 64 (query, head) rows of one (b, KV head): row r
//   is query r / G of query head kvh * G + r % G, so one K/V tile in shared
//   memory serves all G = H/KV query heads of the group (progen-s G = 2,
//   foldscore-s G = 1), and any G fills the block. A warp owns 16 rows.
// - Q (64 rows) and the first K/V tile of 32 keys arrive by 16-byte
//   cp.async in one group; later tiles are double-buffered, the next in
//   flight while the current one is used. Shared rows are padded by 16
//   bytes, so the 8 row addresses of each ldmatrix hit distinct banks. Keys
//   past seq_k and rows past seq_q are zero-filled, never read.
// - Q.K^T: Q's A fragments come by ldmatrix once and stay in registers (hd
//   <= 128; at hd 256 they are re-read from shared memory each tile to keep
//   registers for the 128-float accumulator), K's B fragments by ldmatrix.
//   The 1/sqrt(hd) scale goes on the fp32 scores, not on a bf16 q.
// - Softcap, the causal / window / seq_q / seq_k masks and the online
//   softmax run on the score fragments in registers; a row's max is two
//   shfl_xor over its quad, its sum is kept per thread and reduced once at
//   the end.
// - P.V: P is rounded to bf16 in registers and reused as the A operand
//   (the score fragment's layout is the A fragment's), V's B fragments
//   come by ldmatrix.trans, the accumulator is fp32.
// - Key tiles with no live key for the block are never loaded (the rule is
//   `live_key_tiles` in flash_attention.py); a warp whose 16 rows have no
//   live key in a loaded tile skips its products (exact: such a tile adds
//   nothing and rescales by 1). A row with no live key, or past seq_q,
//   writes exact zeros (l floored at 1e-20).
// One template covers head dims 16-256 with 32-key tiles; shared memory is
// 15 KB at hd 32 and 99 KB at hd 256.
//
// Rounding P to bf16 costs at most 2^-9 relative per term, inside the bf16
// tolerance of 2e-2 against attention_ref; attention_tiled_ref in
// flash_attention.py repeats this algebra in plain PyTorch.

#include "common.cuh"
#include "mma.cuh"

namespace {

__device__ __forceinline__ bool is_live(int row, int col, int seq_q,
                                        int seq_k, int causal, int window,
                                        int q_off) {
  bool ok = row < seq_q && col < seq_k;
  const int p = row + q_off;      // the row's global position
  if (causal) ok = ok && col <= p;
  if (window > 0) ok = ok && col > p - window;
  return ok;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_BQ = 16 * MMA_WARPS;   // (query, head) rows a block
constexpr int MMA_BK = 32;               // keys a tile

template <int HD>
struct MmaTile {
  static constexpr int LD = HD + 8;      // shared row stride: 16 B of pad
  static constexpr bool Q_REGS = HD <= 128;   // Q fragments in registers
  static constexpr int KS = HD / 16;     // k-steps of Q.K^T
  static constexpr int NT = MMA_BK / 8;  // score n-tiles
  static constexpr int ND = HD / 8;      // accumulator n-tiles
  static constexpr size_t SMEM =         // Q, then two stages of K and V
      sizeof(bf16) * ((size_t)MMA_BQ * LD + 4 * (size_t)MMA_BK * LD);
};

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                     int seq_q, int seq_k, int causal, int window, int q_off,
                     float softcap, float scale) {
  using Tl = MmaTile<HD>;
  constexpr int LD = Tl::LD, KS = Tl::KS, NT = Tl::NT, ND = Tl::ND;
  constexpr int BQ = MMA_BQ, BK = MMA_BK, C8 = HD / 8;   // 16-B pieces a row
  extern __shared__ __align__(16) unsigned char msm[];
  bf16* qs = reinterpret_cast<bf16*>(msm);   // [BQ][LD]
  bf16* kvs = qs + BQ * LD;                  // [stage][K, V][BK][LD]

  const int G = H / KV, n_rows = G * Sq;     // row r: query r / G, head r % G
  const int r0 = blockIdx.x * BQ, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long kv_off = ((long long)b * KV + kvh) * Sk * HD;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;
  // (b, head kvh * G + g, query 0) is at q + qh_off + g * Sq * HD
  const long long qh_off = ((long long)b * H + (long long)kvh * G) * Sq * HD;

  // the key tiles that hold a live key of some live row of this block
  // (local rows row_lo..row_hi at positions + q_off)
  const int row_lo = r0 / G;
  const int row_hi = min((min(r0 + BQ, n_rows) - 1) / G, seq_q - 1);
  int t_lo = 0, t_hi = (seq_k + BK - 1) / BK;
  if (causal) t_hi = min(t_hi, (row_hi + q_off) / BK + 1);
  if (window > 0) t_lo = max(0, row_lo + q_off - window + 1) / BK;
  const int t_end = row_hi < row_lo ? t_lo : max(t_lo, t_hi);

  auto load_kv = [&](int t, int stage) {
    bf16* ks = kvs + stage * 2 * BK * LD;
    bf16* vs = ks + BK * LD;
    const int k0 = t * BK;
    for (int i = tid; i < BK * C8; i += MMA_THREADS) {
      const int j = i / C8, off = (i % C8) * 8;
      const bool in = k0 + j < seq_k;
      const long long src = (long long)(in ? k0 + j : 0) * HD + off;
      cp_async16(ks + j * LD + off, kb + src, in);
      cp_async16(vs + j * LD + off, vb + src, in);
    }
  };
  if (t_end > t_lo) {               // group: Q and the first K/V tile
    for (int i = tid; i < BQ * C8; i += MMA_THREADS) {
      const int rr = i / C8, off = (i % C8) * 8, r = r0 + rr;
      const bool in = r < n_rows && r / G < seq_q;
      const long long src =
          in ? qh_off + ((long long)(r % G) * Sq + r / G) * HD + off : 0;
      cp_async16(qs + rr * LD + off, q + src, in);
    }
    load_kv(t_lo, 0);
  }
  cp_async_commit();

  // this warp's rows: wr0 + lane / 4 (fragment halves 0, 1) and + 8 (2, 3);
  // a row past the last one takes the position seq_q, which masks it
  const int wr0 = r0 + warp * 16;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + lane / 4 + 8 * h;
    pos[h] = r < n_rows ? r / G : seq_q;
  }
  const int wpos_lo = wr0 / G;
  const int wpos_hi = min((min(wr0 + 16, n_rows) - 1) / G, seq_q - 1);

  float acc[ND][4], m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = REPRO_NEG_INF;
    l[h] = 0.f;                     // this thread's part of the row sum
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  unsigned qf[Tl::Q_REGS ? KS : 1][4];
  // ldmatrix lane offsets: A (rows lane % 8 + 8 (lane / 8 % 2), cols 8 (lane
  // / 16)); B from K rows (keys lane % 8 + 8 (lane / 16), dims 8 (lane / 8 %
  // 2)); B from V rows by .trans (keys lane % 8 + 8 (lane / 8 % 2), dims
  // 8 (lane / 16))
  const int a_off = (lane % 8 + 8 * (lane / 8 % 2)) * LD + 8 * (lane / 16);
  const int k_off = (lane % 8 + 8 * (lane / 16)) * LD + 8 * (lane / 8 % 2);
  const int v_off = a_off;
  const bf16* qw = qs + warp * 16 * LD;

  for (int t = t_lo; t < t_end; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();             // tile t (and Q) are in
    __syncthreads();
    if constexpr (Tl::Q_REGS) {
      if (t == t_lo) {
#pragma unroll
        for (int s = 0; s < KS; ++s) ldmatrix_x4(qf[s], qw + a_off + 16 * s);
      }
    }
    const int k0 = t * BK;
    const bool live =
        wpos_hi >= wpos_lo && (!causal || k0 <= wpos_hi + q_off) &&
        (window <= 0 || k0 + BK - 1 > wpos_lo + q_off - window);
    if (live) {                     // warp-uniform
      const bf16* ks = kvs + stage * 2 * BK * LD;
      const bf16* vs = ks + BK * LD;

      // S = Q K^T (fp32)
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        unsigned a[4];
        if constexpr (Tl::Q_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[st][e];
        } else {
          ldmatrix_x4(a, qw + a_off + 16 * st);
        }
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          unsigned bk[4];
          ldmatrix_x4(bk, ks + n * 8 * LD + k_off + 16 * st);
          mma_bf16(s[n], a, bk[0], bk[1]);
          mma_bf16(s[n + 1], a, bk[2], bk[3]);
        }
      }

      // scale, softcap, masks; the online softmax per row half
      float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          float x = s[n][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s[n][e] =
              is_live(pos[e / 2], col, seq_q, seq_k, causal, window, q_off)
                  ? x
                  : REPRO_NEG_INF;
          mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      float alpha[2], m_new[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m_new[h] = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new[h]);
        m[h] = m_new[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const float p =
              is_live(pos[e / 2], col, seq_q, seq_k, causal, window, q_off)
                  ? expf(s[n][e] - m_new[e / 2])
                  : 0.f;
          s[n][e] = p;
          l[e / 2] += p;
        }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];

      // O += P V: P's fragments, rounded to bf16, are the A operand
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const unsigned pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          unsigned bv[4];
          ldmatrix_x4_trans(bv, vs + kk * 16 * LD + v_off + 8 * n);
          mma_bf16(acc[n], pa, bv[0], bv[1]);
          mma_bf16(acc[n + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                // this stage is free for tile t + 2
  }

  // finish the row sums over the quad, divide, write bf16 (and, if asked,
  // the row's log-sum-exp m + log(l), l floored as in the divide)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = wr0 + lane / 4 + 8 * h;
    if (r >= n_rows) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-20f);
    if (lse != nullptr && lane % 4 == 0)
      lse[((long long)b * H + (long long)kvh * G + r % G) * Sq + r / G] =
          m[h] + logf(fmaxf(l[h], 1e-20f));
    bf16* orow = o + qh_off + ((long long)(r % G) * Sq + r / G) * HD +
                 (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<unsigned*>(orow + n * 8) =
          pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int KV, int Sq, int Sk,
                       int seq_q, int seq_k, int causal, int window, int q_off,
                       float softcap, int device, cudaStream_t stream) {
  constexpr size_t smem = MmaTile<HD>::SMEM;
  static unsigned long long smem_set = 0;
  cudaError_t err =
      allow_smem(flash_fwd_mma_kernel<HD>, smem_set, device, smem);
  if (err != cudaSuccess) return err;
  const long long n_rows = (long long)(H / KV) * Sq;
  const dim3 grid((unsigned)((n_rows + MMA_BQ - 1) / MMA_BQ), KV, B);
  flash_fwd_mma_kernel<HD><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, KV, Sq, Sk,
      seq_q, seq_k, causal, window, q_off, softcap,
      1.f / sqrtf(static_cast<float>(HD)));
  return cudaSuccess;
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int H, int KV, int Sq,
                         int Sk, int hd, int seq_q, int seq_k, int causal,
                         int window, int q_off, float softcap, int device,
                         cudaStream_t s) {
#define REPRO_MMA_CASE(HD)                                                \
  case HD:                                                                \
    return launch_mma<HD>(q, k, v, o, lse, B, H, KV, Sq, Sk, seq_q, seq_k, \
                          causal, window, q_off, softcap, device, s);
  switch (hd) {
    REPRO_MMA_CASE(16)
    REPRO_MMA_CASE(32)
    REPRO_MMA_CASE(64)
    REPRO_MMA_CASE(128)
    REPRO_MMA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_MMA_CASE
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
                     float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                     int seq_q, int seq_k, int causal, int window, int q_off,
                     float softcap, float scale) {
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
  // (local rows q0..row_hi at positions + q_off)
  const int row_hi = min(q0 + BQ, seq_q) - 1;
  int t_lo = 0, t_hi = (seq_k + BK - 1) / BK;
  if (causal) t_hi = min(t_hi, (row_hi + q_off) / BK + 1);
  if (window > 0) t_lo = max(0, q0 + q_off - window + 1) / BK;
  const int n_t = row_hi < q0 ? 0 : max(0, t_hi - t_lo);

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
        s[i][j] = is_live(row, k0 + tx + 16 * j, seq_q, seq_k, causal,
                          window, q_off)
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
        const float p =
            is_live(row, col, seq_q, seq_k, causal, window, q_off)
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
    if (lse != nullptr && tx == 0)     // the row's log-sum-exp, if asked
      lse[((long long)b * H + h) * Sq + row] = m[i] + logf(lf);
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
                       float* lse, int B, int H, int KV, int Sq, int Sk,
                       int seq_q, int seq_k, int causal, int window, int q_off,
                       float softcap, int device, cudaStream_t stream) {
  constexpr size_t smem = F32Tile<HD>::SMEM;
  static unsigned long long smem_set = 0;
  cudaError_t err =
      allow_smem(flash_fwd_f32_kernel<HD>, smem_set, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + F32_BQ - 1) / F32_BQ, H, B);
  flash_fwd_f32_kernel<HD><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, KV, Sq,
      Sk, seq_q, seq_k, causal, window, q_off, softcap,
      1.f / sqrtf(static_cast<float>(HD)));
  return cudaSuccess;
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int H, int KV, int Sq,
                         int Sk, int hd, int seq_q, int seq_k, int causal,
                         int window, int q_off, float softcap, int device,
                         cudaStream_t s) {
#define REPRO_F32_CASE(HD)                                                \
  case HD:                                                                \
    return launch_f32<HD>(q, k, v, o, lse, B, H, KV, Sq, Sk, seq_q, seq_k, \
                          causal, window, q_off, softcap, device, s);
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

// Sq >= 1: the register-tiled kernel for fp32, the mma.sync kernel for
// bf16; q_off the global position of query row 0. ``lse`` (fp32 B * H * Sq,
// or null) takes each row's log-sum-exp of its live scores, what the
// gradient kernel reads. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int H, int KV, int Sq, int Sk,
                                     int hd,
                                     int seq_q, int seq_k, int causal,
                                     int window, int q_off, float softcap,
                                     int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == REPRO_F32)
    err = dispatch_f32(q, k, v, o, l, B, H, KV, Sq, Sk, hd, seq_q, seq_k,
                       causal, window, q_off, softcap, device, s);
  else if (dtype == REPRO_BF16)
    err = dispatch_mma(q, k, v, o, l, B, H, KV, Sq, Sk, hd, seq_q, seq_k,
                       causal, window, q_off, softcap, device, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
