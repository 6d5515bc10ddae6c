// Flash-decoding: one query row per head (Sq = 1) over a key/value cache,
// for Hopper (sm_90a). The decode form of flash_attention_bhsd.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_bhsd`, body `_kernel`) where it is called with one query,
// as recurrentgemma-2b's local-attention layers call it at every decode step
// over their ring cache. Same contract: scale 1/sqrt(hd), optional tanh
// softcap, GQA kv head = h / (H/KV), a row with no live key writes zeros (l
// floored at 1e-20), the output has q's dtype. With one query at row 0 the
// masks reduce to a count of live keys: seq_k, or min(1, seq_k) when causal,
// or none past seq_q = 0; a window never masks row 0.
//
// What bounds it on the H100: bytes. At recurrentgemma-2b's decode (8 rows
// x 10 query heads, one KV head of 256, 2048 cached keys in bf16) it reads
// 16.78 MB of K/V and 82 KB of q and writes 82 KB, ~0.0051 ms at 3.35 TB/s;
// its 168 MFLOP take a third of that at the fp32 rate. So every cached byte
// is read once, in its stored dtype, and enough of them are in flight:
//
// - A block owns one (row, KV head) and holds all G = H/KV query rows of it
//   (up to 16; a third grid axis takes larger groups 16 at a time), so the
//   KV head's keys are read once for all its query heads, not once per head.
// - The keys are split into n_split contiguous ranges, one per block along
//   the grid's y axis (flash-decoding), so B x KV x n_split blocks fill the
//   132 SMs: 8 x 1 x 16 = 128 blocks of 128 keys at the path's shape. Each
//   block writes a partial (m, l, acc[G][hd]) in fp32; a second small kernel
//   rescales and sums the partials. A range with no key writes m = NEG_INF,
//   l = 0 and drops out of the sum.
// - K/V are read in place through their batch, head and key strides (the
//   ring cache's (B, L, KV, hd) layout, no transpose), in their stored
//   dtype: bf16 beside an fp32 q is widened in registers, which is exact.
//   Tiles of 32 keys of K and V (33 KB at the path's shape) go to shared
//   memory by 16-byte cp.async, two stages, the next tile in flight while
//   the current one is used.
// - A tile is 32 keys, one a lane. Warp w owns query rows w, w+4, ... of
//   the group, ceil(G/4) of them (at most 4): a compile-time count, so the
//   warps do no work for rows past G beyond rounding G up to 4 warps. In Q.K^T a lane takes its key's row (K rows padded
//   by 16 bytes in shared memory, so the warp's loads hit distinct banks)
//   against the warp's rows of q (pre-scaled, fp32, broadcast from shared
//   memory): full dot products, no shuffles, four partial sums a row to
//   keep the FMA chains short. The softmax is then one exp a score, and
//   its max and sum are warp reductions. In P.V the lanes own 8
//   consecutive head dims each, p comes from the lane that holds it by
//   shuffle, and each row's accumulator stays in its warp's registers.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 4;                // query rows a warp owns, most
constexpr int GROUP = WARPS * MAX_ROWS;    // query rows a block owns, most
constexpr int TB = 32;                     // keys a tile, one a lane

template <typename TKV, int HD>
struct Tile {
  static constexpr int LPK = HD / 8;       // lanes a V row, 8 dims a lane
  static constexpr int KPS = 32 / LPK;     // V rows a warp takes a step
  static constexpr int EPC = 16 / (int)sizeof(TKV);  // elements a 16-B chunk
  static constexpr int CHUNKS = HD / EPC;            // chunks a row
  static constexpr int KLD = HD + EPC;     // K row stride: 16 bytes of pad
  static constexpr size_t SMEM = (size_t)GROUP * HD * 4 +
                                 2 * (size_t)TB * (KLD + HD) * sizeof(TKV);
};

// 8 consecutive elements of a row from element ``at`` on, as floats: one
// 16-byte load for bf16, two for fp32.
template <typename TKV>
__device__ __forceinline__ void load8(const TKV* row, int at, float (&x)[8]) {
  if constexpr (sizeof(TKV) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + at);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    const float4 a = *reinterpret_cast<const float4*>(row + at);
    const float4 b = *reinterpret_cast<const float4*>(row + at + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

struct Params {
  const void* q;   // (B, H, 1, hd), contiguous
  const void* k;   // (B, KV, >= n_keys, hd) through the strides below
  const void* v;
  void* o;         // (B, H, 1, hd), q's dtype
  float* acc;      // partials (B*KV, n_split, G, hd)
  float* ml;       // partials (B*KV, n_split, G, 2): m, l
  long long k_sb, k_sh, k_sk, v_sb, v_sh, v_sk;   // element strides
  int H, KV, G, n_keys, n_split;
  float softcap, scale;
};

template <typename TQ, typename TKV, int HD, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
flash_decode_kernel(const Params p) {
  using T = Tile<TKV, HD>;
  constexpr int LPK = T::LPK, KPS = T::KPS, KLD = T::KLD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);        // [GROUP][HD]
  TKV* ks = reinterpret_cast<TKV*>(qs + GROUP * HD); // [2][TB][KLD]
  TKV* vs = ks + 2 * TB * KLD;                       // [2][TB][HD]

  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / p.KV, kvh = bkv % p.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % LPK, sub = lane / LPK;
  const int g0 = blockIdx.z * WARPS * ROWS;          // the block's rows
  int nr = 0;                                        // live rows of the warp
#pragma unroll
  for (int r = 0; r < ROWS; ++r) nr += g0 + warp + WARPS * r < p.G;

  const int per = (p.n_keys + p.n_split - 1) / p.n_split;
  const int k_begin = min(p.n_keys, split * per);
  const int k_end = min(p.n_keys, k_begin + per);
  const int n_tiles = (k_end - k_begin + TB - 1) / TB;

  const TKV* kb = static_cast<const TKV*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const TKV* vb = static_cast<const TKV*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  auto load_tile = [&](int t, int stage) {
    const int key0 = k_begin + t * TB;
    for (int i = threadIdx.x; i < TB * T::CHUNKS; i += THREADS) {
      const int j = i / T::CHUNKS, off = (i % T::CHUNKS) * T::EPC;
      const bool in = key0 + j < k_end;
      const long long key = in ? key0 + j : k_begin;
      cp_async16(ks + (stage * TB + j) * KLD + off, kb + key * p.k_sk + off,
                 in);
      cp_async16(vs + (stage * TB + j) * HD + off, vb + key * p.v_sk + off,
                 in);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0, 0);

  // the block's query rows, pre-scaled, fp32; rows past G are zero
  for (int i = threadIdx.x; i < WARPS * ROWS * HD; i += THREADS) {
    const int g = g0 + i / HD;
    qs[i] = g < p.G ? to_f(static_cast<const TQ*>(p.q)[
                          ((long long)b * p.H + kvh * p.G + g) * HD +
                          i % HD]) * p.scale
                    : 0.f;
  }

  float acc[ROWS][8], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = REPRO_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n_in = min(TB, k_end - (k_begin + t * TB));
    const TKV* kt = ks + stage * TB * KLD;
    const TKV* vt = vs + stage * TB * HD;

    // scores: lane = key, the warp's rows; zero q rows past G give 0
    float part[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[r][e] = 0.f;
    const TKV* krow = kt + lane * KLD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 8) {
      float kf[8];
      load8<TKV>(krow, d, kf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float* qrow = qs + (warp + WARPS * r) * HD + d;
        const float4 a = *reinterpret_cast<const float4*>(qrow);
        const float4 z = *reinterpret_cast<const float4*>(qrow + 4);
        part[r][0] = fmaf(a.x, kf[0], part[r][0]);
        part[r][1] = fmaf(a.y, kf[1], part[r][1]);
        part[r][2] = fmaf(a.z, kf[2], part[r][2]);
        part[r][3] = fmaf(a.w, kf[3], part[r][3]);
        part[r][0] = fmaf(z.x, kf[4], part[r][0]);
        part[r][1] = fmaf(z.y, kf[5], part[r][1]);
        part[r][2] = fmaf(z.z, kf[6], part[r][2]);
        part[r][3] = fmaf(z.w, kf[7], part[r][3]);
      }
    }

    // online softmax: one exp a score, warp reductions for max and sum
    float pr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      pr[r] = 0.f;
      if (r >= nr) continue;
      float s = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
      if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      if (lane >= n_in) s = REPRO_NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(s));
      pr[r] = lane < n_in ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pr[r]);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
    }

    // P.V: hd/8 lanes a V row; p from the lane that holds it
#pragma unroll 4
    for (int j0 = 0; j0 < n_in; j0 += KPS) {
      const int j = j0 + sub;
      float vf[8];
      load8<TKV>(vt + j * HD, c * 8, vf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pr[r], j);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pj, vf[e], acc[r][e]);
      }
    }
    __syncthreads();   // the stage is refilled two tiles on
  }

  // lanes that took other keys of a step hold other parts of the sums
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nr || sub != 0) break;
    const long long row =
        ((long long)bkv * p.n_split + split) * p.G + g0 + warp + WARPS * r;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      p.acc[row * HD + c * 8 + e] = acc[r][e];
    if (lane == 0) {
      p.ml[2 * row] = m[r];
      p.ml[2 * row + 1] = l[r];
    }
  }
}

// One block a query row (b, h), one thread a head dim: the partials of its
// n_split key ranges rescaled to their common max and summed.
template <typename TQ>
__global__ void flash_decode_combine(const Params p, int hd) {
  const int row = blockIdx.x;                  // b * H + h
  const int d = threadIdx.x;
  const int b = row / p.H, h = row % p.H;
  const int kvh = h / p.G, g = h % p.G;
  const long long base = ((long long)b * p.KV + kvh) * p.n_split * p.G + g;
  float mx = REPRO_NEG_INF;
  for (int s = 0; s < p.n_split; ++s)
    mx = fmaxf(mx, p.ml[2 * (base + (long long)s * p.G)]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < p.n_split; ++s) {
    const long long r = base + (long long)s * p.G;
    const float w = expf(p.ml[2 * r] - mx);
    l += w * p.ml[2 * r + 1];
    a += w * p.acc[r * hd + d];
  }
  static_cast<TQ*>(p.o)[(long long)row * hd + d] =
      from_f<TQ>(a / fmaxf(l, 1e-20f));
}

template <typename TQ, typename TKV, int HD, int ROWS>
cudaError_t launch(const Params& p, int B, int device, cudaStream_t s) {
  constexpr size_t smem = Tile<TKV, HD>::SMEM;
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(flash_decode_kernel<TQ, TKV, HD, ROWS>,
                               smem_set, device, smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = WARPS * ROWS;
  const dim3 grid(B * p.KV, p.n_split, (p.G + rows - 1) / rows);
  flash_decode_kernel<TQ, TKV, HD, ROWS><<<grid, THREADS, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine<TQ><<<B * p.H, HD, 0, s>>>(p, HD);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HD>
cudaError_t dispatch_rows(const Params& p, int B, int device,
                          cudaStream_t s) {
  switch (p.G <= 4 ? 1 : p.G <= 8 ? 2 : p.G <= 12 ? 3 : 4) {
    case 1: return launch<TQ, TKV, HD, 1>(p, B, device, s);
    case 2: return launch<TQ, TKV, HD, 2>(p, B, device, s);
    case 3: return launch<TQ, TKV, HD, 3>(p, B, device, s);
    default: return launch<TQ, TKV, HD, 4>(p, B, device, s);
  }
}

template <typename TQ, typename TKV>
cudaError_t dispatch_hd(const Params& p, int B, int hd, int device,
                        cudaStream_t s) {
  switch (hd) {
    case 16: return dispatch_rows<TQ, TKV, 16>(p, B, device, s);
    case 32: return dispatch_rows<TQ, TKV, 32>(p, B, device, s);
    case 64: return dispatch_rows<TQ, TKV, 64>(p, B, device, s);
    case 128: return dispatch_rows<TQ, TKV, 128>(p, B, device, s);
    case 256: return dispatch_rows<TQ, TKV, 256>(p, B, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One query a head over n_keys cached keys: the split kernel, then the
// combine, on ``stream``. ``part`` holds B*KV*n_split*G*(hd + 2) floats of
// scratch. K/V strides are in elements; the last dim has stride 1. dtypes:
// q and K/V the same, or an fp32 q with bf16 K/V. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, void* o, void* part, int B,
    int H, int KV, int hd, int n_keys, long long k_sb, long long k_sh,
    long long k_sk, long long v_sb, long long v_sh, long long v_sk,
    int n_split, float softcap, int q_dtype, int kv_dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (KV <= 0 || H % KV || n_split <= 0 || n_keys < 0)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.acc = static_cast<float*>(part);
  p.ml = p.acc + (long long)B * KV * n_split * (H / KV) * hd;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sk = k_sk;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sk = v_sk;
  p.H = H; p.KV = KV; p.G = H / KV; p.n_keys = n_keys; p.n_split = n_split;
  p.softcap = softcap;
  p.scale = 1.f / sqrtf(static_cast<float>(hd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == REPRO_F32 && kv_dtype == REPRO_F32)
    return dispatch_hd<float, float>(p, B, hd, device, s);
  if (q_dtype == REPRO_F32 && kv_dtype == REPRO_BF16)
    return dispatch_hd<float, __nv_bfloat16>(p, B, hd, device, s);
  if (q_dtype == REPRO_BF16 && kv_dtype == REPRO_BF16)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(p, B, hd, device, s);
  return cudaErrorInvalidValue;
}
