// The split-KV decode body shared by the port's two one-query attention
// kernels, for Hopper (sm_90a): flash's decode form (csrc/flash_decode.cu,
// keys of a strided view: the ring cache) and paged decode
// (csrc/paged_attention.cu, keys in a paged pool). The two differ only in
// where key j of a row lies and how many keys the row has. A key-source
// policy passed as a template parameter says both (StridedKeys, PagedKeys),
// and load_tile is the one place that turns a key into an address.
//
// What bounds both on the H100: bytes. Each cached K/V element is read once
// and used for G multiply-adds, far below the ~295 flop/byte the card needs
// before its arithmetic is the limit. So every cached byte is read once, in
// its stored dtype, and enough of them are in flight:
//
// - A block owns one (row, KV head) and holds all G = H/KV query rows of it
//   (up to 16; a third grid axis takes larger groups 16 at a time), so the
//   KV head's keys are read once for all its query heads, not once per head.
// - A row's n keys are split into n_split contiguous ranges of
//   ceil(n / n_split), one per block along the grid's y axis
//   (flash-decoding), so that few long rows still fill the 132 SMs. Each
//   block writes a partial (m, l, acc[G][hd]) in fp32; a second small
//   kernel rescales and sums the partials. A range with no key writes m =
//   NEG_INF, l = 0 and drops out of the sum. With n_split == 1 there is no
//   second kernel: the block normalises and writes the output itself, so a
//   call is one launch.
// - Tiles of 32 keys of K and V go to shared memory by 16-byte cp.async in
//   a ring of three stages: the next two tiles are in flight while the
//   current one is used, and one barrier a tile both publishes the tile
//   that landed and frees the stage it refills. A bf16 K/V beside an fp32 q
//   is widened in registers, which is exact.
// - A tile is 32 keys, one a lane. Warp w owns query rows w, w+4, ... of
//   the group, ceil(G/4) of them (at most 4): a compile-time count; a warp
//   with no row below G (warps 2 and 3 at G = 2) only loads tiles. In
//   Q.K^T a lane takes its key's row (K rows padded by 16 bytes in shared
//   memory, so the warp's loads hit distinct banks) against the warp's rows
//   of q (pre-scaled, fp32, broadcast from shared memory): full dot
//   products, no shuffles, four partial sums a row to keep the FMA chains
//   short. The softmax is then one exp a score, and its max and sum are
//   warp reductions. In P.V the lanes own 8 consecutive head dims each, p
//   comes from the lane that holds it by shuffle, and each row's
//   accumulator stays in its warp's registers.
#pragma once

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 4;                // query rows a warp owns, most
constexpr int GROUP = WARPS * MAX_ROWS;    // query rows a block owns, most
constexpr int TB = 32;                     // keys a tile, one a lane
constexpr int STAGES = 3;                  // tiles in the shared ring

template <typename TKV, int HD>
struct Tile {
  static constexpr int LPK = HD / 8;       // lanes a V row, 8 dims a lane
  static constexpr int KPS = 32 / LPK;     // V rows a warp takes a step
  static constexpr int EPC = 16 / (int)sizeof(TKV);  // elements a 16-B chunk
  static constexpr int CHUNKS = HD / EPC;            // chunks a row
  static constexpr int KLD = HD + EPC;     // K row stride: 16 bytes of pad
  static constexpr size_t SMEM = (size_t)GROUP * HD * 4 +
                                 STAGES * (size_t)TB * (KLD + HD) *
                                     sizeof(TKV);
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

// 8 floats to 8 consecutive elements of a row from element ``at`` on: one
// 16-byte store for bf16 (rounded to nearest), two for fp32.
template <typename T>
__device__ __forceinline__ void store8(T* row, int at, const float (&x)[8]) {
  if constexpr (sizeof(T) == 2) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(row + at) = raw;
  } else {
    *reinterpret_cast<float4*>(row + at) = make_float4(x[0], x[1], x[2],
                                                       x[3]);
    *reinterpret_cast<float4*>(row + at + 4) = make_float4(x[4], x[5], x[6],
                                                           x[7]);
  }
}

struct Params {
  const void* q;   // (B, H, 1, hd) = (B, KV, G, hd), contiguous
  const void* k;   // strided: (B, KV, >= n_keys, hd) through the strides
  const void* v;   // below; paged: the pools (P, KV, page, hd), contiguous
  void* o;         // like q, in q's dtype
  float* acc;      // partials (B*KV, n_split, G, hd); none when n_split == 1
  float* ml;       // partials (B*KV, n_split, G, 2): m, l
  const int* bt;   // paged: block tables (B, maxp)
  const int* lengths;   // paged: keys of each row (B,)
  long long k_sb, k_sh, k_sk, v_sb, v_sh, v_sk;   // strided: element strides
  int H, KV, G, n_split;
  int n_keys;      // strided: keys of every row
  int page, maxp;  // paged
  float softcap, scale;
};

// Keys of a strided view: key j of (b, kvh) at element b*sb + kvh*sh +
// j*sk of K (and likewise of V), n_keys of them in every row.
struct StridedKeys {
  static constexpr bool kPaged = false;
  long long k0, v0, sk, sv;
  int n;
  __device__ StridedKeys(const Params& p, int b, int kvh)
      : k0(b * p.k_sb + kvh * p.k_sh), v0(b * p.v_sb + kvh * p.v_sh),
        sk(p.k_sk), sv(p.v_sk), n(p.n_keys) {}
  __device__ long long k_at(int key) const { return k0 + key * sk; }
  __device__ long long v_at(int key) const { return v0 + key * sv; }
};

// Keys in a paged pool (P, KV, page, hd): key j of (b, kvh) at element
// ((bt[b][j / page] * KV + kvh) * page + j % page) * hd, the same in K's and
// V's pool; min(lengths[b], maxp * page) keys in row b (the TPU grid walks
// maxp pages). The block reads its own block-table row and length, which
// the TPU got by scalar prefetch.
struct PagedKeys {
  static constexpr bool kPaged = true;
  const int* bt;
  int kvh, KV, page, n;
  __device__ PagedKeys(const Params& p, int b, int kvh)
      : bt(p.bt + (long long)b * p.maxp), kvh(kvh), KV(p.KV), page(p.page),
        n(min(max(p.lengths[b], 0), p.maxp * p.page)) {}
  template <int HD>
  __device__ long long at(int key) const {
    return (((long long)__ldg(bt + key / page) * KV + kvh) * page +
            key % page) * HD;
  }
};

// The small instances (one query row a warp, hd <= 64) keep 8 blocks an
// SM (64 registers a thread at most), so that 1,024 (row, KV head) blocks of
// a long paged batch run in one wave of 132 x 8; the others 1 at least.
template <typename Keys, typename TQ, typename TKV, int HD, int ROWS>
__global__ void __launch_bounds__(THREADS, (ROWS == 1 && HD <= 64) ? 8 : 1)
decode_attention_kernel(const Params p) {
  using T = Tile<TKV, HD>;
  constexpr int LPK = T::LPK, KPS = T::KPS, KLD = T::KLD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);        // [GROUP][HD]
  TKV* ks = reinterpret_cast<TKV*>(qs + GROUP * HD); // [STAGES][TB][KLD]
  TKV* vs = ks + STAGES * TB * KLD;                  // [STAGES][TB][HD]

  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / p.KV, kvh = bkv % p.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % LPK, sub = lane / LPK;
  const int g0 = blockIdx.z * WARPS * ROWS;          // the block's rows
  int nr = 0;                                        // live rows of the warp
#pragma unroll
  for (int r = 0; r < ROWS; ++r) nr += g0 + warp + WARPS * r < p.G;

  const Keys keys(p, b, kvh);
  const int per = (keys.n + p.n_split - 1) / p.n_split;
  const int k_begin = min(keys.n, split * per);
  const int k_end = min(keys.n, k_begin + per);
  const int n_tiles = (k_end - k_begin + TB - 1) / TB;
  const TKV* kg = static_cast<const TKV*>(p.k);
  const TKV* vg = static_cast<const TKV*>(p.v);

  // The tile's keys to shared memory, one 16-byte cp.async a chunk; keys
  // past the range are zero-filled and read nothing. A paged key is looked
  // up once a warp, by the lane of the same index (clamped into the range,
  // so every address lies in a live page), and its chunks take the offset
  // by shuffle. Every warp runs the loop the same number of times.
  auto load_tile = [&](int t, int stage) {
    const int key0 = k_begin + t * TB;
    long long mine = 0;
    if constexpr (Keys::kPaged)
      mine = keys.template at<HD>(min(key0 + lane, k_end - 1));
    for (int i = threadIdx.x; i < TB * T::CHUNKS; i += THREADS) {
      const int j = i / T::CHUNKS, off = (i % T::CHUNKS) * T::EPC;
      const bool in = key0 + j < k_end;
      long long ko, vo;
      if constexpr (Keys::kPaged) {
        ko = vo = __shfl_sync(0xffffffffu, mine, j);
      } else {
        const int key = in ? key0 + j : k_begin;
        ko = keys.k_at(key);
        vo = keys.v_at(key);
      }
      cp_async16(ks + (stage * TB + j) * KLD + off, kg + ko + off, in);
      cp_async16(vs + (stage * TB + j) * HD + off, vg + vo + off, in);
    }
    cp_async_commit();
  };
  // the first STAGES - 1 tiles in flight, one group each (empty past the
  // range, so that every thread counts the same groups)
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t, t);
    else cp_async_commit();
  }

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
    // tile t has landed, and every warp is done with tile t - 1, whose
    // stage now takes tile t + STAGES - 1
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < n_tiles)
      load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    else
      cp_async_commit();
    const int stage = t % STAGES;
    if (nr == 0) continue;   // no live query row: this warp only loads
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
    const int g = g0 + warp + WARPS * r;
    if (p.n_split == 1) {   // the only range: normalise, write the output
      const float inv = 1.f / fmaxf(l[r], 1e-20f);
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = acc[r][e] * inv;
      store8<TQ>(static_cast<TQ*>(p.o) +
                     ((long long)b * p.H + kvh * p.G + g) * HD,
                 c * 8, x);
      continue;
    }
    const long long row = ((long long)bkv * p.n_split + split) * p.G + g;
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
__global__ void decode_attention_combine(const Params p, int hd) {
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

// The split kernel over B rows, then, for more than one range, the
// combine, on ``s``.
template <typename Keys, typename TQ, typename TKV, int HD, int ROWS>
cudaError_t launch(const Params& p, int B, int device, cudaStream_t s) {
  constexpr size_t smem = Tile<TKV, HD>::SMEM;
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(
      decode_attention_kernel<Keys, TQ, TKV, HD, ROWS>, smem_set, device,
      smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = WARPS * ROWS;
  const dim3 grid(B * p.KV, p.n_split, (p.G + rows - 1) / rows);
  decode_attention_kernel<Keys, TQ, TKV, HD, ROWS>
      <<<grid, THREADS, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  decode_attention_combine<TQ><<<B * p.H, HD, 0, s>>>(p, HD);
  return cudaGetLastError();
}

template <typename Keys, typename TQ, typename TKV, int HD>
cudaError_t dispatch_rows(const Params& p, int B, int device,
                          cudaStream_t s) {
  switch (p.G <= 4 ? 1 : p.G <= 8 ? 2 : p.G <= 12 ? 3 : 4) {
    case 1: return launch<Keys, TQ, TKV, HD, 1>(p, B, device, s);
    case 2: return launch<Keys, TQ, TKV, HD, 2>(p, B, device, s);
    case 3: return launch<Keys, TQ, TKV, HD, 3>(p, B, device, s);
    default: return launch<Keys, TQ, TKV, HD, 4>(p, B, device, s);
  }
}

// The kernel for head dim ``hd`` (16, 32, 64, 128 or 256) and the group
// size in p.G.
template <typename Keys, typename TQ, typename TKV>
cudaError_t dispatch_hd(const Params& p, int B, int hd, int device,
                        cudaStream_t s) {
  switch (hd) {
    case 16: return dispatch_rows<Keys, TQ, TKV, 16>(p, B, device, s);
    case 32: return dispatch_rows<Keys, TQ, TKV, 32>(p, B, device, s);
    case 64: return dispatch_rows<Keys, TQ, TKV, 64>(p, B, device, s);
    case 128: return dispatch_rows<Keys, TQ, TKV, 128>(p, B, device, s);
    case 256: return dispatch_rows<Keys, TQ, TKV, 256>(p, B, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
