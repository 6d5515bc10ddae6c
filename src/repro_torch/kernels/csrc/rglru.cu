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
// The TPU grid (B, channel blocks, time blocks) carried h across its
// sequential time axis in VMEM scratch. Here nothing carries over between
// blocks, so each channel's T tokens are walked by one thread holding h in
// a register, each step __fadd_rn(__fmul_rn(a, h), b): no FMA contraction,
// so both kernels below round exactly as the plain version's separate
// multiply and add do, and h and h_T are bitwise `rglru_ref`'s at any
// shape. T is never split across blocks (a scan of per-block (prod a, h)
// pairs would round otherwise).
//
// `rglru_staged_kernel`, the main form: a block owns a tile of W = 64
// channels of one batch row (grid (ceil(C / W), B)), so a token's tile
// row is one 256 B run: 320 / 160 blocks at 8 and 4 x 2560 channels, 40
// at the tensor-parallel rank's 4 x 640, where the channel-per-thread grid
// has 160 / 80 / 20 blocks of 128. Bytes in flight, not arithmetic, held
// that grid back (Little's law: megabytes across the card at 3.35 TB/s
// and DRAM's latency). So one lane of a producer warp keeps a ring of
// `depth` stages in shared memory full through the copy engine, a stage
// being one box of a's and one of b's 3-D tensor maps (B, T, C), STAGE
// tokens x W channels of one row (cp.async.bulk.tensor: two instructions a
// stage), completing on the stage's "full" mbarrier with the two boxes'
// bytes, whole even for the short last stage where T % STAGE != 0 and the
// short last tile where C % W != 0 (the copy engine fills what lies past
// the edge with zeros, which no thread reads). A copy per token row
// instead (cp.async.bulk, the lanes of a warp issuing them) took ~29 ns a
// copy a block on the H100, one after another: 30.6 us at the
// tensor-parallel rank's 1,024 copies a block, slower than the serial
// form's 24.9. The consumers, a thread a channel, read the stage's rows
// (W consecutive floats: conflict-free), step h and write it coalesced
// straight to global; each consumer warp then arrives on the stage's
// "empty" mbarrier, which the producer waits on before it refills the
// slot. The ring's depth comes from the wrapper (`rglru.staged_plan`: a
// grid resident at once gets rings that hold 2 MiB across it, at least 2
// stages; a grid of more than two blocks an SM runs in waves of one block
// an SM with rings of 8); any depth gives the same bits. On the H100
// (PERF.md §6), tiles of 64 ran faster than tiles of 32 or 16 at every
// path shape, even the tensor-parallel rank's 40 blocks against 160 of
// 16; at 160 blocks rings of 2 ran faster than deeper ones (0.1061 ms at
// 4 x 2560 x 2560 against 0.1142 with 3), at 320 one block an SM with a
// ring of 8 ran faster than all resident (0.2133 against 0.2203). The
// tensor maps need a and b 16-byte aligned and C % 4 == 0 (a row's stride
// a multiple of 16 bytes): the staged form runs where those hold and
// T >= STAGE. The maps are encoded on the host at
// each launch and passed as kernel parameters, so a CUDA graph replays
// them as captured.
//
// `rglru_kernel`, the serial form, runs everywhere else: decode (T = 1),
// short prompts, C % 4 != 0, a view at an unaligned offset. One thread owns
// one (b, c) channel and walks all T tokens itself; neighbouring threads
// take neighbouring c, so every load and store is coalesced. The token loop
// runs in groups of U: the loads of group g+1 are issued before group g's
// chain of dependent steps. With one thread a channel its grid is B*C/128
// blocks (20 at the tensor-parallel rank), which is why the staged form
// exists.
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
// the staged form: tokens a ring stage (rglru.STAGE_TOKENS), channels a
// tile (rglru.WIDTH), its block (a consumer thread a channel, then the
// producer warp), a slot of the ring (a box of a and one of b)
constexpr int STAGE = 32;
constexpr int W = 64;
constexpr int STAGED_THREADS = W + 32;
constexpr int SLOT = 2 * STAGE * W;                    // floats
constexpr size_t STAGED_SMEM_MAX = 232448;   // 227 KB, a block's most

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


// The staged form (see the top). W consumer threads, one a channel (warps
// 0 and 1), then a producer warp of which lane 0 works. Dynamic shared
// memory, from a 128-byte aligned base: `depth` slots of [a STAGE x W | b
// STAGE x W] floats (a box of each map), then the depth "full" and depth
// "empty" barriers (one arrival a consumer warp).
__global__ void __launch_bounds__(STAGED_THREADS)
rglru_staged_kernel(const __grid_constant__ CUtensorMap ma,
                    const __grid_constant__ CUtensorMap mb,
                    const float* __restrict__ h0, float* __restrict__ h,
                    float* __restrict__ h_T, int T, int C, int depth) {
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + (-smem_addr(smem_raw) & 127u));
  auto* full = reinterpret_cast<unsigned long long*>(ring + depth * SLOT);
  auto* empty = full + depth;
  const int c0 = blockIdx.x * W;
  const int row = blockIdx.y;
  const int j = threadIdx.x;                           // a consumer's channel
  const int stages = (T + STAGE - 1) / STAGE;
  if (threadIdx.x == 0) {
    for (int i = 0; i < depth; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, W / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= W) {                              // the producer
    if (threadIdx.x != W) return;
    int slot = 0;
    unsigned round = 0;                                // parity of s / depth
    for (int s = 0; s < stages; ++s) {
      if (s >= depth) mbar_wait(empty + slot, round ^ 1);
      // whole boxes: the short last stage and tile arrive zero-filled
      mbar_expect(full + slot, SLOT * 4);
      float* sa = ring + slot * SLOT;
      tma_load_3d(sa, &ma, c0, s * STAGE, row, full + slot);
      tma_load_3d(sa + STAGE * W, &mb, c0, s * STAGE, row, full + slot);
      if (++slot == depth) {
        slot = 0;
        round ^= 1;
      }
    }
    return;
  }

  const bool live = c0 + j < C;                        // short last tile
  float hv = live ? h0[(long long)row * C + c0 + j] : 0.f;
  float* out = h + (long long)row * T * C + c0 + j;
  int slot = 0;
  unsigned round = 0;
  for (int s = 0; s < stages; ++s) {
    const int t0 = s * STAGE;
    const int rows = min(STAGE, T - t0);               // short last stage
    mbar_wait(full + slot, round);
    const float* sa = ring + slot * SLOT + j;
    const float* sb = sa + STAGE * W;
    float* o = out + (long long)t0 * C;
    if (live) {
      if (rows == STAGE) {
        float av[STAGE], bv[STAGE];
#pragma unroll
        for (int i = 0; i < STAGE; ++i) {
          av[i] = sa[i * W];
          bv[i] = sb[i * W];
        }
#pragma unroll
        for (int i = 0; i < STAGE; ++i) {
          hv = step(av[i], hv, bv[i]);
          o[(long long)i * C] = hv;
        }
      } else {
        for (int i = 0; i < rows; ++i) {
          hv = step(sa[i * W], hv, sb[i * W]);
          o[(long long)i * C] = hv;
        }
      }
    }
    __syncwarp();                      // every lane's reads of the slot done
    if (j % 32 == 0) mbar_arrive(empty + slot);
    if (++slot == depth) {
      slot = 0;
      round ^= 1;
    }
  }
  if (live) h_T[(long long)row * C + c0 + j] = hv;
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

// The staged form's launch: a ring of `depth` stages, from
// rglru.staged_plan; the caller has checked T >= STAGE, C % 4 == 0 and a,
// b 16-byte aligned. Encodes a's and b's tensor maps (boxes of W channels
// x STAGE tokens of one row), then launches. Returns cudaGetLastError()
// after the launch (0 = launched), or the error that kept it from
// launching: cudaErrorInvalidValue for a depth that does not fit.
cudaError_t launch_staged(const float* a, const float* b, const float* h0,
                          float* h, float* h_T, int B, int T, int C,
                          int depth, int device, cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  const size_t smem = (size_t)depth * (SLOT * 4 + 16) + 128;
  if (depth < 1 || smem > STAGED_SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(rglru_staged_kernel, smem_set, device,
                               STAGED_SMEM_MAX);
  if (err != cudaSuccess) return err;
  alignas(64) CUtensorMap ma, mb;
  err = tile_map_3d(&ma, a, B, T, C, 1, STAGE, W);
  if (err == cudaSuccess) err = tile_map_3d(&mb, b, B, T, C, 1, STAGE, W);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + W - 1) / W, B);
  rglru_staged_kernel<<<grid, STAGED_THREADS, smem, stream>>>(
      ma, mb, h0, h, h_T, T, C, depth);
  return cudaGetLastError();
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

// The staged form (rglru_staged_kernel) with a ring of `depth` stages.
extern "C" int repro_rglru_staged(const void* a, const void* b,
                                  const void* h0, void* h, void* h_T, int B,
                                  int T, int C, int depth, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (T < STAGE || C % 4) return cudaErrorInvalidValue;
  return launch_staged(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_T), B, T, C, depth, device,
      static_cast<cudaStream_t>(stream));
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
