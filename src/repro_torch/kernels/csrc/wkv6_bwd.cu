// The gradient of RWKV-6's WKV recurrence, for Hopper (sm_90a): chunk-
// parallel, the products through a state on the tensor cores.
//
// The contract of `wkv6_bhtk` (wkv6.cu, kernels/rwkv6.py): per (b, h)
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(logw_t),  S_{-1} = s0.
// Given dy (B,H,T,K) in r's dtype and dS = dL/ds_T (B,H,K,K) fp32, either
// absent (a null pointer: zero), and G_t = dL/dS_t with G_{T-1} = dS:
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,              ds0 = G_{-1};
//   dr_t = S_{t-1} dy_t + u . k_t (v_t . dy_t);
//   dk_t = G_t v_t + u . r_t (v_t . dy_t);
//   dv_t = G_t^T k_t + beta_t dy_t,  beta_t = sum_i r_t[i] u[i] k_t[i];
//   dlogw_t = w_t . rowsum(G_t . S_{t-1});
//   du = sum over b and t of r_t . k_t (v_t . dy_t).
// dr, dk and dv come out in r's dtype, dlogw, du and ds0 in fp32.
//
// What it replaces. The TPU package has no backward kernel: it trains the
// recurrence through XLA (`wkv6_chunked`, ssm_impl "xla"). This is the
// gradient of the function its Pallas kernel src/repro/kernels/rwkv6.py
// (`wkv6_bhtk`) computes, which `WKV6.backward` launches on CUDA tensors in
// place of a plain PyTorch backward.
//
// What bounds it on the H100. The function's work (`cost.wkv6_bwd_work`)
// is six multiply-adds a state element a token: at 8 x 64 x 512 x 64 that
// is 12.9 GFLOP, 0.19 ms at the 67 TFLOP/s fp32 rate, against 0.39 GB of
// inputs and gradients (0.12 ms at 3.35 TB/s). This design moves the
// products through a state to the tensor cores (split TF32, below, at 165
// TFLOP/s of fp32 products: 0.08 ms) and adds traffic of its own: the
// states at every chunk boundary, written once by (a) and read once by (b)
// (537 MB at C = 16, 0.32 ms), and the in-chunk pair terms on the CUDA
// cores, about 10 C K operations a token. Measured (chip_smoke.py phases
// 10e and 10g; PERF.md): (a) runs near its traffic at the
// training shape and is held by its walk's latency at a rank's 4 x 16
// heads; a block of (b) by the latency of its phases in turn (staging,
// products, walks; 2 blocks an SM at its 122 registers), not by its
// operations. C = 16 (`CHUNK`) took less than C = 32 at every shape
// measured (PERF.md): C = 32's pair walks cost twice a token and its block
// 182 KB of shared memory.
//
// Scratch. Those boundary states, Sst and Gst, are fp32 (B, H, ceil(T/C),
// K, K) each, allocated by the wrapper on every call: 2 x 4 B x K^2 / C a
// token and head, 2 KB at K = 64, growing linearly with T (537 MB at 8 x
// 64 x 512, about 4.3 GB at 4,096 tokens), freed when the call returns.
//
// Design. T is cut into chunks of C = CHUNK tokens (the wrapper's
// BWD_CHUNK), the last one padded with zero tokens (w = 1). Per chunk,
// with S the state before it and G the gradient of the state after it:
// - (a) `wkv6_bwd_carry_kernel`, one block a (b, h, 16 rows of the state),
//   two warps: one walks the chunks forward, S <- A S + (B . k)^T V, the
//   other backward, G <- A G + (A' . r)^T dY (A the chunk's whole decay, B
//   the decay after each token, A' before it), each product on mma.sync in
//   the accumulator registers where S (G) lives, the next chunk's rows in
//   flight by cp.async; each writes its state at every chunk (S before, G
//   after), and the backward one ds0. Rows of the state evolve apart, so a
//   walk needs nothing of the other rows. A is carried as its deficit y =
//   1 - A and applied as S - y S: A near 1 rounded to fp32 would lose the
//   low bits of 1 - A alike at every chunk, an error that compounds over
//   the chunks (tools/wkv6_grad_precision.py prints the algorithm's).
// - (b) `wkv6_bwd_chunk_kernel`, one block a (b, h, chunk), 8 warps: from
//   S, G and the chunk's tokens, dr, dk, dv and dlogw of its C tokens and
//   du's part. The terms through S or G are products on mma.sync: M = dY
//   V^T (C x C), S dY^T, G V^T, (B . K) G and P dY. The pair terms of two
//   tokens a < b of the chunk carry the decay of the tokens between them
//   on each channel, so they are walks on the CUDA cores, C/2 lanes a
//   channel, each lane two tokens t and C-1-t (their walks' lengths add to
//   C-1, so no lane idles on the triangle): (i) token b runs a < b, H_b <-
//   H_b - d_a H_b + k_a M[b, a] (dr's pair term, kept for each a in a
//   triangle table), and likewise dk's term through G (gamma) and the
//   decay A' before b; (ii) token t runs b > t with the factor f = F[t, b],
//   summing dk's pair term, dlogw's terms through S (alpha) and through
//   both pairs (pi, from the kept H) and, over the block's channels, P[t,
//   b] = sum_i k_t r_b f; f ends as B. dlogw_t = w_t (A' (B X + alpha) + B
//   gamma + pi), X = rowsum(S . G): the direct product w_t rowsum(G_t .
//   S_{t-1}) expanded over the chunk's terms, w_t = exp(logw_t) itself (a
//   small w keeps its gradient), no difference of cumulative sums. Arrays
//   dead by the time another is written share its room (72 KB a block).
// - (c) `wkv6_bwd_du_kernel`: du, the parts summed over b and the chunks in
//   order.
// - Decays: a factor between two tokens is built one token at a time by
//   steps x - d x, d = 1 - w taken as -expm1(logw) (near logw = -1e-6, w
//   rounded to fp32 is off by up to 3% of 1 - w, with the same sign at
//   every token), walking the tokens between the two in sequence; never
//   exp of a difference of prefix sums. At the floor d is exactly 1 and a
//   factor across the token exactly 0.
// - Tensor cores: fp32 products as three TF32 products of the split x =
//   hi + lo (mma.cuh's `mma_tf32x3`, about fp32's accuracy), each sum in
//   two partials of at most 4 k-steps on the tensor cores added in fp32 (a
//   long tensor-core sum truncates). An operand that holds bf16 inputs is
//   exact in TF32: it is not split, and its lo products are skipped.
// - Order: every sum in a fixed order, no float atomics; the grid is set
//   by the shapes alone, so two calls, and any card, give the same bits.
// wkv6_bwd_chunk_ref in rwkv6.py repeats this algorithm in plain PyTorch.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int CHUNK = 16;        // tokens a chunk: rwkv6.py's BWD_CHUNK
constexpr int CHUNK_WARPS = 8;   // warps of a chunk block
constexpr int SLAB = 16;         // state rows a carry walk
constexpr int CARRY_STAGES = 2;  // chunks a carry walk has staged or in flight

// acc += A . B over KS k-steps of 8 for the 16 x 8 tile at (m0, n0), a(m,
// k) and b(k, n) reading shared memory: split TF32 (an operand flagged
// exact, AX or BX, holds bf16 values, which TF32 keeps whole: no split and
// no product of its lo part); the tensor cores sum the even and the odd
// k-steps in two partials (independent chains, at most 4 k-steps each:
// KS <= 8), added to acc in fp32, even first
template <int KS, bool AX, bool BX, typename FA, typename FB>
__device__ __forceinline__ void mma_tile(float (&acc)[4], FA a, FB b, int m0,
                                         int n0, int lane) {
  static_assert(KS <= 8, "two partials of at most 4 k-steps");
  const int g = lane >> 2, t = lane & 3;
  float part[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int kk = ks * 8;
    const float av[4] = {a(m0 + g, kk + t), a(m0 + g + 8, kk + t),
                         a(m0 + g, kk + t + 4), a(m0 + g + 8, kk + t + 4)};
    const float bv[2] = {b(kk + t, n0 + g), b(kk + t + 4, n0 + g)};
    unsigned ahi[4], alo[4], bhi[2], blo[2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (AX) ahi[e] = __float_as_uint(av[e]);
      else split_tf32(__float_as_uint(av[e]), ahi[e], alo[e]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (BX) bhi[e] = __float_as_uint(bv[e]);
      else split_tf32(__float_as_uint(bv[e]), bhi[e], blo[e]);
    }
    float (&d)[4] = part[ks & 1];
    if constexpr (!AX) mma_tf32(d, alo, bhi[0], bhi[1]);
    if constexpr (!BX) mma_tf32(d, ahi, blo[0], blo[1]);
    mma_tf32(d, ahi, bhi[0], bhi[1]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = (acc[e] + part[0][e]) + part[1][e];
}

// (a) the carry: block (b h, slab), warp 0 S forward, warp 1 G backward.
// Sst / Gst (B H, n_ch, K, K): S before chunk c, G after it. Each warp
// stages its chunks' raw rows by cp.async in a ring of CARRY_STAGES, the
// next chunks' in flight while it works on this one.
template <typename T, int K, int C>
struct CarrySmem {
  static constexpr int RB = K * (int)sizeof(T) + 16;      // raw row, bytes
  static constexpr int RS = SLAB * (int)sizeof(T) + 16;   // raw slab row
  static constexpr int RL = SLAB * 4 + 16;                // logw slab row
  static constexpr int STAGE = C * (RB + RS + RL);        // bytes a stage
  static constexpr int LS = 24;                           // xb's row
  static constexpr int WARP = CARRY_STAGES * STAGE + (C * LS + SLAB) * 4;
  static constexpr int BYTES = 2 * WARP;
};

template <typename T, int K, int C>
__global__ void __launch_bounds__(64)
wkv6_bwd_carry_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const float* __restrict__ s0,
                      const T* __restrict__ dy, const float* __restrict__ dS,
                      float* __restrict__ Sst, float* __restrict__ Gst,
                      float* __restrict__ ds0, int n_tok, int n_ch) {
  using L = CarrySmem<T, K, C>;
  constexpr int LS = L::LS, NS = K / SLAB, E = 16 / (int)sizeof(T);
  constexpr bool BF = sizeof(T) == 2;  // bf16 inputs: exact in TF32
  extern __shared__ __align__(16) unsigned char craw[];
  const int bh = blockIdx.x / NS, slab = blockIdx.x % NS;
  const int wp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3, row0 = slab * SLAB;
  unsigned char* mine = craw + wp * L::WARP;
  float* xb = reinterpret_cast<float*>(mine + CARRY_STAGES * L::STAGE);
  float* af = xb + C * LS;         // 1 - the chunk's whole decay, (SLAB)
  const long long base = (long long)bh * n_tok * K;
  const long long sbase = (long long)bh * K * K;
  const bool fwd = wp == 0;
  const T* bigp = fwd ? v : dy;    // all columns: v (S walk), dy (G walk)
  const T* slp = fwd ? k : r;      // the slab's rows: k (S walk), r (G)
  const int n_walk = fwd ? n_ch - 1 : n_ch;   // chunks a walk steps over

  // chunk ch's raw rows into stage st: big (C, K), slab (C, SLAB) of slp
  // and of logw; rows past n_tok zero-filled
  auto issue = [&](int ch, int st) {
    unsigned char* s = mine + st * L::STAGE;
    const int t0 = ch * C;
    constexpr int PB = K / E, PS = SLAB / E, PL = SLAB / 4;
    for (int p = lane; p < C * (PB + PS + PL); p += 32) {
      const int t = p / (PB + PS + PL), q = p % (PB + PS + PL);
      const long long row = base + (long long)(t0 + t) * K;
      bool in = t0 + t < n_tok;
      const void* src;
      void* dst;
      if (q < PB) {
        in = in && bigp != nullptr;
        src = in ? (const void*)(bigp + row + q * E) : (const void*)slp;
        dst = s + t * L::RB + q * 16;
      } else if (q < PB + PS) {
        src = in ? (const void*)(slp + row + row0 + (q - PB) * E)
                 : (const void*)slp;
        dst = s + C * L::RB + t * L::RS + (q - PB) * 16;
      } else {
        src = in ? (const void*)(logw + row + row0 + (q - PB - PS) * 4)
                 : (const void*)logw;
        dst = s + C * (L::RB + L::RS) + t * L::RL + (q - PB - PS) * 16;
      }
      cp_async16(dst, src, in);
    }
    cp_async_commit();
  };

  float st[K / 8][4];              // the slab's rows of S (G), mma layout
  const float* init = fwd ? s0 : dS;
#pragma unroll
  for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row0 + g + (e >> 1) * 8, cc = nt * 8 + 2 * tq + (e & 1);
      st[nt][e] = init != nullptr ? init[sbase + (long long)rr * K + cc]
                                  : 0.f;
    }
  // walk step s takes chunk fwd ? s : n_ch - 1 - s from stage s % STAGES
  for (int s = 0; s < CARRY_STAGES - 1 && s < n_walk; ++s)
    issue(fwd ? s : n_ch - 1 - s, s);

  for (int s = 0; s < n_ch; ++s) {
    const int ch = fwd ? s : n_ch - 1 - s;
    float* out = (fwd ? Sst : Gst) + ((long long)bh * n_ch + ch) * K * K;
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rr = row0 + g + h2 * 8, cc = nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(out + (long long)rr * K + cc) =
            make_float2(st[nt][2 * h2], st[nt][2 * h2 + 1]);
      }
    if (s == n_walk) break;        // S after the last chunk: unused
    const int ahead = s + CARRY_STAGES - 1;
    if (ahead < n_walk) {
      issue(fwd ? ahead : n_ch - 1 - ahead, ahead % CARRY_STAGES);
      cp_async_wait<CARRY_STAGES - 1>();
    } else if (ahead - 1 < n_walk) {
      cp_async_wait<CARRY_STAGES - 2>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const unsigned char* cur = mine + (s % CARRY_STAGES) * L::STAGE;
    const T* big = reinterpret_cast<const T*>(cur);
    const T* sl = reinterpret_cast<const T*>(cur + C * L::RB);
    const float* lw = reinterpret_cast<const float*>(cur + C * (L::RB +
                                                                L::RS));
    if (lane < SLAB) {             // a row a lane, through the chunk
      // x: the decay so far; y: the same as its deficit 1 - x, which keeps
      // the low bits of 1 - x near x = 1 (exactly 1 once a factor is 0)
      float x = 1.f, y = 0.f;
      auto step = [&](int t) {
        xb[t * LS + lane] = x * to_f(sl[t * (L::RS / sizeof(T)) + lane]);
        const float d = -expm1f(lw[t * (L::RL / 4) + lane]);
        x = fmaf(-d, x, x);
        y = d == 1.f || y == 1.f ? 1.f : fmaf(-y, d, y + d);
      };
      if (fwd) {
#pragma unroll
        for (int t = C - 1; t >= 0; --t) step(t);   // B_t: the decay after t
      } else {
#pragma unroll
        for (int t = 0; t < C; ++t) step(t);        // A'_t: before t
      }
      af[lane] = y;
    }
    __syncwarp();
    const float y0 = af[g], y1 = af[g + 8];
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt) {
      float add[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tile<C / 8, false, BF>(
          add, [&](int m, int kk) { return xb[kk * LS + m]; },
          [&](int kk, int n) {
            return to_f(big[kk * (L::RB / sizeof(T)) + n]);
          },
          0, nt * 8, lane);
      st[nt][0] = fmaf(-y0, st[nt][0], st[nt][0]) + add[0];
      st[nt][1] = fmaf(-y0, st[nt][1], st[nt][1]) + add[1];
      st[nt][2] = fmaf(-y1, st[nt][2], st[nt][2]) + add[2];
      st[nt][3] = fmaf(-y1, st[nt][3], st[nt][3]) + add[3];
    }
    __syncwarp();                  // the stage is read before it is reused
  }
  if (!fwd) {
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rr = row0 + g + h2 * 8, cc = nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(ds0 + sbase + (long long)rr * K + cc) =
            make_float2(st[nt][2 * h2], st[nt][2 * h2 + 1]);
      }
  }
}

template <int K, int C>
struct ChunkSmem {
  static constexpr int LD = K + 4, LC = C + 1, NW = 64 / C;
  static constexpr int KK = K * LD, CK = C * LD, CC = C * LC;
  static constexpr int TRI = C * (C - 1) / 2;        // a pair table
  static constexpr int HT = NW * TRI;                // a warp's tables
  static constexpr int HTS = CHUNK_WARPS * HT > KK ? CHUNK_WARPS * HT : KK;
  static constexpr int FLOATS = HTS + KK + 8 * CK + 2 * CC + 2 * K + C;
};

// the pair (a, b), a < b, of a chunk's triangle table
__device__ __forceinline__ int tri(int a, int b) {
  return b * (b - 1) / 2 + a;
}

// (b) the chunk pass: block (b h, chunk), 8 warps.
template <typename T, int K, int C>
__global__ void __launch_bounds__(CHUNK_WARPS * 32)
wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const float* __restrict__ u, const T* __restrict__ dy,
                      const float* __restrict__ Sst,
                      const float* __restrict__ Gst, T* __restrict__ dr,
                      T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dlogw, float* __restrict__ du_part,
                      int H, int n_tok, int n_ch) {
  using L = ChunkSmem<K, C>;
  constexpr int LD = L::LD, LC = L::LC, NW = L::NW, NT = CHUNK_WARPS * 32;
  constexpr bool BF = sizeof(T) == 2;  // bf16 inputs: exact in TF32
  extern __shared__ __align__(16) float smem[];
  // arrays dead by the time another is written share its room: S and the
  // warps' H tables, v and B . k, S dy and dr, G v and dk, w and dlogw;
  // bf16 tokens land raw in S dy's and G v's room
  float* sS = smem;                // (K, LD) the state before the chunk
  float* sHt = smem;               // each warp's H tables, then its P part
  float* sG = smem + L::HTS;       // (K, LD) its gradient after the chunk
  float* sR = sG + L::KK;          // the tokens in fp32, (C, LD) each
  float* sK = sR + L::CK;
  float* sV = sK + L::CK;
  float* sBk = sV;                 // [t][i] = B_t[i] k_t[i]
  float* sY = sV + L::CK;          // dy
  float* sD = sY + L::CK;          // d = -expm1(logw)
  float* sW = sD + L::CK;          // w = exp(logw)
  float* sDl = sW;                 // dlogw
  float* sSdY = sW + L::CK;        // [t][i] = (S dy_t)[i]
  float* sDr = sSdY;               // dr
  float* sGV = sSdY + L::CK;       // [t][i] = (G v_t)[i]
  float* sDk = sGV;                // dk
  float* sM = sGV + L::CK;         // (C, LC) [b][a] = dy_b . v_a
  float* sP = sM + L::CC;          // (C, LC) [t][b] = sum_i k_t r_b F[t, b]
  float* sX = sP + L::CC;          // (K) rowsum(S . G)
  float* sU = sX + K;
  float* sBeta = sU + K;           // (C)

  const int bh = blockIdx.x / n_ch, ch = blockIdx.x % n_ch, h = bh % H;
  const int tid = threadIdx.x, wp = tid / 32, lane = tid % 32;
  const int t0 = ch * C;
  const long long base = (long long)bh * n_tok * K;
  const long long cbase = ((long long)bh * n_ch + ch) * K * K;

  // stage by cp.async: S, G, logw (into sW) and the tokens; fp32 tokens
  // land in their arrays, bf16 ones raw in the outputs' room, widened after
  {
    constexpr int E = 16 / (int)sizeof(T), PK = K / E;
    T* raw = reinterpret_cast<T*>(sSdY);         // (4, C, K) of T
    const T* src4[4] = {r, k, v, dy};
    float* dst4[4] = {sR, sK, sV, sY};
    for (int p = tid; p < 4 * C * PK; p += NT) {
      const int a = p / (C * PK), t = p % (C * PK) / PK, q = p % PK;
      const bool in = t0 + t < n_tok && src4[a] != nullptr;
      const T* src = in ? src4[a] + base + (long long)(t0 + t) * K + q * E : r;
      void* dst;
      if constexpr (sizeof(T) == 4)
        dst = dst4[a] + t * LD + q * 4;
      else
        dst = raw + (a * C + t) * K + q * E;
      cp_async16(dst, src, in);
    }
    for (int p = tid; p < C * K / 4; p += NT) {
      const int t = p / (K / 4), q = p % (K / 4);
      const bool in = t0 + t < n_tok;
      cp_async16(sW + t * LD + q * 4,
                 in ? logw + base + (long long)(t0 + t) * K + q * 4 : logw,
                 in);
    }
    for (int p = tid; p < 2 * K * K / 4; p += NT) {
      const int a = p / (K * K / 4), q = p % (K * K / 4);
      cp_async16((a ? sG : sS) + 4 * q / K * LD + 4 * q % K,
                 (a ? Gst : Sst) + cbase + 4 * q, true);
    }
    cp_async_commit();
    for (int i = tid; i < K; i += NT) sU[i] = u[h * K + i];
    cp_async_wait<0>();
    __syncthreads();
    constexpr int PER = C * K / NT;   // elements a thread widens
    static_assert(PER * NT == C * K, "whole rows a pass");
    float xs[PER][4], lws[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {   // the loads first, then the stores
      const int p = tid + q * NT, t = p / K, i = p % K;
      if constexpr (sizeof(T) != 4) {
#pragma unroll
        for (int a = 0; a < 4; ++a) xs[q][a] = to_f(raw[(a * C + t) * K + i]);
      }
      lws[q] = sW[t * LD + i];
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int p = tid + q * NT, e = p / K * LD + p % K;
      if constexpr (sizeof(T) != 4) {
#pragma unroll
        for (int a = 0; a < 4; ++a) dst4[a][e] = xs[q][a];
      }
      sD[e] = -expm1f(lws[q]);
      sW[e] = expf(lws[q]);
    }
    __syncthreads();
  }

  // M = dY V^T, S dY^T and G V^T on the tensor cores, a 16 x 8 tile a turn
  {
    constexpr int TM = (C / 16) * (C / 8), TS = (C / 16) * (K / 8);
    for (int q = wp; q < TM + 2 * TS; q += CHUNK_WARPS) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float* out;
      int m0, n0, ld;
      if (q < TM) {
        m0 = q / (C / 8) * 16;
        n0 = q % (C / 8) * 8;
        mma_tile<K / 8, BF, BF>(
            acc, [&](int m, int kk) { return sY[m * LD + kk]; },
            [&](int kk, int n) { return sV[n * LD + kk]; }, m0, n0, lane);
        out = sM;
        ld = LC;
      } else {
        const bool s = q < TM + TS;
        const int p = q - TM - (s ? 0 : TS);
        const float* X = s ? sY : sV;
        const float* Z = s ? sS : sG;
        m0 = p / (K / 8) * 16;
        n0 = p % (K / 8) * 8;
        mma_tile<K / 8, BF, false>(
            acc, [&](int m, int kk) { return X[m * LD + kk]; },
            [&](int kk, int n) { return Z[n * LD + kk]; }, m0, n0, lane);
        out = s ? sSdY : sGV;
        ld = LD;
      }
      const int g = lane >> 2, tq = lane & 3;
      out[(m0 + g) * ld + n0 + 2 * tq] = acc[0];
      out[(m0 + g) * ld + n0 + 2 * tq + 1] = acc[1];
      out[(m0 + g + 8) * ld + n0 + 2 * tq] = acc[2];
      out[(m0 + g + 8) * ld + n0 + 2 * tq + 1] = acc[3];
    }
  }
  // X_i = rowsum(S . G) and beta_t, a quad of lanes each: its quarter in
  // order, then the quarters pairwise (xor 1, then xor 2)
  for (int p = tid; p < 4 * (K + C); p += NT) {
    const int n = p / 4, q = p % 4;
    float s = 0.f;
    if (n < K) {
      for (int j = q * (K / 4); j < (q + 1) * (K / 4); ++j)
        s = fmaf(sS[n * LD + j], sG[n * LD + j], s);
    } else {
      const int t = n - K;
      for (int i = q * (K / 4); i < (q + 1) * (K / 4); ++i)
        s = fmaf(sR[t * LD + i] * sU[i], sK[t * LD + i], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0) (n < K ? sX[n] : sBeta[n - K]) = s;
  }
  __syncthreads();

  // the pair terms, NW channels a warp at a time, C/2 lanes a channel: a
  // lane takes tokens u0 = j and u1 = C-1-j, whose walks are j and C-1-j
  // steps long in (i) and the other way round in (ii), so each of its C-1
  // steps is one of its tokens' (no lane idles on the triangle)
  constexpr int HL = C / 2;
  const int sub = lane / HL, j = lane % HL, u0 = j, u1 = C - 1 - j;
  float* ht = sHt + wp * L::HT + sub * L::TRI;   // H_b(a) at tri(a, b)
  float Q[C - 1];                  // P[tok][b] of step s, over the channels
#pragma unroll
  for (int s = 0; s < C - 1; ++s) Q[s] = 0.f;
  for (int cg = wp; cg < K / NW; cg += CHUNK_WARPS) {
    const int i = cg * NW + sub;
    // (i) each token walks a < tok: H (dr's pair term), gamma, A'
    float hh = 0.f, gam = 0.f, ap = 1.f, h0 = 0.f, g0 = 0.f, a0 = 1.f;
    float hk[C - 1];               // H_tk before token a, step by step
#pragma unroll
    for (int s = 0; s < C - 1; ++s) {
      if (s == j) {                // u0 is done: u1 from a = 0
        h0 = hh; g0 = gam; a0 = ap;
        hh = 0.f; gam = 0.f; ap = 1.f;
      }
      const bool first = s < j;
      const int tk = first ? u0 : u1, a = first ? s : s - j;
      hk[s] = hh;
      const float da = sD[a * LD + i], ka = sK[a * LD + i];
      hh = fmaf(ka, sM[tk * LC + a], fmaf(-da, hh, hh));
      gam = fmaf(ka, sGV[a * LD + i], fmaf(-da, gam, gam));
      ap = fmaf(-da, ap, ap);
    }
#pragma unroll
    for (int s = 0; s < C - 1; ++s) {
      const bool first = s < j;
      ht[tri(first ? s : s - j, first ? u0 : u1)] = hk[s];
    }
    __syncwarp();
    // (ii) each token walks b > tok with f = F[tok, b]
    const int L0 = C - 1 - j;      // u0's steps
    const float k0 = sK[u0 * LD + i], k1 = sK[u1 * LD + i];
    float f = 1.f, pi = 0.f, al = 0.f, dki = 0.f;
    float f0 = 1.f, pi0 = 0.f, al0 = 0.f, dk0 = 0.f;
#pragma unroll
    for (int s = 0; s < C - 1; ++s) {
      if (s == L0) {               // u0 is done: u1 from b = u1 + 1
        f0 = f; pi0 = pi; al0 = al; dk0 = dki;
        f = 1.f; pi = 0.f; al = 0.f; dki = 0.f;
      }
      const bool first = s < L0;
      const int tk = first ? u0 : u1;
      const int b = first ? u0 + 1 + s : u1 + 1 + s - L0;
      const float rfb = f * sR[b * LD + i];
      pi = fmaf(rfb, ht[tri(tk, b)], pi);
      al = fmaf(rfb, sSdY[b * LD + i], al);
      dki = fmaf(rfb, sM[b * LC + tk], dki);
      Q[s] = fmaf(first ? k0 : k1, rfb, Q[s]);
      f = fmaf(-sD[b * LD + i], f, f);
    }
    if (L0 == C - 1) {             // j = 0: u1 = C-1 has no step
      f0 = f; pi0 = pi; al0 = al; dk0 = dki;
      f = 1.f; pi = 0.f; al = 0.f; dki = 0.f;
    }
    __syncwarp();                  // S dy, G v are read before dr, dk land
    const float ui = sU[i];
    auto finish = [&](int tk, float kt, float hv, float gv, float av,
                      float fv, float piv, float alv, float dkv) {
      const int e = tk * LD + i;
      const float vdy = sM[tk * LC + tk];    // v_t . dy_t
      sDr[e] = fmaf(ui * kt, vdy, fmaf(av, sSdY[e], hv));
      sDk[e] = fmaf(ui * sR[e], vdy, fmaf(fv, sGV[e], dkv));
      sDl[e] = sW[e] * fmaf(av, fmaf(fv, sX[i], alv), fmaf(fv, gv, piv));
      sBk[e] = fv * kt;
    };
    finish(u0, k0, h0, g0, a0, f0, pi0, al0, dk0);
    finish(u1, k1, hh, gam, ap, f, pi, al, dki);
    __syncwarp();                  // the table is read before it is reused
  }
  // P's parts: the warp's channel groups in pairs (xor HL, then xor 2 HL),
  // then a part a warp at tri(tok, b)
#pragma unroll
  for (int s = 0; s < C - 1; ++s)
#pragma unroll
    for (int o = HL; o < 32; o <<= 1)
      Q[s] += __shfl_xor_sync(0xffffffffu, Q[s], o);
  if (sub == 0) {
    float* part = sHt + wp * L::HT;
    const int L0 = C - 1 - j;
#pragma unroll
    for (int s = 0; s < C - 1; ++s) {
      const bool first = s < L0;
      const int tk = first ? u0 : u1;
      part[tri(tk, first ? u0 + 1 + s : u1 + 1 + s - L0)] = Q[s];
    }
  }
  __syncthreads();
  for (int p = tid; p < C * C; p += NT) {
    const int t = p / C, b = p % C;
    float s = 0.f;
    if (t < b) {
#pragma unroll
      for (int w = 0; w < CHUNK_WARPS; ++w) s += sHt[w * L::HT + tri(t, b)];
    }
    sP[t * LC + b] = s;
  }
  for (int i = tid; i < K; i += NT) {   // du's part, token order
    float s = 0.f;
    for (int t = 0; t < C; ++t)
      s = fmaf(sR[t * LD + i] * sK[t * LD + i], sM[t * LC + t], s);
    du_part[((long long)bh * n_ch + ch) * K + i] = s;
  }
  __syncthreads();

  // dv = (B . K) G + P dY + beta dy on the tensor cores, out from the tiles
  for (int q = wp; q < (C / 16) * (K / 8); q += CHUNK_WARPS) {
    const int m0 = q / (K / 8) * 16, n0 = q % (K / 8) * 8;
    float bnd[4] = {0.f, 0.f, 0.f, 0.f}, pair[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tile<K / 8, false, false>(
        bnd, [&](int m, int kk) { return sBk[m * LD + kk]; },
        [&](int kk, int n) { return sG[kk * LD + n]; }, m0, n0, lane);
    mma_tile<C / 8, false, BF>(
        pair, [&](int m, int kk) { return sP[m * LC + kk]; },
        [&](int kk, int n) { return sY[kk * LD + n]; }, m0, n0, lane);
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = m0 + g + (e >> 1) * 8, j = n0 + 2 * tq + (e & 1);
      if (t0 + t < n_tok)
        dv[base + (long long)(t0 + t) * K + j] = from_f<T>(
            fmaf(sBeta[t], sY[t * LD + j], bnd[e] + pair[e]));
    }
  }
  for (int p = tid; p < C * K; p += NT) {
    const int t = p / K, i = p % K, e = t * LD + i;
    if (t0 + t >= n_tok) continue;
    const long long off = base + (long long)(t0 + t) * K + i;
    dr[off] = from_f<T>(sDr[e]);
    dk[off] = from_f<T>(sDk[e]);
    dlogw[off] = sDl[e];
  }
}

// (c) du[h, i] = the parts over b and the chunks, in order
__global__ void __launch_bounds__(256)
wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                   int B, int H, int K, int n_ch) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * K) return;
  const int h = p / K, i = p % K;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < n_ch; ++c)
      s += du_part[(((long long)b * H + h) * n_ch + c) * K + i];
  du[p] = s;
}

template <typename T, int K, int C>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const void* logw, const void* u, const void* s0,
                       const void* dy, const void* dS, void* dr, void* dk,
                       void* dv, void* dlogw, void* du, void* ds0, void* Sst,
                       void* Gst, void* du_part, int B, int H, int n_tok,
                       int device, cudaStream_t stream) {
  const int BH = B * H, n_ch = (n_tok + C - 1) / C;
  constexpr size_t carry_smem = CarrySmem<T, K, C>::BYTES;
  constexpr size_t chunk_smem = ChunkSmem<K, C>::FLOATS * sizeof(float);
  static unsigned long long carry_set = 0, chunk_set = 0;
  cudaError_t err = allow_smem(wkv6_bwd_carry_kernel<T, K, C>, carry_set,
                               device, carry_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(wkv6_bwd_chunk_kernel<T, K, C>, chunk_set, device,
                   chunk_smem);
  if (err != cudaSuccess) return err;
  wkv6_bwd_carry_kernel<T, K, C><<<BH * (K / SLAB), 64, carry_smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(s0), static_cast<const T*>(dy),
      static_cast<const float*>(dS), static_cast<float*>(Sst),
      static_cast<float*>(Gst), static_cast<float*>(ds0), n_tok, n_ch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_chunk_kernel<T, K, C>
      <<<BH * n_ch, CHUNK_WARPS * 32, chunk_smem, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(logw),
          static_cast<const float*>(u), static_cast<const T*>(dy),
          static_cast<const float*>(Sst), static_cast<const float*>(Gst),
          static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
          static_cast<float*>(dlogw), static_cast<float*>(du_part), H, n_tok,
          n_ch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_du_kernel<<<(H * K + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), B, H, K,
      n_ch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_k(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* s0,
                         const void* dy, const void* dS, void* dr, void* dk,
                         void* dv, void* dlogw, void* du, void* ds0, void* Sst,
                         void* Gst, void* du_part, int B, int H, int n_tok,
                         int K, int device, cudaStream_t s) {
#define REPRO_WKV6_BWD(KK)                                                   \
  if (K == KK)                                                               \
    return launch_bwd<T, KK, CHUNK>(r, k, v, logw, u, s0, dy, dS, dr, dk,    \
                                    dv, dlogw, du, ds0, Sst, Gst, du_part,   \
                                    B, H, n_tok, device, s);
  REPRO_WKV6_BWD(16)
  REPRO_WKV6_BWD(64)
#undef REPRO_WKV6_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// The six gradients of wkv6 (repro_wkv6's contract) at the upstream dy
// (B,H,T,K) in r's dtype and dS (B,H,K,K) fp32, either null for zero, in
// chunks of CHUNK tokens. Scratch, fp32, n_ch = ceil(T / CHUNK): Sst and
// Gst (B, H, n_ch, K, K), the states at the chunk boundaries, du_part (B,
// H, n_ch, K).
// Three kernels on ``stream``: the carry, the chunk pass, du's sum. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                              const void* logw, const void* u, const void* s0,
                              const void* dy, const void* dS, void* dr,
                              void* dk, void* dv, void* dlogw, void* du,
                              void* ds0, void* Sst, void* Gst, void* du_part,
                              int B, int H, int n_tok, int K, int dtype,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_bwd_k<float>(r, k, v, logw, u, s0, dy, dS, dr, dk, dv,
                               dlogw, du, ds0, Sst, Gst, du_part, B, H, n_tok,
                               K, device, s);
  if (dtype == REPRO_BF16)
    return launch_bwd_k<__nv_bfloat16>(r, k, v, logw, u, s0, dy, dS, dr, dk,
                                       dv, dlogw, du, ds0, Sst, Gst, du_part,
                                       B, H, n_tok, K, device, s);
  return cudaErrorInvalidValue;
}
