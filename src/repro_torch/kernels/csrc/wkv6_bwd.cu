// The gradient of RWKV-6's WKV recurrence, for Hopper (sm_90a).
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
// What bounds it on the H100. Six fp32 multiply-adds a state element a token
// (the state rebuilt, G's update, and the dr, dk, dv and dlogw sums): at
// 8 x 64 x 512 x 64 that is 12.9 GFLOP, 0.19 ms at the 67 TFLOP/s fp32 rate,
// against 0.39 GB of inputs and gradients (0.12 ms at 3.35 TB/s): bounded
// by operations, as the forward is. The tensor cores do not help, for the
// forward kernel's reason (the state is fp32 and held to 2e-5).
//
// Design.
// - The reverse walk needs S_{t-1} at every t. It never undoes the decay
//   (at logw = -e^5, w = exp(-148) is 0 in fp32): a forward pass stores the
//   state at the start of every chunk of C = 16 tokens (checkpoints, fp32,
//   (T/C) B H K^2 4 bytes, 260 MB at 8 x 64 x 512 x 64), and the reverse
//   pass rebuilds each chunk's states from its checkpoint, last chunk
//   first. Within a chunk a thread holds P = 4 states in registers: for
//   each run of 4 tokens, last run first, it walks from the checkpoint to
//   the run's start and keeps the run's four states S_{t-1}, then takes the
//   four tokens backwards (2.25 rebuilt steps a token on average).
// - Element (i, j) of S and of G evolves on its own, so a thread owns the
//   same RT x CT tile of both (4 x 4 at K = 64, 2 x 4 at K = 16) and
//   rebuilds its S tile without talking to other threads. The sums over a
//   row j (dr, dk, dlogw) run over the CL = K / CT lanes of a warp that
//   share the row: each lane's CT columns in turn, then the lanes pairwise
//   (lane l with l + CL/2 first, by halving exchanges, as the forward
//   kernel's column sums); the sums over a column i (dv) over the rows of a
//   thread in turn, the warp's row lanes pairwise likewise, then the warps
//   of the (b, h) in adjacent pairs ((0+1)+(2+3))+... through shared memory.
// - dlogw is the direct product w_t . rowsum(G_t . S_{t-1}), never a
//   difference of cumulative sums.
// - A decay step is S - d S with d = 1 - w taken as -expm1(logw), not w S:
//   near logw = -1e-6, w rounded to fp32 is off by up to 3% of 1 - w, and
//   that error, the same sign at every token, compounds over a sequence
//   (4e-6 of the gradients' max over 512 tokens at the logw ends, against
//   1e-6 with d; ``WKV6``'s CPU form, exp of summed logw, 3e-7). At the
//   floor d is exactly 1 and the state exactly 0, as with w. dlogw's
//   factor is w = exp(logw) itself: 1 - d loses a small w whole (w =
//   2e-9 rounds to 0), and with it a real gradient of the decay.
// - A (b, h) may split its rows into NG groups (1, 2, 4 or 8 at K = 64),
//   one block each, so that the rank-local shapes (4 x 16 heads) fill the
//   132 SMs: a group owns its rows' dr, dk, dlogw and du whole and writes
//   its warps' sum of dv. A second kernel adds the groups' dv in the same
//   adjacent pairs, so the tree over the warps is the same at every NG and
//   the gradients are bitwise the same whatever NG the wrapper picks; it
//   then adds beta_t dy_t, and sums du over b in order. No float atomics:
//   two calls give bitwise the same gradients.
// - Chunks are staged in shared memory in fp32 (d and w taken once a
//   (token, row)); beta_t and v_t . dy_t are computed once a token while
//   staging. A chunk's dr, dk and dlogw sums and its warps' dv sums stay in
//   shared memory and go out coalesced after the chunk.
// wkv6_bwd_serial_ref in rwkv6.py repeats this order of operations in
// plain PyTorch.

#include "common.cuh"

namespace {

constexpr int BWD_C = 16;   // tokens a chunk: staged at a time, checkpointed
constexpr int BWD_P = 4;    // states a thread holds while it walks back

template <int K>
struct BwdTile;
template <>
struct BwdTile<64> {
  static constexpr int RT = 4, CT = 4;   // rows, columns of a thread's tile
  static constexpr int CL = 16;          // lanes a row: K / CT
  static constexpr int RL = 2;           // row lanes a warp: 32 / CL
  static constexpr int NW = 8;           // warps a (b, h): K / (RL RT)
  static constexpr int HX = 2;           // halving steps of the row sums
  static constexpr int HV = 1;           // halving steps of dv's sums
};
template <>
struct BwdTile<16> {
  static constexpr int RT = 2, CT = 4, CL = 4, RL = 8, NW = 1, HX = 1,
                       HV = 2;
};

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
  static_assert(N == 4, "a thread's columns go out as one float4");
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// x[0] + x[1] + ... + x[N-1] in adjacent pairs, ((0+1)+(2+3))+..., in x[0]
template <int N>
__device__ __forceinline__ void sum_adjacent(float (&x)[N]) {
#pragma unroll
  for (int n = N; n > 1; n >>= 1)
#pragma unroll
    for (int m = 0; m < n / 2; ++m) x[m] = x[2 * m] + x[2 * m + 1];
}

template <typename T, int K, int NG>
__global__ void __launch_bounds__(BwdTile<K>::NW / NG * 32)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ s0,
                const T* __restrict__ dy, const float* __restrict__ dS,
                T* __restrict__ dr, T* __restrict__ dk,
                float* __restrict__ dlogw, float* __restrict__ ds0,
                float* ckpt, float* __restrict__ dvp,
                float* __restrict__ beta, float* __restrict__ du_part, int BH,
                int H, int n_tok) {
  using W = BwdTile<K>;
  constexpr int RT = W::RT, CT = W::CT, CL = W::CL, RL = W::RL;
  constexpr int NWB = W::NW / NG, NT = NWB * 32, KR = K / NG;
  constexpr int C = BWD_C, P = BWD_P, L = K < 32 ? K : 32, CK = C * K;
  constexpr int NX = 3 * RT, VX = NX >> W::HX, RX = CL >> W::HX;
  constexpr int VD = CT >> W::HV, RD = RL >> W::HV;
  constexpr unsigned FULL = 0xffffffffu;
  static_assert(CL * CT == K && CL * RL == 32 && W::NW * RL * RT == K &&
                    NX % (1 << W::HX) == 0 && RL % (1 << W::HV) == 0 &&
                    CT % (1 << W::HV) == 0 && W::NW % NG == 0 &&
                    C % (NT / L) == 0 && C % P == 0,
                "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;               // the chunk in fp32, (C, K) each
  float* k_s = r_s + CK;
  float* d_s = k_s + CK;           // 1 - w = -expm1(logw)
  float* w_s = d_s + CK;           // w = exp(logw)
  float* v_s = w_s + CK;
  float* y_s = v_s + CK;           // dy
  float* o_s = y_s + CK;           // row sums: dr, dk, dlogw's (3, C, K)
  float* dv_s = o_s + 3 * CK;      // each warp's dv sums (NWB, C, K)
  float* beta_s = dv_s + NWB * CK;
  float* vdy_s = beta_s + C;       // v_t . dy_t
  float* u_s = vdy_s + C;

  const int bh = blockIdx.x / NG, g = blockIdx.x % NG, h = bh % H;
  const int tid = threadIdx.x, wp = tid / 32, lane = tid % 32;
  const int rl = lane / CL, cl = lane % CL;
  const int grow0 = g * KR;                       // the group's first row
  const int row0 = grow0 + (wp * RL + rl) * RT, col0 = cl * CT;
  const long long base = (long long)bh * n_tok * K;   // (b, h, 0, 0)
  const long long sbase = (long long)bh * K * K;
  const int n_ch = (n_tok + C - 1) / C;

  for (int i = tid; i < K; i += NT) u_s[i] = u[h * K + i];

  // stage chunk ch (tokens past n_tok: zeros, w = 1); ``back``: r and dy
  // too, beta_t and v_t . dy_t (L lanes a token)
  auto stage = [&](int ch, bool back) {
    const int t0 = ch * C;
    for (int t = tid / L; t < C; t += NT / L) {
      const bool in = t0 + t < n_tok;
      const long long off = base + (long long)(t0 + t) * K;
      float pb = 0.f, pv = 0.f;
      for (int i = tid % L; i < K; i += L) {
        const int e = t * K + i;
        const float ki = in ? to_f(k[off + i]) : 0.f;
        const float vi = in ? to_f(v[off + i]) : 0.f;
        k_s[e] = ki;
        v_s[e] = vi;
        const float lw = in ? logw[off + i] : 0.f;
        d_s[e] = -expm1f(lw);
        w_s[e] = expf(lw);
        if (back) {
          const float ri = in ? to_f(r[off + i]) : 0.f;
          const float yi = in && dy != nullptr ? to_f(dy[off + i]) : 0.f;
          r_s[e] = ri;
          y_s[e] = yi;
          pb = fmaf(ri * u_s[i], ki, pb);
          pv = fmaf(vi, yi, pv);
        }
      }
      if (back) {
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1) {
          pb += __shfl_xor_sync(FULL, pb, o);
          pv += __shfl_xor_sync(FULL, pv, o);
        }
        if (tid % L == 0) {
          beta_s[t] = pb;
          vdy_s[t] = pv;
        }
      }
    }
  };

  // one token forward: S = (S - d_t S) + k_t v_t^T on the thread's tile
  auto step = [&](float (&S)[RT][CT], int t) {
    float dk_[RT], kr[RT], vc[CT];
    load_vec(d_s + t * K + row0, dk_);
    load_vec(k_s + t * K + row0, kr);
    load_vec(v_s + t * K + col0, vc);
#pragma unroll
    for (int e = 0; e < RT; ++e)
#pragma unroll
      for (int c = 0; c < CT; ++c)
        S[e][c] = fmaf(kr[e], vc[c], fmaf(-dk_[e], S[e][c], S[e][c]));
  };
  auto load_tile = [&](float (&S)[RT][CT], const float* src) {
#pragma unroll
    for (int e = 0; e < RT; ++e) load_vec(src + (row0 + e) * K + col0, S[e]);
  };
  auto store_tile = [&](float* dst, const float (&S)[RT][CT]) {
#pragma unroll
    for (int e = 0; e < RT; ++e) store_vec(dst + (row0 + e) * K + col0, S[e]);
  };

  // the forward pass: the state before chunks 1 .. n_ch-1, checkpointed
  {
    float S[RT][CT];
    load_tile(S, s0 + sbase);
    for (int ch = 0; ch + 1 < n_ch; ++ch) {
      __syncthreads();              // the last chunk's steps are done
      stage(ch, false);
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < C; ++t) step(S, t);
      store_tile(ckpt + ((long long)ch * BH + bh) * K * K, S);
    }
  }

  float G[RT][CT];                  // dL/dS_t on the thread's tile
#pragma unroll
  for (int e = 0; e < RT; ++e)
#pragma unroll
    for (int c = 0; c < CT; ++c) G[e][c] = 0.f;
  if (dS != nullptr) load_tile(G, dS + sbase);

  // token t of the chunk backwards, from S_{t-1} (Sp) and G = G_t: the row
  // and column sums to shared memory, then G = G_{t-1}
  auto back_step = [&](const float (&Sp)[RT][CT], int t) {
    float rr[RT], dd[RT], kr[RT], vc[CT], yc[CT];
    load_vec(r_s + t * K + row0, rr);
    load_vec(d_s + t * K + row0, dd);
    load_vec(k_s + t * K + row0, kr);
    load_vec(v_s + t * K + col0, vc);
    load_vec(y_s + t * K + col0, yc);
    float x[NX], d[CT];             // x: dr's, dk's, dlogw's sums by row
#pragma unroll
    for (int e = 0; e < RT; ++e) {
      float a0 = Sp[e][0] * yc[0], a1 = G[e][0] * vc[0],
            a2 = G[e][0] * Sp[e][0];
#pragma unroll
      for (int c = 1; c < CT; ++c) {
        a0 = fmaf(Sp[e][c], yc[c], a0);
        a1 = fmaf(G[e][c], vc[c], a1);
        a2 = fmaf(G[e][c], Sp[e][c], a2);
      }
      x[e] = a0;
      x[RT + e] = a1;
      x[2 * RT + e] = a2;
    }
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      d[c] = G[0][c] * kr[0];
#pragma unroll
      for (int e = 1; e < RT; ++e) d[c] = fmaf(G[e][c], kr[e], d[c]);
    }
#pragma unroll
    for (int e = 0; e < RT; ++e)
#pragma unroll
      for (int c = 0; c < CT; ++c)
        G[e][c] = fmaf(rr[e], yc[c], fmaf(-dd[e], G[e][c], G[e][c]));

    // the row sums over the CL lanes of a row: HX steps that each halve
    // the values a lane holds (xor CL/2: the upper lanes keep the upper
    // half; then xor CL/4), then the RX lanes left add theirs
    int xb = 0;
#pragma unroll
    for (int s = 0; s < W::HX; ++s) {
      const int half = NX >> (s + 1), off = CL >> (s + 1);
      const bool up = cl & off;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = up ? x[j] : x[j + half];
        x[j] = (up ? x[j + half] : x[j]) + __shfl_xor_sync(FULL, send, off);
      }
      xb += up ? half : 0;
    }
#pragma unroll
    for (int off = RX / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < VX; ++j) x[j] += __shfl_xor_sync(FULL, x[j], off);
#pragma unroll
    for (int j = 0; j < VX; ++j)
      if (j % RX == cl % RX) {
        const int q = (xb + j) / RT, e = (xb + j) % RT;
        o_s[q * CK + t * K + row0 + e] = x[j];
      }

    // dv's sums over the RL row lanes of a warp, likewise (xor 16 first)
    int db = 0;
#pragma unroll
    for (int s = 0; s < W::HV; ++s) {
      const int half = CT >> (s + 1), off = 16 >> s;
      const bool up = lane & off;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = up ? d[j] : d[j + half];
        d[j] = (up ? d[j + half] : d[j]) + __shfl_xor_sync(FULL, send, off);
      }
      db += up ? half : 0;
    }
#pragma unroll
    for (int off = CL * RD / 2; off >= CL; off >>= 1)
#pragma unroll
      for (int j = 0; j < VD; ++j) d[j] += __shfl_xor_sync(FULL, d[j], off);
    if (rl % RD == 0)
#pragma unroll
      for (int j = 0; j < VD; ++j) dv_s[wp * CK + t * K + col0 + db + j] = d[j];
  };

  float du = 0.f;                   // row grow0 + tid's, for tid < KR
  for (int ch = n_ch - 1; ch >= 0; --ch) {
    const int t0 = ch * C, nt = min(C, n_tok - t0);
    const float* ck = ch == 0 ? s0 + sbase
                              : ckpt + ((long long)(ch - 1) * BH + bh) * K * K;
    __syncthreads();                // the last chunk's sums are out
    stage(ch, true);
    __syncthreads();
    for (int a = (nt - 1) / P * P; a >= 0; a -= P) {
      float Sb[P][RT][CT];          // S_{a-1} .. S_{a+P-2}
      load_tile(Sb[0], ck);
      for (int t = 0; t < a; ++t) step(Sb[0], t);
#pragma unroll
      for (int p = 1; p < P; ++p) {
#pragma unroll
        for (int e = 0; e < RT; ++e)
#pragma unroll
          for (int c = 0; c < CT; ++c) Sb[p][e][c] = Sb[p - 1][e][c];
        step(Sb[p], a + p - 1);
      }
#pragma unroll
      for (int p = P - 1; p >= 0; --p)
        if (a + p < nt) back_step(Sb[p], a + p);
    }
    __syncthreads();                // the chunk's sums are in

    // out: the group's rows of dr, dk and dlogw; its warps' dv sum
    for (int p = tid; p < nt * KR; p += NT) {
      const int t = p / KR, i = grow0 + p % KR, e = t * K + i;
      const long long off = base + (long long)(t0 + t) * K + i;
      const float vdy = vdy_s[t];
      dr[off] = from_f<T>(fmaf(u_s[i] * k_s[e], vdy, o_s[e]));
      dk[off] = from_f<T>(fmaf(u_s[i] * r_s[e], vdy, o_s[CK + e]));
      dlogw[off] = w_s[e] * o_s[2 * CK + e];
    }
    float* dvp_out = dvp + ((long long)g * BH + bh) * n_tok * K +
                     (long long)t0 * K;
    for (int p = tid; p < nt * K; p += NT) {
      float s[NWB];
#pragma unroll
      for (int w = 0; w < NWB; ++w) s[w] = dv_s[w * CK + p];
      sum_adjacent(s);
      dvp_out[p] = s[0];
    }
    if (g == 0)
      for (int t = tid; t < nt; t += NT)
        beta[(long long)bh * n_tok + t0 + t] = beta_s[t];
    if (tid < KR) {
      const int i = grow0 + tid;
      for (int t = nt - 1; t >= 0; --t)
        du = fmaf(r_s[t * K + i] * k_s[t * K + i], vdy_s[t], du);
    }
  }
  store_tile(ds0 + sbase, G);
  if (tid < KR) du_part[(long long)bh * K + grow0 + tid] = du;
}

// dv = (the NG groups' sums, in adjacent pairs) + beta_t dy_t; du = the
// (b, h) sums of du over b, in order. One thread an element of dv, then
// one an element of du.
template <typename T, int NG>
__global__ void __launch_bounds__(256)
wkv6_bwd_sum_kernel(const float* __restrict__ dvp,
                    const float* __restrict__ beta, const T* __restrict__ dy,
                    const float* __restrict__ du_part, T* __restrict__ dv,
                    float* __restrict__ du, long long n, int K, int B,
                    int HK) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) {
    float s[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) s[g] = dvp[g * n + p];
    sum_adjacent(s);
    const float y = dy != nullptr ? to_f(dy[p]) : 0.f;
    dv[p] = from_f<T>(fmaf(beta[p / K], y, s[0]));
  } else if (p - n < HK) {
    const int j = (int)(p - n);
    float s = du_part[j];
    for (int b = 1; b < B; ++b) s += du_part[(long long)b * HK + j];
    du[j] = s;
  }
}

template <typename T, int K, int NG>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const void* logw, const void* u, const void* s0,
                       const void* dy, const void* dS, void* dr, void* dk,
                       void* dv, void* dlogw, void* du, void* ds0, void* ckpt,
                       void* dvp, void* beta, void* du_part, int B, int H,
                       int n_tok, int device, cudaStream_t stream) {
  constexpr int NWB = BwdTile<K>::NW / NG;
  constexpr size_t smem =
      ((9 + NWB) * BWD_C * K + 2 * BWD_C + K) * sizeof(float);
  static unsigned long long smem_set = 0;
  cudaError_t err =
      allow_smem(wkv6_bwd_kernel<T, K, NG>, smem_set, device, smem);
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  wkv6_bwd_kernel<T, K, NG><<<BH * NG, NWB * 32, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<const T*>(dy), static_cast<const float*>(dS),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<float*>(dlogw),
      static_cast<float*>(ds0), static_cast<float*>(ckpt),
      static_cast<float*>(dvp), static_cast<float*>(beta),
      static_cast<float*>(du_part), BH, H, n_tok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)BH * n_tok * K, total = n + H * K;
  wkv6_bwd_sum_kernel<T, NG><<<(unsigned)((total + 255) / 256), 256, 0,
                               stream>>>(
      static_cast<const float*>(dvp), static_cast<const float*>(beta),
      static_cast<const T*>(dy), static_cast<const float*>(du_part),
      static_cast<T*>(dv), static_cast<float*>(du), n, K, B, H * K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_k(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* s0,
                         const void* dy, const void* dS, void* dr, void* dk,
                         void* dv, void* dlogw, void* du, void* ds0,
                         void* ckpt, void* dvp, void* beta, void* du_part,
                         int B, int H, int n_tok, int K, int groups,
                         int device, cudaStream_t s) {
#define REPRO_WKV6_BWD(KK, NG)                                             \
  if (K == KK && groups == NG)                                             \
    return launch_bwd<T, KK, NG>(r, k, v, logw, u, s0, dy, dS, dr, dk, dv, \
                                 dlogw, du, ds0, ckpt, dvp, beta, du_part, \
                                 B, H, n_tok, device, s);
  REPRO_WKV6_BWD(16, 1)
  REPRO_WKV6_BWD(64, 1)
  REPRO_WKV6_BWD(64, 2)
  REPRO_WKV6_BWD(64, 4)
  REPRO_WKV6_BWD(64, 8)
#undef REPRO_WKV6_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// The six gradients of wkv6 (repro_wkv6's contract) at the upstream dy
// (B,H,T,K) in r's dtype and dS (B,H,K,K) fp32, either null for zero.
// Scratch, fp32: ckpt ((T-1)/16, B, H, K, K) checkpoints, dvp (groups, B,
// H, T, K) dv sums, beta (B, H, T), du_part (B, H, K). Two kernels on
// ``stream``: the walk (B H groups blocks), then the sums. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                              const void* logw, const void* u, const void* s0,
                              const void* dy, const void* dS, void* dr,
                              void* dk, void* dv, void* dlogw, void* du,
                              void* ds0, void* ckpt, void* dvp, void* beta,
                              void* du_part, int B, int H, int n_tok, int K,
                              int groups, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_bwd_k<float>(r, k, v, logw, u, s0, dy, dS, dr, dk, dv,
                               dlogw, du, ds0, ckpt, dvp, beta, du_part, B,
                               H, n_tok, K, groups, device, s);
  if (dtype == REPRO_BF16)
    return launch_bwd_k<__nv_bfloat16>(r, k, v, logw, u, s0, dy, dS, dr, dk,
                                       dv, dlogw, du, ds0, ckpt, dvp, beta,
                                       du_part, B, H, n_tok, K, groups,
                                       device, s);
  return cudaErrorInvalidValue;
}
