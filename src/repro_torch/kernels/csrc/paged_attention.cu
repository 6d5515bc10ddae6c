// Single-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (`paged_decode_bkgh`, body `_decode_kernel`). Same contract: q (B,KV,G,hd),
// k/v pages (P,KV,page,hd), block tables (B,maxp) int32, lengths (B,) int32;
// fp32 online softmax with scale 1/sqrt(hd); pages past a row's length are
// never read; lengths[b] == 0 gives an exact zero row (l floored at 1e-20);
// the output has q's dtype.
//
// What bounds it on the H100: bytes. Each live K/V entry is read once and
// used for G multiply-adds per element, far below the ~295 flop/byte the
// card needs before its arithmetic is the limit. At the decode sizes of the
// protein models (24-32 rows, under 100 cached tokens, hd 32) one launch
// moves about 1 MB, a fraction of a microsecond at 3.35 TB/s, so the launch
// itself and the host around it set the step time.
//
// Design: the TPU grid (rows, pages) ran its page axis in order, carrying
// (m, l, acc) in VMEM. Here one block owns one (row, KV head) and walks the
// row's live tokens itself, CHUNK logical tokens at a time: the block reads
// its own block-table row and length (scalar prefetch on the TPU), turns
// each token into a pool offset once per chunk, scores the chunk for all G
// query heads of the group, folds it into the running (m, l) per head, and
// accumulates P.V into acc. m, l and acc stay in shared memory in fp32. No
// block depends on another, so rows run in parallel across the SMs.

#include "common.cuh"

namespace {

constexpr int CHUNK = 64;    // logical tokens scored per pass
constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int KV, int G, int hd, int page, int maxp, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* off_s = reinterpret_cast<long long*>(smem_raw);  // CHUNK
  float* q_s = reinterpret_cast<float*>(off_s + CHUNK);       // G*hd
  float* acc_s = q_s + G * hd;                                // G*hd
  float* s_s = acc_s + G * hd;                                // G*CHUNK
  float* m_s = s_s + G * CHUNK;                               // G
  float* l_s = m_s + G;                                       // G
  float* a_s = l_s + G;                                       // G

  const int b = blockIdx.x, kv = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int GH = G * hd;
  // tokens past the block table never exist (the TPU grid has maxp pages)
  const int len = min(lengths[b], maxp * page);
  const int* bt = block_tables + (long long)b * maxp;
  const T* qb = q + ((long long)b * KV + kv) * GH;

  for (int i = tid; i < GH; i += nt) {
    q_s[i] = to_f(qb[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += nt) {
    m_s[g] = REPRO_NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  for (int t0 = 0; t0 < len; t0 += CHUNK) {
    const int n = min(CHUNK, len - t0);
    for (int j = tid; j < n; j += nt) {
      const int t = t0 + j;
      const long long pg = bt[t / page];
      off_s[j] = ((pg * KV + kv) * page + (t % page)) * hd;
    }
    __syncthreads();

    // scores s[g][j] = q_g . k_j for the chunk's live tokens
    for (int i = tid; i < G * CHUNK; i += nt) {
      const int g = i / CHUNK, j = i % CHUNK;
      float s = REPRO_NEG_INF;
      if (j < n) {
        const T* kr = k_pages + off_s[j];
        const float* qg = q_s + g * hd;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc += qg[d] * to_f(kr[d]);
        s = acc;
      }
      s_s[i] = s;
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += nw) {
      float* sg = s_s + g * CHUNK;
      float cm = REPRO_NEG_INF;
      for (int j = lane; j < n; j += 32) cm = fmaxf(cm, sg[j]);
      cm = warp_max(cm);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, cm);
      float ps = 0.f;
      for (int j = lane; j < CHUNK; j += 32) {
        const float p = j < n ? expf(sg[j] - m_new) : 0.f;
        sg[j] = p;
        ps += p;
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V (neighbouring threads read neighbouring d)
    for (int i = tid; i < GH; i += nt) {
      const int g = i / hd, d = i % hd;
      const float* pg = s_s + g * CHUNK;
      float a = acc_s[i] * a_s[g];
      for (int j = 0; j < n; ++j) a += pg[j] * to_f(v_pages[off_s[j] + d]);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * KV + kv) * GH;
  for (int i = tid; i < GH; i += nt)
    ob[i] = from_f<T>(acc_s[i] / fmaxf(l_s[i / hd], 1e-20f));
}

template <typename T>
void launch(const void* q, const void* kp, const void* vp, const void* bt,
            const void* lens, void* out, int B, int KV, int G, int hd,
            int page, int maxp, cudaStream_t stream) {
  const size_t smem = CHUNK * sizeof(long long) +
                      (2 * G * hd + G * CHUNK + 3 * G) * sizeof(float);
  paged_decode_kernel<T><<<dim3(B, KV), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<T*>(out), KV, G, hd, page,
      maxp, 1.f / sqrtf(static_cast<float>(hd)));
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages,
                                  const void* block_tables,
                                  const void* lengths, void* out, int B,
                                  int KV, int G, int hd, int page, int maxp,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    launch<float>(q, k_pages, v_pages, block_tables, lengths, out, B, KV, G,
                  hd, page, maxp, s);
  else if (dtype == REPRO_BF16)
    launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths, out, B,
                          KV, G, hd, page, maxp, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
