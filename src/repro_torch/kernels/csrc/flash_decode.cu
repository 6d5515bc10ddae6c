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
// its 168 MFLOP take a third of that at the fp32 rate.
//
// Design: the split-KV decode body of decode_attention.cuh (shared with
// paged decode) over StridedKeys. K/V are read in place through their
// batch, head and key strides (the ring cache's (B, L, KV, hd) layout, no
// transpose), in their stored dtype: bf16 beside an fp32 q is widened in
// registers. Every row has the same n_keys, cut into n_split ranges so that
// B x KV x n_split blocks fill the 132 SMs: 8 x 1 x 16 = 128 blocks of 128
// keys at the path's shape, then the combine kernel.

#include "decode_attention.cuh"

// One query a head over n_keys cached keys: the split kernel, then (for
// n_split > 1) the combine, on ``stream``. ``part`` holds
// B*KV*n_split*G*(hd + 2) floats of scratch, or is null when n_split == 1.
// K/V strides are in elements; the last dim has stride 1. dtypes: q and K/V
// the same, or an fp32 q with bf16 K/V. Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, void* o, void* part, int B,
    int H, int KV, int hd, int n_keys, long long k_sb, long long k_sh,
    long long k_sk, long long v_sb, long long v_sh, long long v_sk,
    int n_split, float softcap, int q_dtype, int kv_dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (KV <= 0 || H % KV || n_split <= 0 || n_keys < 0 ||
      (n_split > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.acc = static_cast<float*>(part);
  p.ml = part ? p.acc + (long long)B * KV * n_split * (H / KV) * hd
              : nullptr;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sk = k_sk;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sk = v_sk;
  p.H = H; p.KV = KV; p.G = H / KV; p.n_keys = n_keys; p.n_split = n_split;
  p.softcap = softcap;
  p.scale = 1.f / sqrtf(static_cast<float>(hd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == REPRO_F32 && kv_dtype == REPRO_F32)
    return dispatch_hd<StridedKeys, float, float>(p, B, hd, device, s);
  if (q_dtype == REPRO_F32 && kv_dtype == REPRO_BF16)
    return dispatch_hd<StridedKeys, float, __nv_bfloat16>(p, B, hd, device,
                                                          s);
  if (q_dtype == REPRO_BF16 && kv_dtype == REPRO_BF16)
    return dispatch_hd<StridedKeys, __nv_bfloat16, __nv_bfloat16>(
        p, B, hd, device, s);
  return cudaErrorInvalidValue;
}
