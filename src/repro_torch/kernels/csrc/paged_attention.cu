// Single-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (`paged_decode_bkgh`, body `_decode_kernel`). Same contract: q (B,KV,G,hd),
// k/v pages (P,KV,page,hd), block tables (B,maxp) int32, lengths (B,) int32;
// fp32 online softmax with scale 1/sqrt(hd); min(lengths[b], maxp*page) keys
// in row b, and pages past a row's length are never read; lengths[b] == 0
// gives an exact zero row (every range empty: m = NEG_INF, l = 0, l floored
// at 1e-20); q and the pages in one dtype, fp32 or bf16; the output has q's
// dtype; hd 16, 32, 64, 128 or 256 and any G.
//
// What bounds it on the H100: bytes. Each live K/V entry is read once and
// used for G multiply-adds per element. At the protein path's decode (24
// slots x 43 cached tokens, 4 KV heads of 32, bf16) a call moves ~0.55 MB,
// ~0.16 us at 3.35 TB/s, so a launch and one or two load round trips set
// its time; at a design length of 256 slots x 320 tokens it reads 42 MB of
// K/V, 12.6 us at 3.35 TB/s, and the bytes do.
//
// Design: the TPU grid (rows, pages) ran its page axis in order, carrying
// (m, l, acc) in VMEM. Here it is the split-KV decode body of
// decode_attention.cuh (shared with flash's decode form) over PagedKeys: a
// block owns one (row, KV head, key range), reads its own block-table row
// and length, and walks its range in 32-key tiles by 16-byte cp.async
// through a ring of three stages; a key's page is looked up once a warp by
// one lane, not once a 16-byte chunk. The range count n_split comes from
// the grid's static shapes (kernels/paged_attention.py::
// paged_decode_splits), never from the lengths, so a fixed engine launches
// a fixed grid; each row's ranges are cut from its own length. With
// n_split == 1, as at the protein path's shape, a call is one launch.

#include "decode_attention.cuh"

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One query a head over each row's paged keys: the split kernel, then (for
// n_split > 1) the combine, on ``stream``. ``part`` holds
// B*KV*n_split*G*(hd + 2) floats of scratch, or is null when n_split == 1.
// The pools are contiguous and 16-byte aligned. Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int repro_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages,
                                  const void* block_tables,
                                  const void* lengths, void* out, void* part,
                                  int B, int KV, int G, int hd, int page,
                                  int maxp, int n_split, int dtype,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (KV <= 0 || G <= 0 || page <= 0 || maxp < 0 || n_split <= 0 ||
      (n_split > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = k_pages; p.v = v_pages; p.o = out;
  p.acc = static_cast<float*>(part);
  p.ml = part ? p.acc + (long long)B * KV * n_split * G * hd : nullptr;
  p.bt = static_cast<const int*>(block_tables);
  p.lengths = static_cast<const int*>(lengths);
  p.H = KV * G; p.KV = KV; p.G = G; p.n_split = n_split;
  p.page = page; p.maxp = maxp;
  p.scale = 1.f / sqrtf(static_cast<float>(hd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return dispatch_hd<PagedKeys, float, float>(p, B, hd, device, s);
  if (dtype == REPRO_BF16)
    return dispatch_hd<PagedKeys, __nv_bfloat16, __nv_bfloat16>(p, B, hd,
                                                               device, s);
  return cudaErrorInvalidValue;
}
