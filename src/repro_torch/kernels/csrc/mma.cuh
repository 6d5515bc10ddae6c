// Tensor-core helpers shared by the flash forward (flash_attention.cu) and
// its gradient (flash_bwd.cu): ldmatrix fragment loads, mma.sync products
// in bf16 (m16n8k16) and TF32 (m16n8k8), both with fp32 accumulators.
//
// Fragment layouts (PTX ISA, warp-level mma), g = lane / 4, t = lane % 4:
// - accumulator C (16 x 8, fp32): c0, c1 at row g, columns 2t, 2t + 1;
//   c2, c3 at row g + 8, the same columns.
// - bf16 A (16 x 16): 4 registers of two bf16 each, (g, 2t..), (g + 8,
//   2t..), (g, 2t + 8..), (g + 8, 2t + 8..): two accumulators side by side,
//   rounded and packed, are an A fragment.
// - bf16 B (16 x 8): (k 2t.., n g), (k 2t + 8.., n g).
// - TF32 A (16 x 8): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
// - TF32 B (8 x 8): (k t, n g), (k t + 4, n g).
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"   // smem_addr

// Four 8 x 8 matrices of 16-bit elements (or 8 x 4 of 32-bit ones); lanes
// 8i..8i+7 give the row addresses of the i-th, whose fragment lands in
// r[i]: lane l gets row l / 4, 32-bit element l % 4.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, ``lo`` in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The gradient kernel's products: the same instructions without
// `volatile`, so that the compiler may schedule them among the loads (the
// forward keeps the ordered `mma_bf16` it was tuned with). They touch
// registers only.
__device__ __forceinline__ void mma_bf16_free(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row) . b (8 x 8, col), TF32 in (the low 13 bits of each
// 32-bit operand ignored), fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi = x rounded to TF32 (10 explicit mantissa bits, to
// nearest, ties away: cvt.rna's rounding in two integer operations), lo =
// x - hi exactly (|lo| <= 2^-11 |x|), which the tensor cores read to its
// own 10 bits: x to about 2^-21 relative, without a conversion instruction
__device__ __forceinline__ void split_tf32(unsigned bits, unsigned& hi,
                                           unsigned& lo) {
  hi = (bits + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(bits) - __uint_as_float(hi));
}

// d += a . b in three TF32 products, lo.hi + hi.lo + hi.hi (the small
// terms first): about fp32's accuracy, lo.lo (2^-22 relative) dropped
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4],
                                           unsigned bhi0, unsigned bhi1,
                                           unsigned blo0, unsigned blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}
