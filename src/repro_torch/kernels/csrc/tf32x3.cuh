// Float32 accuracy on TF32 tensor cores (3xTF32), shared by the float32
// flash attention (flash_attention_tf32.cu) and the chunkwise mLSTM
// (mlstm_chunk.cu).
//
// A tensor core reads a float32 register as TF32 (10 bits of mantissa) by
// dropping the low bits. An operand x is split as hi = tf32(x), lo =
// tf32(x - hi), both rounded to nearest, and a product is taken as lo*hi +
// hi*lo + hi*hi in the fp32 accumulator; the dropped lo*lo term is below
// 2^-22 of |x||y|. An operand that is already exact in TF32 (a bfloat16
// input widened to float32) needs no lo part, so a product with one such
// operand takes two mma instructions, and a product of two takes one.
#pragma once

#include <stdint.h>

namespace {

// x rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for every finite x (adding half a TF32 unit to the
// magnitude carries into the kept bits exactly when the dropped 13 bits
// are at least half), in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32 (round to nearest)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (16 x 8, fp32) += A (16 x 8, TF32) B (8 x 8, TF32); not volatile, so
// the compiler may interleave independent products
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
