// 3xTF32 helpers shared by the tensor-core tiles (rhs_tall.cuh, tri_gram.cuh,
// fused_als.cu), for sm_90a: x = hi + lo with hi = tf32(x), and the TF32
// m16n8k8 product.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// d += A (16 x 8) . B (8 x 8) in TF32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 fraction bits, to nearest, ties away from zero:
// cvt.rna.tf32.f32's rounding), in integer operations, which run at four
// times the rate of the conversion unit
__device__ __forceinline__ uint32_t round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the low part of x beside hi = round(x), rounded to TF32 too
__device__ __forceinline__ uint32_t low(float x, uint32_t hi) {
  return round(x - __uint_as_float(hi));
}

}  // namespace tf32
