// TF32 tensor-core pieces of the dense S.A kernel (sketch_apply.cu), shared with
// its probe (mma_probe.cu) so that the probe checks the very fragment code the
// kernel runs.
//
// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest (ties away); a product a*b is taken as lo_a*hi_b + hi_a*lo_b +
// hi_a*hi_b in fp32 (lo*lo is below fp32's rounding).
//
// mma.sync.m16n8k8 TF32 fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8"),
// with gid = lane / 4 and tig = lane % 4:
//   A (16 x 8, row): a0 = A[gid][tig], a1 = A[gid + 8][tig], a2 = A[gid][tig + 4],
//                    a3 = A[gid + 8][tig + 4];
//   B (8 x 8, col):  b0 = B[tig][gid], b1 = B[tig + 4][gid];
//   C (16 x 8):      c0, c1 = C[gid][2 tig + {0, 1}], c2, c3 = C[gid + 8][2 tig + {0, 1}].
#pragma once

#include <cstdint>

namespace repro {

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding for finite x, in two integer operations,
// which issue faster in the S.A kernel than the conversion (bitwise the same
// S.X at every path shape, tools/apply_ablation.py).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x), lo = tf32(x - hi), both as float bit patterns.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), TF32 inputs, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro
