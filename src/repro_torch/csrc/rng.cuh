// Counter RNG on the device: the contract of repro_torch/kernels/common.py
// (and of the JAX reference's kernels/common.py), written once for every kernel.
//
// Entry (i, j) of a sketch is a pure function of (key words, i, j):
//   * threefry2x32 with the reference's rotation table and key schedule;
//   * a normal is Box-Muller (cos branch) on the two words, each mapped to (0, 1)
//     as (float(word) + 0.5) * 2^-32, with the IEEE-rounded conversion;
//   * a Rademacher sign is bit j % 32 of threefry(key, i, j / 32)[0] (1 -> -1).
// logf/sqrtf/cosf are the full-precision library functions: build without
// --use_fast_math, or the normals drift from the plain version by far more
// than the tolerance the checks state.
#pragma once

#include <cstdint>

namespace repro {

__host__ __device__ constexpr int threefry_rotation(int i) {
  return i == 0 ? 13 : i == 1 ? 15 : i == 2 ? 26 : i == 3 ? 6
       : i == 4 ? 17 : i == 5 ? 29 : i == 6 ? 16 : 24;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t pick3(int i, uint32_t a, uint32_t b, uint32_t c) {
  return i == 0 ? a : (i == 1 ? b : c);
}

// Threefry-2x32 with `rounds` rounds (a positive multiple of 4). Inlined with a
// compile-time `rounds` the loop unrolls and the key schedule folds to registers.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                              uint32_t c1, int rounds) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int block = 0; block < rounds / 4; ++block) {
    const int base = (block & 1) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, base == 0 ? threefry_rotation(r) : threefry_rotation(4 + r));
      x1 ^= x0;
    }
    const int inj = block + 1;
    x0 += pick3(inj % 3, k0, k1, k2);
    x1 += pick3((inj + 1) % 3, k0, k1, k2) + static_cast<uint32_t>(inj);
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ float bits_to_open_unit(uint32_t bits) {
  return (__uint2float_rn(bits) + 0.5f) * 2.3283064365386963e-10f;  // 2^-32
}

// Box-Muller (cos branch) on the two words of one threefry.
__device__ __forceinline__ float normal_from_bits(uint2 b) {
  const float u1 = bits_to_open_unit(b.x);
  const float u2 = bits_to_open_unit(b.y);
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(6.2831854820251465f * u2);  // float32(2*pi), as the reference
}

__device__ __forceinline__ float counter_normal(uint32_t k0, uint32_t k1, uint32_t c0,
                                                uint32_t c1, int rounds) {
  return normal_from_bits(threefry2x32(k0, k1, c0, c1, rounds));
}

// The word of 32 packed signs for sketch row `row` and data rows 32*wcol .. 32*wcol+31.
__device__ __forceinline__ uint32_t packed_sign_word(uint32_t k0, uint32_t k1, uint32_t row,
                                                     uint32_t wcol) {
  return threefry2x32(k0, k1, row, wcol, 20).x;
}

}  // namespace repro
