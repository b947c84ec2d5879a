// Probe of the device counter RNG (rng.cuh), for checking it against the plain
// PyTorch contract in repro_torch/kernels/common.py. Not on any solve path: it
// writes, for each counter pair (c0[e], c1[e]) under key (k0, k1),
//   words[2e], words[2e+1]  threefry2x32 with `rounds` rounds,
//   normals[e]              counter_normal with `rounds` rounds,
//   signs[e]                the packed-contract sign at sketch row c0[e], data
//                           row c1[e]: bit c1 % 32 of threefry20(k, c0, c1 / 32)[0].
#include <cuda_runtime.h>

#include <cstdint>

#include "rng.cuh"

namespace {

__global__ void rng_probe_kernel(uint32_t k0, uint32_t k1, const uint32_t* __restrict__ c0,
                                 const uint32_t* __restrict__ c1, int count, int rounds,
                                 uint32_t* __restrict__ words, float* __restrict__ normals,
                                 float* __restrict__ signs) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const uint2 b = repro::threefry2x32(k0, k1, c0[e], c1[e], rounds);
  words[2 * e] = b.x;
  words[2 * e + 1] = b.y;
  normals[e] = repro::counter_normal(k0, k1, c0[e], c1[e], rounds);
  const uint32_t word = repro::packed_sign_word(k0, k1, c0[e], c1[e] >> 5);
  signs[e] = ((word >> (c1[e] & 31u)) & 1u) ? -1.f : 1.f;
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int repro_rng_probe(unsigned int k0, unsigned int k1, const uint32_t* c0,
                               const uint32_t* c1, int count, int rounds, uint32_t* words,
                               float* normals, float* signs, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  rng_probe_kernel<<<(count + 255) / 256, 256, 0, stream>>>(k0, k1, c0, c1, count, rounds,
                                                             words, normals, signs);
  return static_cast<int>(cudaGetLastError());
}
