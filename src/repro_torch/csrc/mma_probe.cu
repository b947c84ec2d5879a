// Probes of the dense S.A kernel's tensor-core product (tf32.cuh), not on any
// solve path:
//   repro_mma_probe  one warp's m16n8k8 product of A (16 x 8) and B (8 x 8), as
//                    one TF32 product and in the 3xTF32 form, for checking the
//                    fragment layouts and the split against a float64 product;
//   repro_mma_rate   mma.sync TF32 alone from registers (no loads): the ceiling
//                    the S.A kernel's consumer warps work under.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32.cuh"

namespace {

// A and B row-major floats, d_tf32 and d_3x (16 x 8) row-major.
__global__ void mma_probe_kernel(const float* A, const float* B, float* d_tf32, float* d_3x) {
  const int lane = threadIdx.x;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  uint32_t ah[4], al[4];
  const float a[4] = {A[gid * 8 + tig], A[(gid + 8) * 8 + tig], A[gid * 8 + tig + 4],
                      A[(gid + 8) * 8 + tig + 4]};
  for (int e = 0; e < 4; ++e) repro::split_tf32(a[e], ah[e], al[e]);
  uint32_t bh0, bl0, bh1, bl1;
  repro::split_tf32(B[tig * 8 + gid], bh0, bl0);
  repro::split_tf32(B[(tig + 4) * 8 + gid], bh1, bl1);
  float c1[4] = {0.f, 0.f, 0.f, 0.f};
  float c3[4] = {0.f, 0.f, 0.f, 0.f};
  repro::mma_tf32(c1, ah, bh0, bh1);
  repro::mma_tf32(c3, ah, bl0, bl1);
  repro::mma_tf32(c3, al, bh0, bh1);
  repro::mma_tf32(c3, ah, bh0, bh1);
  for (int e = 0; e < 4; ++e) {
    const int idx = (gid + (e >= 2 ? 8 : 0)) * 8 + 2 * tig + (e & 1);
    d_tf32[idx] = c1[e];
    d_3x[idx] = c3[e];
  }
}

// Each of a block's 8 warps runs `iters` rounds of 8 independent m16n8k8
// products on registers and writes a sum, so that nothing is optimised away.
__global__ void __launch_bounds__(256) mma_rate_kernel(int iters, float* out) {
  float c[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) repro::mma_tf32(c[k], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A (16, 8), B (8, 8), d_tf32 and d_3x (16, 8), float32 on the device.
int repro_mma_probe(const float* A, const float* B, float* d_tf32, float* d_3x, void* stream_ptr) {
  mma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>(A, B, d_tf32, d_3x);
  return static_cast<int>(cudaGetLastError());
}

// mma_rate_kernel on `blocks` blocks of 256 threads; out: blocks * 256 floats.
// Each block runs 8 * 8 * iters m16n8k8 products (2,048 flops each).
int repro_mma_rate(int blocks, int iters, float* out, void* stream_ptr) {
  mma_rate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
