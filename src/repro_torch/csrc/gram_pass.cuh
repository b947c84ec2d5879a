// The two passes that finish every fused sketch->Gram kernel of the port, shared
// by sketch_gram.cu (dense and SRHT sketch passes) and sjlt_gram.cu (SJLT pass);
// the S.A entries (sjlt_gram.cu, and sketch_apply.cu when it has more than one
// split) and the adjoint (adjoint.cu) use the first alone.
//
// A sketch pass leaves, for each of q workers, n_splits partial sketches S_w X
// over disjoint ranges of data rows: partial is (q, n_splits, m, d) float32.
//   reduce_splits_kernel sums each worker's splits in split order, into split 0
//   for a Gram, or into an (q, m, d) output for an S.A entry: on the same
//   sketch pass the same sums, so the SJLT S.A entry's S_w X is bitwise what
//   its Gram pass contracts;
//   gram_kernel forms G_w = acc_w^T acc_w (contraction over m) with a tiled FFMA
//   loop, each G entry one fmaf chain over m in ascending order, so G is bitwise
//   symmetric.
// Neither pass uses atomics, so a rerun is bitwise equal, and a worker's result
// does not depend on which other workers share the launch.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// partial: (q, n_splits, m*d). Sums the splits of each worker in split order
// into out + w * out_stride (out may be partial itself, with out_stride
// n_splits * m * d: each thread reads its element's splits before writing).
__global__ void reduce_splits_kernel(const float* partial, int q, int n_splits, long long md,
                                     float* out, long long out_stride) {
  const long long total = static_cast<long long>(q) * md;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long w = idx / md;
    const long long e = idx - w * md;
    const float* p = partial + w * n_splits * md + e;
    float s = p[0];
    for (int t = 1; t < n_splits; ++t) s += p[t * md];
    out[w * out_stride + e] = s;
  }
}

// The split reduction of partial (q, n_splits, m, d) into out (q, m, d) with
// stride out_stride per worker; returns the launch error.
inline cudaError_t reduce_splits(const float* partial, int q, int n_splits, int m, int d,
                                 float* out, long long out_stride, cudaStream_t stream) {
  const long long md = static_cast<long long>(m) * d;
  const long long want_blocks = (static_cast<long long>(q) * md + 255) / 256;
  const int blocks = static_cast<int>(want_blocks < 65535LL * 8 ? want_blocks : 65535LL * 8);
  reduce_splits_kernel<<<blocks, 256, 0, stream>>>(partial, q, n_splits, md, out, out_stride);
  return cudaGetLastError();
}

constexpr int GT = 64;  // G tile edge
constexpr int GK = 16;  // sketch rows per step

// G_w = acc_w^T acc_w; acc_w is (m, d) at partial + w * acc_stride.
__global__ void __launch_bounds__(256)
gram_kernel(const float* __restrict__ partial, long long acc_stride, int m, int d,
            float* __restrict__ G) {
  __shared__ float xi[GK][GT];
  __shared__ float xj[GK][GT];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int i0 = blockIdx.y * GT;
  const int j0 = blockIdx.x * GT;
  const int w = blockIdx.z;
  const float* acc = partial + w * acc_stride;

  float sum[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sum[a][b] = 0.f;

  for (int r0 = 0; r0 < m; r0 += GK) {
#pragma unroll
    for (int t = 0; t < GK * GT / 256; ++t) {
      const int e = tid + 256 * t;
      const int rr = e / GT;
      const int cc = e % GT;
      const int r = r0 + rr;
      const float* row = acc + static_cast<long long>(r) * d;
      xi[rr][cc] = (r < m && i0 + cc < d) ? row[i0 + cc] : 0.f;
      xj[rr][cc] = (r < m && j0 + cc < d) ? row[j0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        a[t] = xi[k][ty + 16 * t];
        b[t] = xj[k][tx + 16 * t];
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int t = 0; t < 4; ++t) sum[s][t] = fmaf(a[s], b[t], sum[s][t]);
    }
    __syncthreads();
  }

  float* out = G + static_cast<long long>(w) * d * d;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int i = i0 + ty + 16 * s;
    if (i >= d) continue;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = j0 + tx + 16 * t;
      if (j < d) out[static_cast<long long>(i) * d + j] = sum[s][t];
    }
  }
}

// Both passes over partial (q, n_splits, m, d) into G (q, d, d); returns the
// first CUDA launch error (cudaSuccess when both were accepted).
inline cudaError_t reduce_and_gram(float* partial, int q, int n_splits, int m, int d, float* G,
                                   cudaStream_t stream) {
  const long long md = static_cast<long long>(m) * d;
  cudaError_t err = reduce_splits(partial, q, n_splits, m, d, partial, n_splits * md, stream);
  if (err != cudaSuccess) return err;

  const int g_tiles = (d + GT - 1) / GT;
  gram_kernel<<<dim3(g_tiles, g_tiles, q), dim3(16, 16), 0, stream>>>(
      partial, static_cast<long long>(n_splits) * md, m, d, G);
  return cudaGetLastError();
}

}  // namespace repro
