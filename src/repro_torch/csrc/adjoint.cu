// Gaussian adjoint S^T Y, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel of the JAX reference package:
//   kernels/gaussian/gram.py  gaussian_adjoint_tiles
// For Y (m, k) float32 and S in R^{m x n} with S[i, j] = counter_normal(k0, k1,
// i, j) / sqrt(m) (rng.cuh: the same counter pair (sketch row i, data row j) as
// the forward S.A of sketch_gram.cu, so <S x, y> = <x, S^T y> holds for one S),
// it computes out[j, c] = sum_i S[i, j] * Y[i, c] for j < n, c < k. It is the
// x = S^T z of the right-sketch least-norm solve (sketch_least_norm, the paper's
// section V), where Y is the (m, 1) solution z of the small problem: k = 1.
//
// What bounds it on this card: drawing S. Each of the m * n entries is one
// threefry (about 75 integer operations at 20 rounds) and a Box-Muller (logf,
// sqrtf, cosf); the product adds 2 * k flops per entry and the bytes are Y and
// the output, (m + n) * k floats. At m = 4,000, n = 11,556, k = 1 the integer work
// alone is 0.21 ms at the card's int32 rate, the bytes 0.02 us. So nothing is
// staged for reuse but Y: the TPU kernel's (block_n x block_k) MXU contraction,
// the 128-lane padding of k and the padding of m and n to blocks are gone.
//
// Design. One thread owns one output row j (128 rows a block) and walks its
// split of the sketch rows i in chunks of 128: the block stages the chunk's Y
// rows (KC columns) in shared memory, then each thread draws S[i, j] in
// registers for the 128 i of the chunk and accumulates KC running products;
// each S entry is drawn exactly once per column tile. k = 1 takes a one-column
// instance (KC = 1); k > 1 takes KC = 8 accumulators a thread, and grid z walks
// the 8-column tiles, so S is drawn once for k <= 8 and once per 8 columns
// beyond. Masked rows and columns (i >= m, j >= n, c >= k) are never drawn or
// written: nothing is padded in device memory.
// Enough blocks: at n = 1,000 there are only 8 row tiles, so m is cut into
// splits (kernels/cuda.py plan_adjoint: a function of (m, n, k) only), each
// block writes its split's partial (n_splits, n, k), and reduce_splits_kernel
// (gram_pass.cuh) sums the partials in split order. There are no atomics, so
// reruns are bitwise equal.
// Two-level sum: within a split a thread's product chain restarts every chunk
// (at most 128 terms) and is added to a running sum; the splits are then added
// in order. At m = 4,000 one output is 23 chains of <= 128 terms and 23 partials,
// against a float64 plain version the check holds per column to 1e-5 of the
// column's rms.
#include <cuda_runtime.h>

#include <cstdint>

#include "gram_pass.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 128;  // output rows per block, one per thread
constexpr int CHUNK = 128;    // sketch rows staged per step, one loaded per thread
constexpr int KC_MULTI = 8;   // columns a thread accumulates when k > 1
static_assert(THREADS == CHUNK, "each thread stages one Y row of a chunk");

template <int KC, int ROUNDS>
__global__ void __launch_bounds__(THREADS)
adjoint_partial_kernel(const float* __restrict__ Y, int m, int k, long long n, uint32_t k0,
                       uint32_t k1, float scale, int rounds, int rows_per_split,
                       float* __restrict__ partial) {
  __shared__ float y_tile[CHUNK][KC];
  const int tid = threadIdx.x;
  const long long j = static_cast<long long>(blockIdx.x) * THREADS + tid;
  const int split = blockIdx.y;
  const int c0 = blockIdx.z * KC;
  const int nrounds = ROUNDS > 0 ? ROUNDS : rounds;
  const int i_begin = split * rows_per_split;
  const int i_end = min(m, i_begin + rows_per_split);
  const bool live = j < n;

  float run[KC];
  float acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) run[c] = acc[c] = 0.f;

  for (int i0 = i_begin; i0 < i_end; i0 += CHUNK) {
    const int rows = min(CHUNK, i_end - i0);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      y_tile[tid][c] = (tid < rows && c0 + c < k)
                           ? __ldg(Y + static_cast<long long>(i0 + tid) * k + c0 + c)
                           : 0.f;
    }
    __syncthreads();
    if (live) {
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const float s = repro::counter_normal(k0, k1, static_cast<uint32_t>(i0 + r),
                                              static_cast<uint32_t>(j), nrounds) * scale;
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c] = fmaf(s, y_tile[r][c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        run[c] += acc[c];
        acc[c] = 0.f;
      }
    }
    __syncthreads();
  }

  if (live) {
    float* out = partial + (static_cast<long long>(split) * n + j) * k;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c0 + c < k) out[c0 + c] = run[c];
    }
  }
}

template <int KC, int ROUNDS>
cudaError_t launch_adjoint(dim3 grid, cudaStream_t stream, const float* Y, int m, int k, long long n,
                           uint32_t k0, uint32_t k1, float scale, int rounds, int rows_per_split,
                           float* partial) {
  adjoint_partial_kernel<KC, ROUNDS><<<grid, THREADS, 0, stream>>>(
      Y, m, k, n, k0, k1, scale, rounds, rows_per_split, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Y: (m, k) float32, row-major, on the device. (k0, k1): the key words of S,
// scale: float32(1/sqrt(m)), rounds: threefry rounds (a positive multiple of 4).
// partial: (n_splits, n, k) float32 scratch; out: (n, k) float32.
// The sketch rows are cut into n_splits splits of rows_per_split rows, none
// empty: (n_splits - 1) * rows_per_split < m <= n_splits * rows_per_split.
// Returns cudaErrorInvalidValue for a shape or split it cannot take, else the
// first CUDA error of the two launches (0 when both were accepted).
int repro_gaussian_adjoint(const float* Y, int m, int k, long long n, uint32_t k0, uint32_t k1,
                           float scale, int rounds, int rows_per_split, int n_splits, float* partial,
                           float* out, void* stream_ptr) {
  if (m <= 0 || k <= 0 || n <= 0 || n > 0x7FFFFFFFLL || rounds <= 0 || rounds % 4 != 0 ||
      rows_per_split <= 0 || n_splits <= 0 || n_splits > 65535 ||
      static_cast<long long>(n_splits) * rows_per_split < m ||
      static_cast<long long>(n_splits - 1) * rows_per_split >= m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kc = k == 1 ? 1 : KC_MULTI;
  const long long row_tiles = (n + THREADS - 1) / THREADS;
  const int col_tiles = (k + kc - 1) / kc;
  if (col_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles), n_splits, col_tiles);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (kc == 1) {
    err = rounds == 20 ? launch_adjoint<1, 20>(grid, stream, Y, m, k, n, k0, k1, scale, rounds,
                                               rows_per_split, partial)
                       : launch_adjoint<1, 0>(grid, stream, Y, m, k, n, k0, k1, scale, rounds,
                                              rows_per_split, partial);
  } else {
    err = rounds == 20 ? launch_adjoint<KC_MULTI, 20>(grid, stream, Y, m, k, n, k0, k1, scale,
                                                      rounds, rows_per_split, partial)
                       : launch_adjoint<KC_MULTI, 0>(grid, stream, Y, m, k, n, k0, k1, scale,
                                                     rounds, rows_per_split, partial);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(repro::reduce_splits(partial, 1, n_splits, static_cast<int>(n), k, out,
                                               n * k, stream));
}

}  // extern "C"
