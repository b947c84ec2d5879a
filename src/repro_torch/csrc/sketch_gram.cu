// Fused sketch -> Gram for the dense sketch families, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of the JAX reference package:
//   kernels/gaussian/gram.py      gaussian_gram_tiles, gaussian_gram_tiles_multi
//   kernels/rademacher/gram.py    rademacher_gram_tiles, rademacher_gram_tiles_multi
//   kernels/fwht/gram.py          srht_gram_tiles, srht_gram_tiles_multi
// For q keys (one per worker) and X = [A | b] of shape (n, d), repro_sketch_gram
// computes G_w = (S_w X)^T (S_w X), with S_w[i, j] drawn in-core from the
// counter stream (rng.cuh): neither S nor S X is ever written to device memory
// whole. The dense S.A (Gaussian, Rademacher) has its own kernel and plan in
// sketch_apply.cu, so its S_w X agrees with the one this file contracts to
// rounding, not bitwise.
// The SRHT's S is dense too, by the Sylvester closed form
//   S[r, j] = (1/sqrt(m)) * (-1)^popcount(rows[r] & j) * D[j],
// with rows[r] the worker's sampled Hadamard row ids (drawn on the host, passed
// as (q, m) int32) and D[j] the sign of threefry20(kd, j, 0)[0]'s low bit; j is
// the global data row. No transform runs: each entry is a popcount.
//
// What bounds it on this card. The bytes are small: S never leaves the SM, and
// each worker's blocks read X (about 0.5 GB at n = 500,000, d = 251) once per
// m-tile. Workers never share a block (grid z = worker), so a q-key call reads X
// q * m_tiles times from the SMs' side, not once for all q as the TPU's _multi
// kernel does. The m-tiles of one split are neighbours in the grid and can meet
// in L2; how many of those reads reach device memory is not measured. The work is
// m*n*d FFMA on the fp32 pipe plus the RNG: per Gaussian entry one threefry
// (about 75 integer operations at 20 rounds) and logf/sqrtf/cosf, per Rademacher
// entry 1/32 of a threefry, per SRHT entry an AND, a popcount and a select (D
// costs one threefry per data row per block). So the Gaussian kernel is bound by
// the integer RNG pipe and the fp32 pipe together, the Rademacher and SRHT
// kernels by fp32 FFMA.
//
// Design.
//   Sketch pass: grid (m-tile x d-tile, n-split, worker). A block owns BM = 64
//   sketch rows and BD = 256 columns of X and walks its n-range BK = 32 data rows
//   at a time: it draws the (BM x BK) tile of S once into shared memory, loads
//   the matching (BK x BD) tile of X (masked at the ragged edges, so nothing is
//   padded in device memory) and accumulates BM x BD in fp32 registers, 8 x 8
//   per thread, with FFMA. Every FLUSH_STEPS steps (256 data rows) a thread
//   adds its 64 registers to its running sums in shared memory (64 KB a block)
//   and restarts them: a two-level sum, chains of 256 products and then one add
//   per 256 rows. One chain over a whole split (9,632 rows at FIG3A) left the
//   largest S.X entry ~7e-6 of its column's rms off the exact sum; the two
//   levels cut the rounding about 6x for one FADD per 256 FFMAs. Each S entry
//   is reused across all BD columns. For
//   Rademacher the 32-row step is one packed-sign word per sketch row. For the
//   SRHT the block keeps its BM row ids in shared memory and draws the step's BK
//   diagonal signs once into shared memory before the S tile. The block writes
//   its (BM x BD) partial; there are no atomics.
//   Gram pass (gram_pass.cuh): a second kernel sums the n-split partials in split
//   order, then a third forms G_w = acc_w^T acc_w.
// Determinism: the number of n-splits is a function of (n, m, d) only, chosen by
// the caller, and workers never share a block, so the slice of a q-key call for
// key w is bitwise equal to a call with q = 1 on key w, and reruns are bitwise.
// The caller plans the splits with this file's BM, BD and BK (kernels/cuda.py
// BLOCK_ROWS, BLOCK_COLS, STEP_ROWS); the entry refuses a split that is not a
// whole number of BK-row steps or that leaves rows of X uncovered.
#include <cuda_runtime.h>

#include <cstdint>

#include "gram_pass.cuh"
#include "rng.cuh"

namespace {

constexpr int kGaussian = 0;
constexpr int kRademacher = 1;
constexpr int kSRHT = 2;

constexpr int BM = 64;       // sketch rows per block
constexpr int BD = 256;      // columns of X per block
constexpr int BK = 32;       // data rows per step: one packed sign word
constexpr int TM = 8;        // sketch rows per thread
constexpr int TD = 8;        // columns per thread, strided by 32
constexpr int THREADS = 256; // (BM / TM) warps of 32 lanes; BD == THREADS
constexpr int FLUSH_STEPS = 8;  // steps of BK rows per register chain (two-level sum)
constexpr int RUN_SUM_BYTES = TM * TD * THREADS * static_cast<int>(sizeof(float));
static_assert(BD == THREADS && (BM / TM) * 32 == THREADS && TD * 32 == BD, "block geometry");

template <int FAMILY, int ROUNDS>
__global__ void __launch_bounds__(THREADS, 2)
sketch_partial_kernel(const float* __restrict__ X, long long n, int d,
                      const uint32_t* __restrict__ keys, const int* __restrict__ srht_rows,
                      int m, float scale, int rounds, long long rows_per_split, int d_tiles,
                      float* __restrict__ partial) {
  __shared__ __align__(16) float s_tile[BK][BM];
  __shared__ __align__(16) float x_tile[BK][BD];
  __shared__ uint32_t h_rows[FAMILY == kSRHT ? BM : 1];  // SRHT: this block's row ids
  __shared__ uint32_t d_bits[FAMILY == kSRHT ? BK : 1];  // SRHT: the step's D sign bits

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = (blockIdx.x / d_tiles) * BM;
  const int col0 = (blockIdx.x % d_tiles) * BD;
  const int split = blockIdx.y;
  const int w = blockIdx.z;
  const uint32_t k0 = keys[2 * w];
  const uint32_t k1 = keys[2 * w + 1];
  const int nrounds = ROUNDS > 0 ? ROUNDS : rounds;
  const long long j_begin = static_cast<long long>(split) * rows_per_split;
  const long long j_end = min(n, j_begin + rows_per_split);
  if constexpr (FAMILY == kSRHT) {
    if (tid < BM) {
      const int row = row0 + tid;
      h_rows[tid] = row < m ? static_cast<uint32_t>(srht_rows[static_cast<long long>(w) * m + row]) : 0u;
    }
  }

  extern __shared__ float run_sum[];  // [TM * TD][THREADS]: each thread's running sums
  float acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      acc[i][c] = 0.f;
      run_sum[(i * TD + c) * THREADS + tid] = 0.f;
    }

  int steps = 0;
  for (long long j0 = j_begin; j0 < j_end; j0 += BK) {
    // X tile: thread tid loads column col0 + tid of BK rows (coalesced per row).
    const int col = col0 + tid;
#pragma unroll 8
    for (int r = 0; r < BK; ++r) {
      const long long j = j0 + r;
      x_tile[r][tid] = (j < j_end && col < d) ? __ldg(X + j * d + col) : 0.f;
    }
    // S tile, drawn once per step; rows >= m and data rows >= j_end are zero.
    if constexpr (FAMILY == kSRHT) {
      if (tid < BK) {
        const long long j = j0 + tid;
        d_bits[tid] = j < j_end ? repro::threefry2x32(k0, k1, static_cast<uint32_t>(j), 0u, 20).x & 1u
                                : 0u;
      }
      __syncthreads();
#pragma unroll 1
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int i = e % BM;
        const int k = e / BM;
        const long long j = j0 + k;
        float s = 0.f;
        if (row0 + i < m && j < j_end) {
          const uint32_t odd =
              (static_cast<uint32_t>(__popc(h_rows[i] & static_cast<uint32_t>(j))) ^ d_bits[k]) & 1u;
          s = odd ? -scale : scale;
        }
        s_tile[k][i] = s;
      }
    } else if constexpr (FAMILY == kGaussian) {
#pragma unroll 1
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int i = e % BM;
        const int k = e / BM;
        const int row = row0 + i;
        const long long j = j0 + k;
        float s = 0.f;
        if (row < m && j < j_end) {
          s = repro::counter_normal(k0, k1, static_cast<uint32_t>(row),
                                    static_cast<uint32_t>(j), nrounds) * scale;
        }
        s_tile[k][i] = s;
      }
    } else {
      if (tid < BM) {
        const int row = row0 + tid;
        const uint32_t word =
            row < m ? repro::packed_sign_word(k0, k1, static_cast<uint32_t>(row),
                                              static_cast<uint32_t>(j0 >> 5))
                    : 0u;
        const float live = row < m ? scale : 0.f;
#pragma unroll
        for (int k = 0; k < BK; ++k) s_tile[k][tid] = ((word >> k) & 1u) ? -live : live;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 s_lo = *reinterpret_cast<const float4*>(&s_tile[k][warp * TM]);
      const float4 s_hi = *reinterpret_cast<const float4*>(&s_tile[k][warp * TM + 4]);
      const float s[TM] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w, s_hi.x, s_hi.y, s_hi.z, s_hi.w};
      float x[TD];
#pragma unroll
      for (int c = 0; c < TD; ++c) x[c] = x_tile[k][lane + 32 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[i][c] = fmaf(s[i], x[c], acc[i][c]);
    }
    __syncthreads();
    if (++steps == FLUSH_STEPS) {
      steps = 0;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          run_sum[(i * TD + c) * THREADS + tid] += acc[i][c];
          acc[i][c] = 0.f;
        }
    }
  }

  float* out = partial + (static_cast<long long>(w) * gridDim.y + split) *
                             static_cast<long long>(m) * d;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + warp * TM + i;
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int cc = col0 + lane + 32 * c;
      const float total = run_sum[(i * TD + c) * THREADS + tid] + acc[i][c];
      if (cc < d) out[static_cast<long long>(row) * d + cc] = total;
    }
  }
}

template <int FAMILY, int ROUNDS>
cudaError_t launch_sketch(dim3 grid, cudaStream_t stream, const float* X, long long n, int d,
                          const uint32_t* keys, const int* srht_rows, int m, float scale, int rounds,
                          long long rows_per_split, int d_tiles, float* partial) {
  const cudaError_t err = cudaFuncSetAttribute(
      sketch_partial_kernel<FAMILY, ROUNDS>, cudaFuncAttributeMaxDynamicSharedMemorySize, RUN_SUM_BYTES);
  if (err != cudaSuccess) return err;
  sketch_partial_kernel<FAMILY, ROUNDS><<<grid, THREADS, RUN_SUM_BYTES, stream>>>(
      X, n, d, keys, srht_rows, m, scale, rounds, rows_per_split, d_tiles, partial);
  return cudaGetLastError();
}

// The sketch pass of `family` into partial (q, n_splits, m, d); returns
// cudaErrorInvalidValue for a split or family it cannot take, else the launch error.
cudaError_t sketch_pass(int family, const float* X, long long n, int d, const uint32_t* keys,
                        const int* srht_rows, int q, int m, float scale, int rounds,
                        long long rows_per_split, int n_splits, float* partial,
                        cudaStream_t stream) {
  if (rows_per_split <= 0 || rows_per_split % BK != 0 ||
      static_cast<long long>(n_splits) * rows_per_split < n ||
      (family == kSRHT && srht_rows == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int m_tiles = (m + BM - 1) / BM;
  const int d_tiles = (d + BD - 1) / BD;
  const dim3 grid(m_tiles * d_tiles, n_splits, q);
  if (family == kGaussian) {
    return rounds == 20 ? launch_sketch<kGaussian, 20>(grid, stream, X, n, d, keys, srht_rows, m, scale,
                                                       rounds, rows_per_split, d_tiles, partial)
                        : launch_sketch<kGaussian, 0>(grid, stream, X, n, d, keys, srht_rows, m, scale,
                                                      rounds, rows_per_split, d_tiles, partial);
  }
  if (family == kRademacher) {
    return launch_sketch<kRademacher, 20>(grid, stream, X, n, d, keys, srht_rows, m, scale, rounds,
                                          rows_per_split, d_tiles, partial);
  }
  if (family == kSRHT) {
    return launch_sketch<kSRHT, 20>(grid, stream, X, n, d, keys, srht_rows, m, scale, rounds,
                                    rows_per_split, d_tiles, partial);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// family: 0 Gaussian, 1 Rademacher, 2 SRHT. X: (n, d) float32, row-major, on the
// device. keys: (q, 2) uint32 (for the SRHT the diagonal's key words). srht_rows:
// (q, m) int32 sampled Hadamard row ids in [0, 2^32) for the SRHT, else unused.
// partial: (q, n_splits, m, d) float32 scratch. G: (q, d, d).
// rows_per_split must be a multiple of 32 and n_splits * rows_per_split >= n.
// Returns cudaErrorInvalidValue for a split it cannot take, else the first CUDA
// error of the three launches (0 when all were accepted).
int repro_sketch_gram(int family, const float* X, long long n, int d, const uint32_t* keys,
                      const int* srht_rows, int q, int m, float scale, int rounds,
                      long long rows_per_split, int n_splits, float* partial, float* G,
                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = sketch_pass(family, X, n, d, keys, srht_rows, q, m, scale, rounds,
                                      rows_per_split, n_splits, partial, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(repro::reduce_and_gram(partial, q, n_splits, m, d, G, stream));
}

}  // extern "C"
