// Fast Walsh-Hadamard transform, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel of the JAX reference package:
//   kernels/fwht/kernel.py  fwht_tiles (body _fwht_tile_kernel), which
//   kernels/fwht/ops.py fwht drives in two Kronecker grid passes.
// y = H x for x (n, k) float32, row-major, n = 2^L, H the unnormalised +-1
// Hadamard matrix of order n: the transform inside the SRHT's S.A (D A, zero
// rows up to n_pad, then this, then the m sampled rows).
//
// What bounds it on this card: bytes. The transform is L add/subtract pairs per
// element pair, n * L * k flops (at the SRHT's full n, 2^19 x 251: 2.5 G flop,
// 0.04 ms at the fp32 peak), against one read and one write of x per pass (526
// MB each way: 0.314 ms per pass at 3.35 TB/s). The TPU ran the transform as
// dense products with small Hadamard factors on the MXU, R * (128 + R / 128)
// multiplies per element; on Hopper that is far more work than the butterfly,
// so this design keeps the butterfly and cuts the passes over x.
//
// Design. A pass runs t <= 10 consecutive stages h = 2^lo, ..., 2^(lo+t-1). Its
// grid is (group x column strip): a group is the 2^t rows base + i * 2^lo,
// i < 2^t, that those stages mix; a strip is 32 columns (lane = column; the
// last strip masks the ragged edge, so any k works and rows need not be 16-byte
// aligned). A block of 8 warps:
//   1. for each run of 2^a consecutive i (a = min(5, t)), loads the 2^a rows of
//      its column into registers, runs the pass's first a stages there, and
//      stores the run to shared memory (2^t x 32 floats, at most 128 KB);
//   2. after a barrier, for each residue r < 2^a, loads the 2^(t-a) rows
//      i = r + j * 2^a from shared memory into registers, runs the other t - a
//      stages there and writes the rows to y.
// x and y cross device memory once per pass: the first pass reads x and writes
// y, later passes work on y in place (a block reads all its elements before it
// writes any, and blocks own disjoint elements). The caller (kernels/cuda.py
// plan_fwht) cuts L into the fewest passes: two for n <= 2^20.
// Bitwise equal to the plain version: every stage is the butterfly
// (a, b) -> (a + b, a - b) of sketches._fwht, and stages run in its order
// h = 1, 2, 4, ... (across passes and within a pass), so every output is the
// same sequence of float adds and subtracts. No atomics.
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;  // columns per block: lane = column
constexpr int WARPS = 8;
constexpr int THREADS = W * WARPS;
constexpr int MAX_TILE_BITS = 10;  // 2^10 rows x 32 columns x 4 B = 128 KB of shared memory
constexpr int REG_BITS = 5;        // stages a step runs in registers

// The stages h = 1, 2, ..., 2^(B-1) of a 2^B-point transform held in registers, in order.
template <int B>
__device__ __forceinline__ void butterflies(float (&v)[1 << B]) {
#pragma unroll
  for (int st = 0; st < B; ++st) {
    const int h = 1 << st;
#pragma unroll
    for (int i = 0; i < (1 << B); ++i) {
      if ((i & h) == 0) {
        const float a = v[i];
        const float b = v[i + h];
        v[i] = a + b;
        v[i + h] = a - b;
      }
    }
  }
}

// One pass of T stages starting at stage 2^lo; x and y may be the same array.
template <int T>
__global__ void __launch_bounds__(THREADS)
fwht_pass_kernel(const float* x, float* y, int k, int lo, int strips) {
  constexpr int A = T < REG_BITS ? T : REG_BITS;
  constexpr int B = T - A;
  extern __shared__ float tile[];  // [1 << T][W]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long group = blockIdx.x / strips;
  const int col = static_cast<int>(blockIdx.x % strips) * W + lane;
  const bool live = col < k;
  const long long stride = 1LL << lo;
  const long long base = ((group >> lo) << (lo + T)) | (group & (stride - 1));

  for (int u = warp; u < (1 << B); u += WARPS) {
    float v[1 << A];
#pragma unroll
    for (int i = 0; i < (1 << A); ++i) {
      const long long row = base + static_cast<long long>((u << A) + i) * stride;
      v[i] = live ? x[row * k + col] : 0.f;
    }
    butterflies<A>(v);
#pragma unroll
    for (int i = 0; i < (1 << A); ++i) tile[((u << A) + i) * W + lane] = v[i];
  }
  __syncthreads();
  for (int r = warp; r < (1 << A); r += WARPS) {
    float v[1 << B];
#pragma unroll
    for (int j = 0; j < (1 << B); ++j) v[j] = tile[(r + (j << A)) * W + lane];
    butterflies<B>(v);
    if (live) {
#pragma unroll
      for (int j = 0; j < (1 << B); ++j) {
        const long long row = base + static_cast<long long>(r + (j << A)) * stride;
        y[row * k + col] = v[j];
      }
    }
  }
}

template <int T>
cudaError_t launch_pass(const float* x, float* y, long long n, int k, int lo, cudaStream_t stream) {
  const int strips = (k + W - 1) / W;
  const long long blocks = (n >> T) * strips;
  if (blocks <= 0 || blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const int smem = (1 << T) * W * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(fwht_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fwht_pass_kernel<T><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(x, y, k, lo, strips);
  return cudaGetLastError();
}

cudaError_t run_pass(int t, const float* x, float* y, long long n, int k, int lo,
                     cudaStream_t stream) {
  switch (t) {
    case 0: return launch_pass<0>(x, y, n, k, lo, stream);
    case 1: return launch_pass<1>(x, y, n, k, lo, stream);
    case 2: return launch_pass<2>(x, y, n, k, lo, stream);
    case 3: return launch_pass<3>(x, y, n, k, lo, stream);
    case 4: return launch_pass<4>(x, y, n, k, lo, stream);
    case 5: return launch_pass<5>(x, y, n, k, lo, stream);
    case 6: return launch_pass<6>(x, y, n, k, lo, stream);
    case 7: return launch_pass<7>(x, y, n, k, lo, stream);
    case 8: return launch_pass<8>(x, y, n, k, lo, stream);
    case 9: return launch_pass<9>(x, y, n, k, lo, stream);
    case 10: return launch_pass<10>(x, y, n, k, lo, stream);
    default: return cudaErrorInvalidValue;
  }
}

static_assert(MAX_TILE_BITS == 10, "run_pass instantiates passes of 0 to 10 stages");

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (n, k) float32, row-major, on the device, not overlapping. pass_bits:
// host array of `passes` stage counts, each in [0, MAX_TILE_BITS], summing to
// log2(n); pass p runs its stages after those of the passes before it. Returns
// cudaErrorInvalidValue for a shape or plan it cannot take, else the first CUDA
// error of the passes' launches (0 when all were accepted).
int repro_fwht(const float* x, float* y, long long n, int k, const int* pass_bits, int passes,
               void* stream_ptr) {
  if (n <= 0 || (n & (n - 1)) != 0 || k <= 0 || passes <= 0 || pass_bits == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int total = 0;
  for (int p = 0; p < passes; ++p) {
    if (pass_bits[p] < 0 || pass_bits[p] > MAX_TILE_BITS) return static_cast<int>(cudaErrorInvalidValue);
    total += pass_bits[p];
  }
  if (total > 62 || (1LL << total) != n) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int lo = 0;
  for (int p = 0; p < passes; ++p) {
    const cudaError_t err = run_pass(pass_bits[p], p == 0 ? x : y, y, n, k, lo, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    lo += pass_bits[p];
  }
  return 0;
}

}  // extern "C"
