// Fused sketch -> Gram for the dense sketch families, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of the JAX reference package:
//   kernels/gaussian/gram.py      gaussian_gram_tiles, gaussian_gram_tiles_multi
//   kernels/rademacher/gram.py    rademacher_gram_tiles, rademacher_gram_tiles_multi
//   kernels/fwht/gram.py          srht_gram_tiles, srht_gram_tiles_multi
// For q keys (one per worker) and X = [A | b] of shape (n, d), each entry
// computes G_w = (S_w X)^T (S_w X), with S_w[i, j] drawn in-core from the
// counter stream (rng.cuh): neither S nor S X is ever written to device memory
// whole. Two sketch passes end in the same split reduction and Gram pass
// (gram_pass.cuh):
//   repro_gaussian_gram  the Gaussian family on the tensor cores (second half of
//                        this file);
//   repro_sketch_gram    the Rademacher and the SRHT on the fp32 pipe (FFMA,
//                        first half).
// The dense S.A (Gaussian, Rademacher) has its own kernel and plan in
// sketch_apply.cu, so its S_w X agrees with the one this file contracts to
// rounding, not bitwise.
// The SRHT's S is dense too, by the Sylvester closed form
//   S[r, j] = (1/sqrt(m)) * (-1)^popcount(rows[r] & j) * D[j],
// with rows[r] the worker's sampled Hadamard row ids (drawn on the host, passed
// as (q, m) int32) and D[j] the sign of threefry20(kd, j, 0)[0]'s low bit; j is
// the global data row. No transform runs: each entry is a popcount.
//
// FFMA pass.
//   What bounds it on this card. The bytes are small: S never leaves the SM, and
//   each worker's blocks read X (about 0.5 GB at n = 500,000, d = 251) once per
//   m-tile. Workers never share a block (grid z = worker), so a q-key call reads
//   X q * m_tiles times from the SMs' side, not once for all q as the TPU's
//   _multi kernel does. The m-tiles of one split are neighbours in the grid and
//   can meet in L2. The work is m*n*d FFMA on the fp32 pipe plus the RNG: per
//   Rademacher entry 1/32 of a threefry, per SRHT entry an AND, a popcount and a
//   select (D costs one threefry per data row per block). So both are bound by
//   fp32 FFMA.
//   Grid (m-tile x d-tile, n-split, worker). A block owns BM = 64 sketch rows
//   and BD = 256 columns of X and walks its n-range BK = 32 data rows at a time:
//   it draws the (BM x BK) tile of S once into shared memory, loads the matching
//   (BK x BD) tile of X (masked at the ragged edges, so nothing is padded in
//   device memory) and accumulates BM x BD in fp32 registers, 8 x 8 per thread,
//   with FFMA. Every FLUSH_STEPS steps (256 data rows) a thread adds its 64
//   registers to its running sums in shared memory (64 KB a block) and restarts
//   them: a two-level sum, chains of 256 products and then one add per 256 rows.
//   One chain over a whole split (9,632 rows at FIG3A) left the largest S.X
//   entry ~7e-6 of its column's rms off the exact sum; the two levels cut the
//   rounding about 6x for one FADD per 256 FFMAs. Each S entry is reused across
//   all BD columns. For Rademacher the 32-row step is one packed-sign word per
//   sketch row. For the SRHT the block keeps its BM row ids in shared memory and
//   draws the step's BK diagonal signs once into shared memory before the S
//   tile. The block writes its (BM x BD) partial; there are no atomics.
//
// Tensor-core pass (Gaussian).
//   What bounds it on this card. Per worker 2*m*n*d flops, taken as 3 TF32
//   products in the 3xTF32 form (tf32.cuh), and one threefry with a Box-Muller
//   per S entry, each entry drawn once per split (one column tile covers
//   d <= 256). At FIG3A (n = 500,000, d = 251, m = 2,500) the products are 3.8 ms
//   at wgmma's 495 TFLOP/s and the threefry 5.8 ms of the integer pipe; with the
//   Box-Muller (logf, sqrtf, cosf at full precision) a drawn entry is about 200
//   instructions, so the draw is bound by issue and the products must take as few
//   issue slots as they can.
//   Split pass: split_x_kernel writes X once per call as TF32 hi and lo parts,
//   in the K-major core-matrix layout that wgmma reads (below), zero-padded to
//   whole steps and column tiles, into scratch that the wrapper allocates and
//   every worker of the call reads. An X tile of XK = 16 rows and one column tile
//   is then one contiguous block: the sketch pass copies it whole with one bulk
//   copy and splits nothing per m-tile.
//   Block: BM = 64 sketch rows (an m-tile) by BN in {64, 128, 256} columns,
//   walking its split BK = 32 data rows a step, in two roles on mbarrier rings.
//   Twelve producer warps draw the step's (BM x BK) S tile, split into hi and
//   lo, into a ring of S_STAGES tiles (units of 8 rows by 4 columns shared out
//   round the warps, three threefry chains in flight a thread). Two consumer
//   warpgroups multiply with wgmma m64nNk8 (N = BN / 2 each), A = S and B = X
//   both from shared memory, three products a k-slice (lo*hi, hi*lo, hi*hi): no
//   fragment loads, a dozen instructions a step where mma.sync took hundreds.
//   All barriers are CTA-scope waits and arrivals: no block reads another's
//   shared memory, and cluster-scope acquires cost more than the work between.
//   X once per cluster: the m-tiles of one column tile and split are launched as
//   thread block clusters of c blocks (the plan pads the last cluster with
//   m-tiles past m, which copy their share of X and draw and multiply nothing).
//   Each X tile is cut into c pieces: in block r, lane 0 of consumer warp 0
//   copies piece r with one bulk copy multicast to every block of the cluster,
//   up to X_STAGES tiles ahead, once every block has handed that ring entry back
//   (x_empty counts the cluster's blocks, one arrival each after a consumer
//   barrier). It only polls for that, and waits only for a tile of the step at
//   hand, so no warp multiplies in lockstep with the cluster.
//   Two-level sum: wgmma chains of CHAIN_STEPS steps (32 data rows), then FADD
//   into running sums in shared memory, each thread its own (one chain a split
//   left the FIG3A Gram 1.2e-4 off; in the dense S.A, chains of 256 rows missed
//   the 1e-5 that the checks hold S.X to). Each block writes its (BM x BN)
//   partial.
//
// Gram pass (gram_pass.cuh): a second kernel sums the n-split partials in split
// order, then a third forms G_w = acc_w^T acc_w.
// Determinism: the plan (the number of n-splits, and for the tensor-core pass
// the column width and clusters) is a function of (n, m, d) only, chosen by the
// caller (kernels/cuda.py plan_splits and plan_gaussian_gram), nothing is added
// with atomics, the order of the products is fixed, and workers never share a
// block, so the slice of a q-key call for key w is bitwise equal to a call with
// q = 1 on key w, and reruns are bitwise. The entries refuse a split that is not
// a whole number of steps or that leaves rows of X uncovered.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "gram_pass.cuh"
#include "pipeline.cuh"
#include "rng.cuh"
#include "tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRademacher = 1;  // family ids, as kernels/cuda.py FAMILIES has them
constexpr int kSRHT = 2;

constexpr int BM = 64;       // sketch rows per block
constexpr int BD = 256;      // columns of X per block
constexpr int BK = 32;       // data rows per step: one packed sign word
constexpr int TM = 8;        // sketch rows per thread
constexpr int TD = 8;        // columns per thread, strided by 32
constexpr int THREADS = 256; // (BM / TM) warps of 32 lanes; BD == THREADS
// Steps of BK rows per register chain (two-level sum); tools/gram_ablation.py
// builds with one chain a split to time the second level.
#ifndef SKETCH_GRAM_FLUSH_STEPS
#define SKETCH_GRAM_FLUSH_STEPS 8
#endif
constexpr int FLUSH_STEPS = SKETCH_GRAM_FLUSH_STEPS;
constexpr int RUN_SUM_BYTES = TM * TD * THREADS * static_cast<int>(sizeof(float));
static_assert(BD == THREADS && (BM / TM) * 32 == THREADS && TD * 32 == BD, "block geometry");
// Ablation switches, bits of SKETCH_GRAM_ABLATE (the port builds with none):
// tools/gram_ablation.py builds both passes with some of their work left out, to
// time what the rest costs. Results are then wrong.
#ifndef SKETCH_GRAM_ABLATE
#define SKETCH_GRAM_ABLATE 0
#endif
constexpr int kAblate = SKETCH_GRAM_ABLATE;
constexpr int kSkipDraw = 1;   // no S is drawn
constexpr int kSkipX = 2;      // no X is copied into shared memory
constexpr int kSkipSplit = 4;  // tensor-core pass: the split pass does not run
constexpr int kSkipMma = 8;    // nothing is multiplied

template <int FAMILY>
__global__ void __launch_bounds__(THREADS, 2)
sketch_partial_kernel(const float* __restrict__ X, long long n, int d,
                      const uint32_t* __restrict__ keys, const int* __restrict__ srht_rows,
                      int m, float scale, long long rows_per_split, int d_tiles,
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
    if constexpr (!(kAblate & kSkipX)) {
#pragma unroll 8
      for (int r = 0; r < BK; ++r) {
        const long long j = j0 + r;
        x_tile[r][tid] = (j < j_end && col < d) ? __ldg(X + j * d + col) : 0.f;
      }
    }
    // S tile, drawn once per step; rows >= m and data rows >= j_end are zero.
    if constexpr (kAblate & kSkipDraw) {
    } else if constexpr (FAMILY == kSRHT) {
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
    for (int k = 0; k < ((kAblate & kSkipMma) ? 0 : BK); ++k) {
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
    if constexpr (kAblate & kSkipMma) {  // read both tiles, or the compiler drops what fills them
      acc[0][0] += s_tile[tid % BK][tid % BM] + x_tile[tid % BK][tid];
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

template <int FAMILY>
cudaError_t launch_sketch(dim3 grid, cudaStream_t stream, const float* X, long long n, int d,
                          const uint32_t* keys, const int* srht_rows, int m, float scale,
                          long long rows_per_split, int d_tiles, float* partial) {
  const cudaError_t err = cudaFuncSetAttribute(
      sketch_partial_kernel<FAMILY>, cudaFuncAttributeMaxDynamicSharedMemorySize, RUN_SUM_BYTES);
  if (err != cudaSuccess) return err;
  sketch_partial_kernel<FAMILY><<<grid, THREADS, RUN_SUM_BYTES, stream>>>(
      X, n, d, keys, srht_rows, m, scale, rows_per_split, d_tiles, partial);
  return cudaGetLastError();
}

// The sketch pass of `family` into partial (q, n_splits, m, d); returns
// cudaErrorInvalidValue for a split or family it cannot take, else the launch error.
cudaError_t sketch_pass(int family, const float* X, long long n, int d, const uint32_t* keys,
                        const int* srht_rows, int q, int m, float scale,
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
  if (family == kRademacher) {
    return launch_sketch<kRademacher>(grid, stream, X, n, d, keys, srht_rows, m, scale, rows_per_split,
                                      d_tiles, partial);
  }
  if (family == kSRHT) {
    return launch_sketch<kSRHT>(grid, stream, X, n, d, keys, srht_rows, m, scale, rows_per_split, d_tiles,
                                partial);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core pass of the Gaussian family (see the head of this file).
namespace tc {

constexpr int BM = 64;          // sketch rows per block (one m-tile)
constexpr int BK = 32;          // data rows per step: four 8-row k-slices
constexpr int XK = 16;          // data rows per X tile: a step multiplies two
constexpr int CONSUMERS = 256;  // warps 0-7: copy X (warp 0), multiply
constexpr int PRODUCERS = 384;  // warps 8-19: draw S
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int X_STAGES = 4;     // split X tiles in the ring (copied up to X_STAGES tiles ahead)
constexpr int S_STAGES = 2;     // drawn S tiles in the ring
// Steps of BK rows per tensor-core chain before it is added to the running sums
// (two-level sum); tools/gram_ablation.py builds with one chain a split to time
// the second level.
#ifndef SKETCH_GRAM_CHAIN_STEPS
#define SKETCH_GRAM_CHAIN_STEPS 1
#endif
constexpr int CHAIN_STEPS = SKETCH_GRAM_CHAIN_STEPS;
// Registers a thread: the block is launched with 96 (65,536 / 640, in 8s); the
// producers hand some down and the consumers take them, and ptxas compiles the
// consumers' code within the raised limit (without the hand-over the 256-column
// instantiation spilled 20/44 bytes and ran 3-4% slower). wgmma m64n128k8 alone
// needs 90, so the running sums live in shared memory, and the producers are
// twelve warps, not sixteen (768 threads leave 80: ptxas refused the wgmma).
// setmaxnreg.inc waits until the block's own pool has the registers, so the two
// must fit it.
constexpr int LAUNCH_REGS = (65536 / THREADS) / 8 * 8;
constexpr int PRODUCER_REGS = 80;
constexpr int CONSUMER_REGS = 120;
static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= THREADS * LAUNCH_REGS,
              "the consumers would wait forever for registers");
// Operands in shared memory, as wgmma reads them: K-major, no swizzle, in core
// matrices of 8 rows (sketch rows of S, columns of X) by 4 TF32 values of K (data
// rows), 128 contiguous bytes each. An S tile (BM x BK) is [part][kc][mc][8][4]
// (part 0 hi, 1 lo; kc = k / 4, mc = row / 8); an X tile (XK x BN) is
// [part][kc][nc][8][4] (nc = column / 8).
constexpr int S_FLOATS = 2 * BM * BK;  // one S tile, hi and lo
constexpr int MAX_CLUSTER = 8;         // portable cluster size

// The two consumer warpgroups split the BN columns: each multiplies the whole
// (BM x 8) S slice by its N = BN / 2 columns with wgmma m64nNk8.
template <int BN>
struct Geometry {
  static constexpr int N = BN / 2;
  static constexpr int X_FLOATS = 2 * XK * BN;  // one X tile, hi and lo
  static constexpr uint32_t X_BYTES = 4u * X_FLOATS;
  static constexpr int RUN_FLOATS = (N / 2) * CONSUMERS;  // the consumers' running sums
  static constexpr int FLOATS = X_STAGES * X_FLOATS + S_STAGES * S_FLOATS + RUN_FLOATS;
  static constexpr int SMEM_BYTES = FLOATS * 4 + 2 * (X_STAGES + S_STAGES) * 8;
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

// X (n, d) into its split form xs: per column tile ct (BN columns) and X tile g
// (XK rows; g < x_rows / XK; rows past n and columns past d are zero), the tile
// as the sketch pass's ring holds it: [part][kc][nc][8 columns][4 rows], hi and
// lo TF32 parts. Each thread splits four rows of one column and writes both
// parts; consecutive threads take consecutive columns. Grid y is the column tile.
template <int BN>
__global__ void split_x_kernel(const float* __restrict__ X, long long n, int d, long long x_rows,
                               float* __restrict__ xs) {
  constexpr int PER_TILE = (XK / 4) * BN;  // threads a tile: (kc, column) pairs
  const long long total = x_rows / XK * PER_TILE;
  const int ct = blockIdx.y;
  float* out = xs + ct * x_rows * 2 * BN;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long g = idx / PER_TILE;
    const int e = static_cast<int>(idx - g * PER_TILE);
    const int kc = e / BN;
    const int cn = e % BN;  // column within the tile: nc = cn / 8, its row in the core matrix cn % 8
    const int col = ct * BN + cn;
    const long long j0 = g * XK + 4 * kc;
    float4 hi, lo;
    float* h = &hi.x;
    float* l = &lo.x;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const long long j = j0 + kk;
      const float x = (col < d && j < n) ? X[j * d + col] : 0.f;
      uint32_t xh, xl;
      repro::split_tf32(x, xh, xl);
      h[kk] = __uint_as_float(xh);
      l[kk] = __uint_as_float(xl);
    }
    float* tile = out + g * 2 * XK * BN + (kc * (BN / 8) + cn / 8) * 32 + (cn % 8) * 4;
    *reinterpret_cast<float4*>(tile) = hi;
    *reinterpret_cast<float4*>(tile + XK * BN) = lo;
  }
}

template <int ROUNDS, int BN>
__global__ void __launch_bounds__(THREADS, 1)
gaussian_partial_kernel(const float* __restrict__ xs, long long x_rows, long long n, int d,
                        const uint32_t* __restrict__ keys, int m, float scale, int rounds,
                        long long rows_per_split, int m_tiles, int clusters, float* __restrict__ partial) {
  using G = Geometry<BN>;
  extern __shared__ __align__(128) float smem[];
  float* x_ring = smem;                             // [X_STAGES][X_FLOATS]: split X tiles
  float* s_ring = x_ring + X_STAGES * G::X_FLOATS;  // [S_STAGES][S_FLOATS]: drawn S tiles
  float4* run = reinterpret_cast<float4*>(s_ring + S_STAGES * S_FLOATS);  // [N / 8][CONSUMERS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_ring + S_STAGES * S_FLOATS + G::RUN_FLOATS);
  uint64_t* x_full = bars;                   // the whole X tile has landed (bytes)
  uint64_t* x_empty = bars + X_STAGES;       // every block of the cluster is done with it
  uint64_t* s_full = bars + 2 * X_STAGES;    // every producer warp drew its rows
  uint64_t* s_empty = s_full + S_STAGES;     // every consumer warp multiplied the tile

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cluster_id = blockIdx.x / c;
  const int ct = cluster_id / clusters;                  // column tile
  const int m_tile = (cluster_id % clusters) * c + rank;
  const bool live = m_tile < m_tiles;                    // padding m-tiles only copy X
  const int row0 = m_tile * BM;
  const int split = blockIdx.y;
  const int w = blockIdx.z;
  const uint32_t k0 = keys[2 * w];
  const uint32_t k1 = keys[2 * w + 1];
  const long long j_begin = static_cast<long long>(split) * rows_per_split;
  const long long j_end = min(n, j_begin + rows_per_split);
  const int steps = static_cast<int>((j_end - j_begin + BK - 1) / BK);

  if (tid == 0) {
    for (int f = 0; f < X_STAGES; ++f) {
      repro::mbar_init(x_full + f, 1);
      repro::mbar_init(x_empty + f, c);
    }
    for (int f = 0; f < S_STAGES; ++f) {
      repro::mbar_init(s_full + f, PRODUCERS / 32);
      repro::mbar_init(s_empty + f, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  repro::cluster_arrive();  // every block's barriers are set before any peer copies or arrives
  repro::cluster_wait();

  // Barrier phases: the u-th use of a ring entry (u = use / ring size) waits for
  // its full barrier's phase u (parity u & 1) and for its empty barrier's phase
  // u - 1 (parity (u & 1) ^ 1; a fresh barrier passes that at once).
  if (tid >= CONSUMERS) {
    // Producer warps: a step's S tile is 64 units of one core matrix (8 rows by
    // 4 columns, an entry a lane: row 8 mc + lane / 4, column 4 kc + lane % 4 for
    // unit mc + 8 kc). Warp p takes units v, v + 12, ... with v = (p + 4 t) % 12,
    // six or five of them (the six move round the warps from step to step), in
    // two rounds of three threefry chains.
    repro::set_max_regs_dec<PRODUCER_REGS>();
    constexpr int UNITS = BM / 8 * BK / 4;
    constexpr int PWARPS = PRODUCERS / 32;
    constexpr int ILP = 3;
    const int pw = warp - CONSUMERS / 32;
    const int r = lane >> 2;
    const int tig = lane & 3;
    const int nrounds = ROUNDS > 0 ? ROUNDS : rounds;
    for (int t = 0; live && t < steps; ++t) {
      const int f = t % S_STAGES;
      repro::mbar_wait_cta(s_empty + f, ((t / S_STAGES) & 1) ^ 1);
      if constexpr (!(kAblate & kSkipDraw)) {
        // Entries past the split's end are drawn too: they meet X rows past n,
        // which the split pass zeroes (splits are whole steps but the last).
        const long long jt = j_begin + static_cast<long long>(t) * BK + tig;
        const int v = (pw + 4 * t) % PWARPS;
#pragma unroll
        for (int round = 0; round < 2; ++round) {
          uint2 bits[ILP];
#pragma unroll
          for (int i = 0; i < ILP; ++i) {  // independent threefry chains first
            const int u = v + PWARPS * (ILP * round + i);
            const int row = row0 + 8 * (u % 8) + r;
            if (u < UNITS && row < m) {
              bits[i] = repro::threefry2x32(k0, k1, static_cast<uint32_t>(row),
                                            static_cast<uint32_t>(jt + 4 * (u / 8)), nrounds);
            }
          }
#pragma unroll
          for (int i = 0; i < ILP; ++i) {
            const int u = v + PWARPS * (ILP * round + i);
            if (u < UNITS) {
              uint32_t hi = 0u, lo = 0u;
              if (row0 + 8 * (u % 8) + r < m) repro::split_tf32(repro::normal_from_bits(bits[i]) * scale, hi, lo);
              float* dst = s_ring + f * S_FLOATS + u * 32 + lane;  // unit u = mc + 8 kc is core matrix (kc, mc)
              dst[0] = __uint_as_float(hi);
              dst[BM * BK] = __uint_as_float(lo);
            }
          }
        }
        // The tile is read by wgmma, through the async proxy.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(s_full + f);
    }
  } else {
    // Consumer warpgroups 0-1: multiply each S tile by the X tiles of its step,
    // warpgroup h the columns h N .. h N + N - 1; warp 0 also copies this block's
    // piece of each X tile to the whole cluster.
    repro::set_max_regs_inc<CONSUMER_REGS>();
    const int wg = warp / 4;
    const float* x_src = xs + static_cast<long long>(ct) * x_rows * 2 * BN + (j_begin / XK) * G::X_FLOATS;
    const uint32_t piece = ((G::X_BYTES + c - 1) / c + 15) & ~15u;
    const uint32_t p_lo = min(G::X_BYTES, rank * piece);
    const uint32_t p_hi = min(G::X_BYTES, p_lo + piece);
    // X tile s of the split (rows XK s .. XK s + XK - 1) into ring entry
    // s % X_STAGES of every block of the cluster (this block's piece; the local
    // barrier expects the whole tile).
    auto copy_x = [&](int s) {
      uint64_t* bar = x_full + s % X_STAGES;
      if constexpr (kAblate & kSkipX) {
        repro::mbar_arrive(bar);
      } else {
        repro::mbar_arrive_expect_tx(bar, G::X_BYTES);
        char* dst = reinterpret_cast<char*>(x_ring + (s % X_STAGES) * G::X_FLOATS) + p_lo;
        const char* src = reinterpret_cast<const char*>(x_src + static_cast<long long>(s) * G::X_FLOATS) + p_lo;
        if (c == 1) {
          repro::bulk_copy(dst, src, p_hi - p_lo, bar);
        } else {
          repro::bulk_copy_multicast(dst, src, p_hi - p_lo, bar, static_cast<uint16_t>((1u << c) - 1));
        }
      }
    };

    float acc[G::N / 2];  // the chain (CHAIN_STEPS steps), wgmma's accumulator
#pragma unroll
    for (int e = 0; e < G::N / 2; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e4 = 0; e4 < G::N / 8; ++e4) run[e4 * CONSUMERS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);

    // Lane 0 of warp 0 copies X tile s once the cluster has handed back the ring
    // entry's previous tile (s - X_STAGES), up to X_STAGES tiles ahead; it only
    // polls, and waits only for a tile of the step at hand, so no warp multiplies
    // in lockstep with the cluster.
    constexpr int X_PER_STEP = BK / XK;
    const int tiles = steps * X_PER_STEP;
    int next = 0;  // X tiles whose pieces this block has copied (lane 0 of warp 0)
    const uint32_t s_base = repro::smem_u32(s_ring);
    const uint32_t x_base = repro::smem_u32(x_ring) + wg * (G::N / 8) * 128;
    for (int t = 0; t < steps; ++t) {
      if (warp == 0) {
        if (lane == 0) {
          for (; next < tiles && next < X_PER_STEP * t + X_STAGES; ++next) {
            uint64_t* empty = x_empty + next % X_STAGES;
            const uint32_t parity = ((next / X_STAGES) & 1) ^ 1;
            if (next >= X_PER_STEP * (t + 1)) {
              if (!repro::mbar_test_cta(empty, parity)) break;
            } else {
              repro::mbar_wait_cta(empty, parity);
            }
            copy_x(next);
          }
        }
        __syncwarp();  // the warp converges before its wgmma
      }
      const int fs = t % S_STAGES;
      if (live) repro::mbar_wait_cta(s_full + fs, (t / S_STAGES) & 1);
#pragma unroll
      for (int h = 0; h < X_PER_STEP; ++h) {
        const int g = X_PER_STEP * t + h;
        repro::mbar_wait_cta(x_full + g % X_STAGES, (g / X_STAGES) & 1);
      }
      if (live && !(kAblate & kSkipMma)) {
        repro::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
          // S: core matrices kc = 2 ks, 2 ks + 1 of the tile; X: those of its tile.
          const uint32_t sa = s_base + (fs * S_FLOATS + 2 * ks * 8 * 32) * 4;
          const int g = X_PER_STEP * t + ks / (XK / 8);
          const uint32_t xa = x_base + ((g % X_STAGES) * G::X_FLOATS + 2 * (ks % (XK / 8)) * (BN / 8) * 32) * 4;
          const uint64_t s_hi = repro::smem_desc(sa, 8 * 128, 128);
          const uint64_t s_lo = repro::smem_desc(sa + BM * BK * 4, 8 * 128, 128);
          const uint64_t x_hi = repro::smem_desc(xa, (BN / 8) * 128, 128);
          const uint64_t x_lo = repro::smem_desc(xa + XK * BN * 4, (BN / 8) * 128, 128);
          repro::wgmma_tf32<G::N>(acc, s_hi, x_lo);
          repro::wgmma_tf32<G::N>(acc, s_lo, x_hi);
          repro::wgmma_tf32<G::N>(acc, s_hi, x_hi);
        }
        repro::wgmma_commit();
        repro::wgmma_wait<0>();
      }
      if (live) {
        __syncwarp();
        if (lane == 0) repro::mbar_arrive(s_empty + fs);  // the S tile may be overwritten
      }
      repro::named_sync<1, CONSUMERS>();  // every consumer warp is done with the step's X tiles: tell each block of the cluster
      if (tid < c) {
#pragma unroll
        for (int h = 0; h < X_PER_STEP; ++h) repro::mbar_arrive_remote_cta(x_empty + (X_PER_STEP * t + h) % X_STAGES, tid);
      }
      if ((t + 1) % CHAIN_STEPS == 0 || t + 1 == steps) {
#pragma unroll
        for (int e4 = 0; e4 < G::N / 8; ++e4) {  // a thread's own sums: no barrier
          float4 r = run[e4 * CONSUMERS + tid];
          r.x += acc[4 * e4];
          r.y += acc[4 * e4 + 1];
          r.z += acc[4 * e4 + 2];
          r.w += acc[4 * e4 + 3];
          run[e4 * CONSUMERS + tid] = r;
          acc[4 * e4] = acc[4 * e4 + 1] = acc[4 * e4 + 2] = acc[4 * e4 + 3] = 0.f;
        }
      }
    }

    if (live) {
      // wgmma's accumulator layout: warp w % 4 of the group holds rows
      // 16 (w % 4) .. + 15; register 4 j + e is row gid (+ 8 for e >= 2), column
      // 8 j + 2 tig + (e & 1) of the group's N.
      const int gid = lane >> 2;
      const int tig = lane & 3;
      float* out = partial + (static_cast<long long>(w) * gridDim.y + split) * static_cast<long long>(m) * d;
#pragma unroll
      for (int e4 = 0; e4 < G::N / 8; ++e4) {
        const float4 r = run[e4 * CONSUMERS + tid];
        const float v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 16 * (warp % 4) + gid + ((e & 2) ? 8 : 0);
          const int col = ct * BN + wg * G::N + 8 * e4 + 2 * tig + (e & 1);
          if (row < m && col < d) out[static_cast<long long>(row) * d + col] = v[e];
        }
      }
    }
  }
  // No block leaves while a peer may still copy into it or arrive on its barriers.
  repro::cluster_arrive();
  repro::cluster_wait();
}

// The kernel's arguments, as the C entry received them.
struct Args {
  const float* xs;
  long long x_rows;
  long long n;
  int d;
  const uint32_t* keys;
  int m;
  float scale;
  int rounds;
  long long rows_per_split;
  int m_tiles;
  int clusters;
  float* partial;
};

// A cluster launch of gaussian_partial_kernel<ROUNDS, BN>: sets the kernel's
// shared memory attribute and fills cfg (whose attrs point at attr).
template <int ROUNDS, int BN>
cudaError_t configure(dim3 grid, int cluster, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  const int smem = Geometry<BN>::SMEM_BYTES;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaFuncSetAttribute(gaussian_partial_kernel<ROUNDS, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int ROUNDS, int BN>
cudaError_t launch(dim3 grid, int cluster, cudaStream_t stream, const Args& a) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<ROUNDS, BN>(grid, cluster, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, gaussian_partial_kernel<ROUNDS, BN>, a.xs, a.x_rows, a.n, a.d, a.keys, a.m,
                           a.scale, a.rounds, a.rows_per_split, a.m_tiles, a.clusters, a.partial);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// f(std::integral_constant<int, BN>{}) for the column width block_cols.
template <typename F>
cudaError_t by_width(int block_cols, F&& f) {
  if (block_cols == 64) return f(std::integral_constant<int, 64>{});
  if (block_cols == 128) return f(std::integral_constant<int, 128>{});
  if (block_cols == 256) return f(std::integral_constant<int, 256>{});
  return cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The FFMA pass. family: 1 Rademacher, 2 SRHT (the Gaussian is repro_gaussian_gram's;
// both draw S at 20 threefry rounds). X: (n, d) float32, row-major, on the
// device. keys: (q, 2) uint32 (for the SRHT the diagonal's key words). srht_rows:
// (q, m) int32 sampled Hadamard row ids in [0, 2^32) for the SRHT, else unused.
// partial: (q, n_splits, m, d) float32 scratch. G: (q, d, d).
// rows_per_split must be a multiple of 32 and n_splits * rows_per_split >= n.
// Returns cudaErrorInvalidValue for a split it cannot take, else the first CUDA
// error of the three launches (0 when all were accepted).
int repro_sketch_gram(int family, const float* X, long long n, int d, const uint32_t* keys,
                      const int* srht_rows, int q, int m, float scale, long long rows_per_split,
                      int n_splits, float* partial, float* G, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = sketch_pass(family, X, n, d, keys, srht_rows, q, m, scale, rows_per_split,
                                      n_splits, partial, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(repro::reduce_and_gram(partial, q, n_splits, m, d, G, stream));
}

// The Gaussian family on the tensor cores. X: (n, d) float32, row-major, on the
// device. keys: (q, 2) uint32 on the device. The plan (kernels/cuda.py
// plan_gaussian_gram): block_cols in {64, 128, 256}; per column tile, `clusters`
// clusters of `cluster` (1 to 8) blocks of 64 sketch rows covering m; n_splits
// splits of rows_per_split rows (a multiple of 16, n_splits * rows_per_split >= n).
// xs: the split form of X, 2 * ceil(d / block_cols) * block_cols * x_rows floats,
// 16-byte aligned, with x_rows >= n a multiple of 16; split_x != 0 writes it from
// X first (the call of a wrapper's first chunk of workers), else it is read as
// it stands. partial: (q, n_splits, m, d) float32 scratch. G: (q, d, d).
// Returns cudaErrorInvalidValue for a plan it cannot take, else the first CUDA
// error of the launches (0 when all were accepted).
int repro_gaussian_gram(const float* X, long long n, int d, const uint32_t* keys, int q, int m, float scale,
                        int rounds, long long rows_per_split, int n_splits, int block_cols, int cluster,
                        int clusters, float* xs, long long x_rows, int split_x, float* partial, float* G,
                        void* stream_ptr) {
  const int m_tiles = (m + tc::BM - 1) / tc::BM;
  const int d_tiles = (d + block_cols - 1) / block_cols;
  if (rows_per_split <= 0 || rows_per_split % tc::BK != 0 ||
      static_cast<long long>(n_splits) * rows_per_split < n || x_rows < n || x_rows % tc::BK != 0 ||
      cluster < 1 || cluster > tc::MAX_CLUSTER || clusters < 1 ||
      static_cast<long long>(clusters) * cluster < m_tiles || keys == nullptr || xs == nullptr ||
      partial == nullptr || reinterpret_cast<uintptr_t>(xs) % 16 != 0 ||
      (block_cols != 64 && block_cols != 128 && block_cols != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSuccess;
  if (split_x && !(kAblate & kSkipSplit)) {
    err = tc::by_width(block_cols, [&](auto bn) {
      constexpr int BN = decltype(bn)::value;
      const long long want = (x_rows / tc::XK * (tc::XK / 4) * BN + 255) / 256;
      const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
      tc::split_x_kernel<BN><<<dim3(blocks, d_tiles), 256, 0, stream>>>(X, n, d, x_rows, xs);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(d_tiles * clusters * cluster, n_splits, q);
  const tc::Args a{xs, x_rows, n, d, keys, m, scale, rounds, rows_per_split, m_tiles, clusters, partial};
  err = tc::by_width(block_cols, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    return rounds == 20 ? tc::launch<20, BN>(grid, cluster, stream, a) : tc::launch<0, BN>(grid, cluster, stream, a);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(repro::reduce_and_gram(partial, q, n_splits, m, d, G, stream));
}

// Clusters of `cluster` blocks of the Gaussian tensor-core pass (rounds 20) at
// block_cols that can be resident at once (cudaOccupancyMaxActiveClusters), into *count.
int repro_gaussian_gram_clusters(int block_cols, int cluster, int* count) {
  return static_cast<int>(tc::by_width(block_cols, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    const cudaError_t err = tc::configure<20, BN>(dim3(cluster * 64), cluster, nullptr, cfg, attr);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(count, tc::gaussian_partial_kernel<20, BN>, &cfg);
  }));
}

}  // extern "C"
