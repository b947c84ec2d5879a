// Fused sketch -> Gram for the dense sketch families, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of the JAX reference package:
//   kernels/gaussian/gram.py      gaussian_gram_tiles, gaussian_gram_tiles_multi
//   kernels/rademacher/gram.py    rademacher_gram_tiles, rademacher_gram_tiles_multi
//   kernels/fwht/gram.py          srht_gram_tiles, srht_gram_tiles_multi
// For q keys (one per worker) and X = [A | b] of shape (n, d), each entry
// computes G_w = (S_w X)^T (S_w X), with S_w[i, j] drawn in-core from the
// counter stream (rng.cuh): neither S nor S X is ever written to device memory
// whole. One sketch pass on the tensor cores serves the three families
// (repro_dense_gram); the split reduction and the Gram pass of gram_pass.cuh
// end it. The families differ only in who draws S and in the number of products:
//   Gaussian    S[i, j] = counter_normal(key, i, j) / sqrt(m), split into TF32
//               hi and lo, three products a k-slice (lo*hi, hi*lo, hi*hi);
//   Rademacher  S[i, j] = +-1 / sqrt(m), bit j % 32 of the packed sign word
//               threefry20(key, i, j / 32)[0];
//   SRHT        S[i, j] = (1/sqrt(m)) * (-1)^popcount(rows[i] & j) * D[j], the
//               Sylvester closed form with the worker's sampled Hadamard row ids
//               (drawn on the host, passed as (q, m) int32) and D[j] the sign of
//               threefry20(kd, j, 0)[0]'s low bit; j is the global data row.
// A +-1 entry is exact in TF32, so the +-1 families take two products a k-slice
// (S X_lo, S X_hi). Their scale 1/sqrt(m) (0.02 at m = 2,500) is not: it is
// applied once, when the consumers write a partial, so S X rounds differently
// from the plain version, which folds the scale into S (both within the checks'
// 1e-5 per Gram entry). The dense S.A (Gaussian, Rademacher) has its own kernel
// and plan in sketch_apply.cu, so its S_w X agrees with the one this file
// contracts to rounding, not bitwise.
//
// What bounds it on this card. Per worker 2*m*n*d flops, taken as 3 TF32
// products (Gaussian) or 2 (+-1), each S entry drawn once per split (one column
// tile covers d <= 256): at FIG3A (n = 500,000, d = 251, m = 2,500) 3.8 or 2.5 ms
// at wgmma's 495 TFLOP/s. The Gaussian's draw is one threefry and a Box-Muller an
// entry (5.8 ms of the integer pipe; with logf, sqrtf and cosf at full precision
// about 200 instructions an entry), so it is bound by issue. The +-1 draws are
// one 32-bit sign word per sketch row per 32 data rows: a threefry (Rademacher);
// for the SRHT, since j = j0 + k with j0 a multiple of 32 and k < 32,
// popcount(r & j) = popcount(r & j0) + popcount(r & k), so the word is
// H_r ^ D ^ -(popcount(r & j0) & 1), with H_r (bit k: the parity of r & k) set
// once per block and D (bit k: D[j0 + k]) one threefry a data row, gathered with
// a ballot. So the +-1 passes are bound by the consumers' side: the products,
// the X tiles' way into shared memory, and the hand-offs.
//
// Split pass: split_x_kernel writes X once per call as TF32 hi and lo parts,
// in the K-major core-matrix layout that wgmma reads (below), zero-padded to
// whole steps and column tiles, into scratch that the wrapper allocates and
// every worker of the call reads. An X tile of XK = 16 rows and one column tile
// is then one contiguous block: the sketch pass copies it whole with one bulk
// copy and splits nothing per m-tile.
// Block: BM = 64 sketch rows (an m-tile) by BN in {64, 128, 256} columns,
// walking its split BK = 32 data rows a step, in two roles on mbarrier rings.
// Producer warps draw the step's (BM x BK) S tile into a ring in shared memory;
// two consumer warpgroups multiply with wgmma m64nNk8 (N = BN / 2 each), A = S
// and B = X both from shared memory: no fragment loads, a dozen instructions a
// step. The producers differ by family:
//   Gaussian: twelve warps draw the tile split into hi and lo (units of 8 rows
//     by 4 columns shared out round the warps, three threefry chains in flight a
//     thread) into a ring of 2 tiles;
//   +-1: one warpgroup draws the step's 64 sign words (one warp a step, in turn,
//     a lane two rows) and writes them out as +-1.0f (hi only: lo is zero) into
//     a ring of 4 tiles. It hands most of its registers to the consumers
//     (setmaxnreg), which keep their running sums in registers. (Consumers that
//     built A from the words in registers, wgmma with A from registers and no S
//     tile, took 8.1 ms at FIG3A against 7.2 for this, both with chains of 1.)
// All barriers are CTA-scope waits and arrivals: no block reads another's
// shared memory, and cluster-scope acquires cost more than the work between.
// X once per cluster: the m-tiles of one column tile and split are launched as
// thread block clusters of c blocks (the plan pads the last cluster with
// m-tiles past m, which copy their share of X and draw and multiply nothing).
// Each X tile is cut into c pieces: in block r, lane 0 of consumer warp 0
// copies piece r with one bulk copy multicast to every block of the cluster,
// up to X_STAGES tiles ahead, once every block of the cluster has handed that
// ring entry back (x_empty counts the cluster's blocks, one arrival each after
// a consumer barrier; a hand-back per warpgroup, so that the two warpgroups do
// not wait for each other, was 2-14% slower). It only polls for that, and waits
// only for a tile of the step at hand, so no warp multiplies in lockstep with
// the cluster.
// Two-level sum: wgmma chains of CHAIN_STEPS steps (32 data rows each), then
// FADD into running sums, each thread its own: in shared memory for the
// Gaussian (its producers leave the consumers no registers for them), in
// registers for the +-1 families (one chain a split left the FIG3A Grams
// 1.2e-4 (Gaussian) and 4.4e-5 (+-1) off; in the dense S.A, chains of 256 rows
// missed the 1e-5 that the checks hold S.X to). Each block writes its (BM x BN)
// partial.
//
// Gram pass (gram_pass.cuh): a second kernel sums the n-split partials in split
// order, then a third forms G_w = acc_w^T acc_w.
// Determinism: the plan (the number of n-splits, the column width and the
// clusters) is a function of (n, m, d) only, chosen by the caller
// (kernels/cuda.py plan_dense_gram), nothing is added with atomics, the order of
// the products is fixed, and workers never share a block, so the slice of a
// q-key call for key w is bitwise equal to a call with q = 1 on key w, and
// reruns are bitwise. The entry refuses a plan that is not whole steps or that
// leaves rows of X uncovered.
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

constexpr int kGaussian = 0;  // family ids, as kernels/cuda.py FAMILIES has them
constexpr int kRademacher = 1;
constexpr int kSRHT = 2;

constexpr int BM = 64;          // sketch rows per block (one m-tile)
constexpr int BK = 32;          // data rows per step: four 8-row k-slices, one sign word
constexpr int XK = 16;          // data rows per X tile: a step multiplies two
constexpr int CONSUMERS = 256;  // warps 0-7: copy X (warp 0), multiply
constexpr int MAX_CLUSTER = 8;  // portable cluster size
// Steps of BK rows per tensor-core chain before it is added to the running sums
// (two-level sum), when set: tools/gram_ablation.py builds with other chain
// lengths than the families' own (Roles::CHAIN_STEPS) to time the second level
// and measure its error.
#ifndef SKETCH_GRAM_CHAIN_STEPS
#define SKETCH_GRAM_CHAIN_STEPS 0
#endif
// Ablation switches, bits of SKETCH_GRAM_ABLATE (the port builds with none):
// tools/gram_ablation.py builds the pass with some of its work left out, to
// time what the rest costs. Results are then wrong.
#ifndef SKETCH_GRAM_ABLATE
#define SKETCH_GRAM_ABLATE 0
#endif
constexpr int kAblate = SKETCH_GRAM_ABLATE;
constexpr int kSkipDraw = 1;   // no S (or sign word) is drawn
constexpr int kSkipX = 2;      // no X is copied into shared memory
constexpr int kSkipSplit = 4;  // the split pass does not run
constexpr int kSkipMma = 8;    // nothing is multiplied

// The roles of a family's block. Registers a thread: the block is launched with
// LAUNCH_REGS (65,536 / THREADS, in 8s); the producers hand some down and the
// consumers take them, and ptxas compiles each role's code within its limit.
// setmaxnreg.inc waits until the block's own pool has the registers, so the two
// must fit it. Gaussian: 640 threads leave 96; wgmma m64n128k8 alone needs 90, so
// its running sums live in shared memory, and its producers are twelve warps,
// not sixteen (768 threads leave 80: ptxas refused the wgmma); without the
// hand-over the 256-column instantiation spilled 20/44 bytes and ran 3-4% slower.
// +-1: 384 threads leave 168; the producers keep 40, the consumers 232, room for
// the accumulator and the running sums.
template <int FAMILY>
struct Roles {
  static constexpr bool GAUSSIAN = FAMILY == kGaussian;
  static constexpr int PRODUCERS = GAUSSIAN ? 384 : 128;  // warps 8-19, or 8-11
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int LAUNCH_REGS = (65536 / THREADS) / 8 * 8;
  static constexpr int PRODUCER_REGS = GAUSSIAN ? 80 : 40;
  static constexpr int CONSUMER_REGS = GAUSSIAN ? 120 : 232;
  // Split X tiles in the ring (copied up to X_STAGES tiles ahead: one step, or
  // two for the +-1 families, whose steps are short) and drawn S tiles.
  static constexpr int X_STAGES = GAUSSIAN ? 4 : 6;
  static constexpr int S_STAGES = GAUSSIAN ? 2 : 4;
  // Steps a chain. At FIG3A (tools/gram_ablation.py), chains of 4 steps left the
  // +-1 Grams 2.8e-6 off per entry against 2.2e-6 for chains of 1 (16: 4.2e-6)
  // and took 6.5% less time; the Gaussian's chains of 2 read 1.3-1.9 times the
  // error of chains of 1 for 3%.
  static constexpr int CHAIN_STEPS = SKETCH_GRAM_CHAIN_STEPS > 0 ? SKETCH_GRAM_CHAIN_STEPS : GAUSSIAN ? 1 : 4;
  // One ring entry: a drawn S tile as wgmma reads it (below), hi and lo, or hi
  // alone for the +-1 families.
  static constexpr int S_FLOATS = (GAUSSIAN ? 2 : 1) * BM * BK;
  static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= THREADS * LAUNCH_REGS,
                "the consumers would wait forever for registers");
};

// Operands in shared memory, as wgmma reads them: K-major, no swizzle, in core
// matrices of 8 rows (sketch rows of S, columns of X) by 4 TF32 values of K (data
// rows), 128 contiguous bytes each. An S tile (BM x BK) is [part][kc][mc][8][4]
// (part 0 hi, 1 lo, the Gaussian's only; kc = k / 4, mc = row / 8); an X tile
// (XK x BN) is [part][kc][nc][8][4] (nc = column / 8). The two consumer
// warpgroups split the BN columns: each multiplies the whole (BM x 8) S slice by
// its N = BN / 2 columns with wgmma m64nNk8.
template <int FAMILY, int BN>
struct Geometry {
  using R = Roles<FAMILY>;
  static constexpr int N = BN / 2;
  static constexpr int X_FLOATS = 2 * XK * BN;  // one X tile, hi and lo
  static constexpr uint32_t X_BYTES = 4u * X_FLOATS;
  static constexpr int RUN_FLOATS = R::GAUSSIAN ? (N / 2) * CONSUMERS : 0;  // running sums in shared memory
  static constexpr int FLOATS = R::X_STAGES * X_FLOATS + R::S_STAGES * R::S_FLOATS + RUN_FLOATS;
  static constexpr int SMEM_BYTES = FLOATS * 4 + 2 * (R::X_STAGES + R::S_STAGES) * 8;
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

// A consumer thread's running sums (the second level of the two-level sum), NF
// of them: in registers, or in shared memory at run[e / 4][tid] (float4s).
template <bool IN_REGS, int NF>
struct RunSums;
template <int NF>
struct RunSums<true, NF> {
  float v[NF];
  __device__ __forceinline__ RunSums(float4*, int) {
#pragma unroll
    for (int e = 0; e < NF; ++e) v[e] = 0.f;
  }
  __device__ __forceinline__ void add(float (&acc)[NF]) {  // and restart the chain
#pragma unroll
    for (int e = 0; e < NF; ++e) {
      v[e] += acc[e];
      acc[e] = 0.f;
    }
  }
  __device__ __forceinline__ float4 get4(int e4) const {
    return make_float4(v[4 * e4], v[4 * e4 + 1], v[4 * e4 + 2], v[4 * e4 + 3]);
  }
};
template <int NF>
struct RunSums<false, NF> {
  float4* p;  // this thread's first float4; the next is CONSUMERS float4s on
  __device__ __forceinline__ RunSums(float4* run, int tid) : p(run + tid) {
#pragma unroll
    for (int e4 = 0; e4 < NF / 4; ++e4) p[e4 * CONSUMERS] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void add(float (&acc)[NF]) {  // a thread's own sums: no barrier
#pragma unroll
    for (int e4 = 0; e4 < NF / 4; ++e4) {
      float4 r = p[e4 * CONSUMERS];
      r.x += acc[4 * e4];
      r.y += acc[4 * e4 + 1];
      r.z += acc[4 * e4 + 2];
      r.w += acc[4 * e4 + 3];
      p[e4 * CONSUMERS] = r;
      acc[4 * e4] = acc[4 * e4 + 1] = acc[4 * e4 + 2] = acc[4 * e4 + 3] = 0.f;
    }
  }
  __device__ __forceinline__ float4 get4(int e4) const { return p[e4 * CONSUMERS]; }
};

// +-1.0f from bit k of a sign word (1 -> -1).
__device__ __forceinline__ float sign_f32(uint32_t word, int k) {
  return __uint_as_float(((word << (31 - k)) & 0x80000000u) | 0x3f800000u);
}

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

// Gaussian producers (twelve warps): a step's S tile is 64 units of one core
// matrix (8 rows by 4 columns, an entry a lane: row 8 mc + lane / 4, column
// 4 kc + lane % 4 for unit mc + 8 kc). Warp p takes units v, v + 12, ... with
// v = (p + 4 t) % 12, six or five of them (the six move round the warps from
// step to step), in two rounds of three threefry chains.
template <int ROUNDS>
__device__ __forceinline__ void draw_gaussian(float* s_ring, uint64_t* s_full, uint64_t* s_empty, uint32_t k0,
                                              uint32_t k1, int m, int row0, float scale, int rounds,
                                              long long j_begin, int steps) {
  using R = Roles<kGaussian>;
  constexpr int UNITS = BM / 8 * BK / 4;
  constexpr int PWARPS = R::PRODUCERS / 32;
  constexpr int ILP = 3;
  const int lane = threadIdx.x & 31;
  const int pw = (threadIdx.x - CONSUMERS) >> 5;
  const int r = lane >> 2;
  const int tig = lane & 3;
  const int nrounds = ROUNDS > 0 ? ROUNDS : rounds;
  for (int t = 0; t < steps; ++t) {
    const int f = t % R::S_STAGES;
    repro::mbar_wait_cta(s_empty + f, ((t / R::S_STAGES) & 1) ^ 1);
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
            float* dst = s_ring + f * R::S_FLOATS + u * 32 + lane;  // unit u = mc + 8 kc is core matrix (kc, mc)
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
}

// +-1 producers (one warpgroup): warp p draws the S tiles of steps p, p + 4,
// ...; lane l the sign words of the block's sketch rows l and l + 32 (rows past
// m draw words that no consumer writes out), bit k the sign of data row j0 + k
// (1 -> -1), j0 the step's first row, and writes each row's 32 entries as eight
// 16-byte rows of core matrices.
template <int FAMILY>
__device__ __forceinline__ void draw_signs(float* s_ring, uint64_t* s_full, uint64_t* s_empty, uint32_t k0,
                                           uint32_t k1, const int* __restrict__ srht_rows, int w, int m,
                                           int row0, long long j_begin, int steps) {
  using R = Roles<FAMILY>;
  constexpr int PWARPS = R::PRODUCERS / 32;
  const int lane = threadIdx.x & 31;
  const int pw = (threadIdx.x - CONSUMERS) >> 5;
  const int r0 = row0 + lane;
  const int r1 = r0 + 32;
  // SRHT: the rows' Hadamard ids, and H (bit k: the parity of id & k, k < 32).
  uint32_t id0 = 0u, id1 = 0u, h0 = 0u, h1 = 0u;
  if constexpr (FAMILY == kSRHT) {
    const long long base = static_cast<long long>(w) * m;
    id0 = r0 < m ? static_cast<uint32_t>(srht_rows[base + r0]) : 0u;
    id1 = r1 < m ? static_cast<uint32_t>(srht_rows[base + r1]) : 0u;
#pragma unroll
    for (uint32_t k = 0; k < 32; ++k) {
      h0 |= (static_cast<uint32_t>(__popc(id0 & k)) & 1u) << k;
      h1 |= (static_cast<uint32_t>(__popc(id1 & k)) & 1u) << k;
    }
  }
  for (int t = pw; t < steps; t += PWARPS) {
    const int f = t % R::S_STAGES;
    repro::mbar_wait_cta(s_empty + f, ((t / R::S_STAGES) & 1) ^ 1);
    if constexpr (!(kAblate & kSkipDraw)) {
      const uint32_t j0 = static_cast<uint32_t>(j_begin + static_cast<long long>(t) * BK);
      uint32_t w0, w1;
      if constexpr (FAMILY == kRademacher) {
        w0 = repro::packed_sign_word(k0, k1, static_cast<uint32_t>(r0), j0 >> 5);
        w1 = repro::packed_sign_word(k0, k1, static_cast<uint32_t>(r1), j0 >> 5);
      } else {
        const uint32_t dbits = __ballot_sync(0xffffffffu, repro::threefry2x32(k0, k1, j0 + lane, 0u, 20).x & 1u);
        w0 = h0 ^ dbits ^ (0u - (static_cast<uint32_t>(__popc(id0 & j0)) & 1u));
        w1 = h1 ^ dbits ^ (0u - (static_cast<uint32_t>(__popc(id1 & j0)) & 1u));
      }
      float* tile = s_ring + f * R::S_FLOATS;
#pragma unroll
      for (int kc = 0; kc < BK / 4; ++kc) {  // core matrix (kc, mc), its row r % 8
        const float4 v0 = make_float4(sign_f32(w0, 4 * kc), sign_f32(w0, 4 * kc + 1), sign_f32(w0, 4 * kc + 2),
                                      sign_f32(w0, 4 * kc + 3));
        const float4 v1 = make_float4(sign_f32(w1, 4 * kc), sign_f32(w1, 4 * kc + 1), sign_f32(w1, 4 * kc + 2),
                                      sign_f32(w1, 4 * kc + 3));
        *reinterpret_cast<float4*>(tile + (kc * (BM / 8) + r0 % BM / 8) * 32 + (lane % 8) * 4) = v0;
        *reinterpret_cast<float4*>(tile + (kc * (BM / 8) + r1 % BM / 8) * 32 + (lane % 8) * 4) = v1;
      }
      // The tile is read by wgmma, through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncwarp();
    if (lane == 0) repro::mbar_arrive(s_full + f);
  }
}

template <int FAMILY, int ROUNDS, int BN>
__global__ void __launch_bounds__(Roles<FAMILY>::THREADS, 1)
dense_partial_kernel(const float* __restrict__ xs, long long x_rows, long long n, int d,
                     const uint32_t* __restrict__ keys, const int* __restrict__ srht_rows, int m, float scale,
                     int rounds, long long rows_per_split, int m_tiles, int clusters, float* __restrict__ partial) {
  using R = Roles<FAMILY>;
  using G = Geometry<FAMILY, BN>;
  constexpr int X_STAGES = R::X_STAGES;
  extern __shared__ __align__(128) float smem[];
  float* x_ring = smem;                             // [X_STAGES][X_FLOATS]: split X tiles
  float* s_ring = x_ring + X_STAGES * G::X_FLOATS;  // [S_STAGES][S_FLOATS]: drawn S tiles
  float4* run = reinterpret_cast<float4*>(s_ring + R::S_STAGES * R::S_FLOATS);  // Gaussian: [N / 8][CONSUMERS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_ring + R::S_STAGES * R::S_FLOATS + G::RUN_FLOATS);
  uint64_t* x_full = bars;                   // the whole X tile has landed (bytes)
  uint64_t* x_empty = bars + X_STAGES;       // every block of the cluster is done with it
  uint64_t* s_full = bars + 2 * X_STAGES;    // the step's S tile is drawn
  uint64_t* s_empty = s_full + R::S_STAGES;  // every consumer warp multiplied it

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
    for (int f = 0; f < R::S_STAGES; ++f) {
      repro::mbar_init(s_full + f, R::GAUSSIAN ? R::PRODUCERS / 32 : 1);
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
    repro::set_max_regs_dec<R::PRODUCER_REGS>();
    if (live) {
      if constexpr (R::GAUSSIAN) {
        draw_gaussian<ROUNDS>(s_ring, s_full, s_empty, k0, k1, m, row0, scale, rounds, j_begin, steps);
      } else {
        draw_signs<FAMILY>(s_ring, s_full, s_empty, k0, k1, srht_rows, w, m, row0, j_begin, steps);
      }
    }
  } else {
    // Consumer warpgroups 0-1: multiply each step's S by its X tiles, warpgroup
    // h the columns h N .. h N + N - 1; warp 0 also copies this block's piece of
    // each X tile to the whole cluster.
    repro::set_max_regs_inc<R::CONSUMER_REGS>();
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

    float acc[G::N / 2];  // the chain (R::CHAIN_STEPS steps), wgmma's accumulator
#pragma unroll
    for (int e = 0; e < G::N / 2; ++e) acc[e] = 0.f;
    RunSums<!R::GAUSSIAN, G::N / 2> sums(run, tid);

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
      const int fs = t % R::S_STAGES;
      if (live) repro::mbar_wait_cta(s_full + fs, (t / R::S_STAGES) & 1);
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
          const uint32_t sa = s_base + (fs * R::S_FLOATS + 2 * ks * 8 * 32) * 4;
          const int g = X_PER_STEP * t + ks / (XK / 8);
          const uint32_t xa = x_base + ((g % X_STAGES) * G::X_FLOATS + 2 * (ks % (XK / 8)) * (BN / 8) * 32) * 4;
          const uint64_t s_hi = repro::smem_desc(sa, 8 * 128, 128);
          const uint64_t x_hi = repro::smem_desc(xa, (BN / 8) * 128, 128);
          const uint64_t x_lo = repro::smem_desc(xa + XK * BN * 4, (BN / 8) * 128, 128);
          repro::wgmma_tf32<G::N>(acc, s_hi, x_lo);
          if constexpr (R::GAUSSIAN) {
            repro::wgmma_tf32<G::N>(acc, repro::smem_desc(sa + BM * BK * 4, 8 * 128, 128), x_hi);  // S lo
          }
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
      if ((t + 1) % R::CHAIN_STEPS == 0 || t + 1 == steps) sums.add(acc);
    }

    if (live) {
      // wgmma's accumulator layout: warp w % 4 of the group holds rows
      // 16 (w % 4) .. + 15; register 4 j + e is row gid (+ 8 for e >= 2), column
      // 8 j + 2 tig + (e & 1) of the group's N.
      const int gid = lane >> 2;
      const int tig = lane & 3;
      float* out = partial + (static_cast<long long>(w) * gridDim.y + split) * static_cast<long long>(m) * d;
      const float out_scale = R::GAUSSIAN ? 1.f : scale;  // the +-1 families' 1/sqrt(m), once
#pragma unroll
      for (int e4 = 0; e4 < G::N / 8; ++e4) {
        const float4 r = sums.get4(e4);
        const float v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 16 * (warp % 4) + gid + ((e & 2) ? 8 : 0);
          const int col = ct * BN + wg * G::N + 8 * e4 + 2 * tig + (e & 1);
          if (row < m && col < d) out[static_cast<long long>(row) * d + col] = R::GAUSSIAN ? v[e] : v[e] * out_scale;
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
  const int* srht_rows;
  int m;
  float scale;
  int rounds;
  long long rows_per_split;
  int m_tiles;
  int clusters;
  float* partial;
};

// A cluster launch of dense_partial_kernel<FAMILY, ROUNDS, BN>: sets the
// kernel's shared memory attribute and fills cfg (whose attrs point at attr).
template <int FAMILY, int ROUNDS, int BN>
cudaError_t configure(dim3 grid, int cluster, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  const int smem = Geometry<FAMILY, BN>::SMEM_BYTES;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Roles<FAMILY>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaFuncSetAttribute(dense_partial_kernel<FAMILY, ROUNDS, BN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int FAMILY, int ROUNDS, int BN>
cudaError_t launch(dim3 grid, int cluster, cudaStream_t stream, const Args& a) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<FAMILY, ROUNDS, BN>(grid, cluster, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, dense_partial_kernel<FAMILY, ROUNDS, BN>, a.xs, a.x_rows, a.n, a.d, a.keys,
                           a.srht_rows, a.m, a.scale, a.rounds, a.rows_per_split, a.m_tiles, a.clusters, a.partial);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<BN>{}) for the column width block_cols.
template <typename F>
cudaError_t by_width(int block_cols, F&& f) {
  if (block_cols == 64) return f(Int<64>{});
  if (block_cols == 128) return f(Int<128>{});
  if (block_cols == 256) return f(Int<256>{});
  return cudaErrorInvalidValue;
}

// f(Int<FAMILY>{}, Int<ROUNDS>{}): the Gaussian at 20 rounds compiled in, or at
// `rounds` read at run time; the +-1 families always draw at 20.
template <typename F>
cudaError_t by_family(int family, int rounds, F&& f) {
  if (family == kGaussian) return rounds == 20 ? f(Int<kGaussian>{}, Int<20>{}) : f(Int<kGaussian>{}, Int<0>{});
  if (family == kRademacher) return f(Int<kRademacher>{}, Int<20>{});
  if (family == kSRHT) return f(Int<kSRHT>{}, Int<20>{});
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The dense sketch->Gram of `family` (0 Gaussian, 1 Rademacher, 2 SRHT). X:
// (n, d) float32, row-major, on the device. keys: (q, 2) uint32 on the device
// (for the SRHT the diagonal's key words). srht_rows: (q, m) int32 sampled
// Hadamard row ids in [0, 2^32) for the SRHT, else unused. scale: 1/sqrt(m).
// rounds: the Gaussian's threefry rounds (the +-1 families always draw at 20).
// The plan (kernels/cuda.py plan_dense_gram): block_cols in {64, 128, 256}; per
// column tile, `clusters` clusters of `cluster` (1 to 8) blocks of 64 sketch rows
// covering m; n_splits splits of rows_per_split rows (a multiple of 32,
// n_splits * rows_per_split >= n). xs: the split form of X, 2 * ceil(d /
// block_cols) * block_cols * x_rows floats, 16-byte aligned, with x_rows >= n a
// multiple of 32; split_x != 0 writes it from X first (the call of a wrapper's
// first chunk of workers), else it is read as it stands. partial: (q, n_splits,
// m, d) float32 scratch. G: (q, d, d). Returns cudaErrorInvalidValue for a plan
// or family it cannot take, else the first CUDA error of the launches (0 when
// all were accepted).
int repro_dense_gram(int family, const float* X, long long n, int d, const uint32_t* keys, const int* srht_rows,
                     int q, int m, float scale, int rounds, long long rows_per_split, int n_splits, int block_cols,
                     int cluster, int clusters, float* xs, long long x_rows, int split_x, float* partial, float* G,
                     void* stream_ptr) {
  const int m_tiles = (m + BM - 1) / BM;
  const int d_tiles = (d + block_cols - 1) / block_cols;
  if (rows_per_split <= 0 || rows_per_split % BK != 0 || static_cast<long long>(n_splits) * rows_per_split < n ||
      x_rows < n || x_rows % BK != 0 || cluster < 1 || cluster > MAX_CLUSTER || clusters < 1 ||
      static_cast<long long>(clusters) * cluster < m_tiles || keys == nullptr || xs == nullptr ||
      partial == nullptr || reinterpret_cast<uintptr_t>(xs) % 16 != 0 ||
      (family == kSRHT && srht_rows == nullptr) ||
      (block_cols != 64 && block_cols != 128 && block_cols != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSuccess;
  if (split_x && !(kAblate & kSkipSplit)) {
    err = by_width(block_cols, [&](auto bn) {
      constexpr int BN = decltype(bn)::value;
      const long long want = (x_rows / XK * (XK / 4) * BN + 255) / 256;
      const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
      split_x_kernel<BN><<<dim3(blocks, d_tiles), 256, 0, stream>>>(X, n, d, x_rows, xs);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(d_tiles * clusters * cluster, n_splits, q);
  const Args a{xs, x_rows, n, d, keys, srht_rows, m, scale, rounds, rows_per_split, m_tiles, clusters, partial};
  err = by_family(family, rounds, [&](auto fam, auto rnd) {
    return by_width(block_cols, [&](auto bn) {
      return launch<decltype(fam)::value, decltype(rnd)::value, decltype(bn)::value>(grid, cluster, stream, a);
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(repro::reduce_and_gram(partial, q, n_splits, m, d, G, stream));
}

// Clusters of `cluster` blocks of the family's sketch pass (the Gaussian at 20
// rounds) at block_cols that can be resident at once
// (cudaOccupancyMaxActiveClusters), into *count.
int repro_dense_gram_clusters(int family, int block_cols, int cluster, int* count) {
  return static_cast<int>(by_family(family, 20, [&](auto fam, auto rnd) {
    return by_width(block_cols, [&](auto bn) {
      constexpr int F = decltype(fam)::value, RO = decltype(rnd)::value, BN = decltype(bn)::value;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      const cudaError_t err = configure<F, RO, BN>(dim3(cluster * 64), cluster, nullptr, cfg, attr);
      if (err != cudaSuccess) return err;
      return cudaOccupancyMaxActiveClusters(count, dense_partial_kernel<F, RO, BN>, &cfg);
    });
  }));
}

}  // extern "C"
