// Dense S.A for the Gaussian and Rademacher sketches, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of the JAX reference package:
//   kernels/gaussian/kernel.py    gaussian_tiles
//   kernels/rademacher/kernel.py  rademacher_tiles
// For q keys (one per worker) and X of shape (n, d), repro_sketch_apply computes
// S_w X (m, d), with S_w[i, j] drawn in-core from the counter stream (rng.cuh):
// counter_normal(key, i, j) / sqrt(m) for the Gaussian, the packed sign of
// (i, j / 32) for the Rademacher. S is written to device memory only when the
// caller asks for it (s_out, below).
//
// What bounds it on this card. Per worker the product is 2*m*n*d flops; in
// fp32-accurate tensor-core form (below) that is 3 TF32 products for the
// Gaussian and 2 for the +-1 signs, at 495 TFLOP/s dense TF32 (wgmma's rate;
// mma.sync's own rate is lower: mma_probe.cu's repro_mma_rate measures it).
// Drawing S costs one threefry (about 77 integer operations at 20 rounds) and a
// Box-Muller per Gaussian entry, 1/32 of a threefry per sign, at 16.7 T integer
// ops/s, if each entry is drawn once. The bytes (X read once, m*d written) are
// small. So at d = 2,000 (the Fig. 4(b) S.A^T) the tensor product bounds it, at
// d = 251 (the FIG3A hybrid) the RNG, and at FIG4A's 1,000 x 50 neither: launch
// and set-up.
//
// Design.
//   Product: mma.sync m16n8k8 TF32 in the 3xTF32 form. Each operand x is split
//   into hi = tf32(x) and lo = tf32(x - hi), and the block accumulates
//   lo*hi + hi*lo + hi*hi in fp32 (the lo*lo term is below fp32's rounding). S
//   is split once, when it is drawn; X when its fragments are loaded. The
//   Rademacher S is +-1, exact in TF32, so it takes s*x_lo + s*x_hi and the
//   1/sqrt(m) scale after the sum. wgmma would need X K-major in shared memory;
//   that transpose is left for later.
//   Block: BM = 64 sketch rows by BN in {64, 128, 256} columns (the plan picks
//   it to fit d), walking its split of the data rows BK = 64 at a time, in two
//   roles. Eight producer warps draw S and gather it; eight consumer warps (each
//   a 16- to 64-row by 32-column warp tile) stage X and multiply. The roles
//   hand steps over through mbarriers in rings (STAGES gathered tiles, SLICES
//   drawn slices), so the RNG's long dependent chains, the gathers and the
//   tensor cores overlap, and setmaxnreg moves registers from the producers to
//   the consumers, whose running sums live in registers. A first version whose
//   every warp drew and then multiplied ran those one after the other (8.3 ms
//   at the Fig. 4(b) S.A^T), and one that stepped in lockstep on a cluster-wide
//   barrier spent much of each step waiting on it.
//   S drawn once per cluster: the column tiles of one m-tile are launched as a
//   thread block cluster of c <= 8 blocks (c tiles per group, groups of at most
//   8; dead tiles past d only draw). Each block's producers draw 1/c of the
//   step's (BM x BK) S tile, split into hi and lo, into its own shared memory
//   and arrive on every block's slice_full barrier; every block's producers
//   then copy the whole tile from the cluster's slices through distributed
//   shared memory and arrive on each owner's slice_empty barrier. With d <= 8
//   tiles, each S entry is drawn once per split.
//   X: the consumer warps stage 8-row blocks of X together with 16-byte
//   cp.async into a ring of X_RING blocks in shared memory, three blocks ahead
//   of their products, one consumer barrier a block. Any d: a row's chunks
//   start at the 16-byte boundary below X[j, col0] (X itself 16-byte aligned),
//   so each row sits at its own offset (j d) mod 4 in the ring, and the copy is
//   cut at the row's end (zero-filled past it and past the split). A first
//   version in which each thread staged its own fragment values with 4-byte
//   copies, no barrier, spent more on the staging than on the products
//   (tools/apply_ablation.py).
//   Two-level sum: the tensor-core fp32 accumulators are chains of one step
//   (BK = 64 data rows), then are added to running sums (FADD, round to
//   nearest), as the Gram pass of sketch_gram.cu does. The tensor cores do not
//   round their accumulation as FFMA does: with chains of 256 rows, as the FFMA
//   pass keeps, the largest entry of S.X at (n, d, m) = (1,000, 2,048, 4,224)
//   was 1.08e-5 of its column's rms off the float64 product, over the 1e-5 the
//   checks hold it to.
//   Splits: the data rows are cut into n_splits splits (grid y) of whole
//   32-row sign words. With one split the blocks write S_w X straight to the
//   output; otherwise each writes its partial and reduce_splits_kernel
//   (gram_pass.cuh) sums them in split order. Grid x orders the clusters of all
//   m-tiles of one split together, so they share X's rows in L2; grid z is the
//   worker.
// Determinism: the plan (kernels/cuda.py plan_apply) is a function of (n, m, d)
// only, nothing is added with atomics and the MMA order is fixed, so slice w
// of a q-key call is bitwise a q = 1 call on key w, and reruns are bitwise.
// Keeping S: for one Gaussian key the caller may pass s_out, an (m, ld_s)
// buffer, and the producers of each m-tile's first cluster group (every S entry
// is drawn there exactly once per split; the splits own disjoint columns) store
// each live entry as drawn, before its TF32 split, at s_out[i * ld_s + j]. The
// right-sketch least-norm path reads it back in its adjoint (adjoint.cu,
// repro_adjoint_kept) instead of drawing S again. The store changes nothing
// in S.X: the kernel with the store (KEEP) is bitwise the kernel without it.
// It adds m * n * 4 bytes of stores (185 MB at the Fig. 4(b) S.A^T: 0.055 ms of
// the card's bandwidth, in a call bound by the tensor cores).
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

constexpr int kGaussian = 0;
constexpr int kRademacher = 1;

constexpr int BM = 64;          // sketch rows per block
constexpr int BK = 64;          // data rows per step: two packed sign words
constexpr int SPLIT_ROWS = 32;  // a split is a whole number of packed sign words
constexpr int CONSUMERS = 256;  // warps 0-7: load X, multiply
constexpr int PRODUCERS = 256;  // warps 8-15: draw S, gather the cluster's tile
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int DRAW_ILP = 2;     // threefry chains a producer thread keeps in flight
constexpr int GATHER_ILP = 8;   // remote 16-byte loads a producer thread keeps in flight
constexpr int STAGES = 3;       // gathered S tiles in flight
constexpr int SLICES = 2;       // drawn slices in flight
constexpr int X_RING = 4;       // 8-row blocks of X in shared memory (3 in flight)
// Registers a thread: the block is launched with 128 (65,536 / 512); the
// producers hand theirs down to 64 and the consumers take them, up to 192
// (their running sums live in registers).
// setmaxnreg.inc waits until the block's own pool has the registers, so the two
// must fit it.
constexpr int LAUNCH_REGS = (65536 / THREADS) / 8 * 8;
constexpr int PRODUCER_REGS = 64;
constexpr int CONSUMER_REGS = 192;
static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= THREADS * LAUNCH_REGS,
              "the consumers would wait forever for registers");
// S tile row: per 8-column block ks and fragment column tig, the four floats
// hi(k), lo(k), hi(k + 4), lo(k + 4) with k = 8 ks + tig, so that one 16-byte
// load gives a thread both parts of two A-fragment entries; 16 floats of pad
// make the row stride 16 mod 32 banks (conflict-free 16-byte loads).
constexpr int SROW = 2 * BK + 16;
constexpr int S_FLOATS = BM * SROW;  // one (BM x BK) S tile, hi and lo
constexpr int MAX_CLUSTER = 8;  // portable cluster size
// Ablation switches, bits of SKETCH_APPLY_ABLATE (the port builds with none):
// tools/apply_ablation.py builds the kernel with some of each role's work left
// out, to time what the rest costs. Results are then wrong.
#ifndef SKETCH_APPLY_ABLATE
#define SKETCH_APPLY_ABLATE 0
#endif
constexpr int kAblate = SKETCH_APPLY_ABLATE;
constexpr int kSkipDraw = 1;    // producers draw no S
constexpr int kSkipGather = 2;  // producers copy no rows into the gathered tile
constexpr int kSkipX = 4;       // consumers stage no X (their B fragments are constants)
constexpr int kSkipMma = 8;     // consumers multiply nothing (X is still staged)

using repro::cluster_arrive;
using repro::cluster_wait;
using repro::cp_async_16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::mbar_arrive;
using repro::mbar_arrive_remote;
using repro::mbar_init;
using repro::mbar_wait;
using repro::mma_tf32;
using repro::set_max_regs_dec;
using repro::set_max_regs_inc;
using repro::split_tf32;

// Named barrier 1 over the producer warps alone, 2 over the consumer warps alone.
__device__ __forceinline__ void producer_sync() { repro::named_sync<1, PRODUCERS>(); }
__device__ __forceinline__ void consumer_sync() { repro::named_sync<2, CONSUMERS>(); }

// Index of S[i, k]'s hi part in a tile (its lo part follows it).
__device__ __forceinline__ int s_index(int i, int k) {
  return i * SROW + (k >> 3) * 16 + (k & 3) * 4 + ((k >> 2) & 1) * 2;
}

// Warp layout of a (BM x BN) block tile over the 8 consumer warps: WM x WN
// warps, each MT m16 tiles by NT = 4 n8 tiles (a 16- to 64-row by 32-column
// warp tile).
template <int BN>
struct Geometry {
  static constexpr int WN = BN / 32;
  static constexpr int WM = 8 / WN;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = 4;
  // X ring rows: BN columns behind up to 3 floats of misalignment (X[j, col0]
  // lies at float (j d) mod 4 of its 16-byte chunk), in BN / 4 + 1 chunks; the
  // stride is 8 mod 32 banks, so a B-fragment load meets at most 2-way conflicts.
  static constexpr int X_CHUNKS = BN / 4 + 1;
  static constexpr int XS = BN + 8;
  // gathered tiles, slices, the X ring, then the barriers
  static constexpr int FLOATS = (STAGES + SLICES) * S_FLOATS + X_RING * 8 * XS;
  static constexpr int SMEM_BYTES = FLOATS * 4 + 2 * (STAGES + SLICES) * 8;
  static_assert(WM * WN * 32 == CONSUMERS && MT * 16 * WM == BM && NT * 8 * WN == BN, "geometry");
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

template <int FAMILY, int ROUNDS, int BN, bool KEEP>
__global__ void __launch_bounds__(THREADS, 1)
sketch_apply_kernel(const float* __restrict__ X, long long n, int d, const uint32_t* __restrict__ keys,
                    int m, float scale, int rounds,
                    long long rows_per_split, int groups, float* __restrict__ dst, int direct,
                    float* __restrict__ s_out, int ld_s, long long j_base) {
  static_assert(!KEEP || FAMILY == kGaussian, "only the Gaussian S is kept");
  using G = Geometry<BN>;
  constexpr bool kTwoParts = FAMILY == kGaussian;  // the Rademacher S has no lo part
  extern __shared__ __align__(16) float smem[];
  float* full = smem;                         // [STAGES][BM][SROW]: whole tiles, gathered
  float* slice = full + STAGES * S_FLOATS;    // [SLICES][BM][SROW]: this block's rows, drawn
  float* x_ring = slice + SLICES * S_FLOATS;  // [X_RING][8][XS]: 8-row blocks of X
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::FLOATS);
  uint64_t* stage_full = bars;                // a gathered tile is ready (producers arrive)
  uint64_t* stage_empty = bars + STAGES;      // a tile was multiplied (consumers arrive)
  uint64_t* slice_full = bars + 2 * STAGES;   // every block of the cluster drew its rows of a step
  uint64_t* slice_empty = slice_full + SLICES;  // every block of the cluster copied this block's rows

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int cluster_id = blockIdx.x / c;
  const int row0 = (cluster_id / groups) * BM;
  const int col0 = ((cluster_id % groups) * c + rank) * BN;  // this block's column tile
  const bool live = col0 < d;  // dead tiles past d only draw their slice
  const bool keeper = KEEP && cluster_id % groups == 0;  // this cluster group stores S
  const int split = blockIdx.y;
  const int w = blockIdx.z;
  const uint32_t k0 = keys[2 * w];
  const uint32_t k1 = keys[2 * w + 1];
  const long long j_begin = static_cast<long long>(split) * rows_per_split;
  const long long j_end = min(n, j_begin + rows_per_split);
  const int steps = static_cast<int>((j_end - j_begin + BK - 1) / BK);
  // This block's slice of every S tile: rows [s_lo, s_hi) of the BM.
  const int slice_rows = (BM + c - 1) / c;
  const int s_lo = min(BM, rank * slice_rows);
  const int s_hi = min(BM, s_lo + slice_rows);

  if (tid == 0) {
    for (int f = 0; f < STAGES; ++f) {
      mbar_init(stage_full + f, PRODUCERS);
      mbar_init(stage_empty + f, CONSUMERS);
    }
    for (int f = 0; f < SLICES; ++f) {
      mbar_init(slice_full + f, c);
      mbar_init(slice_empty + f, c);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();  // every block's barriers are set before any peer arrives on them
  cluster_wait();

  // Barrier phases: the u-th use of a ring entry (u = step / ring size) waits for
  // its full barrier's phase u (parity u & 1) and for its empty barrier's phase
  // u - 1 (parity (u & 1) ^ 1; a fresh barrier passes that at once).
  if (tid >= CONSUMERS) {
    // Producer warps: at iteration t, draw and publish this block's rows of
    // step t, then gather step t - 1's whole tile (its rows were published an
    // iteration earlier) and hand it to the consumers.
    set_max_regs_dec<PRODUCER_REGS>();
    const int ptid = tid - CONSUMERS;
    const int nrounds = ROUNDS > 0 ? ROUNDS : rounds;
    for (int t = 0; t <= steps; ++t) {
      if (t < steps) {
        const int sl = t % SLICES;
        const long long j0 = j_begin + static_cast<long long>(t) * BK;
        // Once every block has copied what this slice buffer held before.
        mbar_wait(slice_empty + sl, ((t / SLICES) & 1) ^ 1);
        float* buf = slice + sl * S_FLOATS;
        if constexpr (kAblate & kSkipDraw) {
        } else if constexpr (FAMILY == kGaussian) {
          const int count = (s_hi - s_lo) * BK;
          for (int base = ptid; base < count; base += PRODUCERS * DRAW_ILP) {
            uint2 bits[DRAW_ILP];
#pragma unroll
            for (int u = 0; u < DRAW_ILP; ++u) {  // independent threefry chains first
              const int e = base + u * PRODUCERS;
              bits[u] = repro::threefry2x32(k0, k1, static_cast<uint32_t>(row0 + s_lo + e / BK),
                                            static_cast<uint32_t>(j_base + j0 + e % BK), nrounds);
            }
#pragma unroll
            for (int u = 0; u < DRAW_ILP; ++u) {
              const int e = base + u * PRODUCERS;
              if (e >= count) break;
              const int i = s_lo + e / BK;
              const int k = e % BK;
              const bool in = row0 + i < m && j0 + k < j_end;
              const float s = in ? repro::normal_from_bits(bits[u]) * scale : 0.f;
              if (keeper && in) {  // m * ld_s < 2^31 (the C entry checks it)
                s_out[(row0 + i) * ld_s + static_cast<int>(j0) + k] = s;
              }
              uint32_t hi, lo;
              split_tf32(s, hi, lo);
              *reinterpret_cast<float2*>(buf + s_index(i, k)) =
                  make_float2(__uint_as_float(hi), __uint_as_float(lo));
            }
          }
        } else {
          for (int e = ptid; e < (s_hi - s_lo) * (BK / 32); e += PRODUCERS) {
            const int i = s_lo + e / (BK / 32);
            const int half = e % (BK / 32);  // which packed word of the step
            const int row = row0 + i;
            const long long jw = j0 + 32 * half;
            const uint32_t word =
                row < m ? repro::packed_sign_word(k0, k1, static_cast<uint32_t>(row),
                                                  static_cast<uint32_t>((j_base + jw) >> 5))
                        : 0u;
            const float one = row < m ? 1.f : 0.f;
#pragma unroll
            for (int k = 0; k < 32; ++k) {
              buf[s_index(i, 32 * half + k)] = (jw + k < j_end) ? (((word >> k) & 1u) ? -one : one) : 0.f;
            }
          }
        }
        producer_sync();
        if (ptid < c) {  // publish the rows to every block of the cluster
          asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
          mbar_arrive_remote(slice_full + sl, ptid);
        }
      }
      if (t >= 1) {  // step u = t - 1: gather its whole tile, hand it over
        const int u = t - 1;
        const int f = u % STAGES;
        const int sl = u % SLICES;
        mbar_wait(slice_full + sl, (u / SLICES) & 1);
        if (live) {
          mbar_wait(stage_empty + f, ((u / STAGES) & 1) ^ 1);
        }
        if (live && !(kAblate & kSkipGather)) {
          const float* s_buf = slice + sl * S_FLOATS;
          float* dst_tile = full + f * S_FLOATS;
          constexpr int V = 2 * BK / 4;  // float4 per row (the pad is not copied)
          constexpr int PER = BM * V / PRODUCERS;
          static_assert(PER % GATHER_ILP == 0, "gather batches");
#pragma unroll
          for (int p0 = 0; p0 < PER; p0 += GATHER_ILP) {
            float4 v[GATHER_ILP];
#pragma unroll
            for (int p = 0; p < GATHER_ILP; ++p) {
              const int e = ptid + (p0 + p) * PRODUCERS;
              const int i = e / V;
              const float* src = s_buf + i * SROW + 4 * (e % V);
              v[p] = *reinterpret_cast<const float4*>(c == 1 ? src : cluster.map_shared_rank(src, i / slice_rows));
            }
#pragma unroll
            for (int p = 0; p < GATHER_ILP; ++p) {
              const int e = ptid + (p0 + p) * PRODUCERS;
              *reinterpret_cast<float4*>(dst_tile + (e / V) * SROW + 4 * (e % V)) = v[p];
            }
          }
        }
        producer_sync();  // every producer has read its part of the peers' rows
        if (ptid < c) mbar_arrive_remote(slice_empty + sl, ptid);
        if (live) mbar_arrive(stage_full + f);
      }
    }
  } else if (live) {
    // Consumer warps 0-7: multiply each gathered tile by X's rows, which they
    // stage together in 8-row blocks with 16-byte cp.async, three blocks ahead.
    set_max_regs_inc<CONSUMER_REGS>();
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gid = lane >> 2;  // fragment group
    const int tig = lane & 3;   // thread in group
    const int wm = warp / G::WN;
    const int wn = warp % G::WN;
    // This thread's B-fragment rows of a block are tig and tig + 4: rows j with
    // j = tig (mod 4), as splits start on whole sign words, so both sit at float
    // (tig d) mod 4 of their first chunk.
    const int x_col = ((tig * (d & 3)) & 3) + wn * 32 + gid;

    // Stage 8-row block g of the split, rows j = j_begin + 8 g + r, into ring
    // entry g % X_RING: each row's 16-byte chunks from the one holding X[j, col0]
    // on, cut at the end of row j (zero past it, and for rows past the split).
    auto stage_x = [&](int g) {
      float* slot = x_ring + (g % X_RING) * 8 * G::XS;
      constexpr int CHUNKS = 8 * G::X_CHUNKS;
#pragma unroll
      for (int e0 = 0; e0 < CHUNKS; e0 += CONSUMERS) {
        const int e = e0 + tid;
        if (CHUNKS % CONSUMERS == 0 || e < CHUNKS) {
          const int r = e / G::X_CHUNKS;
          const int ch = e - r * G::X_CHUNKS;
          const long long j = j_begin + 8LL * g + r;
          const long long start = ((j * d + col0) & ~3LL) + 4 * ch;  // this chunk's first float
          const long long left = j < j_end ? j * d + d - start : 0;  // floats of row j from there
          const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : 4 * static_cast<int>(left));
          if constexpr (!(kAblate & kSkipX)) {
            cp_async_16(slot + r * G::XS + 4 * ch, bytes ? X + start : X, bytes);
          }
        }
      }
      cp_async_commit();
    };

    float acc[G::MT][G::NT][4];  // the chain of one step (BK data rows)
    float run[G::MT][G::NT][4];  // running sums of the chains
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int t = 0; t < G::NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] = run[i][t][e] = 0.f;

#pragma unroll
    for (int g = 0; g < X_RING - 1; ++g) stage_x(g);
    for (int u = 0; u < steps; ++u) {
      const int f = u % STAGES;
      mbar_wait(stage_full + f, (u / STAGES) & 1);
      const float* a_buf = full + f * S_FLOATS;
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        const int g = u * (BK / 8) + ks;
        if constexpr (!(kAblate & kSkipX)) {
          cp_async_wait<X_RING - 2>();  // this thread's copies of block g have landed,
          consumer_sync();              // every thread's have, and block g - 1 is read
        }
        stage_x(g + X_RING - 1);  // into block g - 1's entry
        const float* xb = x_ring + (g % X_RING) * 8 * G::XS + tig * G::XS + x_col;
        uint32_t bh[G::NT][2], bl[G::NT][2];
#pragma unroll
        for (int tn = 0; tn < G::NT; ++tn) {
          split_tf32((kAblate & kSkipX) ? 1.f : xb[8 * tn], bh[tn][0], bl[tn][0]);
          split_tf32((kAblate & kSkipX) ? 1.f : xb[4 * G::XS + 8 * tn], bh[tn][1], bl[tn][1]);
        }
#pragma unroll
        for (int i = 0; i < (kAblate & kSkipMma ? 0 : G::MT); ++i) {
          const int r = wm * (BM / G::WM) + i * 16 + gid;
          const float4 top = *reinterpret_cast<const float4*>(a_buf + r * SROW + ks * 16 + tig * 4);
          const float4 bot = *reinterpret_cast<const float4*>(a_buf + (r + 8) * SROW + ks * 16 + tig * 4);
          const uint32_t ah[4] = {__float_as_uint(top.x), __float_as_uint(bot.x), __float_as_uint(top.z),
                                  __float_as_uint(bot.z)};
          // Pass by pass, so that consecutive products feed different accumulators.
#pragma unroll
          for (int tn = 0; tn < G::NT; ++tn) mma_tf32(acc[i][tn], ah, bl[tn][0], bl[tn][1]);
          if constexpr (kTwoParts) {
            const uint32_t al[4] = {__float_as_uint(top.y), __float_as_uint(bot.y), __float_as_uint(top.w),
                                    __float_as_uint(bot.w)};
#pragma unroll
            for (int tn = 0; tn < G::NT; ++tn) mma_tf32(acc[i][tn], al, bh[tn][0], bh[tn][1]);
          }
#pragma unroll
          for (int tn = 0; tn < G::NT; ++tn) mma_tf32(acc[i][tn], ah, bh[tn][0], bh[tn][1]);
        }
      }
      mbar_arrive(stage_empty + f);  // the tile may be overwritten
#pragma unroll
      for (int i = 0; i < G::MT; ++i)
#pragma unroll
        for (int tn = 0; tn < G::NT; ++tn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            run[i][tn][e] += acc[i][tn][e];
            acc[i][tn][e] = 0.f;
          }
    }

    cp_async_wait<0>();  // the blocks staged past the split

    const long long md = static_cast<long long>(m) * d;
    float* out = dst + (direct ? static_cast<long long>(w) * md
                               : (static_cast<long long>(w) * gridDim.y + split) * md);
    const float post = FAMILY == kRademacher ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int tn = 0; tn < G::NT; ++tn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + wm * (BM / G::WM) + i * 16 + gid + (e >= 2 ? 8 : 0);
          const int col = col0 + wn * 32 + tn * 8 + 2 * tig + (e & 1);
          if (row < m && col < d) out[static_cast<long long>(row) * d + col] = run[i][tn][e] * post;
        }
  } else {
    set_max_regs_inc<CONSUMER_REGS>();
  }
  // No block leaves while a peer may still read its rows or arrive on its barriers.
  cluster_arrive();
  cluster_wait();
}

// The kernel's arguments, as the C entry received them.
struct Args {
  const float* X;
  long long n;
  int d;
  const uint32_t* keys;  // (q, 2) words on the device
  int m;
  float scale;
  int rounds;
  long long rows_per_split;
  int groups;
  float* dst;
  int direct;
  float* s_out;  // the kept S, or null
  int ld_s;
  long long j_base;  // S's column of X's row 0 (the counter of data row j is j_base + j)
};

// A cluster launch of sketch_apply_kernel<FAMILY, ROUNDS, BN>: sets the kernel's
// shared memory attribute and fills cfg (whose attrs point at attr).
template <int FAMILY, int ROUNDS, int BN, bool KEEP>
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
  return cudaFuncSetAttribute(sketch_apply_kernel<FAMILY, ROUNDS, BN, KEEP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int FAMILY, int ROUNDS, int BN, bool KEEP>
cudaError_t launch(dim3 grid, int cluster, cudaStream_t stream, const Args& a) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<FAMILY, ROUNDS, BN, KEEP>(grid, cluster, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, sketch_apply_kernel<FAMILY, ROUNDS, BN, KEEP>, a.X, a.n, a.d, a.keys, a.m,
                           a.scale, a.rounds, a.rows_per_split, a.groups, a.dst, a.direct, a.s_out, a.ld_s,
                           a.j_base);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of `cluster` blocks at width BN that can be resident at once.
template <int BN>
cudaError_t max_clusters(int cluster, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kGaussian, 20, BN, false>(dim3(cluster * 64), cluster, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, sketch_apply_kernel<kGaussian, 20, BN, false>, &cfg);
}

// f(std::integral_constant<int, BN>{}) for the column width block_cols.
template <typename F>
cudaError_t by_width(int block_cols, F&& f) {
  if (block_cols == 64) return f(std::integral_constant<int, 64>{});
  if (block_cols == 128) return f(std::integral_constant<int, 128>{});
  if (block_cols == 256) return f(std::integral_constant<int, 256>{});
  return cudaErrorInvalidValue;
}

template <int FAMILY, int ROUNDS, bool KEEP = false>
cudaError_t launch_width(int block_cols, dim3 grid, int cluster, cudaStream_t stream, const Args& a) {
  return by_width(block_cols, [&](auto bn) {
    return launch<FAMILY, ROUNDS, decltype(bn)::value, KEEP>(grid, cluster, stream, a);
  });
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// S_w X for family 0 (Gaussian) or 1 (Rademacher). X: (n, d) float32, row-major,
// on the device, 16-byte aligned. keys: (q, 2) uint32 on the device. The plan (kernels/cuda.py
// plan_apply): block_cols in {64, 128, 256}, cluster c in 1..8 blocks, groups of
// c column tiles (groups * c >= ceil(d / block_cols)), n_splits splits of
// rows_per_split rows (a multiple of 32, n_splits * rows_per_split >= n). With
// n_splits == 1 the kernel writes out (q, m, d) directly and partial is unused;
// otherwise partial is (q, n_splits, m, d) float32 scratch and a second kernel
// sums it into out. s_out: null, or for the Gaussian family and q = 1 an
// (m, ld_s) float32 buffer, 16-byte aligned, ld_s >= n a multiple of 4 and
// m * ld_s < 2^31, into which the kernel writes S (columns past n untouched).
// row0: the column of S that X's row 0 meets, so the call computes
// S_w[:, row0 : row0 + n] X, a row tile of a taller matrix streamed a tile at a
// time; row0 + n <= 2^32 (the counter), a multiple of 32 for the Rademacher
// (whole packed sign words), 0 with s_out. row0 = 0 is the whole-matrix S.X.
// Returns cudaErrorInvalidValue for a plan or s_out it cannot take, else the
// first CUDA error of the launches (0 when all were accepted).
int repro_sketch_apply(int family, const float* X, long long n, int d, const uint32_t* keys,
                       int q, int m, float scale, int rounds,
                       long long rows_per_split, int n_splits, int block_cols, int cluster, int groups,
                       float* partial, float* out, float* s_out, long long ld_s, long long row0,
                       void* stream_ptr) {
  if (row0 < 0 || row0 + n > (1LL << 32) || (family == kRademacher && row0 % SPLIT_ROWS != 0) ||
      (s_out != nullptr && row0 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s_out != nullptr &&
      (family != kGaussian || q != 1 || ld_s < n || ld_s % 4 != 0 || ld_s >= (1LL << 31) ||
       static_cast<long long>(m) * ld_s >= (1LL << 31) ||
       reinterpret_cast<uintptr_t>(s_out) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((family != kGaussian && family != kRademacher) || rows_per_split <= 0 ||
      rows_per_split % SPLIT_ROWS != 0 || static_cast<long long>(n_splits) * rows_per_split < n ||
      cluster < 1 || cluster > MAX_CLUSTER || groups < 1 ||
      static_cast<long long>(groups) * cluster * block_cols < d || (n_splits > 1 && partial == nullptr) ||
      keys == nullptr || reinterpret_cast<uintptr_t>(X) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int m_tiles = (m + BM - 1) / BM;
  const dim3 grid(m_tiles * groups * cluster, n_splits, q);
  const int direct = n_splits == 1;
  const Args a{X, n, d, keys, m, scale, rounds, rows_per_split, groups,
               direct ? out : partial, direct, s_out, static_cast<int>(ld_s), row0};
  cudaError_t err;
  if (family == kGaussian && s_out != nullptr) {
    err = rounds == 20 ? launch_width<kGaussian, 20, true>(block_cols, grid, cluster, stream, a)
                       : launch_width<kGaussian, 0, true>(block_cols, grid, cluster, stream, a);
  } else if (family == kGaussian) {
    err = rounds == 20 ? launch_width<kGaussian, 20>(block_cols, grid, cluster, stream, a)
                       : launch_width<kGaussian, 0>(block_cols, grid, cluster, stream, a);
  } else {
    err = launch_width<kRademacher, 20>(block_cols, grid, cluster, stream, a);
  }
  if (err != cudaSuccess || direct) return static_cast<int>(err);
  return static_cast<int>(repro::reduce_splits(partial, q, n_splits, m, d, out,
                                               static_cast<long long>(m) * d, stream));
}

// Clusters of `cluster` blocks of the (family 0, rounds 20) kernel at block_cols
// that can be resident at once (cudaOccupancyMaxActiveClusters), into *count.
int repro_sketch_apply_clusters(int block_cols, int cluster, int* count) {
  return static_cast<int>(
      by_width(block_cols, [&](auto bn) { return max_clusters<decltype(bn)::value>(cluster, count); }));
}

}  // extern "C"
