// Fused sketch -> Gram and S.A for the sparse JL (SJLT) sketch, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of the JAX reference package:
//   kernels/sjlt/gram.py    sjlt_gram_tiles, sjlt_gram_tiles_multi
//   kernels/sjlt/kernel.py  sjlt_tiles  (entry repro_sjlt_apply; for few, long
//                           columns or an m past the m-tiles, repro_sjlt_apply_long,
//                           row 12b, at the end of this file)
// The TPU kernels contract a one-hot (m x n) tile on the MXU, m / s times the
// work of the sparse sum. Here the sketch is a sparse scatter: for q keys (one
// per worker) and X = [A | b] of shape (n, d), data row i adds sign(i, t) * X[i]
// into sketch row bucket(i, t) for t < s, with (bucket, sign) = (b0 mod m,
// +-1/sqrt(s) from b1's low bit) of threefry20(key_w, i, t): the contract of
// kernels/common.py sjlt_counter_params, drawn on the card (a (q, n, s)
// parameter tensor would be 16 GB at q = 200, n = 500,000, s = 20).
// repro_sjlt_gram adds the Gram G_w = (S_w X)^T (S_w X); repro_sjlt_apply
// stops at S_w X, which on the same plan is bitwise what the Gram contracts.
//
// What bounds it on this card. Per worker at n = 500,000, d = 251, s = 20:
// X's bytes take 0.150 ms; the 10^7 threefry draws (79 integer operations a
// pair) 0.047 ms at 16.7 T ops/s; the 2.5 G adds 0.075 ms at the fp32 FFMA
// peak. The practical floor is shared memory: each add is a read-modify-write
// of an accumulator row plus a read of the X row, 3 wavefronts per 32 adds,
// 2.4e8 wavefronts a worker, 0.9 ms at one wavefront a cycle on each of 132
// SMs. The design spends what it can on that pass alone.
//
// Design: two passes and the split reduction.
//   1. Bin pass (sjlt_bin_kernel): one warp per chunk of chunk_rows data rows
//      draws each of the chunk's chunk_rows * s (row, t) pairs once per worker
//      and writes them to a list in global memory, binned by (m-tile, owner
//      class) and, inside a bin, in pair order (i, t ascending): a stable
//      counting sort, each lane counting its own run of pairs in its own
//      column of the counts, no warp collective per pair. Each bin is padded
//      to a multiple of 4 entries (pads add into a spare accumulator row of
//      the bin's class). A chunk's region holds the bin offsets (bins + 1
//      words) and then its entries; an entry packs the accumulator row's
//      offset lb * 32 (bits 0-15), the staged X row's offset r * 32 (bits
//      16-30) and the sign (bit 31).
//   2. Scatter pass (sjlt_scatter_kernel): grid (column tile x m-tile,
//      n-split, worker). A block owns an m-tile of bucket_tile sketch rows
//      (the fewest m-tiles that fit: two of 1,250 at FIG3A, adjacent in the
//      grid so the second reads X from L2) by CW = 32 columns: its accumulator
//      lives in shared memory. Four producer warps walk the split's chunks
//      and, STAGES chunks ahead, bring in each chunk's list region with one
//      bulk copy and its X rows with 4-byte cp.async (any d: rows need not be
//      16-byte aligned), on an mbarrier ring. Sixteen consumer warps add: half-
//      warp h of warp w owns the buckets of class 2 w + h (bucket mod 32), each
//      lane two columns, so a half-warp's access is one 128-byte row of the
//      accumulator or of X, one wavefront. It walks its bin of each chunk in
//      order, four entries a step (one 16-byte read): the four rows are read
//      first and an entry whose row an earlier one of the four updates takes
//      that one's sum, so no branch splits the warp. Each consumer warp hands
//      the chunk back on its own; no block-wide barrier runs per chunk.
//   3. The split partials (q, n_splits, m, d) are summed in split order and,
//      for the Gram, contracted (gram_pass.cuh).
// tools/sjlt_ablation.py times the parts; at FIG3A the adds take most of the
// time, the bin pass about a tenth.
// Determinism: the plan (kernels/cuda.py plan_sjlt) is a function of
// (n, m, d, s) only; each bucket's sum within a split is taken by one half-warp
// in pair order, and the splits are summed in split order; workers never share
// a block. So the slice of a q-key call for key w is bitwise equal to a call
// with q = 1 on key w, and reruns are bitwise. No float atomics anywhere.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "gram_pass.cuh"
#include "pipeline.cuh"
#include "rng.cuh"

namespace {

// Switches of tools/sjlt_ablation.py, which builds the kernels with parts of
// the work left out or done another way, to time what the rest costs (results
// are then wrong); the port builds with the defaults. SJLT_ABLATE's bits leave
// out work; SJLT_PRODUCER_WARPS sets the warps that stage X; consumers add each
// chunk SJLT_CONSUMER_REPS times.
#ifndef SJLT_ABLATE
#define SJLT_ABLATE 0
#endif
#ifndef SJLT_PRODUCER_WARPS
#define SJLT_PRODUCER_WARPS 4
#endif
#ifndef SJLT_CONSUMER_REPS
#define SJLT_CONSUMER_REPS 1
#endif
constexpr int kAblate = SJLT_ABLATE;
constexpr int kNoDraw = 1;         // the bin pass hashes the pair index instead of drawing threefry
constexpr int kNoX = 2;            // the producers copy no X rows
constexpr int kNoScatter = 4;      // consumers add nothing (they still wait and hand chunks back)
constexpr int kNoBinPass = 8;      // the bin pass is not launched (the list scratch is left as it is)
constexpr int kNoScatterPass = 16; // the scatter pass is not launched

constexpr int CONSUMER_WARPS = 16;
constexpr int PRODUCER_WARPS = SJLT_PRODUCER_WARPS;  // after the consumers
constexpr int THREADS = 32 * (CONSUMER_WARPS + PRODUCER_WARPS);
constexpr int STAGES = 4;                            // chunks in flight in the ring
constexpr int MAX_ROWS = 64;                         // data rows per chunk
constexpr int MAX_PAIRS = 2048;                      // (row, t) pairs per chunk
constexpr int CW = 32;                               // columns a scatter block: 16 lanes, 2 each
constexpr int CLASSES = 2 * CONSUMER_WARPS;          // owner classes: a half-warp each
constexpr int MAX_BINS = 1024;                       // m-tiles x owner classes
constexpr int SMEM_LIMIT = 232448;                   // shared memory a block may take
constexpr int MAX_ACC_OFFSET = 1 << 16;              // accumulator floats an entry can address
constexpr int BIN_WARPS = 2;                         // chunks per bin-pass block, at most
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(MAX_ROWS * CW <= (1 << 15) && MAX_BINS <= (1 << 16), "entry packing, 16-bit bins");

__host__ __device__ constexpr int align4(int x) { return (x + 3) & ~3; }

// 4-byte asynchronous copy global -> shared (any 4-byte aligned addresses).
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(repro::smem_u32(dst)), "l"(src) : "memory");
}
// Arrive on `bar` once this thread's earlier cp.async copies have landed (the
// arrival is one of the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(repro::smem_u32(bar)) : "memory");
}

// a % d for 32-bit a and d >= 1, from m_magic = ceil(2^64 / d), computed as
// (2^64 - 1) / d + 1 in 64 bits (0 for d = 1): exact for every 32-bit a
// (Lemire, Kaser and Kurz, "Faster remainder by direct computation", 2019).
__device__ __forceinline__ uint32_t fast_mod(uint32_t a, uint64_t m_magic, uint32_t d) {
  return static_cast<uint32_t>(__umul64hi(m_magic * a, d));
}

// Words of one bin-pass warp's shared memory: lane-private counts [bins][32],
// the bins' totals and then starts, entries [per][32] and their bins [per][32]
// (16 bits each; per = the pairs a lane takes), the sorted list.
__host__ __device__ constexpr int bin_warp_words(int bins, int pairs_cap) {
  return 32 * bins + align4(bins) + 48 * ((pairs_cap + 31) / 32) + align4(pairs_cap + 3 * bins);
}

// Inclusive sum over the lanes below and at this one.
__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The bin pass. Grid (ceil(chunks / warps), q), `warps` <= BIN_WARPS warps a
// block (as many as the shared memory holds); warp `warp` of block x bins
// chunk x * warps + warp of worker blockIdx.y into its list region. Lane L
// takes the chunk's pairs [L * per, (L + 1) * per) in order and counts them per
// bin in its own column of the counts, so no warp collective ranks them; scans
// in (bin, lane) order turn the counts into each lane's place in each bin, and
// a bin keeps pair order. Each bin is padded to a multiple of 4 entries with
// entries that add X's row 0 into its class's spare accumulator row
// (spare_row + class).
__global__ void __launch_bounds__(32 * BIN_WARPS)
sjlt_bin_kernel(long long n, const uint32_t* __restrict__ keys, int m, uint64_t m_magic, int s, int chunk_rows,
                int bucket_tile, int m_tiles, int spare_row, int hdr_ints, int region_ints, long long chunks,
                long long row_base, uint32_t* __restrict__ list) {
  extern __shared__ __align__(16) uint32_t bin_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bins = m_tiles * CLASSES;
  const int cap = chunk_rows * s;
  const int per_cap = (cap + 31) / 32;
  uint32_t* cnt = bin_smem + warp * bin_warp_words(bins, cap);  // [bins][32]: counts, then places
  uint32_t* start = cnt + 32 * bins;                            // [bins]: totals, then starts
  uint32_t* ents = start + align4(bins);                        // [per][32]: entries of each lane
  uint16_t* kept = reinterpret_cast<uint16_t*>(ents + 32 * per_cap);  // [per][32]: their bins
  uint32_t* sorted = ents + 48 * per_cap;                       // the chunk's list
  const long long c = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (c >= chunks) return;
  const int w = blockIdx.y;
  const uint32_t k0 = keys[2 * w];
  const uint32_t k1 = keys[2 * w + 1];
  const long long row0 = c * chunk_rows;
  const int pairs = static_cast<int>(min(static_cast<long long>(chunk_rows), n - row0)) * s;
  const int per = (pairs + 31) / 32;
  const int p_lo = min(pairs, lane * per);
  const int mine = min(pairs, p_lo + per) - p_lo;

  for (int b = 0; b < bins; ++b) cnt[b * 32 + lane] = 0u;
  int r = p_lo / s;
  int t = p_lo - r * s;
#pragma unroll 2
  for (int k = 0; k < mine; ++k) {
    const uint32_t row = static_cast<uint32_t>(row_base + row0 + r);  // the pair's global row
    uint32_t b0, b1;
    if constexpr (kAblate & kNoDraw) {
      b0 = row * 2654435761u + static_cast<uint32_t>(t) * 40503u;
      b1 = b0 >> 7;
    } else {
      const uint2 b = repro::threefry2x32(k0, k1, row, static_cast<uint32_t>(t), 20);
      b0 = b.x;
      b1 = b.y;
    }
    const uint32_t bucket = fast_mod(b0, m_magic, static_cast<uint32_t>(m));
    const uint32_t tile = m_tiles > 1 ? bucket / static_cast<uint32_t>(bucket_tile) : 0u;
    const uint32_t lb = bucket - tile * static_cast<uint32_t>(bucket_tile);
    const uint32_t key = tile * CLASSES + (lb & (CLASSES - 1));
    ++cnt[key * 32 + lane];
    ents[k * 32 + lane] = lb * CW | (static_cast<uint32_t>(r) * CW) << 16 | (b1 & 1u) << 31;
    kept[k * 32 + lane] = static_cast<uint16_t>(key);
    if (++t == s) {
      t = 0;
      ++r;
    }
  }
  __syncwarp();
  // Counts -> places in three steps: each bin's lanes scanned on their own (the
  // bins' scans independent of each other), the bins' padded totals scanned
  // into their starts, the starts added.
#pragma unroll 4
  for (int b = 0; b < bins; ++b) {
    const uint32_t v = cnt[b * 32 + lane];
    const uint32_t incl = warp_inclusive_scan(v, lane);
    cnt[b * 32 + lane] = incl - v;
    if (lane == 31) start[b] = incl;
  }
  __syncwarp();
  uint32_t* region = list + (static_cast<long long>(w) * chunks + c) * region_ints;
  uint32_t run = 0u;
  for (int b0 = 0; b0 < bins; b0 += 32) {
    const int b = b0 + lane;
    const uint32_t total = b < bins ? start[b] : 0u;
    const uint32_t padded = (total + 3u) & ~3u;
    const uint32_t incl = warp_inclusive_scan(padded, lane);
    const uint32_t at = run + incl - padded;
    if (b < bins) {
      start[b] = at;
      region[b] = at;
      // pads: the class's spare row, X's row 0, positive
      const uint32_t pad = static_cast<uint32_t>(spare_row + b % CLASSES) * CW;
      for (uint32_t e = total; e < padded; ++e) sorted[at + e] = pad;
    }
    run += __shfl_sync(FULL, incl, 31);
  }
  for (int b = bins + lane; b < hdr_ints; b += 32) region[b] = b == bins ? run : 0u;
  __syncwarp();
#pragma unroll 4
  for (int b = 0; b < bins; ++b) cnt[b * 32 + lane] += start[b];
  for (int k = 0; k < mine; ++k) {
    uint32_t* place = cnt + kept[k * 32 + lane] * 32 + lane;
    const uint32_t at = *place;
    *place = at + 1u;
    sorted[at] = ents[k * 32 + lane];
  }
  __syncwarp();
  const uint4* src = reinterpret_cast<const uint4*>(sorted);
  uint4* dst = reinterpret_cast<uint4*>(region + hdr_ints);
  for (int i = lane; i < static_cast<int>(run / 4); i += 32) dst[i] = src[i];
}

// Add the four entries of v in order: sign * X[row] into each entry's
// accumulator row, in this lane's two columns. The four rows are read first; an
// entry whose row an earlier one of the four also updates takes that one's sum
// instead, and the stores land in order, so each row's sum is the one-by-one
// sum in list order.
__device__ __forceinline__ void add4(float* acc_l, const float* x_l, uint4 v, uint32_t pos) {
  const uint32_t a0 = v.x & 0xFFFFu, a1 = v.y & 0xFFFFu, a2 = v.z & 0xFFFFu, a3 = v.w & 0xFFFFu;
  float2* p0 = reinterpret_cast<float2*>(acc_l + a0);
  float2* p1 = reinterpret_cast<float2*>(acc_l + a1);
  float2* p2 = reinterpret_cast<float2*>(acc_l + a2);
  float2* p3 = reinterpret_cast<float2*>(acc_l + a3);
  const float2 x0 = *reinterpret_cast<const float2*>(x_l + ((v.x >> 16) & 0x7FFFu));
  const float2 x1 = *reinterpret_cast<const float2*>(x_l + ((v.y >> 16) & 0x7FFFu));
  const float2 x2 = *reinterpret_cast<const float2*>(x_l + ((v.z >> 16) & 0x7FFFu));
  const float2 x3 = *reinterpret_cast<const float2*>(x_l + ((v.w >> 16) & 0x7FFFu));
  const float2 c0 = *p0, c1 = *p1, c2 = *p2, c3 = *p3;
  const float s0 = __uint_as_float(pos | (v.x & 0x80000000u)), s1 = __uint_as_float(pos | (v.y & 0x80000000u));
  const float s2 = __uint_as_float(pos | (v.z & 0x80000000u)), s3 = __uint_as_float(pos | (v.w & 0x80000000u));
  const float2 y0 = make_float2(fmaf(s0, x0.x, c0.x), fmaf(s0, x0.y, c0.y));
  const float2 b1 = a1 == a0 ? y0 : c1;
  const float2 y1 = make_float2(fmaf(s1, x1.x, b1.x), fmaf(s1, x1.y, b1.y));
  const float2 b2 = a2 == a1 ? y1 : a2 == a0 ? y0 : c2;
  const float2 y2 = make_float2(fmaf(s2, x2.x, b2.x), fmaf(s2, x2.y, b2.y));
  const float2 b3 = a3 == a2 ? y2 : a3 == a1 ? y1 : a3 == a0 ? y0 : c3;
  const float2 y3 = make_float2(fmaf(s3, x3.x, b3.x), fmaf(s3, x3.y, b3.y));
  *p0 = y0;
  *p1 = y1;
  *p2 = y2;
  *p3 = y3;
}

// The scatter pass. Grid (d_tiles * m_tiles, n_splits, q); x = column tile *
// m_tiles + m-tile, so the blocks of one split run side by side and share its
// list regions and X rows in L2. Shared memory: STAGES ring entries (a list
// region, then chunk_rows staged X rows of CW floats), the barriers, the
// accumulator (spare_row + CLASSES rows of CW floats: the m-tile's, then the
// pads' spare rows).
__global__ void __launch_bounds__(THREADS, 1)
sjlt_scatter_kernel(const float* __restrict__ X, long long n, int d, int m, float inv_sqrt_s,
                    long long rows_per_split, int chunk_rows, int bucket_tile, int m_tiles, int spare_row,
                    int hdr_ints, int region_ints, long long chunks, const uint32_t* __restrict__ list,
                    float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int stage_bytes = region_ints * 4 + chunk_rows * CW * 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * stage_bytes);  // a chunk landed
  uint64_t* empty = full + STAGES;  // every consumer warp is done with a chunk
  float* acc = reinterpret_cast<float*>(empty + STAGES);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x % m_tiles;
  const int col0 = (blockIdx.x / m_tiles) * CW;
  const int m0 = tile * bucket_tile;
  const int nb = min(bucket_tile, m - m0);
  const int split = blockIdx.y;
  const int w = blockIdx.z;
  const long long per_split = rows_per_split / chunk_rows;
  const long long c_begin = split * per_split;
  const int steps = static_cast<int>(min(chunks, c_begin + per_split) - c_begin);

  for (int e = threadIdx.x; e < (spare_row + CLASSES) * CW; e += THREADS) acc[e] = 0.f;
  if (threadIdx.x == 0) {
    for (int f = 0; f < STAGES; ++f) {
      repro::mbar_init(full + f, 32 * PRODUCER_WARPS + 1);  // the bulk copy's arrival, each producer lane's cp.async
      repro::mbar_init(empty + f, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Barrier phases: the u-th use of a ring entry (u = step / STAGES) waits for
  // its full barrier's phase u (parity u & 1) and for its empty barrier's phase
  // u - 1 (parity (u & 1) ^ 1; a fresh barrier passes that at once).
  if (warp >= CONSUMER_WARPS) {
    // Producers: each chunk's list region by one bulk copy, its X rows by
    // cp.async, rows pw, pw + PRODUCER_WARPS, ... by producer warp pw.
    const int pw = warp - CONSUMER_WARPS;
    const uint32_t* src = list + (static_cast<long long>(w) * chunks + c_begin) * region_ints;
    const int col = col0 + lane;
    for (int k = 0; k < steps; ++k) {
      const int f = k % STAGES;
      const uint32_t u = static_cast<uint32_t>(k / STAGES);
      repro::mbar_wait_cta(empty + f, (u & 1u) ^ 1u);
      unsigned char* st = smem + f * stage_bytes;
      if (pw == 0 && lane == 0) {
        repro::mbar_arrive_expect_tx(full + f, static_cast<uint32_t>(region_ints * 4));
        repro::bulk_copy(st, src + static_cast<long long>(k) * region_ints,
                         static_cast<uint32_t>(region_ints * 4), full + f);
      }
      if (!(kAblate & kNoX) && col < d) {
        const long long row0 = (c_begin + k) * chunk_rows;
        const int rows_here = static_cast<int>(min(static_cast<long long>(chunk_rows), n - row0));
        float* xs = reinterpret_cast<float*>(st + region_ints * 4) + lane;
        const float* xg = X + row0 * d + col;
        for (int r = pw; r < rows_here; r += PRODUCER_WARPS) {
          cp_async_4(xs + r * CW, xg + static_cast<long long>(r) * d);
        }
      }
      cp_async_arrive_noinc(full + f);
    }
  } else {
    // Consumers: half-warp h of warp w owns the bin of class 2 w + h; its lane
    // adds columns 2 (lane % 16) and 2 (lane % 16) + 1.
    const int kb = tile * CLASSES + 2 * warp + lane / 16;
    float* acc_l = acc + 2 * (lane % 16);
    const uint32_t pos = __float_as_uint(inv_sqrt_s);
    for (int k = 0; k < steps; ++k) {
      const int f = k % STAGES;
      const uint32_t u = static_cast<uint32_t>(k / STAGES);
      repro::mbar_wait_cta(full + f, u & 1u);
      if (!(kAblate & kNoScatter)) {
        const uint32_t* st = reinterpret_cast<const uint32_t*>(smem + f * stage_bytes);
        const float* x_l = reinterpret_cast<const float*>(st + region_ints) + 2 * (lane % 16);
        const int e0 = static_cast<int>(st[kb]);
        const int quads = (static_cast<int>(st[kb + 1]) - e0) / 4;  // bins are padded to 4 entries
        const uint4* L = reinterpret_cast<const uint4*>(st + hdr_ints + e0);
        const int most = __reduce_max_sync(FULL, quads);
        for (int rep = 0; rep < SJLT_CONSUMER_REPS; ++rep) {
          for (int i = 0; i < most; ++i) {
            if (i < quads) add4(acc_l, x_l, L[i], pos);
          }
        }
      }
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(empty + f);
    }
  }
  __syncthreads();

  float* out = partial + (static_cast<long long>(w) * gridDim.y + split) * static_cast<long long>(m) * d;
  for (int e = threadIdx.x; e < nb * CW; e += THREADS) {
    const int col = col0 + e % CW;
    if (col < d) out[static_cast<long long>(m0 + e / CW) * d + col] = acc[e];
  }
}

// The geometry both passes derive from the caller's plan.
struct Layout {
  int m_tiles, bins, spare_row, hdr_ints, region_ints, smem_bytes, bin_warps, bin_smem_bytes;
  long long chunks;
  uint64_t m_magic;
};

// Returns false for a plan the passes cannot take.
bool layout(long long n, int d, int m, int s, long long rows_per_split, int n_splits, int chunk_rows,
            int bucket_tile, Layout* out) {
  if (n <= 0 || d <= 0 || m <= 0 || s <= 0 || chunk_rows <= 0 || chunk_rows > MAX_ROWS ||
      static_cast<long long>(chunk_rows) * s > MAX_PAIRS || rows_per_split <= 0 ||
      rows_per_split % chunk_rows != 0 || n_splits <= 0 ||
      static_cast<long long>(n_splits) * rows_per_split < n ||
      static_cast<long long>(n_splits - 1) * rows_per_split >= n || n_splits > 65535 || bucket_tile <= 0 ||
      bucket_tile > MAX_ACC_OFFSET) {
    return false;
  }
  Layout L;
  L.m_tiles = (m + bucket_tile - 1) / bucket_tile;
  if (static_cast<long long>(L.m_tiles) * CLASSES > MAX_BINS) return false;
  L.bins = L.m_tiles * CLASSES;
  L.spare_row = (bucket_tile + CLASSES - 1) / CLASSES * CLASSES;
  if ((L.spare_row + CLASSES) * CW > MAX_ACC_OFFSET) return false;
  L.hdr_ints = align4(L.bins + 1);
  L.region_ints = L.hdr_ints + align4(chunk_rows * s + 3 * L.bins);
  L.smem_bytes = STAGES * (L.region_ints * 4 + chunk_rows * CW * 4) + 2 * STAGES * 8 + (L.spare_row + CLASSES) * CW * 4;
  const int warp_bytes = 4 * bin_warp_words(L.bins, chunk_rows * s);
  L.bin_warps = min(BIN_WARPS, SMEM_LIMIT / warp_bytes);
  L.bin_smem_bytes = L.bin_warps * warp_bytes;
  L.chunks = (n + chunk_rows - 1) / chunk_rows;
  L.m_magic = ~0ull / static_cast<uint64_t>(m) + 1u;
  if (L.smem_bytes > SMEM_LIMIT || L.bin_warps < 1) return false;
  *out = L;
  return true;
}

// Lets both kernels take up to SMEM_LIMIT bytes of dynamic shared memory, once
// per device: a runtime call on every launch is host time that a call at
// FIG4A's size, whose kernels take microseconds, cannot hide.
cudaError_t allow_shared_memory() {
  static std::atomic<unsigned long long> done{0};  // bit d: device d is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(sjlt_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(sjlt_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  }
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

cudaError_t launch_bins(long long n, const uint32_t* keys, int q, int m, int s, int chunk_rows, int bucket_tile,
                        const Layout& L, long long row_base, uint32_t* list, cudaStream_t stream) {
  const cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return err;
  const long long blocks = (L.chunks + L.bin_warps - 1) / L.bin_warps;
  sjlt_bin_kernel<<<dim3(static_cast<unsigned>(blocks), q), 32 * L.bin_warps, L.bin_smem_bytes, stream>>>(
      n, keys, m, L.m_magic, s, chunk_rows, bucket_tile, L.m_tiles, L.spare_row, L.hdr_ints, L.region_ints,
      L.chunks, row_base, list);
  return cudaGetLastError();
}

// The bin pass into list and the scatter pass into partial (q, n_splits, m, d),
// X's row j being the sketch's data row row_base + j (its (row, t) pairs drawn
// at that row); returns cudaErrorInvalidValue for a plan it cannot take, else
// the first CUDA error.
cudaError_t sjlt_pass(const float* X, long long n, int d, const uint32_t* keys, int q, int m, int s,
                      float inv_sqrt_s, long long rows_per_split, int n_splits, int chunk_rows, int bucket_tile,
                      uint32_t* list, float* partial, long long row_base, cudaStream_t stream) {
  Layout L;
  if (q <= 0 || q > 65535 || row_base < 0 || row_base + n > (1LL << 32) ||
      !layout(n, d, m, s, rows_per_split, n_splits, chunk_rows, bucket_tile, &L)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (!(kAblate & kNoBinPass)) {
    err = launch_bins(n, keys, q, m, s, chunk_rows, bucket_tile, L, row_base, list, stream);
    if (err != cudaSuccess) return err;
  }
  if (kAblate & kNoScatterPass) return cudaSuccess;
  err = allow_shared_memory();
  if (err != cudaSuccess) return err;
  const int d_tiles = (d + CW - 1) / CW;
  sjlt_scatter_kernel<<<dim3(d_tiles * L.m_tiles, n_splits, q), THREADS, L.smem_bytes, stream>>>(
      X, n, d, m, inv_sqrt_s, rows_per_split, chunk_rows, bucket_tile, L.m_tiles, L.spare_row, L.hdr_ints,
      L.region_ints, L.chunks, list, partial);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Row 12b: S.X for few, long columns (d' of 1 to 8, n up to 2^32) and any
// m < 2^31: sketched gradient compression's CountSketch (s = 1) of one
// gradient vector, D = 2^20 + 2^16 to 2^28 coordinates, m up to a quarter of
// D. The passes above keep an m-tile's accumulator in shared memory (at most
// 32 m-tiles of <= 992 rows: m <= 31,744) and a scatter block is 32 columns
// wide, so one column would use a lane of 32.
//
// Arithmetic: entry (b, c) is the sum of the integers round(t * 2^S_bc) of
// its terms t = +-(1/sqrt s) x (exact in float64), S_bc = 188 - e_bc -
// ceil(log2 L_b), e_bc the largest float32 exponent field of its column-c
// terms and L_b its pair count. |t| < 2^(e_bc - 126), so every term is below
// 2^(62 - ceil(log2 L_b)) and the L_b of them sum below 2^62: no overflow, and
// the sum is exact whatever the order of the adds. It is rounded once to
// float32 and scaled by 2^-S_bc. A non-finite term (exponent 255) makes its
// entry +-inf or NaN, as the float64 sum would: its class is or-ed into the
// entry instead of a value. Accuracy: each term is rounded at 2^-S_bc, so an
// entry is off the exact sum by at most L^2 2^-61 of max |term| (2.7e-8 at
// L = 256); the plain version (kernels/sjlt/ref.py) sums the same terms in
// float64 and rounds once.
//
// What bounds it on this card: per worker at n = 2^28, s = 1, d' = 1, m =
// 0.1 n, the n threefry draws (77 integer operations each) take 1.24 ms at
// 16.7 T ops/s, X's 1.07 GB and the output 0.35 ms at 3.35 TB/s. Its first
// form summed each pair into device-memory tables of counts, exponents and
// 64-bit entries with three random global atomics a pair (63.7 ms there): at
// 2^28 the tables were 430 MB, far past the 50 MB L2, and even inside L2 the
// rate of random global atomics held it at 9.5x the draw. This form sorts the
// pairs by bucket range first (a partition: bucket_tile buckets), so every add
// is a shared-memory atomic on a block's own buckets, and device memory is
// streamed:
//   1. count pass (sjlt_long_count_kernel): one block per chunk of chunk_pairs
//      consecutive (row, t) pairs draws each pair once (the same
//      threefry20(key, row0 + i, t), bucket b0 mod m, sign from b1's low bit),
//      stores bucket | sign << 31 in the pair list in pair order (4 B a pair:
//      the list the CountSketch's adjoint reads back), and counts its pairs
//      by partition in a shared histogram, one row of (chunks, parts) counts;
//   2. two scans (sjlt_long_scan_chunks_kernel, sjlt_long_scan_parts_kernel) turn the
//      counts into each (partition, chunk)'s place: partitions in order, and
//      chunks in order within a partition;
//   3. scatter pass (sjlt_long_scatter_kernel): each block walks its chunk again,
//      reading the pair list and X, a tile of 1,024 pairs at a time. Each warp
//      ranks its keys among its own (__match_any_sync), and the warps' counts
//      summed in warp order place them, so a partition's entries keep pair
//      order and the list is the same on every run. The tile's entries (the
//      bucket within the partition, 16 bits, and the signed values, 4 B a
//      column) are laid out in shared memory in the order of their places and
//      written from there, consecutive threads to consecutive places: stored
//      where each goes, one L2 transaction of 2 or 4 bytes a store, they held
//      the pass at 38.5 of 44.2 ms in a first version of this form;
//   4. accumulate pass (sjlt_long_accumulate_kernel): one block per partition
//      reads its contiguous entries twice: first each bucket's count and
//      largest exponent, then the fixed-point integers, both with integer
//      atomics on the block's shared counts, exponents and 64-bit sums (16 B a
//      bucket at d' = 1), eight entries in flight a thread, and writes its
//      float32 rows. The plan makes at least two waves of 132 SMs' blocks
//      where m allows (partitions of fewer buckets than fit), so no partition
//      is split over blocks: a small m gets small partitions instead.
// Past 128 partitions (and 2^22 pairs; kernels/cuda.py plan_sjlt_long) a
// tile's run for one partition is too short to fill sectors, so the sort takes
// two levels, as an MSD radix sort does: steps 1 to 3 put each pair's full
// bucket and values into the segment of its group of group_parts partitions
// (about sqrt(parts) groups), and a second count, scan and scatter, sub blocks a
// group, each over its share of one group's segment, put the entries into that
// group's partitions; a block then writes to about sqrt(parts) segments at
// either level. At 2^28 and 0.1 n the passes stream about 13 GB (the pair list
// written and read with X, the group list, 8 B a pair, written and read twice,
// the entries, 6 B a pair, written once and read twice: 3.9 ms at 3.35 TB/s)
// and take 11.6 ms on an H100 80GB HBM3 at 700 W (tools/sjlt_long_profile.py):
// the two scatter passes 4.63 and 3.33, the accumulate 1.94, the count passes
// 1.25 and 0.41. The scatter passes hold it, by their shared-memory work a key
// (ranking, staging, writing out): with no entry written to device memory they
// still take 2.69 and 3.09 ms, where the second count pass reads the same keys
// in 0.41. More than LONG_MAX_COLS columns are taken in groups of that many,
// each group scattered and summed on its own. Device memory at d' = 1: the
// pair list 4 B a pair, the entries 6 and, with two levels, the group list 8
// (the first form: 4 B a pair and 16 B a bucket). Determinism: every atomic is an
// integer add, max or or on exact integers, so each output is bitwise the same
// run to run, whatever the plan, and a q-key call's slice w is bitwise the call
// on key w alone. The key words are launch arguments read from the host, so
// the call copies nothing to the card before it launches.
// Switch of tools/sjlt_long_profile.py --ablate, which builds the scatter pass
// with its device-memory writes left out, to time what the rest costs (the
// results are then wrong); the port builds with 0.
#ifndef SJLT_LONG_ABLATE
#define SJLT_LONG_ABLATE 0
#endif
constexpr int kLongAblate = SJLT_LONG_ABLATE;
constexpr int kLongNoWrites = 4;    // no entry is written to device memory
constexpr int LONG_THREADS = 256;                           // count, scatter and scan blocks
constexpr int LONG_WARPS = LONG_THREADS / 32;
constexpr int LONG_LANE_PAIRS = 4;                          // keys a lane counts or ranks a step
constexpr int LONG_LIST_LANES = 8;                          // keys a lane ranks over the group list
constexpr int LONG_CHUNK_ALIGN = 1024;                      // chunk_pairs is a multiple of it
// Keys a lane ranks in a scatter tile: the pass over the pairs and X, and the
// pass over the group list (its larger tiles cost more registers but leave
// longer runs to write). kernels/cuda.py SJLT_LONG_TILE and
// SJLT_LONG_LIST_TILE are LONG_THREADS times these.
__host__ __device__ constexpr int scatter_lanes(bool from_x) { return from_x ? LONG_LANE_PAIRS : LONG_LIST_LANES; }
constexpr int LONG_SCAN_THREADS = 1024;
constexpr int LONG_ACC_THREADS = 512;
constexpr int LONG_ACC_UNROLL = 8;                          // entries a thread loads before it adds them
constexpr int LONG_ACC_SMEM = 115712;                       // an accumulate block's bytes: two fit an SM
constexpr int LONG_MAX_BINS = 2048;                         // partitions (or groups) of one count or scatter pass
constexpr int LONG_MAX_COLS = 8;                            // columns of one group
constexpr uint32_t NONFINITE = 255u;  // the biased exponent of inf and NaN
constexpr uint32_t NO_PART = 0xFFFFFFFFu;
constexpr uint32_t NO_SHIFT = 0x80000000u;  // a (bucket, column) with a non-finite term
constexpr unsigned long long POS_INF = 1ull, NEG_INF = 2ull, NOT_A_NUMBER = 4ull;

__device__ __forceinline__ uint32_t biased_exponent(float x) { return (__float_as_uint(x) >> 23) & 0xFFu; }

__device__ __forceinline__ int ceil_log2(uint32_t v) { return v <= 1u ? 0 : 32 - __clz(v - 1u); }

// The power of two that scales the terms of entry (bucket, column) to integers.
__device__ __forceinline__ int fixed_shift(uint32_t e_max, uint32_t count) {
  return 188 - static_cast<int>(e_max) - ceil_log2(count);
}

// 2^k for integer k in [-1022, 1023], exactly: its exponent bits. A term times
// 2^fixed_shift (-97 to 188) is exact (a float32 term's double stays normal),
// so it is the scalbn of the term without scalbn's cases.
__device__ __forceinline__ double pow2(int k) { return __longlong_as_double(static_cast<long long>(k + 1023) << 52); }

// a / d for 32-bit a, from the magic of fast_mod (d = 1: a itself).
__device__ __forceinline__ uint32_t fast_div(uint32_t a, uint64_t magic, uint32_t d) {
  return d == 1u ? a : static_cast<uint32_t>(__umul64hi(magic, static_cast<uint64_t>(a)));
}

// Output entry from its count, its power of two (NO_SHIFT: a non-finite term)
// and its fixed-point sum.
__device__ __forceinline__ float shifted_entry(uint32_t count, uint32_t shift, unsigned long long a) {
  if (count == 0u) return 0.f;
  if (shift == NO_SHIFT) {
    const bool is_nan = (a & NOT_A_NUMBER) || (a & (POS_INF | NEG_INF)) == (POS_INF | NEG_INF);
    return __int_as_float(is_nan ? 0x7FC00000 : (a & POS_INF) ? 0x7F800000 : static_cast<int>(0xFF800000u));
  }
  // one rounding of the exact sum to float32 (a second only below float32's normal range)
  return scalbnf(__ll2float_rn(static_cast<long long>(a)), -static_cast<int>(shift));
}

// The keys block (x, y) of a count or scatter pass takes: with gbase null,
// chunk x of chunk_pairs keys; else share x of gridDim.x of group y's
// segment [gbase[y], gbase[y + 1]) of a group list.
__device__ __forceinline__ void block_keys(long long n_keys, long long chunk_pairs, const uint32_t* gbase,
                                           long long* begin, long long* end) {
  if (gbase == nullptr) {
    *begin = blockIdx.x * chunk_pairs;
    *end = min(n_keys, *begin + chunk_pairs);
  } else {
    const long long s0 = gbase[blockIdx.y];
    const long long len = static_cast<long long>(gbase[blockIdx.y + 1]) - s0;
    *begin = s0 + len * blockIdx.x / gridDim.x;
    *end = s0 + len * (blockIdx.x + 1) / gridDim.x;
  }
}

// Count pass: with DRAW, draws pair i of the chunk and stores its word in
// keys; else reads keys[i] (a pair word or a group list's bucket). Counts the
// keys of each of the block's partitions, (bucket / tile) - first with first
// = 0 or, by group, y * width, into the block's row of hist (rows, width), row
// y * gridDim.x + x.
template <bool DRAW>
__global__ void __launch_bounds__(LONG_THREADS)
sjlt_long_count_kernel(long long n_keys, int s, uint32_t k0, uint32_t k1, long long row0, int m, uint64_t m_magic,
                       uint32_t* __restrict__ keys, uint32_t tile, uint64_t t_magic, int width, long long chunk_pairs,
                       const uint32_t* __restrict__ gbase, uint32_t* __restrict__ hist) {
  extern __shared__ __align__(16) unsigned char long_smem[];
  uint32_t* cnt = reinterpret_cast<uint32_t*>(long_smem);
  for (int p = threadIdx.x; p < width; p += LONG_THREADS) cnt[p] = 0u;
  __syncthreads();
  long long begin, end;
  block_keys(n_keys, chunk_pairs, gbase, &begin, &end);
  const int first = gbase == nullptr ? 0 : blockIdx.y * width;  // the block's first partition
  if (DRAW) {
    for (long long i = begin + threadIdx.x; i < end; i += LONG_THREADS) {
      const uint32_t iu = static_cast<uint32_t>(i);  // n_keys < 2^32
      const uint32_t row = s == 1 ? iu : iu / static_cast<uint32_t>(s);
      const uint2 r = repro::threefry2x32(k0, k1, static_cast<uint32_t>(row0 + row), iu - row * s, 20);
      const uint32_t word = fast_mod(r.x, m_magic, static_cast<uint32_t>(m)) | (r.y & 1u) << 31;
      keys[i] = word;
      atomicAdd(cnt + (fast_div(word & 0x7FFFFFFFu, t_magic, tile) - first), 1u);
    }
  } else {
    for (long long i0 = begin + threadIdx.x; i0 < end; i0 += LONG_THREADS * LONG_LANE_PAIRS) {
      uint32_t word[LONG_LANE_PAIRS];
#pragma unroll
      for (int k = 0; k < LONG_LANE_PAIRS; ++k) {
        const long long i = i0 + k * LONG_THREADS;
        word[k] = i < end ? keys[i] : 0u;
      }
#pragma unroll
      for (int k = 0; k < LONG_LANE_PAIRS; ++k) {
        if (i0 + k * LONG_THREADS < end) atomicAdd(cnt + (fast_div(word[k] & 0x7FFFFFFFu, t_magic, tile) - first), 1u);
      }
    }
  }
  __syncthreads();
  uint32_t* out = hist + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * width;
  for (int p = threadIdx.x; p < width; p += LONG_THREADS) out[p] = cnt[p];
}

// hist (groups * rows, width): each partition's counts over its group's rows
// become exclusive places in row order, in place, and totals[p] its count,
// partition p = y * width + column for y < groups, p < limit. A block takes 32
// columns (a lane each; coalesced rows) of group blockIdx.y, its warps
// consecutive ranges of rows.
__global__ void __launch_bounds__(LONG_THREADS)
sjlt_long_scan_chunks_kernel(int rows, int width, int limit, uint32_t* __restrict__ hist,
                             uint32_t* __restrict__ totals) {
  __shared__ uint32_t warp_sum[LONG_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const long long p = static_cast<long long>(blockIdx.y) * width + col;
  const bool mine = col < width && p < limit;
  uint32_t* h = hist + static_cast<long long>(blockIdx.y) * rows * width + col;
  const int per = (rows + LONG_WARPS - 1) / LONG_WARPS;
  const int r0 = min(rows, warp * per);
  const int r1 = min(rows, r0 + per);
  uint32_t sum = 0u;
  if (mine) {
    for (int r = r0; r < r1; ++r) sum += h[static_cast<long long>(r) * width];
  }
  warp_sum[warp][lane] = sum;
  __syncthreads();
  uint32_t run = 0u;
  for (int w = 0; w < warp; ++w) run += warp_sum[w][lane];
  if (!mine) return;
  for (int r = r0; r < r1; ++r) {
    const uint32_t v = h[static_cast<long long>(r) * width];
    h[static_cast<long long>(r) * width] = run;
    run += v;
  }
  if (warp == LONG_WARPS - 1) totals[p] = run;
}

// base[p] = the entries of the partitions before p (base[parts]: all of them).
__global__ void __launch_bounds__(LONG_SCAN_THREADS)
sjlt_long_scan_parts_kernel(int parts, const uint32_t* __restrict__ totals, uint32_t* __restrict__ base) {
  __shared__ uint32_t warp_sum[32];
  __shared__ uint32_t tile_sum;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t carry = 0u;
  for (int p0 = 0; p0 < parts; p0 += LONG_SCAN_THREADS) {
    const int p = p0 + threadIdx.x;
    const uint32_t v = p < parts ? totals[p] : 0u;
    const uint32_t inc = warp_inclusive_scan(v, lane);
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const uint32_t w = warp_sum[lane];
      const uint32_t w_inc = warp_inclusive_scan(w, lane);
      warp_sum[lane] = w_inc - w;
      if (lane == 31) tile_sum = w_inc;
    }
    __syncthreads();
    if (p < parts) base[p] = carry + warp_sum[warp] + inc - v;
    carry += tile_sum;
    __syncthreads();
  }
  if (threadIdx.x == 0) base[parts] = carry;
}

// Scatter pass, block as in the count pass: each key into its partition's
// segment, with its cols values: from X (FROM_X: keys are pair words, the sign
// their bit 31, X's columns c0 .. c0 + cols of the pair's row) or from vals (a
// group list's signed values, cols a key). WIDE writes the key's full bucket
// into wide (the group list); else its bucket within its partition into local
// (16 bits). A tile of LONG_THREADS LANES keys at a time (the next tile's keys
// loaded while this one is placed): warp w holds keys w * 32 LANES onwards and
// ranks them among its own, 32 at a time (__match_any_sync, a running count a
// partition in its row of cnt); the rows, summed in warp order, place each key
// in pair order. The tile's entries are then laid out in shared memory in the
// order of their places and written from there, consecutive threads to
// consecutive places, so a partition's run of the tile goes out in whole
// sectors.
template <bool FROM_X, bool WIDE>
__global__ void __launch_bounds__(LONG_THREADS)
sjlt_long_scatter_kernel(const float* __restrict__ X, const float* __restrict__ vals, long long n_keys, int d,
                         int s, int c0, int cols, const uint32_t* __restrict__ keys, uint32_t tile, uint64_t t_magic,
                         int width, int limit, long long chunk_pairs, const uint32_t* __restrict__ gbase,
                         const uint32_t* __restrict__ hist, const uint32_t* __restrict__ base,
                         uint32_t* __restrict__ wide, uint16_t* __restrict__ local, float* __restrict__ out_vals) {
  constexpr int LANES = scatter_lanes(FROM_X);
  constexpr int TILE = LONG_THREADS * LANES;
  extern __shared__ __align__(16) unsigned char long_smem[];
  __shared__ uint32_t warp_sum[LONG_WARPS + 1];
  uint32_t* run = reinterpret_cast<uint32_t*>(long_smem);  // [width]: each partition's next place
  uint32_t* pre = run + width;                              // [width]: its first slot in the stage
  uint32_t* cnt = pre + width;                              // [LONG_WARPS][width]: counts, then offsets
  uint32_t* stage_pos = cnt + LONG_WARPS * width;           // [TILE]: the staged entries' places
  uint32_t* stage_key = stage_pos + TILE;              // [TILE]: their buckets
  float* stage_val = reinterpret_cast<float*>(stage_key + TILE);  // [TILE][cols]: their values
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int first = gbase == nullptr ? 0 : blockIdx.y * width;  // the block's first partition
  const int parts = min(width, limit - first);
  const uint32_t* place = hist + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * width;
  for (int p = threadIdx.x; p < parts; p += LONG_THREADS) run[p] = base[first + p] + place[p];
  for (int k = threadIdx.x; k < LONG_WARPS * width; k += LONG_THREADS) cnt[k] = 0u;
  const int per = (parts + LONG_THREADS - 1) / LONG_THREADS;  // partitions a thread sums
  const int p_lo = min(parts, static_cast<int>(threadIdx.x) * per);
  const int p_hi = min(parts, p_lo + per);
  uint32_t* row = cnt + warp * width;
  long long begin, end;
  block_keys(n_keys, chunk_pairs, gbase, &begin, &end);
  // lane L of warp w takes the tile's keys w * 32 LANES + k * 32 + L, k < LANES
  auto load = [&](long long t0, uint32_t* word, float* v0) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) {
      const long long i = t0 + warp * (32 * LANES) + 32 * k + lane;
      word[k] = 0u;
      v0[k] = 0.f;
      if (i < end) {
        word[k] = keys[i];
        if (FROM_X) {
          const uint32_t iu = static_cast<uint32_t>(i);
          const float x = X[static_cast<long long>(s == 1 ? iu : iu / static_cast<uint32_t>(s)) * d + c0];
          v0[k] = word[k] >> 31 ? -x : x;
        } else {
          v0[k] = vals[i * cols];
        }
      }
    }
  };
  uint32_t next_word[LANES];
  float next_v0[LANES];
  load(begin, next_word, next_v0);
  for (long long t0 = begin; t0 < end; t0 += TILE) {
    uint32_t word[LANES], part[LANES], rank[LANES];
    float v0[LANES];
#pragma unroll
    for (int k = 0; k < LANES; ++k) {
      word[k] = next_word[k];
      v0[k] = next_v0[k];
    }
    if (t0 + TILE < end) load(t0 + TILE, next_word, next_v0);
    const long long lead = t0 + warp * (32 * LANES) + lane;
    __syncthreads();  // the last tile's stage is written out and cnt cleared
#pragma unroll
    for (int k = 0; k < LANES; ++k) {
      part[k] = lead + 32 * k < end ? fast_div(word[k] & 0x7FFFFFFFu, t_magic, tile) - first : NO_PART;
      const unsigned peers = __match_any_sync(FULL, part[k]);
      const int leader = __ffs(peers) - 1;
      uint32_t old = 0u;
      if (part[k] != NO_PART && lane == leader) {
        old = row[part[k]];
        row[part[k]] = old + __popc(peers);
      }
      rank[k] = __shfl_sync(FULL, old, leader) + __popc(peers & below);
      __syncwarp();
    }
    __syncthreads();
    // each partition's warp counts to offsets in warp order; its tile count to pre,
    // then pre to exclusive sums over the partitions
    uint32_t mine = 0u;
    for (int p = p_lo; p < p_hi; ++p) {
      uint32_t acc = 0u;
      for (int w = 0; w < LONG_WARPS; ++w) {
        const uint32_t c = cnt[w * width + p];
        cnt[w * width + p] = acc;
        acc += c;
      }
      pre[p] = acc;
      mine += acc;
    }
    const uint32_t inc = warp_inclusive_scan(mine, lane);
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const uint32_t w = lane < LONG_WARPS ? warp_sum[lane] : 0u;
      const uint32_t w_inc = warp_inclusive_scan(w, lane);
      if (lane < LONG_WARPS) warp_sum[lane] = w_inc - w;
      if (lane == LONG_WARPS - 1) warp_sum[LONG_WARPS] = w_inc;
    }
    __syncthreads();
    uint32_t at = warp_sum[warp] + inc - mine;
    for (int p = p_lo; p < p_hi; ++p) {
      const uint32_t c = pre[p];
      pre[p] = at;
      at += c;
    }
    __syncthreads();
    const int staged = static_cast<int>(warp_sum[LONG_WARPS]);
#pragma unroll
    for (int k = 0; k < LANES; ++k) {
      if (part[k] == NO_PART) continue;
      const uint32_t off = row[part[k]] + rank[k];  // the key's place within its partition's run of the tile
      const int j = static_cast<int>(pre[part[k]] + off);
      const uint32_t bucket = word[k] & 0x7FFFFFFFu;
      stage_pos[j] = run[part[k]] + off;
      stage_key[j] = WIDE ? bucket : bucket - (static_cast<uint32_t>(first) + part[k]) * tile;
      float* v = stage_val + j * cols;
      v[0] = v0[k];
      const long long i = lead + 32 * k;
      for (int c = 1; c < cols; ++c) {
        if (FROM_X) {
          const uint32_t iu = static_cast<uint32_t>(i);
          const float x = X[static_cast<long long>(s == 1 ? iu : iu / static_cast<uint32_t>(s)) * d + c0 + c];
          v[c] = word[k] >> 31 ? -x : x;
        } else {
          v[c] = vals[i * cols + c];
        }
      }
    }
    __syncthreads();
    for (int p = p_lo; p < p_hi; ++p) run[p] += (p + 1 < parts ? pre[p + 1] : staged) - pre[p];
    for (int k = threadIdx.x; k < LONG_WARPS * width; k += LONG_THREADS) cnt[k] = 0u;
    if (kLongAblate & kLongNoWrites) continue;
    for (int j = threadIdx.x; j < staged; j += LONG_THREADS) {
      if (WIDE) {
        wide[stage_pos[j]] = stage_key[j];
      } else {
        local[stage_pos[j]] = static_cast<uint16_t>(stage_key[j]);
      }
    }
    for (int f = threadIdx.x; f < staged * cols; f += LONG_THREADS) {
      const int j = f / cols;
      out_vals[static_cast<long long>(stage_pos[j]) * cols + (f - j * cols)] = stage_val[f];
    }
  }
}

// Block lp sums partition lp's entries: first each bucket's count and each
// (bucket, column)'s largest exponent, then the fixed-point integers, all with
// integer atomics in shared memory (the 64-bit sums [bucket][col], the largest
// exponents [bucket][col], the counts [bucket]), and writes the partition's
// float32 rows of out. Each thread loads LONG_ACC_UNROLL entries (their
// buckets, and values when cols = 1) before it adds any of them.
__global__ void __launch_bounds__(LONG_ACC_THREADS, 2)
sjlt_long_accumulate_kernel(int m, int d, int c0, int cols, float inv_sqrt_s, int bucket_tile,
                            const uint32_t* __restrict__ base, const uint16_t* __restrict__ ebucket,
                            const float* __restrict__ evals, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char long_smem[];
  constexpr int U = LONG_ACC_UNROLL;
  const int lp = blockIdx.x;
  const long long b0 = static_cast<long long>(lp) * bucket_tile;
  const int nb = static_cast<int>(min(static_cast<long long>(bucket_tile), m - b0));
  const int ne = nb * cols;
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(long_smem);
  uint32_t* exps = reinterpret_cast<uint32_t*>(acc + bucket_tile * cols);
  uint32_t* counts = exps + bucket_tile * cols;
  const long long e0 = base[lp];
  const long long e1 = base[lp + 1];
  for (int b = threadIdx.x; b < nb; b += LONG_ACC_THREADS) counts[b] = 0u;
  for (int k = threadIdx.x; k < ne; k += LONG_ACC_THREADS) exps[k] = 0u;
  __syncthreads();
  for (long long e = e0 + threadIdx.x; e < e1; e += LONG_ACC_THREADS * U) {
    int lb[U];
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long f = e + u * LONG_ACC_THREADS;
      lb[u] = f < e1 ? ebucket[f] : -1;
      x[u] = f < e1 && cols == 1 ? evals[f] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (lb[u] < 0) continue;
      atomicAdd(counts + lb[u], 1u);
      for (int c = 0; c < cols; ++c) {
        const uint32_t ex = biased_exponent(cols == 1 ? x[u] : evals[(e + u * LONG_ACC_THREADS) * cols + c]);
        atomicMax(exps + lb[u] * cols + c, ex);
      }
    }
  }
  __syncthreads();
  // each (bucket, column)'s largest exponent becomes its power of two (or NO_SHIFT)
  for (int k = threadIdx.x; k < ne; k += LONG_ACC_THREADS) {
    acc[k] = 0ull;
    exps[k] = exps[k] == NONFINITE ? NO_SHIFT : static_cast<uint32_t>(fixed_shift(exps[k], counts[k / cols]));
  }
  __syncthreads();
  for (long long e = e0 + threadIdx.x; e < e1; e += LONG_ACC_THREADS * U) {
    int lb[U];
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long f = e + u * LONG_ACC_THREADS;
      lb[u] = f < e1 ? ebucket[f] : -1;
      x[u] = f < e1 && cols == 1 ? evals[f] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (lb[u] < 0) continue;
      for (int c = 0; c < cols; ++c) {
        const int k = lb[u] * cols + c;
        const uint32_t shift = exps[k];
        const float v = cols == 1 ? x[u] : evals[(e + u * LONG_ACC_THREADS) * cols + c];
        if (shift == NO_SHIFT) {
          if (biased_exponent(v) == NONFINITE) atomicOr(acc + k, v != v ? NOT_A_NUMBER : v > 0.f ? POS_INF : NEG_INF);
          continue;
        }
        const long long f = __double2ll_rn(static_cast<double>(inv_sqrt_s) * v * pow2(static_cast<int>(shift)));
        if (f != 0) atomicAdd(acc + k, static_cast<unsigned long long>(f));
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ne; k += LONG_ACC_THREADS) {
    const int lb = k / cols;
    out[(b0 + lb) * d + c0 + (k - lb * cols)] = shifted_entry(counts[lb], exps[k], acc[k]);
  }
}

// The caller's plan (kernels/cuda.py plan_sjlt_long) and the scratch pieces it
// implies, each 16-byte aligned: with two levels, the first level's hist
// (chunks, groups), totals (groups) and base (groups + 1) uint32 and the group
// list's buckets (n s) uint32 and values (n s, cols) float32; then the
// partitions' hist (chunks, parts) or, with two levels, (groups sub,
// group_parts), their totals (parts) and base (parts + 1) uint32, the entries'
// buckets (n s) uint16 and values (n s, cols) float32. kernels/cuda.py
// LongPlan.scratch_bytes mirrors this layout to plan memory on the host; the
// wrappers size their scratch with repro_sjlt_long_scratch_bytes.
struct LongPlan {
  long long n_pairs, chunks, scratch_bytes;
  int parts, groups;  // groups: 0 for one level
  uint64_t m_magic, b_magic, g_magic;
  uint32_t *hist1, *totals1, *base1, *list1;
  float* vals1;
  uint32_t *hist, *totals, *base;
  uint16_t* ebucket;
  float* evals;
};

long long align16(long long bytes) { return (bytes + 15) & ~15LL; }

// Returns false for arguments or a plan the passes cannot take; lays the pieces
// out from scratch (nullptr: only their bytes).
bool long_plan(long long n, int d, int m, int s, long long row0, int bucket_tile, int group_parts, int sub,
               long long chunk_pairs, int cols, char* scratch, LongPlan* L) {
  if (n <= 0 || d <= 0 || m <= 0 || s <= 0 || row0 < 0 || row0 + n > (1LL << 32)) return false;
  L->n_pairs = n * s;
  if (L->n_pairs >= (1LL << 32) || cols < 1 || cols > LONG_MAX_COLS || cols > d || bucket_tile < 1 ||
      bucket_tile > 65536 || bucket_tile > m || static_cast<long long>(bucket_tile) * (4 + 12 * cols) > LONG_ACC_SMEM ||
      chunk_pairs < LONG_CHUNK_ALIGN || chunk_pairs % LONG_CHUNK_ALIGN != 0 || group_parts < 0) {
    return false;
  }
  L->parts = static_cast<int>((static_cast<long long>(m) + bucket_tile - 1) / bucket_tile);  // m up to 2^31 - 1
  L->groups = group_parts > 0 ? (L->parts + group_parts - 1) / group_parts : 0;
  if (L->groups > 0 ? (group_parts > LONG_MAX_BINS || L->groups > LONG_MAX_BINS || L->groups > 65535 || sub < 1 ||
                       static_cast<long long>(L->groups) * sub > 0x7FFFFFFF)
                    : (L->parts > LONG_MAX_BINS || sub != 0)) {
    return false;
  }
  L->chunks = (L->n_pairs + chunk_pairs - 1) / chunk_pairs;
  if (L->chunks > 0x7FFFFFFF) return false;
  L->m_magic = ~0ull / static_cast<uint64_t>(m) + 1u;
  L->b_magic = ~0ull / static_cast<uint64_t>(bucket_tile) + 1u;
  L->g_magic = ~0ull / (static_cast<uint64_t>(bucket_tile) * (group_parts > 0 ? group_parts : 1)) + 1u;
  const long long two = L->groups > 0;
  long long at = 0;
  auto piece = [&](long long bytes) {
    char* p = scratch == nullptr ? nullptr : scratch + at;
    at += align16(bytes);
    return p;
  };
  L->hist1 = reinterpret_cast<uint32_t*>(piece(4 * L->chunks * L->groups));
  L->totals1 = reinterpret_cast<uint32_t*>(piece(4LL * L->groups));
  L->base1 = reinterpret_cast<uint32_t*>(piece(4LL * (L->groups + 1) * two));
  L->list1 = reinterpret_cast<uint32_t*>(piece(4 * L->n_pairs * two));
  L->vals1 = reinterpret_cast<float*>(piece(4 * L->n_pairs * cols * two));
  L->hist = reinterpret_cast<uint32_t*>(
      piece(4 * (two ? static_cast<long long>(L->groups) * sub * group_parts : L->chunks * L->parts)));
  L->totals = reinterpret_cast<uint32_t*>(piece(4LL * L->parts));
  L->base = reinterpret_cast<uint32_t*>(piece(4LL * (L->parts + 1)));
  L->ebucket = reinterpret_cast<uint16_t*>(piece(2 * L->n_pairs));
  L->evals = reinterpret_cast<float*>(piece(4 * L->n_pairs * cols));
  L->scratch_bytes = at;
  return true;
}

int scatter_smem(int width, int cols, bool from_x) {
  return 4 * ((2 + LONG_WARPS) * width + (2 + cols) * LONG_THREADS * scatter_lanes(from_x));
}

// Lets the row 12b kernels take their dynamic shared memory (over 48 KB), and
// the accumulate kernel all of an SM's, once per device.
cudaError_t allow_long_shared_memory() {
  static std::atomic<unsigned long long> done{0};  // bit d: device d is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const void* scatters[] = {reinterpret_cast<const void*>(sjlt_long_scatter_kernel<true, true>),
                            reinterpret_cast<const void*>(sjlt_long_scatter_kernel<true, false>),
                            reinterpret_cast<const void*>(sjlt_long_scatter_kernel<false, false>)};
  const void* sum = reinterpret_cast<const void*>(sjlt_long_accumulate_kernel);
  for (const void* f : scatters) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 scatter_smem(LONG_MAX_BINS, LONG_MAX_COLS, false));
    }
  }
  if (err == cudaSuccess) err = cudaFuncSetAttribute(sum, cudaFuncAttributeMaxDynamicSharedMemorySize, LONG_ACC_SMEM);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(sum, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// A count pass (drawing the pairs into keys with draw) into hist, over the
// chunks (gbase null) or sub blocks a group of the groups of gbase, and its
// scans into totals and base.
cudaError_t long_count(const LongPlan& L, bool draw, int s, uint32_t k0, uint32_t k1, long long row0, int m,
                       uint32_t* keys, uint32_t tile, uint64_t t_magic, int width, int limit, long long chunk_pairs,
                       const uint32_t* gbase, int groups, int sub, uint32_t* hist, uint32_t* totals, uint32_t* base,
                       cudaStream_t stream) {
  const dim3 grid = gbase == nullptr ? dim3(static_cast<unsigned>(L.chunks)) : dim3(sub, groups);
  if (draw) {
    sjlt_long_count_kernel<true><<<grid, LONG_THREADS, 4 * width, stream>>>(
        L.n_pairs, s, k0, k1, row0, m, L.m_magic, keys, tile, t_magic, width, chunk_pairs, gbase, hist);
  } else {
    sjlt_long_count_kernel<false><<<grid, LONG_THREADS, 4 * width, stream>>>(
        L.n_pairs, s, k0, k1, row0, m, L.m_magic, keys, tile, t_magic, width, chunk_pairs, gbase, hist);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sjlt_long_scan_chunks_kernel<<<dim3((width + 31) / 32, grid.y), LONG_THREADS, 0, stream>>>(grid.x, width, limit,
                                                                                            hist, totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sjlt_long_scan_parts_kernel<<<1, LONG_SCAN_THREADS, 0, stream>>>(limit, totals, base);
  return cudaGetLastError();
}

// A scatter pass over the blocks of long_count: of the pairs and X (FROM_X)
// or of the group list, into the group list (WIDE) or the entries.
template <bool FROM_X, bool WIDE>
cudaError_t long_scatter(const LongPlan& L, const float* X, const float* vals, int d, int s, int c0, int cols,
                         const uint32_t* keys, uint32_t tile, uint64_t t_magic, int width, int limit,
                         long long chunk_pairs, const uint32_t* gbase, int groups, int sub, const uint32_t* hist,
                         const uint32_t* base, uint32_t* wide, uint16_t* local, float* out_vals,
                         cudaStream_t stream) {
  const dim3 grid = gbase == nullptr ? dim3(static_cast<unsigned>(L.chunks)) : dim3(sub, groups);
  sjlt_long_scatter_kernel<FROM_X, WIDE><<<grid, LONG_THREADS, scatter_smem(width, cols, FROM_X), stream>>>(
      X, vals, L.n_pairs, d, s, c0, cols, keys, tile, t_magic, width, limit, chunk_pairs, gbase, hist, base, wide,
      local, out_vals);
  return cudaGetLastError();
}

// The accumulate pass for columns c0 .. c0 + cols: one block a partition.
cudaError_t long_accumulate(const LongPlan& L, int m, int d, float inv_sqrt_s, int bucket_tile, int c0, int cols,
                            float* out, cudaStream_t stream) {
  sjlt_long_accumulate_kernel<<<L.parts, LONG_ACC_THREADS, bucket_tile * (12 * cols + 4), stream>>>(
      m, d, c0, cols, inv_sqrt_s, bucket_tile, L.base, L.ebucket, L.evals, out);
  return cudaGetLastError();
}

// One worker's S.X into out (m, d); with stop_after_partition only the
// partition passes of columns 0 .. cols (the check entry), without summing.
cudaError_t long_worker(const LongPlan& L, const float* X, int d, int m, int s, float inv_sqrt_s, uint32_t k0,
                        uint32_t k1, long long row0, int bucket_tile, int group_parts, int sub, long long chunk_pairs,
                        int cols, uint32_t* pairs, float* out, bool stop_after_partition,
                        cudaStream_t stream) {
  const uint32_t B = static_cast<uint32_t>(bucket_tile);
  const int P = L.parts;
  cudaError_t err;
  if (L.groups > 0) {
    // Two levels: the pairs into groups of group_parts partitions, then each
    // group's share of the group list into its partitions.
    const uint32_t G = B * static_cast<uint32_t>(group_parts);
    err = long_count(L, true, s, k0, k1, row0, m, pairs, G, L.g_magic, L.groups, L.groups, chunk_pairs, nullptr, 0, 0,
                     L.hist1, L.totals1, L.base1, stream);
    for (int c0 = 0; c0 < d && err == cudaSuccess; c0 += cols) {
      const int group = min(cols, d - c0);
      err = long_scatter<true, true>(L, X, nullptr, d, s, c0, group, pairs, G, L.g_magic, L.groups, L.groups,
                                     chunk_pairs, nullptr, 0, 0, L.hist1, L.base1, L.list1, nullptr, L.vals1, stream);
      if (err == cudaSuccess && c0 == 0) {  // the group list's buckets are the same for every column group
        err = long_count(L, false, s, k0, k1, row0, m, L.list1, B, L.b_magic, group_parts, P, chunk_pairs, L.base1,
                         L.groups, sub, L.hist, L.totals, L.base, stream);
      }
      if (err == cudaSuccess) {
        err = long_scatter<false, false>(L, nullptr, L.vals1, d, s, 0, group, L.list1, B, L.b_magic, group_parts, P,
                                         chunk_pairs, L.base1, L.groups, sub, L.hist, L.base, nullptr, L.ebucket,
                                         L.evals, stream);
      }
      if (stop_after_partition) return err;
      if (err == cudaSuccess) err = long_accumulate(L, m, d, inv_sqrt_s, bucket_tile, c0, group, out, stream);
    }
    return err;
  }
  err = long_count(L, true, s, k0, k1, row0, m, pairs, B, L.b_magic, P, P, chunk_pairs, nullptr, 0, 0, L.hist,
                   L.totals, L.base, stream);
  for (int c0 = 0; c0 < d && err == cudaSuccess; c0 += cols) {
    const int group = min(cols, d - c0);
    err = long_scatter<true, false>(L, X, nullptr, d, s, c0, group, pairs, B, L.b_magic, P, P, chunk_pairs, nullptr,
                                    0, 0, L.hist, L.base, nullptr, L.ebucket, L.evals, stream);
    if (stop_after_partition) return err;
    if (err == cudaSuccess) err = long_accumulate(L, m, d, inv_sqrt_s, bucket_tile, c0, group, out, stream);
  }
  return err;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// X: (n, d) float32, row-major, on the device. keys: (q, 2) uint32. The sketch
// has m rows and s nonzeros per data row, each +-inv_sqrt_s. The caller's plan
// (kernels/cuda.py plan_sjlt): chunks of chunk_rows <= MAX_ROWS data rows with
// chunk_rows * s <= MAX_PAIRS; n_splits splits of rows_per_split rows (whole
// chunks, none empty); m-tiles of bucket_tile sketch rows, at most
// MAX_BINS / CLASSES of them, each block's ring and accumulator within shared
// memory. list: q * chunks * region_ints uint32 scratch (the binned pairs;
// Layout); partial: (q, n_splits, m, d) float32 scratch; G: (q, d, d). Returns
// cudaErrorInvalidValue for a plan it cannot take, else the first CUDA error of
// the launches.
int repro_sjlt_gram(const float* X, long long n, int d, const uint32_t* keys, int q, int m, int s,
                    float inv_sqrt_s, long long rows_per_split, int n_splits, int chunk_rows, int bucket_tile,
                    uint32_t* list, float* partial, float* G, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = sjlt_pass(X, n, d, keys, q, m, s, inv_sqrt_s, rows_per_split, n_splits, chunk_rows,
                                    bucket_tile, list, partial, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(repro::reduce_and_gram(partial, q, n_splits, m, d, G, stream));
}

// S_w X: the two passes of repro_sjlt_gram and the split reduction into out
// (q, m, d) float32, no Gram. row0: the sketch's data row that X's row 0 is
// (its pairs, buckets and owner classes drawn at row0 + j), so the call
// computes S_w[:, row0 : row0 + n] X, a row tile of a taller matrix streamed a
// tile at a time; row0 >= 0, row0 + n <= 2^32. row0 = 0 is the whole-matrix
// S.X. Other arguments and returns as for repro_sjlt_gram.
int repro_sjlt_apply(const float* X, long long n, int d, const uint32_t* keys, int q, int m, int s,
                     float inv_sqrt_s, long long rows_per_split, int n_splits, int chunk_rows, int bucket_tile,
                     uint32_t* list, float* partial, float* out, long long row0, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = sjlt_pass(X, n, d, keys, q, m, s, inv_sqrt_s, rows_per_split, n_splits, chunk_rows,
                                    bucket_tile, list, partial, row0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(repro::reduce_splits(partial, q, n_splits, m, d, out,
                                               static_cast<long long>(m) * d, stream));
}

// The bin pass alone into list (q * chunks * region_ints uint32), for checking
// the binned pairs against their plain version. Arguments as for
// repro_sjlt_gram (d, rows_per_split and n_splits only checked).
int repro_sjlt_bins(long long n, int d, const uint32_t* keys, int q, int m, int s, long long rows_per_split,
                    int n_splits, int chunk_rows, int bucket_tile, uint32_t* list, void* stream_ptr) {
  Layout L;
  if (q <= 0 || q > 65535 || !layout(n, d, m, s, rows_per_split, n_splits, chunk_rows, bucket_tile, &L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      launch_bins(n, keys, q, m, s, chunk_rows, bucket_tile, L, 0, list, static_cast<cudaStream_t>(stream_ptr)));
}


// Row 12b: S_w X for q keys into out (q, m, d) float32, X (n, d) float32
// row-major on the device, keys (q, 2) uint32 in host memory (each worker's two
// words go to its kernels as launch arguments), m < 2^31 sketch rows, s nonzeros
// per data row of +-inv_sqrt_s, X's row j the sketch's data row row0 + j
// (row0 >= 0, row0 + n <= 2^32), n * s < 2^32 pairs. The plan (kernels/cuda.py
// plan_sjlt_long): bucket_tile buckets a partition, group_parts partitions a
// group of the first level (0: one level) and sub second-level blocks a group,
// chunk_pairs pairs a first-level count and scatter block (a multiple of
// LONG_CHUNK_ALIGN), cols columns a group. pairs: n s uint32, the pair list
// (bucket | sign << 31, in pair order), written by each worker in turn (the
// last one's stays). scratch: scratch_bytes of 16-byte aligned device memory,
// at least repro_sjlt_long_scratch_bytes. Returns cudaErrorInvalidValue for
// arguments it cannot take, else the first CUDA error of the launches.
int repro_sjlt_apply_long(const float* X, long long n, int d, const uint32_t* keys, int q, int m, int s,
                          float inv_sqrt_s, long long row0, int bucket_tile, int group_parts, int sub,
                          long long chunk_pairs, int cols, uint32_t* pairs, void* scratch, long long scratch_bytes,
                          float* out, void* stream_ptr) {
  LongPlan L;
  if (q <= 0 || keys == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 15u) ||
      !long_plan(n, d, m, s, row0, bucket_tile, group_parts, sub, chunk_pairs, cols, static_cast<char*>(scratch),
                 &L) ||
      L.scratch_bytes > scratch_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = allow_long_shared_memory();
  for (int w = 0; w < q && err == cudaSuccess; ++w) {
    err = long_worker(L, X, d, m, s, inv_sqrt_s, keys[2 * w], keys[2 * w + 1], row0, bucket_tile, group_parts, sub,
                      chunk_pairs, cols, pairs, out + static_cast<long long>(w) * m * d, false, stream);
  }
  return static_cast<int>(err);
}

// The scratch bytes of repro_sjlt_apply_long (and repro_sjlt_long_partition)
// on a plan, as long_plan lays them out; -1 for arguments the entry refuses.
long long repro_sjlt_long_scratch_bytes(long long n, int d, int m, int s, int bucket_tile, int group_parts, int sub,
                                        long long chunk_pairs, int cols) {
  LongPlan L;
  return long_plan(n, d, m, s, 0, bucket_tile, group_parts, sub, chunk_pairs, cols, nullptr, &L) ? L.scratch_bytes
                                                                                                 : -1;
}

// The partition passes of repro_sjlt_apply_long alone, for one key (two host
// words) and columns 0 .. cols: the pair list into pairs (n s uint32), the
// partitions' first entries into base (parts + 1 uint32) and the entries into
// ebucket (n s uint16) and evals (n s, cols float32), for checking them against
// their plain version. Other arguments as for repro_sjlt_apply_long (the
// scratch's entry pieces unused).
int repro_sjlt_long_partition(const float* X, long long n, int d, const uint32_t* key, int m, int s, long long row0,
                              int bucket_tile, int group_parts, int sub, long long chunk_pairs, int cols,
                              uint32_t* pairs, uint32_t* base, uint16_t* ebucket, float* evals,
                              void* scratch, long long scratch_bytes, void* stream_ptr) {
  LongPlan L;
  if (key == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 15u) ||
      !long_plan(n, d, m, s, row0, bucket_tile, group_parts, sub, chunk_pairs, cols, static_cast<char*>(scratch),
                 &L) ||
      L.scratch_bytes > scratch_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  L.base = base;
  L.ebucket = ebucket;
  L.evals = evals;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = allow_long_shared_memory();
  if (err == cudaSuccess) {
    err = long_worker(L, X, d, m, s, 1.f, key[0], key[1], row0, bucket_tile, group_parts, sub, chunk_pairs, cols,
                      pairs, nullptr, true, stream);
  }
  return static_cast<int>(err);
}

}  // extern "C"
