// Fused sketch -> Gram and S.A for the sparse JL (SJLT) sketch, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of the JAX reference package:
//   kernels/sjlt/gram.py    sjlt_gram_tiles, sjlt_gram_tiles_multi
//   kernels/sjlt/kernel.py  sjlt_tiles  (entry repro_sjlt_apply)
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

}  // extern "C"
