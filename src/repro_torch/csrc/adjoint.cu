// Gaussian adjoint S^T Y, hand-written for Hopper: two entries.
//
// Replaces the Pallas TPU kernel of the JAX reference package:
//   kernels/gaussian/gram.py  gaussian_adjoint_tiles
// For Y (m, k) float32 and S in R^{m x n} with S[i, j] = counter_normal(k0, k1,
// i, j) / sqrt(m) (rng.cuh: the same counter pair (sketch row i, data row j) as
// the forward S.A of sketch_apply.cu, so <S x, y> = <x, S^T y> holds for one S),
// both compute out[j, c] = sum_i S[i, j] * Y[i, c] for j < n, c < k. It is the
// x = S^T z of the right-sketch least-norm solve (sketch_least_norm, the paper's
// section V), where Y is the (m, 1) solution z of the small problem: k = 1.
//
// repro_adjoint_kept: S read back from device memory. On the least-norm path a
// worker's forward S.A^T draws every entry of its S once and can store it
// (sketch_apply.cu, s_out); the adjoint then reads that S, row-major (m, ld)
// with ld a multiple of 4, instead of drawing it again.
//   What bounds it on this card: the bytes. S is m * n floats, read once (185 MB
//   at m = 4,000, n = 11,556: 0.055 ms at 3.35 TB/s); the product is 2 * m * n * k
//   flops (1.4 us of FFMA at k = 1).
//   Design. A block owns a strip of KEPT_COLS = 128 output rows j (four per
//   lane, so a warp reads 512 contiguous bytes of a row of S a load) and
//   KEPT_WARPS = 8 splits of the sketch rows, one a warp; the splits of one
//   strip are the blocks of one thread-block cluster (at most 8 blocks, 64
//   splits). A warp streams its split in groups of UNROLL = 4 rows with 16-byte
//   loads that do not allocate in L1, the next group's loads in flight while a
//   group's products run (a ring of STAGES = 2 groups in registers). Each warp
//   sums its split in chains of at most CHUNK = 128 rows (fmaf in row order)
//   added to a running sum, as the redraw kernel below does; the warps then put
//   their partials in shared memory, and after a cluster barrier each block
//   sums its share of the strip's outputs over all splits in split order,
//   reading the other blocks' partials through distributed shared memory. One
//   launch, no partial buffer, no atomics: reruns are bitwise equal.
//   What the card showed (tools/adjoint_tune.py): resident warps, not the depth
//   of each warp's loads, decide the rate. Deeper rings or groups cost
//   registers, and once a launch no longer fits the card in one wave its tail
//   costs more than the depth gains; fewer, fuller clusters beat more splits.
//   The splits (kernels/cuda.py plan_adjoint) are the redraw kernel's, and so
//   are the chains and the split order, so the two entries are bitwise equal
//   on the same key.
//
// repro_gaussian_adjoint: S drawn in-core again (a standalone adjoint, or S too
// large to keep).
//   What bounds it on this card: drawing S. Each of the m * n entries is one
//   threefry (about 75 integer operations at 20 rounds) and a Box-Muller (logf,
//   sqrtf, cosf); the product adds 2 * k flops per entry and the bytes are Y and
//   the output, (m + n) * k floats. At m = 4,000, n = 11,556, k = 1 the integer
//   work alone is 0.21 ms at the card's int32 rate, the bytes 0.02 us. So nothing
//   is staged for reuse but Y: the TPU kernel's (block_n x block_k) MXU
//   contraction, the 128-lane padding of k and the padding of m and n to blocks
//   are gone.
//   Design. One thread owns one output row j (128 rows a block) and walks its
//   split of the sketch rows i in chunks of 128: the block stages the chunk's Y
//   rows (KC columns) in shared memory, then each thread draws S[i, j] in
//   registers for the 128 i of the chunk and accumulates KC running products;
//   each S entry is drawn exactly once per column tile. k = 1 takes a one-column
//   instance (KC = 1); k > 1 takes KC = 8 accumulators a thread, and grid z walks
//   the 8-column tiles, so S is drawn once for k <= 8 and once per 8 columns
//   beyond. Masked rows and columns (i >= m, j >= n, c >= k) are never drawn or
//   written: nothing is padded in device memory.
//   Enough blocks: at n = 1,000 there are only 8 row tiles, so m is cut into
//   splits (kernels/cuda.py plan_adjoint: a function of (m, n, k) only), each
//   block writes its split's partial (n_splits, n, k), and reduce_splits_kernel
//   (gram_pass.cuh) sums the partials in split order. There are no atomics, so
//   reruns are bitwise equal.
//
// Two-level sum (both entries): within a split a product chain restarts every
// chunk (at most 128 terms) and is added to a running sum; the splits are then
// added in order. At m = 4,000, n = 11,556 one output is 16 splits of 250 rows,
// 32 chains and 16 partials; against a float64 plain version the check holds
// per column to 1e-5 of the column's rms.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gram_pass.cuh"
#include "rng.cuh"

namespace cg = cooperative_groups;

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


// ---- repro_adjoint_kept: S^T Y over a kept S ----

constexpr int KEPT_WARPS = 8;                          // splits a block, one a warp
constexpr int KEPT_THREADS = 32 * KEPT_WARPS;
constexpr int KEPT_COLS = 128;                         // output rows a block: four a lane
constexpr int KEPT_MAX_CLUSTER = 8;                    // portable cluster size
constexpr int KEPT_MAX_SPLITS = KEPT_WARPS * KEPT_MAX_CLUSTER;
constexpr int KEPT_KC_MULTI = 4;                       // columns of Y a warp sums when k > 1
// Tuning switches (the port builds with the defaults; tools/adjoint_tune.py
// times others): rows of S a warp loads a group, groups in the ring, and the
// load's cache hints (0: not in L1, 256-byte L2 prefetch; 1: not in L1; 2: __ldg).
#ifndef ADJOINT_KEPT_UNROLL
#define ADJOINT_KEPT_UNROLL 4
#endif
#ifndef ADJOINT_KEPT_STAGES
#define ADJOINT_KEPT_STAGES 2
#endif
#ifndef ADJOINT_KEPT_LOAD
#define ADJOINT_KEPT_LOAD 1
#endif
constexpr int UNROLL = ADJOINT_KEPT_UNROLL;
constexpr int STAGES = ADJOINT_KEPT_STAGES;
static_assert(CHUNK % UNROLL == 0, "a group of rows never straddles a chain");

// 16 bytes of a stream read once.
__device__ __forceinline__ float4 load_stream(const float* p) {
  float4 v;
#if ADJOINT_KEPT_LOAD == 0
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
#elif ADJOINT_KEPT_LOAD == 1
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
#else
  v = __ldg(reinterpret_cast<const float4*>(p));
#endif
  return v;
}

// One group of UNROLL rows from row i (rows at or past i_end, and columns at or
// past n, read as zero): this lane's float4 of S and Y's KC values, each row's.
template <int KC>
struct Group {
  float4 s[UNROLL];
  float y[UNROLL][KC];

  __device__ __forceinline__ void load(const float* S, long long ld, const float* Y, int k, int c0, long long j,
                                       bool live, int i, int i_end) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool row = i + u < i_end;
      s[u] = (live && row) ? load_stream(S + static_cast<long long>(i + u) * ld + j)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        y[u][q] = (row && c0 + q < k) ? __ldg(Y + static_cast<long long>(i + u) * k + c0 + q) : 0.f;
      }
    }
  }
};

template <int KC>
__global__ void __launch_bounds__(KEPT_THREADS)
adjoint_kept_kernel(const float* __restrict__ S, long long ld, const float* __restrict__ Y, int m, int k,
                    long long n, int rows_per_split, int n_splits, float* __restrict__ out) {
  constexpr int OUTS = KEPT_COLS * KC;  // outputs of a strip and column tile
  __shared__ __align__(16) float part[KEPT_WARPS][OUTS];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long strip0 = static_cast<long long>(blockIdx.x / c) * KEPT_COLS;
  const int c0 = blockIdx.y * KC;
  const int split = rank * KEPT_WARPS + warp;

  if (split < n_splits) {
    // Lane: columns j .. j + 3 of S (inside a row when j < n: ld >= n is a multiple of 4).
    const long long j = strip0 + 4 * lane;
    const bool live = j < n;
    const int i_begin = split * rows_per_split;
    const int i_end = min(m, i_begin + rows_per_split);
    float run[4][KC];
    float acc[4][KC];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < KC; ++q) run[e][q] = acc[e][q] = 0.f;
    // Groups of UNROLL rows in a ring of STAGES: the next STAGES - 1 groups'
    // loads are in flight while a group's products run. A chain closes every
    // CHUNK rows from i_begin and at i_end.
    const int groups = (i_end - i_begin + UNROLL - 1) / UNROLL;
    Group<KC> ring[STAGES];
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < groups) ring[t].load(S, ld, Y, k, c0, j, live, i_begin + t * UNROLL, i_end);
    }
    for (int g0 = 0; g0 < groups; g0 += STAGES) {
#pragma unroll
      for (int t = 0; t < STAGES; ++t) {
        const int g = g0 + t;
        if (g >= groups) break;
        if (g + STAGES - 1 < groups) {
          ring[(t + STAGES - 1) % STAGES].load(S, ld, Y, k, c0, j, live, i_begin + (g + STAGES - 1) * UNROLL,
                                               i_end);
        }
        const Group<KC>& cur = ring[t];
        const int i = i_begin + g * UNROLL;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (i + u < i_end) {  // the same for every lane: a chain has exactly its rows
#pragma unroll
            for (int q = 0; q < KC; ++q) {
              acc[0][q] = fmaf(cur.s[u].x, cur.y[u][q], acc[0][q]);
              acc[1][q] = fmaf(cur.s[u].y, cur.y[u][q], acc[1][q]);
              acc[2][q] = fmaf(cur.s[u].z, cur.y[u][q], acc[2][q]);
              acc[3][q] = fmaf(cur.s[u].w, cur.y[u][q], acc[3][q]);
            }
          }
        }
        if ((g + 1) % (CHUNK / UNROLL) == 0 || g + 1 == groups) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int q = 0; q < KC; ++q) {
              run[e][q] += acc[e][q];
              acc[e][q] = 0.f;
            }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < KC; ++q) part[warp][(4 * lane + e) * KC + q] = run[e][q];
  }
  cluster.sync();  // every split's partial of the strip is in its block's shared memory

  // This block's share of the strip's outputs, each summed over the splits in
  // split order (split p is warp p % 8 of block p / 8 of the cluster).
  const int per = (OUTS + c - 1) / c;
  const int o_end = min(OUTS, (rank + 1) * per);
  for (int o = rank * per + static_cast<int>(threadIdx.x); o < o_end; o += KEPT_THREADS) {
    float sum = 0.f;
    for (int b = 0; b * KEPT_WARPS < n_splits; ++b) {
      const float* src = cluster.map_shared_rank(&part[0][0], b) + o;
      float v[KEPT_WARPS];
#pragma unroll
      for (int w = 0; w < KEPT_WARPS; ++w) v[w] = b * KEPT_WARPS + w < n_splits ? src[w * OUTS] : 0.f;
#pragma unroll
      for (int w = 0; w < KEPT_WARPS; ++w) {
        const int p = b * KEPT_WARPS + w;
        if (p < n_splits) sum = p == 0 ? v[w] : sum + v[w];
      }
    }
    const long long jj = strip0 + o / KC;
    const int col = c0 + o % KC;
    if (jj < n && col < k) out[jj * k + col] = sum;
  }
  cluster.sync();  // no block leaves while a peer may still read its partials
}

template <int KC>
cudaError_t launch_kept(dim3 grid, int cluster, cudaStream_t stream, const float* S, long long ld,
                        const float* Y, int m, int k, long long n, int rows_per_split, int n_splits,
                        float* out) {
  if (cluster == 1) {  // a block is its own cluster: the plain launch is cheaper on the host
    adjoint_kept_kernel<KC><<<grid, KEPT_THREADS, 0, stream>>>(S, ld, Y, m, k, n, rows_per_split, n_splits, out);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(KEPT_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, adjoint_kept_kernel<KC>, S, ld, Y, m, k, n, rows_per_split,
                                             n_splits, out);
  if (err != cudaSuccess) return err;
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

// S: (m, ld) float32, row-major, on the device, 16-byte aligned, ld >= n a
// multiple of 4 (columns past n are never used); Y: (m, k) float32, row-major;
// out: (n, k) float32. The sketch rows are cut into n_splits <= 64 splits of
// rows_per_split rows, none empty (as for repro_gaussian_adjoint, whose output
// on the same splits and key this is bitwise). One launch
// on device `device` (made current for it) and the stream: a cluster of
// ceil(n_splits / 8) blocks per strip of 128 output rows. Returns
// cudaErrorInvalidValue for a shape or split it cannot take, else the launch's
// CUDA error (0 when it was accepted).
int repro_adjoint_kept(const float* S, long long ld, const float* Y, int m, int k, long long n,
                       int rows_per_split, int n_splits, float* out, int device, void* stream_ptr) {
  if (S == nullptr || reinterpret_cast<uintptr_t>(S) % 16 != 0 || ld < n || ld % 4 != 0 || m <= 0 || k <= 0 ||
      n <= 0 || n > 0x7FFFFFFFLL || rows_per_split <= 0 || n_splits <= 0 || n_splits > KEPT_MAX_SPLITS ||
      static_cast<long long>(n_splits) * rows_per_split < m ||
      static_cast<long long>(n_splits - 1) * rows_per_split >= m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kc = k == 1 ? 1 : KEPT_KC_MULTI;
  const int cluster = (n_splits + KEPT_WARPS - 1) / KEPT_WARPS;
  const long long strips = (n + KEPT_COLS - 1) / KEPT_COLS;
  const int col_tiles = (k + kc - 1) / kc;
  if (col_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(strips * cluster), col_tiles);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = kc == 1 ? launch_kept<1>(grid, cluster, stream, S, ld, Y, m, k, n, rows_per_split, n_splits, out)
                : launch_kept<KEPT_KC_MULTI>(grid, cluster, stream, S, ld, Y, m, k, n, rows_per_split, n_splits, out);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // extern "C"
