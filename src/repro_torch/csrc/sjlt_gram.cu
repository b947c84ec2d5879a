// Fused sketch -> Gram and S.A for the sparse JL (SJLT) sketch, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of the JAX reference package:
//   kernels/sjlt/gram.py    sjlt_gram_tiles, sjlt_gram_tiles_multi
//   kernels/sjlt/kernel.py  sjlt_tiles  (entry repro_sjlt_apply)
// The TPU's sjlt_tiles takes (n, s) bucket and sign arrays and contracts a
// one-hot (m x n) tile on the MXU, m / s times the work of the sparse sum. Here
// repro_sjlt_apply is this file's sketch pass and split reduction, written out,
// without the Gram pass: the parameters are the same sjlt_counter_params drawn
// in-core, so S is identical, and on the same plan S_w X is bitwise what the
// Gram pass contracts. Bound: X's bytes, 0.150 ms per worker at n = 500,000,
// d = 251, plus m * d * 4 bytes of output.
// For q keys (one per worker) and X = [A | b] of shape (n, d), it computes
// G_w = (S_w X)^T (S_w X) where data row i adds sign(i, t) * X[i] into sketch row
// bucket(i, t) for t < s, with (bucket, sign) = (b0 mod m, +-1/sqrt(s) from b1's
// low bit) of threefry20(key_w, i, t): the contract of kernels/common.py
// sjlt_counter_params, drawn in-core (a (q, n, s) parameter tensor would be
// 16 GB at q = 200, n = 500,000, s = 20).
//
// What bounds it on this card. The work is sparse: n * s * d FMA per worker
// (not the TPU's one-hot product, m / s times more). At n = 500,000, d = 251,
// s = 20 that is 2.5 G FMA (0.075 ms at the fp32 peak) and 10^7 threefry draws
// (0.046 ms of integer work), against 0.15 ms to read X once: bytes-bound per
// worker. This design pays more than that floor: every block redraws the
// parameters of its rows (m_tiles * d_tiles blocks share a split), and each
// block re-reads its columns of X once per m-tile.
//
// Design.
//   Sketch pass: grid (m-tile x d-tile, n-split, worker). A block owns
//   bucket_tile sketch rows (an m-tile, <= MAX_BUCKETS) and BD = 32 columns of
//   X: lane = column. Its (bucket_tile x 32) fp32 accumulator lives in shared
//   memory. It walks its n-range chunk_rows data rows at a time:
//     1. loads the (chunk_rows x 32) tile of X into shared memory;
//     2. draws the chunk's chunk_rows * s (row, t) pairs, SLOTS per thread, and
//        keeps those whose bucket falls in its m-tile;
//     3. bins them by owner warp (bucket mod WARPS) with warp ballots: warp p's
//        pairs land in its own segment of a shared list, class by class, in
//        ascending pair order (no atomics);
//     4. warp c walks the entries of class c, segment 0 .. WARPS-1 in order,
//        and adds sign * X[row, lane] into accumulator row bucket - m0 with one
//        fmaf per lane. Only warp c touches the buckets of class c, and it does
//        so in a fixed order, so every sum is deterministic. Four entries are
//        taken at a time when their buckets differ (else one by one, in order).
//   The block then writes its (bucket_tile x 32) partial; the split reduction and
//   the Gram pass (gram_pass.cuh) finish the job as for the dense families.
// Determinism: the split plan and the chunking are functions of (n, m, d, s)
// only, chosen by the caller, and workers never share a block, so the slice of a
// q-key call for key w is bitwise equal to a call with q = 1 on key w, and
// reruns are bitwise. No float atomics anywhere.
#include <cuda_runtime.h>

#include <cstdint>

#include "gram_pass.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;           // also the number of bucket classes
constexpr int BD = 32;                        // columns of X per block: lane = column
constexpr int MAX_ROWS = 128;                 // data rows per chunk
constexpr int MAX_PAIRS = 2048;               // (row, t) pairs per chunk
constexpr int SLOTS = MAX_PAIRS / THREADS;    // pairs each thread draws per chunk
constexpr int SEG = SLOTS * 32;               // list entries each warp's pairs may take
constexpr int MAX_BUCKETS = 1536;             // accumulator rows per block: 192 KB
constexpr int ROWS_PER_WARP = MAX_ROWS / WARPS;
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(SLOTS * THREADS == MAX_PAIRS && ROWS_PER_WARP * WARPS == MAX_ROWS, "chunk geometry");
static_assert(MAX_BUCKETS <= 0xFFFF && MAX_ROWS <= 0x7FFF, "list entry packing");

// A list entry: bucket - m0 in bits 0-15, the row within the chunk in bits
// 16-30, the sign bit (1 -> negative) in bit 31.
// x_s is the chunk's X tile, (MAX_ROWS x BD) row-major.
__device__ __forceinline__ void add_entry(float* acc, const float* x_s, uint32_t v, float pos,
                                          int lane) {
  float* a = acc + (v & 0xFFFFu) * BD + lane;
  const float sv = (v >> 31) ? -pos : pos;
  *a = fmaf(sv, x_s[((v >> 16) & 0x7FFFu) * BD + lane], *a);
}

__global__ void __launch_bounds__(THREADS, 1)
sjlt_partial_kernel(const float* __restrict__ X, long long n, int d,
                    const uint32_t* __restrict__ keys, int m, int s, float inv_sqrt_s,
                    long long rows_per_split, int bucket_tile, int m_tiles, int chunk_rows,
                    float* __restrict__ partial) {
  extern __shared__ float acc[];  // [bucket_tile][BD]
  __shared__ float x_s[MAX_ROWS][BD];
  __shared__ uint32_t list[MAX_PAIRS];
  __shared__ int seg_off[WARPS][WARPS];  // [drawing warp][class]
  __shared__ int seg_cnt[WARPS][WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = (blockIdx.x % m_tiles) * bucket_tile;
  const int nb = min(bucket_tile, m - m0);
  const int col = (blockIdx.x / m_tiles) * BD + lane;
  const int split = blockIdx.y;
  const int w = blockIdx.z;
  const uint32_t k0 = keys[2 * w];
  const uint32_t k1 = keys[2 * w + 1];
  const long long j_begin = static_cast<long long>(split) * rows_per_split;
  const long long j_end = min(n, j_begin + rows_per_split);
  const int pairs = chunk_rows * s;
  const uint32_t lanes_below = (1u << lane) - 1u;

  for (int e = tid; e < nb * BD; e += THREADS) acc[e] = 0.f;

  for (long long c0 = j_begin; c0 < j_end; c0 += chunk_rows) {
    const int rows_here = static_cast<int>(min(static_cast<long long>(chunk_rows), j_end - c0));
    // 1. X tile: warp loads rows warp, warp + WARPS, ... (32 columns each) into
    //    registers first, so the loads are in flight while the pairs are drawn.
    float xr[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + WARPS * i;
      xr[i] = (r < rows_here && col < d) ? __ldg(X + (c0 + r) * d + col) : 0.f;
    }
    // 2. This warp's pairs p = warp * SEG + k * 32 + lane, with their classes.
    uint32_t ent[SLOTS];
    int cls[SLOTS];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int p = warp * SEG + k * 32 + lane;
      const int r = p / s;
      cls[k] = WARPS;
      ent[k] = 0u;
      if (p < pairs && r < rows_here) {
        const uint2 b = repro::threefry2x32(k0, k1, static_cast<uint32_t>(c0 + r),
                                            static_cast<uint32_t>(p - r * s), 20);
        const int lb = static_cast<int>(b.x % static_cast<uint32_t>(m)) - m0;
        if (lb >= 0 && lb < nb) {
          cls[k] = lb % WARPS;
          ent[k] = static_cast<uint32_t>(lb) | (static_cast<uint32_t>(r) << 16) | ((b.y & 1u) << 31);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) x_s[warp + WARPS * i][lane] = xr[i];
    // 3. Bin by class. Lane c counts class c; each pair's place is its class's
    //    start in this warp's segment plus the pairs of its class before it.
    uint32_t mine[SLOTS];
    uint32_t of_lane[SLOTS];
    int total = 0;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      mine[k] = 0u;
      of_lane[k] = 0u;
#pragma unroll
      for (int c = 0; c < WARPS; ++c) {
        const uint32_t bal = __ballot_sync(FULL, cls[k] == c);
        if (cls[k] == c) mine[k] = bal;
        if (lane == c) of_lane[k] = bal;
      }
      total += __popc(of_lane[k]);
    }
    int incl = total;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - total;
    if (lane < WARPS) {
      seg_off[warp][lane] = run;
      seg_cnt[warp][lane] = total;
    }
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int base = __shfl_sync(FULL, run, cls[k] % WARPS);
      if (cls[k] < WARPS) list[warp * SEG + base + __popc(mine[k] & lanes_below)] = ent[k];
      run += __popc(of_lane[k]);
    }
    __syncthreads();
    // 4. Warp c adds the entries of class c, segment by segment, in order.
    for (int pw = 0; pw < WARPS; ++pw) {
      const uint32_t* L = list + pw * SEG + seg_off[pw][warp];
      const int cnt = seg_cnt[pw][warp];
      int e = 0;
      for (; e + 4 <= cnt; e += 4) {
        const uint32_t v0 = L[e], v1 = L[e + 1], v2 = L[e + 2], v3 = L[e + 3];
        const uint32_t b0 = v0 & 0xFFFFu, b1 = v1 & 0xFFFFu, b2 = v2 & 0xFFFFu, b3 = v3 & 0xFFFFu;
        if (b0 != b1 && b0 != b2 && b0 != b3 && b1 != b2 && b1 != b3 && b2 != b3) {
          float* a0 = acc + b0 * BD + lane;
          float* a1 = acc + b1 * BD + lane;
          float* a2 = acc + b2 * BD + lane;
          float* a3 = acc + b3 * BD + lane;
          const float x0 = x_s[(v0 >> 16) & 0x7FFFu][lane], x1 = x_s[(v1 >> 16) & 0x7FFFu][lane];
          const float x2 = x_s[(v2 >> 16) & 0x7FFFu][lane], x3 = x_s[(v3 >> 16) & 0x7FFFu][lane];
          const float y0 = fmaf((v0 >> 31) ? -inv_sqrt_s : inv_sqrt_s, x0, *a0);
          const float y1 = fmaf((v1 >> 31) ? -inv_sqrt_s : inv_sqrt_s, x1, *a1);
          const float y2 = fmaf((v2 >> 31) ? -inv_sqrt_s : inv_sqrt_s, x2, *a2);
          const float y3 = fmaf((v3 >> 31) ? -inv_sqrt_s : inv_sqrt_s, x3, *a3);
          *a0 = y0;
          *a1 = y1;
          *a2 = y2;
          *a3 = y3;
        } else {
          add_entry(acc, &x_s[0][0], v0, inv_sqrt_s, lane);
          add_entry(acc, &x_s[0][0], v1, inv_sqrt_s, lane);
          add_entry(acc, &x_s[0][0], v2, inv_sqrt_s, lane);
          add_entry(acc, &x_s[0][0], v3, inv_sqrt_s, lane);
        }
      }
      for (; e < cnt; ++e) add_entry(acc, &x_s[0][0], L[e], inv_sqrt_s, lane);
    }
    __syncthreads();
  }

  if (col < d) {
    float* out = partial + (static_cast<long long>(w) * gridDim.y + split) *
                               static_cast<long long>(m) * d;
    for (int lb = warp; lb < nb; lb += WARPS) {
      out[static_cast<long long>(m0 + lb) * d + col] = acc[lb * BD + lane];
    }
  }
}

// The SJLT sketch pass into partial (q, n_splits, m, d); returns
// cudaErrorInvalidValue for a plan it cannot take, else the first CUDA error.
cudaError_t sjlt_pass(const float* X, long long n, int d, const uint32_t* keys, int q, int m,
                      int s, float inv_sqrt_s, long long rows_per_split, int n_splits,
                      int bucket_tile, int chunk_rows, float* partial, cudaStream_t stream) {
  if (rows_per_split <= 0 || static_cast<long long>(n_splits) * rows_per_split < n ||
      bucket_tile <= 0 || bucket_tile > MAX_BUCKETS || chunk_rows <= 0 ||
      chunk_rows > MAX_ROWS || s <= 0 || static_cast<long long>(chunk_rows) * s > MAX_PAIRS) {
    return cudaErrorInvalidValue;
  }
  const int m_tiles = (m + bucket_tile - 1) / bucket_tile;
  const int d_tiles = (d + BD - 1) / BD;
  const int smem = bucket_tile * BD * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(sjlt_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sjlt_partial_kernel<<<dim3(m_tiles * d_tiles, n_splits, q), THREADS, smem, stream>>>(
      X, n, d, keys, m, s, inv_sqrt_s, rows_per_split, bucket_tile, m_tiles, chunk_rows, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// X: (n, d) float32, row-major, on the device. keys: (q, 2) uint32. The sketch
// has m rows and s nonzeros per data row, each +-inv_sqrt_s. partial:
// (q, n_splits, m, d) float32 scratch. G: (q, d, d). The caller's plan:
// n_splits * rows_per_split >= n; bucket_tile <= MAX_BUCKETS sketch rows per
// block with ceil(m / bucket_tile) m-tiles; chunk_rows <= MAX_ROWS data rows per
// chunk with chunk_rows * s <= MAX_PAIRS. Returns cudaErrorInvalidValue for a
// plan it cannot take, else the first CUDA error of the three launches.
int repro_sjlt_gram(const float* X, long long n, int d, const uint32_t* keys, int q, int m,
                    int s, float inv_sqrt_s, long long rows_per_split, int n_splits,
                    int bucket_tile, int chunk_rows, float* partial, float* G,
                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = sjlt_pass(X, n, d, keys, q, m, s, inv_sqrt_s, rows_per_split, n_splits,
                                    bucket_tile, chunk_rows, partial, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(repro::reduce_and_gram(partial, q, n_splits, m, d, G, stream));
}

// S_w X: the sketch pass of repro_sjlt_gram and its split reduction into out
// (q, m, d) float32, no Gram. Arguments and returns as for repro_sjlt_gram.
int repro_sjlt_apply(const float* X, long long n, int d, const uint32_t* keys, int q, int m,
                     int s, float inv_sqrt_s, long long rows_per_split, int n_splits,
                     int bucket_tile, int chunk_rows, float* partial, float* out,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = sjlt_pass(X, n, d, keys, q, m, s, inv_sqrt_s, rows_per_split, n_splits,
                                    bucket_tile, chunk_rows, partial, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(repro::reduce_splits(partial, q, n_splits, m, d, out,
                                               static_cast<long long>(m) * d, stream));
}

}  // extern "C"
