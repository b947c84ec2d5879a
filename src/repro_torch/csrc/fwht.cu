// Fast Walsh-Hadamard transform, hand-written for Hopper: two entries on one
// templated pass kernel.
//
// Replaces the Pallas TPU kernel of the JAX reference package:
//   kernels/fwht/kernel.py  fwht_tiles (body _fwht_tile_kernel), which
//   kernels/fwht/ops.py fwht drives in two Kronecker grid passes.
// H is the unnormalised +-1 Hadamard matrix of order n_pad = 2^L.
//
// repro_fwht: y = H x for x (n, k) float32, row-major, n = 2^L (the SRHT's
// adjoint, and any standalone transform).
// repro_srht_forward: the SRHT's S.A = (1/sqrt(m)) P H D A without D A, the zero
// rows or H D A in device memory: out[p] = (H pad(D A, n_pad))[ids[p]] * scale
// for A (n, k), the Rademacher diagonal D[j] = 1 - 2 (threefry2x32(kd0, kd1, j,
// 0).x & 1) (rng.cuh, 20 rounds, as kernels/common.py counter_rademacher) and
// the m sampled row ids (with repeats).
//
// What bounds it on this card: bytes. The transform is L add/subtract pairs per
// element pair (at the SRHT's full n, 2^19 x 251: 2.5 G flop, 0.04 ms at the fp32
// peak), against one read and one write of the data per pass (526 MB each way at
// 2^19 x 251: 0.157 ms at 3.35 TB/s). The TPU ran the transform as dense products
// with small Hadamard factors on the MXU, R * (128 + R / 128) multiplies per
// element; on Hopper that is far more work than the butterfly, so this design
// keeps the butterfly and cuts the bytes.
//
// Pass kernel. A pass runs t <= 10 consecutive stages h = 2^lo, ..., 2^(lo+t-1).
// Its grid is (group x column strip): a group is the 2^t rows base + i * 2^lo,
// i < 2^t, that those stages mix; a strip is W = 32 columns, a lane of a warp
// per column, so a warp's row piece is 128 bytes (the last strip masks the
// ragged edge, so any k works and rows need not be 16-byte aligned). A block
// holds a 2^t x 32 tile in shared memory and
//   1. for each run of 2^a consecutive i (a = min(5, t)), a warp loads the 2^a
//      rows of its strip into registers, runs the pass's first a stages there,
//      and stores the run to the tile;
//   2. after a barrier, for each residue r < 2^a, a warp loads the 2^(t-a) rows
//      i = r + j * 2^a from the tile, runs the other t - a stages and writes
//      the rows out.
// The loads and stores of one block do not overlap. A tile of up to 9 stages
// (64 KB) fits three blocks of 8 warps an SM, so while one stores the others
// load; the 128 KB tile of 10 stages fits once, and its block takes 16 warps
// so that more of its loads are in flight (tools/fwht_tune.py: 16-column
// strips, whose 10-stage tile fits three times, lose more to row pieces of 64
// bytes than they gain).
//
// repro_fwht: the first pass reads x and writes y, later passes work on y in
// place (a block reads all its elements before it writes any, and blocks own
// disjoint elements). The caller (kernels/cuda.py plan_fwht) cuts L into the
// fewest passes: two for 2^10 < n <= 2^20.
//
// repro_srht_forward, on the same plan:
//   * the first pass reads A's rows j < n with D[j] applied at load (one
//     threefry a row and column strip, drawn by one lane of the warp and shared
//     by ballot); rows n <= j < n_pad are zeros, never read. Its groups that
//     hold no row below n write nothing, and the next pass reads their rows as
//     zeros;
//   * passes between the first and the last run on a scratch (the kernel's own)
//     whose rows are padded to a multiple of 32 floats, so that a warp's row
//     piece is whole 32-byte sectors;
//   * the last pass (lo + t = L: group g holds the rows g + i * 2^lo) scans the
//     m ids (from L2) for those in its group before it loads anything, each
//     thread keeping a hit bit for each of its first 32 ids, so a group with
//     none skips its reads; it runs its butterflies and writes each sampled row, times scale,
//     into the (m, k) output at every position p that drew it (a warp a
//     position).
//     With n_pad <= 2^10 the first pass is the last.
// So A is read once, each intermediate written and read once, and m rows written.
//
// Bitwise equal to the plain versions: every stage is the butterfly
// (a, b) -> (a + b, a - b) of sketches._fwht, and stages run in its order
// h = 1, 2, 4, ... (across passes and within a pass), so every output is the
// same sequence of float adds and subtracts; a sign flip, a zero and the product
// by scale (a float32 value) are the plain version's exact operations. No atomics
// reach the output: each output element is written by one thread.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "rng.cuh"

namespace {

constexpr int W = 32;             // columns per strip: one lane of a warp each
constexpr int MAX_TILE_BITS = 10;
constexpr int REG_BITS = 5;       // stages a step runs in registers (a warp's ballot covers them)
constexpr int SCRATCH_ALIGN = W;  // floats a scratch row is a multiple of: whole strips
constexpr int THREADS = 256;      // a block of a tile that fits three times an SM
constexpr int ONE_BLOCK_THREADS = 512;  // a block of a tile that fits once
constexpr int MASK_CHUNKS = 32;   // SAMPLE: chunks of the ids a thread keeps its hits of

enum Mode : int { PLAIN = 0, SIGNS = 1, SAMPLE = 2 };

struct PassArgs {
  const float* in;
  long long ld_in;     // floats between rows of `in`
  long long valid_in;  // rows at or past it read as zeros
  float* out;
  long long ld_out;
  long long valid_out;  // groups whose rows all lie at or past it write nothing
  int k;
  int lo;
  int strips;
  uint32_t kd0, kd1;  // SIGNS: the diagonal's key words
  const int* ids;     // SAMPLE: the m sampled row ids (repro_srht_forward)
  int m;
  float scale;
};

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

template <int T>
__host__ __device__ constexpr int smem_bytes() {
  return (W << T) * static_cast<int>(sizeof(float));
}

// A tile of more than a third of an SM's 228 KB fits once: its block takes more
// threads (its loads in flight are all the SM has), at most 128 registers each;
// smaller tiles fit three times, at most 80 registers a thread.
template <int T>
__host__ __device__ constexpr bool one_block() {
  return smem_bytes<T>() > 76 * 1024;
}
template <int T>
__host__ __device__ constexpr int block_threads() {
  return one_block<T>() ? ONE_BLOCK_THREADS : THREADS;
}

template <int T, int MODE>
__global__ void __launch_bounds__(block_threads<T>(), one_block<T>() ? 1 : 3)
fwht_pass_kernel(const PassArgs p) {
  constexpr int NT = block_threads<T>();
  constexpr int WARPS = NT / 32;
  constexpr int A = T < REG_BITS ? T : REG_BITS;
  constexpr int B = T - A;
  extern __shared__ float tile[];  // [1 << T][W]
  const int c = static_cast<int>(threadIdx.x) % W;
  const int warp = static_cast<int>(threadIdx.x) / W;
  const long long group = blockIdx.x / p.strips;
  const int col = static_cast<int>(blockIdx.x % p.strips) * W + c;
  const bool live = col < p.k;
  const long long stride = 1LL << p.lo;
  const long long region = (group >> p.lo) << (p.lo + T);  // first row of the group's span
  const long long base = region | (group & (stride - 1));
  if (region >= p.valid_out) return;  // every row of the span is zero: nothing to write
  // SAMPLE: an id lies in this group when its low lo bits are the group's
  // residue; bit s of hits is set when ids[s * NT + threadIdx.x] does (s < MASK_CHUNKS).
  const unsigned low = static_cast<unsigned>(stride - 1);
  const int chunks = static_cast<int>((static_cast<long long>(p.m) + NT - 1) / NT);
  uint32_t hits = 0;
  if constexpr ((MODE & SAMPLE) != 0) {
    bool any = false;
#pragma unroll 4
    for (int s = 0; s < chunks; ++s) {
      const long long j = static_cast<long long>(s) * NT + threadIdx.x;
      const bool hit = j < p.m && (static_cast<unsigned>(__ldg(p.ids + j)) & low) == group;
      any |= hit;
      if (s < MASK_CHUNKS) hits |= static_cast<uint32_t>(hit) << s;
    }
    if (!__syncthreads_or(any)) return;  // no sampled row in this group: skip its reads
  }

  for (int u = warp; u < (1 << B); u += WARPS) {
    uint32_t neg = 0;  // SIGNS: bit i set when D of run row i is -1 (the first pass: stride 1)
    if constexpr ((MODE & SIGNS) != 0) {
      const long long row = base + (static_cast<long long>(u) << A) + c;
      const bool flip = c < (1 << A) && row < p.valid_in &&
                        (repro::threefry2x32(p.kd0, p.kd1, static_cast<uint32_t>(row), 0u, 20).x & 1u);
      neg = __ballot_sync(0xFFFFFFFFu, flip);
    }
    float v[1 << A];
#pragma unroll
    for (int i = 0; i < (1 << A); ++i) {
      const long long row = base + static_cast<long long>((u << A) + i) * stride;
      float x = (live && row < p.valid_in) ? p.in[row * p.ld_in + col] : 0.f;
      if constexpr ((MODE & SIGNS) != 0) x = ((neg >> i) & 1u) ? -x : x;
      v[i] = x;
    }
    butterflies<A>(v);
#pragma unroll
    for (int i = 0; i < (1 << A); ++i) tile[((u << A) + i) * W + c] = v[i];
  }
  __syncthreads();
  for (int r = warp; r < (1 << A); r += WARPS) {
    float v[1 << B];
#pragma unroll
    for (int j = 0; j < (1 << B); ++j) v[j] = tile[(r + (j << A)) * W + c];
    butterflies<B>(v);
    if constexpr ((MODE & SAMPLE) != 0) {
#pragma unroll
      for (int j = 0; j < (1 << B); ++j) tile[(r + (j << A)) * W + c] = v[j];
    } else if (live) {
#pragma unroll
      for (int j = 0; j < (1 << B); ++j) {
        const long long row = base + static_cast<long long>(r + (j << A)) * stride;
        p.out[row * p.ld_out + col] = v[j];
      }
    }
  }
  if constexpr ((MODE & SAMPLE) != 0) {  // out[at] = row ids[at] >> lo of the group, times scale, a warp a position
    __syncthreads();
    for (int s = 0; s < chunks; ++s) {
      const long long j = static_cast<long long>(s) * NT + threadIdx.x;
      const bool hit = s < MASK_CHUNKS ? ((hits >> s) & 1u) != 0
                                       : j < p.m && (static_cast<unsigned>(__ldg(p.ids + j)) & low) == group;
      for (unsigned b = __ballot_sync(0xFFFFFFFFu, hit); b != 0; b &= b - 1) {
        const long long at = static_cast<long long>(s) * NT + warp * 32 + (__ffs(b) - 1);
        const int i = static_cast<int>(static_cast<unsigned>(__ldg(p.ids + at)) >> p.lo);
        if (live) p.out[at * p.k + col] = tile[i * W + c] * p.scale;
      }
    }
  }
}

// The shared memory an SM sets aside for a pass (its carveout): only what the
// most blocks of the pass that fit the SM need, each with its reserve, so that
// the rest of the SM's 256 KB stays L1, where its loads in flight land
// (tools/fwht_tune.py: at 2^19 x 251 the forward's 10-stage pass took 0.47 ms
// with all of it shared, 0.38 with the rest L1; left to CUDA's own choice, the
// 9-stage pass got one block short of three).
template <int T, int MODE>
cudaError_t fit_carveout(int device) {
  const auto kernel = fwht_pass_kernel<T, MODE>;
  int per_sm = 0, reserve = 0, blocks = 0;
  cudaError_t err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&reserve, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block_threads<T>(), smem_bytes<T>());
  }
  if (err != cudaSuccess || blocks <= 0 || per_sm <= 0) return err == cudaSuccess ? cudaErrorInvalidValue : err;
  const long long need = static_cast<long long>(blocks) * (smem_bytes<T>() + reserve);
  const int percent = static_cast<int>(std::min(100LL, (100 * need + per_sm - 1) / per_sm));
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, percent);
}

// Launch one pass. Its dynamic shared memory and its carveout are set once per
// instantiation and device: a runtime call on every launch is host time that a
// call at FIG4A's size, whose passes take microseconds, cannot hide.
template <int T, int MODE>
cudaError_t launch_pass(const PassArgs& p, long long groups, int device, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};  // bit d: device d is set
  constexpr int smem = smem_bytes<T>();
  const unsigned long long bit = 1ull << (device & 63);
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    cudaError_t err =
        cudaFuncSetAttribute(fwht_pass_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = fit_carveout<T, MODE>(device);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const long long blocks = groups * p.strips;
  if (blocks <= 0 || blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  fwht_pass_kernel<T, MODE><<<static_cast<unsigned>(blocks), block_threads<T>(), smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t run_pass(int t, const PassArgs& p, long long groups, int device, cudaStream_t stream) {
  switch (t) {
    case 0: return launch_pass<0, MODE>(p, groups, device, stream);
    case 1: return launch_pass<1, MODE>(p, groups, device, stream);
    case 2: return launch_pass<2, MODE>(p, groups, device, stream);
    case 3: return launch_pass<3, MODE>(p, groups, device, stream);
    case 4: return launch_pass<4, MODE>(p, groups, device, stream);
    case 5: return launch_pass<5, MODE>(p, groups, device, stream);
    case 6: return launch_pass<6, MODE>(p, groups, device, stream);
    case 7: return launch_pass<7, MODE>(p, groups, device, stream);
    case 8: return launch_pass<8, MODE>(p, groups, device, stream);
    case 9: return launch_pass<9, MODE>(p, groups, device, stream);
    case 10: return launch_pass<10, MODE>(p, groups, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

static_assert(MAX_TILE_BITS == 10, "run_pass instantiates passes of 0 to 10 stages");

cudaError_t run_mode(int mode, int t, const PassArgs& p, long long groups, int device, cudaStream_t stream) {
  switch (mode) {
    case PLAIN: return run_pass<PLAIN>(t, p, groups, device, stream);
    case SIGNS: return run_pass<SIGNS>(t, p, groups, device, stream);
    case SAMPLE: return run_pass<SAMPLE>(t, p, groups, device, stream);
    case SIGNS | SAMPLE: return run_pass<SIGNS | SAMPLE>(t, p, groups, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The stage counts packed 4 bits a pass (pass p in bits 4p..4p+3): each in
// [0, MAX_TILE_BITS], `passes` of them, summing to log2(n). Fills t[].
bool unpack_plan(long long packed, int passes, long long n, int* t) {
  if (n <= 0 || (n & (n - 1)) != 0 || passes <= 0 || passes > 15) return false;
  int total = 0;
  for (int q = 0; q < passes; ++q) {
    t[q] = static_cast<int>((packed >> (4 * q)) & 15);
    if (t[q] > MAX_TILE_BITS) return false;
    total += t[q];
  }
  return (packed >> (4 * passes)) == 0 && total <= 62 && (1LL << total) == n;
}

long long round_up(long long x, long long mult) { return (x + mult - 1) / mult * mult; }

// Runs `body` with `device` current, restoring the caller's device after.
template <typename F>
int on_device(int device, F&& body) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = body();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (n, k) float32, row-major, on `device`, not overlapping. plan: the
// passes' stage counts packed 4 bits a pass (see unpack_plan); pass p runs its
// stages after those of the passes before it. Makes `device` current for the
// launches. Returns cudaErrorInvalidValue for a shape or plan it cannot take,
// else the first CUDA error of the passes' launches (0 when all were accepted).
int repro_fwht(const float* x, float* y, long long n, int k, long long plan, int passes, int device,
               void* stream_ptr) {
  int t[15];
  if (x == nullptr || y == nullptr || k <= 0 || !unpack_plan(plan, passes, n, t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return on_device(device, [&]() -> cudaError_t {
    PassArgs p{};
    p.k = k;
    p.strips = (k + W - 1) / W;
    p.valid_in = p.valid_out = n;
    p.ld_in = p.ld_out = k;
    for (int q = 0; q < passes; ++q) {
      p.in = q == 0 ? x : y;
      p.out = y;
      const cudaError_t err = run_mode(PLAIN, t[q], p, n >> t[q], device, stream);
      if (err != cudaSuccess) return err;
      p.lo += t[q];
    }
    return cudaSuccess;
  });
}

// out (m, k) = (H pad(D A, n_pad))[ids] * scale for A (n, k) float32, row-major,
// n <= n_pad = 2^L <= 2^31, D keyed by (kd0, kd1) and the m sampled row ids,
// int32 on the device, each in [0, n_pad) (the caller checks; repeats allowed).
// Plan as repro_fwht's for n_pad. With two or more passes `scratch` holds
// round_up(n, n_pad >> t_last) rows (those the passes before the last can make
// nonzero) of `ld_scratch` floats (ld_scratch >= k, a multiple of
// SCRATCH_ALIGN); with one it is not read. Makes `device` current for the
// launches.
int repro_srht_forward(const float* A, long long n, int k, unsigned kd0, unsigned kd1, const int* ids, int m,
                       float scale, float* out, float* scratch, long long ld_scratch, long long n_pad,
                       long long plan, int passes, int device, void* stream_ptr) {
  int t[15];
  if (A == nullptr || out == nullptr || ids == nullptr || n <= 0 || n > n_pad || n_pad > (1LL << 31) || k <= 0 ||
      m <= 0 || !unpack_plan(plan, passes, n_pad, t) ||
      (passes > 1 && (scratch == nullptr || ld_scratch < k || ld_scratch % SCRATCH_ALIGN != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return on_device(device, [&]() -> cudaError_t {
    PassArgs p{};
    p.k = k;
    p.strips = (k + W - 1) / W;
    p.kd0 = kd0;
    p.kd1 = kd1;
    p.ids = ids;
    p.m = m;
    p.scale = scale;
    p.in = A;
    p.ld_in = k;
    p.valid_in = n;
    for (int q = 0; q < passes; ++q) {
      const bool last = q == passes - 1;
      const int mode = (q == 0 ? SIGNS : PLAIN) | (last ? SAMPLE : PLAIN);
      // Rows at or past valid_out stay zero after this pass: whole spans of
      // 2^(lo + t) rows of zero input.
      p.valid_out = last ? n_pad : round_up(p.valid_in, 1LL << (p.lo + t[q]));
      p.out = last ? out : scratch;
      p.ld_out = last ? k : ld_scratch;
      // The last pass's groups are the residues mod 2^lo; an earlier pass's are
      // those whose span starts below valid_out.
      const long long groups = last ? (1LL << p.lo) : (p.valid_out >> t[q]);
      const cudaError_t err = run_mode(mode, t[q], p, groups, device, stream);
      if (err != cudaSuccess) return err;
      p.in = scratch;
      p.ld_in = ld_scratch;
      p.valid_in = p.valid_out;
      p.lo += t[q];
    }
    return cudaSuccess;
  });
}

}  // extern "C"
