// Pipeline pieces of the tensor-core sketch kernels, shared by the dense S.A
// (sketch_apply.cu) and the Gaussian sketch->Gram pass (sketch_gram.cu):
// mbarriers (local, remote and with a transaction count), cp.async and the bulk
// copy with its cluster multicast, register hand-over between warpgroups, named
// barriers over one role's warps, and the cluster-wide barrier. Every address is
// a 32-bit shared-memory address of the calling block unless a function says
// otherwise.
#pragma once

#include <cstdint>

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Wait until the phase of `bar` with this parity has completed (acquire, so
// what the arriving threads of the cluster wrote before they arrived is seen).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// The same two at CTA scope: for a barrier whose arrivals publish nothing that
// the waiting block reads from another block's shared memory (a bulk copy's
// bytes, a hand-back of a ring entry), which is cheaper to wait on.
__device__ __forceinline__ void mbar_wait_cta(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// Whether the phase of `bar` with this parity has completed, without waiting.
__device__ __forceinline__ bool mbar_test_cta(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transaction count the current phase waits for
// (the bulk copies that complete_tx on `bar` bring them).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Arrive (release, cluster scope) on the barrier at the same offset in block `rank`'s shared memory.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}
// The same at CTA scope: a hand-back that publishes no writes.
__device__ __forceinline__ void mbar_arrive_remote_cta(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global memory into this block's shared memory at dst, completing `bytes` of
// bar's transaction count. With `mask` (bit r: cluster rank r) the same bytes
// land at dst's offset in every masked block's shared memory, and each block's
// barrier at bar's offset is completed by them.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
      "%4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// 16-byte asynchronous copy global -> shared of src_bytes (0 to 16) bytes, the
// rest zero-filled; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Hand registers between warpgroups (setmaxnreg acts on a whole warpgroup of 4
// warps; .inc waits until the block's pool has the registers).
template <int REGS>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Named barrier ID (1 to 15; 0 is __syncthreads's) over COUNT threads of the
// block, a multiple of 32: one role's warps wait for each other alone.
template <int ID, int COUNT>
__device__ __forceinline__ void named_sync() {
  static_assert(ID > 0 && ID < 16 && COUNT % 32 == 0, "named barrier");
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
}

// Split arrive and wait of the cluster-wide barrier (every thread of every block
// of the cluster arrives once per phase): release and acquire order the shared
// memory writes and reads of the cluster around it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace repro
