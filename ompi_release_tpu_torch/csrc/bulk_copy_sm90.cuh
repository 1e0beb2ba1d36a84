// Hopper's bulk asynchronous copies (the 1-D, non-tensor form of the
// Tensor Memory Accelerator) and the shared-memory barriers (mbarrier)
// that report their completion, for sm_90a. Inline PTX, no state: a
// kernel that streams through shared memory includes this header and
// builds its own ring of stages from these pieces. No kernel of the
// library includes it yet: a ring of bulk copies built on it for
// stream_scale ran behind torch.mul on an H100 (PERF.md) and was not
// kept; the flash kernels' TMA pipeline is the next user planned.
//
// - mbarrier: init (with the fence that publishes it), arrive with an
//   expected byte count (arrive_expect_tx), and a wait on a phase's
//   parity (wait_parity: try_wait in a loop);
// - bulk_load: global -> shared, completing on an mbarrier with the
//   bytes it wrote (complete_tx);
// - bulk_store: shared -> global in the issuing thread's bulk group,
//   with bulk_commit, bulk_wait_read<N> (at most N groups may still be
//   reading shared memory: the stage may be refilled) and bulk_wait<N>
//   (their writes are done);
// - fence_proxy_async: between the threads' generic writes to shared
//   memory and a bulk store that reads them.
//
// Every address and byte count handed to a bulk copy must be a
// multiple of 16; the callers keep them so. One thread issues a copy;
// every thread of the block may wait on its barrier. Everything here
// has internal linkage. cuda_op.build() hashes this header with the
// sources, so an edit here rebuilds the library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace bulk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: a barrier that completes a phase after `count` arrivals
// and every expected byte; then the fence that makes the init visible
// to the async proxy (the copies) before any thread uses it
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also raises the phase's expected bytes by `bytes`
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase with parity `parity` has completed (a fresh
// barrier is in phase 0: its first completion is waited on with 0)
__device__ __forceinline__ void mbar_wait_parity(uint64_t* bar,
                                                 uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// global -> shared, `bytes` (a multiple of 16, both addresses 16-byte
// aligned); the barrier's current phase counts the bytes as they land
__device__ __forceinline__ void bulk_load(void* smem_dst, const void* gmem_src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem_dst)),
      "l"(gmem_src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global, `bytes` (a multiple of 16, both addresses 16-byte
// aligned), in the issuing thread's current bulk group
__device__ __forceinline__ void bulk_store(void* gmem_dst, const void* smem_src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gmem_dst),
      "r"(smem_u32(smem_src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// at most N of this thread's committed groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// at most N of this thread's committed groups are still incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes made visible to the async proxy
// (a later bulk store of the same bytes); each writing thread fences,
// then the block synchronises, then one thread issues the store
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace bulk
}  // namespace
