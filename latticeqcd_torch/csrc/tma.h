// One-thread bulk copies from device memory into shared memory (the Tensor Memory
// Accelerator's 1-D form, cp.async.bulk) completing on a shared-memory mbarrier, sm_90.
// A block's thread 0 initialises the barrier, announces the bytes to come and issues the
// copies; every thread waits for the barrier's phase 0 before reading the copied rows.
// Addresses and sizes of a bulk copy are multiples of 16 bytes.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Initialise with one expected arrival and make it visible to the copy engine; the block
// synchronises (__syncthreads) before any other thread touches the barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The one arrival, announcing `bytes` of copies that complete on this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  } while (!done);
}

// Prefetch [p, p + bytes) from device memory into L2 (cp.async.bulk.prefetch, no completion to
// wait for); p and bytes are multiples of 16.
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p), "r"(bytes) : "memory");
}
