// The producer-fed rings of both kernels (sm_90): mbarriers, bulk copies
// into shared memory (cp.async.bulk, completing on an mbarrier) and out of
// it (bulk groups), the fences between the generic and the async proxy, a
// named barrier, and the clock split's macros. polyphase.cu's reg.tma and
// resample.cu's grouped.tma variants use them; device code only.
//
// A ring stage has a "full" barrier, which completes when its samples have
// landed (the producer's arrivals and the bulk copy's bytes), and an
// "empty" one, which completes when every consumer warp has read it.

#pragma once

#include <stdint.h>

namespace mr {
namespace pipe {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// the barriers' initialisation, visible to the async proxy (the copies)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar))
      : "memory");
}
// arrive, and expect ``bytes`` more from a bulk copy before the phase ends
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// one bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// this thread's writes to shared memory, visible to a later bulk store
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// one bulk store of ``bytes`` (as bulk_copy's) from shared memory into
// device memory, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gmem),
      "r"(smem_addr(smem)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until this thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// wait until this thread's bulk groups have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// named barrier ``id`` (not 0, __syncthreads') among ``threads`` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace pipe
}  // namespace mr

// A clock split for the tools (tools/polyphase_runs.py, tools/
// resample_runs.py), which build a source again with -DMR_CLOCKS: each
// thread then adds its clock64 intervals, by part, to the source's
// mr_clocks[kClockParts] (its ClockPart enum; read and cleared by its
// mr_<name>_clocks entry); a thread's sums are 32-bit (a launch's clocks
// a thread stay below 2^32), so the split spends few registers. Without
// the define the macros are empty.
#ifdef MR_CLOCKS
#define MR_CLOCK_BEGIN                 \
  unsigned int clk_[kClockParts] = {}; \
  long long clk_at_ = clock64()
#define MR_CLOCK(part)                          \
  do {                                          \
    const long long t_ = clock64();             \
    clk_[part] += (unsigned int)(t_ - clk_at_); \
    clk_at_ = t_;                               \
  } while (0)
#define MR_CLOCK_END                                                       \
  do {                                                                     \
    for (int p_ = 0; p_ < kClockParts; ++p_)                               \
      if (clk_[p_]) atomicAdd(&mr_clocks[p_], (unsigned long long)clk_[p_]); \
  } while (0)
#else
#define MR_CLOCK_BEGIN \
  do {                 \
  } while (0)
#define MR_CLOCK(part) \
  do {                 \
  } while (0)
#define MR_CLOCK_END \
  do {               \
  } while (0)
#endif
