// The mbarrier and bulk-copy (TMA) helpers the Hopper kernels share:
// stream_probes.cu and, through staged_window.cuh, dia_spmm_slide.cu and
// dia_spmm_tiles.cu.  sm_90a.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// clock cycles a barrier wait may spin (about 10 s at the H100's clocks)
constexpr long long kHangCycles = 20000000000LL;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void barrier_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// One arrival on `bar` that also expects `bytes` of copies to land.
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Spins until the phase of `bar` with this parity has completed, with
// acquire at the scope of the block or (kCluster: the arrivals may come
// from other blocks) of the cluster; traps (the launch fails) rather than
// hang the card if it has not after about ten seconds.
template <bool kCluster = false>
__device__ __forceinline__ void barrier_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    const long long t0 = clock64();
    do {
        if (kCluster) {
            asm volatile(
                "{\n"
                ".reg .pred p;\n"
                "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
                "p, [%1], %2;\n"
                "selp.u32 %0, 1, 0, p;\n"
                "}\n"
                : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        } else {
            asm volatile(
                "{\n"
                ".reg .pred p;\n"
                "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                "selp.u32 %0, 1, 0, p;\n"
                "}\n"
                : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        }
        if (!done && clock64() - t0 > kHangCycles) __trap();
    } while (!done);
}

// Bulk copy of `bytes` from global `src` into this block's shared `dst`,
// counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The same under the L2 cache `policy`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], "
                 "%4;\n"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
                 : "memory");
}

}  // namespace
