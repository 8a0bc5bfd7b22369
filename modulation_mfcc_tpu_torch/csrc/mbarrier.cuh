// Shared-memory mbarriers, as the kernels that pipeline through shared
// memory use them (fused_frontend_tc.cu through tensor_core.cuh,
// fused_frontend.cu's tail and viterbi.cu's backtrace): initialise, arrive,
// wait for a phase with a trap on a wait that never ends, and the bulk copy
// that completes one. Included by those sources only.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace mbar {

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a barrier whose phase completes after `count` arrivals (and the bytes they expect)
__device__ __forceinline__ void init(uint64_t* bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_init()
{
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival (release: this thread's earlier writes are seen by a thread
// whose wait on the phase returns)
__device__ __forceinline__ void arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// whether the phase of bar with this parity has completed
__device__ __forceinline__ bool done(uint64_t* bar, uint32_t parity)
{
    uint32_t ok;
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    return ok;
}

// wait until the phase of bar with this parity has completed; a wait of
// more than 2^32 cycles (about 2 s) traps, so that a fault in the pipeline
// fails the launch instead of hanging the card
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity)
{
    if (done(bar, parity)) return;
    const long long start = clock64();
    while (!done(bar, parity))
        if (clock64() - start > (1ll << 32)) __trap();
}

// one thread: arrive on bar expecting `bytes`, and copy them global -> shared
// with the bulk-copy engine (TMA without a tensor map: 16-byte aligned,
// contiguous, a multiple of 16 bytes); the barrier's phase completes when
// they have landed
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

}  // namespace mbar
