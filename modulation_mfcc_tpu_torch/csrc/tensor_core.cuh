// What the tensor-core frontend kernels (fused_frontend_tc.cu: fused_mel_x3,
// fused_mel_i16, fused_mel_i24) share: the warp-level MMAs, the bulk copies
// with their mbarriers, and the end of the frontend, the mel projection in
// x3 arithmetic on the bf16 tensor cores and the write of a block's mel and
// maximum. Included by that source only.
//
// Fragments follow the PTX ISA's m16n8k16 (bf16) and m16n8k32 (int8)
// layouts: lane = 4g + t, a thread holds rows g and g + 8 of A and column g
// of B. The contraction order inside one MMA is free, so every operand here
// is read with the same relabelling of k: the A register pair (a0, a2) of a
// row is one 8-byte load of consecutive elements k0 + 4t .. (bf16) or
// k0 + 8t .. (int8), and (b0, b1) of a column the same 8 bytes of B stored
// column-major ([n][k], 32 bytes a column). A half warp then reads 128
// contiguous bytes, free of bank conflicts.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace tc {

constexpr int kBF = 64;         // frames per block: one block maximum each
constexpr int kThreads = 256;   // 8 warps
constexpr int kMelCols = 128;   // mel columns a block computes (zero weights past n_mels)
constexpr int kMelStep = 16;    // bins per k-step of the mel projection

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D += A·B, bf16 operands, FP32 accumulate (m16n8k16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A·B as a fresh bf16 MMA (zero accumulator) whose four results are
// then added to D with FP32 adds, rounded to nearest: the tensor cores'
// own accumulation does not round each add to nearest, so a long chain of
// MMAs into one sum drifts
__device__ __forceinline__ void mma_bf16_add(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1)
{
    float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(f, a, b0, b1);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], f[i]);
}

// D += A·B, int8 operands, exact int32 accumulate (m16n8k32)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a barrier whose phase completes after `count` arrivals (and the bytes they expect)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}


__device__ __forceinline__ void mbar_fence_init()
{
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// wait until the phase of bar with this parity has completed; a wait of
// more than 2^32 cycles (about 2 s) traps, so that a fault in the pipeline
// fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    const long long start = clock64();
    uint32_t done = 0;
    while (true) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - start > (1ll << 32)) __trap();
    }
}

// The mel projection of one bin tile in x3 arithmetic, accumulated into the
// block's mel: p_s holds the tile's power split into bf16 (hi, lo), [2][kBF]
// rows of `pitch` elements ([frame][bin], STEPS * 16 bins); m_s the mel
// weights' (hi, lo) planes of those bins, [STEPS][2][kMelCols][16]. Warp w
// owns frames 32 (w >> 2) .. + 31 and mel columns 32 (w & 3) .. + 31: 2 x 4
// tiles of 16 x 8, the hi.hi products in hh (each 16-bin MMA added with
// FP32 adds, mma_bf16_add), the hi.lo and lo.hi products in sm (two FP32
// sums, added at the end, as the TPU mode sums its passes).
template <int STEPS>
__device__ __forceinline__ void mel_x3_tile(float (&hh)[2][4][4], float (&sm)[2][4][4],
                                            const __nv_bfloat16* p_s, int pitch,
                                            const __nv_bfloat16* m_s, int lane, int warp)
{
    const int g = lane >> 2, t = lane & 3;
    const int row0 = 32 * (warp >> 2) + g;
    const int col0 = 32 * (warp & 3) + g;
    const __nv_bfloat16* p_lo = p_s + kBF * pitch;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = (row0 + 16 * mt + 8 * h) * pitch + kMelStep * j + 4 * t;
                const uint2 vh = *reinterpret_cast<const uint2*>(p_s + o);
                const uint2 vl = *reinterpret_cast<const uint2*>(p_lo + o);
                ah[mt][h] = vh.x; ah[mt][2 + h] = vh.y;
                al[mt][h] = vl.x; al[mt][2 + h] = vl.y;
            }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const __nv_bfloat16* mb = m_s + ((2 * j) * kMelCols + col0 + 8 * nt) * kMelStep + 4 * t;
            const uint2 bh = *reinterpret_cast<const uint2*>(mb);
            const uint2 bl = *reinterpret_cast<const uint2*>(mb + kMelCols * kMelStep);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                mma_bf16_add(hh[mt][nt], ah[mt], bh.x, bh.y);
                mma_bf16(sm[mt][nt], ah[mt], bl.x, bl.y);
                mma_bf16(sm[mt][nt], al[mt], bh.x, bh.y);
            }
        }
    }
}

// The end of a block: mel = hh + sm of its valid frames (< nf) and columns
// (< n_mels) to mel [B, nf, n_mels], and their maximum to bmax[b,
// blockIdx.x] (mel >= 0, so 0 is neutral). red_s: kThreads / 32 floats.
__device__ __forceinline__ void write_mel(const float (&hh)[2][4][4], const float (&sm)[2][4][4],
                                          float* __restrict__ mel, float* __restrict__ bmax, float* red_s,
                                          int b, int f0, int nf, int n_mels, int lane, int warp)
{
    const int g = lane >> 2, t = lane & 3;
    float vmax = 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int f = f0 + 32 * (warp >> 2) + 16 * mt + 8 * h + g;
            if (f >= nf) continue;
            float* row = mel + ((size_t)b * nf + f) * n_mels;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int m = 32 * (warp & 3) + 8 * nt + 2 * t + i;
                    if (m < n_mels) {
                        const float v = hh[mt][nt][2 * h + i] + sm[mt][nt][2 * h + i];
                        row[m] = v;
                        vmax = fmaxf(vmax, v);
                    }
                }
        }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    if (lane == 0) red_s[warp] = vmax;
    __syncthreads();
    if (threadIdx.x == 0) {
        float m = red_s[0];
        for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red_s[w]);
        bmax[(size_t)b * gridDim.x + blockIdx.x] = m;
    }
}

}  // namespace tc
