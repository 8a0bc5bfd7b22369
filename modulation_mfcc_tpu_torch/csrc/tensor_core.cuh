// What the tensor-core frontend kernels (fused_frontend_tc.cu: fused_mel_f32,
// fused_mel_bf16, fused_mel_x3, fused_mel_i16, fused_mel_i24; and
// fused_frontend_fold_tc.cu: fused_mel_fold_f32, fused_mel_fold_x3) share:
// the block and tile geometry, the warp-level MMAs, and the end of the
// frontend, the mel projection on the bf16 tensor cores (one pass for bf16,
// the three-plane split for f32, x3 arithmetic for the others) and the
// write of a block's mel and maxima. Included by those sources only.
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

#include "mbarrier.cuh"

namespace tc {

using mbar::bulk_load;
using mbar::smem_u32;

constexpr int kBF = 64;         // frames per block of the full plan, and of one block maximum
constexpr int kThreads = 256;   // 8 warps
constexpr int kMelCols = 128;   // mel columns a block computes (a group; zero weights past n_mels)
constexpr int kMelLimit = 512;  // mel columns a launch takes: up to four groups
constexpr int kMelStep = 16;    // bins per k-step of the mel projection
constexpr int kChunkRows = 32;  // contraction rows a pipeline stage of the basis ring holds
constexpr int kStages = 4;      // pipeline stages of the full plan (the compact plan: 2 to 4)
constexpr int kMT = 2;          // 16-frame MMA tiles a warp in the full plan: warps 2 (frames) x 4 (columns)
constexpr int kWN = 4;          // warps across a tile's columns, 32 each
constexpr int kCols = 32 * kWN; // DFT columns per tile: re and im of 64 bins
constexpr int kTileBins = kCols / 2;
constexpr int kPitch = kTileBins + 16;  // bf16 elements of a power-tile row: 8 mod 32 words, conflict-free
constexpr int kSharedMax = 232448;      // bytes of shared memory a block may use on the H100

static_assert(kMT * 16 * (kThreads / 32 / kWN) == kBF, "the warps cover the block's frames");

// re^2 + im^2, each product and the sum rounded to nearest (no FMA)
__device__ __forceinline__ float power_of(float re, float im)
{
    return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
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

// The mel projection of one bin tile, accumulated into the block's mel. p_s
// holds the tile's power as PLANES bf16 planes (bf16: the rounded power;
// x3: its (hi, lo) split; f32: (hi, mid, lo)) of 32 MT rows of `pitch`
// elements ([frame][bin], STEPS * 16 bins); m_s the mel weights' planes of
// those bins, [STEPS][PLANES][kMelCols][16]. Warp w owns frames
// 16 MT (w >> 2) .. + 16 MT - 1 and mel columns 32 (w & 3) .. + 31: MT x 4
// tiles of 16 x 8. The hi.hi products go to hh, each 16-bin MMA added with FP32 adds
// (mma_bf16_add); for x3 the hi.lo and lo.hi products go to sm (two FP32
// sums, added at the end, as the TPU mode sums its passes), for f32 the
// hi.mid, mid.hi, hi.lo, mid.mid and lo.hi products.
template <int STEPS, int PLANES, int MT>
__device__ __forceinline__ void mel_tile(float (&hh)[MT][4][4], float (&sm)[MT][4][4], const __nv_bfloat16* p_s,
                                         int pitch, const __nv_bfloat16* m_s, int lane, int warp)
{
    const int g = lane >> 2, t = lane & 3;
    const int row0 = 16 * MT * (warp >> 2) + g;
    const int col0 = 32 * (warp & 3) + g;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
        uint32_t a[PLANES][MT][4];
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int o = p * 32 * MT * pitch + (row0 + 16 * mt + 8 * h) * pitch + kMelStep * j + 4 * t;
                    const uint2 v = *reinterpret_cast<const uint2*>(p_s + o);
                    a[p][mt][h] = v.x; a[p][mt][2 + h] = v.y;
                }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const __nv_bfloat16* mb = m_s + ((PLANES * j) * kMelCols + col0 + 8 * nt) * kMelStep + 4 * t;
            uint2 b[PLANES];
#pragma unroll
            for (int p = 0; p < PLANES; ++p) b[p] = *reinterpret_cast<const uint2*>(mb + p * kMelCols * kMelStep);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_bf16_add(hh[mt][nt], a[0][mt], b[0].x, b[0].y);
            if constexpr (PLANES >= 2) {
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma_bf16(sm[mt][nt], a[0][mt], b[1].x, b[1].y);
                    mma_bf16(sm[mt][nt], a[1][mt], b[0].x, b[0].y);
                    if constexpr (PLANES == 3) {
                        mma_bf16(sm[mt][nt], a[0][mt], b[2].x, b[2].y);
                        mma_bf16(sm[mt][nt], a[1][mt], b[1].x, b[1].y);
                        mma_bf16(sm[mt][nt], a[2][mt], b[0].x, b[0].y);
                    }
                }
            }
        }
    }
}

__device__ __forceinline__ void store_pair(float* p, float v0, float v1, bool)
{
    p[0] = v0;
    p[1] = v1;
}

// two neighbouring mel entries rounded to bf16 (nearest even), as one 4-byte
// store where p is aligned to it
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1, bool aligned)
{
    if (aligned) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    } else {
        p[0] = __float2bfloat16_rn(v0);
        p[1] = __float2bfloat16_rn(v1);
    }
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The end of a block of 32 MT frames from f0 and mel group c0 / 128: mel =
// hh + sm of its valid frames (< nf) and columns c0 .. c0 + 127 (< n_mels) to
// mel [B, nf, n_mels] (float32, or bf16 rounded to nearest even), and their
// maximum, over the FP32 values, into bmax[b, f0 / 64] (mel >= 0, so 0 is
// neutral): stored where the block is the only one of its 64 frames (the
// full plan, one mel group), else by atomicMax on the bits, which order as
// the values for non-negative floats, into a zeroed bmax. red_s: kThreads /
// 32 floats.
template <int MT, typename OutT>
__device__ __forceinline__ void write_mel(const float (&hh)[MT][4][4], const float (&sm)[MT][4][4],
                                          OutT* __restrict__ mel, float* __restrict__ bmax, float* red_s,
                                          int b, int f0, int nf, int n_mels, int c0, bool atomic, int lane,
                                          int warp)
{
    const int g = lane >> 2, t = lane & 3;
    const bool aligned = (n_mels & 1) == 0;
    float vmax = 0.0f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int f = f0 + 16 * MT * (warp >> 2) + 16 * mt + 8 * h + g;
            if (f >= nf) continue;
            OutT* row = mel + ((size_t)b * nf + f) * n_mels;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int m = c0 + 32 * (warp & 3) + 8 * nt + 2 * t;
                const float v0 = hh[mt][nt][2 * h] + sm[mt][nt][2 * h];
                const float v1 = hh[mt][nt][2 * h + 1] + sm[mt][nt][2 * h + 1];
                if (m + 1 < n_mels) {
                    store_pair(row + m, v0, v1, aligned);
                    vmax = fmaxf(vmax, fmaxf(v0, v1));
                } else if (m < n_mels) {
                    store_one(row + m, v0);
                    vmax = fmaxf(vmax, v0);
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
        float* dst = bmax + (size_t)b * ((nf + kBF - 1) / kBF) + f0 / kBF;
        if (atomic) atomicMax(reinterpret_cast<int*>(dst), __float_as_int(m));
        else *dst = m;
    }
}

}  // namespace tc
