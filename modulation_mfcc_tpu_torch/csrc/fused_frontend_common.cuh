// What the CUDA-core fold kernels share (fused_frontend_fold.cu:
// fused_mel_fold_f32, _bf16, _x3): the block geometry, the cp.async and bf16 helpers, and the end of
// each bin tile and of each block. A block owns kBF consecutive frames of
// one utterance; warp w owns frames 4w..4w+3 and 32+4w..32+4w+3, lane l the
// bins (and mel columns) l + 32j of a tile. Included by those sources only.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace frontend {

constexpr int kBF = 64;        // frames per block
constexpr int kBT = 128;       // DFT bins per tile (re and im columns each)
constexpr int kKC = 16;        // contraction rows staged per step
constexpr int kMelMax = 128;   // mel columns a block holds: a group (the grid's z)
constexpr int kMelLimit = 512; // mel columns a launch takes: up to four groups
constexpr int kThreads = 256;
constexpr int kPitch = kBF + 4;  // row pitch of the [k][frame] and [bin][frame] tiles: 16-byte rows, few bank conflicts

constexpr int kF32 = 0, kBF16 = 1, kX3 = 2;

// DFT bins a tile holds (re and im columns each). f32 halves the tile: a
// thread's 8 x 2 running sums and the step's partial sums then take 64
// registers, which leaves room for two blocks an SM
template <int MODE> constexpr int kTile = MODE == kF32 ? kBT / 2 : kBT;
template <int MODE> constexpr int kTileSlice = kKC * 2 * kTile<MODE>;  // floats of one staged basis slice (one plane)

__device__ __forceinline__ int owned_frame(int warp, int i) { return (i < 4 ? 0 : 28) + 4 * warp + i; }

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// 16-byte global -> shared copy that bypasses registers; zero-fills when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

// The end of bin tile bt, of TB = 32 NJ bins: the thread's re and im sums
// (x3: the hi*hi sums in re/im, the small products in res/ims) -> power,
// rounded as MODE says ('bf16': to bf16; 'x3': split into bf16 hi and lo),
// written transposed ([bin][frame]) to p_s, which may share space with the
// staged slices; then the power tile projected onto melw's rows
// bt..bt+TB-1, columns c0..c0+127 (the block's mel group), into the
// [kBF][kMelMax] accumulator mel_s (x3: the small products into mel2_s,
// melw's lo plane following its hi plane), in bin order.
template <int MODE, int NJ = 4>
__device__ __forceinline__ void project_tile(const float (&re)[8][NJ], const float (&im)[8][NJ],
                                             const float (&res)[8][NJ], const float (&ims)[8][NJ], float* p_s,
                                             float* mel_s, float* mel2_s, const float* __restrict__ melw, int bt,
                                             int bins_pad, int n_mels, int c0, int lane, int warp)
{
    constexpr int TB = 32 * NJ;
    const float* mel_lo = melw + (size_t)bins_pad * n_mels;  // x3 only
    __syncthreads();  // every warp is done with the slices the power tile overwrites
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        float pw[8], pl[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float r = MODE == kX3 ? re[i][j] + res[i][j] : re[i][j];
            const float m = MODE == kX3 ? im[i][j] + ims[i][j] : im[i][j];
            const float v = r * r + m * m;
            pw[i] = MODE == kF32 ? v : bf16r(v);
            pl[i] = MODE == kX3 ? bf16r(v - pw[i]) : 0.0f;
        }
        float* row = p_s + (lane + 32 * j) * kPitch + 4 * warp;
        *reinterpret_cast<float4*>(row) = make_float4(pw[0], pw[1], pw[2], pw[3]);
        *reinterpret_cast<float4*>(row + 32) = make_float4(pw[4], pw[5], pw[6], pw[7]);
        if constexpr (MODE == kX3) {
            float* row_l = row + TB * kPitch;
            *reinterpret_cast<float4*>(row_l) = make_float4(pl[0], pl[1], pl[2], pl[3]);
            *reinterpret_cast<float4*>(row_l + 32) = make_float4(pl[4], pl[5], pl[6], pl[7]);
        }
    }
    __syncthreads();

    // each thread owns mel_s entries (its 8 frames, mel lane + 32j)
    float acc[8][4], acc2[8][4];  // acc2: x3's small products
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            acc[i][j] = mel_s[owned_frame(warp, i) * kMelMax + lane + 32 * j];
            acc2[i][j] = MODE == kX3 ? mel2_s[owned_frame(warp, i) * kMelMax + lane + 32 * j] : 0.0f;
        }
    for (int c = 0; c < TB; ++c) {
        const float4 p_lo = *reinterpret_cast<const float4*>(p_s + c * kPitch + 4 * warp);
        const float4 p_hi = *reinterpret_cast<const float4*>(p_s + c * kPitch + 32 + 4 * warp);
        const float pv[8] = {p_lo.x, p_lo.y, p_lo.z, p_lo.w, p_hi.x, p_hi.y, p_hi.z, p_hi.w};
        float mw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int m = c0 + lane + 32 * j;
            mw[j] = m < n_mels ? __ldg(melw + (size_t)(bt + c) * n_mels + m) : 0.0f;
        }
        if constexpr (MODE == kX3) {
            const float* pl_row = p_s + TB * kPitch + c * kPitch;
            const float4 q_lo = *reinterpret_cast<const float4*>(pl_row + 4 * warp);
            const float4 q_hi = *reinterpret_cast<const float4*>(pl_row + 32 + 4 * warp);
            const float pvl[8] = {q_lo.x, q_lo.y, q_lo.z, q_lo.w, q_hi.x, q_hi.y, q_hi.z, q_hi.w};
            float mwl[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int m = c0 + lane + 32 * j;
                mwl[j] = m < n_mels ? __ldg(mel_lo + (size_t)(bt + c) * n_mels + m) : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc[i][j] = fmaf(pv[i], mw[j], acc[i][j]);
                    acc2[i][j] = fmaf(pv[i], mwl[j], acc2[i][j]);
                    acc2[i][j] = fmaf(pvl[i], mw[j], acc2[i][j]);
                }
        } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], mw[j], acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            mel_s[owned_frame(warp, i) * kMelMax + lane + 32 * j] = acc[i][j];
            if constexpr (MODE == kX3) mel2_s[owned_frame(warp, i) * kMelMax + lane + 32 * j] = acc2[i][j];
        }
}

// The end of a block: its valid frames (< nf) of the mel accumulator to
// mel_out [B, nf, n_mels] columns c0.. (bf16 for 'bf16'), and the max over
// them to bmax[b, blockIdx.x] (mel >= 0, so 0 is neutral): stored with one
// mel group, else merged by atomicMax on the bits (which order as the values
// for non-negative floats) into a zeroed bmax. red_s: kThreads/32 floats.
template <int MODE>
__device__ __forceinline__ void write_block(const float* mel_s, const float* mel2_s, void* __restrict__ mel_out,
                                            float* __restrict__ bmax, float* red_s, int b, int f0, int nf,
                                            int n_mels, int c0, int tid, int lane, int warp)
{
    __syncthreads();
    const int nm = min(kMelMax, n_mels - c0);  // the group's columns
    float vmax = 0.0f;
    for (int i = tid; i < kBF * nm; i += kThreads) {
        const int f = i / nm;
        const int m = i % nm;
        if (f0 + f < nf) {
            const float v = MODE == kX3 ? mel_s[f * kMelMax + m] + mel2_s[f * kMelMax + m] : mel_s[f * kMelMax + m];
            const size_t o = ((size_t)b * nf + f0 + f) * n_mels + c0 + m;
            if constexpr (MODE == kBF16) static_cast<__nv_bfloat16*>(mel_out)[o] = __float2bfloat16_rn(v);
            else static_cast<float*>(mel_out)[o] = v;
            vmax = fmaxf(vmax, v);
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    if (lane == 0) red_s[warp] = vmax;
    __syncthreads();
    if (tid == 0) {
        float m = red_s[0];
        for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red_s[w]);
        float* dst = bmax + (size_t)b * gridDim.x + blockIdx.x;
        if (gridDim.z > 1) atomicMax(reinterpret_cast<int*>(dst), __float_as_int(m));
        else *dst = m;
    }
}

}  // namespace frontend
