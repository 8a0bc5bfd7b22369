// The end of the fused MFCC frontend for Hopper (sm_90a): mel -> dB with the
// top_db clip -> DCT-II. A plain C launcher, loaded with ctypes
// (modulation_mfcc_tpu_torch/kernels/_build.py); it returns the cudaError_t of
// its launch. True FP32 on the CUDA cores (FFMA, log10f; no fast-math
// intrinsics). The frontend kernels themselves, audio -> mel, run on the
// tensor cores (fused_frontend_tc.cu) and, folded, on the CUDA cores
// (fused_frontend_fold.cu).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "mbarrier.cuh"

namespace {

// ---------------------------------------------------------------------------
// mfcc_tail_f32
//
// Replaces the Pallas tail kernels of modulation_mfcc_tpu/pallas/
// fused_frontend.py (mfcc_tail -> _tail_kernel_t, coef-major, and
// _tail_kernel, frame-major).
//
// Computes out[b, c, f] (coef-major) or out[b, f, c] (frame-major) =
//   sum_m dct[m, c] * max(10*log10(max(mel[b, f, m], 1e-10)), peak[b] - 80),
// reading a float32 mel, or a bf16 one widened to float32 as the TPU tail
// reads the bf16 mode's mel (mel_ref[0].astype(f32)). The JAX tail runs the
// DCT at Precision.HIGHEST, which is FP32 here; the bar (1e-4 on MFCCs of
// order 10^2) leaves no room for a split or a fast log.
//
// Bound: device memory. It reads the mel tensor once (~393 MB for a
// 128 x 30 s batch at 16 kHz, half that in bf16) and writes 13 floats per
// frame (~40 MB): 0.129 ms at 3.35 TB/s. One log10f per element (98 M) and
// the DCT's 13 x 128 FFMA per frame issue in about as long, so the design
// keeps the loads in flight while it computes.
//
// Order of the sums: each coefficient is one FFMA chain over the mel bins
// in order, from zero, the order of the plain version's FP32 GEMM on the
// card, so the two agree to its 1e-4 bar (bit for bit on the card). A
// tree-ordered sum over the lanes lands nearer the float64 tail but parts
// from the plain version by more than that bar; chip_smoke.py phase 23
// prints what this order costs at the MFCC (the routes with the tail in
// float64).
//
// Design: a block of 4 warps walks tiles of kTailRows = 32 frames of one
// utterance (blocks take every gridDim.x-th tile; the grid is as many
// blocks as fit on the card at once). A tile is contiguous in the mel
// tensor, so one thread streams it with the bulk-copy engine into a ring
// of kTailStages shared-memory stages, each completing an mbarrier, so the
// next tiles land while this one is computed; one __syncthreads a tile
// returns its stage. Where a row of mel is not a multiple of 16 bytes, the
// threads copy the tile in themselves instead. A warp owns 8 frames of the
// tile. First its lanes spread the frames' log10f: lane l takes bins
// 4l .. 4l + 3 of each (one 16-byte, or 8-byte for bf16, load), clips them
// and stores the dB into a shared [32][132] tile (the transpose: a row's
// pitch puts the 8 rows a warp reads at once in distinct banks). Then lane
// (frame f, group g) forms coefficients 4g .. 4g + 3 of frame f as four
// chains over the bins, reading four dB at a time (one 16-byte load, the
// warp's 8 frames at 8 addresses) and the DCT matrix from shared memory
// (one 16-byte load a bin, 4 addresses). The sums go to a shared
// [32][NC + 1] tile (two, alternating), which the block writes out
// coalesced: along frames for coef-major, which is the layout the
// trajectory filters consume, along coefficients for frame-major.
// ---------------------------------------------------------------------------

constexpr int kTailWarps = 4;
constexpr int kTailThreads = 32 * kTailWarps;
constexpr int kTailRows = 32;            // frames a tile: 8 a warp
constexpr int kTailStages = 2;
constexpr int kMelMax = 128;             // mel bins: 4 a lane
constexpr int kDbPitch = kMelMax + 4;    // floats a row of the dB tile
constexpr int kMfccMax = 32;

static_assert(kTailRows == 8 * kTailWarps, "a warp owns 8 frames of a tile");

// four consecutive mel values of a row in shared memory (16-byte aligned for
// float32, 8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4])
{
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4])
{
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
}

// bytes of shared memory a block of mfcc_tail_kernel<M, NC> uses
template <typename M, int NC>
constexpr size_t tail_shared_bytes()
{
    return 128 + (size_t)kTailStages * kTailRows * kMelMax * sizeof(M) +
           sizeof(float) * ((size_t)kTailRows * kDbPitch + (size_t)kMelMax * NC + 2 * (size_t)kTailRows * (NC + 1));
}

template <typename M, int NC>
__global__ void __launch_bounds__(kTailThreads)
mfcc_tail_kernel(const M* __restrict__ mel, const float* __restrict__ peak, const float* __restrict__ dct,
                 float* __restrict__ out, int nf, int n_mels, int n_mfcc, int coef_major, int tiles_per_utt,
                 int n_tiles, int bulk)
{
    constexpr int G = NC / 4;         // lanes a frame in the DCT, four coefficients each
    constexpr int FP = 32 / G;        // frames a warp sums at once
    constexpr int kOutPitch = NC + 1;
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);                   // [kTailStages] tile barriers
    M* ring = reinterpret_cast<M*>(smem + 128);                           // kTailStages x [kTailRows][pitch]
    float* db = reinterpret_cast<float*>(ring + kTailStages * kTailRows * kMelMax);  // [kTailRows][kDbPitch]
    float* w_s = db + kTailRows * kDbPitch;                               // [kMelMax][NC] the DCT, zero-padded
    float* out_s = w_s + kMelMax * NC;                                    // 2 x [kTailRows][NC + 1]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int pitch = bulk ? n_mels : kMelMax;  // the stage's row pitch, in elements
    const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;

    for (int e = tid; e < kMelMax * NC; e += kTailThreads) {
        const int m = e / NC, c = e - m * NC;
        w_s[e] = (m < n_mels && c < n_mfcc) ? __ldg(dct + m * n_mfcc + c) : 0.0f;
    }
    auto tile_of = [&](int i, int& b, int& f0, int& rows) {  // the block's i-th tile
        const int q = (int)blockIdx.x + i * (int)gridDim.x;
        b = q / tiles_per_utt;
        f0 = (q - b * tiles_per_utt) * kTailRows;
        rows = min(kTailRows, nf - f0);
    };
    auto issue = [&](int i) {  // tile i -> its stage
        int b, f0, rows;
        tile_of(i, b, f0, rows);
        mbar::bulk_load(ring + (i % kTailStages) * kTailRows * kMelMax, mel + ((size_t)b * nf + f0) * n_mels,
                        (uint32_t)(rows * n_mels * sizeof(M)), full + i % kTailStages);
    };
    if (bulk && tid == 0) {
        for (int s = 0; s < kTailStages; ++s) mbar::init(full + s, 1);
        mbar::fence_init();
        for (int i = 0; i < kTailStages && i < my_tiles; ++i) issue(i);
    }
    __syncthreads();  // the barriers are initialised and the DCT matrix staged

    const int g = lane % G, fl = lane / G;
    for (int i = 0; i < my_tiles; ++i) {
        int b, f0, rows;
        tile_of(i, b, f0, rows);
        M* st = ring + (i % kTailStages) * kTailRows * kMelMax;
        if (bulk) {
            mbar::wait(full + i % kTailStages, (i / kTailStages) & 1);
        } else {
            const M* src = mel + ((size_t)b * nf + f0) * n_mels;
            for (int e = tid; e < rows * n_mels; e += kTailThreads) st[(e / n_mels) * kMelMax + e % n_mels] = src[e];
            __syncthreads();
        }
        const float floor_db = __ldg(peak + b) - 80.0f;
        // the dB of the warp's 8 frames, lane l bins 4l .. 4l + 3 (zero past n_mels and rows)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int r = 8 * warp + j;
            float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (r < rows && 4 * lane < n_mels) {
                float v[4];
                load4(st + r * pitch + 4 * lane, v);
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (4 * lane + k < n_mels) d[k] = fmaxf(10.0f * log10f(fmaxf(v[k], 1e-10f)), floor_db);
            }
            *reinterpret_cast<float4*>(db + r * kDbPitch + 4 * lane) = make_float4(d[0], d[1], d[2], d[3]);
        }
        __syncwarp();
        // the DCT of those frames: lane (fl, g) chains coefficients 4g .. 4g + 3 of frame 8 warp + FP p + fl
        float* o_s = out_s + (i & 1) * kTailRows * kOutPitch;
#pragma unroll
        for (int p = 0; p < 8 / FP; ++p) {
            const int r = 8 * warp + FP * p + fl;
            const float* drow = db + r * kDbPitch;
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int m0 = 0; m0 < n_mels; m0 += 4) {
                const float4 dv = *reinterpret_cast<const float4*>(drow + m0);
                const float d[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float4 wv = *reinterpret_cast<const float4*>(w_s + (m0 + k) * NC + 4 * g);
                    acc[0] = fmaf(d[k], wv.x, acc[0]);
                    acc[1] = fmaf(d[k], wv.y, acc[1]);
                    acc[2] = fmaf(d[k], wv.z, acc[2]);
                    acc[3] = fmaf(d[k], wv.w, acc[3]);
                }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (r < rows && 4 * g + q < n_mfcc) o_s[r * kOutPitch + 4 * g + q] = acc[q];
        }
        __syncthreads();  // the stage is read and the tile's sums are in o_s
        if (bulk && tid == 0 && i + kTailStages < my_tiles) issue(i + kTailStages);
        if (coef_major) {
            for (int e = tid; e < n_mfcc * kTailRows; e += kTailThreads) {
                const int c = e / kTailRows, r = e - c * kTailRows;
                if (r < rows) out[((size_t)b * n_mfcc + c) * nf + f0 + r] = o_s[r * kOutPitch + c];
            }
        } else {
            for (int e = tid; e < rows * n_mfcc; e += kTailThreads) {
                const int r = e / n_mfcc, c = e - r * n_mfcc;
                out[((size_t)b * nf + f0) * n_mfcc + e] = o_s[r * kOutPitch + c];
            }
        }
    }
}

template <typename M, int NC>
int launch_tail(const void* mel, const float* peak, const float* dct, float* out, int B, int nf, int n_mels,
                int n_mfcc, int coef_major, void* stream)
{
    const int bulk = (n_mels * (int)sizeof(M)) % 16 == 0 && reinterpret_cast<uintptr_t>(mel) % 16 == 0;
    constexpr size_t smem = tail_shared_bytes<M, NC>();
    cudaError_t err = cudaFuncSetAttribute(mfcc_tail_kernel<M, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev, n_sm, per_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mfcc_tail_kernel<M, NC>, kTailThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles_per_utt = (nf + kTailRows - 1) / kTailRows;
    const int n_tiles = B * tiles_per_utt;
    const int grid = min(n_tiles, n_sm * max(per_sm, 1));
    mfcc_tail_kernel<M, NC><<<grid, kTailThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const M*>(mel), peak, dct, out, nf, n_mels, n_mfcc, coef_major, tiles_per_utt, n_tiles, bulk);
    return (int)cudaGetLastError();
}

template <typename M>
int launch_tail(const void* mel, const float* peak, const float* dct, float* out, int B, int nf, int n_mels,
                int n_mfcc, int coef_major, void* stream)
{
    return n_mfcc <= 16 ? launch_tail<M, 16>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream)
                        : launch_tail<M, 32>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream);
}

}  // namespace

// mel [B, nf, n_mels] float32 or bf16 (mel_bf16), n_mels <= 128; peak [B]
// dB; dct [n_mels, n_mfcc], n_mfcc <= 32; out [B, n_mfcc, nf] (coef_major)
// or [B, nf, n_mfcc], float32
extern "C" int mfcc_tail_f32(const void* mel, int mel_bf16, const float* peak, const float* dct,
                             float* out, int B, int nf, int n_mels, int n_mfcc,
                             int coef_major, void* stream)
{
    if (B < 1 || nf < 1 || n_mels < 1 || n_mels > kMelMax || n_mfcc < 1 || n_mfcc > kMfccMax)
        return (int)cudaErrorInvalidValue;
    return mel_bf16 ? launch_tail<__nv_bfloat16>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream)
                    : launch_tail<float>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream);
}
