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
// Design: a block of 4 warps walks tiles of kTailRows frames of one
// utterance (32; 16 where a frame holds more than 128 mel bins, so that
// two blocks of 256 bins share an SM's shared memory) for one
// group of kTailCoefs coefficients (the grid's y; n_mfcc up to n_mels takes
// ceil(n_mfcc / 32) groups, each of which reads the tile and forms its dB
// again; blocks take every gridDim.x-th tile; the grid is as many blocks as
// fit on the card at once). A tile is contiguous in the mel
// tensor, so one thread streams it with the bulk-copy engine into a ring
// of kTailStages shared-memory stages, each completing an mbarrier, so the
// next tiles land while this one is computed; one __syncthreads a tile
// returns its stage. Where a row of mel is not a multiple of 16 bytes, the
// threads copy the tile in themselves instead. A warp owns a quarter of the
// tile's frames. First its lanes spread the frames' log10f: lane l takes bins
// 128 q + 4l .. + 3 of each (LB / 4 groups q; one 16-byte, or 8-byte for
// bf16, load each), clips them and stores the dB into a shared [rows][32 LB
// + 4] tile (the transpose: a row's pitch, 4 mod 32 words, puts the 8 rows a
// warp reads at once in distinct banks). Then lane (frame f, group g) forms
// coefficients 4g .. 4g + 3 of the block's group of frame f as four chains
// over the bins, reading four dB at a time (one 16-byte load, the warp's 8
// frames at 8 addresses) and the DCT matrix from shared memory (one 16-byte
// load a bin, 4 addresses). The sums go to a shared [rows][NC + 1] tile (two,
// alternating), which the block writes out coalesced: along frames for
// coef-major, which is the layout the trajectory filters consume, along
// coefficients for frame-major.
// ---------------------------------------------------------------------------

constexpr int kTailWarps = 4;
constexpr int kTailThreads = 32 * kTailWarps;
constexpr int kTailStages = 2;
constexpr int kTailMelLimit = 512;  // mel bins a launch takes: LB = 4, 8 or 16 a lane
constexpr int kTailCoefs = 32;      // coefficients of a group, the most a block sums

template <int LB> constexpr int kTailRows = LB == 4 ? 32 : 16;  // frames a tile
template <int LB> constexpr int kMelW = 32 * LB;                  // mel bins a row of the tile holds
template <int LB> constexpr int kDbPitch = kMelW<LB> + 4;         // floats a row of the dB tile

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

// bytes of shared memory a block of mfcc_tail_kernel<M, NC, LB> uses
template <typename M, int NC, int LB>
constexpr size_t tail_shared_bytes()
{
    constexpr size_t R = kTailRows<LB>;
    return 128 + (size_t)kTailStages * R * kMelW<LB> * sizeof(M) +
           sizeof(float) * (R * kDbPitch<LB> + (size_t)kMelW<LB> * NC + 2 * R * (NC + 1));
}

template <typename M, int NC, int LB>
__global__ void __launch_bounds__(kTailThreads)
mfcc_tail_kernel(const M* __restrict__ mel, const float* __restrict__ peak, const float* __restrict__ dct,
                 float* __restrict__ out, int nf, int n_mels, int n_mfcc, int coef_major, int tiles_per_utt,
                 int n_tiles, int bulk)
{
    constexpr int R = kTailRows<LB>;  // frames a tile
    constexpr int FW = R / kTailWarps;  // frames a warp
    constexpr int MW = kMelW<LB>;
    constexpr int DP = kDbPitch<LB>;
    constexpr int G = NC / 4;         // lanes a frame in the DCT, four coefficients each
    constexpr int FP = 32 / G;        // frames a warp sums at once
    constexpr int kOutPitch = NC + 1;
    static_assert(FW % FP == 0, "a warp's frames are whole passes of the DCT");
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);                   // [kTailStages] tile barriers
    M* ring = reinterpret_cast<M*>(smem + 128);                           // kTailStages x [R][pitch]
    float* db = reinterpret_cast<float*>(ring + kTailStages * R * MW);    // [R][DP]
    float* w_s = db + R * DP;                                             // [MW][NC] the group's DCT, zero-padded
    float* out_s = w_s + MW * NC;                                         // 2 x [R][NC + 1]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int c0 = NC * (int)blockIdx.y;  // the group's first coefficient
    const int nc = min(NC, n_mfcc - c0);  // and its count
    const int pitch = bulk ? n_mels : MW;  // the stage's row pitch, in elements
    const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;

    for (int e = tid; e < MW * NC; e += kTailThreads) {
        const int m = e / NC, c = e - m * NC;
        w_s[e] = (m < n_mels && c < nc) ? __ldg(dct + m * n_mfcc + c0 + c) : 0.0f;
    }
    auto tile_of = [&](int i, int& b, int& f0, int& rows) {  // the block's i-th tile
        const int q = (int)blockIdx.x + i * (int)gridDim.x;
        b = q / tiles_per_utt;
        f0 = (q - b * tiles_per_utt) * R;
        rows = min(R, nf - f0);
    };
    auto issue = [&](int i) {  // tile i -> its stage
        int b, f0, rows;
        tile_of(i, b, f0, rows);
        mbar::bulk_load(ring + (i % kTailStages) * R * MW, mel + ((size_t)b * nf + f0) * n_mels,
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
        M* st = ring + (i % kTailStages) * R * MW;
        if (bulk) {
            mbar::wait(full + i % kTailStages, (i / kTailStages) & 1);
        } else {
            const M* src = mel + ((size_t)b * nf + f0) * n_mels;
            for (int e = tid; e < rows * n_mels; e += kTailThreads) st[(e / n_mels) * MW + e % n_mels] = src[e];
            __syncthreads();
        }
        const float floor_db = __ldg(peak + b) - 80.0f;
        // the dB of the warp's frames, lane l bins 128 q + 4l .. + 3 (zero past n_mels and rows)
#pragma unroll
        for (int j = 0; j < FW; ++j) {
            const int r = FW * warp + j;
#pragma unroll
            for (int q = 0; q < LB / 4; ++q) {
                const int m = 128 * q + 4 * lane;
                float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                if (r < rows && m < n_mels) {
                    float v[4];
                    load4(st + r * pitch + m, v);
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        if (m + k < n_mels) d[k] = fmaxf(10.0f * log10f(fmaxf(v[k], 1e-10f)), floor_db);
                }
                *reinterpret_cast<float4*>(db + r * DP + m) = make_float4(d[0], d[1], d[2], d[3]);
            }
        }
        __syncwarp();
        // the DCT of those frames: lane (fl, g) chains coefficients c0 + 4g .. + 3 of frame FW warp + FP p + fl
        float* o_s = out_s + (i & 1) * R * kOutPitch;
#pragma unroll
        for (int p = 0; p < FW / FP; ++p) {
            const int r = FW * warp + FP * p + fl;
            const float* drow = db + r * DP;
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
                if (r < rows && 4 * g + q < nc) o_s[r * kOutPitch + 4 * g + q] = acc[q];
        }
        __syncthreads();  // the stage is read and the tile's sums are in o_s
        if (bulk && tid == 0 && i + kTailStages < my_tiles) issue(i + kTailStages);
        if (coef_major) {
            for (int e = tid; e < nc * R; e += kTailThreads) {
                const int c = e / R, r = e - c * R;
                if (r < rows) out[((size_t)b * n_mfcc + c0 + c) * nf + f0 + r] = o_s[r * kOutPitch + c];
            }
        } else {
            for (int e = tid; e < rows * nc; e += kTailThreads) {
                const int r = e / nc, c = e - r * nc;
                out[((size_t)b * nf + f0 + r) * n_mfcc + c0 + c] = o_s[r * kOutPitch + c];
            }
        }
    }
}

template <typename M, int NC, int LB>
int launch_tail(const void* mel, const float* peak, const float* dct, float* out, int B, int nf, int n_mels,
                int n_mfcc, int coef_major, void* stream)
{
    const int bulk = (n_mels * (int)sizeof(M)) % 16 == 0 && reinterpret_cast<uintptr_t>(mel) % 16 == 0;
    constexpr size_t smem = tail_shared_bytes<M, NC, LB>();
    cudaError_t err = cudaFuncSetAttribute(mfcc_tail_kernel<M, NC, LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev, n_sm, per_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mfcc_tail_kernel<M, NC, LB>, kTailThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles_per_utt = (nf + kTailRows<LB> - 1) / kTailRows<LB>;
    const int n_tiles = B * tiles_per_utt;
    const int groups = (n_mfcc + NC - 1) / NC;
    const int grid = min(n_tiles, max(n_sm * max(per_sm, 1) / groups, 1));
    mfcc_tail_kernel<M, NC, LB><<<dim3(grid, groups), kTailThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const M*>(mel), peak, dct, out, nf, n_mels, n_mfcc, coef_major, tiles_per_utt, n_tiles, bulk);
    return (int)cudaGetLastError();
}

template <typename M, int LB>
int launch_tail(const void* mel, const float* peak, const float* dct, float* out, int B, int nf, int n_mels,
                int n_mfcc, int coef_major, void* stream)
{
    // 16 coefficients a group where they fit a pass of the DCT (LB = 4: 8 frames a warp)
    if constexpr (LB == 4)
        if (n_mfcc <= 16) return launch_tail<M, 16, LB>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream);
    return launch_tail<M, kTailCoefs, LB>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream);
}

template <typename M>
int launch_tail(const void* mel, const float* peak, const float* dct, float* out, int B, int nf, int n_mels,
                int n_mfcc, int coef_major, void* stream)
{
    if (n_mels <= 128) return launch_tail<M, 4>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream);
    if (n_mels <= 256) return launch_tail<M, 8>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream);
    return launch_tail<M, 16>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream);
}

}  // namespace

// mel [B, nf, n_mels] float32 or bf16 (mel_bf16), n_mels <= 512; peak [B]
// dB; dct [n_mels, n_mfcc], n_mfcc <= n_mels; out [B, n_mfcc, nf]
// (coef_major) or [B, nf, n_mfcc], float32
extern "C" int mfcc_tail_f32(const void* mel, int mel_bf16, const float* peak, const float* dct,
                             float* out, int B, int nf, int n_mels, int n_mfcc,
                             int coef_major, void* stream)
{
    if (B < 1 || nf < 1 || n_mels < 1 || n_mels > kTailMelLimit || n_mfcc < 1 || n_mfcc > n_mels)
        return (int)cudaErrorInvalidValue;
    return mel_bf16 ? launch_tail<__nv_bfloat16>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream)
                    : launch_tail<float>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream);
}
