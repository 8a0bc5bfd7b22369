// Folded fused MFCC frontend for Hopper (sm_90a), bf16 mode: audio -> mel
// power through the folded real DFT. A plain C launcher, loaded with ctypes
// (modulation_mfcc_tpu_torch/kernels/_build.py); it returns the cudaError_t
// of its launch. All arithmetic runs on the CUDA cores (FFMA, no tensor
// cores, no fast-math intrinsics). The f32 and x3 folds run on the tensor
// cores (fused_frontend_fold_tc.cu).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// fused_mel_fold_bf16
//
// Replaces the Pallas folded frontend of modulation_mfcc_tpu/pallas/
// fused_frontend.py (fused_mel_frontend(fold=True) -> _folded_frontend ->
// pallas_call at :1096, body _fold_kernel), algorithm 'bf16'.
//
// The periodic Hann window of the trimmed support (sup samples, even) is
// symmetric about sup/2, so the windowed real DFT of a frame folds: with a
// the frame's first support sample (x[b, f*hop + off], zero outside the
// buffer) and u in [0, K), K = sup/2 + 1,
//   s[u] = x[a + u] + x[a + sup - u],   d[u] = x[a + u] - x[a + sup - u]
//   re   = s @ wc                      ([K] x [K, bins_pad])
//   im   = d @ ws                      ([K] x [K, im_cols]; zero beyond)
//   mel  = (re^2 + im^2) @ melw        ([bins_pad] x [bins_pad, n_mels])
// wc and ws carry the window (its u = sup/2 row halved, the sine row there
// zero; the u = 0 rows are zero, since the periodic Hann is zero there), and
// when every bin is live the Nyquist cosine column rides wc's dead DC
// column. Each block writes the max of mel over its valid frames (< nf).
// The power is re^2 + im^2 with each product and the sum rounded to nearest
// (no FMA), as the plain version computes it.
//
// The samples are rounded to bf16 as they are staged (the TPU path rounds
// the audio before the fold), s and d summed in FP32 and rounded to bf16 for
// the products; wc, ws and melw arrive rounded. Each DFT sum and each mel
// sum is one FFMA chain in row order, the order of the plain version's FP32
// GEMMs (cuBLAS's FFMA kernels on the H100): the power, rounded to bf16,
// then matches the plain version's bit for bit, where the tensor cores'
// sums, in any order tried, moved a mel band across a power of two, two
// bf16 steps (3 of its ulps) from the plain version (PERF.md §6). The mel
// is stored as bf16, the block max taken over the FP32 mel.
//
// Bound: FFMA throughput on the CUDA cores. A 128 x 30 s batch at 16 kHz
// (sup 400, 256 live bins) is 158 GFLOP of folded DFT (half the unfolded
// 315) and 50 GFLOP of mel: about 3.1 ms at 67 TFLOP/s.
//
// Design: a block owns 64 consecutive frames of one utterance and copies
// the contiguous span they cover, (64 - 1)*hop + sup + 1 samples, into
// shared memory once, as bf16 (its samples are bf16 values): both ends of
// every frame's fold are read from there, so the design needs no second
// (reversed) input stream, which the TPU kernel streams from a lane-flipped
// copy of the audio. The u = 0 term reads x[a + sup], one sample past the
// support; it is inside the staged span (the span's global reads are zero
// past the buffer's end), so the last frame of the last block stays in
// bounds. Per step of 16 contraction rows the block stages the s and d
// slices ([u][frame], transposed) from the span and the wc and ws columns of
// its bin tile (cp.async, double-buffered); a thread keeps an 8-frame by
// 4-bin tile of re and im of a 128-bin tile in registers, two blocks an SM.
// The block fits the 227 KB of shared memory up to spans of 79,104 samples
// (hop 1,200 with a 2,400-sample window). Power, mel and the block max are
// projected and reduced by project_tile and write_block below.
// ---------------------------------------------------------------------------

// The block geometry: a block owns kBF consecutive frames of one utterance;
// warp w owns frames 4w..4w+3 and 32+4w..32+4w+3, lane l the bins (and mel
// columns) l + 32j of a tile.
constexpr int kBF = 64;        // frames per block
constexpr int kBT = 128;       // DFT bins per tile (re and im columns each)
constexpr int kKC = 16;        // contraction rows staged per step
constexpr int kMelMax = 128;   // mel columns a block holds: a group (the grid's z)
constexpr int kMelLimit = 512; // mel columns a launch takes: up to four groups
constexpr int kThreads = 256;
constexpr int kSharedMax = 232448;  // bytes of shared memory a block may use on the H100
constexpr int kPitch = kBF + 4;  // row pitch of the [k][frame] and [bin][frame] tiles: 16-byte rows, few bank conflicts

constexpr int kTileSlice = kKC * 2 * kBT;  // floats of one staged basis slice

__device__ __forceinline__ int owned_frame(int warp, int i) { return (i < 4 ? 0 : 28) + 4 * warp + i; }

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// 16-byte global -> shared copy that bypasses registers; zero-fills when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

// The end of bin tile bt, of TB = 32 NJ bins: the thread's re and im sums
// -> power rounded to bf16, written transposed ([bin][frame]) to
// p_s, which may share space with the staged slices; then the power tile
// projected onto melw's rows bt..bt+TB-1, columns c0..c0+127 (the block's
// mel group), into the [kBF][kMelMax] accumulator mel_s, in bin order.
template <int NJ>
__device__ __forceinline__ void project_tile(const float (&re)[8][NJ], const float (&im)[8][NJ], float* p_s,
                                             float* mel_s, const float* __restrict__ melw, int bt, int n_mels,
                                             int c0, int lane, int warp)
{
    constexpr int TB = 32 * NJ;
    __syncthreads();  // every warp is done with the slices the power tile overwrites
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        float pw[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float v = __fadd_rn(__fmul_rn(re[i][j], re[i][j]), __fmul_rn(im[i][j], im[i][j]));
            pw[i] = bf16r(v);
        }
        float* row = p_s + (lane + 32 * j) * kPitch + 4 * warp;
        *reinterpret_cast<float4*>(row) = make_float4(pw[0], pw[1], pw[2], pw[3]);
        *reinterpret_cast<float4*>(row + 32) = make_float4(pw[4], pw[5], pw[6], pw[7]);
    }
    __syncthreads();

    // each thread owns mel_s entries (its 8 frames, mel lane + 32j)
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = mel_s[owned_frame(warp, i) * kMelMax + lane + 32 * j];
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
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], mw[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mel_s[owned_frame(warp, i) * kMelMax + lane + 32 * j] = acc[i][j];
}

// The end of a block: its valid frames (< nf) of the mel accumulator to
// mel_out [B, nf, n_mels] columns c0.. (bf16, rounded to nearest even), and
// the max over them to bmax[b, blockIdx.x] (mel >= 0, so 0 is neutral):
// stored with one mel group, else merged by atomicMax on the bits (which
// order as the values for non-negative floats) into a zeroed bmax.
// red_s: kThreads/32 floats.
__device__ __forceinline__ void write_block(const float* mel_s, __nv_bfloat16* __restrict__ mel_out,
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
            const float v = mel_s[f * kMelMax + m];
            const size_t o = ((size_t)b * nf + f0 + f) * n_mels + c0 + m;
            mel_out[o] = __float2bfloat16_rn(v);
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

// floats of the space the basis slices, the s and d slices and the power tile share
__host__ __device__ constexpr int shared_floats()
{
    const int stage = 2 * kTileSlice + 2 * kKC * kPitch;  // two steps of slices + s and d
    const int power = kBT * kPitch;
    return stage > power ? stage : power;
}

// bytes of a launch's shared memory: that space, the mel accumulator and the
// staged span (span_pad bf16 samples)
__host__ __device__ constexpr long long shared_bytes(int span_pad)
{
    return 4LL * (shared_floats() + kBF * kMelMax) + 2LL * span_pad;
}

// rows [k0, k0 + kKC) of the TB-bin tile's wc and ws columns -> w_dst
// (cosine columns first), one commit group. Rows past K and sine tiles at
// or past im_cols are zero-filled.
template <int TB>
__device__ __forceinline__ void stage_basis(float* w_dst, const float* __restrict__ wc, const float* __restrict__ ws,
                                            int k0, int K, int bt, int bins_pad, int im_cols, int tid)
{
    for (int i = tid; i < kKC * 2 * TB / 4; i += kThreads) {
        const int kk = i / (2 * TB / 4);
        const int c = (i % (2 * TB / 4)) * 4;
        const int k = k0 + kk;
        const int kr = k < K ? k : 0;
        const float* src;
        bool valid = k < K;
        if (c < TB) {
            src = wc + (size_t)kr * bins_pad + bt + c;
        } else {
            valid = valid && bt < im_cols;
            src = ws + (size_t)kr * im_cols + (bt < im_cols ? bt : 0) + (c - TB);
        }
        cp_async16(w_dst + kk * 2 * TB + c, src, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, 2)
fused_mel_fold_kernel(const float* __restrict__ audio, const float* __restrict__ wc, const float* __restrict__ ws,
                      const float* __restrict__ melw, __nv_bfloat16* __restrict__ mel_out, float* __restrict__ bmax,
                      int T, int K, int sup, int hop, int off, int nf, int bins_pad, int im_cols, int n_mels,
                      int span_pad)
{
    constexpr int TB = kBT, NJ = TB / 32, kSl = kTileSlice;
    constexpr int kShared = shared_floats();
    extern __shared__ __align__(16) float smem[];
    float* w_s = smem;                         // 2 steps x [kKC][2*TB] basis slices
    float* s_s = w_s + 2 * kSl;                // [kKC][kPitch] s slice, transposed
    float* d_s = s_s + kKC * kPitch;           // [kKC][kPitch] d slice, transposed
    float* p_s = w_s;                          // [TB][kPitch] power tile, transposed
    float* mel_s = w_s + kShared;              // [kBF][kMelMax] mel accumulator
    auto* span_s = reinterpret_cast<__nv_bfloat16*>(mel_s + kBF * kMelMax);  // [span_pad] audio samples
    __shared__ float red_s[kThreads / 32];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * kBF;
    const float* x = audio + (size_t)b * T;
    const int n_steps = (K + kKC - 1) / kKC;

    // the span, u = 0's sample past the last frame's support included
    const long long start = (long long)f0 * hop + off;
    for (int i = tid; i < span_pad; i += kThreads) {
        const long long s = start + i;
        const float v = (s >= 0 && s < T) ? x[s] : 0.0f;
        span_s[i] = __float2bfloat16_rn(v);
    }
    for (int i = tid; i < kBF * kMelMax; i += kThreads) mel_s[i] = 0.0f;

    for (int bt = 0; bt < bins_pad; bt += TB) {
        float re[8][NJ] = {}, im[8][NJ] = {};

        __syncthreads();  // the previous tile's power (same space) fully read
        stage_basis<TB>(w_s, wc, ws, 0, K, bt, bins_pad, im_cols, tid);
        for (int step = 0; step < n_steps; ++step) {
            const int k0 = step * kKC;
            __syncthreads();  // the previous step's slices fully read
            if (step + 1 < n_steps)
                stage_basis<TB>(w_s + ((step + 1) & 1) * kSl, wc, ws, k0 + kKC, K, bt, bins_pad, im_cols, tid);
            for (int i = tid; i < kKC * kBF; i += kThreads) {
                const int kk = i % kKC;
                const int f = i / kKC;
                const int u = k0 + kk;
                float sv = 0.0f, dv = 0.0f;  // rows past K meet zero weights
                if (u < K) {
                    const float lo = __bfloat162float(span_s[f * hop + u]);
                    const float hi = __bfloat162float(span_s[f * hop + sup - u]);
                    sv = __fadd_rn(lo, hi);
                    dv = __fsub_rn(lo, hi);
                }
                s_s[kk * kPitch + f] = bf16r(sv);
                d_s[kk * kPitch + f] = bf16r(dv);
            }
            if (step + 1 < n_steps) asm volatile("cp.async.wait_group 1;\n" ::);
            else asm volatile("cp.async.wait_group 0;\n" ::);
            __syncthreads();
            const float* w_cur = w_s + (step & 1) * kSl;
            // re and im: one FFMA chain each, in row order
#pragma unroll
            for (int kk = 0; kk < kKC; ++kk) {
                const float4 s_lo = *reinterpret_cast<const float4*>(s_s + kk * kPitch + 4 * warp);
                const float4 s_hi = *reinterpret_cast<const float4*>(s_s + kk * kPitch + 32 + 4 * warp);
                const float4 d_lo = *reinterpret_cast<const float4*>(d_s + kk * kPitch + 4 * warp);
                const float4 d_hi = *reinterpret_cast<const float4*>(d_s + kk * kPitch + 32 + 4 * warp);
                const float a[8] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w, s_hi.x, s_hi.y, s_hi.z, s_hi.w};
                const float e[8] = {d_lo.x, d_lo.y, d_lo.z, d_lo.w, d_hi.x, d_hi.y, d_hi.z, d_hi.w};
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const float wr = w_cur[kk * 2 * TB + lane + 32 * j];
                    const float wi = w_cur[kk * 2 * TB + TB + lane + 32 * j];
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        re[i][j] = fmaf(a[i], wr, re[i][j]);
                        im[i][j] = fmaf(e[i], wi, im[i][j]);
                    }
                }
            }
        }

        project_tile<NJ>(re, im, p_s, mel_s, melw, bt, n_mels, kMelMax * (int)blockIdx.z, lane, warp);
    }
    write_block(mel_s, mel_out, bmax, red_s, b, f0, nf, n_mels, kMelMax * (int)blockIdx.z, tid, lane, warp);
}

}  // namespace

// wc [K, bins_pad], ws [K, im_cols], melw [bins_pad, n_mels], bf16-rounded
// values held as float32, n_mels <= 512 (groups of 128 columns, the grid's
// z; bmax zeroed where there are more than one); mel bf16
extern "C" int fused_mel_fold_bf16(const float* audio, const float* wc, const float* ws, const float* melw,
                                   __nv_bfloat16* mel, float* bmax, int B, int T, int K, int sup, int hop, int off,
                                   int nf, int bins_pad, int im_cols, int n_mels, void* stream)
{
    if (B < 1 || T < 1 || nf < 1 || hop < 1 || sup < 2 || sup % 2 || K != sup / 2 + 1 || n_mels < 1 ||
        n_mels > kMelLimit || bins_pad < kBT || bins_pad % kBT || im_cols < kBT || im_cols % kBT ||
        im_cols > bins_pad)
        return (int)cudaErrorInvalidValue;
    const int n_blocks = (nf + kBF - 1) / kBF;
    const int span = (kBF - 1) * hop + sup + 1;  // + 1: u = 0 reads one sample past the support
    const int span_pad = (span + 3) / 4 * 4;
    const long long smem = shared_bytes(span_pad);
    if (smem > kSharedMax) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(fused_mel_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_mel_fold_kernel<<<dim3(n_blocks, B, (n_mels + kMelMax - 1) / kMelMax), kThreads, smem,
                            (cudaStream_t)stream>>>(audio, wc, ws, melw, mel, bmax, T, K, sup, hop, off, nf,
                                                    bins_pad, im_cols, n_mels, span_pad);
    return (int)cudaGetLastError();
}
