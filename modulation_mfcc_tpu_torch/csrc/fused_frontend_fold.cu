// Folded fused MFCC frontend for Hopper (sm_90a): audio -> mel power through
// the folded real DFT. Plain C launchers, loaded with ctypes
// (modulation_mfcc_tpu_torch/kernels/_build.py); each returns the
// cudaError_t of its launch. All arithmetic runs on the CUDA cores (FFMA, no
// tensor cores, no fast-math intrinsics).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_frontend_common.cuh"

namespace {

using namespace frontend;

// ---------------------------------------------------------------------------
// fused_mel_fold_f32, fused_mel_fold_bf16, fused_mel_fold_x3
//
// Replace the Pallas folded frontend of modulation_mfcc_tpu/pallas/
// fused_frontend.py (fused_mel_frontend(fold=True) -> _folded_frontend ->
// pallas_call at :1096, body _fold_kernel), algorithms 'f32', 'bf16' and
// 'x3'.
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
//
//   'f32':  FP32 throughout; the DFT sums in steps of kKC = 16 rows, each
//           step's products into a fresh partial sum that is then added to
//           the running one, as the plain version does (_stepped_matmul).
//   'bf16': samples rounded to bf16 as they are staged (the TPU path rounds
//           the audio before the fold), s and d summed in FP32 and rounded to
//           bf16 again for the products; power rounded to bf16; wc, ws and
//           melw arrive rounded; mel stored as bf16, the block max taken over
//           the FP32 mel.
//   'x3':   s, d and the power split into bf16 (hi, lo); wc, ws and melw
//           arrive as [2, ...] (hi, lo) stacks; hi*hi products in one FP32
//           sum, hi*lo + lo*hi in another (as fused_mel_x3).
//
// Bound: FFMA throughput on the CUDA cores (FP32), the bf16 tensor core for
// 'bf16' and 'x3', the units the modes' arithmetic is made for. A 128 x 30 s
// batch at 16 kHz (sup 400, 256 live bins) is 158 GFLOP of folded DFT
// (half the unfolded 315) and 50 GFLOP of mel: about 3.1 ms at 67 TFLOP/s;
// this kernel runs 'bf16' and 'x3' on the CUDA cores too.
//
// Design: the FFMA design fused_mel_f32 had before it moved to the tensor
// cores (fused_frontend_tc.cu). A block owns 64
// consecutive frames of one utterance and copies the contiguous span they
// cover, (64 - 1)*hop + sup + 1 samples, into shared memory once: both ends
// of every frame's fold are read from there, so the design needs no second
// (reversed) input stream, which the TPU kernel streams from a lane-flipped
// copy of the audio. The u = 0 term reads x[a + sup], one sample past the
// support; it is inside the staged span (the span's global reads are zero
// past the buffer's end), so the last frame of the last block stays in
// bounds. Per step of 16 contraction rows the block stages the s and d
// slices ([u][frame], transposed) from the span and the wc and ws columns of
// its bin tile (cp.async, double-buffered); a thread keeps an 8-frame by
// 4-bin tile of re and im of a 128-bin tile in registers, or for f32, which
// adds the step's partial sums, 8 frames by 2 bins of a 64-bin tile (two
// blocks an SM). Power, mel and the block max are projected and reduced
// as fused_frontend_common.cuh's project_tile and write_block do.
// ---------------------------------------------------------------------------

// floats of the space the basis slices, the s and d slices and the power tile share
template <int MODE>
__host__ __device__ constexpr int shared_floats()
{
    const int planes = MODE == kX3 ? 2 : 1;
    const int stage = 2 * planes * kTileSlice<MODE> + 2 * planes * kKC * kPitch;  // two steps of slices + s and d
    const int power = planes * kTile<MODE> * kPitch;
    return stage > power ? stage : power;
}

// rows [k0, k0 + kKC) of the TB-bin tile's wc and ws columns of each plane
// -> w_dst (plane p at w_dst + p * kKC * 2 * TB; cosine columns first), one
// commit group. Rows past K and sine tiles at or past im_cols are zero-filled.
template <int PLANES, int TB>
__device__ __forceinline__ void stage_basis(float* w_dst, const float* __restrict__ wc,
                                            const float* __restrict__ ws, int k0, int K, int bt,
                                            int bins_pad, int im_cols, int tid)
{
    constexpr int slice = kKC * 2 * TB;
    for (int i = tid; i < PLANES * slice / 4; i += kThreads) {
        const int p = i / (slice / 4);
        const int r = i % (slice / 4);
        const int kk = r / (2 * TB / 4);
        const int c = (r % (2 * TB / 4)) * 4;
        const int k = k0 + kk;
        const int kr = k < K ? k : 0;
        const float* src;
        bool valid = k < K;
        if (c < TB) {
            src = wc + ((size_t)p * K + kr) * bins_pad + bt + c;
        } else {
            valid = valid && bt < im_cols;
            src = ws + ((size_t)p * K + kr) * im_cols + (bt < im_cols ? bt : 0) + (c - TB);
        }
        cp_async16(w_dst + p * slice + kk * 2 * TB + c, src, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, MODE == kX3 ? 1 : 2)
fused_mel_fold_kernel(const float* __restrict__ audio, const float* __restrict__ wc,
                      const float* __restrict__ ws, const float* __restrict__ melw,
                      void* __restrict__ mel_out, float* __restrict__ bmax, int T, int K, int sup,
                      int hop, int off, int nf, int bins_pad, int im_cols, int n_mels, int span_pad)
{
    constexpr int P = MODE == kX3 ? 2 : 1;  // planes per operand: (hi, lo) for x3
    constexpr int TB = kTile<MODE>, NJ = TB / 32, kSl = kTileSlice<MODE>;
    constexpr int kShared = shared_floats<MODE>();
    extern __shared__ __align__(16) float smem[];
    float* span_s = smem;                      // [span_pad] audio samples
    float* w_s = span_s + span_pad;            // 2 steps x P planes x [kKC][2*TB] basis slices
    float* s_s = w_s + 2 * P * kSl;            // P x [kKC][kPitch] s slice, transposed
    float* d_s = s_s + P * kKC * kPitch;       // P x [kKC][kPitch] d slice, transposed
    float* p_s = w_s;                          // P x [TB][kPitch] power tile, transposed
    float* mel_s = w_s + kShared;              // [kBF][kMelMax] mel accumulator
    float* mel2_s = mel_s + kBF * kMelMax;     // x3: [kBF][kMelMax] accumulator of the small products
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
        span_s[i] = MODE == kBF16 ? bf16r(v) : v;
    }
    for (int i = tid; i < P * kBF * kMelMax; i += kThreads) mel_s[i] = 0.0f;

    for (int bt = 0; bt < bins_pad; bt += TB) {
        float re[8][NJ] = {}, im[8][NJ] = {};    // the (hi*hi) products
        float res[8][NJ] = {}, ims[8][NJ] = {};  // x3: the hi*lo and lo*hi products

        __syncthreads();  // the previous tile's power (same space) fully read
        stage_basis<P, TB>(w_s, wc, ws, 0, K, bt, bins_pad, im_cols, tid);
        for (int step = 0; step < n_steps; ++step) {
            const int k0 = step * kKC;
            __syncthreads();  // the previous step's slices fully read
            if (step + 1 < n_steps)
                stage_basis<P, TB>(w_s + ((step + 1) & 1) * P * kSl, wc, ws, k0 + kKC, K, bt, bins_pad, im_cols, tid);
            for (int i = tid; i < kKC * kBF; i += kThreads) {
                const int kk = i % kKC;
                const int f = i / kKC;
                const int u = k0 + kk;
                float sv = 0.0f, dv = 0.0f;  // rows past K meet zero weights
                if (u < K) {
                    const float lo = span_s[f * hop + u];
                    const float hi = span_s[f * hop + sup - u];
                    sv = __fadd_rn(lo, hi);
                    dv = __fsub_rn(lo, hi);
                }
                const int o = kk * kPitch + f;
                if constexpr (MODE == kX3) {
                    const float sh = bf16r(sv), dh = bf16r(dv);
                    s_s[o] = sh;
                    s_s[kKC * kPitch + o] = bf16r(sv - sh);
                    d_s[o] = dh;
                    d_s[kKC * kPitch + o] = bf16r(dv - dh);
                } else if constexpr (MODE == kBF16) {
                    s_s[o] = bf16r(sv);
                    d_s[o] = bf16r(dv);
                } else {
                    s_s[o] = sv;
                    d_s[o] = dv;
                }
            }
            if (step + 1 < n_steps) asm volatile("cp.async.wait_group 1;\n" ::);
            else asm volatile("cp.async.wait_group 0;\n" ::);
            __syncthreads();
            const float* w_cur = w_s + (step & 1) * P * kSl;
            if constexpr (MODE == kF32) {
                // the step's own partial sums, added to re/im after the step
                float pre[8][NJ] = {}, pim[8][NJ] = {};
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
                            pre[i][j] = fmaf(a[i], wr, pre[i][j]);
                            pim[i][j] = fmaf(e[i], wi, pim[i][j]);
                        }
                    }
                }
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < NJ; ++j) {
                        re[i][j] += pre[i][j];
                        im[i][j] += pim[i][j];
                    }
            } else {
#pragma unroll
                for (int kk = 0; kk < kKC; ++kk) {
                    const float4 s_lo = *reinterpret_cast<const float4*>(s_s + kk * kPitch + 4 * warp);
                    const float4 s_hi = *reinterpret_cast<const float4*>(s_s + kk * kPitch + 32 + 4 * warp);
                    const float4 d_lo = *reinterpret_cast<const float4*>(d_s + kk * kPitch + 4 * warp);
                    const float4 d_hi = *reinterpret_cast<const float4*>(d_s + kk * kPitch + 32 + 4 * warp);
                    const float a[8] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w, s_hi.x, s_hi.y, s_hi.z, s_hi.w};
                    const float e[8] = {d_lo.x, d_lo.y, d_lo.z, d_lo.w, d_hi.x, d_hi.y, d_hi.z, d_hi.w};
                    float wr[NJ], wi[NJ];
#pragma unroll
                    for (int j = 0; j < NJ; ++j) {
                        wr[j] = w_cur[kk * 2 * TB + lane + 32 * j];
                        wi[j] = w_cur[kk * 2 * TB + TB + lane + 32 * j];
                    }
                    if constexpr (MODE == kX3) {
                        const float* s2 = s_s + kKC * kPitch + kk * kPitch;
                        const float* d2 = d_s + kKC * kPitch + kk * kPitch;
                        const float4 sl_lo = *reinterpret_cast<const float4*>(s2 + 4 * warp);
                        const float4 sl_hi = *reinterpret_cast<const float4*>(s2 + 32 + 4 * warp);
                        const float4 dl_lo = *reinterpret_cast<const float4*>(d2 + 4 * warp);
                        const float4 dl_hi = *reinterpret_cast<const float4*>(d2 + 32 + 4 * warp);
                        const float al[8] = {sl_lo.x, sl_lo.y, sl_lo.z, sl_lo.w, sl_hi.x, sl_hi.y, sl_hi.z, sl_hi.w};
                        const float el[8] = {dl_lo.x, dl_lo.y, dl_lo.z, dl_lo.w, dl_hi.x, dl_hi.y, dl_hi.z, dl_hi.w};
                        float wrl[NJ], wil[NJ];
#pragma unroll
                        for (int j = 0; j < NJ; ++j) {
                            wrl[j] = w_cur[kSl + kk * 2 * TB + lane + 32 * j];
                            wil[j] = w_cur[kSl + kk * 2 * TB + TB + lane + 32 * j];
                        }
#pragma unroll
                        for (int i = 0; i < 8; ++i)
#pragma unroll
                            for (int j = 0; j < NJ; ++j) {
                                re[i][j] = fmaf(a[i], wr[j], re[i][j]);
                                res[i][j] = fmaf(a[i], wrl[j], res[i][j]);
                                res[i][j] = fmaf(al[i], wr[j], res[i][j]);
                                im[i][j] = fmaf(e[i], wi[j], im[i][j]);
                                ims[i][j] = fmaf(e[i], wil[j], ims[i][j]);
                                ims[i][j] = fmaf(el[i], wi[j], ims[i][j]);
                            }
                    } else {
#pragma unroll
                        for (int i = 0; i < 8; ++i)
#pragma unroll
                            for (int j = 0; j < NJ; ++j) {
                                re[i][j] = fmaf(a[i], wr[j], re[i][j]);
                                im[i][j] = fmaf(e[i], wi[j], im[i][j]);
                            }
                    }
                }
            }
        }

        project_tile<MODE, NJ>(re, im, res, ims, p_s, mel_s, mel2_s, melw, bt, bins_pad, n_mels, kMelMax * (int)blockIdx.z,
                               lane, warp);
    }
    write_block<MODE>(mel_s, mel2_s, mel_out, bmax, red_s, b, f0, nf, n_mels, kMelMax * (int)blockIdx.z, tid, lane, warp);
}

template <int MODE>
int launch_fold(const float* audio, const float* wc, const float* ws, const float* melw, void* mel, float* bmax,
                int B, int T, int K, int sup, int hop, int off, int nf, int bins_pad, int im_cols, int n_mels,
                void* stream)
{
    if (B < 1 || T < 1 || nf < 1 || hop < 1 || sup < 2 || sup % 2 || K != sup / 2 + 1 || n_mels < 1 ||
        n_mels > kMelLimit || bins_pad < kBT || bins_pad % kBT || im_cols < kBT || im_cols % kBT ||
        im_cols > bins_pad)
        return (int)cudaErrorInvalidValue;
    const int n_blocks = (nf + kBF - 1) / kBF;
    const int span = (kBF - 1) * hop + sup + 1;  // + 1: u = 0 reads one sample past the support
    const int span_pad = (span + 3) / 4 * 4;
    const size_t smem = sizeof(float) * ((size_t)span_pad + shared_floats<MODE>() + (MODE == kX3 ? 2 : 1) * kBF * kMelMax);
    cudaError_t err = cudaFuncSetAttribute(
        fused_mel_fold_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_mel_fold_kernel<MODE><<<dim3(n_blocks, B, (n_mels + kMelMax - 1) / kMelMax), kThreads, smem,
                                  (cudaStream_t)stream>>>(
        audio, wc, ws, melw, mel, bmax, T, K, sup, hop, off, nf, bins_pad, im_cols, n_mels, span_pad);
    return (int)cudaGetLastError();
}

}  // namespace

// wc [K, bins_pad], ws [K, im_cols], melw [bins_pad, n_mels], n_mels <= 512
// (groups of 128 columns, the grid's z; bmax zeroed where there are more
// than one); mel float32
extern "C" int fused_mel_fold_f32(const float* audio, const float* wc, const float* ws, const float* melw,
                                  float* mel, float* bmax, int B, int T, int K, int sup, int hop, int off,
                                  int nf, int bins_pad, int im_cols, int n_mels, void* stream)
{
    return launch_fold<kF32>(audio, wc, ws, melw, mel, bmax, B, T, K, sup, hop, off, nf, bins_pad, im_cols,
                             n_mels, stream);
}

// wc, ws and melw hold bf16-rounded values as float32; mel is bf16
extern "C" int fused_mel_fold_bf16(const float* audio, const float* wc, const float* ws, const float* melw,
                                   void* mel, float* bmax, int B, int T, int K, int sup, int hop, int off,
                                   int nf, int bins_pad, int im_cols, int n_mels, void* stream)
{
    return launch_fold<kBF16>(audio, wc, ws, melw, mel, bmax, B, T, K, sup, hop, off, nf, bins_pad, im_cols,
                              n_mels, stream);
}

// wc [2, K, bins_pad], ws [2, K, im_cols], melw [2, bins_pad, n_mels]: the (hi, lo) stacks
extern "C" int fused_mel_fold_x3(const float* audio, const float* wc, const float* ws, const float* melw,
                                 float* mel, float* bmax, int B, int T, int K, int sup, int hop, int off,
                                 int nf, int bins_pad, int im_cols, int n_mels, void* stream)
{
    return launch_fold<kX3>(audio, wc, ws, melw, mel, bmax, B, T, K, sup, hop, off, nf, bins_pad, im_cols,
                            n_mels, stream);
}
