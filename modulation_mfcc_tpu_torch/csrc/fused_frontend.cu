// Fused MFCC frontend for Hopper (sm_90a), the f32 mode: audio -> mel
// power, then mel -> dB with the top_db clip -> DCT-II. Plain C launchers,
// loaded with ctypes (modulation_mfcc_tpu_torch/kernels/_build.py); each
// returns the cudaError_t of its launch. All arithmetic here runs on the
// CUDA cores in true FP32 (FFMA, no tensor cores, no fast-math intrinsics).
// The bf16, x3 and fixed-point modes run on the tensor cores
// (fused_frontend_tc.cu).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "fused_frontend_common.cuh"

namespace {

using namespace frontend;

// ---------------------------------------------------------------------------
// fused_mel_f32
//
// Replaces the Pallas frontend kernel of modulation_mfcc_tpu/pallas/
// fused_frontend.py (fused_mel_frontend -> _launch -> _kernel and
// _kernel_pipe, concat frame mode), with algorithm 'f32' (_mxu). The
// pipelined _kernel_pipe computes _kernel's numbers bit for bit, so one
// kernel serves both.
//
// Computes, for every utterance b and frame f < nf,
//   frame[k] = x[b, f*hop + off + k]          (zero outside [0, T): T is the
//              length of one utterance's buffer, off = -eff_pad for flat
//              audio and 0 for hop rows, whose pad is in the buffer; int16
//              samples are dequantized as v * 2^-15, exact)
//   reim     = frame @ wri                    ([K] x [K, 2*bins_pad])
//   power    = re^2 + im^2                    ([bins_pad])
//   mel      = power @ melw                   ([bins_pad] x [bins_pad, n_mels])
// and one float per block: the max of mel over the block's frames (< nf),
// which the wrapper reduces to the per-utterance top_db peak. The DFT sums
// in steps of kKC = 16 rows: each step's 16 products go to a fresh partial
// sum, which is then added to the running re/im sum. One 400-term FFMA
// chain per value rounds enough to put the MFCC 2e-4 from the float64 one
// on 16 x 30 s of noise; the steps halve that. The plain version
// (kernels/fused_frontend._stepped_matmul) sums in the same steps.
//
// Bound: FFMA throughput on the CUDA cores, the unit its arithmetic is made
// for. A 128 x 30 s batch at 16 kHz is ~315 GFLOP of DFT and ~50 GFLOP of
// mel projection; the audio read (123-246 MB) and the mel write (400 MB)
// are small beside it at 3.35 TB/s.
//
// Design: a block owns 64 consecutive frames of one utterance. It copies the
// contiguous audio span those frames cover into shared memory once (about
// 21 KB at hop 80, K 400), so frames never exist in device memory. The DFT
// is an SGEMM against that implicit [64, K] operand, 16 contraction rows at
// a time. The basis slice is double-buffered in shared memory and fetched
// with cp.async one step ahead, so its L2 latency hides behind the current
// step's FFMAs; the frame slice is staged transposed ([k][frame]) from the
// audio span. A thread adds the step's partial sums, so it keeps 8 frames by
// 2 bins of a 64-bin tile (32 running sums, 32 partials) at 6 shared-memory
// wavefronts per 32 FFMA (a warp's 8 frame samples are two float4
// broadcasts, a lane's 2 re and 2 im basis values conflict-free words),
// within the 128 registers of two blocks an SM. Power goes to shared memory
// (transposed, [bin][frame], in the same space as the slices) and is
// projected onto the mel bank into a [64, 128] shared accumulator, a tile
// of bins at a time, so the mel sum over bins runs in bin order. Blocks run
// in no order, so the block max is written per block, not carried.
// ---------------------------------------------------------------------------

constexpr int kTB = kTile<kF32>;  // bins of a tile
// floats of the space the basis slices, the frame slice and the power tile share:
// two steps of slices + the frame slice, or the power tile
constexpr int kShared = 2 * kTileSlice<kF32> + kKC * kPitch > kTB * kPitch ? 2 * kTileSlice<kF32> + kKC * kPitch
                                                                           : kTB * kPitch;

__device__ __forceinline__ float load_sample(const float* x, long long s) { return x[s]; }
__device__ __forceinline__ float load_sample(const int16_t* x, long long s)
{
    return static_cast<float>(x[s]) * (1.0f / 32768.0f);  // exact
}

// rows [k0, k0 + kKC) of the TB-bin tile's re and im columns -> w_dst, one
// commit group
template <int TB>
__device__ __forceinline__ void stage_basis(float* w_dst, const float* __restrict__ wri, int k0,
                                            int K, int bt, int bins_pad, int tid)
{
    for (int i = tid; i < kKC * 2 * TB / 4; i += kThreads) {
        const int kk = i / (2 * TB / 4);
        const int c = (i % (2 * TB / 4)) * 4;
        const int k = k0 + kk;
        const int col = c < TB ? bt + c : bins_pad + bt + (c - TB);
        // rows past K are zero, so the unrolled loop adds exact zeros
        cp_async16(w_dst + kk * 2 * TB + c, wri + (size_t)(k < K ? k : 0) * 2 * bins_pad + col, k < K);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// one step's products, rows [k0, k0 + kKC), added into (re, im) of the
// thread's 8 frames and NJ bins (lane + 32 j of a 32 NJ-bin tile): a_s the
// step's frame slice, w_cur its basis slice
template <int NJ>
__device__ __forceinline__ void dft_step(float (&re)[8][NJ], float (&im)[8][NJ], const float* a_s,
                                         const float* w_cur, int lane, int warp)
{
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
        const float4 a_lo = *reinterpret_cast<const float4*>(a_s + kk * kPitch + 4 * warp);
        const float4 a_hi = *reinterpret_cast<const float4*>(a_s + kk * kPitch + 32 + 4 * warp);
        const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
        float wr[NJ], wi[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            wr[j] = w_cur[kk * 2 * 32 * NJ + lane + 32 * j];
            wi[j] = w_cur[kk * 2 * 32 * NJ + 32 * NJ + lane + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                re[i][j] = fmaf(a[i], wr[j], re[i][j]);
                im[i][j] = fmaf(a[i], wi[j], im[i][j]);
            }
    }
}

template <typename In>
__global__ void __launch_bounds__(kThreads, 2)
fused_mel_kernel(const In* __restrict__ audio, const float* __restrict__ wri,
                 const float* __restrict__ melw, float* __restrict__ mel_out,
                 float* __restrict__ bmax, int T, int K, int hop, int off,
                 int nf, int bins_pad, int n_mels, int span_pad)
{
    constexpr int NJ = kTB / 32;
    extern __shared__ __align__(16) float smem[];
    float* span_s = smem;                      // [span_pad] audio samples
    float* w_s = span_s + span_pad;            // 2 steps x [kKC][2*kTB] basis slices
    float* a_s = w_s + 2 * kTileSlice<kF32>;   // [kKC][kPitch] frame slice, transposed
    float* p_s = w_s;                          // [kTB][kPitch] power tile, transposed
    float* mel_s = w_s + kShared;              // [kBF][kMelMax] mel accumulator
    __shared__ float red_s[kThreads / 32];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * kBF;
    const In* x = audio + (size_t)b * T;
    const int n_steps = (K + kKC - 1) / kKC;

    const long long start = (long long)f0 * hop + off;
    for (int i = tid; i < span_pad; i += kThreads) {
        const long long s = start + i;
        const float v = (s >= 0 && s < T) ? load_sample(x, s) : 0.0f;
        span_s[i] = v;
    }
    for (int i = tid; i < kBF * kMelMax; i += kThreads) mel_s[i] = 0.0f;

    for (int bt = 0; bt < bins_pad; bt += kTB) {
        float re[8][NJ] = {}, im[8][NJ] = {};  // the running sums

        __syncthreads();  // the previous tile's power (same space) fully read
        stage_basis<kTB>(w_s, wri, 0, K, bt, bins_pad, tid);
        for (int step = 0; step < n_steps; ++step) {
            const int k0 = step * kKC;
            __syncthreads();  // the previous step's slices fully read
            if (step + 1 < n_steps)
                stage_basis<kTB>(w_s + ((step + 1) & 1) * kTileSlice<kF32>, wri, k0 + kKC, K, bt, bins_pad, tid);
            for (int i = tid; i < kKC * kBF; i += kThreads) {
                const int kk = i % kKC;
                const int f = i / kKC;
                a_s[kk * kPitch + f] = span_s[f * hop + k0 + kk];
            }
            if (step + 1 < n_steps) asm volatile("cp.async.wait_group 1;\n" ::);
            else asm volatile("cp.async.wait_group 0;\n" ::);
            __syncthreads();
            // the step's own partial sums, added to re/im after the step
            float pre[8][NJ] = {}, pim[8][NJ] = {};
            dft_step<NJ>(pre, pim, a_s, w_s + (step & 1) * kTileSlice<kF32>, lane, warp);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    re[i][j] += pre[i][j];
                    im[i][j] += pim[i][j];
                }
        }

        project_tile<kF32, NJ>(re, im, re, im, p_s, mel_s, nullptr, melw, bt, bins_pad, n_mels, lane, warp);
    }
    write_block<kF32>(mel_s, nullptr, mel_out, bmax, red_s, b, f0, nf, n_mels, tid, lane, warp);
}

template <typename In>
int launch_mel(const void* audio, const float* wri, const float* melw, float* mel, float* bmax,
               int B, int T, int K, int hop, int off, int nf, int bins_pad, int n_mels, void* stream)
{
    if (B < 1 || T < 1 || nf < 1 || K < 1 || hop < 1 || n_mels < 1 || n_mels > kMelMax ||
        bins_pad < kBT || bins_pad % kBT)
        return (int)cudaErrorInvalidValue;
    const int n_blocks = (nf + kBF - 1) / kBF;
    const int span = (kBF - 1) * hop + (K + kKC - 1) / kKC * kKC;
    const int span_pad = (span + 3) / 4 * 4;
    const size_t smem = sizeof(float) * ((size_t)span_pad + kShared + kBF * kMelMax);
    cudaError_t err = cudaFuncSetAttribute(
        fused_mel_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_mel_kernel<In><<<dim3(n_blocks, B), kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const In*>(audio), wri, melw, mel, bmax, T, K, hop, off, nf, bins_pad, n_mels, span_pad);
    return (int)cudaGetLastError();
}

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
// reads the bf16 mode's mel (mel_ref[0].astype(f32)).
//
// Bound: device memory. It reads the mel tensor once (~400 MB for a
// 128 x 30 s batch at 16 kHz, half that in bf16) and writes 13 floats per
// frame; the 13 dot products of 128 terms and one log10f per element are
// light beside that.
//
// Design: a block stages 128 frame rows of mel in shared memory with
// coalesced loads (row stride n_mels + 1, so the one-thread-per-row reads
// hit distinct banks), then each thread computes one frame: log10f, the
// clip, and the DCT from a shared copy of the matrix (broadcast reads).
// The coef-major write is coalesced along frames, which is the layout the
// trajectory filters consume.
// ---------------------------------------------------------------------------

constexpr int kTF = 128;       // frames per block, one thread each
constexpr int kMfccMax = 32;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename M>
__global__ void __launch_bounds__(kTF)
mfcc_tail_kernel(const M* __restrict__ mel, const float* __restrict__ peak,
                 const float* __restrict__ dct, float* __restrict__ out,
                 int nf, int n_mels, int n_mfcc, int coef_major)
{
    extern __shared__ __align__(16) float sm[];
    const int ld = n_mels + 1;
    float* tile = sm;                 // [kTF][ld]
    float* dct_s = sm + kTF * ld;     // [n_mels][n_mfcc]

    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * kTF;
    const int nrows = min(kTF, nf - f0);
    const M* src = mel + ((size_t)b * nf + f0) * n_mels;
    for (int i = tid; i < nrows * n_mels; i += kTF) tile[(i / n_mels) * ld + i % n_mels] = widen(src[i]);
    for (int i = tid; i < n_mels * n_mfcc; i += kTF) dct_s[i] = dct[i];
    __syncthreads();
    if (tid >= nrows) return;

    const float floor_db = peak[b] - 80.0f;
    float acc[kMfccMax];
#pragma unroll
    for (int c = 0; c < kMfccMax; ++c) acc[c] = 0.0f;
    const float* row = tile + tid * ld;
    for (int m = 0; m < n_mels; ++m) {
        const float d = fmaxf(10.0f * log10f(fmaxf(row[m], 1e-10f)), floor_db);
#pragma unroll
        for (int c = 0; c < kMfccMax; ++c)
            if (c < n_mfcc) acc[c] = fmaf(d, dct_s[m * n_mfcc + c], acc[c]);
    }
    const int f = f0 + tid;
#pragma unroll
    for (int c = 0; c < kMfccMax; ++c) {
        if (c < n_mfcc) {
            if (coef_major) out[((size_t)b * n_mfcc + c) * nf + f] = acc[c];
            else out[((size_t)b * nf + f) * n_mfcc + c] = acc[c];
        }
    }
}

template <typename M>
int launch_tail(const void* mel, const float* peak, const float* dct, float* out, int B, int nf,
                int n_mels, int n_mfcc, int coef_major, void* stream)
{
    const size_t smem = sizeof(float) * ((size_t)kTF * (n_mels + 1) + (size_t)n_mels * n_mfcc);
    cudaError_t err = cudaFuncSetAttribute(
        mfcc_tail_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_blocks = (nf + kTF - 1) / kTF;
    mfcc_tail_kernel<M><<<dim3(n_blocks, B), kTF, smem, (cudaStream_t)stream>>>(
        static_cast<const M*>(mel), peak, dct, out, nf, n_mels, n_mfcc, coef_major);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_mel_f32(const void* audio, int audio_i16, const float* wri, const float* melw,
                             float* mel, float* bmax, int B, int T, int K, int hop, int off,
                             int nf, int bins_pad, int n_mels, void* stream)
{
    return audio_i16
        ? launch_mel<int16_t>(audio, wri, melw, mel, bmax, B, T, K, hop, off, nf, bins_pad, n_mels, stream)
        : launch_mel<float>(audio, wri, melw, mel, bmax, B, T, K, hop, off, nf, bins_pad, n_mels, stream);
}

extern "C" int mfcc_tail_f32(const void* mel, int mel_bf16, const float* peak, const float* dct,
                             float* out, int B, int nf, int n_mels, int n_mfcc,
                             int coef_major, void* stream)
{
    if (B < 1 || nf < 1 || n_mels < 1 || n_mfcc < 1 || n_mfcc > kMfccMax)
        return (int)cudaErrorInvalidValue;
    return mel_bf16 ? launch_tail<__nv_bfloat16>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream)
                    : launch_tail<float>(mel, peak, dct, out, B, nf, n_mels, n_mfcc, coef_major, stream);
}
