// Fused MFCC frontend for Hopper (sm_90a), float modes: audio -> mel power,
// then mel -> dB with the top_db clip -> DCT-II. Plain C launchers, loaded
// with ctypes (modulation_mfcc_tpu_torch/kernels/_build.py); each returns the
// cudaError_t of its launch. All arithmetic runs on the CUDA cores (FFMA, no
// tensor cores, no fast-math intrinsics). fused_mel_f32 and mfcc_tail_f32
// compute in true FP32; fused_mel_bf16 and fused_mel_x3 round their operands
// to bf16 as their TPU modes do (a product of two bf16 values is exact in
// FP32, so each such product is accumulated in FP32). The fixed-point modes
// are in fused_frontend_int.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "fused_frontend_common.cuh"

namespace {

using namespace frontend;

// ---------------------------------------------------------------------------
// fused_mel_f32, fused_mel_bf16, fused_mel_x3
//
// Replace the Pallas frontend kernel of modulation_mfcc_tpu/pallas/
// fused_frontend.py (fused_mel_frontend -> _launch -> _kernel and
// _kernel_pipe, concat frame mode), with algorithm 'f32', 'bf16' and 'x3'
// (_mxu) respectively. The pipelined _kernel_pipe computes _kernel's numbers
// bit for bit, so one kernel serves both.
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
// which the wrapper reduces to the per-utterance top_db peak.
//
//   'f32':  as above, FP32.
//   'bf16': frame samples, wri, power and melw rounded to bf16 (nearest
//           even; wri and melw arrive rounded); mel stored as bf16, the
//           block max taken over the FP32 mel before that rounding.
//   'x3':   each product a*w becomes hi(a)*hi(w) + hi(a)*lo(w) + lo(a)*hi(w)
//           with hi = bf16(v), lo = bf16(v - hi); wri and melw arrive as
//           [2, ...] (hi, lo) stacks, the frame and power splits are made
//           here by __float2bfloat16_rn. As the TPU mode sums the hi*hi
//           pass apart from the two small ones, the hi*hi products and the
//           small products accumulate in separate FP32 sums, added at the
//           end: one running sum of all three reorders the rounding enough
//           to move low mel bins by ~1e-4 relative.
//
// Bound: FFMA throughput on the CUDA cores here. A 128 x 30 s batch at
// 16 kHz is ~315 GFLOP of DFT and ~50 GFLOP of mel projection (x3: three
// times that); the audio read (123-246 MB) and the mel write (200-400 MB)
// are small beside it at 3.35 TB/s. The unit the bf16 and x3 modes are
// made for is the bf16 tensor core (989 TFLOP/s): about 0.4 ms (bf16) and
// 1.1 ms (x3) a batch; this kernel does not use it.
//
// Design: a block owns 64 consecutive frames of one utterance. It copies the
// contiguous audio span those frames cover into shared memory once (about
// 21 KB at hop 80, K 400), so frames never exist in device memory. The DFT
// is an SGEMM against that implicit [64, K] operand, 16 contraction rows at
// a time. The basis slice is double-buffered in shared memory and fetched
// with cp.async one step ahead, so its L2 latency hides behind the current
// step's FFMAs; the frame slice is staged transposed ([k][frame]) from the
// audio span. Each thread keeps an 8-frame by 4-bin tile of re and im (64
// accumulators) in registers; a warp's 8 frame samples are two float4
// broadcasts and a lane's 4 re and 4 im basis values are 8 conflict-free
// words: 10 shared-memory wavefronts per 64 FFMA. Power goes to shared memory (transposed,
// [bin][frame], in the same space as the slices) and is projected onto the
// mel bank into a [64, 128] shared accumulator, 128 bins at a time, so the
// mel sum over bins runs in bin order. Blocks run in no order, so the block
// max is written per block, not carried. The x3 mode stages two of every
// operand (hi and lo), runs three FFMA per term into two sums, and keeps a
// second mel accumulator.
// ---------------------------------------------------------------------------

// floats of the space the basis slices, the frame slice and the power tile share
__host__ __device__ constexpr int shared_floats(int mode)
{
    const int planes = mode == kX3 ? 2 : 1;
    const int stage = 2 * planes * kSlice + planes * kKC * kPitch;  // two steps of slices + the frame slice
    const int power = planes * kBT * kPitch;
    return stage > power ? stage : power;
}

__device__ __forceinline__ float load_sample(const float* x, long long s) { return x[s]; }
__device__ __forceinline__ float load_sample(const int16_t* x, long long s)
{
    return static_cast<float>(x[s]) * (1.0f / 32768.0f);  // exact
}

// rows [k0, k0 + kKC) of the bin tile's re and im columns of each plane ->
// w_dst (plane p at w_dst + p * kSlice), one commit group
template <int PLANES>
__device__ __forceinline__ void stage_basis(float* w_dst, const float* __restrict__ wri, int k0,
                                            int K, int bt, int bins_pad, int tid)
{
    for (int i = tid; i < PLANES * kSlice / 4; i += kThreads) {
        const int p = i / (kSlice / 4);
        const int r = i % (kSlice / 4);
        const int kk = r / (2 * kBT / 4);
        const int c = (r % (2 * kBT / 4)) * 4;
        const int k = k0 + kk;
        const int col = c < kBT ? bt + c : bins_pad + bt + (c - kBT);
        // rows past K are zero, so the unrolled loop adds exact zeros
        cp_async16(w_dst + p * kSlice + kk * 2 * kBT + c,
                   wri + ((size_t)p * K + (k < K ? k : 0)) * 2 * bins_pad + col, k < K);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int MODE, typename In>
__global__ void __launch_bounds__(kThreads, MODE == kX3 ? 1 : 2)
fused_mel_kernel(const In* __restrict__ audio, const float* __restrict__ wri,
                 const float* __restrict__ melw, void* __restrict__ mel_out,
                 float* __restrict__ bmax, int T, int K, int hop, int off,
                 int nf, int bins_pad, int n_mels, int span_pad)
{
    constexpr int P = MODE == kX3 ? 2 : 1;  // planes per operand: (hi, lo) for x3
    constexpr int kShared = shared_floats(MODE);
    extern __shared__ __align__(16) float smem[];
    float* span_s = smem;                      // [span_pad] audio samples
    float* w_s = span_s + span_pad;            // 2 steps x P planes x [kKC][2*kBT] basis slices
    float* a_s = w_s + 2 * P * kSlice;         // P x [kKC][kPitch] frame slice, transposed
    float* p_s = w_s;                          // P x [kBT][kPitch] power tile, transposed
    float* mel_s = w_s + kShared;              // [kBF][kMelMax] mel accumulator
    float* mel2_s = mel_s + kBF * kMelMax;     // x3: [kBF][kMelMax] accumulator of the small products
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
        span_s[i] = MODE == kBF16 ? bf16r(v) : v;
    }
    for (int i = tid; i < P * kBF * kMelMax; i += kThreads) mel_s[i] = 0.0f;

    for (int bt = 0; bt < bins_pad; bt += kBT) {
        float re[8][4], im[8][4];    // the (hi*hi) products
        float res[8][4], ims[8][4];  // x3: the hi*lo and lo*hi products
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) { re[i][j] = 0.0f; im[i][j] = 0.0f; res[i][j] = 0.0f; ims[i][j] = 0.0f; }

        __syncthreads();  // the previous tile's power (same space) fully read
        stage_basis<P>(w_s, wri, 0, K, bt, bins_pad, tid);
        for (int step = 0; step < n_steps; ++step) {
            const int k0 = step * kKC;
            __syncthreads();  // the previous step's slices fully read
            if (step + 1 < n_steps)
                stage_basis<P>(w_s + ((step + 1) & 1) * P * kSlice, wri, k0 + kKC, K, bt, bins_pad, tid);
            for (int i = tid; i < kKC * kBF; i += kThreads) {
                const int kk = i % kKC;
                const int f = i / kKC;
                const float v = span_s[f * hop + k0 + kk];
                if constexpr (MODE == kX3) {
                    const float hi = bf16r(v);
                    a_s[kk * kPitch + f] = hi;
                    a_s[kKC * kPitch + kk * kPitch + f] = bf16r(v - hi);
                } else {
                    a_s[kk * kPitch + f] = v;
                }
            }
            if (step + 1 < n_steps) asm volatile("cp.async.wait_group 1;\n" ::);
            else asm volatile("cp.async.wait_group 0;\n" ::);
            __syncthreads();
            const float* w_cur = w_s + (step & 1) * P * kSlice;
#pragma unroll
            for (int kk = 0; kk < kKC; ++kk) {
                const float4 a_lo = *reinterpret_cast<const float4*>(a_s + kk * kPitch + 4 * warp);
                const float4 a_hi = *reinterpret_cast<const float4*>(a_s + kk * kPitch + 32 + 4 * warp);
                const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
                float wr[4], wi[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    wr[j] = w_cur[kk * 2 * kBT + lane + 32 * j];
                    wi[j] = w_cur[kk * 2 * kBT + kBT + lane + 32 * j];
                }
                if constexpr (MODE == kX3) {
                    const float* a2 = a_s + kKC * kPitch + kk * kPitch;
                    const float4 l_lo = *reinterpret_cast<const float4*>(a2 + 4 * warp);
                    const float4 l_hi = *reinterpret_cast<const float4*>(a2 + 32 + 4 * warp);
                    const float al[8] = {l_lo.x, l_lo.y, l_lo.z, l_lo.w, l_hi.x, l_hi.y, l_hi.z, l_hi.w};
                    float wrl[4], wil[4];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        wrl[j] = w_cur[kSlice + kk * 2 * kBT + lane + 32 * j];
                        wil[j] = w_cur[kSlice + kk * 2 * kBT + kBT + lane + 32 * j];
                    }
#pragma unroll
                    for (int i = 0; i < 8; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            re[i][j] = fmaf(a[i], wr[j], re[i][j]);
                            res[i][j] = fmaf(a[i], wrl[j], res[i][j]);
                            res[i][j] = fmaf(al[i], wr[j], res[i][j]);
                            im[i][j] = fmaf(a[i], wi[j], im[i][j]);
                            ims[i][j] = fmaf(a[i], wil[j], ims[i][j]);
                            ims[i][j] = fmaf(al[i], wi[j], ims[i][j]);
                        }
                } else {
#pragma unroll
                    for (int i = 0; i < 8; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            re[i][j] = fmaf(a[i], wr[j], re[i][j]);
                            im[i][j] = fmaf(a[i], wi[j], im[i][j]);
                        }
                }
            }
        }

        project_tile<MODE>(re, im, res, ims, p_s, mel_s, mel2_s, melw, bt, bins_pad, n_mels, lane, warp);
    }
    write_block<MODE>(mel_s, mel2_s, mel_out, bmax, red_s, b, f0, nf, n_mels, tid, lane, warp);
}

template <int MODE, typename In>
int launch_mel(const void* audio, const float* wri, const float* melw, void* mel, float* bmax,
               int B, int T, int K, int hop, int off, int nf, int bins_pad, int n_mels, void* stream)
{
    if (B < 1 || T < 1 || nf < 1 || K < 1 || hop < 1 || n_mels < 1 || n_mels > kMelMax ||
        bins_pad < kBT || bins_pad % kBT)
        return (int)cudaErrorInvalidValue;
    const int n_blocks = (nf + kBF - 1) / kBF;
    const int span = (kBF - 1) * hop + (K + kKC - 1) / kKC * kKC;
    const int span_pad = (span + 3) / 4 * 4;
    const size_t smem = sizeof(float) * ((size_t)span_pad + shared_floats(MODE) + (MODE == kX3 ? 2 : 1) * kBF * kMelMax);
    cudaError_t err = cudaFuncSetAttribute(
        fused_mel_kernel<MODE, In>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_mel_kernel<MODE, In><<<dim3(n_blocks, B), kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const In*>(audio), wri, melw, mel, bmax, T, K, hop, off, nf, bins_pad, n_mels, span_pad);
    return (int)cudaGetLastError();
}

template <int MODE>
int launch_mel_any(const void* audio, int audio_i16, const float* wri, const float* melw, void* mel,
                   float* bmax, int B, int T, int K, int hop, int off, int nf, int bins_pad, int n_mels,
                   void* stream)
{
    return audio_i16
        ? launch_mel<MODE, int16_t>(audio, wri, melw, mel, bmax, B, T, K, hop, off, nf, bins_pad, n_mels, stream)
        : launch_mel<MODE, float>(audio, wri, melw, mel, bmax, B, T, K, hop, off, nf, bins_pad, n_mels, stream);
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
    return launch_mel_any<kF32>(audio, audio_i16, wri, melw, mel, bmax, B, T, K, hop, off, nf, bins_pad,
                                n_mels, stream);
}

// wri and melw hold bf16-rounded values as float32; mel is bf16
extern "C" int fused_mel_bf16(const void* audio, int audio_i16, const float* wri, const float* melw,
                              void* mel, float* bmax, int B, int T, int K, int hop, int off,
                              int nf, int bins_pad, int n_mels, void* stream)
{
    return launch_mel_any<kBF16>(audio, audio_i16, wri, melw, mel, bmax, B, T, K, hop, off, nf, bins_pad,
                                 n_mels, stream);
}

// wri [2, K, 2*bins_pad] and melw [2, bins_pad, n_mels]: the (hi, lo) stacks
extern "C" int fused_mel_x3(const void* audio, int audio_i16, const float* wri, const float* melw,
                            float* mel, float* bmax, int B, int T, int K, int hop, int off,
                            int nf, int bins_pad, int n_mels, void* stream)
{
    return launch_mel_any<kX3>(audio, audio_i16, wri, melw, mel, bmax, B, T, K, hop, off, nf, bins_pad,
                               n_mels, stream);
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
