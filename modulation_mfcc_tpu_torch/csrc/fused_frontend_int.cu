// Fused MFCC frontend for Hopper (sm_90a), fixed-point mode i16: audio ->
// mel power through an int8-digit DFT. A plain C launcher, loaded with
// ctypes (modulation_mfcc_tpu_torch/kernels/_build.py); it returns the
// cudaError_t of its launch. No tensor cores, no fast-math intrinsics. The
// i24 mode runs on the tensor cores (fused_frontend_tc.cu).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// fused_mel_i16
//
// Replaces the Pallas frontend kernels of modulation_mfcc_tpu/pallas/
// fused_frontend.py with algorithm 'i16' (_kernel_i16, _kernel_i16_pipe:
// _i16_digits, _i16_reim). The pipelined kernel computes its plain kernel's
// numbers bit for bit, so one kernel serves the pair.
//
// Computes, for every utterance b and frame f < nf (frame[k] as in
// fused_frontend.cu: x[b, f*hop + off + k], zero outside the buffer, int16
// dequantized as v * 2^-15), with (s, inv) = sc[b] from the wrapper:
//   X = rint(frame * s)                        (half to even, as jnp.round)
//   X clipped to [-32768, 32767]; digits x1 = floor(X/256),
//   x0 = X - 256 x1 - 128 (each in [-128, 127]);
//   d1 = x1.w2, d2 = x1.w1 + x0.w2, d3 = x1.w0 + x0.w1;
//   reim = (((d1 2^24 + d2 2^16) + d3 2^8) + corr) * inv
// where w2, w1, w0 are the int8 planes of the windowed-DFT matrix
// (W ~ (w2 2^16 + w1 2^8 + w0) / Sw) and each dot runs over the K window
// rows. The dots are exact in int32 and every later operation is a
// correctly rounded FP32 operation in the JAX order, so the power
// re^2 + im^2 equals the plain version's bit for bit. Then the mel
// projection in x3 arithmetic (power and melw split into bf16 hi and lo;
// the hi.hi products and the hi.lo + lo.hi products accumulated in two FP32
// sums, as the TPU mode sums its passes apart) and the block max over
// valid frames.
//
// Bound: the int8 digit products. A 128 x 30 s batch at 16 kHz is 5 K-row
// passes of [6001 x 400] x [400 x 512] per utterance, about 1.6 T int8
// operations, plus 150 GFLOP of x3 mel. The unit this mode is made for is
// the int8 tensor core (1,979 TOPS): about 0.95 ms a batch. This kernel
// runs the products as __dp4a on the CUDA cores and the mel as FFMA; it
// does not use the tensor cores.
//
// Design: as fused_mel_f32, a block owns 64 consecutive frames of one
// utterance and copies their audio span into shared memory once. The
// contraction runs 16 rows (4 packed quads) a step: the weight planes
// arrive pre-packed ([3][K/4][2*bins_pad] int32, four consecutive rows per
// word) and are fetched with cp.async one step ahead; the frames' digits
// are computed from the span while the step is staged and packed the same
// way, [digit][quad][frame]. A bin tile is 64 bins (128 columns: their re
// and im); a warp owns 8 frames and a lane the re and im of bins lane and
// lane + 32, so each thread holds 8 x 4 columns x 3 int32 sums and forms
// its own power values. Power (hi and lo) goes to shared memory
// transposed, and is projected onto the mel bank into a [64, 128] shared
// accumulator, 64 bins at a time.
// ---------------------------------------------------------------------------

constexpr int kBF = 64;        // frames per block
constexpr int kBT = 64;        // DFT bins per tile
constexpr int kCols = 2 * kBT; // their re and im columns
constexpr int kKC = 16;        // contraction rows staged per step
constexpr int kQ = kKC / 4;    // packed quads per step
constexpr int kMelMax = 128;   // mel columns a block holds
constexpr int kThreads = 256;  // warp w owns frames 8w..8w+7; lane owns bins lane and lane + 32 of the tile
constexpr int kPitch = kBF + 4;  // row pitch of the [bin][frame] power tiles
constexpr int kPlanes = 3;     // weight planes w2, w1, w0
constexpr int kWSlice = kPlanes * kQ * kCols;  // ints of one staged weight slice
constexpr int ND = 2;          // audio digits x1, x0

// words of the space the weight and digit slices and the power tiles share
constexpr int kSharedWords = 2 * kWSlice + ND * kQ * kBF > 2 * kBT * kPitch
                                 ? 2 * kWSlice + ND * kQ * kBF : 2 * kBT * kPitch;

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float load_sample(const float* x, long long s) { return x[s]; }
__device__ __forceinline__ float load_sample(const int16_t* x, long long s)
{
    return static_cast<float>(x[s]) * (1.0f / 32768.0f);  // exact
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// quads [q0, q0 + kQ) of the bin tile's re and im columns of the three
// planes -> w_dst [plane][quad][kCols], one commit group
__device__ __forceinline__ void stage_weights(int* w_dst, const int* __restrict__ quads, int q0, int Kq,
                                              int bt, int bins_pad, int tid)
{
    for (int i = tid; i < kWSlice / 4; i += kThreads) {
        const int p = i / (kQ * kCols / 4);
        const int r = i % (kQ * kCols / 4);
        const int q = r / (kCols / 4);
        const int c = (r % (kCols / 4)) * 4;
        const int col = c < kBT ? bt + c : bins_pad + bt + (c - kBT);
        cp_async16(w_dst + (p * kQ + q) * kCols + c, quads + ((size_t)p * Kq + q0 + q) * 2 * bins_pad + col);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// the digit planes of round(v * s), highest first, as in _i16_digits
__device__ __forceinline__ void digits(float v, float s, float (&d)[ND])
{
    const float x = fminf(fmaxf(rintf(__fmul_rn(v, s)), -32768.0f), 32767.0f);
    const float x1 = floorf(x * (1.0f / 256.0f));
    d[0] = x1;
    d[1] = x - 256.0f * x1 - 128.0f;
}

// the exact int32 sums -> the DFT value, FP32 in the JAX order
__device__ __forceinline__ float recombine(int d1, int d2, int d3, float corr, float inv)
{
    const float a = __int2float_rn(d1), b = __int2float_rn(d2), c = __int2float_rn(d3);
    return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, 16777216.0f), __fmul_rn(b, 65536.0f)),
                                         __fmul_rn(c, 256.0f)), corr), inv);
}

template <typename In>
__global__ void __launch_bounds__(kThreads, 1)
fused_mel_int_kernel(const In* __restrict__ audio, const int* __restrict__ quads,
                     const float* __restrict__ sc, const float* __restrict__ corr,
                     const float* __restrict__ melw, float* __restrict__ mel,
                     float* __restrict__ bmax, int T, int Kq, int hop, int off,
                     int nf, int bins_pad, int n_mels, int span_pad)
{
    extern __shared__ __align__(16) float smem[];
    float* span_s = smem;                                        // [span_pad] audio samples
    int* w_s = reinterpret_cast<int*>(span_s + span_pad);        // 2 steps x [3][kQ][kCols] weight quads
    int* dig_s = w_s + 2 * kWSlice;                              // [ND][kQ][kBF] digit quads
    float* p_s = span_s + span_pad;                              // 2 x [kBT][kPitch] power (hi, lo), transposed
    float* mel_s = span_s + span_pad + kSharedWords;             // [kBF][kMelMax] mel accumulator (hi.hi)
    float* mel2_s = mel_s + kBF * kMelMax;                       // [kBF][kMelMax] the hi.lo + lo.hi products
    __shared__ float red_s[kThreads / 32];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * kBF;
    const In* x = audio + (size_t)b * T;
    const float s = sc[2 * b];
    const float inv = sc[2 * b + 1];
    const int n_steps = Kq / kQ;
    const float* mel_lo = melw + (size_t)bins_pad * n_mels;

    const long long start = (long long)f0 * hop + off;
    for (int i = tid; i < span_pad; i += kThreads) {
        const long long t = start + i;
        span_s[i] = (t >= 0 && t < T) ? load_sample(x, t) : 0.0f;
    }
    for (int i = tid; i < 2 * kBF * kMelMax; i += kThreads) mel_s[i] = 0.0f;

    for (int bt = 0; bt < bins_pad; bt += kBT) {
        int d1[8][4], d2[8][4], d3[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) { d1[i][j] = 0; d2[i][j] = 0; d3[i][j] = 0; }

        __syncthreads();  // the previous tile's power (same space) fully read
        stage_weights(w_s, quads, 0, Kq, bt, bins_pad, tid);
        for (int step = 0; step < n_steps; ++step) {
            const int q0 = step * kQ;
            __syncthreads();  // the previous step's slices fully read
            if (step + 1 < n_steps)
                stage_weights(w_s + ((step + 1) & 1) * kWSlice, quads, q0 + kQ, Kq, bt, bins_pad, tid);
            {
                // one (quad, frame) per thread: four rows' digits, packed
                const int f = tid % kBF;
                const int q = tid / kBF;
                const float* src = span_s + f * hop + (q0 + q) * 4;
                int packed[ND];
#pragma unroll
                for (int d = 0; d < ND; ++d) packed[d] = 0;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    float dg[ND];
                    digits(src[i], s, dg);
#pragma unroll
                    for (int d = 0; d < ND; ++d) packed[d] |= (static_cast<int>(dg[d]) & 0xff) << (8 * i);
                }
#pragma unroll
                for (int d = 0; d < ND; ++d) dig_s[(d * kQ + q) * kBF + f] = packed[d];
            }
            if (step + 1 < n_steps) asm volatile("cp.async.wait_group 1;\n" ::);
            else asm volatile("cp.async.wait_group 0;\n" ::);
            __syncthreads();
            const int* w_cur = w_s + (step & 1) * kWSlice;
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
                int a[ND][8];
#pragma unroll
                for (int d = 0; d < ND; ++d) {
                    const int4 lo = *reinterpret_cast<const int4*>(dig_s + (d * kQ + q) * kBF + 8 * warp);
                    const int4 hi = *reinterpret_cast<const int4*>(dig_s + (d * kQ + q) * kBF + 8 * warp + 4);
                    a[d][0] = lo.x; a[d][1] = lo.y; a[d][2] = lo.z; a[d][3] = lo.w;
                    a[d][4] = hi.x; a[d][5] = hi.y; a[d][6] = hi.z; a[d][7] = hi.w;
                }
                int w[kPlanes][4];  // w[0] = w2, w[1] = w1, w[2] = w0
#pragma unroll
                for (int p = 0; p < kPlanes; ++p)
#pragma unroll
                    for (int j = 0; j < 4; ++j) w[p][j] = w_cur[(p * kQ + q) * kCols + lane + 32 * j];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        d1[i][j] = __dp4a(a[0][i], w[0][j], d1[i][j]);
                        d2[i][j] = __dp4a(a[0][i], w[1][j], d2[i][j]);
                        d2[i][j] = __dp4a(a[1][i], w[0][j], d2[i][j]);
                        d3[i][j] = __dp4a(a[0][i], w[2][j], d3[i][j]);
                        d3[i][j] = __dp4a(a[1][i], w[1][j], d3[i][j]);
                    }
            }
        }

        __syncthreads();  // every warp is done with the slices the power tiles overwrite
#pragma unroll
        for (int jb = 0; jb < 2; ++jb) {
            const int bin = lane + 32 * jb;
            const float c_re = __ldg(corr + bt + bin);
            const float c_im = __ldg(corr + bins_pad + bt + bin);
            float ph[8], pl[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float re = recombine(d1[i][jb], d2[i][jb], d3[i][jb], c_re, inv);
                const float im = recombine(d1[i][jb + 2], d2[i][jb + 2], d3[i][jb + 2], c_im, inv);
                const float pw = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
                ph[i] = bf16r(pw);
                pl[i] = bf16r(pw - ph[i]);
            }
            float* row = p_s + bin * kPitch + 8 * warp;
            *reinterpret_cast<float4*>(row) = make_float4(ph[0], ph[1], ph[2], ph[3]);
            *reinterpret_cast<float4*>(row + 4) = make_float4(ph[4], ph[5], ph[6], ph[7]);
            float* row_l = row + kBT * kPitch;
            *reinterpret_cast<float4*>(row_l) = make_float4(pl[0], pl[1], pl[2], pl[3]);
            *reinterpret_cast<float4*>(row_l + 4) = make_float4(pl[4], pl[5], pl[6], pl[7]);
        }
        __syncthreads();

        // each thread owns mel_s entries (frames 8w..8w+7, mel lane + 32j)
        float acc[8][4], acc2[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc[i][j] = mel_s[(8 * warp + i) * kMelMax + lane + 32 * j];
                acc2[i][j] = mel2_s[(8 * warp + i) * kMelMax + lane + 32 * j];
            }
        for (int c = 0; c < kBT; ++c) {
            const float* rh = p_s + c * kPitch + 8 * warp;
            const float* rl = rh + kBT * kPitch;
            const float4 h0 = *reinterpret_cast<const float4*>(rh);
            const float4 h1 = *reinterpret_cast<const float4*>(rh + 4);
            const float4 l0 = *reinterpret_cast<const float4*>(rl);
            const float4 l1 = *reinterpret_cast<const float4*>(rl + 4);
            const float ph[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
            const float pl[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
            float mh[4], ml[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int m = lane + 32 * j;
                mh[j] = m < n_mels ? __ldg(melw + (size_t)(bt + c) * n_mels + m) : 0.0f;
                ml[j] = m < n_mels ? __ldg(mel_lo + (size_t)(bt + c) * n_mels + m) : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc[i][j] = fmaf(ph[i], mh[j], acc[i][j]);
                    acc2[i][j] = fmaf(ph[i], ml[j], acc2[i][j]);
                    acc2[i][j] = fmaf(pl[i], mh[j], acc2[i][j]);
                }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                mel_s[(8 * warp + i) * kMelMax + lane + 32 * j] = acc[i][j];
                mel2_s[(8 * warp + i) * kMelMax + lane + 32 * j] = acc2[i][j];
            }
    }
    __syncthreads();

    // write the valid frames; block max over them (mel >= 0, so 0 is neutral)
    float vmax = 0.0f;
    for (int i = tid; i < kBF * n_mels; i += kThreads) {
        const int f = i / n_mels;
        const int m = i % n_mels;
        if (f0 + f < nf) {
            const float v = mel_s[f * kMelMax + m] + mel2_s[f * kMelMax + m];
            mel[((size_t)b * nf + f0 + f) * n_mels + m] = v;
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
        bmax[(size_t)b * gridDim.x + blockIdx.x] = m;
    }
}

template <typename In>
int launch_int(const void* audio, const int* quads, const float* sc, const float* corr, const float* melw,
               float* mel, float* bmax, int B, int T, int K, int Kq, int hop, int off, int nf,
               int bins_pad, int n_mels, void* stream)
{
    if (B < 1 || T < 1 || nf < 1 || K < 1 || Kq * 4 < K || Kq % kQ || hop < 1 || n_mels < 1 ||
        n_mels > kMelMax || bins_pad < kBT || bins_pad % kBT)
        return (int)cudaErrorInvalidValue;
    const int n_blocks = (nf + kBF - 1) / kBF;
    const int span_pad = ((kBF - 1) * hop + Kq * 4 + 3) / 4 * 4;
    const size_t smem = sizeof(float) * ((size_t)span_pad + kSharedWords + 2 * kBF * kMelMax);
    cudaError_t err = cudaFuncSetAttribute(
        fused_mel_int_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_mel_int_kernel<In><<<dim3(n_blocks, B), kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const In*>(audio), quads, sc, corr, melw, mel, bmax, T, Kq, hop, off, nf, bins_pad,
        n_mels, span_pad);
    return (int)cudaGetLastError();
}

}  // namespace

// quads [3, Kq, 2*bins_pad] int32: the planes w2, w1, w0 packed four rows a
// word; sc [B, 2] = (s, 1/(s*Sw)); corr [2*bins_pad]; melw [2, bins_pad,
// n_mels] the x3 (hi, lo) stack
extern "C" int fused_mel_i16(const void* audio, int audio_i16, const int* quads, const float* sc,
                             const float* corr, const float* melw, float* mel, float* bmax, int B, int T,
                             int K, int Kq, int hop, int off, int nf, int bins_pad, int n_mels, void* stream)
{
    return audio_i16
        ? launch_int<int16_t>(audio, quads, sc, corr, melw, mel, bmax, B, T, K, Kq, hop, off, nf, bins_pad,
                              n_mels, stream)
        : launch_int<float>(audio, quads, sc, corr, melw, mel, bmax, B, T, K, Kq, hop, off, nf, bins_pad,
                            n_mels, stream);
}
