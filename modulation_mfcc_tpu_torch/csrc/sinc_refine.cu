// Windowed-sinc peak refinement for Hopper (sm_90a), the pitch tracker's
// Praat NUMimproveMaximum step. Plain C launcher, loaded with ctypes
// (modulation_mfcc_tpu_torch/kernels/_build.py); it returns the cudaError_t
// of its launch. True FP32 on the CUDA cores: no TF32, no fast-math.
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// sinc_refine_f32
//
// Replaces the Pallas kernel of modulation_mfcc_tpu/pallas/sinc_refine.py
// (refine_sinc_band_pallas -> _refine_kernel).
//
// For every row m of r_ext [M, L] and every lag l of the band
// [lag_lo, lag_lo + nl), with x = r_ext[m, start : start + nl + S - 1]:
//   f[g]  = sum_s x[l + s] * w[s, g]        (the interpolant at offset g)
//   gb    = first argmax of f over the interior offsets 1 .. G-2
//   delta = parabola through f[gb-1], f[gb], f[gb+1], |denom| > 1e-12 guard,
//           clipped to +-0.5
//   pos   = lag_lo + l + (-1 + gb*h) + delta*h
//   val   = f[gb] - 0.25*(f[gb-1] - f[gb+1])*delta
//
// Bound: FP32 FFMA. At the tracker's batch (32 x 30 s at 16 kHz: 95,904 rows,
// nl = 189, S = 73, G = 17) that is 45 GFLOP against ~245 MB of input and
// output, so the FFMA rate (67 TFLOP/s) bounds it at ~0.67 ms.
//
// Design: the TPU kernel ran the band as one dense padded GEMM for the MXU.
// Here the band is evaluated directly: a block stages kRows rows of x and
// the weights w (padded to kGP columns so each weight row is float4
// aligned) in shared memory once; each thread owns one (row, lag) and keeps
// G = 17 accumulators in registers, so per tap it reads one x word and four
// float4 + one scalar weight words (broadcasts) for 17 FFMA. The interpolant
// never leaves registers; only (pos, val) is written. The parabola uses
// explicitly rounded operations so it rounds like the plain version's
// separate torch ops.
// ---------------------------------------------------------------------------

constexpr int kG = 17;         // offsets per lag (grid 17: spacing 1/8 over [-1, 1])
constexpr int kGP = 20;        // padded weight row (five float4)
constexpr int kRows = 8;       // rows of r_ext per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sinc_refine_f32_kernel(const float* __restrict__ r_ext, const float* __restrict__ w,
                       float* __restrict__ pos, float* __restrict__ val,
                       int M, int L, int start, int nl, int S, int lag_lo, float h)
{
    extern __shared__ float4 smem4[];
    float* ws = reinterpret_cast<float*>(smem4);  // [S][kGP]
    const int kb = nl + S - 1;
    float* xs = ws + S * kGP;                       // [kRows][kb]

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * kRows;
    const int nrows = min(kRows, M - row0);
    for (int i = tid; i < S * kGP; i += kThreads) {
        const int s = i / kGP, g = i % kGP;
        ws[i] = g < kG ? w[s * kG + g] : 0.0f;
    }
    for (int i = tid; i < nrows * kb; i += kThreads) {
        const int r = i / kb, j = i % kb;
        xs[i] = r_ext[(size_t)(row0 + r) * L + start + j];
    }
    __syncthreads();

    for (int item = tid; item < nrows * nl; item += kThreads) {
        const int r = item / nl, l = item % nl;
        const float* x = xs + r * kb + l;
        float f[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) f[g] = 0.0f;
        for (int s = 0; s < S; ++s) {
            const float xv = x[s];
            const float4* wr = reinterpret_cast<const float4*>(ws + s * kGP);
            const float4 w0 = wr[0], w1 = wr[1], w2 = wr[2], w3 = wr[3];
            const float w16 = ws[s * kGP + 16];
            f[0] = fmaf(xv, w0.x, f[0]);   f[1] = fmaf(xv, w0.y, f[1]);
            f[2] = fmaf(xv, w0.z, f[2]);   f[3] = fmaf(xv, w0.w, f[3]);
            f[4] = fmaf(xv, w1.x, f[4]);   f[5] = fmaf(xv, w1.y, f[5]);
            f[6] = fmaf(xv, w1.z, f[6]);   f[7] = fmaf(xv, w1.w, f[7]);
            f[8] = fmaf(xv, w2.x, f[8]);   f[9] = fmaf(xv, w2.y, f[9]);
            f[10] = fmaf(xv, w2.z, f[10]); f[11] = fmaf(xv, w2.w, f[11]);
            f[12] = fmaf(xv, w3.x, f[12]); f[13] = fmaf(xv, w3.y, f[13]);
            f[14] = fmaf(xv, w3.z, f[14]); f[15] = fmaf(xv, w3.w, f[15]);
            f[16] = fmaf(xv, w16, f[16]);
        }
        // first maximum over the interior offsets (strict >: the earliest wins)
        float best = f[1];
        int gb = 1;
#pragma unroll
        for (int g = 2; g < kG - 1; ++g) {
            if (f[g] > best) { best = f[g]; gb = g; }
        }
        // neighbours by selects over the unrolled registers (no local memory)
        float fm = f[0], fp = f[2];
#pragma unroll
        for (int g = 2; g < kG - 1; ++g) {
            if (gb == g) { fm = f[g - 1]; fp = f[g + 1]; }
        }
        const float diff = __fsub_rn(fm, fp);
        const float denom = __fadd_rn(__fsub_rn(fm, __fmul_rn(2.0f, best)), fp);
        float delta = fabsf(denom) > 1e-12f ? __fdiv_rn(__fmul_rn(0.5f, diff), denom) : 0.0f;
        delta = fminf(fmaxf(delta, -0.5f), 0.5f);
        const float off = __fadd_rn(-1.0f, __fmul_rn((float)gb, h));
        const size_t o = (size_t)(row0 + r) * nl + l;
        pos[o] = __fadd_rn(__fadd_rn((float)(lag_lo + l), off), __fmul_rn(delta, h));
        val[o] = __fsub_rn(best, __fmul_rn(__fmul_rn(0.25f, diff), delta));
    }
}

}  // namespace

extern "C" int sinc_refine_f32(const float* r_ext, const float* w, float* pos, float* val,
                               int M, int L, int start, int nl, int S, int G, int lag_lo,
                               float h, void* stream)
{
    if (M < 1 || nl < 1 || S < 1 || G != kG || start < 0 || start + nl + S - 1 > L)
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * ((size_t)S * kGP + (size_t)kRows * (nl + S - 1));
    cudaError_t err = cudaFuncSetAttribute(
        sinc_refine_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_blocks = (M + kRows - 1) / kRows;
    sinc_refine_f32_kernel<<<n_blocks, kThreads, smem, (cudaStream_t)stream>>>(
        r_ext, w, pos, val, M, L, start, nl, S, lag_lo, h);
    return (int)cudaGetLastError();
}
