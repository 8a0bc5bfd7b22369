// Burg LPC for Hopper (sm_90a), the formant tracker's linear prediction.
// Plain C launcher, loaded with ctypes (modulation_mfcc_tpu_torch/kernels/
// _build.py); it returns the cudaError_t of its launch. True FP32 on the
// CUDA cores: no TF32, no fast-math.
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// burg_lpc_f32
//
// Replaces the Pallas kernel of modulation_mfcc_tpu/pallas/burg.py
// (_burg_call -> _burg_kernel, via burg_reflections and burg_lpc_pallas).
//
// For every frame (row of frames [M, nw]), with f = b = the frame, and for
// m = 0 .. order-1 on the shrinking valid prefix lm = nw - 1 - m:
//   num = -2 * sum_{i<lm} f[i+1]*b[i]
//   den = sum_{i<lm} f[i+1]^2 + sum_{i<lm} b[i]^2
//   k_m = num / max(den, 1e-30)                 (a zero frame gives k = 0)
//   f[i] <- f[i+1] + k_m*b[i],  b[i] <- b[i] + k_m*f[i+1]   (i < lm)
// and writes the reflection coefficients k_1..k_p, or with levinson != 0
// the LPC coefficients a_1..a_p of the fused Levinson update
//   a[i] <- a[i] + k_m*a[m-1-i] (i < m),  a[m] <- k_m.
//
// Bound: at the tracker's batch (32 x 30 s resampled to 11 kHz: 191,712
// frames of 550) about 8 GFLOP (0.13 ms at 67 TFLOP/s) against one 422 MB
// read of the frames (0.13 ms at 3.35 TB/s); the write is 7.7 MB.
//
// Design: one warp owns one frame. The frame is read once, coalesced, into
// f and b in shared memory (2 x nw floats per warp); the recursion runs
// there, with lanes striding the prefix. Each step is a reduction pass (three
// per-lane partial sums and a butterfly) and an update pass that reads
// f[i+1] and b[i] into registers, synchronises the warp, and only then
// writes, so no lane reads a neighbour's already-updated f. Lane i keeps
// a_{i+1} in a register and takes a_{m-1-i} from its neighbour by shuffle.
// The updates use explicitly rounded multiply and add, as the plain
// version's separate torch ops round.
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;  // frames per block
constexpr int kMaxOrder = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

__global__ void __launch_bounds__(kWarps * 32)
burg_lpc_f32_kernel(const float* __restrict__ frames, float* __restrict__ out,
                    int M, int nw, int order, int levinson)
{
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * kWarps + warp;
    if (row >= M) return;  // whole warps leave; the block never synchronises
    float* f = smem + (size_t)warp * 2 * nw;
    float* b = f + nw;
    const float* src = frames + row * nw;
    for (int i = lane; i < nw; i += 32) {
        const float v = src[i];
        f[i] = v;
        b[i] = v;
    }
    __syncwarp();

    float a = 0.0f;  // lane i: k_{i+1} or a_{i+1}
    for (int m = 0; m < order; ++m) {
        const int lm = nw - 1 - m;
        float num = 0.0f, den_f = 0.0f, den_b = 0.0f;
        for (int i = lane; i < lm; i += 32) {
            const float fk = f[i + 1], bk = b[i];
            num = fmaf(fk, bk, num);
            den_f = fmaf(fk, fk, den_f);
            den_b = fmaf(bk, bk, den_b);
        }
        num = -2.0f * warp_sum(num);
        const float den = warp_sum(den_f) + warp_sum(den_b);
        const float k = num / fmaxf(den, 1e-30f);
        for (int base = 0; base < lm; base += 32) {
            const int i = base + lane;
            float fk = 0.0f, bk = 0.0f;
            if (i < lm) {
                fk = f[i + 1];
                bk = b[i];
            }
            __syncwarp();
            if (i < lm) {
                f[i] = __fadd_rn(fk, __fmul_rn(k, bk));
                b[i] = __fadd_rn(bk, __fmul_rn(k, fk));
            }
            __syncwarp();
        }
        const float rev = __shfl_sync(kFull, a, (m - 1 - lane) & 31);
        if (levinson && lane < m) a = __fadd_rn(a, __fmul_rn(k, rev));
        if (lane == m) a = k;
    }
    if (lane < order) out[row * order + lane] = a;
}

}  // namespace

extern "C" int burg_lpc_f32(const float* frames, float* out, int M, int nw, int order,
                            int levinson, void* stream)
{
    if (M < 1 || nw < 2 || order < 1 || order > kMaxOrder || order >= nw)
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * (size_t)kWarps * 2 * nw;
    cudaError_t err = cudaFuncSetAttribute(
        burg_lpc_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_blocks = (M + kWarps - 1) / kWarps;
    burg_lpc_f32_kernel<<<n_blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
        frames, out, M, nw, order, levinson);
    return (int)cudaGetLastError();
}
