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
// frames of 550, order 10) about 10.4 GFLOP (0.156 ms at 67 TFLOP/s)
// against one 422 MB read of the frames (0.126 ms at 3.35 TB/s).
//
// What held the first design back (a warp a frame, f and b in shared
// memory, 1.157 ms on the H100): each step made a reduction pass and an
// update pass over the prefix, with two warp barriers every 32 elements,
// about six shared-memory words an element a step, so shared-memory
// bandwidth set the pace, at 13 % of the bound.
//
// Design: the frame lives in registers. Lane i of a warp holds f and b of
// elements [i*C, (i+1)*C) (C a template argument), read once through shared
// memory: the lane's C coalesced row loads all in flight before the first
// store, then its chunk, a gcd(C, 32)-way conflict paid once. The shift
// f[i+1] is a register rename inside a chunk and one shuffle at its end;
// after the staging read there is no shared-memory traffic. Each step is
// one register pass that updates f and b, then the next step's three lane
// partial sums in ascending element order, counted only below the next
// prefix (a predicate per element: elements at or past it hold values no
// valid element reads, and the padding past nw stays zero), then three
// butterflies. den is sum_f + sum_b as the plain version adds them. Frames
// wider than 32*32 elements take 2 or 4 warps (plan): each warp reduces its
// partials, publishes them with its first f and last b in shared memory,
// and one named barrier a step lets every warp of the frame add them, with
// the terms across warp boundaries, in the same order. Lane i keeps
// a_{i+1} in a register and takes a_{m-1-i} from its neighbour by shuffle.
// The updates use explicitly rounded multiply and add, as the plain
// version's separate torch ops round, so about 8 instructions an element a
// step remain: at the tracker's shape the kernel is bound by their issue
// (about 0.5 ms on the H100, chip_smoke.py phase 10), not by the bound.
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;  // warps a block
constexpr int kMaxOrder = 32;
constexpr int kMaxNw = 3632;
constexpr int kChunks[] = {1, 2, 4, 6, 8, 12, 16, 18, 20, 24, 28, 32};
constexpr int kXch = 5;    // a warp's exchange slot: first f, last b, three partials
constexpr unsigned kFull = 0xffffffffu;

constexpr int blocks_per_sm(int C) { return C <= 12 ? 4 : C <= 20 ? 3 : 2; }

struct Plan {
    int chunk, warps_per_frame, blocks_per_sm, shared_bytes;
};

Plan make_plan(int nw)
{
    Plan p;
    p.warps_per_frame = nw <= 32 * 32 ? 1 : nw <= 2 * 32 * 32 ? 2 : 4;
    const int need = (nw + 32 * p.warps_per_frame - 1) / (32 * p.warps_per_frame);
    p.chunk = kChunks[sizeof(kChunks) / sizeof(int) - 1];
    for (int c : kChunks)
        if (c >= need) { p.chunk = c; break; }
    p.blocks_per_sm = blocks_per_sm(p.chunk);
    p.shared_bytes = 4 * (kWarps * 32 * p.chunk + 2 * kWarps * kXch);
    return p;
}

__device__ __forceinline__ float warp_sum(float v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

// The sums of step m over i < lm = nw-1-m: (pn, pf, pb) = the frame's
// sum f[i+1]*b[i], sum f[i+1]^2, sum b[i]^2; fnext <- f at the element after
// this lane's chunk, as the next update reads it.
template <int C>
__device__ __forceinline__ void step_sums(const float (&f)[C], const float (&b)[C], int m, int nw, int first,
                                          int lane, int wf, int wif, int bar, float* xch, float& fnext,
                                          float& pn, float& pf, float& pb)
{
    const int lm = nw - 1 - m;
    const int lim = lm - first;  // elements of this chunk below the prefix
    fnext = __shfl_down_sync(kFull, f[0], 1);
    if (lane == 31) fnext = 0.0f;  // past the warp: a cross-warp term below, or the zero padding
    pn = pf = pb = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float fk = c + 1 < C ? f[c + 1] : fnext;
        if (c < lim) {
            pn = fmaf(fk, b[c], pn);
            pf = fmaf(fk, fk, pf);
            pb = fmaf(b[c], b[c], pb);
        }
    }
    pn = warp_sum(pn);
    pf = warp_sum(pf);
    pb = warp_sum(pb);
    if (wf == 1) return;
    float* step = xch + (m & 1) * kWarps * kXch;  // this step's slots of the block
    float* mine = step + (threadIdx.x >> 5) * kXch;
    if (lane == 0) {
        mine[0] = f[0];
        mine[2] = pn;
        mine[3] = pf;
        mine[4] = pb;
    }
    if (lane == 31) mine[1] = b[C - 1];
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(32 * wf) : "memory");
    const float* s = step + ((threadIdx.x >> 5) - wif) * kXch;  // the frame's first warp
    pn = pf = pb = 0.0f;
    for (int v = 0; v < wf; ++v) {
        pn += s[v * kXch + 2];
        pf += s[v * kXch + 3];
        pb += s[v * kXch + 4];
        if (v + 1 < wf && (v + 1) * 32 * C - 1 < lm) {  // warp v's last element times warp v+1's first
            const float fk = s[(v + 1) * kXch];
            pn = fmaf(fk, s[v * kXch + 1], pn);
            pf = fmaf(fk, fk, pf);
        }
    }
    if (lane == 31 && wif + 1 < wf) fnext = s[(wif + 1) * kXch];
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32, blocks_per_sm(C))
burg_lpc_f32_kernel(const float* __restrict__ frames, float* __restrict__ out,
                    int M, int nw, int order, int levinson, int wf)
{
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int fib = warp / wf, wif = warp - fib * wf;  // frame in block, warp in frame
    const long long row = (long long)blockIdx.x * (kWarps / wf) + fib;
    if (row >= M) return;  // a frame's warps leave together; the block never synchronises
    float* stage = smem + warp * 32 * C;
    float* xch = smem + kWarps * 32 * C;  // [2][kWarps][kXch]
    const int base = wif * 32 * C;        // the frame element of the warp's first
    const float* src = frames + row * nw;
    float f[C], b[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {  // all of a lane's loads in flight before the first store
        const int i = base + lane + 32 * c;
        f[c] = i < nw ? src[i] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) stage[lane + 32 * c] = f[c];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < C; ++c) f[c] = b[c] = stage[lane * C + c];
    const int first = base + lane * C;
    const int bar = 1 + fib;  // named barrier of the frame's warps (0 is __syncthreads)

    float fnext, pn, pf, pb;
    step_sums<C>(f, b, 0, nw, first, lane, wf, wif, bar, xch, fnext, pn, pf, pb);
    float a = 0.0f;  // lane i: k_{i+1} or a_{i+1}
    for (int m = 0; m < order; ++m) {
        const float k = (-2.0f * pn) / fmaxf(pf + pb, 1e-30f);
        const float rev = __shfl_sync(kFull, a, (m - 1 - lane) & 31);
        if (levinson && lane < m) a = __fadd_rn(a, __fmul_rn(k, rev));
        if (lane == m) a = k;
        if (m + 1 == order) break;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float fk = c + 1 < C ? f[c + 1] : fnext, bk = b[c];
            f[c] = __fadd_rn(fk, __fmul_rn(k, bk));
            b[c] = __fadd_rn(bk, __fmul_rn(k, fk));
        }
        step_sums<C>(f, b, m + 1, nw, first, lane, wf, wif, bar, xch, fnext, pn, pf, pb);
    }
    if (wif == 0 && lane < order) out[row * order + lane] = a;
}

template <int C>
int launch(const float* frames, float* out, int M, int nw, int order, int levinson, const Plan& p,
           cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        burg_lpc_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.shared_bytes);
    if (err != cudaSuccess) return (int)err;
    const int frames_per_block = kWarps / p.warps_per_frame;
    const long long n_blocks = ((long long)M + frames_per_block - 1) / frames_per_block;
    burg_lpc_f32_kernel<C><<<(unsigned)n_blocks, kWarps * 32, p.shared_bytes, stream>>>(
        frames, out, M, nw, order, levinson, p.warps_per_frame);
    return (int)cudaGetLastError();
}

}  // namespace

// the plan the launcher uses for frames of nw: C, warps a frame, blocks an
// SM (the kernel's launch bound), shared bytes a block
extern "C" int burg_lpc_f32_plan(int nw, int order, int* out)
{
    if (nw < 2 || nw > kMaxNw || order < 1 || order > kMaxOrder || order >= nw)
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(nw);
    out[0] = p.chunk;
    out[1] = p.warps_per_frame;
    out[2] = p.blocks_per_sm;
    out[3] = p.shared_bytes;
    return 0;
}

extern "C" int burg_lpc_f32(const float* frames, float* out, int M, int nw, int order,
                            int levinson, void* stream)
{
    if (M < 1 || nw < 2 || nw > kMaxNw || order < 1 || order > kMaxOrder || order >= nw)
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(nw);
    const cudaStream_t st = (cudaStream_t)stream;
    switch (p.chunk) {
        case 1: return launch<1>(frames, out, M, nw, order, levinson, p, st);
        case 2: return launch<2>(frames, out, M, nw, order, levinson, p, st);
        case 4: return launch<4>(frames, out, M, nw, order, levinson, p, st);
        case 6: return launch<6>(frames, out, M, nw, order, levinson, p, st);
        case 8: return launch<8>(frames, out, M, nw, order, levinson, p, st);
        case 12: return launch<12>(frames, out, M, nw, order, levinson, p, st);
        case 16: return launch<16>(frames, out, M, nw, order, levinson, p, st);
        case 18: return launch<18>(frames, out, M, nw, order, levinson, p, st);
        case 20: return launch<20>(frames, out, M, nw, order, levinson, p, st);
        case 24: return launch<24>(frames, out, M, nw, order, levinson, p, st);
        case 28: return launch<28>(frames, out, M, nw, order, levinson, p, st);
        case 32: return launch<32>(frames, out, M, nw, order, levinson, p, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
