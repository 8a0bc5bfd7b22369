// Fused MFCC frontend for Hopper (sm_90a) on the tensor cores: the f32, bf16,
// x3, i16 and i24 modes, audio -> mel power. Plain C launchers, loaded with
// ctypes (modulation_mfcc_tpu_torch/kernels/_build.py); each returns the
// cudaError_t of its launch. No fast-math intrinsics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "tensor_core.cuh"

// The staging plan of a launch (kernels/fused_frontend.tc_plan, passed by
// value in this field order); the launcher checks it against its own sum.
struct TcPlan {
    int frames, shifted, streamed, stages, n_copies, span_pad, mel_groups, shared_bytes;
};

namespace {

using namespace tc;

// ---------------------------------------------------------------------------
// fused_mel_f32, fused_mel_bf16, fused_mel_x3, fused_mel_i16, fused_mel_i24
//
// Replace the Pallas frontend kernels of modulation_mfcc_tpu/pallas/
// fused_frontend.py (fused_mel_frontend -> _launch) with algorithm 'f32',
// 'bf16' and 'x3' (_kernel and _kernel_pipe, _mxu's f32, bf16 and x3
// branches), 'i16' (_kernel_i16 and
// _kernel_i16_pipe, _i16_digits and _i16_reim) and 'i24' (_kernel_i24 and
// _kernel_i24_pipe, _i24_reim). The pipelined kernels compute their plain
// kernels' numbers bit for bit, so one kernel serves each pair.
//
// Computes, for every utterance b and frame f < nf, frame[k] = x[b, f*hop +
// off + k] (zero outside the buffer of T samples; int16 dequantized as
// v * 2^-15, exact), the windowed DFT's re and im, power = re^2 + im^2
// (FP32 products, then their sum), and mel = power @ melw in x3
// arithmetic (power and melw split into bf16 hi and lo; hi.hi products in
// one FP32 sum, hi.lo + lo.hi in another, added at the end; bf16: one
// pass; f32: the three-plane split below); and per block of 64 frames the
// maximum of mel over its valid frames.
//
//   'f32': an exact three-plane bf16 split of every operand, the TPU's own
//          f32 arithmetic (_mxu runs 'f32' as a Precision.HIGHEST dot, six
//          bf16 passes over three-way splits). Frame samples split here,
//          hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), with
//          hi + mid + lo == x for every normal float32 (each residue is
//          exact in FP32 and has at most 16, then 8 significant bits); the
//          basis arrives as its (hi, mid, lo) planes. A bf16 product is
//          exact in FP32. Of the nine products the six hh, hm, mh, hl, mm, lh
//          are kept: the three dropped are about 2^-25 of the term, the order
//          of one FFMA rounding. Each 16-row hi.hi MMA starts from zero and
//          is added to the running sum with FP32 adds (mma_bf16_add, as x3);
//          the five smaller products chain into a second sum; re and im are
//          the two sums added. On int16 input (v * 2^-15, at most 16
//          significant bits) the samples' lo plane is zero, and the lo.hi
//          product is skipped: it adds exact zeros. The power is split into
//          three planes the same way and projected onto the mel weights'
//          three planes with the same six products (mel_tile), so every
//          operand of the mel is exact too. The plain version
//          (kernels/fused_frontend._stepped_matmul) is a true FP32 GEMM in
//          16-row steps; _split3_matmul mirrors this arithmetic on the CPU.
//   'bf16': frame samples rounded to bf16 here (__float2bfloat16_rn), the
//          basis arrives rounded; one bf16 MMA a fragment, the MMAs of the
//          400 rows chained into one FP32 sum; the power rounded to bf16,
//          projected onto the bf16 mel weights in one pass (each 16-bin MMA
//          added with FP32 adds), the mel stored as bf16 and the maxima
//          taken over its FP32 values before that rounding (the TPU _emit).
//   'x3':  the DFT in x3 arithmetic: frame samples split into bf16 (hi, lo)
//          here (__float2bfloat16_rn), the basis arrives as (hi, lo) planes;
//          hi.Whi in one FP32 sum, hi.Wlo + lo.Whi in another, re and im
//          their sums. The apart sums keep low mel bins at the kernels' bar.
//          The tensor cores do not round each FP32 add to nearest: on the
//          H100 one chain of MMAs over the 400 rows came out twice as far
//          from the float64 sum of the same x3 products as the plain
//          version's FP32 GEMMs (relative, above the top_db floor, at
//          16 kHz). So each 16-row MMA of the hi.hi sum starts from zero
//          and is added to the running sum with FP32 adds (mma_bf16_add),
//          as the mel projection does, which brings the kernel to the
//          plain version's order of error (chip_smoke.py phases 14, 17).
//          The small products, 2^-8 of it, chain.
//   'i24': X = rint(frame * s) (half to even; (s, inv) per utterance from
//          the wrapper) in balanced int8 digits x2, x1, x0; the basis as
//          int8 planes w2, w1, w0; d1 = x2.w2, d2 = x2.w1 + x1.w2,
//          d3 = x2.w0 + x1.w1 + x0.w2 as exact int32 sums (at most
//          3 * 416 * 128^2 < 2^31), then ((d1 2^32 + d2 2^24) + d3 2^16) * inv
//          in FP32 in the JAX order. The sums are exact whatever order the
//          MMAs add in, so the power equals the plain version's bit for bit.
//   'i16': X = rint(frame * s) clipped to [-32768, 32767] (s a power of
//          two) in two int8 digits x1 = floor(X / 256), x0 = X - 256 x1 - 128;
//          the same basis planes; d1 = x1.w2, d2 = x1.w1 + x0.w2,
//          d3 = x1.w0 + x0.w1 (five MMAs a fragment into i24's three sums),
//          then (((d1 2^24 + d2 2^16) + d3 2^8) + corr) * inv, where corr (per
//          DFT column, from the wrapper) puts back the low digit's +128
//          offset. Exact sums again: the power is the plain version's bit
//          for bit.
//
// Bound: the tensor cores' operations. A 128 x 30 s batch at 16 kHz is 315
// GFLOP per K-row pass of the DFT and 50 GFLOP per pass of the mel
// projection; bf16 runs one bf16 pass of each (989 TFLOP/s dense: 0.37 ms),
// x3 three (1.1 ms), f32 six (2.2 ms; five of the DFT on int16 input), i24
// six int8 passes of the DFT (1,979 TOPS) and three bf16 of the
// mel (1.1 ms), i16 five int8 passes and the same mel (0.95 ms). The audio
// read and the mel write are ~0.2 ms at 3.35 TB/s.
//
// Design: a block owns 64 consecutive frames of one utterance (8 warps) and
// one group of 128 mel columns.
//  * The A operand (frames) never exists in device memory, nor (but in
//    the streamed plan below) as a frame tile in shared memory: the block
//    stages its audio span once, already
//    in the MMA's element type (bf16: one plane; x3: the bf16 hi and lo
//    planes; f32: hi, mid and lo; i16, i24: the two or three int8 digit
//    planes), and each thread loads its A fragments
//    straight from it: frame f, column k is span[f*hop + k], so the 8 bytes
//    a thread needs for a row are consecutive in the span. Where f*hop is
//    not a multiple of those 8 bytes (the 10 kHz default's hop of 50), the
//    span is staged 8 bytes / gcd more times, each copy shifted by gcd
//    elements, and a row reads the copy that aligns it.
//  * The B operand (basis planes) arrives pre-arranged by the wrapper (once
//    per set of weights), as [tile][k-step][plane][column][k] with re and
//    im columns interleaved, so that one 32-row chunk of a tile is one
//    contiguous block: a single thread streams chunks with the bulk-copy
//    engine into a ring of kStages shared-memory stages, each completing an
//    mbarrier; one __syncthreads a chunk returns a stage to the ring.
//  * A bin tile is kCols = 128 DFT columns (re and im of 64 bins). Warps
//    tile it 2 (32 frames) x 4 (32 columns): a thread holds 2 x 4
//    accumulator fragments per sum (bf16: 1 sum, 32 registers; x3, f32: 2,
//    64; i16, i24: 3 int32 sums, 96), so re and im of a bin are neighbours in
//    one thread, which forms the power (and its bf16 split) into a [64 x
//    64 bins] tile in shared memory. The tile's mel weights come in by bulk
//    copy while its DFT runs, and the tile is projected onto them
//    (tensor_core.cuh mel_tile) into the block's mel, held in registers
//    over all tiles (registers and spills of each mode: chip_smoke.py
//    phase 1). x3, f32, i16 and i24 take one block of 8 warps an SM (f32:
//    its three-plane stages, mel weights, power tile and span come to
//    211-219 KB of shared memory in the full plan at 16 kHz, kernels/fused_frontend.tc_plan);
//    bf16, with one sum and a one-plane mel, fits in 128 registers and
//    takes two, which beat 128-frame blocks of 64-frame warp tiles on the
//    H100 (one block an SM, half the weight stream a frame).
//  * The staging plan (TcPlan; its one owner is kernels/fused_frontend.
//    tc_plan) is the first of three rungs that fits the block in the 227 KB
//    of shared memory. The full plan is the above: 64 frames (MT = 2 MMA
//    tiles of 16 a warp), the span in its shifted copies, four stages.
//    Where that does not fit (large hops: the span is 63 hop + Kp; odd
//    hops: four copies), the compact plan takes 32 frames (MT = 1), one
//    span copy whose rows each thread aligns in registers (two aligned
//    8-byte loads and a funnel shift, kShifted), and two to four stages.
//    Two blocks then share a block maximum, merged by atomicMax. The span
//    still grows with the hop and the window: at 22.05 kHz and more with a
//    30 ms hop (44.1 kHz from 15 ms), f32's and x3's compact plans do not
//    fit either. The streamed plan (kStream) stages no span: each stage of
//    the ring holds, beside its basis chunk, the A tile of that chunk, 64
//    frames x 32 rows in the mode's planes, written by the threads from the
//    audio while the chunk before it is multiplied (load_a_tile before the
//    MMAs, store_a_tile after), so its shared memory is the same at every
//    hop and window (f32: 227,456 bytes). Each frame's fragments hold the
//    same elements in the same 16-row MMAs as in the other plans, so every
//    plan computes the same mel bit for bit (chip_smoke.py phase 24). The
//    tile is staged again for every bin tile, with one chunk of MMAs to hide
//    its loads: forced at the 16 kHz flagship it takes 1.18 x the full
//    plan's time (PERF.md §6).
//  * More than 128 mel bands (up to kMelLimit): the grid's z is the mel
//    group, each group a block of its own that recomputes the DFT and
//    projects onto the group's 128 columns of the weights.
// Times on the H100: PERF.md §6 (chip_smoke.py phase 17). A narrower i24
// warp tile (16 x 32, 48 accumulators) and per-warp release of the weight
// stages through mbarriers, in place of the block barrier per chunk, were
// both slower there. wgmma (a warpgroup's 64-row MMAs, B straight from
// shared memory) is the next step.
// ---------------------------------------------------------------------------

constexpr int kX3 = 0, kI16 = 1, kI24 = 2, kBF16 = 3, kF32 = 4;

template <int MODE> struct Mode;
template <> struct Mode<kX3> {
    using T = __nv_bfloat16;               // element of the span planes and the basis
    using Out = float;                     // element of the mel
    static constexpr int kSpanPlanes = 2;  // the samples' (hi, lo)
    static constexpr int kBasisPlanes = 2; // the basis' (hi, lo)
    static constexpr int kStep = 16;       // contraction rows per MMA
    static constexpr int kMelPlanes = 2;   // the power's and the mel weights' (hi, lo)
};
template <> struct Mode<kI16> {
    using T = int8_t;
    using Out = float;
    static constexpr int kSpanPlanes = 2;  // digits x1, x0
    static constexpr int kBasisPlanes = 3; // planes w2, w1, w0
    static constexpr int kStep = 32;
    static constexpr int kMelPlanes = 2;
};
template <> struct Mode<kI24> {
    using T = int8_t;
    using Out = float;
    static constexpr int kSpanPlanes = 3;  // digits x2, x1, x0
    static constexpr int kBasisPlanes = 3; // planes w2, w1, w0
    static constexpr int kStep = 32;
    static constexpr int kMelPlanes = 2;
};
template <> struct Mode<kBF16> {
    using T = __nv_bfloat16;
    using Out = __nv_bfloat16;
    static constexpr int kSpanPlanes = 1;  // the samples rounded to bf16
    static constexpr int kBasisPlanes = 1;
    static constexpr int kStep = 16;
    static constexpr int kMelPlanes = 1;   // the power and the mel weights rounded to bf16
};
template <> struct Mode<kF32> {
    using T = __nv_bfloat16;
    using Out = float;
    static constexpr int kSpanPlanes = 3;  // the samples' (hi, mid, lo)
    static constexpr int kBasisPlanes = 3; // the basis' (hi, mid, lo)
    static constexpr int kStep = 16;
    static constexpr int kMelPlanes = 3;   // the power's and the mel weights' (hi, mid, lo)
};

template <int MODE> constexpr int kAl = 8 / (int)sizeof(typename Mode<MODE>::T);  // elements per 8-byte load
template <int MODE> constexpr int kChunkBytes =
    kChunkRows * kCols * Mode<MODE>::kBasisPlanes * (int)sizeof(typename Mode<MODE>::T);
template <int MODE> constexpr int kMelBytes = kTileBins * Mode<MODE>::kMelPlanes * kMelCols * 2;  // a tile's mel weights
template <int MODE, int MT> constexpr int kPowerBytes = Mode<MODE>::kMelPlanes * 32 * MT * kPitch * 2;
// the streamed plan's A tile of a stage: [plane][kBF frames][kChunkRows]
template <int MODE> constexpr int kATileBytes =
    Mode<MODE>::kSpanPlanes * kBF * kChunkRows * (int)sizeof(typename Mode<MODE>::T);
// where a block reads its A fragments: the span in shifted copies (full
// plan), one span copy aligned in registers (compact), or the A tile of each
// stage (streamed)
enum ASource { kCopies, kShifted, kStream };

__device__ __forceinline__ float load_sample(const float* x, long long s) { return x[s]; }
__device__ __forceinline__ float load_sample(const int16_t* x, long long s)
{
    return static_cast<float>(x[s]) * (1.0f / 32768.0f);  // exact
}

// the span planes' values of one sample: bf16, its nearest bf16
__device__ __forceinline__ void planes_of(float v, float, __nv_bfloat16 (&p)[1]) { p[0] = __float2bfloat16_rn(v); }

// x3, its bf16 (hi, lo) split
__device__ __forceinline__ void planes_of(float v, float, __nv_bfloat16 (&p)[2])
{
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    p[0] = hi;
    p[1] = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// f32, its exact three-plane bf16 split: hi + mid + lo == v
__device__ __forceinline__ void planes_of(float v, float, __nv_bfloat16 (&p)[3])
{
    p[0] = __float2bfloat16_rn(v);
    const float r = __fsub_rn(v, __bfloat162float(p[0]));
    p[1] = __float2bfloat16_rn(r);
    p[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(p[1])));
}

// the two digits of rint(v * s) clipped to 16 bits, the low one offset by
// -128, as _i16_digits
__device__ __forceinline__ void planes_of(float v, float s, int8_t (&p)[2])
{
    const float x = fminf(fmaxf(rintf(__fmul_rn(v, s)), -32768.0f), 32767.0f);
    const float x1 = floorf(x * (1.0f / 256.0f));
    p[0] = static_cast<int8_t>(x1);
    p[1] = static_cast<int8_t>(x - 256.0f * x1 - 128.0f);
}

// balanced base-256 digits of rint(v * s), highest first, as _i24_reim
__device__ __forceinline__ void planes_of(float v, float s, int8_t (&p)[3])
{
    const float x = rintf(__fmul_rn(v, s));
    const float q1 = floorf((x + 128.0f) * (1.0f / 256.0f));
    const float q2 = floorf((q1 + 128.0f) * (1.0f / 256.0f));
    p[0] = static_cast<int8_t>(q2);
    p[1] = static_cast<int8_t>(q1 - 256.0f * q2);
    p[2] = static_cast<int8_t>(x - 256.0f * q1);
}

// the bits of one plane element, for packing a fragment's 8 bytes
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 e) { return __bfloat16_as_ushort(e); }
__device__ __forceinline__ uint32_t bits_of(int8_t e) { return static_cast<uint8_t>(e); }

// The streamed plan's A tile of the chunk at contraction row k0: frame f
// (0 .. kBF - 1), row r at sample start + f hop + k0 + r of the utterance x
// (zero outside its T samples). A thread takes kAUnits units of kAl
// consecutive rows (8 bytes of a plane) of one frame: load_a_tile reads
// their samples into registers, store_a_tile writes their planes (planes_of,
// as the span's staging) to the tile, [plane][frame][kChunkRows], the 8-byte
// unit u of frame f at u ^ 4 ((f >> 1) & 1) for bf16 planes: a half warp's
// fragment loads, rows g .. g + 3 at units 4j + t, then meet no bank twice.
template <int MODE> constexpr int kAUnits = kBF * kChunkRows / kAl<MODE> / kThreads;

template <int MODE, typename In>
__device__ __forceinline__ void load_a_tile(float (&v)[kAUnits<MODE>][kAl<MODE>], const In* x, int T,
                                            long long start, int hop, int k0, int tid)
{
    constexpr int al = kAl<MODE>, per_row = kChunkRows / al;
#pragma unroll
    for (int k = 0; k < kAUnits<MODE>; ++k) {
        const int i = tid + kThreads * k, f = i / per_row, u = i % per_row;
        const long long s0 = start + (long long)f * hop + k0 + al * u;
#pragma unroll
        for (int e = 0; e < al; ++e) {
            const long long smp = s0 + e;
            v[k][e] = (smp >= 0 && smp < T) ? load_sample(x, smp) : 0.0f;
        }
    }
}

template <int MODE>
__device__ __forceinline__ void store_a_tile(typename Mode<MODE>::T* tile, const float (&v)[kAUnits<MODE>][kAl<MODE>],
                                             float s, int tid)
{
    using E = typename Mode<MODE>::T;
    constexpr int al = kAl<MODE>, per_row = kChunkRows / al, planes = Mode<MODE>::kSpanPlanes;
#pragma unroll
    for (int k = 0; k < kAUnits<MODE>; ++k) {
        const int i = tid + kThreads * k, f = i / per_row, u = i % per_row;
        const int us = sizeof(E) == 2 ? u ^ (((f >> 1) & 1) << 2) : u;
        E p[al][planes];
#pragma unroll
        for (int e = 0; e < al; ++e) planes_of(v[k][e], s, p[e]);
#pragma unroll
        for (int q = 0; q < planes; ++q) {
            uint32_t w[2] = {0u, 0u};
#pragma unroll
            for (int e = 0; e < al; ++e) w[e / (al / 2)] |= bits_of(p[e][q]) << (8 * (int)sizeof(E) * (e % (al / 2)));
            *reinterpret_cast<uint2*>(tile + (q * kBF + f) * kChunkRows + al * us) = make_uint2(w[0], w[1]);
        }
    }
}

// the exact int32 sums -> the DFT value, FP32 in the JAX order (i24)
__device__ __forceinline__ float recombine(int d1, int d2, int d3, float inv)
{
    const float a = __int2float_rn(d1), b = __int2float_rn(d2), c = __int2float_rn(d3);
    return __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, 4294967296.0f), __fmul_rn(b, 16777216.0f)),
                               __fmul_rn(c, 65536.0f)), inv);
}

// the same for i16, with the column's offset correction
__device__ __forceinline__ float recombine(int d1, int d2, int d3, float corr, float inv)
{
    const float a = __int2float_rn(d1), b = __int2float_rn(d2), c = __int2float_rn(d3);
    return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, 16777216.0f), __fmul_rn(b, 65536.0f)),
                                         __fmul_rn(c, 256.0f)), corr), inv);
}

template <int MODE, int MT>
struct Acc;  // the DFT sums of a thread
template <int MT> struct Acc<kX3, MT> { float hh[MT][4][4], sm[MT][4][4]; };
template <int MT> struct Acc<kI16, MT> { int d[3][MT][4][4]; };
template <int MT> struct Acc<kI24, MT> { int d[3][MT][4][4]; };
template <int MT> struct Acc<kBF16, MT> { float s[MT][4][4]; };
template <int MT> struct Acc<kF32, MT> : Acc<kX3, MT> {};

// one chunk (kChunkRows contraction rows from k0) of the tile's DFT; LO_ZERO:
// the samples' f32 lo plane is zero (int16 input), so lo.hi is skipped.
// a: the span (kCopies, kShifted; planes a_plane elements apart) or the
// stage's A tile (kStream: k0 is then the tile's row 0, and step j of the
// thread's rows sits at j ^ a_flip, store_a_tile's swizzle); a_off: the
// 8-byte aligned offset of each of the thread's A rows; kShifted: the row
// starts a_sh[mt][h] bytes (0 .. 7) past it, and its 8 bytes are cut from
// the 16 of two aligned loads
template <int MODE, int MT, int AS, bool LO_ZERO>
__device__ __forceinline__ void dft_chunk(Acc<MODE, MT>& acc, const typename Mode<MODE>::T* a_src, int a_plane,
                                          const int (&a_off)[MT][2], const int (&a_sh)[MT][2], int a_flip,
                                          const typename Mode<MODE>::T* stage, int k0, int col0, int t)
{
    using M = Mode<MODE>;
#pragma unroll
    for (int j = 0; j < kChunkRows / M::kStep; ++j) {
        uint32_t a[M::kSpanPlanes][MT][4];
        const int kj = AS == kStream ? M::kStep * (j ^ a_flip) : k0 + M::kStep * j;
#pragma unroll
        for (int p = 0; p < M::kSpanPlanes - (LO_ZERO ? 1 : 0); ++p)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const auto* row = a_src + p * a_plane + a_off[mt][h] + kj;
                    const uint2 v = *reinterpret_cast<const uint2*>(row);
                    if constexpr (AS == kShifted) {
                        const uint2 u = *reinterpret_cast<const uint2*>(row + kAl<MODE>);
                        const bool up = a_sh[mt][h] >= 4;
                        const int bits = 8 * (a_sh[mt][h] & 3);
                        const uint32_t w0 = up ? v.y : v.x, w1 = up ? u.x : v.y, w2 = up ? u.y : u.x;
                        a[p][mt][h] = __funnelshift_r(w0, w1, bits);
                        a[p][mt][2 + h] = __funnelshift_r(w1, w2, bits);
                    } else {
                        a[p][mt][h] = v.x;
                        a[p][mt][2 + h] = v.y;
                    }
                }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            // column col0 + 8 nt of step j, plane p: [j][p][kCols][kStep]
            uint2 w[M::kBasisPlanes];
#pragma unroll
            for (int p = 0; p < M::kBasisPlanes; ++p)
                w[p] = *reinterpret_cast<const uint2*>(
                    stage + ((j * M::kBasisPlanes + p) * kCols + col0 + 8 * nt) * M::kStep + kAl<MODE> * t);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                if constexpr (MODE == kBF16) {
                    mma_bf16(acc.s[mt][nt], a[0][mt], w[0].x, w[0].y);
                } else if constexpr (MODE == kX3) {
                    mma_bf16_add(acc.hh[mt][nt], a[0][mt], w[0].x, w[0].y);
                    mma_bf16(acc.sm[mt][nt], a[0][mt], w[1].x, w[1].y);
                    mma_bf16(acc.sm[mt][nt], a[1][mt], w[0].x, w[0].y);
                } else if constexpr (MODE == kF32) {
                    mma_bf16_add(acc.hh[mt][nt], a[0][mt], w[0].x, w[0].y);        // hi.hi
                    mma_bf16(acc.sm[mt][nt], a[0][mt], w[1].x, w[1].y);            // hi.mid
                    mma_bf16(acc.sm[mt][nt], a[1][mt], w[0].x, w[0].y);            // mid.hi
                    mma_bf16(acc.sm[mt][nt], a[0][mt], w[2].x, w[2].y);            // hi.lo
                    mma_bf16(acc.sm[mt][nt], a[1][mt], w[1].x, w[1].y);            // mid.mid
                    if constexpr (!LO_ZERO) mma_bf16(acc.sm[mt][nt], a[2][mt], w[0].x, w[0].y);  // lo.hi
                } else if constexpr (MODE == kI16) {
                    mma_s8(acc.d[0][mt][nt], a[0][mt], w[0].x, w[0].y);  // x1.w2
                    mma_s8(acc.d[1][mt][nt], a[0][mt], w[1].x, w[1].y);  // x1.w1
                    mma_s8(acc.d[1][mt][nt], a[1][mt], w[0].x, w[0].y);  // x0.w2
                    mma_s8(acc.d[2][mt][nt], a[0][mt], w[2].x, w[2].y);  // x1.w0
                    mma_s8(acc.d[2][mt][nt], a[1][mt], w[1].x, w[1].y);  // x0.w1
                } else {
                    mma_s8(acc.d[0][mt][nt], a[0][mt], w[0].x, w[0].y);  // x2.w2
                    mma_s8(acc.d[1][mt][nt], a[0][mt], w[1].x, w[1].y);  // x2.w1
                    mma_s8(acc.d[1][mt][nt], a[1][mt], w[0].x, w[0].y);  // x1.w2
                    mma_s8(acc.d[2][mt][nt], a[0][mt], w[2].x, w[2].y);  // x2.w0
                    mma_s8(acc.d[2][mt][nt], a[1][mt], w[1].x, w[1].y);  // x1.w1
                    mma_s8(acc.d[2][mt][nt], a[2][mt], w[0].x, w[0].y);  // x0.w2
                }
            }
        }
    }
}

template <int MODE, typename In, int MT, int AS>
__global__ void __launch_bounds__(kThreads, 1)
fused_mel_tc_kernel(const In* __restrict__ audio, const typename Mode<MODE>::T* __restrict__ wtc,
                    const __nv_bfloat16* __restrict__ mtc, const float* __restrict__ sc,
                    const float* __restrict__ corr, void* __restrict__ mel, float* __restrict__ bmax, int T, int Kp, int hop, int off,
                    int nf, int bins_pad, int n_mels, int span_pad, int n_copies, int shift_log2, int plan_stages)
{
    using M = Mode<MODE>;
    using E = typename M::T;
    constexpr int BF = 32 * MT;  // frames a block
    constexpr bool kFixed = MODE == kI16 || MODE == kI24;
    constexpr bool kLoZero = MODE == kF32 && std::is_same<In, int16_t>::value;
    // the full and streamed plans' rings are a constant; the compact plan's comes with it
    const int stages = MT == kMT ? kStages : plan_stages;
    // a stage: the basis chunk, then (streamed) the chunk's A tile
    constexpr int kStage = kChunkBytes<MODE> + (AS == kStream ? kATileBytes<MODE> : 0);
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);                 // [stages] chunk barriers
    uint64_t* mel_bar = full + kStages;                                  // the tile's mel weights
    float* red_s = reinterpret_cast<float*>(smem + 64);                  // [kThreads / 32] warp maxima
    unsigned char* ring = smem + 128;                                    // stages x kStage
    auto* mel_w = reinterpret_cast<__nv_bfloat16*>(ring + stages * kStage);  // [steps][planes][128][16]
    auto* pw = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<unsigned char*>(mel_w) + kMelBytes<MODE>);
    E* span = reinterpret_cast<E*>(reinterpret_cast<unsigned char*>(pw) + kPowerBytes<MODE, MT>);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * BF;
    const int group = blockIdx.z;  // of 128 mel columns
    const In* x = audio + (size_t)b * T;
    const float s = kFixed ? sc[2 * b] : 0.0f;
    const float inv = kFixed ? sc[2 * b + 1] : 0.0f;
    const int n_chunks = Kp / kChunkRows;
    const int n_tiles = 2 * bins_pad / kCols;
    const int total = n_tiles * n_chunks;
    const int span_plane = n_copies * span_pad;  // elements of one plane's copies
    const __nv_bfloat16* mtc_g = mtc + (size_t)group * (bins_pad / kTileBins) * (kMelBytes<MODE> / 2);

    if (tid == 0) {
        for (int i = 0; i < kStages + 1; ++i) mbar::init(full + i, 1);
        mbar::fence_init();
    }
    // the span in the planes' element type: copy c holds span[i + c * 2^shift_log2]
    // (streamed: span_plane is 0, and the stages' A tiles take its place)
    const long long start = (long long)f0 * hop + off;
    for (int i = tid; i < span_plane; i += kThreads) {
        const int c = i / span_pad;
        const long long smp = start + (i - c * span_pad) + ((long long)c << shift_log2);
        const float v = (smp >= 0 && smp < T) ? load_sample(x, smp) : 0.0f;
        E p[M::kSpanPlanes];
        planes_of(v, s, p);
#pragma unroll
        for (int q = 0; q < M::kSpanPlanes; ++q) span[q * span_plane + i] = p[q];
    }
    __syncthreads();

    auto issue = [&](int q) {  // chunk q of the (tile, chunk) sequence -> its stage
        const int tile = q / n_chunks, chunk = q % n_chunks;
        const E* src = wtc + ((size_t)tile * Kp + (size_t)chunk * kChunkRows) * kCols * M::kBasisPlanes;
        bulk_load(ring + (q % stages) * kStage, src, kChunkBytes<MODE>, full + q % stages);
    };
    if (tid == 0)
        for (int q = 0; q < stages - 1 && q < total; ++q) issue(q);
    // streamed: the A tile of chunk q of the sequence, in its stage
    auto a_tile = [&](int q) { return reinterpret_cast<E*>(ring + (q % stages) * kStage + kChunkBytes<MODE>); };
    float a_next[kAUnits<MODE>][kAl<MODE>];  // streamed: the samples of the tile stages - 1 chunks ahead
    if constexpr (AS == kStream)
        for (int q = 0; q < stages - 1 && q < total; ++q) {
            load_a_tile<MODE>(a_next, x, T, start, hop, (q % n_chunks) * kChunkRows, tid);
            store_a_tile<MODE>(a_tile(q), a_next, s, tid);
        }

    // this thread's A rows: their offsets into a plane, in the copy that
    // aligns them to 8 bytes (kShifted: one copy, the offset rounded down to
    // 8 bytes and the remainder a_sh in bytes; kStream: the row of the tile,
    // the swizzle's flip for bf16 planes)
    const int wm = warp / kWN, wn = warp % kWN;
    int a_off[MT][2], a_sh[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = 16 * MT * wm + 16 * mt + 8 * h + g;
            const int e = row * hop;
            const int r = e & (kAl<MODE> - 1);
            a_off[mt][h] = AS == kStream ? row * kChunkRows + kAl<MODE> * t
                                         : (AS == kShifted ? 0 : (r >> shift_log2) * span_pad) + e - r + kAl<MODE> * t;
            a_sh[mt][h] = AS == kShifted ? r * (int)sizeof(E) : 0;
        }
    const int a_flip = AS == kStream && sizeof(E) == 2 ? (g >> 1) & 1 : 0;
    const int a_plane = AS == kStream ? kBF * kChunkRows : span_plane;
    const int col0 = 32 * wn + g;

    float mel_hh[MT][4][4], mel_sm[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) { mel_hh[mt][nt][i] = 0.0f; mel_sm[mt][nt][i] = 0.0f; }

    for (int tile = 0; tile < n_tiles; ++tile) {
        Acc<MODE, MT> acc;
        if constexpr (MODE == kBF16) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc.s[mt][nt][i] = 0.0f;
        } else if constexpr (MODE == kX3 || MODE == kF32) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                    for (int i = 0; i < 4; ++i) { acc.hh[mt][nt][i] = 0.0f; acc.sm[mt][nt][i] = 0.0f; }
        } else {
#pragma unroll
            for (int d = 0; d < 3; ++d)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                        for (int i = 0; i < 4; ++i) acc.d[d][mt][nt][i] = 0;
        }
        for (int chunk = 0; chunk < n_chunks; ++chunk) {
            const int q = tile * n_chunks + chunk;
            __syncthreads();  // every warp is done with chunk q - 1 (and, at chunk 0, the last tile's mel)
            if (tid == 0) {
                if (q + stages - 1 < total) issue(q + stages - 1);
                if (chunk == 0) bulk_load(mel_w, mtc_g + (size_t)tile * kMelBytes<MODE> / 2, kMelBytes<MODE>, mel_bar);
            }
            // streamed: chunk q + stages - 1's samples are read before the MMAs
            // and written to its stage (whose chunk q - 1 every warp is done
            // with) after them, so their latency hides behind chunk q
            const int qa = q + stages - 1;
            if constexpr (AS == kStream)
                if (qa < total) load_a_tile<MODE>(a_next, x, T, start, hop, (qa % n_chunks) * kChunkRows, tid);
            mbar::wait(full + q % stages, (q / stages) & 1);
            const E* stage = reinterpret_cast<const E*>(ring + (q % stages) * kStage);
            dft_chunk<MODE, MT, AS, kLoZero>(acc, AS == kStream ? a_tile(q) : span, a_plane, a_off, a_sh, a_flip,
                                            stage, chunk * kChunkRows, col0, t);
            if constexpr (AS == kStream)
                if (qa < total) store_a_tile<MODE>(a_tile(qa), a_next, s, tid);
        }

        // power of each (frame, bin) this thread holds, rounded to bf16 (x3, i16,
        // i24: split into bf16 hi and lo; f32: into hi, mid and lo).
        // The fragment's columns 2t and 2t + 1 of n-tile nt are the re and im
        // of the tile's bin 16 wn + 4 nt + t.
        float c_re[4], c_im[4];  // i16: those bins' offset corrections
        if constexpr (MODE == kI16) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int bin = tile * kTileBins + 16 * wn + 4 * nt + t;
                c_re[nt] = __ldg(corr + bin);
                c_im[nt] = __ldg(corr + bins_pad + bin);
            }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float re, im;
                    if constexpr (MODE == kBF16) {
                        re = acc.s[mt][nt][2 * h];
                        im = acc.s[mt][nt][2 * h + 1];
                    } else if constexpr (MODE == kX3 || MODE == kF32) {
                        re = acc.hh[mt][nt][2 * h] + acc.sm[mt][nt][2 * h];
                        im = acc.hh[mt][nt][2 * h + 1] + acc.sm[mt][nt][2 * h + 1];
                    } else if constexpr (MODE == kI16) {
                        re = recombine(acc.d[0][mt][nt][2 * h], acc.d[1][mt][nt][2 * h], acc.d[2][mt][nt][2 * h],
                                       c_re[nt], inv);
                        im = recombine(acc.d[0][mt][nt][2 * h + 1], acc.d[1][mt][nt][2 * h + 1],
                                       acc.d[2][mt][nt][2 * h + 1], c_im[nt], inv);
                    } else {
                        re = recombine(acc.d[0][mt][nt][2 * h], acc.d[1][mt][nt][2 * h], acc.d[2][mt][nt][2 * h], inv);
                        im = recombine(acc.d[0][mt][nt][2 * h + 1], acc.d[1][mt][nt][2 * h + 1],
                                       acc.d[2][mt][nt][2 * h + 1], inv);
                    }
                    const float p = power_of(re, im);
                    const __nv_bfloat16 hi = __float2bfloat16_rn(p);
                    const int o = (16 * MT * wm + 16 * mt + 8 * h + g) * kPitch + 16 * wn + 4 * nt + t;
                    pw[o] = hi;
                    if constexpr (M::kMelPlanes >= 2) {
                        const float r = __fsub_rn(p, __bfloat162float(hi));
                        const __nv_bfloat16 mid = __float2bfloat16_rn(r);
                        pw[BF * kPitch + o] = mid;
                        if constexpr (M::kMelPlanes == 3)
                            pw[2 * BF * kPitch + o] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
                    }
                }
        __syncthreads();  // the power tile is complete
        mbar::wait(mel_bar, tile & 1);
        mel_tile<kTileBins / kMelStep, M::kMelPlanes, MT>(mel_hh, mel_sm, pw, kPitch, mel_w, lane, warp);
    }
    write_mel<MT>(mel_hh, mel_sm, static_cast<typename M::Out*>(mel), bmax, red_s, b, f0, nf, n_mels,
                  kMelCols * group, MT != kMT || gridDim.z > 1, lane, warp);
}

// the launch's shared memory, and the plan's fields it rests on, recomputed
// from the plan's choices (frames, shifted, streamed, stages) as tc_plan
// computes them; false where the plan is none of the three rungs, disagrees
// or does not fit
template <int MODE>
int gcd_log2(int hop)  // log2 gcd(hop, kAl): the shift between span copies
{
    int s = 0;
    while ((2 << s) <= kAl<MODE> && hop % (2 << s) == 0) ++s;
    return s;
}

template <int MODE>
bool plan_holds(const TcPlan& p, int Kp, int hop, int n_mels)
{
    constexpr int al = kAl<MODE>;
    using E = typename Mode<MODE>::T;
    const bool full = p.frames == kBF && !p.shifted && !p.streamed && p.stages == kStages;
    const bool compact = p.frames == kBF / 2 && p.shifted && !p.streamed && p.stages >= 2 && p.stages <= kStages;
    const bool streamed = p.frames == kBF && !p.shifted && p.streamed == 1 && p.stages == kStages;
    if (!full && !compact && !streamed) return false;
    const int n_copies = streamed ? 0 : p.shifted ? 1 : al >> gcd_log2<MODE>(hop);
    const int span_pad = streamed ? 0 : ((p.frames - 1) * hop + Kp + (p.shifted ? al : 0) + 15) / 16 * 16;
    const long long smem = 128 + (long long)p.stages * (kChunkBytes<MODE> + (streamed ? kATileBytes<MODE> : 0)) +
                           kMelBytes<MODE> + (long long)Mode<MODE>::kMelPlanes * p.frames * kPitch * 2 +
                           (long long)Mode<MODE>::kSpanPlanes * n_copies * span_pad * (long long)sizeof(E);
    return p.n_copies == n_copies && p.span_pad == span_pad && p.shared_bytes == smem &&
           smem <= kSharedMax && p.mel_groups == (n_mels + kMelCols - 1) / kMelCols;
}

template <int MODE, typename In, int MT, int AS>
cudaError_t launch_plan(const In* audio, const void* wtc, const void* mtc, const float* sc, const float* corr,
                        void* mel, float* bmax, int B, int T, int Kp, int hop, int off, int nf, int bins_pad,
                        int n_mels, const TcPlan& p, void* stream)
{
    using E = typename Mode<MODE>::T;
    cudaError_t err = cudaFuncSetAttribute(fused_mel_tc_kernel<MODE, In, MT, AS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, p.shared_bytes);
    if (err != cudaSuccess) return err;
    fused_mel_tc_kernel<MODE, In, MT, AS>
        <<<dim3((nf + p.frames - 1) / p.frames, B, p.mel_groups), kThreads, p.shared_bytes, (cudaStream_t)stream>>>(
            audio, static_cast<const E*>(wtc), static_cast<const __nv_bfloat16*>(mtc), sc, corr, mel, bmax, T, Kp,
            hop, off, nf, bins_pad, n_mels, p.span_pad, p.n_copies, gcd_log2<MODE>(hop), p.stages);
    return cudaGetLastError();
}

template <int MODE, typename In>
cudaError_t launch_in(const In* audio, const void* wtc, const void* mtc, const float* sc, const float* corr,
                      void* mel, float* bmax, int B, int T, int Kp, int hop, int off, int nf, int bins_pad,
                      int n_mels, const TcPlan& p, void* stream)
{
    if (p.shifted)
        return launch_plan<MODE, In, 1, kShifted>(audio, wtc, mtc, sc, corr, mel, bmax, B, T, Kp, hop, off, nf,
                                                  bins_pad, n_mels, p, stream);
    if (p.streamed)
        return launch_plan<MODE, In, kMT, kStream>(audio, wtc, mtc, sc, corr, mel, bmax, B, T, Kp, hop, off, nf,
                                                   bins_pad, n_mels, p, stream);
    return launch_plan<MODE, In, kMT, kCopies>(audio, wtc, mtc, sc, corr, mel, bmax, B, T, Kp, hop, off, nf,
                                               bins_pad, n_mels, p, stream);
}

// bmax: zeroed where the plan merges block maxima (compact, or more than one
// mel group; the streamed plan's blocks own 64 frames, as the full plan's)
template <int MODE>
int launch_tc(const void* audio, int audio_i16, const void* wtc, const void* mtc, const float* sc,
              const float* corr, void* mel, float* bmax, int B, int T, int Kp, int hop, int off, int nf,
              int bins_pad, int n_mels, TcPlan p, void* stream)
{
    if (B < 1 || T < 1 || nf < 1 || Kp < kChunkRows || Kp % kChunkRows || hop < 1 || n_mels < 1 ||
        n_mels > kMelLimit || bins_pad < kTileBins || bins_pad % kTileBins ||
        ((MODE == kI16 || MODE == kI24) && !sc) || (MODE == kI16 && !corr) || !plan_holds<MODE>(p, Kp, hop, n_mels))
        return (int)cudaErrorInvalidValue;
    if (audio_i16)
        return (int)launch_in<MODE>(static_cast<const int16_t*>(audio), wtc, mtc, sc, corr, mel, bmax, B, T, Kp,
                                    hop, off, nf, bins_pad, n_mels, p, stream);
    return (int)launch_in<MODE>(static_cast<const float*>(audio), wtc, mtc, sc, corr, mel, bmax, B, T, Kp, hop,
                                off, nf, bins_pad, n_mels, p, stream);
}

}  // namespace

// wtc: the (hi, mid, lo) basis planes, bf16 [2*bins_pad/128][Kp/16][3][128][16]
// (re and im columns interleaved, rows past K zero); mtc: the mel weights'
// (hi, mid, lo) planes, bf16 [groups * bins_pad/16][3][128][16] (groups of
// 128 mel columns, columns past n_mels zero); mel [B, nf, n_mels] float32,
// bmax [B, ceil(nf/64)]; plan from tc_plan
extern "C" int fused_mel_f32(const void* audio, int audio_i16, const void* wtc, const void* mtc, float* mel,
                             float* bmax, int B, int T, int Kp, int hop, int off, int nf, int bins_pad, int n_mels,
                             TcPlan plan, void* stream)
{
    return launch_tc<kF32>(audio, audio_i16, wtc, mtc, nullptr, nullptr, mel, bmax, B, T, Kp, hop, off, nf,
                           bins_pad, n_mels, plan, stream);
}

// wtc: the bf16-rounded basis, [2*bins_pad/128][Kp/16][1][128][16] (re and
// im columns interleaved, rows past K zero); mtc: the bf16-rounded mel
// weights, [groups * bins_pad/16][1][128][16] (columns past n_mels zero); mel [B, nf,
// n_mels] bf16, bmax [B, ceil(nf/64)]
extern "C" int fused_mel_bf16(const void* audio, int audio_i16, const void* wtc, const void* mtc, void* mel,
                              float* bmax, int B, int T, int Kp, int hop, int off, int nf, int bins_pad, int n_mels,
                              TcPlan plan, void* stream)
{
    return launch_tc<kBF16>(audio, audio_i16, wtc, mtc, nullptr, nullptr, mel, bmax, B, T, Kp, hop, off, nf,
                            bins_pad, n_mels, plan, stream);
}

// wtc: the (hi, lo) basis planes, bf16 [2*bins_pad/128][Kp/16][2][128][16]
// (re and im columns interleaved, rows past K zero); mtc: the mel weights'
// (hi, lo) planes, bf16 [groups * bins_pad/16][2][128][16] (columns past n_mels
// zero); mel [B, nf, n_mels] float32, bmax [B, ceil(nf/64)]
extern "C" int fused_mel_x3(const void* audio, int audio_i16, const void* wtc, const void* mtc, float* mel,
                            float* bmax, int B, int T, int Kp, int hop, int off, int nf, int bins_pad, int n_mels,
                            TcPlan plan, void* stream)
{
    return launch_tc<kX3>(audio, audio_i16, wtc, mtc, nullptr, nullptr, mel, bmax, B, T, Kp, hop, off, nf,
                          bins_pad, n_mels, plan, stream);
}

// wtc: the int8 planes w2, w1, w0, [2*bins_pad/128][Kp/32][3][128][32]
// (columns interleaved as for x3); sc [B, 2] = (s, 1/(s*Sw)); mtc as for x3
extern "C" int fused_mel_i24(const void* audio, int audio_i16, const void* wtc, const float* sc, const void* mtc,
                             float* mel, float* bmax, int B, int T, int Kp, int hop, int off, int nf, int bins_pad,
                             int n_mels, TcPlan plan, void* stream)
{
    return launch_tc<kI24>(audio, audio_i16, wtc, mtc, sc, nullptr, mel, bmax, B, T, Kp, hop, off, nf, bins_pad,
                           n_mels, plan, stream);
}

// wtc, sc, mtc as for i24 (s a power of two); corr [2*bins_pad] (re | im,
// not interleaved) = 128 * the column sums of round(W * Sw)
extern "C" int fused_mel_i16(const void* audio, int audio_i16, const void* wtc, const float* sc, const float* corr,
                             const void* mtc, float* mel, float* bmax, int B, int T, int Kp, int hop, int off, int nf,
                             int bins_pad, int n_mels, TcPlan plan, void* stream)
{
    return launch_tc<kI16>(audio, audio_i16, wtc, mtc, sc, corr, mel, bmax, B, T, Kp, hop, off, nf, bins_pad,
                           n_mels, plan, stream);
}
