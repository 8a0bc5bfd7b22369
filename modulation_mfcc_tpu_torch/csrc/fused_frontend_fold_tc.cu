// Folded fused MFCC frontend for Hopper (sm_90a) on the tensor cores: the f32
// and x3 modes, audio -> mel power through the folded real DFT. Plain C
// launchers, loaded with ctypes (modulation_mfcc_tpu_torch/kernels/_build.py);
// each returns the cudaError_t of its launch. No fast-math intrinsics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "tensor_core.cuh"

// The staging plan of a launch (kernels/fused_frontend.fold_plan, passed by
// value in this field order); the launcher checks it against its own sum.
struct FoldPlan {
    int frames, stages, buffers, span_pad, mel_groups, shared_bytes;
};

namespace {

using namespace tc;

// ---------------------------------------------------------------------------
// fused_mel_fold_f32, fused_mel_fold_x3
//
// Replace the Pallas folded frontend of modulation_mfcc_tpu/pallas/
// fused_frontend.py (fused_mel_frontend(fold=True) -> _folded_frontend ->
// pallas_call at :1096, body _fold_kernel at :239), algorithms 'f32' and
// 'x3'. 'bf16' is fused_frontend_fold.cu's, on the CUDA cores: it is held to
// its plain version's FP32 GEMM order, in which the tensor cores cannot sum
// (PERF.md §6).
//
// The periodic Hann window of the trimmed support (sup samples, even) is
// symmetric about sup/2, so the windowed real DFT of a frame folds: with a
// the frame's first support sample (x[b, f*hop + off], zero outside the
// buffer) and u in [0, K), K = sup/2 + 1,
//   s[u] = x[a + u] + x[a + sup - u],   d[u] = x[a + u] - x[a + sup - u]
//   re   = s @ wc,   im = d @ ws,   mel = (re^2 + im^2) @ melw
// wc and ws carry the window (kernels/fused_frontend.fold_weights: the u = 0
// rows zero, the u = sup/2 row halved and its sine zero; the Nyquist cosine
// column in the dead DC slot when every bin is live). Each block writes the
// maximum of mel over its valid frames (< nf).
//
// The arithmetic of the template's P planes, fused_mel_f32's and
// fused_mel_x3's (fused_frontend_tc.cu): s and d are formed in FP32 (rounded
// to nearest, as the plain version forms them) and split into P bf16 planes,
// the basis arrives as its P planes.
//   'x3'  (P = 2): (hi, lo); hi.Whi, then hi.Wlo + lo.Whi.
//   'f32' (P = 3): the exact split hi = bf16(v), mid = bf16(v - hi),
//         lo = bf16(v - hi - mid), hi + mid + lo == v (the TPU's own f32,
//         _mxu's Precision.HIGHEST dot: six bf16 passes); hi.Whi, then
//         hi.Wmid + mid.Whi + hi.Wlo + mid.Wmid + lo.Whi. Each product of two
//         bf16 values is exact in FP32.
// Each 16-row hi.Whi MMA starts from zero and is added to the running sum
// with FP32 adds (mma_bf16_add: the tensor cores do not round each add to
// nearest, ROADMAP C2); the smaller products chain into a second sum; re and
// im are the two sums added. The power (re^2 + im^2, no FMA) is split the
// same way and projected onto the mel weights' P planes with the same
// products (tensor_core.cuh mel_tile), as the unfolded kernel of the mode
// does.
//
// Bound: the bf16 tensor cores. A 128 x 30 s batch at 16 kHz (sup 400, K =
// 201, 256 live bins) is 158 GFLOP of folded DFT (half the unfolded 315)
// and 50 GFLOP of mel a pass: 0.63 ms for x3's three passes at 989
// TFLOP/s, 1.26 ms for f32's six. The audio read and the mel write are
// ~0.2 ms.
//
// Design: fused_frontend_tc.cu's, with the folded operands built on chip.
//  * A block owns 64 consecutive frames of one utterance (8 warps, 2 x 4 over
//    frames and columns) and one group of 128 mel columns (the grid's z). It
//    stages its audio span once, in FP32, (64 - 1)*hop + sup + 1 samples:
//    both ends of every frame's fold are read from it by index, so no second
//    (reversed) input stream exists (the TPU kernel streams a lane-flipped
//    copy of the audio). The u = 0 term reads x[a + sup], one sample past the
//    support, inside the span.
//  * Per 32-row chunk of the contraction (Kp = K padded to 32; the rows past
//    K meet zero weights and are built as zeros), the block builds the s and
//    d planes of its frames, [16-row step][frame][16], which a thread's A
//    fragments read as 8-byte loads, a half warp 128 contiguous bytes. The
//    planes are double-buffered, one __syncthreads a chunk: each warp loads
//    the next chunk's samples into registers before the current chunk's
//    MMAs and stores its planes after them (ChunkBuild), so the build's
//    shared-memory latency hides behind the MMAs. Lane l builds row 32c + l
//    of the warp's frames, so both span reads are 32 consecutive floats.
//  * The basis arrives pre-arranged by the wrapper (fold_layouts, once per
//    set of weights): [tile][16-row step][plane][128][16], a tile 64 bins,
//    its columns in groups of 16: 8 cosine columns (they meet s), then the
//    sine columns of the same 8 bins (they meet d; zero at or past
//    im_cols). So an even n-tile of a warp is re and the odd one after it
//    im of the same bins, and one thread holds re and im of a bin. One
//    32-row chunk of a tile is contiguous: a thread streams the chunks with
//    the bulk-copy engine through a ring of stages in shared memory, each
//    completing an mbarrier. x3 reads both operands' A fragments at once;
//    f32, with a third plane, one operand at a time (s for the cosine
//    n-tiles, then d), which keeps its fragments at x3's register count.
//  * The power of the tile's 64 bins goes to a shared-memory tile, and is
//    projected onto the tile's mel weights (bulk-copied while the DFT runs)
//    into the block's mel in registers (mel_tile), written with the block
//    maximum at the end (write_mel).
//  * The staging plan (FoldPlan; its one owner is kernels/fused_frontend.
//    fold_plan) fits the block in 227 KB of shared memory at every rate, hop
//    and window fold_ok takes, taking the first rung of the mode's ladder
//    that fits. x3: 64 frames with four stages, else 32 frames (one MMA
//    tile a warp) with four to two. f32, whose planes and ring are half as
//    large again: 64 frames with four to two stages, then 32 frames with
//    four to two, then 32 frames with two stages and one buffer of s and d
//    planes, where each warp stores the next chunk's planes only after a
//    second __syncthreads (the widest spans: 48 kHz at hop 720 with a
//    1,440-sample window). Blocks of 32 frames merge a 64-frame block
//    maximum by atomicMax. One block an SM.
// Times on the H100: PERF.md §6 (chip_smoke.py phase 22).
// ---------------------------------------------------------------------------

template <int P> constexpr int kChunkBytes = kChunkRows * kCols * P * 2;  // a 32-row chunk of a tile's basis
template <int P> constexpr int kMelBytes = kTileBins * P * kMelCols * 2;  // a tile's mel weights
static_assert(8 * (kStages + 1) <= 64 && 64 + 4 * (kThreads / 32) <= 128,
              "the 128-byte header holds the barriers, then the warp maxima from byte 64");

// bytes of a launch's shared memory: 128 of barriers and warp maxima, the
// ring, a tile's mel weights, the power tile, one or two buffers of the s
// and d planes and the FP32 span. All of it is dynamic: a static array
// would sit before it and push the 128-byte aligned dynamic part past the
// block's 232,448 bytes at the widest plans (32 kHz at hop 320, window
// 1280: 232,336 bytes)
__host__ __device__ constexpr long long shared_bytes(int planes, int frames, int stages, int buffers, int span_pad)
{
    return 128 + (long long)stages * kChunkRows * kCols * planes * 2 + (long long)kTileBins * planes * kMelCols * 2 +
           (long long)planes * frames * kPitch * 2 + (long long)buffers * 2 * planes * kChunkRows * frames * 2 +
           4LL * span_pad;
}

// v as the mode's P bf16 planes: x3 (hi, lo), f32 (hi, mid, lo), each the
// nearest bf16 of what the planes before it leave
template <int P>
__device__ __forceinline__ void planes_of(float v, __nv_bfloat16 (&p)[P])
{
    p[0] = __float2bfloat16_rn(v);
    const float r = __fsub_rn(v, __bfloat162float(p[0]));
    p[1] = __float2bfloat16_rn(r);
    if constexpr (P == 3) p[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(p[1])));
}

// The build of the s and d planes of contraction rows [32 c, 32 c + 32) of
// the block's BF frames from the staged span, in two halves so that a
// chunk's MMAs run between them: load() reads the samples into registers,
// store() splits s and d and writes the planes into buf: plane q (s planes,
// then d planes) at q * 32 BF elements, row u = 32 c + 16 j + kk of frame f
// at (j BF + f) 16 + kk. Lane l takes row 32 c + l of frames warp, warp + 8,
// ..., so both reads of a warp are 32 consecutive floats.
template <int P, int BF>
struct ChunkBuild {
    static constexpr int kFrames = BF / (kThreads / 32);  // frames a warp builds
    float v[2][kFrames];  // x[a + u], then x[a + sup - u]
    bool live;            // u < K: rows past K meet zero weights

    __device__ __forceinline__ void load(const float* span, int c, int K, int sup, int hop, int lane, int warp)
    {
        const int u = kChunkRows * c + lane;
        live = u < K;
        const float* fwd = span + warp * hop + (live ? u : 0);
        const float* rev = span + warp * hop + (live ? sup - u : 0);
#pragma unroll
        for (int i = 0; i < kFrames; ++i) {
            v[0][i] = fwd[i * (kThreads / 32) * hop];
            v[1][i] = rev[i * (kThreads / 32) * hop];
        }
    }

    __device__ __forceinline__ void store(__nv_bfloat16* buf, int lane, int warp) const
    {
        constexpr int kPlane = kChunkRows * BF;
        const int o0 = (lane >> 4) * BF * 16 + (lane & 15) + 16 * warp;
#pragma unroll
        for (int i = 0; i < kFrames; ++i) {
            const int o = o0 + 16 * (kThreads / 32) * i;
            const float sv = live ? __fadd_rn(v[0][i], v[1][i]) : 0.0f;
            const float dv = live ? __fsub_rn(v[0][i], v[1][i]) : 0.0f;
            __nv_bfloat16 sp[P], dp[P];
            planes_of<P>(sv, sp);
            planes_of<P>(dv, dp);
#pragma unroll
            for (int p = 0; p < P; ++p) {
                buf[p * kPlane + o] = sp[p];
                buf[(P + p) * kPlane + o] = dp[p];
            }
        }
    }
};

// One 32-row chunk of the tile's DFT: A fragments of the thread's rows from
// the chunk's planes (s for the even n-tiles, d for the odd), B from the
// ring stage [j][plane][kCols][16]. The k order inside an MMA is relabelled
// as tensor_core.cuh says, the same for A and B. hi.Whi added to hh in FP32,
// the smaller products chained into sm. x3 loads the fragments of both
// operands, then runs the n-tiles in order; f32 loads s's and runs the even
// n-tiles, then d's and the odd ones. Either way each sum takes its MMAs in
// the same order.
template <int P, int MT>
__device__ __forceinline__ void fold_chunk(float (&hh)[MT][4][4], float (&sm)[MT][4][4], const __nv_bfloat16* buf,
                                           const __nv_bfloat16* stage, int wm, int col0, int g, int t)
{
    constexpr int BF = 32 * MT, kPlane = kChunkRows * BF;
    constexpr int kOps = P == 2 ? 2 : 1;  // operands whose fragments a pass holds
#pragma unroll
    for (int j = 0; j < kChunkRows / 16; ++j) {
#pragma unroll
        for (int o0 = 0; o0 < 2; o0 += kOps) {
            uint32_t a[kOps][P][MT][4];  // [operand from o0][plane][m-tile]
#pragma unroll
            for (int q = 0; q < kOps * P; ++q)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int row = 16 * MT * wm + 16 * mt + 8 * h + g;
                        const uint2 v = *reinterpret_cast<const uint2*>(buf + (o0 * P + q) * kPlane +
                                                                        (j * BF + row) * 16 + 4 * t);
                        a[q / P][q % P][mt][h] = v.x;
                        a[q / P][q % P][mt][2 + h] = v.y;
                    }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int op = (nt & 1) - o0;  // cosine columns meet s, sine columns d
                if (op < 0 || op >= kOps) continue;
                uint2 w[P];
#pragma unroll
                for (int p = 0; p < P; ++p)
                    w[p] = *reinterpret_cast<const uint2*>(stage + ((j * P + p) * kCols + col0 + 8 * nt) * 16 +
                                                           4 * t);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma_bf16_add(hh[mt][nt], a[op][0][mt], w[0].x, w[0].y);  // hi.Whi
                    mma_bf16(sm[mt][nt], a[op][0][mt], w[1].x, w[1].y);      // hi.Wlo (f32: hi.Wmid)
                    mma_bf16(sm[mt][nt], a[op][1][mt], w[0].x, w[0].y);      // lo.Whi (f32: mid.Whi)
                    if constexpr (P == 3) {
                        mma_bf16(sm[mt][nt], a[op][0][mt], w[2].x, w[2].y);  // hi.Wlo
                        mma_bf16(sm[mt][nt], a[op][1][mt], w[1].x, w[1].y);  // mid.Wmid
                        mma_bf16(sm[mt][nt], a[op][2][mt], w[0].x, w[0].y);  // lo.Whi
                    }
                }
            }
        }
    }
}

template <int P, int MT>
__global__ void __launch_bounds__(kThreads, 1)
fused_mel_fold_tc_kernel(const float* __restrict__ audio, const __nv_bfloat16* __restrict__ wtc,
                         const __nv_bfloat16* __restrict__ mtc, float* __restrict__ mel, float* __restrict__ bmax,
                         int T, int K, int Kp, int sup, int hop, int off, int nf, int bins_pad, int n_mels,
                         int span_pad, int plan_stages, int plan_buffers)
{
    constexpr int BF = 32 * MT;                       // frames a block
    constexpr int kBuf = 2 * P * kChunkRows * BF;     // elements of one buffer of s and d planes
    // x3's full plan has a constant ring; the other plans bring theirs
    const int stages = P == 2 && MT == kMT ? kStages : plan_stages;
    const bool single = P == 3 && plan_buffers == 1;  // one buffer of s and d planes (f32's last rung)
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [stages] chunk barriers
    uint64_t* mel_bar = full + kStages;                   // the tile's mel weights
    float* red_s = reinterpret_cast<float*>(smem + 64);   // [kThreads / 32] warp maxima (write_mel)
    unsigned char* ring = smem + 128;                     // stages x kChunkBytes
    auto* mel_w = reinterpret_cast<__nv_bfloat16*>(ring + stages * kChunkBytes<P>);  // [4][P][128][16]
    __nv_bfloat16* pw = mel_w + kMelBytes<P> / 2;         // P x [BF][kPitch] power tile
    __nv_bfloat16* planes = pw + P * BF * kPitch;         // 1 or 2 x kBuf: the s and d planes of a chunk each
    float* span = reinterpret_cast<float*>(planes + plan_buffers * kBuf);  // [span_pad] samples

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp / kWN, wn = warp % kWN;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * BF;
    const int group = blockIdx.z;  // of 128 mel columns
    const float* x = audio + (size_t)b * T;
    const int n_chunks = Kp / kChunkRows;
    const int n_tiles = bins_pad / kTileBins;
    const int total = n_tiles * n_chunks;
    const __nv_bfloat16* mtc_g = mtc + (size_t)group * n_tiles * (kMelBytes<P> / 2);

    if (tid == 0) {
        for (int i = 0; i < kStages + 1; ++i) mbar::init(full + i, 1);
        mbar::fence_init();
    }
    // the span, u = 0's sample past the last frame's support included
    const long long start = (long long)f0 * hop + off;
    for (int i = tid; i < span_pad; i += kThreads) {
        const long long s = start + i;
        span[i] = (s >= 0 && s < T) ? x[s] : 0.0f;
    }
    __syncthreads();

    auto issue = [&](int q) {  // chunk q of the (tile, chunk) sequence -> its stage
        const int tile = q / n_chunks, chunk = q % n_chunks;
        const __nv_bfloat16* src = wtc + ((size_t)tile * Kp + (size_t)chunk * kChunkRows) * kCols * P;
        bulk_load(ring + (q % stages) * kChunkBytes<P>, src, kChunkBytes<P>, full + q % stages);
    };
    if (tid == 0)
        for (int q = 0; q < stages - 1 && q < total; ++q) issue(q);
    ChunkBuild<P, BF> next;
    next.load(span, 0, K, sup, hop, lane, warp);
    next.store(planes, lane, warp);

    const int col0 = 32 * wn + g;
    float mel_hh[MT][4][4], mel_sm[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) { mel_hh[mt][nt][i] = 0.0f; mel_sm[mt][nt][i] = 0.0f; }

    for (int tile = 0; tile < n_tiles; ++tile) {
        float hh[MT][4][4], sm[MT][4][4];  // the hi.Whi DFT sums and the smaller products
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) { hh[mt][nt][i] = 0.0f; sm[mt][nt][i] = 0.0f; }
        for (int chunk = 0; chunk < n_chunks; ++chunk) {
            const int q = tile * n_chunks + chunk;
            // chunk q's planes are built; every warp is done with chunk q - 1's
            // stage and planes (and, at chunk 0, with the last tile's power and mel)
            __syncthreads();
            if (tid == 0) {
                if (q + stages - 1 < total) issue(q + stages - 1);
                if (chunk == 0) bulk_load(mel_w, mtc_g + (size_t)tile * kMelBytes<P> / 2, kMelBytes<P>, mel_bar);
            }
            // the next chunk's samples load while this chunk's MMAs run; its
            // planes are stored after them, into the other buffer (one buffer:
            // into the same, once every warp is done with it)
            if (q + 1 < total) next.load(span, (chunk + 1) % n_chunks, K, sup, hop, lane, warp);
            mbar::wait(full + q % stages, (q / stages) & 1);
            fold_chunk<P, MT>(hh, sm, planes + (single ? 0 : (q & 1) * kBuf),
                              reinterpret_cast<const __nv_bfloat16*>(ring + (q % stages) * kChunkBytes<P>), wm, col0,
                              g, t);
            if (q + 1 < total) {
                if (single) __syncthreads();
                next.store(planes + (single ? 0 : ((q + 1) & 1) * kBuf), lane, warp);
            }
        }

        // power of each (frame, bin) this thread holds: n-tiles 2 n2 (re) and
        // 2 n2 + 1 (im), columns 2t + e, are the tile's bin 16 wn + 8 n2 + 2t + e;
        // split into the mode's P planes
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float p[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float re = hh[mt][2 * n2][2 * h + e] + sm[mt][2 * n2][2 * h + e];
                        const float im = hh[mt][2 * n2 + 1][2 * h + e] + sm[mt][2 * n2 + 1][2 * h + e];
                        p[e] = power_of(re, im);
                    }
                    const int o = (16 * MT * wm + 16 * mt + 8 * h + g) * kPitch + 16 * wn + 8 * n2 + 2 * t;
                    const __nv_bfloat162 hi = __floats2bfloat162_rn(p[0], p[1]);
                    *reinterpret_cast<__nv_bfloat162*>(pw + o) = hi;
                    const float r0 = __fsub_rn(p[0], __low2float(hi)), r1 = __fsub_rn(p[1], __high2float(hi));
                    const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
                    *reinterpret_cast<__nv_bfloat162*>(pw + BF * kPitch + o) = mid;
                    if constexpr (P == 3)
                        *reinterpret_cast<__nv_bfloat162*>(pw + 2 * BF * kPitch + o) = __floats2bfloat162_rn(
                            __fsub_rn(r0, __low2float(mid)), __fsub_rn(r1, __high2float(mid)));
                }
        __syncthreads();  // the power tile is complete
        mbar::wait(mel_bar, tile & 1);
        mel_tile<kTileBins / kMelStep, P, MT>(mel_hh, mel_sm, pw, kPitch, mel_w, lane, warp);
    }
    write_mel<MT>(mel_hh, mel_sm, mel, bmax, red_s, b, f0, nf, n_mels, kMelCols * group,
                  MT != kMT || gridDim.z > 1, lane, warp);
}

// whether the plan is a rung of the mode's ladder (fold_plan): x3 64 frames
// with four stages, or 32 with two to four; f32 64 or 32 frames with two to
// four stages, or 32 frames with two stages and one buffer of planes; and
// its fields, recomputed from those choices as fold_plan computes them,
// agree and fit
template <int P>
bool plan_holds(const FoldPlan& p, int sup, int hop, int n_mels)
{
    const bool ring = p.stages >= 2 && p.stages <= kStages;
    const bool frames = p.frames == kBF || p.frames == kBF / 2;
    const bool rung = P == 2 ? p.buffers == 2 && frames && ring && (p.frames == kBF / 2 || p.stages == kStages)
                             : (p.buffers == 2 && frames && ring) ||
                                   (p.buffers == 1 && p.frames == kBF / 2 && p.stages == 2);
    if (!rung) return false;
    const int span_pad = ((p.frames - 1) * hop + sup + 1 + 3) / 4 * 4;
    const long long smem = shared_bytes(P, p.frames, p.stages, p.buffers, span_pad);
    return p.span_pad == span_pad && p.shared_bytes == smem && smem <= kSharedMax &&
           p.mel_groups == (n_mels + kMelCols - 1) / kMelCols;
}

template <int P, int MT>
cudaError_t launch_plan(const float* audio, const void* wtc, const void* mtc, float* mel, float* bmax, int B, int T,
                        int K, int Kp, int sup, int hop, int off, int nf, int bins_pad, int n_mels, const FoldPlan& p,
                        void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(fused_mel_fold_tc_kernel<P, MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, p.shared_bytes);
    if (err != cudaSuccess) return err;
    fused_mel_fold_tc_kernel<P, MT>
        <<<dim3((nf + p.frames - 1) / p.frames, B, p.mel_groups), kThreads, p.shared_bytes, (cudaStream_t)stream>>>(
            audio, static_cast<const __nv_bfloat16*>(wtc), static_cast<const __nv_bfloat16*>(mtc), mel, bmax, T, K,
            Kp, sup, hop, off, nf, bins_pad, n_mels, p.span_pad, p.stages, p.buffers);
    return cudaGetLastError();
}

template <int P>
int launch_fold(const float* audio, const void* wtc, const void* mtc, float* mel, float* bmax, int B, int T, int K,
                int Kp, int sup, int hop, int off, int nf, int bins_pad, int n_mels, const FoldPlan& plan,
                void* stream)
{
    if (B < 1 || T < 1 || nf < 1 || hop < 1 || sup < 2 || sup % 2 || K != sup / 2 + 1 || Kp < K ||
        Kp % kChunkRows || Kp - K >= kChunkRows || n_mels < 1 || n_mels > kMelLimit || bins_pad < kTileBins ||
        bins_pad % kTileBins || !plan_holds<P>(plan, sup, hop, n_mels))
        return (int)cudaErrorInvalidValue;
    return (int)(plan.frames == kBF ? launch_plan<P, kMT>(audio, wtc, mtc, mel, bmax, B, T, K, Kp, sup, hop, off, nf,
                                                          bins_pad, n_mels, plan, stream)
                                    : launch_plan<P, 1>(audio, wtc, mtc, mel, bmax, B, T, K, Kp, sup, hop, off, nf,
                                                        bins_pad, n_mels, plan, stream));
}

}  // namespace

// wtc: the (hi, mid, lo) planes of wc and ws, bf16 [bins_pad/64][Kp/16][3][128][16]
// (per 16 columns 8 cosine, then the sine of the same 8 bins; rows past K and
// sine columns at or past im_cols zero); mtc: the mel weights' (hi, mid, lo)
// planes, [groups * bins_pad/16][3][128][16]; mel [B, nf, n_mels] float32,
// bmax [B, ceil(nf/64)], zeroed where the plan merges block maxima (32
// frames, or more than one mel group); plan from fold_plan
extern "C" int fused_mel_fold_f32(const float* audio, const void* wtc, const void* mtc, float* mel, float* bmax,
                                  int B, int T, int K, int Kp, int sup, int hop, int off, int nf, int bins_pad,
                                  int n_mels, FoldPlan plan, void* stream)
{
    return launch_fold<3>(audio, wtc, mtc, mel, bmax, B, T, K, Kp, sup, hop, off, nf, bins_pad, n_mels, plan,
                          stream);
}

// as fused_mel_fold_f32, with the (hi, lo) planes: wtc [bins_pad/64][Kp/16][2][128][16],
// mtc [groups * bins_pad/16][2][128][16]
extern "C" int fused_mel_fold_x3(const float* audio, const void* wtc, const void* mtc, float* mel, float* bmax,
                                 int B, int T, int K, int Kp, int sup, int hop, int off, int nf, int bins_pad,
                                 int n_mels, FoldPlan plan, void* stream)
{
    return launch_fold<2>(audio, wtc, mtc, mel, bmax, B, T, K, Kp, sup, hop, off, nf, bins_pad, n_mels, plan,
                          stream);
}
