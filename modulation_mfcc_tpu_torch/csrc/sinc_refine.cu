// Windowed-sinc peak refinement for Hopper (sm_90a), the pitch tracker's
// Praat NUMimproveMaximum step. Plain C launcher, loaded with ctypes
// (modulation_mfcc_tpu_torch/kernels/_build.py); it returns the cudaError_t
// of its launch. True FP32 on the CUDA cores: no TF32, no fast-math.
#include <cuda_runtime.h>

// The tiling, as kernels/sinc_refine.py sinc_plan computes it: lags an item
// (kWarps * kJ), items a row group, taps staged at once (all S when the
// weights stay resident), chunks, floats a staged x row and a (pos, val)
// tile row, shared bytes.
struct Plan {
    int lag_block, lag_blocks, taps_chunk, chunks, x_stride, out_stride, shared_bytes;
};

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
// What held the first design back (one thread a (row, lag), 17
// accumulators, 1.856 ms on the H100): each tap cost six shared-memory loads
// (one x word, four float4 and one scalar of weights) for 17 FFMA, so loads
// and issue slots set the pace, at 36 % of the bound; and each block staged
// its rows synchronously before computing.
//
// Design: the product is Toeplitz (neighbouring lags read the same x shifted
// by one), so a thread keeps a register tile of kJ = 8 consecutive lags of
// one row: 17*J accumulators and a sliding window of J x values. Each tap
// loads one weight row (as broadcasts) and issues 17*J FFMA; x arrives four
// taps at a time in one float4. The next tap's weights and the next four
// taps' x are loaded before this tap's FFMA, so their latency hides behind
// them. Lanes map to rows: lane r of every warp owns row r of a 32-row
// group, and warp w owns lag group w of a block of 8*J lags, so the weight
// loads are broadcasts and a warp's x loads hit 32 rows at a stride of 4 mod
// 8 words, which puts each quarter warp's 16-byte loads on distinct banks (a
// lag-to-lane map instead would stride J words and conflict gcd(J, 32)
// ways). Each output stays one FMA chain over the taps in ascending order
// from 0, as in the first design, so the values are its plain version's bit
// for bit. A persistent grid walks (row group, lag block) items; cp.async
// copies the next item's band (4-byte granules: a row's band starts at any
// float, so no alignment is assumed; zero fill past the band or M; one float
// in, so the float4 loads are aligned) into the second of two buffers while
// the current one computes. The weights are staged once a block; only past
// 160 taps are they streamed with x in chunks of 128 taps (the accumulators
// carry over the chunks). The wrapper computes the tiling (Plan) and passes
// it in. (pos, val) of an item go through a shared tile to coalesced stores.
// The parabola uses explicitly rounded operations so it rounds like the
// plain version's separate torch ops.
//
// On the H100 at the tracker's shape (chip_smoke.py phase 10) the tap loop
// runs under the FFMA rate because of its shared-memory loads (fewer x
// loads helped; their width and the FFMA count did not matter), so the
// kernel stays near half of its bound. With x read four taps at a time, J
// = 8 beat J = 4 (PERF.md section 6 has the sweep).
// Tensor cores were not taken: an exact three-plane bf16 split (six
// passes) bounds at about 0.42 ms, under the FFMA bound, but would change
// the rounding the argmax's ties rest on.
// ---------------------------------------------------------------------------

constexpr int kG = 17;               // offsets per lag (grid 17: spacing 1/8 over [-1, 1])
constexpr int kGP = 20;              // padded weight row (five float4)
constexpr int kRows = 32;            // rows of a group: one a lane
constexpr int kWarps = 8;            // lag groups of a lag block: one a warp
constexpr int kJ = 8;                // lags a thread
constexpr int kThreads = kWarps * 32;
constexpr int kSharedMax = 232448;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// all but the most recent commit group have landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void load_row(float (&w)[kG], const float* wr)
{
    const float4* w4 = reinterpret_cast<const float4*>(wr);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 v = w4[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
    }
    w[16] = wr[16];
}

// tap t + u of the warp's lags: the window takes xnew = x[l0 + J-1 + t + u];
// the next tap's weight row is loaded before this tap's 17*J FFMA issue,
// so its latency hides behind them; then
// acc[j][g] += x[l + j + t + u] * w[t + u][g], the window rotated by u.
// Row next may be one past the chunk: a harmless shared-memory read.
__device__ __forceinline__ void tap(float (&acc)[kJ][kG], float (&xw)[kJ], float (&wc)[kG], float xnew, int u,
                                    const float* wb, int next)
{
    constexpr int J = kJ;
    xw[(u + J - 1) % J] = xnew;
    float wn[kG];
    load_row(wn, wb + next * kGP);
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const float xv = xw[(u + j) % J];
#pragma unroll
        for (int g = 0; g < kG; ++g) acc[j][g] = fmaf(xv, wc[g], acc[j][g]);
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) wc[g] = wn[g];
}

__global__ void __launch_bounds__(kThreads)
sinc_refine_f32_kernel(const float* __restrict__ r_ext, const float* __restrict__ w,
                       float* __restrict__ pos, float* __restrict__ val,
                       int M, int L, int start, int nl, int S, int lag_lo, float h, Plan p)
{
    constexpr int J = kJ, LB = kWarps * J;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const bool resident = p.chunks == 1;
    float* ws_res = smem;                                    // [S][kGP] when resident
    float* slots = smem + (resident ? S * kGP : 0);
    const int w_slot = resident ? 0 : p.taps_chunk * kGP;   // streamed weights of a slot
    const int slot_size = w_slot + kRows * p.x_stride;
    float* out_pos = slots + 2 * slot_size;                  // [kRows][out_stride]
    float* out_val = out_pos + kRows * p.out_stride;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int n_items = ((M + kRows - 1) / kRows) * p.lag_blocks;
    const int band = nl + S - 1;

    // stage unit u (item blockIdx.x + (u / chunks) * gridDim.x, chunk u % chunks)
    auto stage = [&](int u, float* slot) {
        const int item = blockIdx.x + (u / p.chunks) * gridDim.x, chunk = u % p.chunks;
        const int row0 = (item / p.lag_blocks) * kRows, l0 = (item % p.lag_blocks) * LB;
        const int s0 = chunk * p.taps_chunk, sc = min(p.taps_chunk, S - s0), xw = LB + sc - 1;
        const int valid = min(xw, band - l0 - s0);  // past the band or M: zero fill
        for (int r = warp; r < kRows; r += kWarps) {
            const int n = row0 + r < M ? valid : 0;
            const float* src = r_ext + (size_t)min(row0 + r, M - 1) * L + start + l0 + s0;
            float* dst = slot + w_slot + r * p.x_stride + 1;  // x of tap 0's newest lag 16-byte aligned
            for (int c = lane; c < xw; c += 32) cp_async4(dst + c, src + max(0, min(c, n - 1)), c < n);
        }
        if (!resident)
            for (int i = tid; i < sc * kGP; i += kThreads) {
                const int s = i / kGP, g = i % kGP;
                cp_async4(slot + i, g < kG ? w + (s0 + s) * kG + g : w, g < kG);
            }
    };

    if (resident)
        for (int i = tid; i < S * kGP; i += kThreads) {
            const int s = i / kGP, g = i % kGP;
            cp_async4(ws_res + i, g < kG ? w + s * kG + g : w, g < kG);
        }
    if ((int)blockIdx.x < n_items) stage(0, slots);
    cp_async_commit();

    float acc[J][kG];
    for (int u = 0;; ++u) {
        const int item = blockIdx.x + (u / p.chunks) * gridDim.x, chunk = u % p.chunks;
        if (item >= n_items) break;
        if (blockIdx.x + ((u + 1) / p.chunks) * gridDim.x < n_items) stage(u + 1, slots + ((u + 1) & 1) * slot_size);
        cp_async_commit();
        cp_async_wait_prior();
        __syncthreads();

        const float* slot = slots + (u & 1) * slot_size;
        const int s0 = chunk * p.taps_chunk, sc = min(p.taps_chunk, S - s0);
        const float* wb = resident ? ws_res : slot;
        const float* xr = slot + w_slot + lane * p.x_stride + 1 + warp * J;
        if (chunk == 0) {
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
                for (int g = 0; g < kG; ++g) acc[j][g] = 0.0f;
        }
        float xw[J], wc[kG];
#pragma unroll
        for (int j = 0; j < J - 1; ++j) xw[j] = xr[j];
        load_row(wc, wb);
        // the x of four taps in one float4 (lanes at a row stride of 4 mod 8
        // words: each quarter warp's 16-byte loads on distinct banks), the
        // next four loaded before these four taps' FFMA
        float4 q = *reinterpret_cast<const float4*>(xr + J - 1);
        int t = 0;
        for (; t + J <= sc; t += J) {
#pragma unroll
            for (int v = 0; v < J; v += 4) {
                const float4 x4 = q;
                q = *reinterpret_cast<const float4*>(xr + t + v + 4 + J - 1);
                tap(acc, xw, wc, x4.x, v, wb, t + v + 1);
                tap(acc, xw, wc, x4.y, v + 1, wb, t + v + 2);
                tap(acc, xw, wc, x4.z, v + 2, wb, t + v + 3);
                tap(acc, xw, wc, x4.w, v + 3, wb, t + v + 4);
            }
        }
#pragma unroll
        for (int v = 0; v < J - 1; ++v) {
            if (t + v < sc) tap(acc, xw, wc, xr[t + v + J - 1], v, wb, t + v + 1);
        }

        const bool last = chunk == p.chunks - 1;
        const int row0 = (item / p.lag_blocks) * kRows, l0 = (item % p.lag_blocks) * LB;
        if (last) {
#pragma unroll
            for (int j = 0; j < J; ++j) {
                const float (&f)[kG] = acc[j];
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
                const int l = warp * J + j;
                out_pos[lane * p.out_stride + l] =
                    __fadd_rn(__fadd_rn((float)(lag_lo + l0 + l), off), __fmul_rn(delta, h));
                out_val[lane * p.out_stride + l] = __fsub_rn(best, __fmul_rn(__fmul_rn(0.25f, diff), delta));
            }
        }
        __syncthreads();  // the slot may be restaged and the tile read
        if (last) {
            for (int i = tid; i < kRows * LB; i += kThreads) {
                const int r = i / LB, l = i % LB;
                if (row0 + r < M && l0 + l < nl) {
                    const size_t o = (size_t)(row0 + r) * nl + l0 + l;
                    pos[o] = out_pos[r * p.out_stride + l];
                    val[o] = out_val[r * p.out_stride + l];
                }
            }
        }
    }
}

}  // namespace

// plan: sinc_plan's tiling for (nl, S)
extern "C" int sinc_refine_f32(const float* r_ext, const float* w, float* pos, float* val,
                               int M, int L, int start, int nl, int S, int G, int lag_lo,
                               float h, Plan p, void* stream)
{
    if (M < 1 || nl < 1 || S < 1 || G != kG || start < 0 || start + nl + S - 1 > L ||
        p.lag_block != kWarps * kJ || p.shared_bytes > kSharedMax)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        sinc_refine_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.shared_bytes);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinc_refine_f32_kernel, kThreads, p.shared_bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long items = (long long)((M + kRows - 1) / kRows) * p.lag_blocks;
    const int grid = (int)(items < (long long)per_sm * sms ? items : (long long)per_sm * sms);
    sinc_refine_f32_kernel<<<grid, kThreads, p.shared_bytes, (cudaStream_t)stream>>>(
        r_ext, w, pos, val, M, L, start, nl, S, lag_lo, h, p);
    return (int)cudaGetLastError();
}
