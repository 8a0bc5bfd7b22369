// The pyin Viterbi decode for Hopper (sm_90a): the forward max-plus recursion
// and the backtrace. Plain C launchers, loaded with ctypes
// (modulation_mfcc_tpu_torch/kernels/_build.py); each returns the cudaError_t
// of its launch. Only adds, maxes and comparisons: nothing to contract, no
// rounding choices, so both kernels are bit-identical to their plain versions
// in kernels/viterbi.py.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>

#include "mbarrier.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRingBins = 1024;    // the widest n of the backtrace's ring of (m, sel) rows, n / 32 sources a
                                   // lane; past it the wide backtrace (viterbi_bwd_wide_kernel)
constexpr int kMaxThreads = 1024;  // a forward block: one thread a target, up to this many targets; past them
                                   // each thread owns ceil(n / 1024) (viterbi_fwd_wide_kernel)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSmemLimit = 232448; // bytes of shared memory a block may opt in to on sm_90
constexpr int kMaxRegBand = 64;    // the widest band (2h + 1 sources) a thread holds in registers,
constexpr int kMaxRegThreads = 512; // in a block of at most this many threads (128 registers each)
constexpr int kAhead = 4;          // rows of log_obs in flight ahead of the step that adds them
constexpr int kSlots = 8;          // history rows a backtrace block holds ready ahead of its chain
constexpr int kToeThreads = 512;   // a block of the toeplitz forward (viterbi_fwd_toeplitz_kernel)
constexpr int kToeWarps = kToeThreads / 32;
constexpr int kToeGroup = 4;       // adjacent targets a thread sweeps together
constexpr int kMaxCluster = 16;    // the largest cluster a launch may be given (past 8: non-portable)
constexpr int kRuleCluster = 16;   // the largest cluster the rule picks (past 8: non-portable)
constexpr int kToeSlice = 512;     // the targets a rank takes before the rule doubles the cluster
constexpr int kEdgeCost = 3;       // an edge-table entry against one window offset of one target, in the
                                   // partition's balance of a rank's work
constexpr int kChainLoads = 16;    // in-band sources a chain lane loads before it scores them
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// viterbi_fwd_f32
//
// Replaces the Pallas kernels of modulation_mfcc_tpu/pallas/viterbi.py:
// _forward -> _fwd_kernel (viterbi_forward_pallas, viterbi_decode_pallas) and
// viterbi_decode_batched -> _fwd_kernel_b.
//
// For utterance b (one block) and t = 0 .. NF-2, with delta_0 = delta0[b]:
//   hist[b, t]      = delta_t
//   m_v             = max(delta_t[:n] + c_stay, delta_t[n:] + c_sw)
//   m_u             = max(delta_t[:n] + c_sw,   delta_t[n:] + c_stay)
//   delta_{t+1}[v]  = max_u (m_v[u] + log_tri[u, v]) + log_obs[b, t+1, v]
//   delta_{t+1}[n+v]= max_u (m_u[u] + log_tri[u, v]) + log_obs[b, t+1, n+v]
// and delta_f[b] = delta_{NF-1}.
//
// The band. The wrapper passes (h, C): C = min(log_tri), and every entry
// with |u - v| > h equals C (kernels/viterbi.py viterbi_band checks both).
// Then, bit for bit,
//   max_u fl(m[u] + log_tri[u, v])
//     = max(max_{|u-v| <= h} fl(m[u] + log_tri[u, v]), fl(gmax + C))
// with gmax = max_u m[u]: FP32 addition is monotone in each operand and max
// is exact in any order, so every out-of-band term fl(m[u] + C) is at most
// fl(gmax + C), which is itself either such a term or at most the in-band
// term of gmax's own source (log_tri >= C). pyin's transition (librosa's
// local triangle plus tiny) has h = 21 at n = 361; a matrix without a floor
// has h = n - 1: the dense recursion, in the same kernel.
//
// Bound: the bytes, 0.555 GB of observations and history at 32 x 30 s of
// 16 kHz audio (n = 361, NF = 3,001): 0.17 ms at 3.35 TB/s, against 6.2
// GFLOP of banded max-adds (0.09 ms at 67 TFLOP/s; the dense function's 50
// GFLOP take 0.75 ms). But the frame loop is sequential: one block per
// utterance, so 32 of the 132 SMs work, and each step waits for the last.
//
// Design: one block per utterance, as before; a thread owns target v and
// both of its halves, so each band entry it reads serves m_v and m_u. m sits
// in shared memory as (m_v, m_u) pairs (one 8-byte load a source),
// double-buffered, so a step needs one __syncthreads. The warps that form
// the next m also reduce it (redux.sync on order-preserving integer keys) to
// one maximum a warp and half; after the barrier one more redux a warp folds
// those into gmax. The band lives where it fits (BandAt): in the thread's
// registers, the source loop unrolled over a compile-time width with -inf
// past the band and guard slots of -inf around m (pyin: 43 sources, 95
// registers, blocks of at most 512 threads); else staged in shared memory
// as [2h+1][n], the target fastest so that a warp's reads are
// conflict-free; else (a dense matrix) read from log_tri in L2 with __ldg.
// The observation rows arrive by cp.async in a ring kAhead rows ahead of
// the step that adds them, so no step waits on device memory. Times on the
// H100 beside the dense kernel this one replaces: PERF.md §6 (chip_smoke.py
// phase 13).
// ---------------------------------------------------------------------------

// float <-> int keys in the same order (-0 below +0), for the integer redux
__device__ __forceinline__ int ordered_key(float x)
{
    const int i = __float_as_int(x);
    return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }

__device__ __forceinline__ float warp_max(float x) { return key_value(__reduce_max_sync(kFull, ordered_key(x))); }

// Where a forward block reads the band: kRegs (each thread holds its target's
// band in registers, KW > 0 sources wide), kShared ([2h+1][n] staged in
// shared memory, the target fastest: conflict-free), kL2 (log_tri itself),
// kHist (log_tri itself, and each source's m recomputed from the history
// row, where n is too large for m in shared memory: the wide forward only)
enum BandAt { kRegs, kShared, kL2, kHist };

// float2 slots of one m buffer: n sources, and for kRegs the KW - 1 guard
// slots (-inf) that let every thread read KW sources from v - h on
__host__ __device__ constexpr int m_stride(int n, int kw) { return n + (kw > 0 ? kw - 1 : 0); }

// threads of a forward block: one a target
constexpr int fwd_threads(int n) { return (n + 31) / 32 * 32; }

// bytes of dynamic shared memory: two m buffers of (m_v, m_u) pairs, the
// per-warp maxima (two buffers, two halves), the ring of observation rows
// (kAhead rows, two entries a thread), and the staged band
constexpr size_t fwd_smem_bytes(int n, int h, int kw, BandAt at)
{
    return sizeof(float) * ((size_t)4 * m_stride(n, kw) + 4 * kMaxWarps + (size_t)kAhead * 2 * fwd_threads(n) +
                            (at == kShared ? (size_t)(2 * h + 1) * n : 0));
}

// this thread's (v, n + v) entries of log_obs row r -> its two slots of the
// ring (nt threads), asynchronously, as one commit group (empty past the
// last row)
__device__ __forceinline__ void fetch_row(float* ring, const float* obs, int r, int nf, int n, int nt, int v,
                                          bool own)
{
    if (own && r < nf) {
        float* slot = ring + (r % kAhead) * 2 * nt;
        const unsigned d0 = static_cast<unsigned>(__cvta_generic_to_shared(slot + v));
        const unsigned d1 = static_cast<unsigned>(__cvta_generic_to_shared(slot + nt + v));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d0), "l"(obs + (size_t)r * 2 * n + v)
                     : "memory");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d1), "l"(obs + (size_t)r * 2 * n + n + v)
                     : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// band[k][w] = log_tri[w - h + k, w], C past the matrix's edges (width 2h + 1, n targets)
__device__ __forceinline__ void stage_fwd_band(float* band, const float* log_tri, int n, int h, float floor_c,
                                               int tid, int nt)
{
    const int width = 2 * h + 1;
    for (int i = tid; i < width * n; i += nt) {
        const int k = i / n, w = i - k * n, u = w - h + k;
        band[i] = (u >= 0 && u < n) ? log_tri[(size_t)u * n + w] : floor_c;
    }
}

template <int KW, BandAt AT>
__global__ void __launch_bounds__(AT == kRegs ? kMaxRegThreads : kMaxThreads)
viterbi_fwd_f32_kernel(const float* __restrict__ log_obs, const float* __restrict__ delta0,
                       const float* __restrict__ log_tri, float* __restrict__ hist,
                       float* __restrict__ delta_f, int nf, int n, int h, float floor_c,
                       float c_stay, float c_sw)
{
    extern __shared__ float smem[];
    const int two_n = 2 * n, width = 2 * h + 1, stride = m_stride(n, KW);
    const int lead = KW > 0 ? h : 0;  // guard slots before source 0
    float2* m = reinterpret_cast<float2*>(smem);  // [2][stride]: (m_v[u], m_u[u]) at slot lead + u
    float* wmax = smem + 4 * stride;              // [2][2][kMaxWarps]: per-warp maxima of m_v, m_u
    const int nt = blockDim.x;
    float* ring = wmax + 4 * kMaxWarps;           // [kAhead][2][nt]: log_obs rows, by thread
    float* band = ring + kAhead * 2 * nt;         // kShared: [width][n], band[k][v] = log_tri[v - h + k, v]

    const int b = blockIdx.x, v = threadIdx.x, lane = v & 31, warp = v >> 5;
    const bool own = v < n;
    const float* obs = log_obs + (size_t)b * nf * two_n;
    float* hb = hist + (size_t)b * (nf - 1) * two_n;
    float* df = delta_f + (size_t)b * two_n;
    const int u0 = max(0, v - h), u1 = min(n - 1, v + h);  // the sources within v's band

    float w_reg[KW > 0 ? KW : 1];  // kRegs: log_tri[v - h + k, v], -inf outside the band and the matrix
    if constexpr (AT == kRegs) {
#pragma unroll
        for (int k = 0; k < KW; ++k) {
            const int u = v - h + k;
            w_reg[k] = (own && k < width && u >= 0 && u < n) ? log_tri[(size_t)u * n + v] : -INFINITY;
        }
        for (int i = v; i < 2 * stride; i += nt)
            if (i % stride < lead || i % stride >= lead + n) m[i] = make_float2(-INFINITY, -INFINITY);
    }
    if constexpr (AT == kShared) stage_fwd_band(band, log_tri, n, h, floor_c, v, nt);
    for (int i = v; i < 4 * kMaxWarps; i += nt) wmax[i] = -INFINITY;  // and so stay past the last warp
    __syncthreads();

    // delta_0 -> m and its warp maxima, in buffer 0
    float mv = -INFINITY, mu = -INFINITY;
    if (own) {
        const float dv = delta0[(size_t)b * two_n + v], du = delta0[(size_t)b * two_n + n + v];
        float* row = nf == 1 ? df : hb;
        row[v] = dv;
        row[n + v] = du;
        mv = fmaxf(dv + c_stay, du + c_sw);
        mu = fmaxf(dv + c_sw, du + c_stay);
        m[lead + v] = make_float2(mv, mu);
    }
    mv = warp_max(mv);
    mu = warp_max(mu);
    if (lane == 0) {
        wmax[warp] = mv;
        wmax[kMaxWarps + warp] = mu;
    }
    for (int r = 1; r <= kAhead; ++r) fetch_row(ring, obs, r, nf, n, nt, v, own);
    __syncthreads();

    for (int t = 0; t + 1 < nf; ++t) {
        const int cur = t & 1, nxt = cur ^ 1;
        const float2* mc = m + cur * stride + lead;  // mc[u] = (m_v[u], m_u[u])
        // four chains a half (max is exact in any order)
        float av[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
        float au[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
        if (AT == kRegs && own) {
#pragma unroll
            for (int k = 0; k < KW; ++k) {
                const float2 p = mc[v - h + k];
                av[k & 3] = fmaxf(av[k & 3], p.x + w_reg[k]);
                au[k & 3] = fmaxf(au[k & 3], p.y + w_reg[k]);
            }
        } else if (AT != kRegs && own) {
            const float* col = AT == kShared ? band + (size_t)(u0 - v + h) * n + v : log_tri + (size_t)u0 * n + v;
            int u = u0;
#pragma unroll 2
            for (; u < u1; u += 2, col += 2 * n) {
                const float w0 = AT == kShared ? col[0] : __ldg(col);
                const float w1 = AT == kShared ? col[n] : __ldg(col + n);
                const float2 p0 = mc[u], p1 = mc[u + 1];
                av[0] = fmaxf(av[0], p0.x + w0);
                au[0] = fmaxf(au[0], p0.y + w0);
                av[1] = fmaxf(av[1], p1.x + w1);
                au[1] = fmaxf(au[1], p1.y + w1);
            }
            if (u == u1) {
                const float w0 = AT == kShared ? col[0] : __ldg(col);
                const float2 p0 = mc[u];
                av[0] = fmaxf(av[0], p0.x + w0);
                au[0] = fmaxf(au[0], p0.y + w0);
            }
        }
        // gmax: lane w folds warp w's maxima (-inf past the last warp)
        const float* wm = wmax + cur * 2 * kMaxWarps;
        const float gv = warp_max(wm[lane]), gu = warp_max(wm[kMaxWarps + lane]);
        mv = -INFINITY;
        mu = -INFINITY;
        if (own) {
            // row t + 1 has landed once no more than kAhead - 1 later rows are in flight
            asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
            const float* slot = ring + ((t + 1) % kAhead) * 2 * nt;
            const float lo_v = slot[v], lo_u = slot[nt + v];
            const float dv = fmaxf(fmaxf(fmaxf(av[0], av[1]), fmaxf(av[2], av[3])), gv + floor_c) + lo_v;
            const float du = fmaxf(fmaxf(fmaxf(au[0], au[1]), fmaxf(au[2], au[3])), gu + floor_c) + lo_u;
            float* row = t + 2 == nf ? df : hb + (size_t)(t + 1) * two_n;
            row[v] = dv;
            row[n + v] = du;
            mv = fmaxf(dv + c_stay, du + c_sw);
            mu = fmaxf(dv + c_sw, du + c_stay);
            m[nxt * stride + lead + v] = make_float2(mv, mu);
        }
        fetch_row(ring, obs, t + 1 + kAhead, nf, n, nt, v, own);  // into the slot row t + 1 leaves
        mv = warp_max(mv);
        mu = warp_max(mu);
        if (lane == 0) {
            wmax[nxt * 2 * kMaxWarps + warp] = mv;
            wmax[nxt * 2 * kMaxWarps + kMaxWarps + warp] = mu;
        }
        __syncthreads();
    }
}

template <int KW, BandAt AT>
cudaError_t launch_fwd(const float* log_obs, const float* delta0, const float* log_tri, float* hist,
                       float* delta_f, int nb, int nf, int n, int h, float floor_c, float c_stay, float c_sw,
                       cudaStream_t stream)
{
    const size_t smem = fwd_smem_bytes(n, h, KW, AT);
    cudaError_t err = cudaFuncSetAttribute(viterbi_fwd_f32_kernel<KW, AT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    viterbi_fwd_f32_kernel<KW, AT><<<nb, fwd_threads(n), smem, stream>>>(
        log_obs, delta0, log_tri, hist, delta_f, nf, n, h, floor_c, c_stay, c_sw);
    return cudaGetLastError();
}

// The wide forward, n > kMaxThreads: one block of kMaxThreads per
// utterance, each thread owning the targets v = tid + kMaxThreads i, each
// reduced as the one-target kernel reduces it (the same adds, then maxima,
// so the same bits). m sits in shared memory as [2][n] (m_v, m_u) pairs
// while it fits (n up to about 14,000); past that (kHist) each source's m is
// recomputed from the history row delta_t, which the block wrote a step
// earlier (the same FP32 operations as its owner's). The observations are
// read with __ldg before the band loop of their target, no ring. The band:
// kShared where [2h+1][n] fits beside m, else log_tri from L2. Bound as the
// narrow kernel: the sequential steps, one SM an utterance. At pyin's
// resolution 0.01 (n = 3,601, h = 215) the band of a step is 6.2 MB of L2
// reads, which one SM takes at about 21 GB/s (8 reads in flight a thread
// in place of 2 moved it 3 %): 0.3 ms a step (PERF.md §6).

// bytes of dynamic shared memory: two m buffers of (m_v, m_u) pairs (not for
// kHist), the per-warp maxima (two buffers, two halves) and the staged band
constexpr size_t fwd_wide_smem_bytes(int n, int h, BandAt at)
{
    return sizeof(float) * ((at == kHist ? 0 : (size_t)4 * n) + 4 * kMaxWarps +
                            (at == kShared ? (size_t)(2 * h + 1) * n : 0));
}

template <BandAt AT>
__global__ void __launch_bounds__(kMaxThreads)
viterbi_fwd_wide_kernel(const float* __restrict__ log_obs, const float* __restrict__ delta0,
                        const float* __restrict__ log_tri, float* hist,
                        float* __restrict__ delta_f, int nf, int n, int h, float floor_c, float c_stay, float c_sw)
{
    constexpr bool kMShared = AT != kHist;
    extern __shared__ float smem[];
    const int two_n = 2 * n;
    float2* m = reinterpret_cast<float2*>(smem);                  // kMShared: [2][n]
    float* wmax = smem + (kMShared ? 4 * (size_t)n : 0);          // [2][2][kMaxWarps]
    float* band = wmax + 4 * kMaxWarps;                           // kShared: [width][n]
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* obs = log_obs + (size_t)b * nf * two_n;
    float* hb = hist + (size_t)b * (nf - 1) * two_n;
    float* df = delta_f + (size_t)b * two_n;

    if constexpr (AT == kShared) stage_fwd_band(band, log_tri, n, h, floor_c, tid, kMaxThreads);
    for (int i = tid; i < 4 * kMaxWarps; i += kMaxThreads) wmax[i] = -INFINITY;
    __syncthreads();

    // delta_0 -> the history (or delta_f), m and the warp maxima, buffer 0
    float mv = -INFINITY, mu = -INFINITY;
    for (int v = tid; v < n; v += kMaxThreads) {
        const float dv = delta0[(size_t)b * two_n + v], du = delta0[(size_t)b * two_n + n + v];
        float* row = nf == 1 ? df : hb;
        row[v] = dv;
        row[n + v] = du;
        const float a = fmaxf(dv + c_stay, du + c_sw), c = fmaxf(dv + c_sw, du + c_stay);
        if constexpr (kMShared) m[v] = make_float2(a, c);
        mv = fmaxf(mv, a);
        mu = fmaxf(mu, c);
    }
    mv = warp_max(mv);
    mu = warp_max(mu);
    if (lane == 0) {
        wmax[warp] = mv;
        wmax[kMaxWarps + warp] = mu;
    }
    __syncthreads();

    for (int t = 0; t + 1 < nf; ++t) {
        const int cur = t & 1, nxt = cur ^ 1;
        const float2* mc = m + (size_t)cur * n;            // kMShared: mc[u] = (m_v[u], m_u[u])
        const float* dc = hb + (size_t)t * two_n;          // kHist: delta_t, whose sources give m
        const float* wm = wmax + cur * 2 * kMaxWarps;
        const float gv = warp_max(wm[lane]), gu = warp_max(wm[kMaxWarps + lane]);
        const float* orow = obs + (size_t)(t + 1) * two_n;
        float* row = t + 2 == nf ? df : hb + (size_t)(t + 1) * two_n;
        mv = -INFINITY;
        mu = -INFINITY;
        for (int v = tid; v < n; v += kMaxThreads) {
            const float lo_v = __ldg(orow + v), lo_u = __ldg(orow + n + v);
            const int u0 = max(0, v - h), u1 = min(n - 1, v + h);
            const float* col = AT == kShared ? band + (size_t)(u0 - v + h) * n + v : log_tri + (size_t)u0 * n + v;
            auto source = [&](int u) -> float2 {  // (m_v[u], m_u[u])
                if constexpr (kMShared) {
                    return mc[u];
                } else {
                    const float dv = dc[u], du = dc[n + u];
                    return make_float2(fmaxf(dv + c_stay, du + c_sw), fmaxf(dv + c_sw, du + c_stay));
                }
            };
            // two chains a half (max is exact in any order)
            float av0 = -INFINITY, av1 = -INFINITY, au0 = -INFINITY, au1 = -INFINITY;
            int u = u0;
#pragma unroll 2
            for (; u < u1; u += 2, col += 2 * (size_t)n) {
                const float w0 = AT == kShared ? col[0] : __ldg(col);
                const float w1 = AT == kShared ? col[n] : __ldg(col + n);
                const float2 p0 = source(u), p1 = source(u + 1);
                av0 = fmaxf(av0, p0.x + w0);
                au0 = fmaxf(au0, p0.y + w0);
                av1 = fmaxf(av1, p1.x + w1);
                au1 = fmaxf(au1, p1.y + w1);
            }
            if (u == u1) {
                const float w0 = AT == kShared ? col[0] : __ldg(col);
                const float2 p0 = source(u);
                av0 = fmaxf(av0, p0.x + w0);
                au0 = fmaxf(au0, p0.y + w0);
            }
            const float dv = fmaxf(fmaxf(av0, av1), gv + floor_c) + lo_v;
            const float du = fmaxf(fmaxf(au0, au1), gu + floor_c) + lo_u;
            row[v] = dv;
            row[n + v] = du;
            const float a = fmaxf(dv + c_stay, du + c_sw), c = fmaxf(dv + c_sw, du + c_stay);
            if constexpr (kMShared) m[(size_t)nxt * n + v] = make_float2(a, c);
            mv = fmaxf(mv, a);
            mu = fmaxf(mu, c);
        }
        mv = warp_max(mv);
        mu = warp_max(mu);
        if (lane == 0) {
            wmax[nxt * 2 * kMaxWarps + warp] = mv;
            wmax[nxt * 2 * kMaxWarps + kMaxWarps + warp] = mu;
        }
        __syncthreads();  // row t + 1 of the history, m and the maxima of buffer nxt are complete
    }
}

template <BandAt AT>
cudaError_t launch_fwd_wide(const float* log_obs, const float* delta0, const float* log_tri, float* hist,
                            float* delta_f, int nb, int nf, int n, int h, float floor_c, float c_stay, float c_sw,
                            cudaStream_t stream)
{
    const size_t smem = fwd_wide_smem_bytes(n, h, AT);
    cudaError_t err = cudaFuncSetAttribute(viterbi_fwd_wide_kernel<AT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    viterbi_fwd_wide_kernel<AT><<<nb, kMaxThreads, smem, stream>>>(log_obs, delta0, log_tri, hist, delta_f, nf, n, h,
                                                                    floor_c, c_stay, c_sw);
    return cudaGetLastError();
}

// The toeplitz forward, n > kMaxThreads with a Toeplitz band (the wrapper
// passes its interior rows [lo, hi]: every row u there carries the same
// 2h + 1 values, log_tri[u, u - h + k] = window[k] bit for bit; pyin's
// transition, librosa's triangle, has lo = h and hi = n - 1 - h, and only
// its 2h edge rows, each renormalised by its own sum, differ). Then a
// target's in-band maximum is the larger of two: over its interior sources
// fl(m[u] + window[v - u + h]), the same floats as log_tri's, and over its
// edge sources fl(m[u] + log_tri[u, v]). Both maxima take the same sums as
// the one-block kernels, so the same bits.
//
// Design: a thread-block cluster per utterance (toe_plan: g ranks, rank r
// owning targets [t[r], t[r+1])), one cluster barrier a step. A rank keeps,
// double-buffered, m of the sources its targets reach (its slice and h on
// each side; an edge row's slot stays -inf) and m of the edge rows apart;
// each owner writes its new m into every rank that reads it, through
// distributed shared memory, and every warp's maxima of m into every rank,
// so each rank folds the cluster's gmax itself. The window sits in shared
// memory, padded with -inf; a thread takes 4 adjacent targets and sweeps the
// window offsets k (broadcast float4 loads) against a sliding run of 7
// sources (one float4 of each half of m per 4 offsets), so each m read
// serves 4 targets, and the split threads of a group (up to 8 a group, when
// a rank has few groups) sweep runs of offsets and fold their maxima by
// shuffles. The edge sources are a phase of their own: each window of 128
// targets walks the edge rows within h of it row by row (one broadcast m, a
// float4 of weights a lane: its 4 targets), from the rank's edge table,
// staged in shared memory with each row's run padded to whole float4s with
// -inf; the rows split in chunks over the warps, each chunk's maxima folded
// into its targets' by atomicMax on their order-preserving keys (exact).
// Then a thread a target adds the floor term fl(gmax + C) and the
// observations (the first target's loaded before the sweep). toe_split
// gives the end ranks fewer targets, so that their tables fit and their
// work, sweep and edge rows (an edge entry counted as kEdgeCost window
// offsets), is the cluster's average. Bound: the same work as the one-block
// kernels, on g SMs an utterance; the sweep is 2 FADD and 2 FMNMX a (target,
// source) pair. Times at every cluster size: PERF.md §6 (chip_smoke.py
// phase 11).

struct ToePlan {
    int g;                   // ranks in the cluster
    int k0, kspan;           // window offsets swept: k0 .. k0 + kspan - 1
    int ng;                  // groups of kToeGroup targets of the widest rank
    int ne;                  // edge rows: lo + n - 1 - hi
    int emax;                // edge-table floats of the fullest rank
    int split;               // threads sharing a group's sweep
    int t[kMaxCluster + 1];  // rank r's targets [t[r], t[r + 1])
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ __forceinline__ int toe_edge_row(int e, int lo, int hi) { return e < lo ? e : hi + 1 + (e - lo); }

// the edge rows within h of target v: its column's entries in the edge table
__host__ __device__ __forceinline__ int toe_edge_count(int v, int n, int h, int lo, int hi)
{
    return imax(0, imin(lo - 1, v + h) - imax(0, v - h) + 1) + imax(0, imin(n - 1, v + h) - imax(hi + 1, v - h) + 1);
}

long toe_edge_floats(int t0, int t1, int n, int h, int lo, int hi)
{
    long e = 0;
    for (int v = t0; v < t1; ++v) e += toe_edge_count(v, n, h, lo, hi);
    return e;
}

// the floats of a rank's edge table: each edge row's run of targets in
// [t0, t1) within h of it, its ends rounded out to multiples of 4 (t0 is one)
__host__ __device__ __forceinline__ int toe_run(int u, int t0, int t1, int h, int& a)
{
    a = imax(t0, u - h) / 4 * 4;
    const int z = imin(t1, u + h + 1);
    return z > imax(t0, u - h) ? (z + 3) / 4 * 4 - a : 0;
}

long toe_table_floats(int t0, int t1, int n, int h, int lo, int hi)
{
    long e = 0;
    int a;
    for (int k = 0; k < lo + n - 1 - hi; ++k) e += toe_run(toe_edge_row(k, lo, hi), t0, t1, h, a);
    return e;
}

// (k0, kspan): k0 = h + 1 (mod 4), so that a group's m loads are aligned
// float4s, and kspan a multiple of 32, so that up to 8 threads split it
void toe_span(int h, int& k0, int& kspan)
{
    k0 = (h + 1) % 4 == 0 ? 0 : (h + 1) % 4 - 4;
    kspan = (2 * h + 1 - k0 + 31) / 32 * 32;
}

// bytes of dynamic shared memory: the window, two m buffers of both halves
// over 4 ng + kspan slots, the groups' maxima, two buffers of the edge rows'
// m, every rank's warp maxima (two buffers, two halves), the edge table's
// rows (an int4 each) and the table (toe_table_floats)
size_t toe_smem_bytes(int h, int ne, int g, int ng, long e)
{
    int k0, kspan;
    toe_span(h, k0, kspan);
    const long lm = 4L * ng + kspan;
    return sizeof(float) * (size_t)(kspan + 4 * lm + 8L * ng + 4L * ne + 4L * g * kToeWarps + 4L * ne + e);
}

// the ranks' bounds: up to two ranks even shares; else from each end, while
// targets there read edge rows, a rank takes the share less 4 targets at a
// time (not below 4) until its in-band edge entries fit e_cap and its work,
// kspan a target and kEdgeCost an edge entry, fits the cluster's average
// (cost), and the ranks left (at least one) split the middle evenly.
// kernels/viterbi.py _toe_split mirrors it.
bool toe_split(int n, int h, int lo, int hi, int g, int share, long e_cap, long cost, int kspan, int* t)
{
    if (g <= 2) {
        for (int r = 0; r < g; ++r) t[r] = imin(n, r * share);
        t[g] = n;
        return true;
    }
    int low[kMaxCluster + 1], high[kMaxCluster + 1], nl = 1, nh = 1;
    low[0] = 0;
    while (low[nl - 1] < lo + h && nl < g - 1) {
        const int a0 = low[nl - 1];
        int a = share;
        long e = toe_edge_floats(a0, a0 + a, n, h, lo, hi);
        while (a > 4 && (e > e_cap || (long)kspan * a + kEdgeCost * e > cost)) {
            e -= toe_edge_floats(a0 + a - 4, a0 + a, n, h, lo, hi);
            a -= 4;
        }
        low[nl++] = a0 + a;
    }
    high[0] = n;
    while (high[nh - 1] > hi - h + 1 && nl + nh < g + 1) {
        const int z1 = high[nh - 1];
        int z = (z1 - share + 3) / 4 * 4;
        long e = toe_edge_floats(z, z1, n, h, lo, hi);
        while (z1 - z > 4 && (e > e_cap || (long)kspan * (z1 - z) + kEdgeCost * e > cost)) {
            e -= toe_edge_floats(z, z + 4, n, h, lo, hi);
            z += 4;
        }
        high[nh++] = z;
    }
    const int mid = g + 2 - nl - nh, a = low[nl - 1], z = high[nh - 1];
    if (z <= a) return false;
    const int ms = ((z - a + mid - 1) / mid + 3) / 4 * 4;
    int r = 0;
    for (int i = 0; i < nl; ++i) t[r++] = low[i];
    for (int i = 1; i < mid; ++i) t[r++] = imin(z, a + i * ms);
    for (int i = nh - 1; i >= 0; --i) t[r++] = high[i];
    return true;
}

// the plan of a cluster of g ranks, or false where none fits: shares of
// ceil(n / g) rounded up to 4 targets, split by toe_split in the room that
// middle ranks of the widest slice leave, that room found again (up to 4
// times) from the split it gives; every rank holds a target at least.
// kernels/viterbi.py cluster_partition mirrors it.
bool toe_partition(int n, int h, int lo, int hi, int g, ToePlan& p)
{
    if (g < 1 || g > kMaxCluster) return false;
    const int ne = lo + n - 1 - hi;
    const int share = ((n + g - 1) / g + 3) / 4 * 4;
    if ((long)(g - 1) * share >= n) return false;  // a rank without targets
    int k0, kspan;
    toe_span(h, k0, kspan);
    const long cost = ((long)kspan * n + kEdgeCost * toe_edge_floats(0, n, n, h, lo, hi) + g - 1) / g;
    int ng_room = share / 4;
    for (int it = 0; it < 4; ++it) {
        // the room for the edge table, less each row's padding (at most 6 floats) for the split's in-band count
        const long room = (long)(kSmemLimit / 4) - (long)(toe_smem_bytes(h, ne, g, ng_room, 0) / 4);
        int t[kMaxCluster + 1];
        if (room - 6L * ne < 0 || !toe_split(n, h, lo, hi, g, share, room - 6L * ne, cost, kspan, t)) return false;
        int ng = 0;
        long emax = 0;
        for (int r = 0; r < g; ++r) {
            const int size = t[r + 1] - t[r];
            const long e = toe_table_floats(t[r], t[r + 1], n, h, lo, hi);
            if (size <= 0 || e > room) return false;
            ng = imax(ng, (size + 3) / 4);
            emax = e > emax ? e : emax;
        }
        if (toe_smem_bytes(h, ne, g, ng, emax) <= (size_t)kSmemLimit) {
            p.g = g;
            toe_span(h, p.k0, p.kspan);
            p.ng = ng;
            p.ne = ne;
            p.emax = (int)emax;
            p.split = 8 * ng <= kToeThreads ? 8 : 4 * ng <= kToeThreads ? 4 : 2 * ng <= kToeThreads ? 2 : 1;
            for (int r = 0; r <= g; ++r) p.t[r] = t[r];
            return true;
        }
        ng_room = ng;
    }
    return false;
}

// the rule: a forced cluster, else the smallest of 1, 2, 4, 8, 16 ranks
// whose widest rank takes at most kToeSlice targets, else the largest that
// fits (16, non-portable, is the fastest at 3,601-6,001 bins: PERF.md §6).
// kernels/viterbi.py cluster_plan mirrors it.
bool toe_plan(int n, int h, int lo, int hi, int cluster, ToePlan& p)
{
    if (cluster) return toe_partition(n, h, lo, hi, cluster, p);
    bool found = false;
    for (int g = 1; g <= kRuleCluster; g *= 2) {
        ToePlan q;
        if (!toe_partition(n, h, lo, hi, g, q)) continue;
        p = q;
        found = true;
        int widest = 0;
        for (int r = 0; r < g; ++r) widest = imax(widest, q.t[r + 1] - q.t[r]);
        if (widest <= kToeSlice) break;
    }
    return found;
}

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__global__ void __launch_bounds__(kToeThreads, 1)
viterbi_fwd_toeplitz_kernel(const float* __restrict__ log_obs, const float* __restrict__ delta0,
                            const float* __restrict__ log_tri, float* __restrict__ hist,
                            float* __restrict__ delta_f, int nf, int n, int h, float floor_c, float c_stay,
                            float c_sw, int lo, int hi, const ToePlan p)
{
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(16) float smem_t[];
    const int g = p.g, rank = (int)cluster.block_rank(), b = blockIdx.x / g;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int two_n = 2 * n, gw = g * kToeWarps, lm = 4 * p.ng + p.kspan, ne = p.ne;
    int t0 = 0, t1 = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
        if (q == rank) {
            t0 = p.t[q];
            t1 = p.t[q + 1];
        }
    const int ngr = (t1 - t0 + 3) / 4;
    float* win = smem_t;                                   // [kspan]: window[k0 + i] at i, -inf past [0, 2h]
    float* mv = win + p.kspan;                             // [2][lm]: m_v of source base + i at i
    float* mu = mv + 2 * lm;                               // [2][lm]: m_u
    int* acv = reinterpret_cast<int*>(mu + 2 * lm);        // [4 ng]: a target's maximum over its sources (key)
    int* acu = acv + 4 * p.ng;
    float2* em = reinterpret_cast<float2*>(acu + 4 * p.ng);  // [2][ne]: (m_v, m_u) of edge row e
    float* wsl = reinterpret_cast<float*>(em + 2 * ne);    // [2][2][gw]: warp w of rank q at q * kToeWarps + w
    int4* rinfo = reinterpret_cast<int4*>(wsl + 4 * gw);   // [ne]: edge row e's run (table base - ra, ra, rz, base)
    float* etab = reinterpret_cast<float*>(rinfo + ne);    // row e: log_tri[u, v] for v in [ra, rz) (toe_run)
    const float* obs = log_obs + (size_t)b * nf * two_n;
    float* hb = hist + (size_t)b * (nf - 1) * two_n;
    float* df = delta_f + (size_t)b * two_n;
    const int base = t0 + h - p.k0 - p.kspan + 1;  // the source of slot 0 (a multiple of 4)

    for (int i = tid; i < p.kspan; i += kToeThreads) {
        const int k = p.k0 + i;
        win[i] = k >= 0 && k <= 2 * h ? log_tri[(size_t)lo * n + lo - h + k] : -INFINITY;
    }
    for (int i = tid; i < 4 * lm; i += kToeThreads) mv[i] = -INFINITY;            // mv and mu
    for (int i = tid; i < 4 * ne + 4 * gw; i += kToeThreads) reinterpret_cast<float*>(em)[i] = -INFINITY;  // and wsl
    if (tid == 0) {
        int at = 0, a;
        for (int e = 0; e < ne; ++e) {
            const int len = toe_run(toe_edge_row(e, lo, hi), t0, t1, h, a);
            rinfo[e] = make_int4(at - a, a, a + len, at);
            at += len;
        }
    }
    __syncthreads();
    for (int e = warp; e < ne; e += kToeWarps) {  // -inf past the band and past the rank's targets
        const int u = toe_edge_row(e, lo, hi);
        const int4 ri = rinfo[e];
        for (int j = lane; j < ri.z - ri.y; j += 32) {
            const int v = ri.y + j;
            etab[ri.w + j] = v >= u - h && v <= u + h && v < t1 ? log_tri[(size_t)u * n + v] : -INFINITY;
        }
    }
    cluster.sync();  // every rank's buffers hold -inf before the first push

    // m of target v into every rank whose targets reach it (buffer buf)
    auto push = [&](int v, float a, float c, int buf) {
        const bool inner = v >= lo && v <= hi;
        const int e = v < lo ? v : lo + (v - hi - 1);
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) {
            if (q >= g) break;
            if (v < p.t[q] - h || v > p.t[q + 1] - 1 + h) continue;
            if (inner) {
                float* dv = mv + buf * lm + v - (p.t[q] + h - p.k0 - p.kspan + 1);
                float* du = mu + buf * lm + v - (p.t[q] + h - p.k0 - p.kspan + 1);
                if (q != rank) {
                    dv = cluster.map_shared_rank(dv, q);
                    du = cluster.map_shared_rank(du, q);
                }
                *dv = a;
                *du = c;
            } else {
                float2* de = em + buf * ne + e;
                if (q != rank) de = cluster.map_shared_rank(de, q);
                *de = make_float2(a, c);
            }
        }
    };
    // the warp's maxima of m (order-preserving keys) into every rank (buffer buf)
    auto publish = [&](int kv, int ku, int buf) {
        kv = __reduce_max_sync(kFull, kv);
        ku = __reduce_max_sync(kFull, ku);
        if (lane < g) {
            float* dv = wsl + buf * 2 * gw + rank * kToeWarps + warp;
            float* du = dv + gw;
            if (lane != rank) {
                dv = cluster.map_shared_rank(dv, lane);
                du = cluster.map_shared_rank(du, lane);
            }
            *dv = key_value(kv);
            *du = key_value(ku);
        }
    };

    // delta_0 -> the history (or delta_f), m and the warp maxima, buffer 0
    int kv = ordered_key(-INFINITY), ku = kv;
    for (int v = t0 + tid; v < t1; v += kToeThreads) {
        const float dv = delta0[(size_t)b * two_n + v], du = delta0[(size_t)b * two_n + n + v];
        float* row = nf == 1 ? df : hb;
        row[v] = dv;
        row[n + v] = du;
        const float a = fmaxf(dv + c_stay, du + c_sw), c = fmaxf(dv + c_sw, du + c_stay);
        push(v, a, c, 0);
        kv = max(kv, ordered_key(a));
        ku = max(ku, ordered_key(c));
    }
    publish(kv, ku, 0);
    cluster.sync();

    const int per = 32 / p.split, kseg = lane / per, seg = p.kspan / 4 / p.split;
    for (int t = 0; t + 1 < nf; ++t) {
        const int cur = t & 1, nxt = cur ^ 1;
        // the observations of the thread's first target, in flight through the sweep (later ones load late)
        const float* orow = obs + (size_t)(t + 1) * two_n;
        const float ov0 = t0 + tid < t1 ? __ldg(orow + t0 + tid) : 0.0f;
        const float ou0 = t0 + tid < t1 ? __ldg(orow + n + t0 + tid) : 0.0f;
        // gmax of the cluster: every rank's warp maxima
        const float* wm = wsl + cur * 2 * gw;
        int gkv = ordered_key(-INFINITY), gku = gkv;
        for (int i = lane; i < gw; i += 32) {
            gkv = max(gkv, ordered_key(wm[i]));
            gku = max(gku, ordered_key(wm[gw + i]));
        }
        const float gv = key_value(__reduce_max_sync(kFull, gkv)), gu = key_value(__reduce_max_sync(kFull, gku));

        // the sweep: group grp's targets v0 + j (j < 4) against the window
        const float* mvc = mv + cur * lm;
        const float* muc = mu + cur * lm;
        for (int g0 = warp * per; g0 < ngr; g0 += kToeWarps * per) {
            const int grp = min(g0 + lane % per, ngr - 1);  // lanes past the last group repeat it, unstored
            float av[kToeGroup], au[kToeGroup];
#pragma unroll
            for (int j = 0; j < kToeGroup; ++j) av[j] = au[j] = -INFINITY;
            // slot c holds source v0 + h - k for the block's first offset k; c = 3 (mod 4)
            int c = 4 * grp - 4 * kseg * seg + p.kspan - 1;
            float4 hv = lds4(mvc + c + 1), hu = lds4(muc + c + 1);  // sources c + 1 .. c + 4
            const float* wp = win + 4 * kseg * seg;
            float4 lv = lds4(mvc + c - 3), lu = lds4(muc + c - 3), w4 = lds4(wp);  // sources c - 3 .. c
            for (int bi = 0; bi < seg; ++bi, c -= 4, wp += 4) {
                // the next block's loads in flight while this one reduces (past the last block, unused
                // words of shared memory)
                const float4 nlv = lds4(mvc + c - 7), nlu = lds4(muc + c - 7), nw4 = lds4(wp + 4);
                const float xv[7] = {lv.x, lv.y, lv.z, lv.w, hv.x, hv.y, hv.z};
                const float xu[7] = {lu.x, lu.y, lu.z, lu.w, hu.x, hu.y, hu.z};
                const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                for (int dk = 0; dk < 4; ++dk)
#pragma unroll
                    for (int j = 0; j < kToeGroup; ++j) {  // source c + j - dk into target v0 + j at offset k + dk
                        av[j] = fmaxf(av[j], xv[j - dk + 3] + wk[dk]);
                        au[j] = fmaxf(au[j], xu[j - dk + 3] + wk[dk]);
                    }
                hv = lv;
                hu = lu;
                lv = nlv;
                lu = nlu;
                w4 = nw4;
            }
            for (int off = per; off < 32; off <<= 1)
#pragma unroll
                for (int j = 0; j < kToeGroup; ++j) {
                    av[j] = fmaxf(av[j], __shfl_xor_sync(kFull, av[j], off));
                    au[j] = fmaxf(au[j], __shfl_xor_sync(kFull, au[j], off));
                }
            if (kseg == 0 && g0 + lane % per < ngr) {
                *reinterpret_cast<int4*>(acv + 4 * grp) =
                    make_int4(ordered_key(av[0]), ordered_key(av[1]), ordered_key(av[2]), ordered_key(av[3]));
                *reinterpret_cast<int4*>(acu + 4 * grp) =
                    make_int4(ordered_key(au[0]), ordered_key(au[1]), ordered_key(au[2]), ordered_key(au[3]));
            }
        }
        __syncthreads();

        // the edge rows within h of each window of 128 targets, row by row (one m, a float4 of weights a
        // lane: its 4 targets), the rows split in chunks over the warps; each chunk's maxima folded in by
        // atomicMax on their keys
        const float2* emc = em + cur * ne;
        const int nwin = (t1 - t0 + 127) / 128, nch = max(1, kToeWarps / nwin);
        for (int item = warp; item < nwin * nch; item += kToeWarps) {
            const int w0 = t0 + 128 * (item / nch), w1 = min(t1, w0 + 128) - 1, v0 = w0 + 4 * lane;
            const int a0 = max(0, w0 - h), nlow = max(0, min(lo, w1 + h + 1) - a0);        // rows a0 .. below lo
            const int b0 = max(hi + 1, w0 - h), nrows = nlow + max(0, min(n, w1 + h + 1) - b0);  // and past hi
            const int per_ch = (nrows + nch - 1) / nch, r0 = (item % nch) * per_ch, r1 = min(nrows, r0 + per_ch);
            const int eb = lo + b0 - hi - 1 - nlow;  // edge row of the r-th row past hi, less r
            float bv[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
            float bu[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll 2
            for (int r = r0; r < r1; ++r) {
                const int e = r < nlow ? a0 + r : eb + r;
                const int4 ri = rinfo[e];
                const float2 mm = emc[e];
                if (v0 >= ri.y && v0 < ri.z) {
                    const float4 w = lds4(etab + ri.x + v0);
                    const float wk[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        bv[j] = fmaxf(bv[j], mm.x + wk[j]);
                        bu[j] = fmaxf(bu[j], mm.y + wk[j]);
                    }
                }
            }
            if (r1 > r0)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (v0 + j <= w1) {
                        atomicMax(acv + v0 + j - t0, ordered_key(bv[j]));
                        atomicMax(acu + v0 + j - t0, ordered_key(bu[j]));
                    }
        }
        __syncthreads();

        // a thread a target: the floor term, the observations, the history and the pushes
        float* row = t + 2 == nf ? df : hb + (size_t)(t + 1) * two_n;
        kv = ordered_key(-INFINITY);
        ku = kv;
        for (int w0 = t0 + 32 * warp; w0 < t1; w0 += kToeThreads) {  // the warp's 32 targets from w0
            const int v = w0 + lane;
            if (v < t1) {
                const float bv = key_value(acv[v - t0]), bu = key_value(acu[v - t0]);
                const bool first = w0 == t0 + 32 * warp;
                const float ov = first ? ov0 : __ldg(orow + v), ou = first ? ou0 : __ldg(orow + n + v);
                const float dv = fmaxf(bv, gv + floor_c) + ov, du = fmaxf(bu, gu + floor_c) + ou;
                row[v] = dv;
                row[n + v] = du;
                const float a = fmaxf(dv + c_stay, du + c_sw), c = fmaxf(dv + c_sw, du + c_stay);
                push(v, a, c, nxt);
                kv = max(kv, ordered_key(a));
                ku = max(ku, ordered_key(c));
            }
        }
        publish(kv, ku, nxt);
        cluster.sync();  // m, the edge rows' m and the maxima of buffer nxt are complete in every rank
    }
}

cudaError_t launch_fwd_toeplitz(const ToePlan& p, const float* log_obs, const float* delta0, const float* log_tri,
                                float* hist, float* delta_f, int nb, int nf, int n, int h, float floor_c,
                                float c_stay, float c_sw, int lo, int hi, cudaStream_t stream)
{
    const size_t smem = toe_smem_bytes(h, p.ne, p.g, p.ng, p.emax);
    cudaError_t err = cudaFuncSetAttribute(viterbi_fwd_toeplitz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    if (p.g > 8) {
        err = cudaFuncSetAttribute(viterbi_fwd_toeplitz_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb * p.g);
    cfg.blockDim = dim3(kToeThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.g;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, viterbi_fwd_toeplitz_kernel, log_obs, delta0, log_tri, hist, delta_f, nf, n, h,
                             floor_c, c_stay, c_sw, lo, hi, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// viterbi_bwd_f32
//
// Replaces the Pallas kernels of modulation_mfcc_tpu/pallas/viterbi.py:
// viterbi_decode_pallas -> _bwd_kernel and viterbi_decode_batched ->
// _bwd_kernel_b.
//
// For utterance b (one block): path[NF-1] = first argmax of delta_f[b];
// then for t = NF-2 .. 0, with nxt = path[t+1], d = hist[b, t], pos = nxt
// mod n:
//   (a, c) = nxt < n ? (c_stay, c_sw) : (c_sw, c_stay)
//   score[u] = max(d[u] + a, d[n+u] + c) + log_tri[u, pos]
//   base     = first argmax of score (the lower index wins equal values)
//   path[t]  = base + n * (d[n+base] + c > d[base] + a)   (voiced wins ties)
//
// The band. The wrapper passes the forward's (h, C): every entry of log_tri
// farther than h from the diagonal equals C, and none lies below it. So a
// score is fl(m[u] + log_tri[u, pos]) with the entry read from the band
// where |u - pos| <= h, and fl(m[u] + C) elsewhere, the same float as the
// matrix entry: the same bits. The first argmax is taken over the union of
// two sets of candidates: fl(m[u] + C) for every source u, and the in-band
// scores. A source's C candidate is at most its true score (log_tri >= C,
// and FP32 addition is monotone), so the union's maximum is the scores'
// maximum, reached by the same sources, and the lower index wins in both.
// The C candidates cannot be cut to the argmax of m: distinct m round to
// equal sums fl(m + C), and then the first of them wins.
//
// Bound: the one read of the history (277 MB at 32 x 30 s of 16 kHz audio),
// 0.08 ms at 3.35 TB/s. The steps depend on each other through pos, so the
// kernel is bound by the latency of a step instead.
//
// Design: a block of four warps per utterance, each on its own scheduler.
// Everything but the in-band scores is independent of the path, so three
// producer warps do it ahead of the chain, each on every third history row
// (loaded two of its rows ahead): m and sel of every source for both cases
// (next state voiced or not) into a ring of kSlots rows in shared memory as
// (m, sel) pairs, and the first maximum of the C candidates of each case.
// The chain warp then takes a step in the 2h + 1 band entries at pos (pyin:
// 43, at most two a lane, read without branches): one 8-byte load of (m,
// sel) and one of the band per slot, the warp's first maximum (two
// redux.sync: the largest order-preserving key, -0 keyed as +0 because the
// rule compares with ==, then the least 2u + sel holding it), and the
// comparison with the producers' C candidate. The band is staged once from
// log_tri as [pos][2h + 1] (entry (pos - h + j, pos) at j, C past the
// matrix's edges). Each ring slot has two mbarriers: full (the producer's 32
// lanes arrive) and empty (the chain warp's). Where the band does not fit
// in shared memory beside the ring (a dense transition, h = n - 1), the
// chain reads row pos of the transposed log_tri from L2 and scores every
// source as in-band: no C candidates. Times on the H100: PERF.md §6
// (chip_smoke.py phase 13).
// ---------------------------------------------------------------------------

constexpr int kProducers = 3;                   // warps that prepare the history rows
constexpr int kBwdThreads = 32 * (1 + kProducers);
constexpr int kWideProducers = 7;               // the wide backtraces' producer warps (at most kSlots)
constexpr int kWideBwdThreads = 32 * (1 + kWideProducers);
constexpr int kProducerLoads = 8;               // history sources a wide producer lane loads before it reduces them
enum BwdLayout { kBandPairs, kBandLoop, kDense };  // band of <= 64 entries, a wider band, log_tri^T from L2

// bytes of dynamic shared memory: two mbarriers and 8 words of C candidates
// a slot, the ring of (m, sel) pairs (both cases), and the band where it is
// staged
constexpr size_t bwd_smem_bytes(int n, int h, bool banded)
{
    return (size_t)kSlots * (16 + 32 + 16 * (size_t)n) + (banded ? sizeof(float) * n * (2 * h + 1) : 0);
}

// the first maximum of a warp's candidates (val, idx): the largest value,
// and the lowest index among those holding it (-0 equal to +0), with its
// sel. A lane without a candidate holds idx INT_MAX.
struct Best {
    float val;
    int idx, sel;
};

__device__ __forceinline__ Best warp_first_max(float val, int idx, int sel)
{
    const int key = idx == INT_MAX ? INT_MIN : ordered_key(__fadd_rn(val, 0.0f));  // -0 + 0 = +0
    const int top = __reduce_max_sync(kFull, key);
    const int first = __reduce_min_sync(kFull, key == top ? 2 * idx + sel : INT_MAX);
    return {key_value(top), first >> 1, first & 1};
}

// a lane's candidate (s, u, sel) against its best so far
__device__ __forceinline__ void keep_first_max(float& val, int& idx, int& sel, float s, int u, int sl)
{
    if (s > val || (s == val && u < idx)) {
        val = s;
        idx = u;
        sel = sl;
    }
}

// the chain warp's last state: the first argmax of delta_f's 2n states
__device__ __forceinline__ int last_state(const float* df, int n, int lane)
{
    float best = -INFINITY;
    int bi = INT_MAX, unused = 0;
    for (int i = lane; i < 2 * n; i += 32) keep_first_max(best, bi, unused, df[i], i, 0);
    return warp_first_max(best, bi, 0).idx;
}

// step s's state nxt: lane s mod 32 keeps it until the warp stores the 32
// states it holds together, after every 32nd step and the last
__device__ __forceinline__ void put_state(int& mine, int nxt, int s, int steps, int lane, int* pb, int nf)
{
    mine = lane == (s & 31) ? nxt : mine;
    if ((s & 31) == 31 || s == steps - 1) {
        const int s_lane = (s & ~31) + lane;  // the step whose state this lane holds
        if (s_lane <= s) pb[nf - 2 - s_lane] = mine;
    }
}

// the backtrace's band, [n][2h + 1]: entry (pos - h + j, pos) at [pos][j], C
// past the matrix's edges; every thread of the block (nt) calls it
__device__ __forceinline__ void stage_bwd_band(float* band, const float* log_tri, int n, int h, float floor_c,
                                               int tid, int nt)
{
    const int width = 2 * h + 1;
    for (int i = tid; i < n * width; i += nt) band[i] = floor_c;
    __syncthreads();
    // entry (u, pos = u - h + k): consecutive threads read consecutive pos of row u
#pragma unroll 4
    for (int i = tid; i < n * width; i += nt) {
        const int u = i / width, k = i - u * width, pos = u - h + k;
        if (pos >= 0 && pos < n) band[pos * width + 2 * h - k] = log_tri[(size_t)u * n + pos];
    }
}

template <int KP>
__device__ __forceinline__ void load_row(float (&dv)[KP], float (&du)[KP], const float* row, bool valid, int n,
                                         int lane)
{
#pragma unroll
    for (int k = 0; k < KP; ++k) {
        const int u = lane + 32 * k;
        dv[k] = valid && u < n ? __ldg(row + u) : 0.0f;
        du[k] = valid && u < n ? __ldg(row + n + u) : 0.0f;
    }
}

template <int KP, int LAYOUT>
__global__ void __launch_bounds__(kBwdThreads)
viterbi_bwd_f32_kernel(const float* __restrict__ hist, const float* __restrict__ delta_f,
                       const float* __restrict__ log_tri, const float* __restrict__ log_tri_t,
                       int* __restrict__ path, int nf, int n, int h, float floor_c, float c_stay, float c_sw)
{
    constexpr bool kBanded = LAYOUT != kDense;
    extern __shared__ __align__(16) unsigned char smem_b[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem_b);                 // [kSlots]
    uint64_t* empty = full + kSlots;                                      // [kSlots]
    int4* cands = reinterpret_cast<int4*>(empty + kSlots);                // [kSlots][2]: (val, idx, sel) of each case
    float2* ring = reinterpret_cast<float2*>(cands + 2 * kSlots);         // [kSlots][2][n]: (m, sel) of each case
    float* band = reinterpret_cast<float*>(ring + (size_t)kSlots * 2 * n);  // [n][width]
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int width = 2 * h + 1, steps = nf - 1;
    const float* hb = hist + (size_t)b * steps * 2 * n;
    int* pb = path + (size_t)b * nf;

    if (tid == 0) {
        for (int i = 0; i < kSlots; ++i) {
            mbar::init(full + i, 32);
            mbar::init(empty + i, 32);
        }
        mbar::fence_init();
    }
    if constexpr (kBanded) stage_bwd_band(band, log_tri, n, h, floor_c, tid, kBwdThreads);
    __syncthreads();

    if (warp > 0) {
        // a producer: steps s = warp - 1, + kProducers, ...; step s reads history row nf - 2 - s
        float av[KP], au[KP], bv[KP], bu[KP], cv[KP], cu[KP];
        const int s0 = warp - 1;
        load_row(av, au, hb + (size_t)(steps - 1 - s0) * 2 * n, s0 < steps, n, lane);
        load_row(bv, bu, hb + (size_t)(steps - 1 - s0 - kProducers) * 2 * n, s0 + kProducers < steps, n, lane);
        for (int s = s0; s < steps; s += kProducers) {
            const int ahead = s + 2 * kProducers;
            load_row(cv, cu, hb + (size_t)(steps - 1 - ahead) * 2 * n, ahead < steps, n, lane);
            const int slot = s % kSlots, use = s / kSlots;
            if (use > 0) mbar::wait(empty + slot, (use - 1) & 1);
            float2* mrow = ring + (size_t)slot * 2 * n;
            float v0 = -INFINITY, v1 = -INFINITY;
            int i0 = INT_MAX, i1 = INT_MAX, e0 = 0, e1 = 0;
#pragma unroll
            for (int k = 0; k < KP; ++k) {
                const int u = lane + 32 * k;
                if (u < n) {
                    const float fv = av[k] + c_stay, fu = au[k] + c_sw;  // next state voiced: (a, c) = (c_stay, c_sw)
                    const float gv = av[k] + c_sw, gu = au[k] + c_stay;  // unvoiced: (c_sw, c_stay)
                    const float m0 = fmaxf(fv, fu), m1 = fmaxf(gv, gu);
                    const int s0_ = fu > fv, s1_ = gu > gv;
                    mrow[u] = make_float2(m0, __int_as_float(s0_));
                    mrow[n + u] = make_float2(m1, __int_as_float(s1_));
                    if constexpr (kBanded) {
                        keep_first_max(v0, i0, e0, m0 + floor_c, u, s0_);
                        keep_first_max(v1, i1, e1, m1 + floor_c, u, s1_);
                    }
                }
            }
            if constexpr (kBanded) {
                const Best c0 = warp_first_max(v0, i0, e0), c1 = warp_first_max(v1, i1, e1);
                if (lane == 0) {
                    cands[2 * slot] = make_int4(__float_as_int(c0.val), c0.idx, c0.sel, 0);
                    cands[2 * slot + 1] = make_int4(__float_as_int(c1.val), c1.idx, c1.sel, 0);
                }
            }
            mbar::arrive(full + slot);
#pragma unroll
            for (int k = 0; k < KP; ++k) {
                av[k] = bv[k]; au[k] = bu[k];
                bv[k] = cv[k]; bu[k] = cu[k];
            }
        }
        return;
    }

    // the chain warp
    int nxt = last_state(delta_f + (size_t)b * 2 * n, n, lane);
    if (lane == 0) pb[nf - 1] = nxt;
    int mine = 0;  // lane l keeps the state of step 32 q + l until the warp stores the 32 together
    for (int s = 0; s < steps; ++s) {
        const int slot = s % kSlots, use = s / kSlots;
        mbar::wait(full + slot, use & 1);
        const bool voiced = nxt < n;
        const int pos = voiced ? nxt : nxt - n;
        const float2* mc = ring + (size_t)slot * 2 * n + (voiced ? 0 : n);
        const int4 cand = cands[2 * slot + (voiced ? 0 : 1)];
        float val = -INFINITY;
        int idx = INT_MAX, sel = 0;
        if constexpr (LAYOUT == kBandPairs) {
            const float* col = band + pos * width;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int j = lane + 32 * q, u = pos - h + j;
                const bool ok = j < width && u >= 0 && u < n;
                const float2 ms = mc[ok ? u : pos];
                const float w = col[ok ? j : h];
                if (ok) keep_first_max(val, idx, sel, ms.x + w, u, __float_as_int(ms.y));
            }
        } else if constexpr (LAYOUT == kBandLoop) {
            const float* col = band + pos * width;
            for (int j = lane; j < width; j += 32) {
                const int u = pos - h + j;
                if (u >= 0 && u < n) {
                    const float2 ms = mc[u];
                    keep_first_max(val, idx, sel, ms.x + col[j], u, __float_as_int(ms.y));
                }
            }
        } else {
            const float* col = log_tri_t + (size_t)pos * n;
#pragma unroll
            for (int k = 0; k < KP; ++k) {
                const int u = lane + 32 * k;
                if (u < n) {
                    const float2 ms = mc[u];
                    keep_first_max(val, idx, sel, ms.x + __ldg(col + u), u, __float_as_int(ms.y));
                }
            }
        }
        Best in = warp_first_max(val, idx, sel);
        if constexpr (kBanded) {
            const float cv = __int_as_float(cand.x);
            if (cv > in.val || (cv == in.val && cand.y < in.idx)) {
                in.idx = cand.y;
                in.sel = cand.z;
            }
        }
        mbar::arrive(empty + slot);
        nxt = in.idx + n * in.sel;
        put_state(mine, nxt, s, steps, lane, pb, nf);
    }
}

template <int KP>
cudaError_t launch_bwd(const float* hist, const float* delta_f, const float* log_tri, const float* log_tri_t,
                       int* path, int nb, int nf, int n, int h, float floor_c, float c_stay, float c_sw,
                       bool banded, cudaStream_t stream)
{
    const size_t smem = bwd_smem_bytes(n, h, banded);
    auto kernel = !banded ? viterbi_bwd_f32_kernel<KP, kDense>
                          : 2 * h + 1 <= 64 ? viterbi_bwd_f32_kernel<KP, kBandPairs>
                                            : viterbi_bwd_f32_kernel<KP, kBandLoop>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<nb, kBwdThreads, smem, stream>>>(hist, delta_f, log_tri, log_tri_t, path, nf, n, h, floor_c, c_stay,
                                              c_sw);
    return cudaGetLastError();
}

// The wide backtrace, n > kRingBins: past the widest KP, kWideProducers
// producer warps (wide_producer) stream each history row, kProducerLoads
// sources a lane in flight, and keep nothing of it but the first maximum of
// the C candidates of each case (the ring holds only those, kSlots rows
// ahead; fewer producers, or one source a lane at a time, set the
// backtrace's pace: PERF.md §6). The chain warp reads its 2h + 1
// in-band sources of the row straight from the history (L2), forms their m
// and sel as the producers would (the same FP32 operations, so the same
// bits), and scores them against the band: staged in shared memory as
// [n][2h + 1] where it fits (kBanded), else row pos of log_tri transposed
// from L2, its in-band entries. Shared memory: the barriers, the C
// candidates and the band, none of it a history row, so any n that device
// memory holds.

// bytes of dynamic shared memory: two mbarriers and 8 words of C candidates
// a slot, and the band where it is staged
constexpr size_t bwd_wide_smem_bytes(int n, int h, bool banded)
{
    return (size_t)kSlots * (16 + 32) + (banded ? sizeof(float) * (size_t)n * (2 * h + 1) : 0);
}

// a producer warp of the wide backtraces: steps s = warp - 1, +
// kWideProducers, ...; step s streams history row nf - 2 - s, kProducerLoads
// sources a lane in flight, and keeps the first maximum of the C candidates
// of each case in its slot
__device__ __forceinline__ void wide_producer(const float* hb, int4* cands, uint64_t* full, uint64_t* empty,
                                              int steps, int n, float floor_c, float c_stay, float c_sw, int warp,
                                              int lane)
{
    for (int s = warp - 1; s < steps; s += kWideProducers) {
        const float* row = hb + (size_t)(steps - 1 - s) * 2 * n;
        const int slot = s % kSlots, use = s / kSlots;
        float v0 = -INFINITY, v1 = -INFINITY;
        int i0 = INT_MAX, i1 = INT_MAX, e0 = 0, e1 = 0;
        for (int ub = lane; ub < n; ub += 32 * kProducerLoads) {
            float dv[kProducerLoads], du[kProducerLoads];
#pragma unroll
            for (int i = 0; i < kProducerLoads; ++i) {
                const int u = ub + 32 * i;
                dv[i] = u < n ? __ldg(row + u) : 0.0f;
                du[i] = u < n ? __ldg(row + n + u) : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < kProducerLoads; ++i) {
                const int u = ub + 32 * i;
                if (u < n) {
                    const float fv = dv[i] + c_stay, fu = du[i] + c_sw;  // next state voiced: (a, c) = (c_stay, c_sw)
                    const float gv = dv[i] + c_sw, gu = du[i] + c_stay;  // unvoiced: (c_sw, c_stay)
                    keep_first_max(v0, i0, e0, fmaxf(fv, fu) + floor_c, u, fu > fv);
                    keep_first_max(v1, i1, e1, fmaxf(gv, gu) + floor_c, u, gu > gv);
                }
            }
        }
        const Best c0 = warp_first_max(v0, i0, e0), c1 = warp_first_max(v1, i1, e1);
        if (use > 0) mbar::wait(empty + slot, (use - 1) & 1);
        if (lane == 0) {
            cands[2 * slot] = make_int4(__float_as_int(c0.val), c0.idx, c0.sel, 0);
            cands[2 * slot + 1] = make_int4(__float_as_int(c1.val), c1.idx, c1.sel, 0);
        }
        mbar::arrive(full + slot);
    }
}

template <bool BANDED>
__global__ void __launch_bounds__(kWideBwdThreads)
viterbi_bwd_wide_kernel(const float* __restrict__ hist, const float* __restrict__ delta_f,
                        const float* __restrict__ log_tri, const float* __restrict__ log_tri_t,
                        int* __restrict__ path, int nf, int n, int h, float floor_c, float c_stay, float c_sw)
{
    extern __shared__ __align__(16) unsigned char smem_b[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem_b);            // [kSlots]
    uint64_t* empty = full + kSlots;                                 // [kSlots]
    int4* cands = reinterpret_cast<int4*>(empty + kSlots);           // [kSlots][2]: (val, idx, sel) of each case
    float* band = reinterpret_cast<float*>(cands + 2 * kSlots);      // BANDED: [n][width]
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int width = 2 * h + 1, steps = nf - 1;
    const float* hb = hist + (size_t)b * steps * 2 * n;
    int* pb = path + (size_t)b * nf;

    if (tid == 0) {
        for (int i = 0; i < kSlots; ++i) {
            mbar::init(full + i, 32);
            mbar::init(empty + i, 32);
        }
        mbar::fence_init();
    }
    if constexpr (BANDED) stage_bwd_band(band, log_tri, n, h, floor_c, tid, kWideBwdThreads);
    __syncthreads();

    if (warp > 0) {
        wide_producer(hb, cands, full, empty, steps, n, floor_c, c_stay, c_sw, warp, lane);
        return;
    }

    // the chain warp
    int nxt = last_state(delta_f + (size_t)b * 2 * n, n, lane);
    if (lane == 0) pb[nf - 1] = nxt;
    int mine = 0;  // lane l keeps the state of step 32 q + l until the warp stores the 32 together
    for (int s = 0; s < steps; ++s) {
        const int slot = s % kSlots, use = s / kSlots;
        const bool voiced = nxt < n;
        const int pos = voiced ? nxt : nxt - n;
        const float a = voiced ? c_stay : c_sw, c = voiced ? c_sw : c_stay;
        const float* d = hb + (size_t)(steps - 1 - s) * 2 * n;
        const float* col = BANDED ? band + (size_t)pos * width + h - pos : log_tri_t + (size_t)pos * n;
        float val = -INFINITY;
        int idx = INT_MAX, sel = 0;
        for (int u = max(0, pos - h) + lane; u <= min(n - 1, pos + h); u += 32) {
            const float fa = __ldg(d + u) + a, fc = __ldg(d + n + u) + c;
            const float w = BANDED ? col[u] : __ldg(col + u);
            keep_first_max(val, idx, sel, fmaxf(fa, fc) + w, u, fc > fa);
        }
        Best in = warp_first_max(val, idx, sel);
        mbar::wait(full + slot, use & 1);
        const int4 cand = cands[2 * slot + (voiced ? 0 : 1)];
        const float cv = __int_as_float(cand.x);
        if (cv > in.val || (cv == in.val && cand.y < in.idx)) {
            in.idx = cand.y;
            in.sel = cand.z;
        }
        mbar::arrive(empty + slot);
        nxt = in.idx + n * in.sel;
        put_state(mine, nxt, s, steps, lane, pb, nf);
    }
}

template <bool BANDED>
cudaError_t launch_bwd_wide(const float* hist, const float* delta_f, const float* log_tri, const float* log_tri_t,
                            int* path, int nb, int nf, int n, int h, float floor_c, float c_stay, float c_sw,
                            cudaStream_t stream)
{
    const size_t smem = bwd_wide_smem_bytes(n, h, BANDED);
    cudaError_t err = cudaFuncSetAttribute(viterbi_bwd_wide_kernel<BANDED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    viterbi_bwd_wide_kernel<BANDED><<<nb, kWideBwdThreads, smem, stream>>>(hist, delta_f, log_tri, log_tri_t, path, nf,
                                                                       n, h, floor_c, c_stay, c_sw);
    return cudaGetLastError();
}

// The toeplitz backtrace, n > kRingBins with a Toeplitz band: the wide
// backtrace's producers, and a chain warp that scores its 2h + 1 in-band
// sources against the window in shared memory where the source is an
// interior row and against log_tri[u, pos] where it is an edge row (the
// same floats as the band's). It makes no copy of log_tri. A step's loads
// (kChainLoads sources a lane: two history floats and a weight each) are
// all issued before the first is scored, and the slot's full barrier is
// waited on while they are in flight.

// bytes of dynamic shared memory: two mbarriers and 8 words of C candidates
// a slot, and the window
constexpr size_t bwd_toe_smem_bytes(int h) { return (size_t)kSlots * (16 + 32) + sizeof(float) * (2 * h + 1); }

__global__ void __launch_bounds__(kWideBwdThreads)
viterbi_bwd_toeplitz_kernel(const float* __restrict__ hist, const float* __restrict__ delta_f,
                            const float* __restrict__ log_tri, int* __restrict__ path, int nf, int n, int h,
                            float floor_c, float c_stay, float c_sw, int lo, int hi)
{
    extern __shared__ __align__(16) unsigned char smem_b[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem_b);            // [kSlots]
    uint64_t* empty = full + kSlots;                                 // [kSlots]
    int4* cands = reinterpret_cast<int4*>(empty + kSlots);           // [kSlots][2]: (val, idx, sel) of each case
    float* win = reinterpret_cast<float*>(cands + 2 * kSlots);       // [2h + 1]: window[k] = log_tri[lo, lo - h + k]
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int steps = nf - 1;
    const float* hb = hist + (size_t)b * steps * 2 * n;
    int* pb = path + (size_t)b * nf;

    if (tid == 0) {
        for (int i = 0; i < kSlots; ++i) {
            mbar::init(full + i, 32);
            mbar::init(empty + i, 32);
        }
        mbar::fence_init();
    }
    for (int k = tid; k <= 2 * h; k += kWideBwdThreads) win[k] = log_tri[(size_t)lo * n + lo - h + k];
    __syncthreads();

    if (warp > 0) {
        wide_producer(hb, cands, full, empty, steps, n, floor_c, c_stay, c_sw, warp, lane);
        return;
    }

    // the chain warp
    int nxt = last_state(delta_f + (size_t)b * 2 * n, n, lane);
    if (lane == 0) pb[nf - 1] = nxt;
    int mine = 0;  // lane l keeps the state of step 32 q + l until the warp stores the 32 together
    for (int s = 0; s < steps; ++s) {
        const int slot = s % kSlots, use = s / kSlots;
        const bool voiced = nxt < n;
        const int pos = voiced ? nxt : nxt - n;
        const float a = voiced ? c_stay : c_sw, c = voiced ? c_sw : c_stay;
        const float* d = hb + (size_t)(steps - 1 - s) * 2 * n;
        const int u0 = max(0, pos - h), u1 = min(n - 1, pos + h);
        float val = -INFINITY;
        int idx = INT_MAX, sel = 0;
        for (int ub = u0; ub <= u1; ub += 32 * kChainLoads) {
            float da[kChainLoads], dc[kChainLoads], w[kChainLoads];
#pragma unroll
            for (int i = 0; i < kChainLoads; ++i) {
                const int u = ub + lane + 32 * i;
                const bool ok = u <= u1;
                da[i] = ok ? __ldg(d + u) : 0.0f;
                dc[i] = ok ? __ldg(d + n + u) : 0.0f;
                w[i] = !ok ? 0.0f : u >= lo && u <= hi ? win[pos - u + h] : __ldg(log_tri + (size_t)u * n + pos);
            }
            if (ub == u0) mbar::wait(full + slot, use & 1);
#pragma unroll
            for (int i = 0; i < kChainLoads; ++i) {
                const int u = ub + lane + 32 * i;
                if (u <= u1) {
                    const float fa = da[i] + a, fc = dc[i] + c;
                    keep_first_max(val, idx, sel, fmaxf(fa, fc) + w[i], u, fc > fa);
                }
            }
        }
        Best in = warp_first_max(val, idx, sel);
        const int4 cand = cands[2 * slot + (voiced ? 0 : 1)];
        const float cv = __int_as_float(cand.x);
        if (cv > in.val || (cv == in.val && cand.y < in.idx)) {
            in.idx = cand.y;
            in.sel = cand.z;
        }
        mbar::arrive(empty + slot);
        nxt = in.idx + n * in.sel;
        put_state(mine, nxt, s, steps, lane, pb, nf);
    }
}

cudaError_t launch_bwd_toeplitz(const float* hist, const float* delta_f, const float* log_tri, int* path, int nb,
                                int nf, int n, int h, float floor_c, float c_stay, float c_sw, int lo, int hi,
                                cudaStream_t stream)
{
    const size_t smem = bwd_toe_smem_bytes(h);
    cudaError_t err = cudaFuncSetAttribute(viterbi_bwd_toeplitz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    viterbi_bwd_toeplitz_kernel<<<nb, kWideBwdThreads, smem, stream>>>(hist, delta_f, log_tri, path, nf, n, h, floor_c,
                                                                   c_stay, c_sw, lo, hi);
    return cudaGetLastError();
}

}  // namespace

// (h, floor_c): the band of log_tri (see viterbi_fwd_f32 above); [lo, hi]
// its Toeplitz rows (lo = h, hi = n - 1 - h, every one of them carrying
// row lo's window), or lo = -1 where the band has none; cluster forces the
// toeplitz layout's cluster size (0: the rule). The layout, up to
// kMaxThreads targets: the band in registers up to kMaxRegBand sources a
// target in blocks of at most kMaxRegThreads; else staged in shared memory
// when it is narrower than the matrix and fits; else log_tri from L2. Past
// them: toeplitz (the window in shared memory, a cluster an utterance) when
// the band has a window and toe_plan finds a plan; else the wide forward:
// the band staged in shared memory when it is narrower than the matrix and
// fits beside m; else log_tri from L2 with m in shared memory where it fits;
// else m recomputed from the history (kHist). kernels/viterbi.py
// band_layout mirrors the rule.
extern "C" int viterbi_fwd_f32(const float* log_obs, const float* delta0, const float* log_tri,
                               float* hist, float* delta_f, int nb, int nf, int n, int h, float floor_c,
                               float c_stay, float c_sw, int lo, int hi, int cluster, void* stream)
{
    if (nb < 1 || nf < 1 || n < 1 || h < 0 || h >= n) return (int)cudaErrorInvalidValue;
    const bool toeplitz = lo >= 0;
    if (toeplitz && (lo != h || hi != n - 1 - h || lo > hi)) return (int)cudaErrorInvalidValue;
    if (cluster && (!toeplitz || n <= kMaxThreads)) return (int)cudaErrorInvalidValue;
    const int width = 2 * h + 1;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    ToePlan plan;
    if (n > kMaxThreads && toeplitz && toe_plan(n, h, lo, hi, cluster, plan)) {
        err = launch_fwd_toeplitz(plan, log_obs, delta0, log_tri, hist, delta_f, nb, nf, n, h, floor_c, c_stay, c_sw,
                                  lo, hi, s);
    } else if (cluster) {
        return (int)cudaErrorInvalidValue;  // no plan at the forced size
    } else if (n > kMaxThreads) {
        if (width <= n && fwd_wide_smem_bytes(n, h, kShared) <= (size_t)kSmemLimit)
            err = launch_fwd_wide<kShared>(log_obs, delta0, log_tri, hist, delta_f, nb, nf, n, h, floor_c, c_stay, c_sw, s);
        else if (fwd_wide_smem_bytes(n, h, kL2) <= (size_t)kSmemLimit)
            err = launch_fwd_wide<kL2>(log_obs, delta0, log_tri, hist, delta_f, nb, nf, n, h, floor_c, c_stay, c_sw, s);
        else
            err = launch_fwd_wide<kHist>(log_obs, delta0, log_tri, hist, delta_f, nb, nf, n, h, floor_c, c_stay, c_sw, s);
    } else if (width <= kMaxRegBand && n <= kMaxRegThreads) {
        if (width <= 16)
            err = launch_fwd<16, kRegs>(log_obs, delta0, log_tri, hist, delta_f, nb, nf, n, h, floor_c, c_stay, c_sw, s);
        else if (width <= 32)
            err = launch_fwd<32, kRegs>(log_obs, delta0, log_tri, hist, delta_f, nb, nf, n, h, floor_c, c_stay, c_sw, s);
        else if (width <= 48)
            err = launch_fwd<48, kRegs>(log_obs, delta0, log_tri, hist, delta_f, nb, nf, n, h, floor_c, c_stay, c_sw, s);
        else
            err = launch_fwd<64, kRegs>(log_obs, delta0, log_tri, hist, delta_f, nb, nf, n, h, floor_c, c_stay, c_sw, s);
    } else if (width <= n && fwd_smem_bytes(n, h, 0, kShared) <= (size_t)kSmemLimit) {
        err = launch_fwd<0, kShared>(log_obs, delta0, log_tri, hist, delta_f, nb, nf, n, h, floor_c, c_stay, c_sw, s);
    } else {
        err = launch_fwd<0, kL2>(log_obs, delta0, log_tri, hist, delta_f, nb, nf, n, h, floor_c, c_stay, c_sw, s);
    }
    return (int)err;
}

// (h, floor_c): the band of log_tri and [lo, hi] its Toeplitz rows (lo = -1:
// none), as for viterbi_fwd_f32. The layout: past kRingBins bins, the
// window in shared memory when the band has one and it fits (toeplitz);
// else the band staged in shared memory when it fits beside the ring of
// (m, sel) rows (up to kRingBins bins) or beside the C candidates (the wide
// backtrace, past them); else log_tri_t (log_tri transposed, row v =
// log_tri[:, v]) read from L2, and log_tri_t may be null otherwise.
// kernels/viterbi.py backtrace_layout mirrors the rule.
extern "C" int viterbi_bwd_f32(const float* hist, const float* delta_f, const float* log_tri,
                               const float* log_tri_t, int* path, int nb, int nf, int n, int h, float floor_c,
                               float c_stay, float c_sw, int lo, int hi, void* stream)
{
    if (nb < 1 || nf < 1 || n < 1 || h < 0 || h >= n) return (int)cudaErrorInvalidValue;
    const bool toeplitz = lo >= 0;
    if (toeplitz && (lo != h || hi != n - 1 - h || lo > hi)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (n > kRingBins && toeplitz && bwd_toe_smem_bytes(h) <= (size_t)kSmemLimit)
        return (int)launch_bwd_toeplitz(hist, delta_f, log_tri, path, nb, nf, n, h, floor_c, c_stay, c_sw, lo, hi, s);
    if (n > kRingBins) {
        const bool banded = bwd_wide_smem_bytes(n, h, true) <= (size_t)kSmemLimit;
        if (!banded && !log_tri_t) return (int)cudaErrorInvalidValue;
        return (int)(banded ? launch_bwd_wide<true>(hist, delta_f, log_tri, log_tri_t, path, nb, nf, n, h, floor_c,
                                                    c_stay, c_sw, s)
                            : launch_bwd_wide<false>(hist, delta_f, log_tri, log_tri_t, path, nb, nf, n, h, floor_c,
                                                     c_stay, c_sw, s));
    }
    const bool banded = bwd_smem_bytes(n, h, true) <= (size_t)kSmemLimit;
    if (!banded && !log_tri_t) return (int)cudaErrorInvalidValue;
    const int kp = (n + 31) / 32;
    cudaError_t err;
#define VITERBI_BWD(KP) launch_bwd<KP>(hist, delta_f, log_tri, log_tri_t, path, nb, nf, n, h, floor_c, c_stay, c_sw, banded, s)
    if (kp <= 1) err = VITERBI_BWD(1);
    else if (kp <= 2) err = VITERBI_BWD(2);
    else if (kp <= 4) err = VITERBI_BWD(4);
    else if (kp <= 8) err = VITERBI_BWD(8);
    else if (kp <= 12) err = VITERBI_BWD(12);
    else if (kp <= 16) err = VITERBI_BWD(16);
    else if (kp <= 24) err = VITERBI_BWD(24);
    else err = VITERBI_BWD(32);
#undef VITERBI_BWD
    return (int)err;
}
