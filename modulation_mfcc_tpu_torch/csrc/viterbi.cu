// The pyin Viterbi decode for Hopper (sm_90a): the forward max-plus recursion
// and the backtrace. Plain C launchers, loaded with ctypes
// (modulation_mfcc_tpu_torch/kernels/_build.py); each returns the cudaError_t
// of its launch. Only adds, maxes and comparisons: nothing to contract, no
// rounding choices, so both kernels are bit-identical to their plain versions
// in kernels/viterbi.py.
#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int kMaxBins = 1024;     // n; the backtrace keeps n / 32 sources per lane
constexpr int kMaxThreads = 1024;
constexpr int kMaxParts = 8;       // source partitions per target column (forward)
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
// Bound: FP32 adds and maxes, 4 n^2 per step (50 GFLOP at 32 x 30 s of 16 kHz
// audio: n = 361, NF = 3,001), 0.75 ms at the card's 67 TFLOP/s, against
// about 0.55 GB of observations and history. The frame loop is sequential, so
// only B of the 132 SMs work, and log_tri (521 KB at n = 361, more than a
// block's shared memory) is read from L2 at every step.
//
// Design: the TPU's sequential grid over frame chunks becomes a loop inside
// one block per utterance. m lives in shared memory; a thread owns one target
// column v and one of P partitions of the sources, so P x n threads keep
// P x n coalesced L2 reads in flight per step (each read of log_tri[u, v]
// serves both m_v and m_u); the P partial maxima meet in shared memory, where
// the thread that owns column v also forms the next step's m_v[v], m_u[v].
// The TPU's 128-lane padding and -1e30 pads are not needed.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxThreads)
viterbi_fwd_f32_kernel(const float* __restrict__ log_obs, const float* __restrict__ delta0,
                       const float* __restrict__ log_tri, float* __restrict__ hist,
                       float* __restrict__ delta_f, int nf, int n, int parts,
                       float c_stay, float c_sw)
{
    extern __shared__ float smem[];
    const int two_n = 2 * n;
    float* m = smem;               // [2n]: m_v | m_u
    float* part = smem + two_n;    // [parts][2n]: partial maxima

    const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const float* obs = log_obs + (size_t)b * nf * two_n;
    float* hb = hist + (size_t)b * (nf - 1) * two_n;
    float* df = delta_f + (size_t)b * two_n;
    const int chunk = (n + parts - 1) / parts;

    for (int v = tid; v < n; v += nt) {
        const float dv = delta0[(size_t)b * two_n + v], du = delta0[(size_t)b * two_n + n + v];
        if (nf == 1) {
            df[v] = dv;
            df[n + v] = du;
        } else {
            hb[v] = dv;
            hb[n + v] = du;
        }
        m[v] = fmaxf(dv + c_stay, du + c_sw);
        m[n + v] = fmaxf(dv + c_sw, du + c_stay);
    }
    __syncthreads();

    for (int t = 0; t + 1 < nf; ++t) {
        for (int i = tid; i < parts * n; i += nt) {
            const int p = i / n, v = i - p * n;
            const int u1 = min(n, (p + 1) * chunk);
            float av = -INFINITY, au = -INFINITY;
#pragma unroll 4
            for (int u = p * chunk; u < u1; ++u) {
                const float w = __ldg(log_tri + (size_t)u * n + v);
                av = fmaxf(av, m[u] + w);
                au = fmaxf(au, m[n + u] + w);
            }
            part[p * two_n + v] = av;
            part[p * two_n + n + v] = au;
        }
        __syncthreads();

        const float* lo = obs + (size_t)(t + 1) * two_n;
        const bool last = t + 2 == nf;
        for (int v = tid; v < n; v += nt) {
            float av = part[v], au = part[n + v];
            for (int p = 1; p < parts; ++p) {
                av = fmaxf(av, part[p * two_n + v]);
                au = fmaxf(au, part[p * two_n + n + v]);
            }
            const float dv = av + lo[v], du = au + lo[n + v];
            if (last) {
                df[v] = dv;
                df[n + v] = du;
            } else {
                float* row = hb + (size_t)(t + 1) * two_n;
                row[v] = dv;
                row[n + v] = du;
                m[v] = fmaxf(dv + c_stay, du + c_sw);
                m[n + v] = fmaxf(dv + c_sw, du + c_stay);
            }
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// viterbi_bwd_f32
//
// Replaces the Pallas kernels of modulation_mfcc_tpu/pallas/viterbi.py:
// viterbi_decode_pallas -> _bwd_kernel and viterbi_decode_batched ->
// _bwd_kernel_b.
//
// For utterance b (one warp): path[NF-1] = first argmax of delta_f[b]; then
// for t = NF-2 .. 0, with nxt = path[t+1], d = hist[b, t], pos = nxt mod n:
//   (a, c) = nxt < n ? (c_stay, c_sw) : (c_sw, c_stay)
//   score[u] = max(d[u] + a, d[n+u] + c) + log_tri[u, pos]
//   base     = first argmax of score (the lower index wins equal values)
//   path[t]  = base + n * (d[n+base] + c > d[base] + a)   (voiced wins ties)
//
// Bound: the one read of the history (277 MB at 32 x 30 s of 16 kHz audio),
// 0.08 ms at 3.35 TB/s. The steps depend on each other through pos, so the
// kernel is bound by latency instead: each step waits for one row of log_tri
// from L2 and a five-step shuffle reduction.
//
// Design: lane l holds sources l, l+32, ... in registers (KP of them), and
// the history row of the next step is loaded while this step reduces, so only
// the read of log_tri[:, pos] (given transposed: one contiguous row) waits on
// the previous step. The (value, index, source block) triple is reduced by
// xor shuffles under the order (value descending, index ascending), which is
// jnp.argmax's first-maximum rule.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void first_max(float& val, int& idx, int& sel)
{
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, val, off);
        const int oi = __shfl_xor_sync(kFull, idx, off);
        const int os = __shfl_xor_sync(kFull, sel, off);
        if (ov > val || (ov == val && oi < idx)) {
            val = ov;
            idx = oi;
            sel = os;
        }
    }
}

template <int KP>
__global__ void __launch_bounds__(32)
viterbi_bwd_f32_kernel(const float* __restrict__ hist, const float* __restrict__ delta_f,
                       const float* __restrict__ log_tri_t, int* __restrict__ path,
                       int nf, int n, float c_stay, float c_sw)
{
    const int b = blockIdx.x, lane = threadIdx.x;
    const int two_n = 2 * n;
    const float* hb = hist + (size_t)b * (nf - 1) * two_n;
    int* pb = path + (size_t)b * nf;

    // last state: first argmax of delta_f over all 2n states
    const float* df = delta_f + (size_t)b * two_n;
    float best = -INFINITY;
    int bi = INT_MAX, unused = 0;
    for (int i = lane; i < two_n; i += 32) {
        const float x = df[i];
        if (x > best || bi == INT_MAX) {
            best = x;
            bi = i;
        }
    }
    first_max(best, bi, unused);
    int nxt = bi;
    if (lane == 0) pb[nf - 1] = nxt;

    float cur_v[KP], cur_u[KP];
    if (nf >= 2) {
        const float* row = hb + (size_t)(nf - 2) * two_n;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
            const int u = lane + 32 * k;
            cur_v[k] = u < n ? row[u] : 0.0f;
            cur_u[k] = u < n ? row[n + u] : 0.0f;
        }
    }
    for (int t = nf - 2; t >= 0; --t) {
        float nxt_v[KP], nxt_u[KP];
        const float* prow = hb + (size_t)(t > 0 ? t - 1 : 0) * two_n;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
            const int u = lane + 32 * k;
            nxt_v[k] = (t > 0 && u < n) ? prow[u] : 0.0f;
            nxt_u[k] = (t > 0 && u < n) ? prow[n + u] : 0.0f;
        }

        const bool voiced = nxt < n;
        const int pos = voiced ? nxt : nxt - n;
        const float a = voiced ? c_stay : c_sw, c = voiced ? c_sw : c_stay;
        const float* col = log_tri_t + (size_t)pos * n;
        float val = -INFINITY;
        int idx = INT_MAX, sel = 0;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
            const int u = lane + 32 * k;
            if (u < n) {
                const float from_v = cur_v[k] + a, from_u = cur_u[k] + c;
                const float score = fmaxf(from_v, from_u) + col[u];
                if (score > val || idx == INT_MAX) {
                    val = score;
                    idx = u;
                    sel = from_u > from_v;
                }
            }
        }
        first_max(val, idx, sel);
        nxt = idx + n * sel;
        if (lane == 0) pb[t] = nxt;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
            cur_v[k] = nxt_v[k];
            cur_u[k] = nxt_u[k];
        }
    }
}

template <int KP>
cudaError_t launch_bwd(const float* hist, const float* delta_f, const float* log_tri_t, int* path,
                       int nb, int nf, int n, float c_stay, float c_sw, cudaStream_t stream)
{
    viterbi_bwd_f32_kernel<KP><<<nb, 32, 0, stream>>>(hist, delta_f, log_tri_t, path, nf, n, c_stay, c_sw);
    return cudaGetLastError();
}

}  // namespace

extern "C" int viterbi_fwd_f32(const float* log_obs, const float* delta0, const float* log_tri,
                               float* hist, float* delta_f, int nb, int nf, int n,
                               float c_stay, float c_sw, void* stream)
{
    if (nb < 1 || nf < 1 || n < 1 || n > kMaxBins) return (int)cudaErrorInvalidValue;
    const int parts = max(1, min(kMaxParts, kMaxThreads / n));
    const int threads = min(kMaxThreads, (parts * n + 31) / 32 * 32);
    const size_t smem = sizeof(float) * (size_t)2 * n * (1 + parts);
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    viterbi_fwd_f32_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
        log_obs, delta0, log_tri, hist, delta_f, nf, n, parts, c_stay, c_sw);
    return (int)cudaGetLastError();
}

extern "C" int viterbi_bwd_f32(const float* hist, const float* delta_f, const float* log_tri_t,
                               int* path, int nb, int nf, int n, float c_stay, float c_sw,
                               void* stream)
{
    if (nb < 1 || nf < 1 || n < 1 || n > kMaxBins) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int kp = (n + 31) / 32;
    cudaError_t err;
    if (kp <= 1) err = launch_bwd<1>(hist, delta_f, log_tri_t, path, nb, nf, n, c_stay, c_sw, s);
    else if (kp <= 2) err = launch_bwd<2>(hist, delta_f, log_tri_t, path, nb, nf, n, c_stay, c_sw, s);
    else if (kp <= 4) err = launch_bwd<4>(hist, delta_f, log_tri_t, path, nb, nf, n, c_stay, c_sw, s);
    else if (kp <= 8) err = launch_bwd<8>(hist, delta_f, log_tri_t, path, nb, nf, n, c_stay, c_sw, s);
    else if (kp <= 12) err = launch_bwd<12>(hist, delta_f, log_tri_t, path, nb, nf, n, c_stay, c_sw, s);
    else if (kp <= 16) err = launch_bwd<16>(hist, delta_f, log_tri_t, path, nb, nf, n, c_stay, c_sw, s);
    else if (kp <= 24) err = launch_bwd<24>(hist, delta_f, log_tri_t, path, nb, nf, n, c_stay, c_sw, s);
    else err = launch_bwd<32>(hist, delta_f, log_tri_t, path, nb, nf, n, c_stay, c_sw, s);
    return (int)err;
}
