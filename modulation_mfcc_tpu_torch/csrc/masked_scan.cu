// Length-masked zero-phase Butterworth for Hopper (sm_90a): the scan route's
// trajectory filters. Plain C launcher, loaded with ctypes
// (modulation_mfcc_tpu_torch/kernels/_build.py); it returns the cudaError_t
// of its launch. FP64 without contraction: every product and sum is one
// __dmul_rn / __dadd_rn / __dsub_rn, as the plain version's separate torch
// ops round them.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// masked_sosfiltfilt_f64
//
// For every row r of float32 rows (row r of utterance u = r / rows_per_utt,
// its valid length L = lengths[u] samples of a buffer of T), what the plain
// version (kernels/masked_scan.py: ops/masked.masked_sosfiltfilt on the rows
// in float64, rounded to float32 once) computes:
//
//  * the odd extension around [0, L) by p = padlen samples
//    (ops/masked.masked_odd_ext): ext[e] = 2 x[0] - x[min(p - e, T - 1)] for
//    e < p; x[e - p] for p <= e < L + p; 2 x[min(L - 1, T - 1)] - x[L - 2 -
//    (e - L - p)] (0 for an index outside [0, T)) for L + p <= e < L + 2p;
//  * the forward cascade of the SOS sections over ext[0 .. L + 2p), each
//    section's state started at zi * ext[0] (direct form II transposed:
//    y = b0 u + z0; z0 = (b1 u - a1 y) + z1; z1 = b2 u - a2 y);
//  * the backward cascade over yr[j] = y[L + 2p - 1 - j], its state started
//    at zi * yr[0]; out[i] = yr's output at j = L + p - 1 - i for i < L,
//    rounded once to float32; 0 for L <= i < T.
//
// Each section's recursion reads only its own input sequence, so the order
// in which the sections take their samples leaves the arithmetic as it is:
// the output equals the plain version's bit for bit
// (tests/test_torch_masked_scan.py on the card).
//
// Bound: latency, then the scratch's bytes. The recursion is serial in
// time: a step of a section is four dependent FP64 operations (add,
// multiply, subtract, add) from one state to the next, and a row walks
// L + 2p samples forward and L + p back. At the scan route's sizes (12
// trajectories of each of a batch's utterances, 200-820 frames) the card
// holds at most a warp or two a sub-partition, so a launch takes about one
// row's chain, whatever the number of rows; the forward outputs, float64,
// are written and read once (85 MB at 12,288 rows of 820 frames).
//
// Design: a thread a row, a warp 32 rows, each warp on its own:
//  * the sections as a pipeline: at step t section k takes its input of
//    step t - k (section k - 1's output of the step before), so a step
//    holds NS independent section updates, and its chain is one section's
//    four operations, not NS sections' (a first design that passed each
//    sample through every section in turn, each step a branch of its own,
//    took 0.24 ms at 12,288 rows of 820 frames on the H100, ~280 cycles a
//    step); the pass runs NS - 1 steps past its last input, and only the
//    first chunk's first NS - 1 steps hold a section back (a select);
//  * nothing of long latency inside the chain: every input reaches shared
//    memory by cp.async, a chunk of 16 steps ahead, in a double buffer, so
//    no prefetch lives in registers for the compiler to sink next to its use
//    (the card issues a warp's instructions in order: a load or a conversion
//    between two steps stalls the chain behind it); a chunk's 16 inputs are
//    read and widened to FP64 before its steps, its 16 outputs narrowed and
//    staged after them. Register prefetches with a branch a load took ~280
//    cycles a forward step, ~195 a backward one, against ~90 for the steps
//    alone (24 FP64 operations a step at a warp's FP64 issue, 2.3 cycles an
//    instruction on the H100);
//  * input: the valid samples in tiles of 16 steps of the warp's 32 rows,
//    copied coalesced (a half-warp a row, 64 bytes); the odd extension's 2p
//    edge samples computed first into the scratch, where the forward pass
//    copies them from (a zero-filled copy elsewhere);
//  * the forward output in a float64 scratch laid out [warp][e][32 lanes],
//    so a forward step's 32 stores are one coalesced 256-byte row; the
//    backward pass copies it in reverse, 16 steps ahead of the one computed;
//  * output: 16 steps of the warp's rows through shared memory, then stored
//    a half-warp a row (consecutive addresses, descending in time); the
//    zeros past each length stored a warp a row;
//  * only each row's L + 2p and L + p steps do work, the warp's loops run
//    to its longest row (rows of a bucketed batch differ little).
// ---------------------------------------------------------------------------

constexpr int kMaxSections = 8;  // a Butterworth up to order 16 (band-pass 8)
constexpr int kWarps = 2;        // warps a block
constexpr int kChunk = 16;       // steps a tile and a prefetch
constexpr int kPitch = kChunk + 1;
constexpr unsigned kFull = 0xffffffffu;

struct Sos {
    double b0[kMaxSections], b1[kMaxSections], b2[kMaxSections], a1[kMaxSections], a2[kMaxSections];
    double zi0[kMaxSections], zi1[kMaxSections];
};

// the sections' states and the inputs waiting between them (v[k]: section
// k's input at the next step; v[0] unused)
template <int NS>
struct Cascade {
    double z0[NS], z1[NS], v[NS];
};

template <int NS>
__device__ __forceinline__ void start(Cascade<NS>& c, const Sos& s, double u0)
{
#pragma unroll
    for (int k = 0; k < NS; ++k) {
        c.z0[k] = __dmul_rn(s.zi0[k], u0);
        c.z1[k] = __dmul_rn(s.zi1[k], u0);
        c.v[k] = 0.0;
    }
}

// step i of a chunk of a pass, u its input: section k takes the input of
// step i - k (NS - 1 steps past the pass's last input, the last section's
// output is that input's). In the pass's first chunk (first) section k
// waits for its first input until step k; past the pass's end a section
// goes on with inputs no stored output reads, so no step after the first
// chunk tests anything. Direct form II transposed: y = b0 u + z0;
// z0 = (b1 u - a1 y) + z1; z1 = b2 u - a2 y.
template <int NS>
__device__ __forceinline__ double step(Cascade<NS>& c, double u, int i, bool first, const Sos& s)
{
    double y[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
        const double in = k == 0 ? u : c.v[k];
        y[k] = __dadd_rn(__dmul_rn(s.b0[k], in), c.z0[k]);
        const double z0 = __dadd_rn(__dsub_rn(__dmul_rn(s.b1[k], in), __dmul_rn(s.a1[k], y[k])), c.z1[k]);
        const double z1 = __dsub_rn(__dmul_rn(s.b2[k], in), __dmul_rn(s.a2[k], y[k]));
        const bool on = i >= k || !first;  // i >= k is known at compile time in an unrolled chunk
        c.z0[k] = on ? z0 : c.z0[k];
        c.z1[k] = on ? z1 : c.z1[k];
    }
#pragma unroll
    for (int k = NS - 1; k > 0; --k) c.v[k] = y[k - 1];
    return y[NS - 1];
}

// cp.async of 4 or 8 bytes into shared memory, zero-filled where !pred (gmem
// must still be a valid address); commit_group / wait_group as in PTX
template <int BYTES>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem, bool pred)
{
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem), "n"(BYTES),
                 "r"(pred ? BYTES : 0));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// the forward pass's chunk from step e0: the tile of samples n = e0 - p +
// col of the warp's rows 2 it + h (lane (h, col)), and this lane's edge
// inputs e0 .. e0 + 15 from the scratch (zeros at the other steps)
__device__ __forceinline__ void copy_forward(float (*tile)[kPitch], double (*edge)[32], const float* x, long long off,
                                             long long row0, int rows, int T, const double* sc, bool live, int p,
                                             int L, int e0, int h, int col, int lane)
{
#pragma unroll
    for (int it = 0; it < kChunk; ++it) {
        const int q = 2 * it + h, n = e0 - p + col;
        const long long oq = __shfl_sync(kFull, off, q);
        const bool in = row0 + q < rows && (unsigned)n < (unsigned)T;
        copy_async<4>(&tile[q][col], x + (in ? oq + n : oq), in);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
        const int e = e0 + i;
        const bool in = live & (((unsigned)e < (unsigned)p) | ((unsigned)(e - L - p) < (unsigned)p));
        copy_async<8>(&edge[i][lane], sc + (in ? 32 * e : 0), in);
    }
    copy_commit();
}

// the backward pass's chunk from step j0: yr[j] = y[last - j] for j < n (zeros past it)
__device__ __forceinline__ void copy_back(double (*buf)[32], const double* sc, bool live, int last, int n, int j0,
                                          int lane)
{
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
        const bool in = live && j0 + i < n;
        copy_async<8>(&buf[i][lane], sc + (in ? 32 * (last - j0 - i) : 0), in);
    }
    copy_commit();
}

template <int NS>
__global__ void __launch_bounds__(kWarps * 32, 1)
masked_sosfiltfilt_f64_kernel(const float* __restrict__ x, long long utt_stride, long long row_stride,
                              int rows_per_utt, int rows, int T, const long long* __restrict__ lengths,
                              const Sos s, int p, double* __restrict__ scratch, float* __restrict__ out)
{
    __shared__ float tile_in[kWarps][2][32][kPitch];   // the forward pass's samples, double-buffered
    __shared__ double stage[kWarps][2][kChunk][32];    // its edge inputs, then the backward pass's inputs
    __shared__ float tile_out[kWarps][32][kPitch];
    __shared__ int len_of[kWarps][32];                 // each row's length, for the stores a half-warp a row
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long row0 = ((long long)blockIdx.x * kWarps + w) * 32;
    if (row0 >= rows) return;  // the whole warp
    const long long row = row0 + lane;
    const bool live = row < rows;
    int L = 0;
    long long off = 0;  // this row's first sample in x
    if (live) {
        const long long u = row / rows_per_utt;
        L = (int)min(max(lengths[u], 0LL), (long long)T);
        off = u * utt_stride + (row - u * rows_per_utt) * row_stride;
    }
    const float* xr = x + off;
    double* sc = scratch + (row0 >> 5) * ((long long)T + 2 * p) * 32 + lane;  // step e at sc[32 e]
    const int l_max = __reduce_max_sync(kFull, L);
    const int h = lane >> 4, col = lane & 15;  // a half-warp a row in the coalesced tiles
    const int E = L + 2 * p;                   // the forward pass's inputs

    // ---- the odd extension's edges into the scratch: e < p, and L + p <= e < L + 2p
    const double x0 = live ? (double)xr[0] : 0.0;
    const double two_x0 = __dmul_rn(2.0, x0);
    const double two_xe = __dmul_rn(2.0, live ? (double)xr[min(max(L - 1, 0), T - 1)] : 0.0);
    if (live) {
#pragma unroll 4
        for (int k = 0; k < p; ++k) {
            const int idx = L - 2 - k;
            sc[32 * k] = __dsub_rn(two_x0, (double)xr[min(p - k, T - 1)]);
            sc[32 * (L + p + k)] = __dsub_rn(two_xe, idx >= 0 ? (double)xr[idx] : 0.0);
        }
    }
    __threadfence_block();  // the edges written before the copies that read them

    // ---- forward: steps e < E (+ NS - 1), its output y[e] written over the scratch
    Cascade<NS> c;
    start<NS>(c, s, p > 0 ? (live ? sc[0] : 0.0) : (L > 0 ? x0 : 0.0));
    const int fwd_steps = l_max + 2 * p + NS - 1;
    copy_forward(tile_in[w][0], stage[w][0], x, off, row0, rows, T, sc, live, p, L, 0, h, col, lane);
    for (int e0 = 0, b = 0; e0 < fwd_steps; e0 += kChunk, b ^= 1) {
        copy_wait_all();
        __syncwarp();
        if (e0 + kChunk < fwd_steps)
            copy_forward(tile_in[w][b ^ 1], stage[w][b ^ 1], x, off, row0, rows, T, sc, live, p, L, e0 + kChunk, h,
                         col, lane);
        double u[kChunk];  // the chunk's inputs, read and widened before its chain starts
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
            u[i] = (unsigned)(e0 + i - p) < (unsigned)L ? (double)tile_in[w][b][lane][i] : stage[w][b][i][lane];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
            const double y = step<NS>(c, u[i], i, e0 == 0, s);
            const int e_out = e0 + i - (NS - 1);
            if (live && (unsigned)e_out < (unsigned)E) sc[32 * e_out] = y;
        }
    }
    copy_wait_all();
    __threadfence_block();  // the forward outputs written before the copies that read them
    __syncwarp();

    // ---- backward: yr[j] = y[L + 2p - 1 - j] for j < L + p; out[L + p - 1 - j] for j >= p
    const int last = E - 1;  // yr[0]'s index
    const int n_back = L + p, back_steps = l_max + p + NS - 1;
    start<NS>(c, s, live && last >= 0 ? sc[32 * last] : 0.0);
    len_of[w][lane] = L;  // 0 past the last row
    copy_back(stage[w][0], sc, live, last, n_back, 0, lane);
    for (int j0 = 0, b = 0; j0 < back_steps; j0 += kChunk, b ^= 1) {
        copy_wait_all();
        __syncwarp();
        if (j0 + kChunk < back_steps) copy_back(stage[w][b ^ 1], sc, live, last, n_back, j0 + kChunk, lane);
        double u[kChunk], y[kChunk];  // the chunk's inputs; its outputs, narrowed and staged after its chain
#pragma unroll
        for (int i = 0; i < kChunk; ++i) u[i] = stage[w][b][i][lane];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) y[i] = step<NS>(c, u[i], i, j0 == 0, s);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) tile_out[w][lane][i] = __double2float_rn(y[i]);
        __syncwarp();
        const int j = j0 + col - (NS - 1);
#pragma unroll
        for (int it = 0; it < kChunk; ++it) {
            const int q = 2 * it + h, lq = len_of[w][q];
            if (j >= p && j < lq + p) out[(row0 + q) * T + (lq + p - 1 - j)] = tile_out[w][q][col];
        }
        __syncwarp();
    }

    // ---- zeros at and past each length
    for (int q = 0; q < 32; ++q) {
        const int lz = __shfl_sync(kFull, L, q);
        if (row0 + q < rows) {
            for (int i = lz + lane; i < T; i += 32) out[(row0 + q) * T + i] = 0.0f;
        }
    }
}

// ---------------------------------------------------------------------------
// masked_grad_norm_f32
//
// The scan route's next stage, for every utterance b and frame t < L:
// tot[b, t] = sqrt(sum_c g_c(t)^2) / C over its C trajectories, g the
// masked gradient of ops/masked.masked_gradient (np.gradient, edge_order 1,
// at the true end L): x[1] - x[0] at t = 0, x[L - 1] - x[L - 2] at t = L - 1,
// (x[t + 1] - x[t - 1]) / 2 between; 0 for L <= t < T. Every operation in
// FP32 rounded on its own as the plain version's torch ops round it, the sum
// over c in increasing c. A thread a frame, a block 256 frames of one
// utterance: the C reads of a frame are coalesced across the block. Bound:
// bytes (C + 1 floats a frame), one launch where the plain version takes
// about 40 small ones and ~1 ms of the host's dispatch.
// ---------------------------------------------------------------------------

constexpr int kNormThreads = 256;

__global__ void __launch_bounds__(kNormThreads)
masked_grad_norm_f32_kernel(const float* __restrict__ x, long long utt_stride, long long row_stride, int C, int T,
                            const long long* __restrict__ lengths, float* __restrict__ out)
{
    const int t = blockIdx.x * kNormThreads + threadIdx.x;
    const long long b = blockIdx.y;
    if (t >= T) return;
    const int L = (int)min(max(lengths[b], 0LL), (long long)T);
    float r = 0.0f;
    if (t < L) {
        // the two samples the gradient differences, and whether it halves them
        const bool first = t == 0, last = t == L - 1;
        const int hi = first ? 1 : last ? L - 1 : min(t + 1, T - 1);
        const int lo = first ? 0 : last ? max(L - 2, 0) : t - 1;
        const bool central = !first && !last;
        const float* xb = x + b * utt_stride;
        float acc = 0.0f;
        for (int c = 0; c < C; ++c) {
            const float* xc = xb + c * row_stride;
            float g = __fsub_rn(xc[hi], xc[lo]);
            if (central) g = __fdiv_rn(g, 2.0f);
            acc = __fadd_rn(acc, __fmul_rn(g, g));
        }
        r = __fdiv_rn(__fsqrt_rn(acc), (float)C);
    }
    out[b * T + t] = r;
}

// float64 elements of the scratch: a warp's 32 rows of T + 2 padlen samples
long long scratch_needed(int rows, int T, int padlen)
{
    return ((long long)rows + 31) / 32 * 32 * ((long long)T + 2LL * padlen);
}

template <int NS>
int launch(const float* x, long long utt_stride, long long row_stride, int rows_per_utt, int rows, int T,
           const long long* lengths, const Sos& s, int padlen, double* scratch, float* out, cudaStream_t stream)
{
    const long long n_blocks = ((long long)rows + kWarps * 32 - 1) / (kWarps * 32);
    masked_sosfiltfilt_f64_kernel<NS><<<(unsigned)n_blocks, kWarps * 32, 0, stream>>>(
        x, utt_stride, row_stride, rows_per_utt, rows, T, lengths, s, padlen, scratch, out);
    return (int)cudaGetLastError();
}

}  // namespace

// x: row r of utterance u = r / rows_per_utt starts at x + u * utt_stride +
// (r mod rows_per_utt) * row_stride (samples contiguous); lengths: int64 [n_utt];
// sos [n_sections][6] and zi [n_sections][2]: float64 on the host; out: float32
// [rows, T] contiguous.
extern "C" int masked_sosfiltfilt_f64(const float* x, long long utt_stride, long long row_stride, int rows_per_utt,
                                      int rows, int T, const long long* lengths, const double* sos, const double* zi,
                                      int n_sections, int padlen, double* scratch, long long scratch_elems,
                                      float* out, void* stream)
{
    if (!x || !lengths || !sos || !zi || !scratch || !out || rows < 1 || T < 1 || rows_per_utt < 1 || padlen < 0 ||
        n_sections < 1 || n_sections > kMaxSections || scratch_elems < scratch_needed(rows, T, padlen))
        return (int)cudaErrorInvalidValue;
    Sos s = {};
    for (int k = 0; k < n_sections; ++k) {
        s.b0[k] = sos[6 * k];
        s.b1[k] = sos[6 * k + 1];
        s.b2[k] = sos[6 * k + 2];
        s.a1[k] = sos[6 * k + 4];
        s.a2[k] = sos[6 * k + 5];
        s.zi0[k] = zi[2 * k];
        s.zi1[k] = zi[2 * k + 1];
    }
    const cudaStream_t st = (cudaStream_t)stream;
    switch (n_sections) {
    case 1: return launch<1>(x, utt_stride, row_stride, rows_per_utt, rows, T, lengths, s, padlen, scratch, out, st);
    case 2: return launch<2>(x, utt_stride, row_stride, rows_per_utt, rows, T, lengths, s, padlen, scratch, out, st);
    case 3: return launch<3>(x, utt_stride, row_stride, rows_per_utt, rows, T, lengths, s, padlen, scratch, out, st);
    case 4: return launch<4>(x, utt_stride, row_stride, rows_per_utt, rows, T, lengths, s, padlen, scratch, out, st);
    case 5: return launch<5>(x, utt_stride, row_stride, rows_per_utt, rows, T, lengths, s, padlen, scratch, out, st);
    case 6: return launch<6>(x, utt_stride, row_stride, rows_per_utt, rows, T, lengths, s, padlen, scratch, out, st);
    case 7: return launch<7>(x, utt_stride, row_stride, rows_per_utt, rows, T, lengths, s, padlen, scratch, out, st);
    case 8: return launch<8>(x, utt_stride, row_stride, rows_per_utt, rows, T, lengths, s, padlen, scratch, out, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

// x: trajectory c of utterance b at x + b * utt_stride + c * row_stride (frames
// contiguous, T >= 2); lengths: int64 [B]; out: float32 [B, T] contiguous.
extern "C" int masked_grad_norm_f32(const float* x, long long utt_stride, long long row_stride, int C, int B, int T,
                                    const long long* lengths, float* out, void* stream)
{
    if (!x || !lengths || !out || C < 1 || B < 1 || B > 65535 || T < 2) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((T + kNormThreads - 1) / kNormThreads), (unsigned)B);
    masked_grad_norm_f32_kernel<<<grid, kNormThreads, 0, (cudaStream_t)stream>>>(x, utt_stride, row_stride, C, T,
                                                                                  lengths, out);
    return (int)cudaGetLastError();
}
