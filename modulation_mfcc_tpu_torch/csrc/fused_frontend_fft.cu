// Fused MFCC frontend for Hopper (sm_90a) on the CUDA cores, with FFT
// structure: audio -> mel power, the 'f32' mode's CUDA route wherever
// kernels/fused_frontend.fft_ok takes the geometry. Plain C launcher, loaded
// with ctypes (modulation_mfcc_tpu_torch/kernels/_build.py); it returns the
// cudaError_t of its launch. No fast-math intrinsics: every product and sum
// is one __dmul_rn / __dadd_rn / __dsub_rn (FP64) or __fmul_rn / __fadd_rn
// (FP32), so nothing is contracted.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// fused_mel_fft_f32
//
// Replaces, with fused_mel_f32 (fused_frontend_tc.cu), the Pallas frontend of
// modulation_mfcc_tpu/pallas/fused_frontend.py (fused_mel_frontend -> _launch
// -> _kernel and _kernel_pipe) with algorithm 'f32': for every utterance b and
// frame f < nf, the same centred frame (zero outside the buffer of T samples;
// int16 dequantised as v * 2^-15, exact; float32 flat or hop rows), the
// window, the DFT's re and im on every live bin, power = re^2 + im^2, mel over
// the same packed weights (kernels/fused_frontend.frontend_weights' melw,
// bit-identical to JAX's constants), and per block of 64 frames the maximum
// of mel over its valid frames. It computes them with an FFT:
//
//  * the n_fft = 2M point real FFT as the M-point complex FFT of
//    z[m] = (x[2m] w[2m], x[2m+1] w[2m+1]) (the window multiplied in as the
//    samples are read from the block's span), then the split post-pass
//    X[k] = E + W_N^k O, E = (Z[k] + conj Z[M-k]) / 2,
//    O = -i (Z[k] - conj Z[M-k]) / 2, on the live bins only;
//  * the M-point FFT in Stockham passes (kernels/fused_frontend.fft_radices:
//    radix 16, then 16, then 2, 4 or 8): M / 16 threads a frame, 16 complex
//    points a thread in registers each pass, one exchange through shared
//    memory between passes (256 points: radix 16 x 16, one exchange). A pass
//    of radix R with Ns points already transformed: butterfly j reads points
//    j + q M / R, multiplies point q by W_M^(q (j mod Ns) M / (Ns R)), takes
//    their R-point DFT (radix-2 decimation in frequency in registers;
//    twiddles 1 and -i exact, the others read from the table) and writes
//    output k to (j / Ns) Ns R + j mod Ns + k Ns, so the result lands in
//    natural order;
//  * the mel as a sparse FP32 sum: each band's weights over its bins, from
//    its first nonzero bin to its last, in increasing bin order, from zero
//    (each bin lies in at most two triangles, so a frame takes about two
//    products a live bin where the dense projection took n_mels).
//
// Precision. The window, the FFT, the post-pass and the power run in FP64
// from float64 constants (window, twiddles W_M^k and W_N^k computed in
// float64 on the host, never rounded to float32: kernels/fused_frontend.
// fft_weights); the power is rounded once to float32, and the mel, a sum of
// positive terms, is summed in FP32. An FP32 FFT (float32 twiddles and
// butterflies) rounds each output by ~eps of its frame's energy, so at mel
// entries 80 dB under the peak it lands ~3e-4 from the float64 function,
// twice the stepped FP32 DFT (fused_mel_frontend_reference); in FP64 the
// kernel is the float64 function to the power's and the mel sum's float32
// rounding (PERF.md section 6). The plain mirror
// (kernels/fused_frontend.fft_frontend_mirror) runs the same operations in
// the same order and precision in PyTorch, so the kernel's mel and block
// maxima equal it bit for bit (tests/test_torch_frontend_fft.py on the card).
//
// Bound: FP64 issue. The function's least work (benchmark/roofline/
// frontend.py) is about 13 k flops a frame at n_fft 512, ~10 GFLOP over a
// 128 x 30 s batch at 16 kHz (0.3 ms at 67 TFLOP/s of FP32; its bytes, the
// audio read and the mel written once, 0.19 ms at 3.35 TB/s); the FFT's
// ~11 k of them run on the FP64 units, at half the FP32 rate and without
// FMA contraction, beside the shared-memory traffic of the exchanges, so the
// card's FP64 and shared-memory issue rate, not its bytes, sets the pace.
//
// Design: a block owns 64 consecutive frames of one utterance (the tensor-core
// kernel's tile, so the block-maximum contract holds) and all its bands.
// Its 256 threads stage the tile's audio span once (63 hop + n_fft samples,
// float32, every frame's n_fft points) in shared memory, then take the frames
// in rounds of 4096 / M (16 at n_fft 512): the FFT in a frame's exchange rows
// (double2; a warp holds a frame up to n_fft 1024, so its passes meet at warp
// barriers); the post-pass, bins k and M - k from the same two points
// (for M - k, E and O are k's conjugates, exactly but for the sign of a
// zero, which the square drops; W_N^(M-k) = (-W.re, W.im) by the table's
// construction); the power of the live bins into a float32 row of shared
// memory; the mel of the round's frames (a thread a frame and band, threads
// along frames, so a warp reads one band's weights and bins) staged in groups
// of 128 bands in the exchange's space and written as whole rows. The
// constants (window, twiddles, band table, weights: a few KB) stay in device
// memory and are read through the L1 cache, so at n_fft 512 a block takes
// 106 KB of shared memory (16 kHz; 98 KB at 10 kHz) and two blocks fit an
// SM, 16 warps. Nothing intermediate goes to device memory: no frame matrix,
// no spectrum, no scratch tensor. The tensor-core kernel keeps every other
// geometry (a non-power-of-two n_fft, a span past shared memory: the long
// hops) and the bf16, x3, i16 and i24 modes.
// ---------------------------------------------------------------------------

constexpr int kFftThreads = 256;            // threads a block (8 warps)
constexpr int kFftRadix = 16;               // points a thread holds in each pass
constexpr int kBF = 64;                     // frames a block: one block maximum (kBF in fused_frontend_tc.cu)
constexpr int kFftMelCols = 128;            // mel columns staged at a time
constexpr int kMelLimit = 512;              // mel bands the frontends take
constexpr int kFftMinLog = 7;               // M = n_fft / 2 from 2^7 = 128 ...
constexpr int kFftMaxLog = 10;              // ... to 2^10 = 1024
constexpr int kSharedMax = 232448;          // bytes of shared memory a block may use

__device__ __forceinline__ float load_sample(const float* x, long long s) { return x[s]; }
__device__ __forceinline__ float load_sample(const int16_t* x, long long s)
{
    return static_cast<float>(x[s]) * (1.0f / 32768.0f);  // exact
}

__device__ __forceinline__ double2 cadd(double2 a, double2 b)
{
    return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}
__device__ __forceinline__ double2 csub(double2 a, double2 b)
{
    return make_double2(__dsub_rn(a.x, b.x), __dsub_rn(a.y, b.y));
}

// a·w: four products, then a difference and a sum
__device__ __forceinline__ double2 cmul(double2 a, double2 w)
{
    return make_double2(__dsub_rn(__dmul_rn(a.x, w.x), __dmul_rn(a.y, w.y)),
                        __dadd_rn(__dmul_rn(a.x, w.y), __dmul_rn(a.y, w.x)));
}

// a frame's point i in the exchange: one double2 of padding every 16, so the
// first pass's writes (16 apart) meet no bank twice in a quarter warp
__device__ __forceinline__ int xpad(int i) { return i + (i >> 4); }

__host__ __device__ constexpr int bitrev(int k, int r)
{
    int out = 0;
    for (int b = 1; b < r; b <<= 1) {
        out = (out << 1) | (k & 1);
        k >>= 1;
    }
    return out;
}

// The R-point DFT of v in registers, radix-2 decimation in frequency, from
// the stage of butterflies H apart down to 1 apart; the outputs in
// bit-reversed order (v[bitrev(k)] holds X[k]). tw[e * step] is W_R^e (the
// table of W_M, step = M / R).
template <int R, int H = R / 2>
__device__ __forceinline__ void dft_dif(double2 (&v)[R], const double2* tw, int step)
{
#pragma unroll
    for (int b = 0; b < R; b += 2 * H)
#pragma unroll
        for (int k = 0; k < H; ++k) {
            const double2 a = v[b + k], c = v[b + k + H];
            const double2 d = csub(a, c);
            v[b + k] = cadd(a, c);
            const int e = k * (R / (2 * H));  // W_2H^k = W_R^e
            if (e == 0)
                v[b + k + H] = d;
            else if (4 * e == R)
                v[b + k + H] = make_double2(d.y, -d.x);  // times -i
            else
                v[b + k + H] = cmul(d, __ldg(tw + e * step));
        }
    if constexpr (H > 1) dft_dif<R, H / 2>(v, tw, step);
}

// a frame's threads meet: one warp holds a frame up to M = 512
template <int M>
__device__ __forceinline__ void frame_sync()
{
    if constexpr (M / kFftRadix <= 32)
        __syncwarp();
    else
        __syncthreads();
}

// one Stockham pass of radix R over a frame's M points in the exchange xf,
// NS > 1 points already transformed; thread t of the frame takes 16 / R
// butterflies, j = t + (M / 16) q. The twiddle of point r is W_M^e,
// e = r (j mod NS) M / (NS R): from t1[16 r + j mod 16] in the second pass
// (NS = 16: the same values laid out so a half warp reads 16 consecutive),
// from the table of W_M after it.
template <int M, int R, int NS>
__device__ __forceinline__ void stockham_pass(double2* xf, const double2* __restrict__ tw,
                                              const double2* __restrict__ t1, int t)
{
    constexpr int TF = M / kFftRadix, Q = kFftRadix / R, NB = M / R;
    double2 v[Q][R];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int j = t + TF * q;
#pragma unroll
        for (int r = 0; r < R; ++r) v[q][r] = xf[xpad(j + r * NB)];
    }
    frame_sync<M>();  // every point of the frame is read: the pass writes in place
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int j = t + TF * q, jm = j & (NS - 1);
#pragma unroll
        for (int r = 1; r < R; ++r)
            v[q][r] = cmul(v[q][r], NS == kFftRadix ? __ldg(t1 + kFftRadix * r + jm) : __ldg(tw + r * jm * (M / (NS * R))));
        dft_dif<R>(v[q], tw, M / R);
        const int base = (j / NS) * NS * R + jm;
#pragma unroll
        for (int k = 0; k < R; ++k) xf[xpad(base + k * NS)] = v[q][bitrev(k, R)];
    }
    frame_sync<M>();
}

// the first pass's 16 points of thread t: z[m] = (x[2m] w[2m], x[2m+1] w[2m+1]),
// m = t + (M / 16) r, from the frame's span sp (EVEN: sp is 8-byte aligned,
// each point one 8-byte load); the float32 samples widen exactly
template <int M, bool EVEN>
__device__ __forceinline__ void first_points(double2 (&v)[kFftRadix], const float* sp,
                                             const double2* __restrict__ win, int t)
{
#pragma unroll
    for (int r = 0; r < kFftRadix; ++r) {
        const int m = t + r * (M / kFftRadix);
        const double2 w = __ldg(win + m);
        const float2 x = EVEN ? *reinterpret_cast<const float2*>(sp + 2 * m) : make_float2(sp[2 * m], sp[2 * m + 1]);
        v[r] = make_double2(__dmul_rn(static_cast<double>(x.x), w.x), __dmul_rn(static_cast<double>(x.y), w.y));
    }
}

// the passes after the first: radix 16 while 16 divides what is left, then the rest
template <int M, int NS>
__device__ __forceinline__ void later_passes(double2* xf, const double2* __restrict__ tw,
                                             const double2* __restrict__ t1, int t)
{
    if constexpr (NS < M) {
        constexpr int R = M / NS >= kFftRadix ? kFftRadix : M / NS;
        stockham_pass<M, R, NS>(xf, tw, t1, t);
        later_passes<M, NS * R>(xf, tw, t1, t);
    }
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// the parts of a block's shared memory, in bytes, in their order (the
// launcher's sum; kernels/fused_frontend.fft_shared_bytes); the constants
// stay in device memory, read through the L1 cache
template <int M> constexpr int kRound = kFftThreads * kFftRadix / M;                         // frames a round
template <int M> constexpr int kExchangeBytes = kRound<M> * (M + M / 16) * 16;              // [frames][M padded] double2
template <int M> constexpr int kPowerBytes = round16(kRound<M> * (M + 1) * 4);               // [frames][M + 1] float
constexpr int kRedBytes = 4 * kFftThreads / 32;                                              // the warps' maxima
__host__ __device__ inline int span_floats(int hop, int n_fft) { return (kBF - 1) * hop + n_fft; }
constexpr int kBlocksPerSm = 2;  // blocks an SM holds: shared memory takes two of ~100-110 KB (16 warps)

template <int M>
int shared_bytes(int hop)
{
    return kExchangeBytes<M> + kPowerBytes<M> + kRedBytes + round16(span_floats(hop, 2 * M) * 4);
}

// tab: float64 [M] the window in pairs, [M] W_M^k, [M + 1] W_N^k, [16][16]
// the second pass's twiddles (kernels/fused_frontend.fft_weights)
template <int LOGM, typename In>
__global__ void __launch_bounds__(kFftThreads, kBlocksPerSm)
fused_mel_fft_kernel(const In* __restrict__ audio, const double2* __restrict__ tab, const int2* __restrict__ bands,
                     const float* __restrict__ wts, float* __restrict__ mel, float* __restrict__ bmax, int T, int hop,
                     int start, int nf, int n_mels)
{
    constexpr int M = 1 << LOGM;
    constexpr int TF = M / kFftRadix;  // threads a frame
    constexpr int FR = kRound<M>;      // frames a round
    constexpr int XP = M + M / 16;     // double2 a frame in the exchange
    constexpr int PP = M + 1;          // floats a power row
    constexpr int SP = kFftMelCols + 1;  // floats a staged mel row
    extern __shared__ __align__(16) unsigned char smem[];
    double2* ex = reinterpret_cast<double2*>(smem);  // [FR][XP]; the round's staged mel [FR][SP] after its FFT
    float* pw = reinterpret_cast<float*>(smem + kExchangeBytes<M>);
    float* red = reinterpret_cast<float*>(smem + kExchangeBytes<M> + kPowerBytes<M>);
    float* span = reinterpret_cast<float*>(smem + kExchangeBytes<M> + kPowerBytes<M> + kRedBytes);
    const double2* twm = tab + M;          // W_M^k, k < M
    const double2* twn = tab + 2 * M;      // W_N^k, k <= M
    const double2* tw1 = tab + 3 * M + 1;  // the second pass's W_M^(r j M / (16 R))

    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * kBF;
    const In* x = audio + (size_t)b * T;
    const int2 live = __ldg(bands);  // bins [lo, hi)
    const int pair0 = max(0, min(live.x, M + 1 - live.y));  // the first pair (k, M - k) with a live bin

    // span[i]: sample f0 hop + start + i, so frame f (of the tile) reads its
    // point n at span[f hop + n]
    const long long s0 = (long long)f0 * hop + start;
    const int n_span = span_floats(hop, 2 * M);
    for (int i = tid; i < n_span; i += kFftThreads) {
        const long long smp = s0 + i;
        span[i] = (smp >= 0 && smp < T) ? load_sample(x, smp) : 0.0f;
    }
    __syncthreads();

    const int t = tid % TF, fl = tid / TF;      // the FFT's thread of a frame, and the frame of the round
    const int mf = tid % FR, slot = tid / FR;   // the mel's frame of the round, and band slot (TF of them)
    const int n_valid = min(kBF, nf - f0);
    float* st = reinterpret_cast<float*>(ex);   // [FR][SP] staged mel
    float vmax = 0.0f;
    for (int r0 = 0; r0 < n_valid; r0 += FR) {
        double2* xf = ex + fl * XP;
        {  // the first pass (NS = 1): radix 16 straight from the span, windowed
            double2 v[kFftRadix];
            const float* sp = span + (r0 + fl) * hop;
            if (hop % 2 == 0)  // every frame starts 8-byte aligned: a point is one 8-byte load
                first_points<M, true>(v, sp, tab, t);
            else
                first_points<M, false>(v, sp, tab, t);
            dft_dif<kFftRadix>(v, twm, M / kFftRadix);
#pragma unroll
            for (int k = 0; k < kFftRadix; ++k) xf[xpad(kFftRadix * t + k)] = v[bitrev(k, kFftRadix)];
            frame_sync<M>();
        }
        later_passes<M, kFftRadix>(xf, twm, tw1, t);

        // the post-pass and the power of the live bins, bins k and M - k
        // from the same two points: for M - k, E and O are the conjugates of
        // k's (exactly, but for the sign of a zero, which the square drops)
        // and W_N^(M-k) = (-W.x, W.y) (the table's own symmetry); the power
        // in FP64, rounded once to float32
        float* pf = pw + fl * PP;
#pragma unroll 2
        for (int k = pair0 + t; k <= M / 2; k += TF) {
            const double2 a = xf[xpad(k)];
            const double2 bz = xf[xpad((M - k) & (M - 1))];
            const double2 bc = make_double2(bz.x, -bz.y);  // conj Z[M - k]
            const double2 e = make_double2(__dmul_rn(0.5, __dadd_rn(a.x, bc.x)), __dmul_rn(0.5, __dadd_rn(a.y, bc.y)));
            const double2 d = csub(a, bc);
            const double2 o = make_double2(__dmul_rn(0.5, d.y), -__dmul_rn(0.5, d.x));
            const double2 w = __ldg(twn + k);
            if (k >= live.x && k < live.y) {
                const double2 xk = cadd(e, cmul(o, w));
                pf[k - live.x] = __double2float_rn(__dadd_rn(__dmul_rn(xk.x, xk.x), __dmul_rn(xk.y, xk.y)));
            }
            const int k2 = M - k;
            if (k2 != k && k2 >= live.x && k2 < live.y) {
                const double2 xk =
                    cadd(make_double2(e.x, -e.y), cmul(make_double2(o.x, -o.y), make_double2(-w.x, w.y)));
                pf[k2 - live.x] = __double2float_rn(__dadd_rn(__dmul_rn(xk.x, xk.x), __dmul_rn(xk.y, xk.y)));
            }
        }
        __syncthreads();  // the round's power rows are complete; the exchange is free

        // the mel of the round's frames, 128 bands at a time, staged and written as whole rows
        const int rows = min(FR, n_valid - r0);
        const bool valid = mf < rows;
        float* out = mel + ((size_t)b * nf + f0 + r0) * n_mels;
        for (int g0 = 0; g0 < n_mels; g0 += kFftMelCols) {
            const int cols = min(kFftMelCols, n_mels - g0);
            for (int c = slot; c < cols; c += TF) {
                const int2 bm = __ldg(bands + 1 + g0 + c);  // (first bin less lo, offset of the weights)
                const int count = __ldg(bands + 2 + g0 + c).y - bm.y;
                const float* p = pw + mf * PP + bm.x;
                const float* wb = wts + bm.y;
                float acc = 0.0f;
#pragma unroll 4
                for (int j = 0; j < count; ++j) acc = __fadd_rn(acc, __fmul_rn(__ldg(wb + j), p[j]));
                st[mf * SP + c] = acc;
                if (valid) vmax = fmaxf(vmax, acc);
            }
            __syncthreads();
            const int c = tid % kFftMelCols;
            if (c < cols)
                for (int f = tid / kFftMelCols; f < rows; f += kFftThreads / kFftMelCols)
                    out[(size_t)f * n_mels + g0 + c] = st[f * SP + c];
            __syncthreads();  // the staging (and, after the last group, the exchange) is free again
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    if ((tid & 31) == 0) red[tid >> 5] = vmax;
    __syncthreads();
    if (tid == 0) {
        float m = red[0];
        for (int w = 1; w < kFftThreads / 32; ++w) m = fmaxf(m, red[w]);
        bmax[(size_t)b * gridDim.x + blockIdx.x] = m;
    }
}

template <int LOGM, typename In>
cudaError_t launch_fft(const In* audio, const void* tab, const void* bands, const float* w, float* mel, float* bmax,
                       int B, int T, int hop, int start, int nf, int n_mels, int smem, void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(fused_mel_fft_kernel<LOGM, In>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)  // all of the SM's 228 KB as shared memory: two blocks of up to ~113 KB
        err = cudaFuncSetAttribute(fused_mel_fft_kernel<LOGM, In>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    fused_mel_fft_kernel<LOGM, In><<<dim3((nf + kBF - 1) / kBF, B), kFftThreads, smem, (cudaStream_t)stream>>>(
        audio, static_cast<const double2*>(tab), static_cast<const int2*>(bands), w, mel, bmax, T, hop, start, nf,
        n_mels);
    return cudaGetLastError();
}

template <int LOGM>
int launch_size(const void* audio, int audio_i16, const void* tab, const void* bands, const float* w, float* mel,
                float* bmax, int B, int T, int hop, int start, int nf, int n_mels, int smem, void* stream)
{
    if (smem != shared_bytes<(1 << LOGM)>(hop) || smem > kSharedMax) return (int)cudaErrorInvalidValue;
    if (audio_i16)
        return (int)launch_fft<LOGM>(static_cast<const int16_t*>(audio), tab, bands, w, mel, bmax, B, T, hop, start,
                                     nf, n_mels, smem, stream);
    return (int)launch_fft<LOGM>(static_cast<const float*>(audio), tab, bands, w, mel, bmax, B, T, hop, start, nf,
                                 n_mels, smem, stream);
}

}  // namespace

// tab: double2 [3M + 257] (the window in pairs, W_M^k for k < M, W_N^k for
// k <= M, the second pass's twiddles [16][16]); bands: int2 [n_mels + 2] (live bins [lo, hi); per band its first
// bin less lo and the offset of its weights; then (0, number of weights), at
// most 2 (M + 1)); w: the weights (kernels/fused_frontend.fft_weights);
// start: the sample of frame 0's first FFT point; mel [B, nf, n_mels],
// bmax [B, ceil(nf/64)]; shared_bytes from fft_shared_bytes, checked here
extern "C" int fused_mel_fft_f32(const void* audio, int audio_i16, const void* tab, const void* bands, const float* w,
                                 float* mel, float* bmax, int B, int T, int n_fft, int hop, int start, int nf,
                                 int n_mels, int shared_bytes, void* stream)
{
    if (B < 1 || T < 1 || nf < 1 || hop < 1 || n_mels < 1 || n_mels > kMelLimit || !audio || !tab || !bands || !w)
        return (int)cudaErrorInvalidValue;
    switch (n_fft) {
    case 2 << kFftMinLog:
        return launch_size<kFftMinLog>(audio, audio_i16, tab, bands, w, mel, bmax, B, T, hop, start, nf, n_mels,
                                       shared_bytes, stream);
    case 2 << 8:
        return launch_size<8>(audio, audio_i16, tab, bands, w, mel, bmax, B, T, hop, start, nf, n_mels, shared_bytes,
                              stream);
    case 2 << 9:
        return launch_size<9>(audio, audio_i16, tab, bands, w, mel, bmax, B, T, hop, start, nf, n_mels, shared_bytes,
                              stream);
    case 2 << kFftMaxLog:
        return launch_size<kFftMaxLog>(audio, audio_i16, tab, bands, w, mel, bmax, B, T, hop, start, nf, n_mels,
                                       shared_bytes, stream);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
