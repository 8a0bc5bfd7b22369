"""PyTorch port: the host side of the tensor-core frontend kernels
fused_mel_f32, fused_mel_bf16, fused_mel_x3, fused_mel_i16 and fused_mel_i24
(csrc/fused_frontend_tc.cu). Their weights travel in layouts of their own
(kernels/fused_frontend.tc_layouts), built once per set of weights; here
each layout unpacks to the mode's weights exactly, the kernel's address
arithmetic (mirrored in Python) reads the frames from its staged span (in
shifted copies, or one copy whose rows the threads align in registers) or
from the A tile each stage of the streamed plan holds, and the weights from
those layouts, its staging plan (tc_plan: full, compact, then streamed)
fits a block's shared memory at every rate, hop, window and mel width of
the grid below, and the wrapper's constants are the source's; i16's digits and epilogue, mirrored,
give the plain version's DFT bit for bit, and bf16's epilogue, mirrored,
meets phase 14's bar against its plain version. f32's three-plane split is
exact for every operand it splits, and its arithmetic, mirrored in float32
matmuls (_split3_matmul), meets phase 2's bar against the plain version and
the JAX frontend's tolerances. The kernels themselves run only on the card:
chip_smoke.py holds them against their plain versions (phases 2, 14, 15,
17, 23)."""
import hashlib
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import MfccChange
from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from tests.test_torch_frontend import CONFIGS
from tests.test_torch_modulation import speechlike

CSRC = Path(ff.__file__).resolve().parent.parent / "csrc"
BASIS = {"f32": "wri", "bf16": "wri", "x3": "wri", "i16": "planes", "i24": "planes"}
# (span planes, basis planes, mel planes) of Mode<...>
PLANES = {"f32": (3, 3, 3), "bf16": (1, 1, 1), "x3": (2, 2, 2), "i16": (2, 3, 2), "i24": (3, 3, 2)}
MODE_OF = {"f32": "kF32", "bf16": "kBF16", "x3": "kX3", "i16": "kI16", "i24": "kI24"}
SHARED_MAX = 232_448  # bytes of shared memory a block may use on the H100
# the address mirror's configurations: both CONFIGS, an odd hop (55 at the
# 11.025 kHz default), a large one (220 at 44.1 kHz, n_fft 2048), 256 mel
# bands (two groups of 128), and two hops where f32 takes the streamed plan:
# 882 at 44.1 kHz (tStep 0.02), 1440 at 48 kHz with a 3,072-sample window
# (tStep 0.03, winLen 0.064, n_fft 4096)
STREAMED_CONFIGS = {
    "44.1k hop 882": dict(signal_sample_rate=44_100, n_fft=2048, tStep=0.02),
    "48k hop 1440 window 3072": dict(signal_sample_rate=48_000, n_fft=4096, tStep=0.03, winLen=0.064),
}
GEOMETRY_CONFIGS = CONFIGS | {
    "11.025k hop 55": dict(signal_sample_rate=11_025),
    "44.1k hop 220": dict(signal_sample_rate=44_100, n_fft=2048),
    "16k 256 mels": dict(signal_sample_rate=16_000, maxFreq=8000.0, n_mels=256),
} | STREAMED_CONFIGS
# the grid every mode's plan must fit: rates 8-48 kHz, tStep 2.5-30 ms and
# winLen 15-64 ms (both free keys of the reference's config; a 15-30 ms hop
# is common), 40-512 mel bands, n_fft = max(512, the smallest power of two
# ≥ the window). The plans were first pinned on a narrower grid (tStep to
# 10 ms, winLen to 40 ms, 40-256 bands); NARROW_PLANS is the sha256 of
# repr([(algorithm, sr, hop, Kp, n_mels, plan without its streamed field)])
# over it, in ALGORITHMS, RATES, tStep, winLen, n_mels order, as tc_plan
# gave them before the streamed rung existed: every geometry there keeps its
# plan.
RATES = (8_000, 10_000, 11_025, 12_000, 16_000, 22_050, 24_000, 32_000, 44_100, 48_000)
T_STEPS = (0.0025, 0.005, 0.01, 0.0125, 0.015, 0.02, 0.025, 0.03)
WIN_LENS, MEL_WIDTHS = (0.015, 0.025, 0.04, 0.064), (40, 80, 128, 256, 512)
NARROW_T_STEPS, NARROW_WIN_LENS, NARROW_MEL_WIDTHS = (0.0025, 0.005, 0.01), (0.015, 0.025, 0.04), (40, 80, 128, 256)
NARROW_PLANS = "f393c0fe64491fc16cdaf61efed2a47b273fae3a497189dab64b71b4ca5a6934"


def grid(sr: int, t_steps=T_STEPS, win_lens=WIN_LENS, mel_widths=MEL_WIDTHS) -> list[tuple[int, int, int]]:
    """(hop, Kp, n_mels) of every geometry of the grid at this rate: Kp the
    window support padded to 32 rows (the layouts' rule)."""
    out = []
    for t_step in t_steps:
        for win_len in win_lens:
            cfg = MfccConfig(signal_sample_rate=sr, tStep=t_step, winLen=win_len)
            assert max(512, 1 << (cfg.win_length - 1).bit_length()) >= cfg.win_length
            out += [(cfg.hop_length, -(-cfg.win_length // 32) * 32, n) for n in mel_widths]
    return out


def tensors(algorithm: str, name: str) -> tuple[MfccConfig, dict[str, torch.Tensor]]:
    cfg = MfccConfig(**GEOMETRY_CONFIGS[name])
    return cfg, ff.mode_tensors(algorithm, "cpu", cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels,
                                cfg.minFreq, cfg.maxFreq)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("algorithm", ff.ALGORITHMS)
def test_tc_layouts_round_trip(algorithm, name):
    """pack_tc_basis and pack_tc_mel, then their inverses, give the mode's
    weights (mode_weights) bit for bit, as the planes the kernel reads
    (tc_planes: f32 packs the three planes of its float32 weights, whose
    sum is those weights): bf16 holds the bf16, x3 and f32 planes exactly;
    bf16 packs one plane of each; the padded rows and mel columns are zero;
    mode_tensors and the MfccChange module carry the same layouts."""
    cfg, w = tensors(algorithm, name)
    mw = ff.mode_weights(algorithm, cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq,
                         cfg.maxFreq)
    basis = BASIS[algorithm]
    packed, mel = w[f"{basis}_tc"], w["melw_tc"]
    want = ff.tc_planes(algorithm, torch.from_numpy(mw[basis]))
    k = want.shape[1]
    assert packed.dtype == (torch.int8 if basis == "planes" else torch.bfloat16) and mel.dtype == torch.bfloat16
    assert (packed.shape[2], mel.shape[1]) == PLANES[algorithm][1:]
    back = ff.unpack_tc_basis(algorithm, packed, k)
    assert back.dtype == want.dtype and torch.equal(back, want)
    assert torch.equal(ff.unpack_tc_mel(mel, cfg.n_mels), ff.tc_planes(algorithm, torch.from_numpy(mw["melw"])))
    if algorithm == "f32":
        assert torch.equal(back[0] + back[1] + back[2], torch.from_numpy(mw["wri"]))
    kp = packed.shape[1] * packed.shape[-1]
    assert kp % 32 == 0 and kp - k < 32
    assert not ff.unpack_tc_basis(algorithm, packed, kp)[:, k:].float().any()
    module = MfccChange(cfg).frontend_weights(algorithm)
    assert torch.equal(module[f"{basis}_tc"], packed) and torch.equal(module["melw_tc"], mel)


def kernel_constants() -> dict[str, int]:
    src = (CSRC / "tensor_core.cuh").read_text() + (CSRC / "fused_frontend_tc.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    for mode, body in re.findall(r"struct Mode<(kX3|kI16|kI24|kBF16|kF32)> \{(.*?)\};", src, re.S):
        for k, v in re.findall(r"static constexpr int (k\w+) = (\d+);", body):
            consts[f"{mode}.{k}"] = int(v)
    consts["kCols"] = 32 * consts["kWN"]  # constexpr int kCols = 32 * kWN
    return consts


def test_tc_wrapper_constants_match_cuda_source():
    """The layouts' tile widths, MMA depths, plane counts (bf16: one of each,
    f32: three), chunk, stages, power pitch and mel step are the kernel's
    own constants."""
    c = kernel_constants()
    assert c["kBF"] == ff.BLOCK_FRAMES and c["kMelCols"] == ff._MEL_MAX and c["kMelStep"] == ff._MEL_STEP
    assert c["kChunkRows"] == ff._TC_CHUNK and c["kCols"] == ff._TC_COLS and c["kStages"] == ff._TC_STAGES
    assert c["kCols"] // 2 + 16 == ff._TC_PITCH  # kPitch = kTileBins + 16
    assert c["kMT"] * 16 * (c["kThreads"] // 32 // c["kWN"]) == ff.BLOCK_FRAMES
    assert set(MODE_OF) == set(ff.ALGORITHMS)
    for alg, mode in MODE_OF.items():
        assert c[f"{mode}.kStep"] == ff._TC_STEP[alg]
        assert (c[f"{mode}.kSpanPlanes"], c[f"{mode}.kBasisPlanes"], c[f"{mode}.kMelPlanes"]) == PLANES[alg]
        assert ff._TC_PLANES[alg] == PLANES[alg]


def a_fragment(span: np.ndarray, plane_base: int, e: int, al: int, shifted: bool, span_pad: int, gcd: int) -> np.ndarray:
    """The 8 bytes of a thread's A fragment of the row starting at element
    ``e`` (f·hop + k + al·t) of a span plane, as the kernel loads them:
    from the copy that aligns it (full plan), or (compact plan, shifted)
    cut from the 16 bytes of two aligned 8-byte loads of the one copy by
    the kernel's select and funnel shifts. ``span`` holds the planes'
    elements (uint16 for bf16, uint8 for int8)."""
    r = e % al
    if not shifted:
        assert r % gcd == 0
        start = plane_base + (r // gcd) * span_pad + e - r
        return span[start : start + al].view(np.uint8)
    start = plane_base + e - r
    assert e - r + 2 * al <= span_pad  # the second load stays inside the copy
    q = span[start : start + 2 * al].view(np.uint32).astype(np.uint64)  # v.x, v.y, u.x, u.y
    sh = r * span.itemsize  # bytes
    up, bits = sh >= 4, 8 * (sh & 3)
    w0, w1, w2 = (q[1], q[2], q[3]) if up else (q[0], q[1], q[2])
    lo = ((w1 << np.uint64(32) | w0) >> np.uint64(bits)) & np.uint64(0xFFFFFFFF)
    hi = ((w2 << np.uint64(32) | w1) >> np.uint64(bits)) & np.uint64(0xFFFFFFFF)
    return np.array([lo, hi], np.uint64).astype(np.uint32).view(np.uint8)


def stream_fragments(algorithm: str, hop: int, kp: int) -> None:
    """The streamed plan's A tiles, mirrored from the source: load_a_tile
    and store_a_tile write each chunk's tile (thread tid's unit i = tid +
    256 k: frame i // (32 / kAl), unit i % (32 / kAl), its kAl samples f·hop
    + k0 + kAl·u .. at [plane][frame][32], the 8-byte unit u at u ^ 4·((f >>
    1) & 1) for bf16 planes), and dft_chunk reads a thread's fragment of row
    f at step j from f·32 + kAl·t + kStep·(j ^ flip), flip = (g >> 1) & 1 for
    bf16 planes. Every tile element is written once, each fragment holds
    frame f's samples f·hop + k0 + kStep·j + kAl·t .., every element is
    read, and a half warp's 8-byte stores and loads each meet no bank twice
    (sixteen distinct 8-byte units modulo 16)."""
    al = 8 if BASIS[algorithm] == "planes" else 4  # elements per 8-byte load (kAl)
    step, frames, rows, threads = ff._TC_STEP[algorithm], 64, ff._TC_CHUNK, 256
    per_row, units = rows // al, frames * rows // al // threads
    signal = np.arange((frames - 1) * hop + kp + rows, dtype=np.int64)  # sample index = value
    swz = (lambda f: 4 * ((f >> 1) & 1)) if al == 4 else (lambda f: 0)
    for k0 in range(0, kp, rows):
        tile = np.full(frames * rows, -1, np.int64)
        for k in range(units):
            for half in range(threads // 16):
                tids = np.arange(16 * half, 16 * half + 16)
                i = tids + threads * k
                f, u = i // per_row, i % per_row
                at = f * rows + al * (u ^ swz(f))  # element offset of each lane's unit
                assert len(set((at // al) % 16)) == 16  # the stores' 8-byte units: conflict-free
                for e in range(al):
                    assert (tile[at + e] == -1).all()
                    tile[at + e] = signal[f * hop + k0 + al * u + e]
        assert (tile >= 0).all()
        read = np.zeros_like(tile, dtype=bool)
        for j in range(rows // step):
            for row0 in range(0, frames, 8):  # a warp's rows 16 MT wm + 16 mt + 8 h + g, g = 0 .. 7
                for g_half in (0, 4):
                    g = np.repeat(np.arange(g_half, g_half + 4), 4)
                    t = np.tile(np.arange(4), 4)
                    f = row0 + g
                    flip = (g >> 1) & 1 if al == 4 else 0 * g
                    at = f * rows + al * t + step * (j ^ flip)
                    assert len(set((at // al) % 16)) == 16  # the half warp's loads: conflict-free
                    for e in range(al):
                        np.testing.assert_array_equal(tile[at + e], f * hop + k0 + step * j + al * t + e)
                        read[at + e] = True
        assert read.all()


@pytest.mark.parametrize("name", GEOMETRY_CONFIGS)
@pytest.mark.parametrize("algorithm", ff.ALGORITHMS)
def test_tc_kernel_addressing_reads_frames_and_weights(algorithm, name):
    """The kernel's address arithmetic, mirrored, under the plan tc_plan
    gives: a thread's 8-byte A fragment of frame row f at contraction k is
    element f·hop + k of the staged span, read from the copy shifted so that
    the load is aligned (full plan; the 10 kHz default's hop of 50 needs 2
    copies for bf16, 4 for int8), or cut from two aligned loads of the one
    copy (compact plan: 32 frames a block; f32 at the odd hop of 55 and at
    hop 220), or read from the A tile of the chunk's stage (streamed plan:
    f32 at hop 882 of 44.1 kHz, f32 and x3 at hop 1440 of 48 kHz with a
    3,072-sample window; stream_fragments); its B fragment of column n is
    the interleaved basis column n at rows k..k+7 of the pre-arranged
    chunk; a mel step's B fragment is the mel weight of bin 16j + 4t + i of
    the block's group of 128 mel columns (256 bands: two groups). Every
    element of every frame, basis row and mel bin is read, and read
    right."""
    cfg, w = tensors(algorithm, name)
    hop = cfg.hop_length
    al = 8 if BASIS[algorithm] == "planes" else 4  # elements per 8-byte load (kAl)
    step, cols = ff._TC_STEP[algorithm], ff._TC_COLS
    packed = w[f"{BASIS[algorithm]}_tc"]
    tiles, ks, n_planes = packed.shape[:3]
    kp = ks * step
    plan = ff.tc_plan(algorithm, hop, kp, cfg.n_mels)
    assert plan.shared_bytes <= SHARED_MAX and plan.mel_groups == -(-cfg.n_mels // 128)
    assert bool(plan.streamed) == (name in STREAMED_CONFIGS and (algorithm == "f32" or "48k" in name
                                                                and algorithm == "x3"))
    if plan.streamed:
        assert (plan.frames, plan.shifted, plan.stages, plan.n_copies, plan.span_pad) == (64, 0, 4, 0, 0)
        stream_fragments(algorithm, hop, kp)
    else:
        # A: the span of a block, in n_copies copies (copy c shifted by c·gcd) or one
        gcd = math.gcd(hop, al)
        assert plan.n_copies == (1 if plan.shifted else al // gcd)
        assert plan.span_pad == -(-((plan.frames - 1) * hop + kp + (al if plan.shifted else 0)) // 16) * 16
        dtype = np.uint8 if al == 8 else np.uint16
        signal = np.random.default_rng(hop).integers(0, np.iinfo(dtype).max, plan.span_pad + al, dtype=dtype)
        copies = np.stack([signal[c * gcd : c * gcd + plan.span_pad] for c in range(plan.n_copies)]).reshape(-1)
        for k0 in range(0, kp, step):
            for f in range(plan.frames):
                for t in range(4):
                    e = f * hop + al * t + k0
                    got = a_fragment(copies, 0, e, al, bool(plan.shifted), plan.span_pad, gcd)
                    np.testing.assert_array_equal(got, signal[e : e + al].view(np.uint8))
    # B: the basis as the kernel reads each chunk's stage
    flat = packed.reshape(-1)
    inter = ff._interleave(ff.tc_planes(algorithm, w[BASIS[algorithm]]))
    want = torch.nn.functional.pad(inter, (0, 0, 0, kp - inter.shape[1]))
    got = torch.empty_like(want)
    kk = np.arange(kp)
    chunk, within = kk // ff._TC_CHUNK, kk % ff._TC_CHUNK
    j, rest = within // step, within % step
    for tt in range(tiles):
        for p in range(n_planes):
            base = (tt * kp + chunk * ff._TC_CHUNK) * cols * n_planes
            off = base[:, None] + ((j[:, None] * n_planes + p) * cols + np.arange(cols)[None, :]) * step + rest[:, None]
            got[p, :, tt * cols : (tt + 1) * cols] = flat[torch.as_tensor(off)]
    assert torch.equal(got, want)
    # the mel weights, a tile's steps at a time, group by group (mtc + group · bins_pad/64 tiles)
    mel = w["melw_tc"].reshape(-1)
    melw = ff.tc_planes(algorithm, w["melw"])
    n_mel_planes, bins_pad = melw.shape[:2]
    bins = np.arange(bins_pad)
    jm, rm = bins // ff._MEL_STEP, bins % ff._MEL_STEP
    for g in range(plan.mel_groups):
        for p in range(n_mel_planes):
            off = (((g * bins_pad // ff._MEL_STEP + jm[:, None]) * n_mel_planes + p) * ff._MEL_MAX
                   + np.arange(ff._MEL_MAX)[None, :]) * ff._MEL_STEP + rm[:, None]
            got_m = mel[torch.as_tensor(off)].float()
            live = min(ff._MEL_MAX, cfg.n_mels - 128 * g)
            assert torch.equal(got_m[:, :live], melw[p][:, 128 * g : 128 * g + live])
            assert not got_m[:, live:].any()


def test_tc_modes_raise_off_the_card():
    """A CUDA-only layout never reaches a CPU path: on the CPU every
    tensor-core mode's wrapper takes its plain version (equal with or
    without the layouts in ``weights``; f32's is the FP32 GEMM in 16-row
    steps, never the split), and on another device it raises."""
    kw = dict(sr=16_000, hop=80, win_length=400, fmax=8000.0)
    x = torch.tensor(np.random.default_rng(1).standard_normal((1, 4000)), dtype=torch.float32)
    for alg in ff.ALGORITHMS:
        _, w = tensors(alg, "16k")
        bare = {k: v for k, v in w.items() if not k.endswith("_tc")}
        a = ff.fused_mel_frontend(x, algorithm=alg, weights=w, **kw)
        b = ff.fused_mel_frontend(x, algorithm=alg, weights=bare, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        with pytest.raises(ValueError, match="no kernel"):
            ff.fused_mel_frontend(x.to("meta"), algorithm=alg, **kw)


@pytest.mark.parametrize("algorithm", ff.ALGORITHMS)
def test_tc_launch_needs_the_layouts(algorithm, monkeypatch):
    """The launcher never repacks the weights: on the kernel's route, weights
    without their tensor-core layouts raise before anything is launched,
    naming the layouts and mode_tensors."""
    monkeypatch.setattr(ff, "route", lambda t, name: True)
    _, w = tensors(algorithm, "16k")
    bare = {k: v for k, v in w.items() if not k.endswith("_tc")}
    x = torch.zeros((1, 4000), dtype=torch.float32)
    before = dict(ff.LAUNCHES)
    with pytest.raises(ValueError, match="tensor-core layouts.*mode_tensors"):
        ff.fused_mel_frontend(x, sr=16_000, hop=80, win_length=400, fmax=8000.0, algorithm=algorithm, weights=bare)
    assert dict(ff.LAUNCHES) == before


def test_tc_i16_digits_and_epilogue_match_plain_bit_for_bit():
    """fused_mel_i16's arithmetic, mirrored in numpy from the source: the two
    int8 digits of each sample as planes_of computes them, the five digit ×
    plane products as exact integer sums over the interleaved basis of
    planes_tc (Kp rows, the padded ones zero), and the epilogue, which picks
    corr for the fragment's bin 16·wn + 4·nt + t of tile ``tile`` (re at
    column 2t, im at 2t + 1 of n-tile nt) and recombines in FP32 in the JAX
    order. The DFT equals the plain version's (_fixed_point_reim) bit for
    bit, on int16 audio at both configurations, a quiet utterance included."""
    rng = np.random.default_rng(16)
    for name in CONFIGS:
        cfg, w = tensors("i16", name)
        hop, k = cfg.hop_length, w["planes"].shape[1]
        bins_pad = w["melw"].shape[1]
        pcm = rng.integers(-9000, 9000, (3, 3000)).astype(np.int16)
        pcm[2] //= 300  # about -60 dBFS: the i16 mode's worst case
        audio = torch.tensor(pcm)
        sc = ff.quant_scales(audio, "i16", w["sw"])
        nf = 1 + pcm.shape[1] // hop
        flat = torch.nn.functional.pad(audio.float() / 32768.0, (ff.eff_pad(cfg.n_fft, cfg.win_length), 64 + k))
        frames = frame_by_slices(flat, 0, nf, k, hop)
        want = ff._fixed_point_reim(frames, w["planes"], sc, "i16", w["corr"]).numpy()

        packed = w["planes_tc"]
        tiles, ks, n_planes, cols, step = packed.shape
        kp = ks * step
        basis = packed.permute(2, 1, 4, 0, 3).reshape(n_planes, kp, tiles * cols).numpy().astype(np.int64)
        s_np, inv = sc[:, 0].numpy(), sc[:, 1].numpy()
        # planes_of: rint(v * s) (half to even), clipped, then x1 = floor(X / 256), x0 = X - 256 x1 - 128
        x = frame_by_slices(flat, 0, nf, kp, hop).numpy()
        big = np.clip(np.rint((x * s_np[:, None, None]).astype(np.float32)), -32768.0, 32767.0)
        x1 = np.floor(big * np.float32(1.0 / 256.0))
        x0 = big - np.float32(256.0) * x1 - np.float32(128.0)
        assert x1.min() >= -128 and x1.max() <= 127 and x0.min() >= -128 and x0.max() <= 127
        x1, x0 = x1.astype(np.int64), x0.astype(np.int64)
        w2, w1, w0 = basis
        d1, d2, d3 = x1 @ w2, x1 @ w1 + x0 @ w2, x1 @ w0 + x0 @ w1
        assert max(abs(d).max() for d in (d1, d2, d3)) < 2**31
        tile, wn, nt, t = np.meshgrid(np.arange(tiles), np.arange(4), np.arange(4), np.arange(4), indexing="ij")
        col = (tile * cols + 32 * wn + 8 * nt + 2 * t).ravel()
        bin_ = (tile * (cols // 2) + 16 * wn + 4 * nt + t).ravel()
        assert np.array_equal(np.sort(bin_), np.arange(bins_pad))
        corr = w["corr"].numpy()
        got = np.empty_like(want)
        f32 = np.float32
        for c, part in ((col, bin_), (col + 1, bin_ + bins_pad)):
            a, b, e = (d[..., c].astype(f32) for d in (d1, d2, d3))
            acc = ((a * f32(2.0**24) + b * f32(2.0**16)) + e * f32(2.0**8)) + corr[part]
            got[..., part] = acc * inv[:, None, None]
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), name


@pytest.mark.parametrize("n_mels", [40, 300])
@pytest.mark.parametrize("planes", [1, 2, 3])
def test_tc_mel_pack_round_trip_by_planes(planes, n_mels):
    """pack_tc_mel takes one plane (bf16's rounded weights), two (the x3
    stack) or three (f32's split): [G·bins/16, P, 128, 16] bf16 in G groups
    of 128 mel columns (300 bands: three), the columns past n_mels zero, and
    unpack_tc_mel gives the planes back bit for bit; one plane is half the
    bytes the mel bulk copy moves."""
    rng = np.random.default_rng(planes)
    melw = ff._bf16r(torch.tensor(rng.random((planes, 256, n_mels)), dtype=torch.float32))
    packed = ff.pack_tc_mel(melw)
    groups = -(-n_mels // ff._MEL_MAX)
    assert packed.shape == (groups * 256 // ff._MEL_STEP, planes, ff._MEL_MAX, ff._MEL_STEP)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert torch.equal(ff.unpack_tc_mel(packed, n_mels), melw)
    assert not ff.unpack_tc_mel(packed, groups * ff._MEL_MAX)[..., n_mels:].float().any()


def bf16_ulps(mel: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |mel − ref| of two bf16 mels in units of ref's bf16 ulp, 2^(e−8)
    for ref = m·2^e with m in [0.5, 1); share of entries more than one ulp
    apart): chip_smoke.py phase 14's measure."""
    k, p = mel.double(), ref.double()
    ulp = torch.ldexp(torch.ones_like(p), torch.frexp(p)[1] - 8)
    d = (k - p).abs()
    u = torch.where(p > 0, d / ulp, torch.where(d > 0, torch.inf, 0.0))
    return float(u.max()), float((u > 1.0).double().mean())


def bf16_tc_mirror(audio: torch.Tensor, cfg: MfccConfig, w: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """fused_mel_bf16's arithmetic on flat float32 audio [B, T], mirrored
    from the source: the samples rounded to bf16 as the span is staged; each
    frame's DFT against the interleaved bf16 basis of ``wri_tc`` (Kp rows,
    the padded ones zero) as the FP32 value of the exact sum of its bf16
    products; the power of the bin that a fragment's columns 2t (re) and
    2t + 1 (im) of n-tile nt hold, bin 16·wn + 4·nt + t of its tile,
    fl(fl(re²) + fl(im²)), rounded to bf16; the mel from ``melw_tc``, each
    16-bin step's products summed exactly, rounded to FP32 and added to the
    running FP32 sum (mma_bf16_add); then the mel stored as bf16 and each 64
    frames' maximum taken over the FP32 mel of the valid frames."""
    hop, n_mels = cfg.hop_length, cfg.n_mels
    packed, mtc = w["wri_tc"], w["melw_tc"]
    tiles, ks, _, cols, step = packed.shape
    kp, bins_pad = ks * step, tiles * cols // 2
    basis = packed.permute(2, 1, 4, 0, 3).reshape(kp, tiles * cols).double()
    bsz, t_len = audio.shape
    nf = 1 + t_len // hop
    pad = ff.eff_pad(cfg.n_fft, cfg.win_length)
    flat = torch.nn.functional.pad(ff._bf16r(audio), (pad, (nf - 1) * hop + kp))
    dft = (frame_by_slices(flat, 0, nf, kp, hop).double() @ basis).float()
    tile, wn, nt, t = np.meshgrid(np.arange(tiles), np.arange(4), np.arange(4), np.arange(4), indexing="ij")
    col = torch.as_tensor((tile * cols + 32 * wn + 8 * nt + 2 * t).ravel())
    bin_ = torch.as_tensor((tile * (cols // 2) + 16 * wn + 4 * nt + t).ravel())
    assert torch.equal(torch.sort(bin_).values, torch.arange(bins_pad))
    re, im = dft[..., col], dft[..., col + 1]
    power = torch.empty((bsz, nf, bins_pad), dtype=torch.float32)
    power[..., bin_] = re * re + im * im
    p16 = ff._bf16r(power).double()
    mel = torch.zeros((bsz, nf, ff._MEL_MAX), dtype=torch.float32)
    for j in range(mtc.shape[0]):
        mel = mel + (p16[..., ff._MEL_STEP * j : ff._MEL_STEP * (j + 1)] @ mtc[j, 0].double().T).float()
    mel = mel[..., :n_mels]
    n_blocks = -(-nf // ff.BLOCK_FRAMES)
    fmax = torch.nn.functional.pad(mel.amax(-1), (0, n_blocks * ff.BLOCK_FRAMES - nf))
    return mel.to(torch.bfloat16), fmax.reshape(bsz, n_blocks, ff.BLOCK_FRAMES).amax(-1)


def bf16_mirror_audio(cfg: MfccConfig) -> torch.Tensor:
    """2 × 1.5 s: noise, and speech-like audio with silent lead-in and -out
    (phase 14's kind of input)."""
    sr = int(cfg.signal_sample_rate)
    noise = np.random.default_rng(sr).standard_normal(3 * sr // 2) * 0.3
    return torch.tensor(np.stack([noise, speechlike(1.5, sr, seed=sr)]), dtype=torch.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_tc_bf16_epilogue_meets_the_plain_bar(name):
    """The bf16 mode's tensor-core arithmetic, mirrored (bf16_tc_mirror),
    against its plain version (fused_mel_frontend_reference, FP32 GEMMs of
    the same bf16 operands in another order) within chip_smoke.py phase 14's
    bf16 bar: at most 2 bf16 ulps, at most 0.1 % of the entries beyond one,
    the block maxima within 2^-8. The two sum the same exact products in
    different orders, so they part only where a power or a mel sits at a
    bf16 rounding boundary (measured here: at most 1 ulp)."""
    cfg, w = tensors("bf16", name)
    audio = bf16_mirror_audio(cfg)
    mel, bmax = bf16_tc_mirror(audio, cfg, w)
    want, want_bmax = ff.fused_mel_frontend_reference(
        audio, w["wri"], w["melw"], hop=cfg.hop_length, eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length),
        algorithm="bf16")
    assert mel.shape == want.shape and mel.dtype == want.dtype == torch.bfloat16
    ulps, share = bf16_ulps(mel, want)
    assert ulps <= 2.0 and share <= 1e-3, (ulps, share)
    assert bool(((bmax - want_bmax).abs() <= 2.0**-8 * want_bmax).all())


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("algorithm", ff.ALGORITHMS)
def test_tc_shared_memory_fits_a_block(algorithm, name):
    """tc_plan's shared bytes are the launcher's sum from the source's constants:
    128 bytes of barriers, kStages chunks of kChunkRows x kCols elements of
    every basis plane, a tile's mel weights (kTileBins x kMelCols bf16 a
    plane), the power tile (kBF x kPitch bf16 a plane) and the span planes
    in their shifted copies (the hop of 50 needs two for bf16 elements, four
    for int8); it fits the 227 KB a block may use at both configurations.
    f32's stage carries three bf16 planes, 1.5 times x3's."""
    cfg, w = tensors(algorithm, name)
    c = kernel_constants()
    packed = w[f"{BASIS[algorithm]}_tc"]
    kp = packed.shape[1] * packed.shape[-1]
    span_planes, basis_planes, mel_planes = PLANES[algorithm]
    esize = packed.element_size()
    al = 8 // esize
    span_pad = -(-((c["kBF"] - 1) * cfg.hop_length + kp) // 16) * 16
    want = (128 + c["kStages"] * c["kChunkRows"] * c["kCols"] * basis_planes * esize
            + c["kCols"] // 2 * mel_planes * c["kMelCols"] * 2 + mel_planes * c["kBF"] * (c["kCols"] // 2 + 16) * 2
            + span_planes * (al // math.gcd(cfg.hop_length, al)) * span_pad * esize)
    assert ff.tc_plan(algorithm, cfg.hop_length, kp).shared_bytes == want <= SHARED_MAX == ff.SHARED_MAX
    if algorithm == "f32":
        x3 = c["kChunkRows"] * c["kCols"] * PLANES["x3"][1] * 2
        assert c["kChunkRows"] * c["kCols"] * basis_planes * esize == 3 * x3 // 2


def launcher_bytes(c: dict[str, int], algorithm: str, hop: int, kp: int, frames: int, shifted: bool,
                   stages: int, streamed: bool = False) -> int:
    """The launcher's sum (plan_holds in the source), from the source's
    constants: barriers and warp maxima, ``stages`` basis chunks (each with
    the planes of a kBF × kChunkRows A tile when ``streamed``), a tile's mel
    weights, the power tile of ``frames`` rows and the span planes, in their
    shifted copies, or one copy with kAl elements of slack when ``shifted``,
    or none when ``streamed``."""
    span_planes, basis_planes, mel_planes = PLANES[algorithm]
    esize = 1 if BASIS[algorithm] == "planes" else 2
    al = 8 // esize
    n_copies = 0 if streamed else 1 if shifted else al // math.gcd(hop, al)
    span_pad = -(-((frames - 1) * hop + kp + (al if shifted else 0)) // 16) * 16
    a_tile = span_planes * c["kBF"] * c["kChunkRows"] * esize if streamed else 0
    return (128 + stages * (c["kChunkRows"] * c["kCols"] * basis_planes * esize + a_tile)
            + c["kCols"] // 2 * mel_planes * c["kMelCols"] * 2 + mel_planes * frames * (c["kCols"] // 2 + 16) * 2
            + span_planes * n_copies * span_pad * esize)


def plan_rung(plan: ff.TcPlan) -> str:
    return "streamed" if plan.streamed else "compact" if plan.shifted else "full"


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("algorithm", ff.ALGORITHMS)
def test_tc_plan_fits_every_geometry(algorithm, sr):
    """At every hop, window and mel width of the grid at this rate, tc_plan
    gives a plan within the 227 KB of shared memory a block may use, the
    first rung of the ladder that fits: the full plan (64 frames, the span's
    copies, four stages); else the compact plan (32 frames, one copy aligned
    in registers) with the most stages, four to two, that fit; else the
    streamed plan (64 frames, four stages, each stage with its chunk's A
    tile, no span), which f32 takes from 22.05 kHz with a 30 ms hop and x3
    at 44.1 and 48 kHz with 30 ms; one mel group per 128 bands. The 16 kHz
    flagship (hop 80, Kp 416, 128 bands) keeps the full plan."""
    for hop, kp, n_mels in grid(sr):
        plan = ff.tc_plan(algorithm, hop, kp, n_mels)
        assert plan.shared_bytes <= SHARED_MAX, (hop, kp, n_mels, plan)
        assert plan.mel_groups == -(-n_mels // 128)
        full = ff._plan_for(algorithm, hop, kp, n_mels, 64, False, 4)
        compact = [ff._plan_for(algorithm, hop, kp, n_mels, 32, True, s) for s in (4, 3, 2)]
        if full.shared_bytes <= SHARED_MAX:
            assert plan == full
        elif compact[-1].shared_bytes <= SHARED_MAX:
            assert (plan.frames, plan.shifted, plan.streamed, plan.n_copies) == (32, 1, 0, 1) and 2 <= plan.stages <= 4
            assert plan == next(p for p in compact if p.shared_bytes <= SHARED_MAX)
        else:
            assert (plan.frames, plan.shifted, plan.streamed, plan.stages, plan.n_copies, plan.span_pad) == (
                64, 0, 1, 4, 0, 0)
            assert algorithm in ("f32", "x3") and (sr >= 22_050 if algorithm == "f32" else sr >= 44_100)
    flagship = ff.tc_plan(algorithm, 80, 416, 128)
    assert (flagship.frames, flagship.shifted, flagship.streamed, flagship.stages, flagship.mel_groups) == (
        64, 0, 0, 4, 1)
    for t_step, win_len in ((0.03, 0.025), (0.03, 0.064)):
        cfg = MfccConfig(signal_sample_rate=48_000, tStep=t_step, winLen=win_len)
        kp = -(-cfg.win_length // 32) * 32
        assert (plan_rung(ff.tc_plan(algorithm, cfg.hop_length, kp)) == "streamed") == (algorithm in ("f32", "x3"))


def test_tc_plan_keeps_the_narrow_grids_plans():
    """Every geometry of the narrower grid the plans were first pinned on
    keeps the plan it had before the streamed rung (NARROW_PLANS, a digest
    of those plans); none of them is streamed."""
    rows = []
    for alg in ff.ALGORITHMS:
        for sr in RATES:
            for hop, kp, n in grid(sr, NARROW_T_STEPS, NARROW_WIN_LENS, NARROW_MEL_WIDTHS):
                plan = ff.tc_plan(alg, hop, kp, n)
                assert not plan.streamed
                rows.append((alg, sr, hop, kp, n, tuple(v for k, v in plan._asdict().items() if k != "streamed")))
    assert len(rows) == 5 * 10 * 3 * 3 * 4
    assert hashlib.sha256(repr(rows).encode()).hexdigest() == NARROW_PLANS


@pytest.mark.parametrize("algorithm", ff.ALGORITHMS)
def test_tc_streamed_plan_bytes_do_not_move_with_hop_or_window(algorithm):
    """The streamed plan's shared memory depends on neither the hop nor Kp:
    the same bytes at the flagship (hop 80, Kp 416), where the hop exceeds
    Kp (hop 4,800, Kp 1,216: frames do not overlap), at Kp 4,096 and at
    48 kHz with a 30 ms hop and a 64 ms window; every mode's is within a
    block's shared memory (f32 227,456 bytes, x3 151,680), and the launcher
    sums the same. At hop 4,800 the span of 63 hops leaves every mode no
    other rung, and tc_plan takes it."""
    c = kernel_constants()
    want = {"f32": 227_456, "x3": 151_680, "bf16": 75_904, "i16": 118_912, "i24": 127_104}[algorithm]
    for hop, kp in ((80, 416), (4800, 1216), (80, 4096), (1440, 3072), (1440, 4096)):
        plan = ff._plan_for(algorithm, hop, kp, 128, 64, False, 4, streamed=True)
        assert plan.shared_bytes == want == launcher_bytes(c, algorithm, hop, kp, 64, False, 4, streamed=True)
        assert (plan.n_copies, plan.span_pad) == (0, 0) and want <= SHARED_MAX
    assert plan_rung(ff.tc_plan(algorithm, 4800, 1216)) == "streamed"  # a span of 63 hops outgrows every mode


@pytest.mark.parametrize("algorithm", ff.ALGORITHMS)
def test_tc_plan_bytes_are_the_launchers(algorithm):
    """The wrapper's byte sum (tc_plan) equals the launcher's, computed here
    from the source's constants, at every geometry of the grid, and the plan's
    fields are the ones the launcher recomputes (its check); a width past
    512 bands raises, naming the limit."""
    c = kernel_constants()
    assert c["kMelLimit"] == ff.MEL_LIMIT and c["kSharedMax"] == ff.SHARED_MAX
    for sr in RATES:
        for hop, kp, n_mels in grid(sr):
            plan = ff.tc_plan(algorithm, hop, kp, n_mels)
            assert plan.shared_bytes == launcher_bytes(c, algorithm, hop, kp, plan.frames, bool(plan.shifted),
                                                       plan.stages, bool(plan.streamed))
            assert (plan.frames, plan.stages) in ((c["kBF"], c["kStages"]), (c["kBF"] // 2, plan.stages))
    with pytest.raises(ValueError, match="512"):
        ff.tc_plan(algorithm, 80, 416, 513)


@pytest.fixture(scope="module")
def split_operands() -> dict[str, torch.Tensor]:
    """float32 operands fused_mel_f32 splits: seeded noise, speech-like
    audio, v·2⁻¹⁵ of every int16 value, and both configurations' basis and
    mel weights."""
    out = {
        "noise": torch.tensor(np.random.default_rng(9).standard_normal(48_000) * 0.3, dtype=torch.float32),
        "speech-like": torch.tensor(speechlike(3.0, 16_000, seed=9)),
        "int16": torch.arange(-32768, 32768, dtype=torch.float32) / 32768.0,
    }
    for name in CONFIGS:
        _, w = tensors("f32", name)
        out |= {f"wri {name}": w["wri"], f"melw {name}": w["melw"]}
    return out


@pytest.mark.parametrize("name", ["noise", "speech-like", "int16", "wri 10k", "wri 16k", "melw 10k", "melw 16k"])
def test_split3_is_exact(split_operands, name):
    """hi + mid + lo == x bit for bit for every (denormal-free) operand the
    kernel splits, each plane a bf16 value; v·2⁻¹⁵ of an int16 has at most
    16 significant bits, so its lo plane is zero (the kernel skips lo·hi on
    int16 input)."""
    x = split_operands[name]
    assert bool(((x == 0) | (x.abs() >= 2.0**-126)).all())
    hi, mid, lo = ff._split3(x)
    for plane in (hi, mid, lo):
        assert torch.equal(ff._bf16r(plane), plane)
    assert torch.equal((hi + mid) + lo, x)
    assert bool((mid.abs() <= 2.0**-8 * hi.abs()).all()) and bool((lo.abs() <= 2.0**-8 * mid.abs()).all())
    if name == "int16":
        assert not lo.any()


@pytest.mark.parametrize("k", [16, 250, 400])
def test_split3_matmul_sums_as_the_kernel(k):
    """_split3_matmul is the kernel's order: the hi·hi products summed per
    16-row step and the steps added one by one, the five smaller products
    (hi·mid, mid·hi, hi·lo, mid·mid, lo·hi) summed apart in that order and
    added at the end, bit for bit; and it lands no further from the float64
    product than the FP32 GEMM in 16-row steps (the plain version)."""
    rng = np.random.default_rng(k)
    x = torch.tensor(rng.standard_normal((3, 5, k)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((k, 24)), dtype=torch.float32)
    (xh, xm, xl), planes = ff._split3(x), ff._split3(w)
    wh, wm, wl = planes
    hh = torch.zeros(3, 5, 24)
    for k0 in range(0, k, 16):
        hh = hh + xh[..., k0 : k0 + 16] @ wh[k0 : k0 + 16]
    want = hh + ((((xh @ wm + xm @ wh) + xh @ wl) + xm @ wm) + xl @ wh)
    got = ff._split3_matmul(x, planes)
    assert torch.equal(got, want)
    exact = x.double() @ w.double()
    assert (got.double() - exact).abs().max() <= (ff._stepped_matmul(x, w).double() - exact).abs().max()


def split_bar(mel, bmax, want, want_bmax, exact) -> tuple[float, float, float, float]:
    """(mel relative error above the top_db floor and peak relative error
    against the plain version; the same mel error of the mirror and of the
    plain version against the plain version in float64)."""
    def rel(m, ref):
        live = ref > 1e-8 * ref.amax(dim=(1, 2), keepdim=True)
        r = (m.double() - ref.double()).abs() / torch.where(live, ref.double(), torch.ones_like(ref.double()))
        return float(torch.where(live, r, torch.zeros_like(r)).max())

    peak = float(((bmax.amax(1) - want_bmax.amax(1)).abs() / want_bmax.amax(1)).max())
    return rel(mel, want), peak, rel(mel, exact), rel(want, exact)


@pytest.mark.parametrize("kind", ["noise", "speech-like"])
@pytest.mark.parametrize("name", CONFIGS)
def test_split3_mirror_meets_phase2_bar(name, kind):
    """fused_mel_f32's arithmetic mirrored (split3_frontend_mirror) against
    its plain version (fused_mel_frontend_reference, the FP32 GEMM in 16-row
    steps) at chip_smoke.py phase 2's bars. On noise: mel within 1e-4
    relative above the top_db floor, peak within 1e-5. On the speech-like
    utterance, whose quiet bands in loud frames sit 80 dB under the peak,
    FP32 leaves the plain version itself 3.3e-4 from float64 at 16 kHz and
    the split 8.5e-5, so there the mel bar is phase 2's: no further from the
    plain version evaluated in float64 than the plain version; the peak bar
    stays 1e-5."""
    cfg, w = tensors("f32", name)
    audio = bf16_mirror_audio(cfg)[[0 if kind == "noise" else 1]]
    kw = dict(hop=cfg.hop_length, eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length))
    mel, bmax = ff.split3_frontend_mirror(audio, w["wri"], w["melw"], **kw)
    want, want_bmax = ff.fused_mel_frontend_reference(audio, w["wri"], w["melw"], **kw)
    exact, _ = ff.fused_mel_frontend_reference(audio.double(), w["wri"].double(), w["melw"].double(), **kw)
    rel_plain, peak, rel_exact, plain_exact = split_bar(mel, bmax, want, want_bmax, exact)
    assert mel.shape == want.shape and mel.dtype == torch.float32 and peak <= 1e-5
    if kind == "noise":
        assert rel_plain <= 1e-4
    else:
        assert rel_exact <= plain_exact


@pytest.mark.parametrize("name", CONFIGS)
def test_split3_mirror_matches_jax_pallas(name):
    """The split's mirror against the JAX package's f32 Pallas frontend (its
    'f32' mode, run as its tests run it, in interpret mode) at
    tests/test_torch_frontend.py's tolerances: mel within 1e-5 of the largest
    mel value and 1e-4 relative above the top_db floor; the peak within 1e-6
    of the float64 peak of the same design."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    import modulation_mfcc_tpu.pallas.fused_frontend as jax_ff
    from tests.test_torch_frontend import frontend_kwargs

    cfg, w = tensors("f32", name)
    audio = np.random.default_rng(20260816).standard_normal((2, 24_000)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jmel, _ = jax_ff.fused_mel_frontend(jnp.asarray(audio), **frontend_kwargs(cfg))
    kw = dict(hop=cfg.hop_length, eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length))
    mel, bmax = ff.split3_frontend_mirror(torch.tensor(audio), w["wri"], w["melw"], **kw)
    mel = mel.numpy()
    jmel = np.asarray(jmel)[:, : mel.shape[1]]
    jpeak = jmel.max(axis=(1, 2))
    np.testing.assert_allclose(mel, jmel, rtol=0, atol=1e-5 * jpeak.max())
    live = jmel > 1e-8 * jpeak[:, None, None]
    np.testing.assert_allclose(mel[live], jmel[live], rtol=1e-4, atol=0)
    _, bmax64 = ff.fused_mel_frontend_reference(torch.tensor(audio, dtype=torch.float64), w["wri"].double(),
                                                w["melw"].double(), **kw)
    np.testing.assert_allclose(bmax.amax(1).numpy(), bmax64.amax(1).numpy(), rtol=1e-6, atol=0)


def test_tail_launch_rejects_what_the_kernel_does_not_take(monkeypatch):
    """On the kernel's route, mfcc_tail raises before any launch for more
    than 512 mel bands (sixteen a lane of a warp), or more coefficients than
    mel bands; the frontend raises past 512 bands, naming the limit."""
    monkeypatch.setattr(ff, "route", lambda t, name: True)
    before = dict(ff.LAUNCHES)
    peak = torch.zeros(2)
    for n_mels, n_mfcc in ((513, 13), (40, 41)):
        mel = torch.ones((2, 10, n_mels))
        with pytest.raises(ValueError, match="n_mels|n_mfcc"):
            ff.mfcc_tail(mel, peak, n_mfcc, dct=torch.zeros((n_mels, n_mfcc)))
    assert dict(ff.LAUNCHES) == before
    cfg = MfccConfig(signal_sample_rate=16_000, maxFreq=8000.0, n_mels=513)
    w = ff.mode_tensors("bf16", "cpu", 16_000, win_length=400, n_mels=513, fmax=8000.0)
    with pytest.raises(ValueError, match="n_mels in 1..512"):
        ff.fused_mel_frontend(torch.zeros((1, 4000)), sr=16_000, hop=80, win_length=400, fmax=8000.0,
                              n_mels=cfg.n_mels, algorithm="bf16", weights=w)
    assert dict(ff.LAUNCHES) == before
