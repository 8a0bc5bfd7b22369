"""PyTorch port: the folded frontend (fused_mel_frontend(fold=True)) against
the JAX package's folded Pallas frontend, run as its own tests run it on the
CPU (interpret mode). The fold's host design is compared bit for bit with
the operands the JAX fold hands its kernel (its pallas_call is
intercepted); the plain version (what the wrapper takes on the CPU) is held
to the bars of the JAX frontend tests. The FFMA fold
(csrc/fused_frontend_fold.cu: fused_mel_fold_bf16) fits a block's shared
memory at every geometry fold_ok takes, by its launcher's own sum. The
tensor-core folds' host side (csrc/fused_frontend_fold_tc.cu:
fused_mel_fold_f32, fused_mel_fold_x3): each staging plan (fold_plan) is
the first rung of its mode's ladder that fits a block's shared memory, at
every geometry fold_ok takes, by the launcher's own sum; the basis layouts
(fold_layouts) unpack to fold_weights bit for bit; the kernels' chunk build
and address arithmetic, mirrored, reproduce the plain version's s and d bit
for bit and the DFT of their planes; and the f32 fold's split arithmetic,
mirrored in float32 matmuls (split3_fold_mirror), is no further from the
float64 fold than the plain version. The CUDA kernels themselves are
checked on the card by chip_smoke.py (phases 18-19, 22-23)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as tnf

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import modulation_mfcc_tpu.pallas.fused_frontend as jax_ff
from modulation_mfcc_tpu_torch import convert
from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from tests.test_torch_frontend import CONFIGS, frontend_kwargs
from tests.test_torch_frontend_modes import assert_mel_matches, bf16_ulps
from tests.test_torch_frontend_tc import NARROW_MEL_WIDTHS as MEL_WIDTHS
from tests.test_torch_frontend_tc import NARROW_T_STEPS as T_STEPS
from tests.test_torch_frontend_tc import NARROW_WIN_LENS as WIN_LENS
from tests.test_torch_frontend_tc import RATES, SHARED_MAX, split_bar

CSRC = Path(ff.__file__).resolve().parent.parent / "csrc"
TC_FOLDS = ("x3", "f32")  # the tensor-core folds (bf16 runs on the CUDA cores)
PLANES = {"x3": 2, "f32": 3}  # bf16 planes of each tensor-core fold's split
# the layout and mirror configurations: both CONFIGS and 256 mel bands (two groups of 128)
FOLD_CONFIGS = CONFIGS | {"16k 256 mels": dict(signal_sample_rate=16_000, maxFreq=8000.0, n_mels=256)}

torch.set_num_threads(1)


class _Captured(Exception):
    pass


def jax_fold_operands(monkeypatch, cfg: MfccConfig, algorithm: str) -> dict[str, np.ndarray]:
    """wc_in, ws_in and mel_in as the JAX fold hands them to its kernel."""
    seen = {}

    def pallas_call(kern, **kw):
        def launch(*ops):
            seen.update(zip(("wc_in", "ws_in", "mel_in"), (np.asarray(op) for op in ops[4:7])))
            raise _Captured
        return launch

    monkeypatch.setattr(jax_ff.pl, "pallas_call", pallas_call)
    with pytest.raises(_Captured):
        jax_ff.fused_mel_frontend(jnp.zeros((1, 4000), jnp.float32), algorithm=algorithm, fold=True,
                                  **frontend_kwargs(cfg))
    monkeypatch.undo()
    return seen


def design(cfg: MfccConfig) -> tuple:
    return (cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq, cfg.maxFreq)


def noise(cfg: MfccConfig) -> np.ndarray:
    return np.random.default_rng(20260816).standard_normal((2, 24_000)).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("algorithm", ff.FOLD_ALGORITHMS)
def test_fold_weights_bit_identical(monkeypatch, algorithm, name):
    """The folded bases (taper, half weight at sup/2, zero sine row there),
    the zero-mel-bin trim, the Nyquist cosine in the DC slot at 10 kHz and
    the mode stacks equal the JAX fold's kernel operands bit for bit."""
    cfg = MfccConfig(**CONFIGS[name])
    w = ff.fold_weights(*design(cfg), algorithm)
    ops = jax_fold_operands(monkeypatch, cfg, algorithm)
    k = cfg.win_length // 2 + 1
    for key, jax_key in (("wc", "wc_in"), ("ws", "ws_in"), ("melw", "mel_in")):
        want = ops[jax_key].astype(np.float32)
        if algorithm != "x3":
            want = want[0]
        assert w[key].dtype == np.float32 and np.array_equal(w[key], want), key
    assert w["wc"].shape[-2:] == (k, 256) and w["ws"].shape[-2:] == (k, 256)
    assert not w["wc"][..., 0, :].any() and not w["ws"][..., k - 1, :].any()


@pytest.mark.parametrize("name", CONFIGS)
def test_fold_weights_from_jax(monkeypatch, name):
    """convert.fold_weights_from_jax maps the JAX fold's operands onto the
    port's fold_weights exactly, for every algorithm."""
    cfg = MfccConfig(**CONFIGS[name])
    arrays = {alg: jax_fold_operands(monkeypatch, cfg, alg) for alg in ff.FOLD_ALGORITHMS}
    got = convert.fold_weights_from_jax(arrays)
    for alg in ff.FOLD_ALGORITHMS:
        own = ff.fold_weights(*design(cfg), alg)
        assert got[alg].keys() == own.keys()
        for k in own:
            assert got[alg][k].dtype == own[k].dtype and np.array_equal(got[alg][k], own[k]), (alg, k)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("algorithm", ff.FOLD_ALGORITHMS)
def test_fold_plain_matches_jax(algorithm, name):
    """Against JAX's fold in interpret mode on 2 × 24,000 samples of noise:
    f32 within 1e-5 of the largest mel (test_pallas_frontend.py's fold bar)
    and x3 within 1e-4 relative above the top_db floor, with the peaks to
    1e-6 (the f32 summation order is all that differs); bf16 (JAX asked to
    store bf16 mel, as the port does) within one bf16 ulp, the bar of the
    unfolded bf16 mode."""
    cfg = MfccConfig(**CONFIGS[name])
    a = noise(cfg)
    kw = frontend_kwargs(cfg)
    out = {"out_dtype": jnp.bfloat16} if algorithm == "bf16" else {}
    with pltpu.force_tpu_interpret_mode():
        jmel, jbmax = jax_ff.fused_mel_frontend(jnp.asarray(a), algorithm=algorithm, fold=True, **out, **kw)
    mel, bmax = ff.fused_mel_frontend(torch.tensor(a), algorithm=algorithm, fold=True, **kw)
    nf = 1 + a.shape[1] // cfg.hop_length
    assert mel.shape == (2, nf, cfg.n_mels) and bmax.shape == (2, -(-nf // ff.BLOCK_FRAMES))
    jmel = np.asarray(jmel)[:, :nf].astype(np.float32)
    if algorithm == "bf16":
        assert mel.dtype == torch.bfloat16
        assert bf16_ulps(mel.float().numpy(), jmel).max() <= 1.0
        np.testing.assert_allclose(bmax.numpy().max(axis=1), np.asarray(jbmax).max(axis=(1, 2, 3)), rtol=1e-6)
        return
    assert mel.dtype == torch.float32
    if algorithm == "f32":
        assert_mel_matches(mel.numpy(), jmel, np.asarray(jbmax), bmax.numpy())
        return
    # x3 splits the power into bf16 (hi, lo) before the mel projection: a
    # one-ulp f32 difference in a bin's power moves the split, and the peak
    # by up to 2^-16 (measured 2.4e-6 at 16 kHz), chip_smoke.py's x3 bar
    jpeak = np.asarray(jbmax).max(axis=(1, 2, 3))
    live = jmel > 1e-8 * jpeak[:, None, None]
    np.testing.assert_allclose(mel.numpy()[live], jmel[live], rtol=1e-4, atol=0)
    np.testing.assert_allclose(bmax.numpy().max(axis=1), jpeak, rtol=2.0**-16, atol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_fold_plain_matches_unfolded(name):
    """The plain fold equals the port's unfolded plain frontend within 1e-5
    of the largest mel, on noise and on a sine that ends one sample before
    the buffer (the last frame's u = 0 term reads past its support)."""
    cfg = MfccConfig(**CONFIGS[name])
    kw = frontend_kwargs(cfg)
    n = 24_000 - 1
    tone = np.sin(2 * np.pi * 440.0 * np.arange(n) / cfg.signal_sample_rate).astype(np.float32)
    for a in (noise(cfg), tone[None, :]):
        mel_f, bmax_f = ff.fused_mel_frontend(torch.tensor(a), fold=True, **kw)
        mel_u, bmax_u = ff.fused_mel_frontend(torch.tensor(a), **kw)
        scale = float(mel_u.abs().max())
        np.testing.assert_allclose(mel_f.numpy(), mel_u.numpy(), rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(bmax_f.numpy(), bmax_u.numpy(), rtol=1e-5)


def test_fold_guards():
    """The JAX fold's guards (test_pallas_frontend.py::test_fold_geometry_guard
    and fused_mel_frontend's own): hop rows, a window that is not a whole
    number of hops, the fixed-point algorithms and non-float32 audio raise
    ValueError naming the fold; nothing falls back to the unfolded path."""
    cfg = MfccConfig(**CONFIGS["16k"])
    kw = frontend_kwargs(cfg)
    x = torch.zeros((1, 8000))
    with pytest.raises(ValueError, match="fold"):
        ff.fused_mel_frontend(x, **{**kw, "win_length": 444}, fold=True)
    for alg in ("i16", "i24"):
        with pytest.raises(ValueError, match="fold"):
            ff.fused_mel_frontend(x, algorithm=alg, fold=True, **kw)
    with pytest.raises(ValueError, match="fold"):
        ff.fused_mel_frontend(x.to(torch.int16), fold=True, **kw)
    rows = torch.tensor(ff.pack_hop_rows(np.zeros((1, 8000), np.float32), n_fft=cfg.n_fft, hop=cfg.hop_length,
                                         win_length=cfg.win_length))
    with pytest.raises(ValueError, match="fold"):
        ff.fused_mel_frontend(rows, n_samples=8000, fold=True, **kw)
    assert ff.fold_ok(512, 80, 400) and ff.fold_ok(512, 50, 250)
    assert not ff.fold_ok(512, 80, 444) and not ff.fold_ok(512, 5, 250)
    with pytest.raises(ValueError, match="fold"):
        ff.fold_weights(*design(cfg), "i24")


def test_fold_kernel_constants_match_wrapper():
    """The block and tile sizes the wrapper assumes are the fold kernels':
    the FFMA bf16 fold's (fused_frontend_fold.cu, which includes no header
    of the port) and the tensor-core f32 and x3 folds'
    (fused_frontend_fold_tc.cu, tensor_core.cuh)."""
    src = (CSRC / "fused_frontend_fold.cu").read_text()
    assert '#include "' not in src
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kBF"]) == ff.BLOCK_FRAMES
    assert int(consts["kBT"]) == ff._BIN_TILE
    assert int(consts["kMelMax"]) == ff._MEL_MAX
    assert int(consts["kSharedMax"]) == ff.SHARED_MAX
    for alg in ff.FOLD_ALGORITHMS:
        assert (f'extern "C" int fused_mel_fold_{alg}(' in src) == (alg not in TC_FOLDS)
    tc_src = (CSRC / "fused_frontend_fold_tc.cu").read_text()
    assert '#include "tensor_core.cuh"' in tc_src
    c = fold_constants()
    assert c["kBF"] == ff.BLOCK_FRAMES and c["kMelCols"] == ff._MEL_MAX and c["kMelStep"] == ff._MEL_STEP
    assert c["kChunkRows"] == ff._TC_CHUNK and c["kCols"] == ff._TC_COLS and c["kStages"] == ff._TC_STAGES
    assert c["kCols"] // 2 + 16 == ff._TC_PITCH and c["kSharedMax"] == ff.SHARED_MAX == SHARED_MAX
    assert c["kMelLimit"] == ff.MEL_LIMIT
    assert "mma.sync" not in src
    for alg in ff.FOLD_ALGORITHMS:
        assert (f'extern "C" int fused_mel_fold_{alg}(' in tc_src) == (alg in TC_FOLDS)
    assert "mma.sync" in (CSRC / "tensor_core.cuh").read_text() and "mma_bf16" in tc_src


# ---------------------------------------------------------------------------
# The tensor-core folds' host side (f32, x3): plans, layouts, and mirrors of the kernel
# ---------------------------------------------------------------------------


def fold_constants() -> dict[str, int]:
    src = (CSRC / "tensor_core.cuh").read_text() + (CSRC / "fused_frontend_fold_tc.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    consts["kCols"] = 32 * consts["kWN"]  # constexpr int kCols = 32 * kWN
    consts["kTileBins"] = consts["kCols"] // 2  # constexpr int kTileBins = kCols / 2
    return consts


def fold_grid(sr: int) -> list[tuple[int, int, int]]:
    """(hop, window support, n_mels) of every geometry of the narrower grid
    tc_plan's plans were first pinned on (test_torch_frontend_tc's NARROW_*:
    rates 8-48 kHz, tStep to 10 ms, winLen to 40 ms, n_fft the smallest
    power of two ≥ the window and ≥ 512) that fold_ok takes at this rate.
    On the wider grid the f32 and x3 folds find no plan at 44.1 and 48 kHz
    with 20-25 ms hops (hop 882 with a 1,764-sample window and more)."""
    out = []
    for t_step in T_STEPS:
        for win_len in WIN_LENS:
            cfg = MfccConfig(signal_sample_rate=sr, tStep=t_step, winLen=win_len)
            n_fft = max(512, 1 << (cfg.win_length - 1).bit_length())
            if ff.fold_ok(n_fft, cfg.hop_length, cfg.win_length):
                out += [(cfg.hop_length, cfg.win_length, n) for n in MEL_WIDTHS]
    return out


# JAX's fold takes hop 384 (a multiple of 128) with a 3,840-sample window at
# n_fft 4096; the x3 FFMA fold's span overflowed shared memory there
JAX_HOP384 = (4096, 384, 3840)
# 48 kHz at tStep 0.015, winLen 0.03: the widest span of phase 18 (ROADMAP
# C8), where the f32 FFMA fold's block did not fit
C8 = (2048, 720, 1440)
# each tensor-core fold's ladder of (frames, stages, buffers), first fit first
LADDER = {"x3": [(64, 4, 2), (32, 4, 2), (32, 3, 2), (32, 2, 2)],
          "f32": [(64, 4, 2), (64, 3, 2), (64, 2, 2), (32, 4, 2), (32, 3, 2), (32, 2, 2), (32, 2, 1)]}


def launcher_fold_bytes(c: dict[str, int], algorithm: str, hop: int, sup: int, frames: int, stages: int,
                        buffers: int) -> int:
    """The launcher's sum (shared_bytes in the source), from the source's
    constants: barriers, ``stages`` basis chunks, a tile's mel weights, the
    power tile, ``buffers`` buffers of the chunk's s and d planes and the
    FP32 span, the bf16 parts in the mode's planes."""
    planes = PLANES[algorithm]
    span_pad = -(-((frames - 1) * hop + sup + 1) // 4) * 4
    return (128 + stages * c["kChunkRows"] * c["kCols"] * planes * 2 + c["kTileBins"] * planes * c["kMelCols"] * 2
            + planes * frames * (c["kTileBins"] + 16) * 2 + buffers * 2 * planes * c["kChunkRows"] * frames * 2
            + 4 * span_pad)


def first_rung(algorithm: str, hop: int, sup: int, n_mels: int) -> tuple[int, int, int]:
    """The first rung of the mode's ladder whose launcher sum fits a block."""
    c = fold_constants()
    return next(r for r in LADDER[algorithm] if launcher_fold_bytes(c, algorithm, hop, sup, *r) <= SHARED_MAX)


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("algorithm", TC_FOLDS)
def test_fold_plan_fits_every_geometry(algorithm, sr):
    """At every hop, window and mel width of the grid that fold_ok takes at
    this rate, fold_plan gives the first rung of the mode's ladder whose
    launcher sum (from the source's constants) fits the 227 KB of shared
    memory a block may use, with that sum as its bytes; one mel group per
    128 bands. x3's ladder is unchanged: 64 frames with four stages, then 32
    frames with four to two; its flagship keeps 64/4. f32, whose three
    planes need more room, first gives up stages, then frames, then the
    second buffer of its s and d planes: its flagship takes 64/3 (64/4
    needs 249,232 bytes), and C8's 48 kHz hop 720 / window 1440, where even
    32/2 needs 233,424, fits with one buffer (32/2/1)."""
    c = fold_constants()
    geoms = fold_grid(sr)
    if sr == 16_000:
        geoms.append(JAX_HOP384[1:] + (128,))
    if sr == 48_000:
        geoms.append(C8[1:] + (128,))
    for hop, sup, n_mels in geoms:
        plan = ff.fold_plan(algorithm, hop, sup, n_mels)
        rung = first_rung(algorithm, hop, sup, n_mels)
        assert (plan.frames, plan.stages, plan.buffers) == rung, (hop, sup, n_mels, plan)
        assert plan.shared_bytes == launcher_fold_bytes(c, algorithm, hop, sup, *rung) <= SHARED_MAX
        assert plan.mel_groups == -(-n_mels // 128)
    flagship = ff.fold_plan(algorithm, 80, 400, 128)
    want = {"x3": (64, 4, 2), "f32": (64, 3, 2)}[algorithm]
    assert (flagship.frames, flagship.stages, flagship.buffers, flagship.mel_groups) == want + (1,)
    assert ff.fold_ok(*JAX_HOP384) and ff.fold_ok(2048, 320, 1280) and ff.fold_ok(*C8)
    assert ff.fold_plan(algorithm, 320, 1280).frames == 32 and ff.fold_plan(algorithm, 384, 3840).frames == 32
    c8 = ff.fold_plan(algorithm, *C8[1:])
    assert (c8.frames, c8.stages, c8.buffers) == {"x3": (32, 4, 2), "f32": (32, 2, 1)}[algorithm]
    assert launcher_fold_bytes(c, "f32", *C8[1:], 32, 2, 2) == 233_424 > SHARED_MAX
    assert launcher_fold_bytes(c, "f32", 80, 400, 64, 4, 2) == 249_232 > SHARED_MAX
    # the FFMA x3 fold's launcher sum, 4 (span_pad + 20,736 + 16,384) bytes, did not fit at 32 kHz, hop 320
    assert 4 * ((63 * 320 + 1281 + 3) // 4 * 4 + 20_736 + 16_384) > SHARED_MAX


@pytest.mark.parametrize("algorithm", TC_FOLDS)
def test_fold_plan_bytes_are_the_launchers(algorithm):
    """The wrapper's byte sum (fold_plan) equals the launcher's, computed here
    from the source's constants, at every geometry of the grid fold_ok takes,
    at JAX's hop-384 example and at C8's; the plan's rungs are the ones the
    launcher accepts (plan_holds); over the grid the rungs taken are, for x3,
    64/4 at 49 geometries and 32/4 at 5 (its plans before the f32 fold moved
    to the tensor cores), for f32 64/3 at 34, 64/2 at 11, 32/4 at 5, 32/3 at
    3 (hop 384 among them) and 32/2 with one buffer at C8 alone; a width past
    512 bands, and the FFMA fold (bf16, which has no plan), raise."""
    c = fold_constants()
    src = (CSRC / "fused_frontend_fold_tc.cu").read_text()
    assert "(long long)buffers * 2 * planes * kChunkRows * frames * 2" in src and "4LL * span_pad" in src
    assert f"launch_fold<{PLANES[algorithm]}>(" in src.split(f'fused_mel_fold_{algorithm}(', 1)[1].split("}", 1)[0]
    hs = sorted({(hop, sup) for sr in RATES for hop, sup, _ in fold_grid(sr)})
    taken = {}
    for hop, sup in hs + [JAX_HOP384[1:], C8[1:]]:
        for n_mels in (128, 256):
            plan = ff.fold_plan(algorithm, hop, sup, n_mels)
            rung = (plan.frames, plan.stages, plan.buffers)
            assert plan.shared_bytes == launcher_fold_bytes(c, algorithm, hop, sup, *rung)
            assert rung in LADDER[algorithm] and rung[0] in (c["kBF"], c["kBF"] // 2)
            assert 2 <= plan.stages <= c["kStages"]
            assert plan.span_pad == -(-((plan.frames - 1) * hop + sup + 1) // 4) * 4
        taken[rung] = taken.get(rung, 0) + 1
    want = {"x3": {(64, 4, 2): 49, (32, 4, 2): 5},
            "f32": {(64, 3, 2): 34, (64, 2, 2): 11, (32, 4, 2): 5, (32, 3, 2): 3, (32, 2, 1): 1}}[algorithm]
    assert taken == want
    with pytest.raises(ValueError, match="512"):
        ff.fold_plan(algorithm, 80, 400, 513)
    with pytest.raises(ValueError, match="tensor-core"):
        ff.fold_plan("bf16", 80, 400)


def launcher_ffma_bytes(hop: int, sup: int) -> int:
    """The FFMA fold launcher's sum (shared_bytes in fused_frontend_fold.cu),
    from the source's constants: the space the basis slices, the s and d
    slices and the power tile share (shared_floats), the [kBF][kMelMax] mel
    accumulator, and the span of (kBF − 1)·hop + sup + 1 bf16 samples (the
    samples are bf16 values) padded to 4."""
    src = (CSRC / "fused_frontend_fold.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert "constexpr int kPitch = kBF + 4;" in src and "constexpr int kTileSlice = kKC * 2 * kBT;" in src
    assert "2LL * span_pad" in src
    pitch = c["kBF"] + 4
    shared = max(2 * c["kKC"] * 2 * c["kBT"] + 2 * c["kKC"] * pitch, c["kBT"] * pitch)
    span_pad = -(-((c["kBF"] - 1) * hop + sup + 1) // 4) * 4
    return 4 * (shared + c["kBF"] * c["kMelMax"]) + 2 * span_pad


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("algorithm", ("bf16",))
def test_ffma_fold_fits_every_geometry(algorithm, sr):
    """At every hop and window of the grid that fold_ok takes at this rate
    (and at JAX's hop-384 example), the FFMA fold's launcher sum, computed
    here from the source's constants, equals the wrapper's
    (ffma_fold_bytes) and stays within the 227 KB of shared memory a block
    may use. It stages its span as bf16, half the bytes of FP32: it also
    fits 48 kHz at hop 720 with a 1,440-sample window (C8, chip_smoke.py
    phase 18). The f32 and x3 folds have no FFMA kernel."""
    geoms = [(hop, sup) for hop, sup, _ in fold_grid(sr)]
    if sr == 16_000:
        geoms.append(JAX_HOP384[1:])
    for hop, sup in geoms + [C8[1:]]:
        assert ff.ffma_fold_bytes(algorithm, hop, sup) == launcher_ffma_bytes(hop, sup), (hop, sup)
        assert ff.ffma_fold_bytes(algorithm, hop, sup) <= SHARED_MAX, (hop, sup)
    assert ff.fold_ok(*C8)
    for alg in TC_FOLDS:
        with pytest.raises(ValueError, match="FFMA"):
            ff.ffma_fold_bytes(alg, 80, 400)


def fold_config_tensors(algorithm: str, name: str) -> tuple[MfccConfig, dict[str, torch.Tensor]]:
    cfg = MfccConfig(**FOLD_CONFIGS[name])
    return cfg, ff.fold_tensors(algorithm, "cpu", *design(cfg))


@pytest.mark.parametrize("name", FOLD_CONFIGS)
@pytest.mark.parametrize("algorithm", TC_FOLDS)
def test_fold_layouts_round_trip(algorithm, name):
    """pack_fold_basis and pack_tc_mel, then their inverses, give the
    planes of the mode's fold_weights bit for bit (x3: the (hi, lo) stacks;
    f32: the three planes of its exact split): rows past K, sine columns at
    or past im_cols and mel columns past n_mels are zero; each group of 16
    columns holds the cosine, then the sine columns of the same 8 bins; the
    FFMA fold (bf16) has no such layout."""
    cfg, w = fold_config_tensors(algorithm, name)
    fw = ff.fold_weights(*design(cfg), algorithm)
    planes = PLANES[algorithm]
    packed, mel = w["wcs_tc"], w["melw_tc"]
    k, bins = fw["wc"].shape[-2:]
    im_cols = fw["ws"].shape[-1]
    kp = -(-k // 32) * 32
    assert packed.dtype == mel.dtype == torch.bfloat16
    assert packed.shape == (bins // 64, kp // 16, planes, 128, 16)
    assert mel.shape == (-(-cfg.n_mels // 128) * bins // 16, planes, 128, 16)
    wc, ws = ff.unpack_fold_basis(packed, k, im_cols)
    assert torch.equal(wc, ff.tc_planes(algorithm, torch.from_numpy(fw["wc"])))
    assert torch.equal(ws, ff.tc_planes(algorithm, torch.from_numpy(fw["ws"])))
    assert torch.equal(ff.unpack_tc_mel(mel, cfg.n_mels), ff.tc_planes(algorithm, torch.from_numpy(fw["melw"])))
    full_c, full_s = ff.unpack_fold_basis(packed, kp, bins)
    assert not full_c[:, k:].any() and not full_s[:, k:].any() and not full_s[..., im_cols:].any()
    # column 16 q + i of the interleaved rows: bin 8 q + i, cosine for i < 8, sine after
    flat = packed.permute(2, 1, 4, 0, 3).reshape(planes, kp, 2 * bins)[:, :k].float()
    grouped = flat.reshape(planes, k, bins // 8, 2, 8)
    assert torch.equal(grouped[:, :, :, 0].reshape(planes, k, bins), wc)
    assert ff.fold_layouts("bf16", ff.fold_tensors("bf16", "cpu", *design(cfg))) == {}
    if algorithm == "f32":  # the split is exact: its planes sum to the float32 weights
        assert torch.equal(wc.sum(0), torch.from_numpy(fw["wc"])) and torch.equal(ws.sum(0), torch.from_numpy(fw["ws"]))


def plain_sd(audio: torch.Tensor, cfg: MfccConfig, algorithm: str, w: dict) -> tuple:
    """(s, d) [B, nf, K] as the plain version (fused_mel_fold_reference)
    computes them, in float32 before the mode's rounding (fold_operands)."""
    return ff.fold_operands(audio, w["wc"].shape[-2], hop=cfg.hop_length,
                            eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length), algorithm=algorithm)


def staged_span(audio: torch.Tensor, cfg: MfccConfig, b: int, f0: int, frames: int) -> torch.Tensor:
    """The block's FP32 span as the kernel stages it: x[b, f0·hop + off + i]
    for i < span_pad, zero outside the buffer."""
    hop, sup = cfg.hop_length, cfg.win_length
    span_pad = -(-((frames - 1) * hop + sup + 1) // 4) * 4
    idx = f0 * hop - ff.eff_pad(cfg.n_fft, cfg.win_length) + torch.arange(span_pad)
    ok = (idx >= 0) & (idx < audio.shape[1])
    span = torch.where(ok, audio[b, idx.clamp(0, audio.shape[1] - 1)], 0.0)
    return span


def chunk_planes(span: torch.Tensor, c: int, k: int, sup: int, hop: int, frames: int, planes: int) -> tuple:
    """build_chunk mirrored: the FP32 (s, d) of rows [32 c, 32 c + 32) of the
    block's frames, read from the span at f·hop + u and f·hop + sup − u
    (zero past K), and the chunk's planes as the kernel lays them out, plane
    q (s planes, then d planes) at q·32·frames, row u = 32 c + 16 j + kk of
    frame f at (j·frames + f)·16 + kk; x3: (hi, lo); f32: (hi, mid, lo)."""
    lane = torch.arange(32)
    u = 32 * c + lane
    f = torch.arange(frames)[:, None]
    live = u < k
    lo = span[(f * hop + u.clamp(max=k - 1))]
    hi = span[(f * hop + sup - u.clamp(max=k - 1))]
    sv, dv = torch.where(live, lo + hi, 0.0), torch.where(live, lo - hi, 0.0)
    buf = torch.zeros(2 * planes * 32 * frames)
    offs = ((lane // 16) * frames + f) * 16 + lane % 16
    for q, v in enumerate((sv, dv)):
        split = list(ff._split3(v)) if planes == 3 else list(ff._x3_stack(v.numpy()))
        for pl, x in enumerate(split):
            buf[(q * planes + pl) * 32 * frames + offs] = torch.as_tensor(x)
    return sv, dv, buf


@pytest.mark.parametrize("name", FOLD_CONFIGS)
@pytest.mark.parametrize("algorithm", TC_FOLDS)
def test_fold_chunk_build_mirror(algorithm, name):
    """The kernel's chunk build, mirrored on noise that ends inside the last
    block (whose last frames read zeros past the buffer): every block's s
    and d, read from its staged span by index (the reversed end x[a + sup −
    u] included, rows past K zero), equal the plain version's s and d bit
    for bit in both plans (64 and 32 frames a block), and the planes hold
    their split (x3: (hi, lo); f32: (hi, mid, lo), which sum to s and d
    exactly), whose hi plane is the bf16 rounding."""
    cfg, w = fold_config_tensors(algorithm, name)
    audio = torch.tensor(np.random.default_rng(14).standard_normal((2, 3_001)).astype(np.float32))
    s_ref, d_ref = plain_sd(audio, cfg, algorithm, w)
    nf, k = s_ref.shape[1:]
    kp = -(-k // 32) * 32
    planes = PLANES[algorithm]
    for frames in (64, 32):
        for b in range(audio.shape[0]):
            for f0 in range(0, nf, frames):
                span = staged_span(audio, cfg, b, f0, frames)
                n = min(frames, nf - f0)
                for c in range(kp // 32):
                    sv, dv, buf = chunk_planes(span, c, k, cfg.win_length, cfg.hop_length, frames, planes)
                    rows = slice(32 * c, min(32 * c + 32, k))
                    width = rows.stop - rows.start
                    assert torch.equal(sv[:n, :width], s_ref[b, f0 : f0 + n, rows])
                    assert torch.equal(dv[:n, :width], d_ref[b, f0 : f0 + n, rows])
                    assert not sv[:, width:].any() and not dv[:, width:].any()
                    sp = buf.reshape(2 * planes, 2, frames, 16).permute(0, 2, 1, 3).reshape(2 * planes, frames, 32)
                    assert torch.equal(sp[0], ff._bf16r(sv)) and torch.equal(sp[planes], ff._bf16r(dv))
                    if planes == 3:
                        assert torch.equal(sp[:3].sum(0), sv) and torch.equal(sp[3:].sum(0), dv)


# (operand plane, basis plane) of each product the kernel keeps, in its order
PRODUCTS = {2: ((0, 0), (0, 1), (1, 0)), 3: ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))}


def kernel_dft_mirror(buf: torch.Tensor, packed: torch.Tensor, tile: int, c: int, frames: int,
                      planes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of fold_chunk's address arithmetic, mirrored in float64:
    the A fragments of every thread (warp (wm, wn), lane 4g + t, m-tile mt,
    half h: row 16·MT·wm + 16 mt + 8 h + g, elements 4t..4t+3 of step j) from
    the chunk's planes (s for even n-tiles, d for odd), the B fragments
    (column 32 wn + 8 nt + g of the ring stage) from the packed basis, their
    MMAs (the k relabelling is the same for A and B, so the stored order is
    the contraction order), and the mode's products (x3: hi·Whi + hi·Wlo +
    lo·Whi; f32: hi·Whi + hi·Wmid + mid·Whi + hi·Wlo + mid·Wmid + lo·Whi).
    Returns (re, im) [frames, 64] of the tile's bins as the thread of column
    2t + e of n-tiles 2 n2 and 2 n2 + 1 holds them: bin 16 wn + 8 n2 + 2t + e."""
    mt_n = frames // 32
    kp = packed.shape[1] * 16
    stage = packed.reshape(-1).double()[(tile * kp + 32 * c) * 128 * planes:][: 32 * 128 * planes]
    plane = 32 * frames
    out = torch.zeros(2, frames, 64, dtype=torch.float64)  # re, im
    g, t = torch.arange(8)[:, None], torch.arange(4)[None, :]
    e4 = torch.arange(4)

    def mma(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """C[row g_a][col g_b] = sum over (t, element) of A[g_a, t, :]·B[g_b, t, :]."""
        return torch.einsum("ate,bte->ab", x, y)

    for j in range(2):
        for wm in range(2):
            for mt in range(mt_n):
                for h in range(2):
                    row = 16 * mt_n * wm + 16 * mt + 8 * h + g              # [8, 1]
                    a_off = ((j * frames + row) * 16 + 4 * t)[..., None] + e4  # [8, 4, 4]: g, t, element
                    for wn in range(4):
                        for nt in range(4):
                            op = nt & 1
                            col0 = 32 * wn + g
                            b_off = ((j * planes) * 128 + col0 + 8 * nt) * 16 + 4 * t
                            a = [buf[(op * planes + p) * plane + a_off].double() for p in range(planes)]
                            w = [stage[(b_off + p * 128 * 16)[..., None] + e4] for p in range(planes)]
                            cval = sum(mma(a[i], w[pw]) for i, pw in PRODUCTS[planes])
                            bins = 16 * wn + 8 * (nt // 2) + torch.arange(8)
                            out[op, row[:, 0][:, None], bins[None, :]] += cval
    return out[0], out[1]


@pytest.mark.parametrize("name", FOLD_CONFIGS)
@pytest.mark.parametrize("algorithm", TC_FOLDS)
def test_fold_kernel_address_mirror(algorithm, name):
    """The kernel's addressing end to end on one block per plan: the chunk
    planes (build_chunk) and the packed basis (fold_layouts) read as the
    threads read them (fold_chunk), summed over the chunks, give the tile's
    re = s·wc and im = d·ws of the plain version's rounded s and d against
    the unpacked weights, in float64, to 1e-12 of the largest; and the power
    tile written at the kernel's offsets, row·kPitch + bin, is the power of
    the tile's bins in natural order (mel_tile's input)."""
    cfg, w = fold_config_tensors(algorithm, name)
    audio = torch.tensor(np.random.default_rng(41).standard_normal((1, 12_000)).astype(np.float32))
    s_ref, d_ref = plain_sd(audio, cfg, algorithm, w)
    k, planes = s_ref.shape[-1], PLANES[algorithm]
    kp = -(-k // 32) * 32
    wc, ws = (ff.tc_planes(algorithm, torch.as_tensor(w[key])).double() for key in ("wc", "ws"))
    ws = tnf.pad(ws, (0, wc.shape[-1] - ws.shape[-1]))

    def split(x: torch.Tensor) -> list[torch.Tensor]:
        if planes == 3:
            return list(ff._split3(x).double())
        return [torch.as_tensor(v).double() for v in ff._x3_stack(x.numpy())]

    def x3(xs, ws_):
        return sum(xs[i] @ ws_[pw] for i, pw in PRODUCTS[planes])

    for frames in (64, 32):
        f0 = frames  # the second block
        span = staged_span(audio, cfg, 0, f0, frames)
        s_pl, d_pl = split(s_ref[0, f0 : f0 + frames]), split(d_ref[0, f0 : f0 + frames])
        for tile in range(wc.shape[-1] // 64):
            re = torch.zeros(frames, 64, dtype=torch.float64)
            im = torch.zeros_like(re)
            for c in range(kp // 32):
                buf = chunk_planes(span, c, k, cfg.win_length, cfg.hop_length, frames, planes)[2]
                r, i = kernel_dft_mirror(buf, w["wcs_tc"], tile, c, frames, planes)
                re += r
                im += i
            cols = slice(64 * tile, 64 * tile + 64)
            want_re = x3(s_pl, [p[:, cols] for p in wc])
            want_im = x3(d_pl, [p[:, cols] for p in ws])
            scale = float(max(want_re.abs().max(), want_im.abs().max(), 1e-30))
            assert float((re - want_re).abs().max()) <= 1e-12 * scale
            assert float((im - want_im).abs().max()) <= 1e-12 * scale
            # the power tile: thread (wm, mt, h, g; wn, n2, t, e) writes row·80 + 16 wn + 8 n2 + 2t + e
            pw = torch.full((frames, 80), float("nan"), dtype=torch.float64)
            power = re * re + im * im
            for wn in range(4):
                for n2 in range(2):
                    for t in range(4):
                        for e in range(2):
                            col = 16 * wn + 8 * n2 + 2 * t + e
                            pw[:, col] = power[:, col]
            assert torch.equal(pw[:, :64], power) and torch.isnan(pw[:, 64:]).all()


@pytest.mark.parametrize("name", FOLD_CONFIGS)
def test_split3_fold_mirror_no_further_than_plain(name):
    """fused_mel_fold_f32's arithmetic mirrored (split3_fold_mirror: s and d
    split into three exact bf16 planes, six products in float32 matmuls, the
    hi·hi sums added per 16-row step, the power split the same way against
    the mel weights' planes) on 2 × 24,000 samples of noise: its mel is no
    further from the plain fold evaluated in float64 than the plain fold
    (FP32 in 16-row steps) is, above the top_db floor, and its peak within
    1e-5 of the plain version's: chip_smoke.py's bar for the kernel
    (mode_error_ok), which it holds as it holds fused_mel_f32."""
    cfg, w = fold_config_tensors("f32", name)
    audio = torch.tensor(noise(cfg))
    kw = dict(hop=cfg.hop_length, eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length))
    mel, bmax = ff.split3_fold_mirror(audio, w["wc"], w["ws"], w["melw"], **kw)
    want, want_bmax = ff.fused_mel_fold_reference(audio, w["wc"], w["ws"], w["melw"], **kw)
    exact, _ = ff.fused_mel_fold_reference(audio.double(), w["wc"].double(), w["ws"].double(), w["melw"].double(),
                                           **kw)
    _, peak, rel_exact, plain_exact = split_bar(mel, bmax, want, want_bmax, exact)
    assert mel.shape == want.shape and mel.dtype == torch.float32 and bmax.shape == want_bmax.shape
    assert rel_exact <= plain_exact and peak <= 1e-5


# ROADMAP C11: the (rate, hop, window, mode) geometries where the f32 and x3
# folds find no staging plan, all at hops above 128 that are not multiples
# of 128, n_fft 2048
C11 = [(44_100, 882, 1764, "f32"), (44_100, 1102, 1102, "f32"), (44_100, 1102, 1102, "x3"),
       (48_000, 960, 1920, "f32"), (48_000, 1200, 1200, "f32"), (48_000, 1200, 1200, "x3")]


@pytest.mark.parametrize("sr,hop,win,algorithm", C11)
def test_c11_geometries_are_past_jax_fold(sr, hop, win, algorithm):
    """At each C11 geometry the port's fold_ok takes the geometry and its
    plan ladder has no rung (fold_plan raises: on CUDA the fold raises),
    while JAX's fused_mel_frontend(..., fold=True) raises there too, on the
    hop (modulation_mfcc_tpu/pallas/fused_frontend.py:619-620) before its
    fold branch: the port raises where JAX raises, so C11 is no fault of
    the port against JAX."""
    n_fft = 2048
    assert ff.fold_ok(n_fft, hop, win)
    with pytest.raises(ValueError, match="no staging plan fits"):
        ff.fold_plan(algorithm, hop, win)
    with pytest.raises(ValueError, match=f"hop {hop} > 128 must be a multiple of 128"):
        jax_ff.fused_mel_frontend(jnp.zeros((1, 4 * n_fft), jnp.float32), sr=float(sr), n_fft=n_fft, hop=hop,
                                  win_length=win, algorithm=algorithm, fold=True)
