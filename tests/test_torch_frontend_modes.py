"""PyTorch port: the frontend's arithmetic modes (bf16, x3, i16, i24) and the
hop-rows input against the JAX Pallas frontend, run as its own tests run it
on the CPU (interpret mode). The host designs and the per-utterance scales
are compared bit for bit with the operands the JAX frontend hands its
kernels (its launch is intercepted); the plain versions (what the wrappers
take on the CPU) are held to the JAX frontend tests' bars. The CUDA kernels
themselves are checked on the card by chip_smoke.py (phase 14)."""
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import modulation_mfcc_tpu.pallas.fused_frontend as jax_ff
from modulation_mfcc_tpu.models import modulation as jax_mod
from modulation_mfcc_tpu.models.config import MfccConfig as JaxMfccConfig
from modulation_mfcc_tpu.ops.framing import frame_signal as jax_frame_signal
from modulation_mfcc_tpu.ops.spectral import dft_bases, mel_filterbank
from modulation_mfcc_tpu.ops.spectral import mfcc_from_frames as jax_mfcc_from_frames
from modulation_mfcc_tpu.oracle import get_mfccs_change_np
from modulation_mfcc_tpu_torch import convert
from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff
from modulation_mfcc_tpu_torch.models import modulation as mod
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from tests.test_torch_frontend import CONFIGS, frontend_kwargs
from tests.test_torch_frontend_tc import bf16_mirror_audio, bf16_tc_mirror

torch.set_num_threads(1)

MODES = ("bf16", "x3", "i16", "i24")
FLAGSHIP = CONFIGS["16k"]


class _Captured(Exception):
    pass


def jax_operands(audio: np.ndarray, cfg: MfccConfig, algorithm: str, n_samples=None) -> list[np.ndarray]:
    """The operands after the audio that the JAX frontend hands its kernel
    for ``algorithm`` (its launch intercepted)."""
    seen = {}

    def capture(kern, **kw):
        seen.update(kw)
        raise _Captured

    with mock.patch.object(jax_ff, "_launch", capture), pytest.raises(_Captured):
        jax_ff.fused_mel_frontend(jnp.asarray(audio), algorithm=algorithm, n_samples=n_samples,
                                  **frontend_kwargs(cfg))
    return [np.asarray(op) for op in seen["extra_ops"]]


def design(cfg: MfccConfig) -> tuple:
    return (cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq, cfg.maxFreq)


def jax_reference_mfcc(a: np.ndarray) -> np.ndarray:
    """The JAX frontend tests' rfft reference at the 16 kHz configuration."""
    return np.asarray(jax_mfcc_from_frames(
        jax_frame_signal(jnp.asarray(a), 512, 80), sr=16_000.0, n_fft=512, win_length=400,
        fmin=100.0, fmax=8000.0, use_fft=True,
    ))


def port_mfcc(a, algorithm: str) -> np.ndarray:
    return ff.fused_mfcc(torch.as_tensor(a), sr=16_000.0, hop=80, win_length=400, fmax=8000.0,
                         algorithm=algorithm).numpy()


def pcm_sets(seed: int, n: int) -> np.ndarray:
    """int16 rows: full-scale noise with a −32768 sample, a quiet (about
    −60 dBFS) utterance, silence."""
    rng = np.random.default_rng(seed)
    loud = rng.integers(-32768, 32768, n)
    loud[17] = -32768
    return np.stack([loud, rng.integers(-33, 34, n), np.zeros(n)]).astype(np.int16)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("algorithm", MODES)
def test_mode_designs_bit_identical(algorithm, name):
    """The bf16 plane, the x3 (hi, lo) stacks, the int8 weight planes (with
    np.round's half-to-even rule), Sw and the i16 offset correction equal the
    JAX kernel operands bit for bit."""
    cfg = MfccConfig(**CONFIGS[name])
    w = ff.mode_weights(algorithm, *design(cfg))
    ops = jax_operands(np.zeros((1, 4000), np.float32), cfg, algorithm)
    wri, _ = jax_ff_weights(cfg)
    if algorithm in ("bf16", "x3"):
        wri_in, mel_in = ops
        if algorithm == "bf16":
            wri_in, mel_in = wri_in[0], mel_in[0]
        assert np.array_equal(w["wri"], wri_in.astype(np.float32))
        assert np.array_equal(w["melw"], mel_in.astype(np.float32))
        assert w["wri"].dtype == w["melw"].dtype == np.float32
        return
    sw = jax_ff._int8_weight_planes(wri)[3]
    assert w["sw"].dtype == np.float32 and w["sw"] == np.float32(sw)
    if algorithm == "i16":
        _sc, corr, wa, wb, wc, mel_in = ops
        assert np.array_equal(w["corr"], corr[0]) and not corr[1:].any()
        lo = (w["planes"][2], w["planes"][1])
    else:
        _sc, wa, wb, wc, mel_in = ops
        lo = (w["planes"][2], w["planes"][1], w["planes"][0])
    planes = w["planes"]
    assert planes.dtype == np.int8 and planes.shape == (3, *wri.shape)
    assert np.array_equal(planes[0], wa)
    assert np.array_equal(np.concatenate([planes[1], planes[0]]), wb)
    assert np.array_equal(np.concatenate(lo), wc)
    assert np.array_equal(w["melw"], mel_in.astype(np.float32))


def jax_ff_weights(cfg: MfccConfig) -> tuple[np.ndarray, np.ndarray]:
    ops = jax_operands(np.zeros((1, 4000), np.float32), cfg, "f32")
    return ops[0][0], ops[1][0]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("algorithm", ["i16", "i24"])
def test_scales_bit_identical(algorithm, name):
    """The per-utterance scales (s, 1/(s·Sw)) equal JAX's bit for bit: on
    float32 audio (noise, a −32768 sample, −60 dBFS, silence) and on int16
    hop rows, where the pad zeros are part of the reduction; the i16 scale is
    an exact power of two."""
    cfg = MfccConfig(**CONFIGS[name])
    pcm = pcm_sets(5, 6_000)
    noise = (np.random.default_rng(6).standard_normal((1, 6_000)) * 0.3).astype(np.float32)
    flat = np.concatenate([pcm.astype(np.float32) / 32768.0, noise])
    sw = torch.tensor(ff.mode_weights(algorithm, *design(cfg))["sw"])
    got = ff.quant_scales(torch.tensor(flat), algorithm, sw).numpy()
    want = jax_operands(flat, cfg, algorithm)[0]
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    rows = jax_ff.pack_hop_rows(pcm, n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length, blkf=1024)
    got = ff.quant_scales(torch.tensor(rows), algorithm, sw).numpy()
    want = jax_operands(rows, cfg, algorithm, n_samples=pcm.shape[1])[0]
    assert np.array_equal(got, want)
    if algorithm == "i16":
        assert (np.frexp(got[:, 0])[0] == 0.5).all() and got[2, 0] == 2.0**60


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("n", [4_000, 24_000, 123_457])
def test_hop_rows_bit_identical(name, n):
    """hop_rows_geometry and pack_hop_rows give the JAX package's batch
    shape and bytes (its default frame block of 1024), int16 and float32."""
    cfg = MfccConfig(**CONFIGS[name])
    geo = dict(n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length)
    assert ff.hop_rows_geometry(n, **geo) == jax_ff.hop_rows_geometry(n, blkf=1024, **geo)
    rng = np.random.default_rng(n)
    for a in (rng.integers(-32768, 32768, (2, n)).astype(np.int16), rng.standard_normal((2, n)).astype(np.float32)):
        got, want = ff.pack_hop_rows(a, **geo), jax_ff.pack_hop_rows(a, blkf=1024, **geo)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert torch.equal(ff.pack_hop_rows(torch.tensor(a), **geo), torch.tensor(want))


@pytest.mark.parametrize("algorithm", ff.ALGORITHMS)
def test_rows_input_equals_flat(algorithm):
    """int16 hop rows give bitwise the flat int16 and the flat dequantized
    float32 results, and the block maxima too."""
    cfg = MfccConfig(**FLAGSHIP)
    pcm = pcm_sets(8, 9_000)
    kw = dict(frontend_kwargs(cfg), algorithm=algorithm)
    rows = ff.pack_hop_rows(pcm, n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length)
    want = ff.fused_mel_frontend(torch.tensor(pcm.astype(np.float32) / 32768.0), **kw)
    for x, n in ((torch.tensor(pcm), None), (torch.tensor(rows), pcm.shape[1])):
        got = ff.fused_mel_frontend(x, n_samples=n, **kw)
        assert got[0].dtype == (torch.bfloat16 if algorithm == "bf16" else torch.float32)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def assert_mel_matches(mel: np.ndarray, jmel: np.ndarray, jbmax: np.ndarray, bmax: np.ndarray) -> None:
    """test_torch_frontend's bars: within 1e-5 of the largest mel, 1e-4
    relative above the top_db floor, the peak to 1e-6."""
    jpeak = jbmax.max(axis=(1, 2, 3))
    np.testing.assert_allclose(mel, jmel, rtol=0, atol=1e-5 * jpeak.max())
    live = jmel > 1e-8 * jpeak[:, None, None]
    np.testing.assert_allclose(mel[live], jmel[live], rtol=1e-4, atol=0)
    np.testing.assert_allclose(bmax.max(axis=1), jpeak, rtol=1e-6, atol=0)


@pytest.mark.parametrize("algorithm", ["i16", "i24"])
def test_fixed_point_plain_matches_jax(algorithm):
    """i16 on int16-origin noise, i24 on float noise (2 × 24,000 samples at
    16 kHz): mel equal to JAX's to f32 summation order (the digit products
    are exact in both; measured ≤ 3.3e-6 of the peak, 1.5e-5 relative above
    the top_db floor), MFCC ≤ 1e-4 against the rfft reference (measured
    5.5e-5 for i16, 6.3e-5 for i24)."""
    if algorithm == "i16":  # the fixtures of the JAX tests test_i16_matches_f32_grade_on_int16_audio
        rng = np.random.default_rng(20260818)  # and test_i24_matches_f32_grade
        a = (rng.integers(-32768, 32768, (2, 24_000)).astype(np.float32) / 32768.0)
    else:
        a = np.random.default_rng(20260816).standard_normal((2, 24_000)).astype(np.float32)
    cfg = MfccConfig(**FLAGSHIP)
    kw = frontend_kwargs(cfg)
    with pltpu.force_tpu_interpret_mode():
        jmel, jbmax = jax_ff.fused_mel_frontend(jnp.asarray(a), algorithm=algorithm, **kw)
    mel, bmax = ff.fused_mel_frontend(torch.tensor(a), algorithm=algorithm, **kw)
    nf = mel.shape[1]
    assert_mel_matches(mel.numpy(), np.asarray(jmel)[:, :nf], np.asarray(jbmax), bmax.numpy())
    np.testing.assert_allclose(port_mfcc(a, algorithm), jax_reference_mfcc(a), rtol=0, atol=1e-4)


def test_i16_quiet_utterance():
    """The JAX frontend tests' worst case for i16: a −60 dBFS utterance
    (every X a multiple of 256, x0 ≡ −128) beside a loud one. Mel ≤ 2e-4
    relative to the float64 oracle (measured 1.40e-4, as JAX's), MFCC
    ≤ 5e-4 against the rfft reference (measured 3.7e-4; the f32 ulp of
    c0 ≈ 679 bounds it)."""
    rng = np.random.default_rng(7)
    pcm = np.stack([rng.integers(-32768, 32768, 24_000), rng.integers(-33, 34, 24_000)]).astype(np.int16)
    a64 = pcm.astype(np.float64) / 32768.0
    a = a64.astype(np.float32)
    mel, _ = ff.fused_mel_frontend(torch.tensor(a), sr=16_000.0, hop=80, win_length=400, fmax=8000.0,
                                   algorithm="i16")
    wr, wi = dft_bases(512, "hann", 400)
    m = mel_filterbank(16_000.0, 512, 128, 100.0, 8000.0)
    pad = np.pad(a64, ((0, 0), (256, 256)))
    nf = 1 + 24_000 // 80
    fr = np.stack([[pad[r, i * 80 : i * 80 + 512] for i in range(nf)] for r in range(2)])
    want_mel = ((fr @ wr) ** 2 + (fr @ wi) ** 2) @ m.T
    rel = (mel.numpy().astype(np.float64) - want_mel) / np.maximum(np.abs(want_mel), 1e-300)
    assert np.abs(rel).max() <= 2e-4
    np.testing.assert_allclose(port_mfcc(a, "i16"), jax_reference_mfcc(a), rtol=0, atol=5e-4)


def speech_2s(sr: int = 16_000) -> np.ndarray:
    """The signal of the JAX frontend test test_x3_end_to_end_error_budget."""
    rng = np.random.default_rng(20260816)
    t = np.arange(int(2.0 * sr)) / sr
    phase = 2 * np.pi * np.cumsum(120.0 + 30.0 * np.sin(2 * np.pi * 2.5 * t)) / sr
    sig = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t - np.pi / 2))
    return (sig * env + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def test_x3_plain_matches_jax_and_contracts():
    """x3: mel equal to JAX's to f32 summation order (measured 1.8e-5
    relative above the top_db floor); MFCC < 2e-2 against the rfft
    reference and not f32-exact (measured 2.4e-4); mfcc_change < 1e-4
    against the float64 oracle on speech (measured 1.6e-5, JAX's 1.7e-5)."""
    a = np.random.default_rng(20260816).standard_normal((2, 24_000)).astype(np.float32)
    cfg = MfccConfig(**FLAGSHIP)
    kw = frontend_kwargs(cfg)
    with pltpu.force_tpu_interpret_mode():
        jmel, jbmax = jax_ff.fused_mel_frontend(jnp.asarray(a), algorithm="x3", **kw)
    mel, bmax = ff.fused_mel_frontend(torch.tensor(a), algorithm="x3", **kw)
    nf = mel.shape[1]
    assert_mel_matches(mel.numpy(), np.asarray(jmel)[:, :nf], np.asarray(jbmax), bmax.numpy())
    err = np.abs(port_mfcc(a, "x3") - jax_reference_mfcc(a)).max()
    assert 1e-6 < err < 2e-2, err
    sig = speech_2s()
    want, _ = get_mfccs_change_np(sig.astype(np.float64), 16_000, max_freq=8000.0)
    got = mod.mfcc_change(torch.tensor(sig), cfg, spectrum="fused_x3").numpy()
    assert np.abs(got - want).max() < 1e-4


def bf16_ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got − want| in units of want's bf16 ulp (2^(e−8), want = m·2^e)."""
    ulp = np.ldexp(1.0, np.frexp(want.astype(np.float64))[1] - 8)
    return np.abs(got.astype(np.float64) - want.astype(np.float64)) / np.where(want > 0, ulp, 1.0)


def test_bf16_plain_matches_jax_and_contract():
    """bf16: the mel (stored bf16) within one bf16 ulp of JAX's (measured
    1.0 on 1.3e-5 of the entries, equal elsewhere: f32 sums of bf16
    products in another order round apart only at a bf16 rounding
    boundary), the f32 block maxima to 1e-6; mfcc_change on the JAX test's
    1.5 s signal within 1e-1 of the fft path and not f32-exact (measured
    9.9e-3), and within 1e-4 of JAX's (measured 6.6e-6)."""
    a = np.random.default_rng(20260816).standard_normal((2, 24_000)).astype(np.float32)
    cfg = MfccConfig(**FLAGSHIP)
    kw = frontend_kwargs(cfg)
    with pltpu.force_tpu_interpret_mode():
        jmel, jbmax = jax_ff.fused_mel_frontend(jnp.asarray(a), algorithm="bf16", out_dtype=jnp.bfloat16, **kw)
    mel, bmax = ff.fused_mel_frontend(torch.tensor(a), algorithm="bf16", **kw)
    nf = mel.shape[1]
    assert mel.dtype == torch.bfloat16
    jmel = np.asarray(jmel)[:, :nf].astype(np.float32)
    assert bf16_ulps(mel.float().numpy(), jmel).max() <= 1.0
    np.testing.assert_allclose(bmax.numpy().max(axis=1), np.asarray(jbmax).max(axis=(1, 2, 3)), rtol=1e-6)

    sr = 16_000
    rng = np.random.default_rng(0)
    t = np.arange(int(1.5 * sr)) / sr
    y = sum((0.6 / k) * np.sin(2 * np.pi * k * 140 * t) for k in range(1, 6))
    y = y * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 1e-2 * rng.standard_normal(len(t))
    y = torch.tensor(y, dtype=torch.float32)[None, :]
    want = mod.mfcc_change(y, cfg, spectrum="fft").numpy()
    got = mod.mfcc_change(y, cfg, spectrum="fused_bf16").numpy()
    err = np.abs(got - want).max()
    assert 1e-6 < err < 1e-1, err
    with pltpu.force_tpu_interpret_mode():
        jgot = np.asarray(jax_mod.mfcc_change(jnp.asarray(y.numpy()), JaxMfccConfig(**FLAGSHIP),
                                              spectrum="pallas_bf16"))
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_bf16_tensor_core_mirror_matches_jax(name):
    """fused_mel_bf16's tensor-core arithmetic, mirrored
    (tests/test_torch_frontend_tc.bf16_tc_mirror: bf16 samples, the DFT
    from the packed basis, the bf16 power, the one-pass mel from the packed
    mel weights, the bf16 store, the maxima over the FP32 mel), within one
    bf16 ulp of the JAX frontend's bf16 mode (interpret mode) at both
    configurations, on noise and on speech-like audio; the block maxima to
    1e-6."""
    cfg = MfccConfig(**CONFIGS[name])
    w = ff.mode_tensors("bf16", "cpu", *design(cfg))
    audio = bf16_mirror_audio(cfg)
    mel, bmax = bf16_tc_mirror(audio, cfg, w)
    with pltpu.force_tpu_interpret_mode():
        jmel, jbmax = jax_ff.fused_mel_frontend(jnp.asarray(audio.numpy()), algorithm="bf16",
                                                out_dtype=jnp.bfloat16, **frontend_kwargs(cfg))
    jmel = np.asarray(jmel)[:, : mel.shape[1]].astype(np.float32)
    assert bf16_ulps(mel.float().numpy(), jmel).max() <= 1.0
    np.testing.assert_allclose(bmax.numpy().max(axis=1), np.asarray(jbmax).max(axis=(1, 2, 3)), rtol=1e-6)


def test_tail_reads_bf16_mel_as_float32():
    """The tail widens a bf16 mel to float32 first, as the JAX tail does."""
    mel = torch.rand((2, 30, 128)).to(torch.bfloat16)
    peak = torch.tensor([3.0, -2.0])
    dct = torch.tensor(ff.tail_dct(13, 128))
    assert torch.equal(ff.mfcc_tail(mel, peak, 13, dct=dct), ff.mfcc_tail(mel.float(), peak, 13, dct=dct))


@pytest.mark.parametrize("name", CONFIGS)
def test_frontend_modes_from_jax(name):
    """convert.frontend_modes_from_jax maps the JAX package's constants onto
    the port's mode weights exactly."""
    cfg = MfccConfig(**CONFIGS[name])
    wri, melw = jax_ff_weights(cfg)
    w2, w1, w0, sw = jax_ff._int8_weight_planes(wri)
    arrays = {
        "wri_bf16": np.asarray(jax_ff._stack_weights(wri, "bf16"))[0],
        "melw_bf16": np.asarray(jax_ff._stack_weights(melw, "bf16"))[0],
        "wri_x3": np.asarray(jax_ff._stack_weights(wri, "x3")),
        "melw_x3": np.asarray(jax_ff._stack_weights(melw, "x3")),
        "w2": w2, "w1": w1, "w0": w0, "sw": sw,
        "corr": jax_operands(np.zeros((1, 4000), np.float32), cfg, "i16")[1],
    }
    got = convert.frontend_modes_from_jax(arrays)
    for alg in MODES:
        own = ff.mode_weights(alg, *design(cfg))
        assert got[alg].keys() == own.keys()
        for k in own:
            assert got[alg][k].dtype == own[k].dtype and np.array_equal(got[alg][k], own[k]), (alg, k)


def test_spectra_names_and_validation():
    """The port's fused spectra map onto the JAX frontend modes; hop rows
    need a fused spectrum and n_samples of their geometry."""
    assert mod.FUSED == {"fused": "f32", "fused_bf16": "bf16", "fused_x3": "x3", "fused_i16": "i16",
                         "fused_i24": "i24"}
    cfg = MfccConfig(**FLAGSHIP)
    rows = torch.zeros((1, 1040, 80), dtype=torch.int16)
    with pytest.raises(ValueError, match="fused spectrum"):
        mod.mfcc_trajectories(rows, cfg, spectrum="fft", n_samples=4000)
    with pytest.raises(ValueError, match="n_samples"):
        ff.fused_mel_frontend(rows, **frontend_kwargs(cfg))
    with pytest.raises(ValueError, match="geometry"):
        ff.fused_mel_frontend(rows, n_samples=200_000, **frontend_kwargs(cfg))
    with pytest.raises(ValueError, match="algorithm"):
        ff.fused_mel_frontend(torch.zeros((1, 4000)), algorithm="f16", **frontend_kwargs(cfg))
