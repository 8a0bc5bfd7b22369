"""PyTorch port: the fused-frontend module (kernels/fused_frontend.py) against
the JAX Pallas frontend, run as its own tests run it on the CPU (interpret
mode). On the CPU the wrappers take their plain PyTorch versions; the CUDA
kernels themselves are checked on the card by chip_smoke.py."""
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import modulation_mfcc_tpu.pallas.fused_frontend as jax_ff
from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff
from modulation_mfcc_tpu_torch.models.config import MfccConfig

torch.set_num_threads(1)

CONFIGS = {
    "10k": dict(signal_sample_rate=10_000),
    "16k": dict(signal_sample_rate=16_000, maxFreq=8000.0),
}


def frontend_kwargs(cfg: MfccConfig) -> dict:
    return dict(sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, hop=cfg.hop_length,
                win_length=cfg.win_length, n_mels=cfg.n_mels, fmin=cfg.minFreq, fmax=cfg.maxFreq)


class _Captured(Exception):
    pass


def jax_frontend_weights(cfg: MfccConfig) -> tuple[np.ndarray, np.ndarray]:
    """(wri, melw) exactly as the JAX frontend hands them to its f32 kernel:
    the Pallas launch is intercepted and its weight operands returned."""
    seen = {}

    def capture(kern, **kw):
        seen.update(kw)
        raise _Captured

    with mock.patch.object(jax_ff, "_launch", capture), pytest.raises(_Captured):
        jax_ff.fused_mel_frontend(jnp.zeros((1, 4000), jnp.float32), algorithm="f32",
                                  **frontend_kwargs(cfg))
    wri_in, mel_in = seen["extra_ops"]
    return np.asarray(wri_in)[0], np.asarray(mel_in)[0]


@pytest.fixture(scope="module")
def audio():
    return np.random.default_rng(20260816).standard_normal((2, 24_000)).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_frontend_weights_bit_identical(name):
    """Window-support trim, zero-mel-bin trim and Nyquist packing: the port's
    packed bases and mel matrix equal the JAX kernel operands bit for bit."""
    cfg = MfccConfig(**CONFIGS[name])
    wri, melw = ff.frontend_weights(cfg.signal_sample_rate, cfg.n_fft, cfg.win_length,
                                    cfg.n_mels, cfg.minFreq, cfg.maxFreq)
    jwri, jmelw = jax_frontend_weights(cfg)
    assert wri.dtype == jwri.dtype == np.float32 and np.array_equal(wri, jwri)
    assert melw.dtype == jmelw.dtype == np.float32 and np.array_equal(melw, jmelw)
    assert wri.shape == (cfg.win_length, 512) and melw.shape == (256, 128)


@pytest.mark.parametrize("name", CONFIGS)
def test_fused_mel_frontend_matches_jax(audio, name):
    """mel within 1e-5 of the largest mel value (the JAX frontend tests'
    convention, test_pallas_frontend.py::test_folded_matches_unfolded) and
    within 1e-4 relative on every entry above the top_db floor, where f32
    cancellation in bins 80 dB down reaches 2.5e-5; the per-utterance peak
    (max over valid frames) to 1e-6 of the float64 peak of the same design,
    and no further from it than JAX's. The port's f32 DFT sums in 16-row
    steps and JAX's in one dot, so their peaks may differ by the sum of
    both roundings (measured 1.0e-6 at 16 kHz: port 3.0e-7 from float64,
    JAX 7.0e-7)."""
    cfg = MfccConfig(**CONFIGS[name])
    kw = frontend_kwargs(cfg)
    with pltpu.force_tpu_interpret_mode():
        jmel, jbmax = jax_ff.fused_mel_frontend(jnp.asarray(audio), **kw)
    mel, bmax = ff.fused_mel_frontend(torch.tensor(audio), **kw)
    mel, nf = mel.numpy(), 1 + audio.shape[1] // cfg.hop_length
    jmel = np.asarray(jmel)[:, :nf]
    assert mel.shape == jmel.shape
    jpeak = np.asarray(jbmax).max(axis=(1, 2, 3))
    np.testing.assert_allclose(mel, jmel, rtol=0, atol=1e-5 * jpeak.max())
    live = jmel > 1e-8 * jpeak[:, None, None]
    np.testing.assert_allclose(mel[live], jmel[live], rtol=1e-4, atol=0)
    wri, melw = (torch.tensor(a, dtype=torch.float64) for a in ff.frontend_weights(
        cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq, cfg.maxFreq))
    _, bmax64 = ff.fused_mel_frontend_reference(torch.tensor(audio, dtype=torch.float64), wri, melw,
                                                hop=cfg.hop_length, eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length))
    peak64 = bmax64.amax(dim=1).numpy()
    peak = bmax.amax(dim=1).numpy()
    np.testing.assert_allclose(peak, peak64, rtol=1e-6, atol=0)
    assert (np.abs(peak - peak64) <= np.abs(jpeak - peak64)).all()
    assert bmax.shape == (2, -(-nf // ff.BLOCK_FRAMES))


@pytest.mark.parametrize("name", CONFIGS)
def test_fft_mirror_matches_jax(audio, name):
    """The FFT kernel's arithmetic (fft_frontend_mirror; the kernel equals it
    bit for bit on the card) against the JAX f32 frontend at the bars its
    plain version meets: mel within 1e-5 of the largest mel value and within
    1e-4 relative above the top_db floor; the per-utterance peak within
    1e-6 of the float64 peak of the same design."""
    cfg = MfccConfig(**CONFIGS[name])
    kw = frontend_kwargs(cfg)
    with pltpu.force_tpu_interpret_mode():
        jmel, jbmax = jax_ff.fused_mel_frontend(jnp.asarray(audio), **kw)
    design = (cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq, cfg.maxFreq)
    w = ff.fft_weights(*design)
    mel, bmax = ff.fft_frontend_mirror(torch.tensor(audio), *(torch.tensor(w[k]) for k in ff.FFT_KEYS),
                                       hop=cfg.hop_length, eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length))
    mel, nf = mel.numpy(), 1 + audio.shape[1] // cfg.hop_length
    jmel = np.asarray(jmel)[:, :nf]
    assert mel.shape == jmel.shape
    jpeak = np.asarray(jbmax).max(axis=(1, 2, 3))
    np.testing.assert_allclose(mel, jmel, rtol=0, atol=1e-5 * jpeak.max())
    live = jmel > 1e-8 * jpeak[:, None, None]
    np.testing.assert_allclose(mel[live], jmel[live], rtol=1e-4, atol=0)
    wri, melw = (torch.tensor(a, dtype=torch.float64) for a in ff.frontend_weights(*design))
    _, bmax64 = ff.fused_mel_frontend_reference(torch.tensor(audio, dtype=torch.float64), wri, melw,
                                                hop=cfg.hop_length, eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length))
    np.testing.assert_allclose(bmax.amax(dim=1).numpy(), bmax64.amax(dim=1).numpy(), rtol=1e-6, atol=0)
    assert bmax.shape == (2, -(-nf // ff.BLOCK_FRAMES))


@pytest.mark.parametrize("masked", [False, True], ids=["peak", "masked_peak"])
@pytest.mark.parametrize("transposed", [False, True], ids=["frame_major", "coef_major"])
@pytest.mark.parametrize("name", CONFIGS)
def test_fused_mfcc_matches_jax(audio, name, transposed, masked):
    """MFCC ≤ 1e-4 against JAX fused_mfcc in both layouts, with the peak from
    the block maxes or from a frame mask. The JAX package's own f32 gap
    between its fft and Pallas spectra is 6.9e-5 on values up to 226."""
    cfg = MfccConfig(**CONFIGS[name])
    kw = frontend_kwargs(cfg)
    kw.pop("n_mels")
    nf = 1 + audio.shape[1] // cfg.hop_length
    mask = None
    if masked:
        mask = np.ones((2, nf), np.float32)
        mask[1, nf // 2 :] = 0.0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_ff.fused_mfcc(
            jnp.asarray(audio), frame_mask=None if mask is None else jnp.asarray(mask),
            transposed=transposed, **kw,
        ))
    got = ff.fused_mfcc(
        torch.tensor(audio), frame_mask=None if mask is None else torch.tensor(mask),
        transposed=transposed, **kw,
    ).numpy()
    assert got.shape == want.shape == ((2, 13, nf) if transposed else (2, nf, 13))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_cpu_tensors_never_launch_kernels(audio):
    """A CPU tensor takes the plain version: the launch counters stay put."""
    before = dict(ff.LAUNCHES)
    cfg = MfccConfig(**CONFIGS["16k"])
    kw = frontend_kwargs(cfg)
    kw.pop("n_mels")
    out = ff.fused_mfcc(torch.tensor(audio), transposed=True, **kw)
    assert torch.isfinite(out).all()
    assert ff.LAUNCHES == before


def test_plain_versions_compose_like_the_wrappers(audio):
    """fused_mfcc on the CPU is exactly the two plain versions composed."""
    cfg = MfccConfig(**CONFIGS["10k"])
    wri, melw = (torch.tensor(a) for a in ff.frontend_weights(
        cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq, cfg.maxFreq))
    dct = torch.tensor(ff.tail_dct(cfg.n_mfcc, cfg.n_mels))
    mel, bmax = ff.fused_mel_frontend_reference(torch.tensor(audio), wri, melw, hop=cfg.hop_length,
                                                eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length))
    peak = 10.0 * torch.log10(torch.clamp(bmax.amax(dim=1), min=1e-10))
    want = ff.mfcc_tail_reference(mel, peak, dct, transposed=True)
    got = ff.fused_mfcc(torch.tensor(audio), sr=cfg.signal_sample_rate, hop=cfg.hop_length,
                        win_length=cfg.win_length, fmax=cfg.maxFreq, transposed=True)
    assert torch.equal(got, want)
    assert torch.equal(bmax.amax(dim=1), mel.amax(dim=(1, 2)))


def test_wrapper_geometry_matches_cuda_source():
    """The block and tile sizes the wrappers assume are the kernels' own
    (the f32 fold's, fused_frontend_fold.cu; the tail's, fused_frontend.cu;
    the FFT kernel's, fused_frontend_fft.cu: its frames a block, threads,
    points a thread, staged mel columns, band limit, shared memory and the
    n_fft it takes)."""
    csrc = Path(ff.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "fused_frontend_fold.cu").read_text() + (csrc / "fused_frontend.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kBF"]) == ff.BLOCK_FRAMES
    assert int(consts["kBT"]) == ff._BIN_TILE
    assert int(consts["kMelMax"]) == ff._MEL_MAX
    assert int(consts["kTailMelLimit"]) == ff.MEL_LIMIT
    fft = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", (csrc / "fused_frontend_fft.cu").read_text())}
    assert fft["kBF"] == ff.BLOCK_FRAMES and fft["kFftMelCols"] == ff._MEL_MAX and fft["kMelLimit"] == ff.MEL_LIMIT
    assert fft["kFftThreads"] == ff._FFT_THREADS and fft["kFftRadix"] == ff._FFT_RADIX
    assert fft["kSharedMax"] == ff.SHARED_MAX
    assert ff.FFT_SIZES == tuple(2 << k for k in range(fft["kFftMinLog"], fft["kFftMaxLog"] + 1))


@pytest.mark.parametrize("kw, seconds", [
    (dict(signal_sample_rate=44_100, n_fft=2048, tStep=0.02), 2.0),
    (dict(signal_sample_rate=48_000, n_fft=4096, tStep=0.03, winLen=0.064), 3.0),
], ids=["44.1k hop 882", "48k hop 1440 window 3072"])
def test_mfcc_change_matches_jax_fft_at_long_hops(kw, seconds):
    """At a 20 ms hop at 44.1 kHz and a 30 ms hop with a 64 ms window at
    48 kHz, where fused_mel_f32 takes the streamed plan on the card (the
    span outgrows the other rungs), the port's default mfcc_change on the
    CPU (the plain version of its 'fused' spectrum) matches the JAX
    package's default 'fft' mfcc_change within 1e-5, inside this file's
    1e-4 MFCC bar (measured 1.4e-6 and 1.7e-6)."""
    from modulation_mfcc_tpu.models import modulation as jax_mod
    from modulation_mfcc_tpu.models.config import MfccConfig as JaxMfccConfig
    from modulation_mfcc_tpu_torch import mfcc_change

    cfg = MfccConfig(**kw)
    kp = -(-cfg.win_length // 32) * 32
    assert ff.tc_plan("f32", cfg.hop_length, kp, cfg.n_mels).streamed == 1
    y = np.random.default_rng(20260816).standard_normal((2, int(seconds * cfg.signal_sample_rate))).astype(np.float32)
    want = np.asarray(jax_mod.mfcc_change(jnp.asarray(y), JaxMfccConfig(**kw), spectrum="fft"))
    got = mfcc_change(torch.tensor(y), cfg).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 1 + y.shape[1] // cfg.hop_length)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
