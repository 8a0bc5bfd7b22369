"""PyTorch port: the 'f32' frontend's FFT route (kernels/fused_frontend.py
``fft_ok``, ``fft_weights``, ``fft_frontend_mirror``; the CUDA kernel
``fused_mel_fft_f32`` in csrc/fused_frontend_fft.cu).

The CPU tests hold the rule that picks the route over the geometries the
reference configures, the kernel's constants against the design they come
from, and the kernel's arithmetic (its mirror) against float64. The tests
marked ``card`` hold the kernel to its mirror bit for bit and the route to
its launch counts; they skip without CUDA and run on the card with

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_frontend_fft.py

(this file imports no JAX, which the card's machine lacks)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.ops.spectral import analysis_window, mel_filterbank

torch.set_num_threads(1)

CSRC = Path(ff.__file__).resolve().parent.parent / "csrc"
CONFIGS = {
    "10k": dict(signal_sample_rate=10_000),
    "16k": dict(signal_sample_rate=16_000, maxFreq=8000.0),
}
# the geometry-breadth hazards: rates, hops, n_fft with and without a power of two, bands
RATES = (8_000, 11_025, 16_000, 22_050, 32_000, 44_100, 48_000)
HOP_MS = (5, 10, 15, 20, 25, 30)
N_FFTS = (200, 256, 400, 512, 1000, 1024, 1500, 2048, 3000, 4096)
MEL_WIDTHS = (40, 128, 257, 512)
# one geometry at each n_fft the FFT kernel takes, and an odd hop: (label, MfccConfig kwargs, bands)
FFT_GEOMETRIES = (
    ("8 kHz n_fft 256", dict(signal_sample_rate=8_000, n_fft=256), 40),
    ("16 kHz n_fft 512", CONFIGS["16k"], 128),
    ("11.025 kHz n_fft 512 (odd hop)", dict(signal_sample_rate=11_025), 64),
    ("22.05 kHz n_fft 1024", dict(signal_sample_rate=22_050, n_fft=1024), 128),
    ("48 kHz n_fft 2048", dict(signal_sample_rate=48_000, n_fft=2048), 512),
)


def source_constants() -> dict[str, int]:
    src = (CSRC / "fused_frontend_fft.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def launcher_bytes(c: dict[str, int], n_fft: int, hop: int) -> int:
    """The launcher's shared_bytes from the source's constants: the
    exchange, the power rows, the warps' maxima, the span."""
    m = n_fft // 2
    frames = c["kFftThreads"] * c["kFftRadix"] // m

    def r16(n):
        return (n + 15) // 16 * 16

    return (frames * (m + m // 16) * 16 + r16(frames * (m + 1) * 4) + 4 * c["kFftThreads"] // 32
            + r16(((c["kBF"] - 1) * hop + n_fft) * 4))


def design(cfg: MfccConfig, n_mels: int) -> tuple:
    return cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, n_mels, cfg.minFreq, cfg.maxFreq


def fft_tensors(cfg: MfccConfig, n_mels: int, device="cpu") -> tuple[torch.Tensor, ...]:
    w = ff.fft_weights(*design(cfg, n_mels))
    return tuple(torch.as_tensor(w[k], device=device) for k in ff.FFT_KEYS)


def mirror(audio: torch.Tensor, cfg: MfccConfig, n_mels: int, n_samples: int | None = None):
    return ff.fft_frontend_mirror(audio, *fft_tensors(cfg, n_mels), hop=cfg.hop_length,
                                  eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length), n_samples=n_samples)


def noise(n_utt: int, n: int, seed: int) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal((n_utt, n))).astype(np.float32)


def tone_over_quiet_noise(n: int, sr: float, seed: int) -> np.ndarray:
    """A loud tone over noise 54 dB under it: most mel entries lie 60-80 dB
    under the peak, just above the top_db floor, where float32 rounding of
    the frame's energy shows."""
    t = np.arange(n) / sr
    quiet = 1e-3 * np.random.default_rng(seed).standard_normal(n)
    return (0.5 * np.sin(2 * np.pi * 440.0 * t) + quiet).astype(np.float32)


def float64_mel(x: np.ndarray, cfg: MfccConfig, n_mels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(mel, block maxima) of the frontend's function in float64 from
    float64 constants: centred frames (zero outside the audio), the float64
    analysis window, numpy's real FFT, the power, and the design's mel
    weights (their float32 values, widened) over every bin."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    xp = np.pad(x.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2)))
    idx = np.arange(1 + x.shape[1] // hop)[:, None] * hop + np.arange(n_fft)
    spec = np.fft.rfft(xp[:, idx] * analysis_window(n_fft, "hann", cfg.win_length), axis=-1)
    bank = mel_filterbank(cfg.signal_sample_rate, n_fft, n_mels, cfg.minFreq, cfg.maxFreq).astype(np.float32)
    return ff._with_block_max(torch.tensor((spec.real**2 + spec.imag**2) @ bank.T.astype(np.float64)))


def rel_above_floor(mel: torch.Tensor, mel64: torch.Tensor) -> float:
    """The largest relative distance of ``mel`` from ``mel64`` over the
    entries above 1e-8 of their utterance's peak (the top_db floor)."""
    live = mel64 > 1e-8 * mel64.amax(dim=(1, 2))[:, None, None]
    return float(((mel.double() - mel64).abs() / mel64)[live].max())


# ---------------------------------------------------------------------------
# CPU: the rule, the constants, the arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft", N_FFTS)
@pytest.mark.parametrize("sr", RATES)
def test_fft_ok_decisions(sr, n_fft):
    """fft_ok takes exactly the power-of-two n_fft from 256 to 2048 whose
    block fits shared memory by the launcher's own sum, at every hop of
    5-30 ms, a 25 ms window (within n_fft) and 40-512 bands; the bytes it
    checks are the launcher's; where it takes a hop it takes every shorter
    one; and a window past n_fft is refused."""
    c = source_constants()
    win = min(n_fft, round(0.025 * sr))
    sizes = tuple(2 << k for k in range(c["kFftMinLog"], c["kFftMaxLog"] + 1))
    assert sizes == ff.FFT_SIZES
    for n_mels in MEL_WIDTHS:
        taken = []
        for ms in HOP_MS:
            hop = round(ms * sr / 1000)
            ok = ff.fft_ok(n_fft, hop, win, n_mels)
            if n_fft in sizes:
                assert ff.fft_shared_bytes(n_fft, hop) == launcher_bytes(c, n_fft, hop)
            assert ok == (n_fft in sizes and launcher_bytes(c, n_fft, hop) <= c["kSharedMax"]), (hop, n_mels)
            taken.append(ok)
        assert taken == sorted(taken, reverse=True)  # a longer hop is never taken where a shorter one is not
    assert not ff.fft_ok(n_fft, 80, n_fft + 1, 128)
    assert not ff.fft_ok(n_fft, 80, win, 513)


def test_fft_ok_keeps_the_tensor_core_kernel_where_it_must():
    """The cells' geometries take the FFT kernel; the streamed rung's long
    hops (44.1 kHz with a 20 ms hop at n_fft 2048, 48 kHz with a 30 ms hop
    and a 64 ms window at n_fft 4096) and a non-power-of-two n_fft keep the
    tensor-core kernel, whose plan is the streamed one there."""
    for kw in CONFIGS.values():
        cfg = MfccConfig(**kw)
        assert ff.fft_ok(cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.n_mels)
    for kw in (dict(signal_sample_rate=44_100, n_fft=2048, tStep=0.02),
               dict(signal_sample_rate=48_000, n_fft=4096, tStep=0.03, winLen=0.064)):
        cfg = MfccConfig(**kw)
        assert not ff.fft_ok(cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.n_mels)
        kp = -(-cfg.win_length // 32) * 32
        assert ff.tc_plan("f32", cfg.hop_length, kp, cfg.n_mels).streamed == 1
    assert not ff.fft_ok(400, 80, 400, 128)


def test_fft_wrapper_constants_match_cuda_source():
    """The block's frames, threads, points a thread, mel width and limits
    are the kernel's own."""
    c = source_constants()
    assert c["kBF"] == ff.BLOCK_FRAMES and c["kFftThreads"] == ff._FFT_THREADS and c["kFftRadix"] == ff._FFT_RADIX
    assert c["kFftMelCols"] == ff._MEL_MAX and c["kMelLimit"] == ff.MEL_LIMIT and c["kSharedMax"] == ff.SHARED_MAX


@pytest.mark.parametrize("n_fft", ff.FFT_SIZES)
def test_fft_radices_cover_the_transform(n_fft):
    """Radix 16 while 16 divides what is left, then 2, 4 or 8; each pass
    16 points a thread of the M / 16 a frame."""
    m = n_fft // 2
    r = ff.fft_radices(m)
    assert int(np.prod(r)) == m and all(x == 16 for x in r[:-1]) and r[-1] in (2, 4, 8, 16)


WEIGHT_GEOMETRIES = FFT_GEOMETRIES + (("10 kHz (Nyquist packed)", CONFIGS["10k"], 128),)


@pytest.mark.parametrize("label, kw, n_mels", WEIGHT_GEOMETRIES, ids=[g[0] for g in WEIGHT_GEOMETRIES])
def test_fft_weights_are_the_design(label, kw, n_mels):
    """The window pairs are the analysis window, the twiddles W_M^k and
    W_N^k (to M/2; then by symmetry) the float64 values, unrounded, as the
    kernel's FP64 FFT reads them (the second pass's their copies);
    the band table reads back the
    frontend's melw bit for bit (Nyquist from the DC slot where it is
    packed), each band's bins contiguous, at most two weights a bin, and
    every live bin inside [lo, hi)."""
    cfg = MfccConfig(**kw)
    w = ff.fft_weights(*design(cfg, n_mels))
    m = cfg.n_fft // 2
    tab, bands, wts = w["fft_tab"], w["fft_bands"], w["fft_w"]
    assert tab.dtype == np.float64 and wts.dtype == np.float32 and bands.dtype == np.int32
    assert np.array_equal(tab[:m].reshape(-1), analysis_window(cfg.n_fft, "hann", cfg.win_length))
    k = np.arange(m + 1)
    assert np.array_equal(tab[m : 2 * m, 0], np.cos(2 * np.pi * k[:m] / m))
    h = m // 2 + 1  # W_N^k to M/2, then W_N^(M−k) = (−W.re, W.im), the symmetry the kernel's pairs of bins use
    assert np.array_equal(tab[2 * m : 2 * m + h, 1], -np.sin(2 * np.pi * k[:h] / cfg.n_fft))
    assert np.array_equal(tab[2 * m + h : 3 * m + 1], tab[2 * m + m - h : 2 * m - 1 : -1] * (-1, 1))
    q = np.arange(16)  # the second pass's twiddles: W_M entries, laid out [16, 16]
    step = m // (16 * ff.fft_radices(m)[1])
    assert np.array_equal(tab[3 * m + 1 :], tab[m + np.outer(q, q).reshape(-1) * step % m])
    _, melw = ff.frontend_weights(*design(cfg, n_mels))
    lo, hi = bands[0]
    rows = np.zeros((m + 1, n_mels), np.float32)
    for c in range(n_mels):
        s, o, e = bands[1 + c, 0] + lo, bands[1 + c, 1], bands[2 + c, 1]
        rows[s : s + e - o, c] = wts[o:e]
        assert e == o or lo <= s and s + e - o <= hi
    packed = ff._mel_design(cfg.signal_sample_rate, cfg.n_fft, n_mels, cfg.minFreq, cfg.maxFreq)[2]
    assert packed == (melw.shape[0] == m and melw[0].any()) and (packed or not label.startswith("10 kHz"))
    want = np.concatenate([melw[:1] * 0, melw[1:m], melw[:1]]) if packed else melw[: m + 1]
    assert np.array_equal(rows[: want.shape[0]], want) and not rows[want.shape[0]:].any()
    assert wts.size == bands[-1, 1] <= 2 * (m + 1) and (wts > 0).all()


@pytest.mark.parametrize("label, kw, n_mels", FFT_GEOMETRIES, ids=[g[0] for g in FFT_GEOMETRIES])
def test_fft_mirror_against_float64(label, kw, n_mels):
    """At every n_fft the kernel takes (each radix sequence) and an odd hop,
    on noise and on a tone over quiet noise, the mirror's mel is the float64
    function (float64_mel) to the float32 rounding of the power and the mel
    sum: within 2e-6 relative above the top_db floor and nearer there than
    the plain version (the stepped FP32 DFT lands up to 5e-4 away on the
    tone, an FFT in FP32 about as far), within 1e-6 of the peak everywhere,
    its peak within 1e-6."""
    cfg = MfccConfig(**kw)
    n = int(0.6 * cfg.signal_sample_rate)
    x = np.stack([noise(1, n, seed=7)[0], tone_over_quiet_noise(n, cfg.signal_sample_rate, seed=7)])
    mel, bmax = mirror(torch.tensor(x), cfg, n_mels)
    mel64, bmax64 = float64_mel(x, cfg, n_mels)
    wri, melw = (torch.tensor(a) for a in ff.frontend_weights(*design(cfg, n_mels)))
    plain, _ = ff.fused_mel_frontend_reference(torch.tensor(x), wri, melw, hop=cfg.hop_length,
                                               eff_pad=ff.eff_pad(cfg.n_fft, cfg.win_length))
    peak = bmax64.amax(dim=1)
    assert mel.dtype == torch.float32 and mel.shape == mel64.shape and bmax.shape == bmax64.shape
    assert float(((mel.double() - mel64).abs() / peak[:, None, None]).max()) <= 1e-6
    assert rel_above_floor(mel, mel64) <= min(2e-6, rel_above_floor(plain, mel64))
    assert float(((bmax.amax(dim=1).double() - peak).abs() / peak).max()) <= 1e-6


@pytest.mark.parametrize("name", CONFIGS)
def test_fft_mirror_rows_and_int16_equal_flat(name):
    """The mirror frames hop rows (ragged n_samples) and int16 PCM as it
    frames flat float32: bit for bit."""
    cfg = MfccConfig(**CONFIGS[name])
    n = int(0.8 * cfg.signal_sample_rate) + 37
    pcm = np.clip(np.round(noise(2, n, seed=3) * 32768), -32768, 32767).astype(np.int16)
    flat = mirror(torch.tensor(pcm.astype(np.float32) / 32768), cfg, cfg.n_mels)
    for audio in (torch.tensor(pcm), torch.tensor(ff.pack_hop_rows(pcm, n_fft=cfg.n_fft, hop=cfg.hop_length,
                                                                   win_length=cfg.win_length))):
        got = mirror(audio, cfg, cfg.n_mels, n_samples=n if audio.ndim == 3 else None)
        assert all(torch.equal(a, b) for a, b in zip(got, flat))


def test_fft_route_stays_plain_on_the_cpu():
    """On the CPU the 'f32' frontend keeps the stepped FP32 DFT (its plain
    version) and launches nothing; the module's buffers and mode_tensors
    carry the FFT constants where fft_ok takes the geometry and no
    tensor-core layouts there, and the layouts and no FFT constants at a
    geometry it refuses."""
    cfg = MfccConfig(**CONFIGS["16k"])
    x = torch.tensor(noise(1, 4000, seed=5))
    w = ff.mode_tensors("f32", "cpu", *design(cfg, cfg.n_mels))
    before = dict(ff.LAUNCHES)
    got = ff.fused_mel_frontend(x, sr=16_000, hop=80, win_length=400, fmax=8000.0, weights=w)
    want = ff.fused_mel_frontend_reference(x, w["wri"], w["melw"], hop=80, eff_pad=ff.eff_pad(512, 400))
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and ff.LAUNCHES == before
    from modulation_mfcc_tpu_torch.models.modulation import MfccChange

    module = MfccChange(cfg).frontend_weights("f32")
    assert all(torch.equal(module[k], w[k]) for k in ff.FFT_KEYS)
    assert not any(k.endswith("_tc") for k in (*w, *module))
    refused = ff.mode_tensors("f32", "cpu", 16_000, n_fft=400, win_length=400)
    assert not set(ff.FFT_KEYS) & set(refused) and {"wri_tc", "melw_tc"} <= set(refused)


@pytest.mark.parametrize("name", CONFIGS)
def test_fft_launch_needs_its_constants(name, monkeypatch):
    """On the FFT kernel's route, weights without its constants raise
    before anything is launched, naming them and mode_tensors; the route
    reads nothing of the tensor-core layouts."""
    monkeypatch.setattr(ff, "route", lambda t, name: True)
    cfg = MfccConfig(**CONFIGS[name])
    w = ff.mode_tensors("f32", "cpu", *design(cfg, cfg.n_mels), hop=cfg.hop_length)
    bare = {k: v for k, v in w.items() if k not in ff.FFT_KEYS}
    x = torch.zeros((1, 4000), dtype=torch.float32)
    before = dict(ff.LAUNCHES)
    with pytest.raises(ValueError, match="FFT constants.*mode_tensors"):
        ff.fused_mel_frontend(x, sr=cfg.signal_sample_rate, hop=cfg.hop_length, win_length=cfg.win_length,
                              fmin=cfg.minFreq, fmax=cfg.maxFreq, weights=bare)
    assert ff.LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def kernel_mel(audio: torch.Tensor, cfg: MfccConfig, n_mels: int, n_samples: int | None = None):
    w = ff.mode_tensors("f32", audio.device, *design(cfg, n_mels))
    return ff.fused_mel_frontend(audio, sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, hop=cfg.hop_length,
                                 win_length=cfg.win_length, n_mels=n_mels, n_samples=n_samples, weights=w)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.card
@pytest.mark.parametrize("n_mels", (40, 128, 512))
@pytest.mark.parametrize("label, kw, _", FFT_GEOMETRIES, ids=[g[0] for g in FFT_GEOMETRIES])
def test_fft_kernel_is_its_mirror_bit_for_bit(dev, label, kw, _, n_mels):
    """fused_mel_fft_f32's mel and block maxima equal its mirror's bit for
    bit at every n_fft it takes, at an odd hop (unaligned frames) and at
    40, 128 and 512 bands, on float32 flat
    audio and on int16 hop rows of a ragged length (not a whole number of
    hops), one launch each."""
    cfg = MfccConfig(**kw)
    n = int(1.1 * cfg.signal_sample_rate) + 29
    x = noise(3, n, seed=11)
    pcm = np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    rows = ff.pack_hop_rows(pcm, n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length)
    for audio, n_samples in ((x, None), (rows, n)):
        before = dict(ff.LAUNCHES)
        got = kernel_mel(torch.tensor(audio, device=dev), cfg, n_mels, n_samples)
        torch.cuda.synchronize()
        assert ff.LAUNCHES["fused_mel_fft_f32"] == before["fused_mel_fft_f32"] + 1
        assert ff.LAUNCHES["fused_mel_f32"] == before["fused_mel_f32"]
        want = mirror(torch.tensor(audio), cfg, n_mels, n_samples)
        assert all(same_bits(a, b) for a, b in zip(got, want)), (label, n_mels, audio.dtype)


@pytest.mark.card
@pytest.mark.parametrize("name", CONFIGS)
def test_fft_route_with_frame_masks(dev, name):
    """fused_mfcc on the card (the FFT kernel, then the tail) with a frame
    mask over a ragged batch: the MFCC within 1e-4 (the tail kernel's bar
    against its plain version) of the mirror's mel through the plain tail,
    the peak from the masked mel."""
    cfg = MfccConfig(**CONFIGS[name])
    x = noise(2, int(1.5 * cfg.signal_sample_rate), seed=13)
    nf = 1 + x.shape[1] // cfg.hop_length
    mask = np.ones((2, nf), np.float32)
    mask[1, nf // 3 :] = 0.0
    kw = dict(sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length,
              fmin=cfg.minFreq, fmax=cfg.maxFreq)
    got = ff.fused_mfcc(torch.tensor(x, device=dev), frame_mask=torch.tensor(mask, device=dev), transposed=True, **kw)
    mel, _ = mirror(torch.tensor(x), cfg, cfg.n_mels)
    pmax = torch.amax(torch.where(torch.tensor(mask)[..., None] > 0, mel, 0.0), dim=(1, 2))
    peak = 10.0 * torch.log10(torch.clamp(pmax, min=1e-10))
    want = ff.mfcc_tail_reference(mel, peak, torch.tensor(ff.tail_dct(cfg.n_mfcc, cfg.n_mels)), transposed=True)
    assert float((got.cpu() - want).abs().max()) <= 1e-4


@pytest.mark.card
def test_fft_route_launch_counts(dev):
    """mfcc_change launches fused_mel_fft_f32 and not fused_mel_f32 at both
    cells' geometries; at a non-power-of-two n_fft it launches
    fused_mel_f32 and not the FFT kernel."""
    import modulation_mfcc_tpu_torch as mt

    for kw, fft in ((CONFIGS["16k"], True), (CONFIGS["10k"], True),
                    (dict(signal_sample_rate=16_000, maxFreq=8000.0, n_fft=400), False)):
        cfg = MfccConfig(**kw)
        y = torch.tensor(noise(2, 3 * cfg.signal_sample_rate, seed=17), device=dev)
        before = dict(ff.LAUNCHES)
        tot = mt.mfcc_change(y, cfg)
        torch.cuda.synchronize()
        n_fft_kernel = ff.LAUNCHES["fused_mel_fft_f32"] - before["fused_mel_fft_f32"]
        n_tc = ff.LAUNCHES["fused_mel_f32"] - before["fused_mel_f32"]
        assert (n_fft_kernel, n_tc) == ((1, 0) if fft else (0, 1)), kw
        assert bool(torch.isfinite(tot).all())


@pytest.mark.card
def test_fft_refused_launch_raises(dev, monkeypatch):
    """The launcher checks the shared memory it is given against its own
    sum: a launch it refuses raises, and counts nothing."""
    cfg = MfccConfig(**CONFIGS["16k"])
    x = torch.tensor(noise(1, 8000, seed=19), device=dev)
    real = ff.fft_shared_bytes
    monkeypatch.setattr(ff, "fft_shared_bytes", lambda *a: real(*a) + 16)
    before = dict(ff.LAUNCHES)
    with pytest.raises(RuntimeError, match="fused_mel_fft_f32 launch failed"):
        kernel_mel(x, cfg, cfg.n_mels)
    assert ff.LAUNCHES == before
