"""PyTorch port: the scan route's masked zero-phase Butterworth
(kernels/masked_scan.py; the CUDA kernel ``masked_sosfiltfilt_f64`` in
csrc/masked_scan.cu).

The CPU tests hold the wrapper's plain version (the per-sample loop of
``ops/masked.masked_sosfiltfilt`` in float64) to scipy's ``sosfiltfilt`` of
each row's valid prefix, the kernel's per-row order (its mirror) to the
plain version bit for bit, and ``batched_mfcc_change``'s scan route at
TIMIT lengths to the float64 oracle. The tests marked ``card`` hold the
kernel to the plain version bit for bit and the route to its launch count;
they skip without CUDA and run on the card with

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_masked_scan.py

(this file imports no JAX, which the card's machine lacks)."""
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sps
import torch
from torch.profiler import ProfilerActivity, profile

import modulation_mfcc_tpu_torch as mt
from modulation_mfcc_tpu_torch.kernels import masked_scan as MS
from modulation_mfcc_tpu_torch.models.modulation import MfccChange, min_frames_for_fir
from modulation_mfcc_tpu_torch.ops import filters as F
from modulation_mfcc_tpu_torch.ops.masked import masked_gradient, masked_sosfiltfilt
from modulation_mfcc_tpu_torch.oracle import get_mfccs_change_np
from modulation_mfcc_tpu_torch.parallel.batch import batched_mfcc_change
from modulation_mfcc_tpu_torch.utils import obs

torch.set_num_threads(1)

CFG = mt.MfccConfig(signal_sample_rate=16_000, maxFreq=8000.0)  # the timit16k configuration's analysis
SOS, ZI, PADLEN = F.design_butter_sos(6, (12.0 / 100.0,), "lowpass")  # the 12 Hz low-pass at 200 frames/s
NF = 820  # the frames of a 4.1 s bucket (65,536 samples at hop 80)
CSRC = Path(MS.__file__).resolve().parent.parent / "csrc" / "masked_scan.cu"
# valid frames: padlen + 1 (the shortest scipy takes), 100, 615 (3.1 s), the last scan length, the first FIR one
LENGTHS = (PADLEN + 1, 100, 615, 743, 744)


def rows(b: int, c: int, t: int, seed: int) -> torch.Tensor:
    """Trajectory-like float32 rows [b, c, t]: a slow random walk plus noise."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.standard_normal((b, c, t)), axis=-1) * 0.1 + rng.standard_normal((b, c, t))
    return torch.tensor(walk.astype(np.float32))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32)))


def plain(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The loop as MfccChange ran it before the kernel: float64, rounded once."""
    length = lengths[:, None] if x.ndim == 3 else lengths
    return masked_sosfiltfilt(SOS, ZI, PADLEN, x.double(), length).to(x.dtype)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


def test_source_constants():
    src = CSRC.read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kMaxSections"] == MS.MAX_SECTIONS
    assert "__fmaf" not in src and "fma(" not in src  # every product and sum rounded on its own
    assert MS.scratch_elems(1, NF, PADLEN) == 32 * (NF + 2 * PADLEN)
    assert MS.scratch_elems(12_288, NF, PADLEN) == 12_288 * (NF + 2 * PADLEN)


@pytest.mark.parametrize("c", (1, 12))
@pytest.mark.parametrize("lengths", [(n, n) for n in LENGTHS] + [LENGTHS], ids=[*map(str, LENGTHS), "mixed"])
def test_plain_version_is_scipy_per_row(lengths, c):
    """The wrapper's plain version on float64 rows is scipy's sosfiltfilt of
    each row's valid prefix, zeros past it, and is the loop itself; on
    float32 rows it is the loop in float64 rounded once."""
    b = len(lengths)
    x = rows(b, c, NF, seed=sum(lengths) + c)
    ln = torch.tensor(lengths)
    x64 = x.double() if c > 1 else x[:, 0].double()
    got = MS.masked_sosfiltfilt_f64(SOS, ZI, PADLEN, x64, ln)
    loop = masked_sosfiltfilt(SOS, ZI, PADLEN, x64, ln[:, None] if c > 1 else ln)
    assert got.dtype == torch.float64 and torch.equal(got, loop)
    got = got.reshape(b, c, NF).numpy()
    for i, n in enumerate(lengths):
        want = sps.sosfiltfilt(SOS, x.double().numpy()[i, :, :n], axis=-1)
        scale = np.abs(want).max()
        assert np.abs(got[i, :, :n] - want).max() <= 1e-12 * scale
        assert not got[i, :, n:].any()
    x32 = x if c > 1 else x[:, 0]
    assert same_bits(MS.masked_sosfiltfilt_f64(SOS, ZI, PADLEN, x32, ln), plain(x32, ln))


@pytest.mark.parametrize("padlen", (PADLEN, 0, 200))
def test_mirror_is_the_plain_version_bit_for_bit(padlen):
    """The kernel's per-row order (odd extension as the kernel reads it, a
    sample through every section in turn, the backward pass over the
    forward outputs in reverse) equals the loop bit for bit, at the cell's
    lengths and at lengths the route never takes (0, 1, shorter than
    padlen, the whole buffer)."""
    t = 160
    lengths = np.array([0, 1, 5, PADLEN + 1, 100, t])
    x = rows(len(lengths), 1, t, seed=padlen)[:, 0]
    want = masked_sosfiltfilt(SOS, ZI, padlen, x.double(), torch.tensor(lengths)).to(torch.float32)
    assert same_bits(torch.tensor(MS.masked_scan_mirror(SOS, ZI, padlen, x.numpy(), lengths)), want)


def test_mirror_at_the_cells_lengths():
    lengths = np.array(LENGTHS)
    x = rows(len(lengths), 1, NF, seed=5)[:, 0]
    got = torch.tensor(MS.masked_scan_mirror(SOS, ZI, PADLEN, x.numpy(), lengths))
    assert same_bits(got, plain(x, torch.tensor(lengths)))


# the gradient norm summed in two orders: C positive squares, each order within (C - 1) units of roundoff of
# the exact sum, the root halving that, the root's and the division's roundings two more units each way
GRAD_NORM_RTOL = ((12 - 1) + 4) * 2.0**-24


def grad_norm_mirror(x: np.ndarray, lengths) -> np.ndarray:
    """masked_grad_norm_f32's arithmetic in float32, in its order: each
    frame's two samples (the gradient's edges at 0 and L - 1), the halved
    central difference between, the squares summed over c in increasing c,
    the root, the division by C; zeros past each length."""
    b, c, t = x.shape
    out = np.zeros((b, t), np.float32)
    for i in range(b):
        n = min(max(int(lengths[i]), 0), t)
        for j in range(n):
            first, last = j == 0, j == n - 1
            hi = 1 if first else n - 1 if last else min(j + 1, t - 1)
            lo = 0 if first else max(n - 2, 0) if last else j - 1
            acc = np.float32(0.0)
            for k in range(c):
                g = np.float32(x[i, k, hi] - x[i, k, lo])
                if not (first or last):
                    g = np.float32(g / np.float32(2.0))
                acc = np.float32(acc + np.float32(g * g))
            out[i, j] = np.float32(np.sqrt(acc) / np.float32(c))
    return out


@pytest.mark.parametrize("lengths", [(1, 2, 3, 40), (PADLEN + 1, 39, 40, 17)], ids=["short", "ragged"])
def test_grad_norm_plain_and_mirror(lengths):
    """The gradient norm's plain version is the torch ops the trajectory
    stage ran before it (masked_gradient, square, sum, root, division), and
    the kernel's order (its mirror) lands within the roundoff of summing in
    another order (GRAD_NORM_RTOL), at lengths 1, 2 and 3 (the edges meet)
    and at the whole buffer."""
    x = rows(len(lengths), 12, 40, seed=sum(lengths))
    ln = torch.tensor(lengths)
    got = MS.masked_grad_norm(x, ln)
    g = masked_gradient(x, ln[:, None])
    assert torch.equal(got, torch.sqrt(torch.sum(g * g, dim=-2)) / 12)
    mirror = torch.tensor(grad_norm_mirror(x.numpy(), lengths))
    assert torch.allclose(mirror, got, rtol=GRAD_NORM_RTOL, atol=0.0)
    assert all(not got[i, n:].any() for i, n in enumerate(lengths))


def speechlike_pcm(lengths, sr: int, seed: int) -> np.ndarray:
    """int16 [B, max length]: a gliding f0's harmonics under a 3-5 Hz
    envelope plus noise, silent 0.1 s at each edge, zero past each length."""
    rng = np.random.default_rng(seed)
    t_pad = max(lengths)
    t = np.arange(t_pad) / sr
    out = np.zeros((len(lengths), t_pad), np.int16)
    for i, n in enumerate(lengths):
        f0 = rng.uniform(90, 220) + 30 * np.sin(2 * np.pi * rng.uniform(1.5, 3.5) * t)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        x = sum(0.6 / k * np.sin(k * phase) for k in range(1, 6))
        x *= 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 5) * t - np.pi / 2))
        x += rng.uniform(0.003, 0.03) * rng.standard_normal(t_pad)
        edge = min(int(0.1 * sr), n // 4)
        x[:edge] = 0.0
        x[n - edge :] = 0.0
        x *= rng.uniform(0.25, 0.9) / np.abs(x).max()
        out[i] = np.round(x * 32767.0).astype(np.int16)
    return out


def test_batched_scan_route_against_the_oracle():
    """batched_mfcc_change(masked_fir=False) on int16 speech-like audio at
    TIMIT lengths (1.2-3.7 s, all below min_frames_for_fir) against the
    float64 oracle of each utterance alone, within the timit16k cell's
    tot_err limit (1e-3 of the utterance's largest value); the scan spans
    record the loop."""
    lengths = [19_200, 33_000, 47_000, 59_200]
    assert all(1 + n // CFG.hop_length < min_frames_for_fir(CFG) for n in lengths)
    pcm = speechlike_pcm(lengths, CFG.signal_sample_rate, seed=24)
    batch = mt.AudioBatch(torch.tensor(pcm), torch.tensor(lengths))
    seen = {r.id for r in obs.spans()}
    with profile(activities=[ProfilerActivity.CPU]):
        tot, mask = batched_mfcc_change(batch, CFG)
    scans = {r.name: r.attrs for r in obs.spans() if r.id not in seen and r.name.endswith(".scan")}
    assert scans == {"trajectory.filter.scan": {"rows": 4 * 12, "frames": tot.shape[1], "route": "loop"},
                     "trajectory.out.scan": {"rows": 4, "frames": tot.shape[1], "route": "loop"}}
    for i, n in enumerate(lengths):
        nf = 1 + n // CFG.hop_length
        want = get_mfccs_change_np(pcm[i, :n].astype(np.float64) / 32768.0, CFG.signal_sample_rate,
                                   max_freq=CFG.maxFreq)[0]
        assert want.shape == (nf,)
        assert np.abs(tot[i, :nf].double().numpy() - want).max() <= 1e-3 * np.abs(want).max()
        assert not tot[i, nf:].any() and torch.equal(mask[i] > 0, torch.arange(tot.shape[1]) < nf)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def card_rows(b: int, lengths: list[int], dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Coefficient trajectories [b, 12, NF] as the scan route filters them:
    the frontend's coef-major MFCCs of int16 speech-like audio on the card,
    C0 dropped (a strided view), and their valid frames [b]."""
    n = [min(len_ * CFG.hop_length, (NF - 1) * CFG.hop_length) for len_ in lengths]
    pcm = speechlike_pcm(n, CFG.signal_sample_rate, seed=b)
    pcm = np.pad(pcm, ((0, 0), (0, (NF - 1) * CFG.hop_length - pcm.shape[1])))
    model = MfccChange(CFG).to(dev)
    frames = torch.tensor([1 + k // CFG.hop_length for k in n], device=dev)
    mask = (torch.arange(NF, device=dev)[None, :] < frames[:, None]).float()
    m = model.trajectories(torch.tensor(pcm, device=dev), frame_mask=mask, coef_major=True)
    return m[:, 1:, :], frames


@pytest.mark.card
@pytest.mark.parametrize("b, kind", [(1, "shortest"), (1, "whole"), (4, "ragged"), (64, "ragged"), (1024, "ragged")])
def test_kernel_is_the_loop_bit_for_bit(dev, b, kind):
    """The kernel equals the loop bit for bit on 12 trajectories an
    utterance (12 to 12,288 rows, C0 dropped as a strided view) and on one
    row an utterance (the final filter's rows), at padlen + 1 frames, at the
    whole buffer and at ragged lengths, one launch each; float64 rows
    give the float32 rows' result in float64."""
    rng = np.random.default_rng(b)
    lengths = {"shortest": [PADLEN + 1] * b, "whole": [NF] * b,
               "ragged": [int(v) for v in rng.integers(PADLEN + 1, NF + 1, b)]}[kind]
    m, frames = card_rows(b, lengths, dev)
    for x in (m, m[:, 3].contiguous()):
        before = MS.LAUNCHES["masked_sosfiltfilt_f64"]
        got = MS.masked_sosfiltfilt_f64(SOS, ZI, PADLEN, x, frames)
        torch.cuda.synchronize()
        assert MS.LAUNCHES["masked_sosfiltfilt_f64"] == before + 1
        assert same_bits(got, plain(x.cpu(), frames.cpu())), (b, kind, x.ndim)
        got64 = MS.masked_sosfiltfilt_f64(SOS, ZI, PADLEN, x.double(), frames)
        assert got64.dtype == torch.float64 and torch.equal(got64, got.double())


@pytest.mark.card
@pytest.mark.parametrize("b, kind", [(4, "ragged"), (1024, "ragged"), (3, "short")])
def test_grad_norm_kernel_against_its_plain_version(dev, b, kind):
    """The gradient-norm kernel against its plain torch ops on the same card
    rows (the scan kernel's output of int16 audio's trajectories), within the
    roundoff of summing in another order (GRAD_NORM_RTOL), and bit for bit
    its mirror; at lengths 1-3 the edges meet. float64 rows give the
    float32 rows' result in float64."""
    rng = np.random.default_rng(b + 7)
    lengths = [1, 2, 3][:b] if kind == "short" else [int(v) for v in rng.integers(PADLEN + 1, NF + 1, b)]
    m, frames = card_rows(b, [max(n, PADLEN + 1) for n in lengths], dev)
    frames = torch.tensor(lengths, device=dev)
    filt = MS.masked_sosfiltfilt_f64(SOS, ZI, PADLEN, m, frames.clamp(min=PADLEN + 1))
    before = MS.LAUNCHES["masked_grad_norm_f32"]
    got = MS.masked_grad_norm(filt, frames)
    torch.cuda.synchronize()
    assert MS.LAUNCHES["masked_grad_norm_f32"] == before + 1
    g = masked_gradient(filt, frames[:, None])
    want = torch.sqrt(torch.sum(g * g, dim=-2)) / 12
    assert torch.allclose(got, want, rtol=GRAD_NORM_RTOL, atol=0.0), float((got - want).abs().max())
    got64 = MS.masked_grad_norm(filt.double(), frames)
    assert got64.dtype == torch.float64 and torch.equal(got64, got.double())
    if b <= 4:  # the mirror is a Python loop
        assert torch.equal(got.cpu(), torch.tensor(grad_norm_mirror(filt.cpu().numpy(), lengths)))


@pytest.mark.card
@pytest.mark.parametrize("fir, samples, spectrum", [(False, "int16", "fused"), (True, "int16", "fused"),
                                                    (False, "float64", "fft")], ids=["scan", "fir", "scan_f64"])
def test_scan_route_launches_the_kernel_twice(dev, fir, samples, spectrum):
    """batched_mfcc_change's scan route launches the filter kernel twice a
    call (the trajectory low-pass and the final filter), the FIR route
    never; both masked routes launch the gradient norm once. On the card it
    equals the CPU within the tail kernel's bar, float64 samples through
    the float64 'fft' route too (its trajectories frame-major: the kernels
    on the rows rounded to float32 and copied, the result in float64)."""
    lengths = [60_000, 61_000, 62_000, 65_536] if fir else [19_200, 33_000, 47_000, 59_200]
    pcm = torch.tensor(speechlike_pcm(lengths, CFG.signal_sample_rate, seed=7))
    if samples == "float64":
        pcm = pcm.double() / 32768.0
    batch = mt.AudioBatch(pcm.to(dev), torch.tensor(lengths, device=dev))
    before = dict(MS.LAUNCHES)
    tot, _ = batched_mfcc_change(batch, CFG, masked_fir=fir, spectrum=spectrum)
    torch.cuda.synchronize()
    assert MS.LAUNCHES["masked_sosfiltfilt_f64"] - before["masked_sosfiltfilt_f64"] == (0 if fir else 2)
    assert MS.LAUNCHES["masked_grad_norm_f32"] - before["masked_grad_norm_f32"] == 1
    cpu, _ = batched_mfcc_change(mt.AudioBatch(pcm, torch.tensor(lengths)), CFG, masked_fir=fir, spectrum=spectrum)
    assert tot.dtype == cpu.dtype == (torch.float64 if samples == "float64" else torch.float32)
    assert float((tot.cpu() - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())
