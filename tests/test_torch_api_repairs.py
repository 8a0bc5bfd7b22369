"""PyTorch port: the names and options that closed its public surface
against the JAX package, each fed the same inputs (numpy, seeded) as the
JAX function on the CPU: ``extract_mfcc`` and ``extract_modulation``, the
Hamming window and the spectra under it, ``frame_signal``'s ``center`` and
``pad_mode``, ``frame_times_centered``, ``cdiv``, ``mfcc_change``'s
``frame_mask`` and ``profile_trace``. The native loader's ``source_rates``
is in test_torch_native.py. Each test states its bar."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.signal as sps
import torch
import torch.nn.functional as tnf

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import modulation_mfcc_tpu as jax_pkg
from modulation_mfcc_tpu.models import modulation as jax_mod
from modulation_mfcc_tpu.ops import framing as jax_framing
from modulation_mfcc_tpu.ops import spectral as jax_spectral
from modulation_mfcc_tpu.ops import windows as jax_windows
from modulation_mfcc_tpu.utils.helpers import cdiv as jax_cdiv
import modulation_mfcc_tpu_torch as mt
from modulation_mfcc_tpu_torch.ops import framing, spectral, windows
from modulation_mfcc_tpu_torch.utils.helpers import cdiv
from modulation_mfcc_tpu_torch.utils import obs
from modulation_mfcc_tpu_torch.utils.obs import PROFILER_PAD, kernel_profile, profile_trace

torch.set_num_threads(1)

FLAGSHIP = dict(signal_sample_rate=16_000, maxFreq=8000.0)


@pytest.fixture(scope="module")
def noise():
    return np.random.default_rng(20260816).standard_normal((3, 40_000)).astype(np.float32)


def test_extract_mfcc_matches_jax(noise):
    """extract_mfcc(y, cfg) against JAX's, each at its default spectrum, the
    port also at 'fft' and 'matmul', and both at the fused kernel's
    ('pallas' in interpret mode against the port's plain version on the
    CPU): 1e-4 absolute in dB, the bar of
    test_torch_modulation.py::test_extract_mfcc_matrix_matches_jax."""
    y = noise[0, :24_000]
    t, got = mt.extract_mfcc(y, mt.MfccConfig(**FLAGSHIP), device="cpu")
    want_t, want = jax_pkg.extract_mfcc(y, jax_pkg.MfccConfig(**FLAGSHIP))
    assert np.array_equal(t, want_t) and got.shape == want.shape == (len(t), 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    for spectrum in ("fft", "matmul"):  # one utterance on the plain spectra: [NF, n_mfcc] too
        _, plain = mt.extract_mfcc(y, mt.MfccConfig(**FLAGSHIP), spectrum=spectrum, device="cpu")
        assert plain.shape == want.shape
        np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    with pltpu.force_tpu_interpret_mode():
        want_t, want = jax_pkg.extract_mfcc(y, jax_pkg.MfccConfig(**FLAGSHIP), spectrum="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    # cfg=None is MfccConfig(), the 10 kHz default; a batch gives [B, NF, n_mfcc]
    t, got = mt.extract_mfcc(torch.tensor(noise[:2, :20_000]))
    want_t, want = jax_pkg.extract_mfcc(noise[:2, :20_000])
    assert got.device.type == "cpu" and np.array_equal(t, want_t) and got.shape == want.shape == (2, 401, 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_extract_modulation_matches_jax():
    """extract_modulation is extract_mfcc_change (both packages); one 2 s
    utterance (the host-tail route) against JAX's at each default spectrum:
    1e-5, the bar of test_extract_mfcc_change_matches_jax_and_oracle."""
    from tests.test_torch_modulation import speechlike

    y = speechlike(2.0, 10_000)
    got, t = mt.extract_modulation(y, device="cpu")
    want, want_t = jax_pkg.extract_modulation(y)
    assert jax_pkg.extract_modulation is jax_mod.extract_mfcc_change
    assert np.array_equal(t, want_t) and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "symmetric"])
def test_hamming_window_matches_jax_and_scipy(periodic):
    """Bit for bit JAX's window, within 1e-15 of scipy's; by name too."""
    for m in (1, 2, 3, 250, 251, 400, 512, 1024):
        got = windows.hamming(m, periodic)
        assert got.dtype == np.float64
        assert np.array_equal(got, jax_windows.hamming(m, periodic))
        assert np.array_equal(windows.get_window("hamming", m, periodic), got)
        np.testing.assert_allclose(got, sps.get_window("hamming", m, fftbins=periodic), rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="hamming"):
        windows.get_window("blackman", 16)


@pytest.mark.parametrize("use_fft", [True, False], ids=["fft", "matmul"])
def test_hamming_spectra_match_jax(noise, use_fft):
    """melspectrogram, mfcc_from_frames and the DFT bases with
    window='hamming' against JAX's on float32 frames of 10 kHz noise: the
    bases bit for bit, the mel and the MFCC within 1e-5 of their peak."""
    kw = dict(sr=10_000, n_fft=512, win_length=250, fmin=100.0, fmax=5000.0, window="hamming", use_fft=use_fft)
    frames = framing.frame_signal(torch.tensor(noise[:2]), 512, 50)
    jframes = jax_framing.frame_signal(jnp.asarray(noise[:2]), 512, 50)
    assert np.array_equal(frames.numpy(), np.asarray(jframes))
    for a, b in zip(spectral.dft_bases(512, "hamming", 250), jax_spectral.dft_bases(512, "hamming", 250)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(spectral.analysis_window(512, "hamming", 250),
                          jax_spectral.analysis_window(512, "hamming", 250))
    mel = spectral.melspectrogram(frames, **kw).numpy()
    want = np.asarray(jax_spectral.melspectrogram(jframes, **kw))
    assert mel.dtype == np.float32 and mel.shape == want.shape == (2, 801, 128)
    assert np.abs(mel - want).max() <= 1e-5 * np.abs(want).max()
    m = spectral.mfcc_from_frames(frames, **kw).numpy()
    want = np.asarray(jax_spectral.mfcc_from_frames(jframes, **kw))
    assert m.shape == want.shape == (2, 801, 13)
    assert np.abs(m - want).max() <= 1e-5 * np.abs(want).max()
    hann = spectral.mfcc_from_frames(frames, **(kw | {"window": "hann"})).numpy()
    assert np.abs(hann - m).max() > 1e-2 * np.abs(m).max()  # the window reached the result


CASES = [(True, "constant"), (True, "reflect"), (False, "constant")]


@pytest.mark.parametrize("center,pad_mode", CASES, ids=[f"center={c}-{p}" for c, p in CASES])
def test_frame_signal_matches_jax(rng, center, pad_mode):
    """Exact against JAX's frame_signal on [2, 3, n] float64 and float32,
    the reflect pad also wider than the signal (numpy's repeated
    reflection), and a one-sample signal."""
    for n, fl, hop in ((1000, 250, 50), (7, 16, 3), (1, 4, 2)):
        if not center and n < fl:
            continue
        x = rng.standard_normal((2, 3, n))
        for dtype in (np.float64, np.float32):
            got = framing.frame_signal(torch.tensor(x.astype(dtype)), fl, hop, center=center, pad_mode=pad_mode)
            want = jax_framing.frame_signal(jnp.asarray(x.astype(dtype)), fl, hop, center=center, pad_mode=pad_mode)
            assert got.dtype == torch.from_numpy(x.astype(dtype)).dtype
            assert got.shape == want.shape and np.array_equal(got.numpy(), np.asarray(want)), (n, fl, hop)


def test_frame_signal_constant_is_unchanged_and_rejects(rng):
    """The default (centered zeros) frames bit for bit as the zero pad and
    strided view it always took; an unknown pad mode and a signal shorter
    than a frame raise, as JAX's do."""
    x = torch.tensor(rng.standard_normal((2, 5000)).astype(np.float32))
    nf = framing.n_frames_centered(5000, 512, 50)
    before = framing.frame_by_slices(tnf.pad(x, (256, 256)), 0, nf, 512, 50)
    assert torch.equal(framing.frame_signal(x, 512, 50), before)
    for mod, arr in ((framing, x), (jax_framing, jnp.asarray(x.numpy()))):
        with pytest.raises(ValueError, match="pad_mode"):
            mod.frame_signal(arr, 512, 50, pad_mode="edge")
        with pytest.raises(ValueError, match="too short"):
            mod.frame_signal(arr[..., :100], 512, 50, center=False)


def test_frame_times_centered_and_cdiv_match_jax():
    """Exact against JAX's."""
    for nf, hop, sr in ((0, 160, 16_000), (1, 50, 10_000), (801, 50, 10_000), (3001, 441, 44_100.0)):
        got = framing.frame_times_centered(nf, hop, sr)
        assert got.dtype == np.float64 and np.array_equal(got, jax_framing.frame_times_centered(nf, hop, sr))
    for a in range(-7, 40):
        for b in (1, 2, 3, 7, 128):
            assert cdiv(a, b) == jax_cdiv(a, b)


@pytest.fixture(scope="module")
def ragged():
    """A padded batch of three utterances of 4, 3.85 and 3.72 s at 10 kHz
    (numpy seed 20260816; each at least min_frames_for_fir frames, so the
    masked FIR filters take them), zeros past each length, its valid frame
    counts and their mask."""
    cfg = mt.MfccConfig()
    y = np.random.default_rng(20260816).standard_normal((3, 40_000)).astype(np.float32)
    lengths = np.array([40_000, 38_500, 37_200])
    for i, n in enumerate(lengths):
        y[i, n:] = 0.0
    nf = 1 + lengths // cfg.hop_length
    assert nf.min() >= mt.models.modulation.min_frames_for_fir(cfg)
    mask = (np.arange(1 + 40_000 // cfg.hop_length)[None, :] < nf[:, None]).astype(np.float32)
    return y, nf, mask


@pytest.mark.parametrize("with_lengths", [False, True], ids=["frame_mask", "frame_mask+frame_lengths"])
def test_mfcc_change_frame_mask_matches_jax(ragged, with_lengths):
    """mfcc_change(frame_mask=...) on a padded batch of ragged utterances
    against JAX's (jitted), both on the 'fft' spectrum (which frames set a
    peak and which the filters see do not depend on the spectrum), 1e-5,
    the bar of the mfcc_change parity tests. Alone, the mask sets each
    utterance's top_db peak and the filters run over every frame; beside
    frame_lengths (masked_fir=True), the lengths govern the filters and
    every frame past a length is 0. The padded frames' mel power is 0 and would not raise a
    peak anyway, so a mask over the first half of the frames is also
    checked to move the result."""
    y, nf, mask = ragged
    cfg = mt.MfccConfig()
    kw = dict(frame_lengths=nf, masked_fir=True) if with_lengths else {}
    jax_kw = dict(frame_lengths=jnp.asarray(nf)) if with_lengths else {}
    want = np.asarray(jax.jit(lambda v, m, **a: jax_mod.mfcc_change(
        v, jax_pkg.MfccConfig(), spectrum="fft", frame_mask=m, masked_fir=with_lengths, **a))(
        jnp.asarray(y), jnp.asarray(mask), **jax_kw))
    got = mt.mfcc_change(torch.tensor(y), cfg, spectrum="fft", frame_mask=torch.tensor(mask), **kw)
    assert got.shape == want.shape == (3, 801)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if with_lengths:  # frame_lengths alone derives the same mask
        assert not got.numpy()[mask == 0].any()
        assert torch.equal(got, mt.mfcc_change(torch.tensor(y), cfg, spectrum="fft", frame_lengths=torch.tensor(nf),
                                               masked_fir=True))
    else:  # a mask over the first half only lowers every peak it bounds, so the result moves
        half = mask.copy()
        half[:, 400:] = 0.0
        other = mt.mfcc_change(torch.tensor(y), cfg, spectrum="fft", frame_mask=torch.tensor(half)).numpy()
        assert np.abs(other - got.numpy()).max() > 1e-3


def test_profile_trace_writes_a_trace(tmp_path):
    """A Chrome trace JSON appears under log_dir and holds the events of
    the ops run inside the block; with log_dir None or '' the block runs
    untraced and nothing is written."""
    a = torch.randn(32, 32)
    with profile_trace(str(tmp_path / "trace")):
        with torch.profiler.record_function("modmfcc_probe"):
            (a @ a).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"modmfcc_probe", "aten::mm"} <= names
    for off in (None, ""):
        with profile_trace(off):
            (a @ a).sum()
    assert len(list(tmp_path.rglob("*.json"))) == 1


def test_kernel_profile_and_a_raising_block(tmp_path):
    """kernel_profile yields the torch.profiler profile of its block, whose
    events hold the block's ops, and launches no pad on the CPU;
    profile_trace writes its trace also when the block raises."""
    a = torch.randn(32, 32)
    with kernel_profile() as prof:
        (a @ a).sum()
    names = {e.name for e in prof.events()}
    assert "aten::mm" in names and PROFILER_PAD not in names
    with pytest.raises(KeyError):
        with profile_trace(str(tmp_path)):
            (a @ a).sum()
            raise KeyError("the block's error")
    (trace,) = tmp_path.glob("*.pt.trace.json")
    assert "aten::mm" in {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}


def test_block_records_lost_counts_beyond_the_pad():
    """A padded window's kernel launch calls less its kernel records (copies
    and fills aside), beyond the pad's launches: the block's records lost,
    which kernel_profile reports."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = ([SimpleNamespace(device_type=cpu, name="cudaLaunchKernel")] * 9
              + [SimpleNamespace(device_type=cpu, name="cuLaunchKernel"),
                 SimpleNamespace(device_type=cpu, name="aten::mm")]
              + [SimpleNamespace(device_type=cuda, name="void gemm_kernel")] * 5
              + [SimpleNamespace(device_type=cuda, name="Memcpy HtoD (Pageable -> Device)")])
    prof = SimpleNamespace(events=lambda: events)
    assert [obs._block_records_lost(prof, pad) for pad in (0, 3, 5, 8)] == [5, 2, 0, 0]
