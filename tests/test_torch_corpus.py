"""PyTorch port: the corpus path against the JAX package on the CPU — the
scan-based masked filters, the batched modulation cepstrum (FIR and scan
filters, uniform lengths, int16 hop rows), the WAV reader, the host
pipeline and the resumable sweep itself. The JAX side runs as its own tests
run it (Pallas in interpret mode)."""
import functools
import json
import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from modulation_mfcc_tpu.io import wav as jax_wav
from modulation_mfcc_tpu.models.config import MfccConfig as JaxMfccConfig
from modulation_mfcc_tpu.ops import filters as jax_filters
from modulation_mfcc_tpu.ops import masked as jax_masked
from modulation_mfcc_tpu.parallel import batch as jax_batch
from modulation_mfcc_tpu.parallel import corpus as jax_corpus
from modulation_mfcc_tpu.pallas import fused_frontend as jax_ff
from modulation_mfcc_tpu_torch import MfccConfig, extract_mfcc_change
from modulation_mfcc_tpu_torch.io import wav as wav_io
from modulation_mfcc_tpu_torch.kernels import fused_frontend as ff
from modulation_mfcc_tpu_torch.models import modulation as mod
from modulation_mfcc_tpu_torch.ops import masked
from modulation_mfcc_tpu_torch.parallel import batch, corpus, prefetch
from modulation_mfcc_tpu_torch.utils.obs import ThroughputMeter, log_event
from tests.test_torch_modulation import speechlike

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Masked filters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trajectories():
    """[3, 4, 300] float64 trajectories and their valid lengths."""
    return np.random.default_rng(4).standard_normal((3, 4, 300)), np.array([300, 217, 61])


def test_masked_odd_ext_and_reverse_match_jax(trajectories):
    """The odd extension at each item's true end and the valid-prefix
    reversal equal JAX's bit for bit (float64)."""
    x, lengths = trajectories
    for b, L in enumerate(lengths):
        want = np.asarray(jax_masked.masked_odd_ext(jnp.asarray(x[b]), L, 27))
        got = masked.masked_odd_ext(torch.tensor(x[b]), torch.tensor(L), 27).numpy()
        assert np.array_equal(got, want)
        want = np.asarray(jax_masked.masked_reverse(jnp.asarray(want), L + 54))
        got = masked.masked_reverse(torch.tensor(got), torch.tensor(L + 54)).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("order", [6, 2])
def test_masked_sosfiltfilt_matches_jax(trajectories, order):
    """masked_sosfiltfilt on a batch with per-item lengths equals JAX's
    (vmapped over the items) to 1e-8 in float64 on valid samples, and
    scipy's sosfiltfilt of each valid prefix; zeros beyond each length."""
    import scipy.signal as sps

    x, lengths = trajectories
    sos, zi, padlen = jax_filters.design_butter_sos(order, (12.0 / 100.0,), "lowpass")
    want = np.asarray(jax.vmap(lambda tr, L: jax_masked.masked_sosfiltfilt(sos, zi, padlen, tr, L))(
        jnp.asarray(x), jnp.asarray(lengths)))
    got = masked.masked_sosfiltfilt(sos, zi, padlen, torch.tensor(x), torch.tensor(lengths)[:, None]).numpy()
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(got[b, :, :L], want[b, :, :L], rtol=0, atol=1e-8)
        np.testing.assert_allclose(got[b, :, :L], sps.sosfiltfilt(sos, x[b, :, :L]), rtol=0, atol=1e-8)
        assert not got[b, :, L:].any()


# ---------------------------------------------------------------------------
# Batched modulation cepstrum
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ragged():
    """Four speech-like utterances at 10 kHz: two long enough for the FIR
    filters (≥ 744 frames), two shorter; padded to 65,536 samples."""
    lengths = np.array([41_000, 38_500, 20_000, 9_000])
    y = np.zeros((4, 65_536), np.float32)
    for i, n in enumerate(lengths):
        y[i, :n] = speechlike(n / 10_000, 10_000, seed=30 + i)[:n] * 0.5
    return y, lengths


def jax_batched(samples, lengths, spectrum: str, **kw) -> np.ndarray:
    """JAX's batched_mfcc_change at its default configuration."""
    with pltpu.force_tpu_interpret_mode():
        tot, _ = jax_batch.batched_mfcc_change(
            jax_batch.AudioBatch(jnp.asarray(samples), jnp.asarray(lengths)), JaxMfccConfig(),
            spectrum=spectrum, **kw)
    return np.asarray(tot)


def assert_valid_frames_close(got, want, lengths, cfg, atol):
    for b, n in enumerate(lengths):
        nf = 1 + int(n) // cfg.hop_length
        np.testing.assert_allclose(got[b, :nf], want[b, :nf], rtol=0, atol=atol)


@pytest.mark.parametrize("masked_fir", [True, False], ids=["fir", "scan"])
def test_batched_mfcc_change_matches_jax_and_per_file(ragged, masked_fir):
    """A ragged batch through the FIR filters (its two long items) or the
    scan filters (all four): ≤ 1e-5 against JAX's batched_mfcc_change
    ('pallas') on valid frames (measured 1.7e-6 and 6.7e-6: JAX runs its
    scan in float32, the port in float64), and each item ≤ 1e-5 against its
    own extract_mfcc_change (measured 6.6e-7 and 1.0e-6); the frame mask
    marks exactly the valid frames."""
    y, lengths = ragged
    cfg = MfccConfig()
    if masked_fir:
        y, lengths = y[:2], lengths[:2]
    got, mask = batch.batched_mfcc_change(batch.AudioBatch(torch.tensor(y), torch.tensor(lengths)), cfg,
                                          masked_fir=masked_fir)
    got = got.numpy()
    want = jax_batched(y, lengths, "pallas", masked_fir=masked_fir)
    assert got.shape == want.shape
    assert_valid_frames_close(got, want, lengths, cfg, 1e-5)
    for b, n in enumerate(lengths):
        single, _ = extract_mfcc_change(y[b, :n], cfg, device="cpu")
        nf = single.shape[0]
        assert mask[b].sum() == nf and not mask[b, nf:].any() and not got[b, nf:].any()
        np.testing.assert_allclose(got[b, :nf], single.numpy(), rtol=0, atol=1e-5)


def test_batched_uniform_lengths_matches_jax(ragged):
    """uniform_lengths=True skips the masked edges: ≤ 1e-5 from JAX's
    (measured 1.7e-6) and equal to the unmasked mfcc_change."""
    y = ragged[0][:2, :40_000]
    cfg = MfccConfig()
    lengths = np.array([40_000, 40_000])
    got, _ = batch.batched_mfcc_change(batch.AudioBatch(torch.tensor(y), torch.tensor(lengths)), cfg,
                                       uniform_lengths=True)
    want = jax_batched(y, lengths, "pallas", uniform_lengths=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got, mod.mfcc_change(torch.tensor(y), cfg))


def test_batched_i16_rows_matches_jax(ragged):
    """int16 hop rows through 'fused_i16': the two long items with the FIR
    filters equal JAX's 'pallas_i16' on the same rows to 1e-5 (measured
    1.3e-6); the whole ragged batch with the scan filters equals the flat
    int16 and float32 batches bitwise, and each item's extract_mfcc_change
    to 1e-5."""
    y, lengths = ragged
    cfg = MfccConfig()
    pcm = np.round(y * 32767.0).astype(np.int16)
    geo = dict(n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length)
    n = pcm.shape[1]
    got, _ = batch.batched_mfcc_change(
        batch.AudioBatch(torch.tensor(ff.pack_hop_rows(pcm[:2], **geo)), torch.tensor(lengths[:2])), cfg,
        spectrum="fused_i16", n_samples=n, masked_fir=True)
    want = jax_batched(jax_ff.pack_hop_rows(pcm[:2], blkf=1024, **geo), lengths[:2], "pallas_i16", n_samples=n,
                       masked_fir=True)
    assert_valid_frames_close(got.numpy(), want, lengths[:2], cfg, 1e-5)
    got, _ = batch.batched_mfcc_change(batch.AudioBatch(torch.tensor(ff.pack_hop_rows(pcm, **geo)),
                                                        torch.tensor(lengths)), cfg, spectrum="fused_i16", n_samples=n)
    for flat in (torch.tensor(pcm), torch.tensor(pcm.astype(np.float32) / 32768.0)):
        same, _ = batch.batched_mfcc_change(batch.AudioBatch(flat, torch.tensor(lengths)), cfg, spectrum="fused_i16")
        assert torch.equal(same, got)
    for b, m in enumerate(lengths):
        single, _ = extract_mfcc_change(pcm[b, :m].astype(np.float32) / 32768.0, cfg, spectrum="fused_i16",
                                        device="cpu")
        np.testing.assert_allclose(got[b, : single.shape[0]].numpy(), single.numpy(), rtol=0, atol=1e-5)


def test_dequantize_and_frame_mask_match_jax():
    pcm = np.array([[-32768, -1, 0, 1, 32767]], np.int16)
    got = batch.dequantize_samples(torch.tensor(pcm)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, np.asarray(jax_batch.dequantize_samples(jnp.asarray(pcm))))
    f = torch.ones(3)
    assert batch.dequantize_samples(f) is f
    lengths = np.array([9_000, 40_000, 1])
    cfg = MfccConfig()
    want = np.asarray(jax_batch.frame_validity_mask(jnp.asarray(lengths), 40_960, JaxMfccConfig()))
    got = batch.frame_validity_mask(torch.tensor(lengths), 40_960, cfg).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# Host side: WAV reader, batch assembly, pipeline, counters
# ---------------------------------------------------------------------------


def write_pcm(path, data: np.ndarray, sr: int, width: int = 2) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1 if data.ndim == 1 else data.shape[1])
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def test_read_wav_and_load_channel_match_jax(tmp_path):
    """16-bit mono and stereo, 24-bit and 32-bit float WAVs decode as the
    JAX package decodes them; load_channel resamples and selects alike."""
    rng = np.random.default_rng(9)
    p16 = tmp_path / "a.wav"
    write_pcm(p16, rng.integers(-32768, 32768, 3_000).astype("<i2"), 16_000)
    pst = tmp_path / "st.wav"
    write_pcm(pst, rng.integers(-32768, 32768, (2_000, 2)).astype("<i2"), 10_000)
    p24 = tmp_path / "b.wav"
    write_pcm(p24, rng.integers(0, 256, 6_000).astype(np.uint8), 10_000, width=3)
    for p in (p16, pst, p24):
        (got, sr), (want, jsr) = wav_io.read_wav(str(p)), jax_wav.read_wav(str(p))
        assert sr == jsr and got.dtype == want.dtype and np.array_equal(got, want)
        for ch in (0, 1):
            assert np.array_equal(wav_io.load_channel(str(p), 10_000, ch), jax_wav.load_channel(str(p), 10_000, ch))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav at all")
    with pytest.raises(ValueError, match="RIFF"):
        wav_io.read_wav(str(bad))


def test_make_batch_matches_jax():
    """Batch assembly: on-grid float buckets ship as int16 (JAX's grid
    check), off-grid and out-of-range ones as float32; with a configuration
    an int16 batch ships as hop rows, JAX's pack_hop_rows bytes."""
    rng = np.random.default_rng(3)
    on = rng.integers(-(2**15), 2**15 - 1, 4_000).astype(np.float32) / 32768.0
    cfg = MfccConfig()
    for group in ([("a", on), ("b", on[:3_000])], [("c", on + 1e-6)], [("d", np.full(100, 1.5, np.float32))]):
        paths, arrays, n = corpus._make_batch(group, 4_096)
        jpaths, jarrays, _ = jax_corpus._make_batch(group, 4_096)
        assert paths == jpaths and n is None
        for k in ("samples", "lengths"):
            assert np.array_equal(arrays[k], jarrays[k]) and arrays["samples"].dtype == jarrays["samples"].dtype
    _, arrays, n = corpus._make_batch([("a", on), ("b", on[:3_000])], 4_096, cfg)
    _, jflat, _ = jax_corpus._make_batch([("a", on), ("b", on[:3_000])], 4_096)
    want = jax_ff.pack_hop_rows(jflat["samples"], n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length,
                                blkf=1024)
    assert n == 4_096 and arrays["samples"].dtype == np.int16 and np.array_equal(arrays["samples"], want)
    _, arrays, n = corpus._make_batch([("c", on + 1e-6)], 4_096, cfg)
    assert n is None and arrays["samples"].ndim == 2


def test_output_names_match_jax():
    paths = ["/x/a.wav", "/y/a.wav", "/x/b.wav"]
    assert corpus._output_names(paths) == jax_corpus._output_names(paths)


def test_background_iter_and_prefetch():
    """background_iter passes items through and raises the producer's
    exception in the consumer; prefetch_to_device on the CPU yields the
    batches as tensors and counts the bytes."""
    assert list(prefetch.background_iter(iter(range(5)), maxsize=2)) == [0, 1, 2, 3, 4]

    def bad():
        yield 1
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(prefetch.background_iter(bad()))
    stats = {}
    items = [{"samples": np.full((2, 8), i, np.int16), "lengths": np.array([8, 5])} for i in range(3)]
    out = list(prefetch.prefetch_to_device(iter(items), depth=2, device="cpu", stats=stats))
    assert [int(o["samples"][0, 0]) for o in out] == [0, 1, 2]
    assert out[0]["samples"].dtype == torch.int16 and out[0]["samples"].device.type == "cpu"
    assert stats["upload_mb"] == pytest.approx(3 * (32 + 16) / 1e6) and stats["upload_busy_s"] == 0.0


def test_obs(capsys):
    m = ThroughputMeter()
    m.add(3600.0, items=2)
    rep = m.report()
    assert rep["items"] == 2 and rep["audio_hours"] == 1.0 and rep["audio_hours_per_sec"] > 0
    log_event("corpus.test", files=3)
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rec["event"] == "corpus.test" and rec["files"] == 3


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    return make_tiny_corpus(tmp_path_factory.mktemp("corpus"))


def make_tiny_corpus(d) -> list[str]:
    """int16 WAVs at 10 kHz (one of 2 s, below the 744 frames of the FIR
    filters; two with the same basename in two folders), one at 16 kHz that
    needs resampling, and one corrupt file, in directory ``d``."""
    paths = []
    for name, seconds, sr in (("a", 4.5, 10_000), ("x/c", 4.2, 10_000), ("y/c", 4.8, 10_000),
                              ("short", 2.0, 10_000), ("r16k", 5.0, 16_000)):
        p = d / f"{name}.wav"
        p.parent.mkdir(exist_ok=True)
        y = speechlike(seconds, sr, seed=len(paths) + 40) * 0.5
        write_pcm(p, np.round(y * 32767.0).astype("<i2"), sr)
        paths.append(str(p))
    bad = d / "bad.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    paths.insert(2, str(bad))
    return paths


def test_sweep_matches_jax_and_resumes(tiny_corpus, tmp_path, capsys):
    """sweep_mfcc_change on the CPU: records with the JAX sweep's names, keys
    and shapes, values ≤ 1e-5 from JAX's ('pallas', interpret mode); the
    corrupt file is logged and skipped; a second run skips every finished
    file; a third with resume=False redoes them."""
    cfg = MfccConfig()
    kw = dict(cfg=cfg, batch_size=3, bucket_multiple=32_768)
    out = tmp_path / "port"
    rep = corpus.sweep_mfcc_change(tiny_corpus, corpus.CorpusSweep(str(out), device="cpu", **kw))
    assert rep["items"] == 5 and rep["stages"]["upload_mb"] > 0
    err = capsys.readouterr().err
    skips = [json.loads(line) for line in err.splitlines() if '"corpus.skip"' in line]
    assert [s["file"] for s in skips] == [tiny_corpus[2]]
    with pltpu.force_tpu_interpret_mode():
        jrep = jax_corpus.sweep_mfcc_change(tiny_corpus, jax_corpus.CorpusSweep(
            str(tmp_path / "jax"), cfg=JaxMfccConfig(), spectrum="pallas", use_native_loader=False,
            batch_size=3, bucket_multiple=32_768))
    assert jrep["items"] == 5
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 6  # five records + _done.txt
    for name in names:
        if not name.endswith(".npz"):
            continue
        got, want = np.load(out / name), np.load(tmp_path / "jax" / name)
        assert sorted(got.files) == sorted(want.files) == ["mod_cepstr", "times"]
        assert got["mod_cepstr"].shape == want["mod_cepstr"].shape and np.array_equal(got["times"], want["times"])
        np.testing.assert_allclose(got["mod_cepstr"], want["mod_cepstr"], rtol=0, atol=1e-5)
    assert corpus.sweep_mfcc_change(tiny_corpus, corpus.CorpusSweep(str(out), device="cpu", **kw))["items"] == 0
    again = corpus.sweep_mfcc_change(tiny_corpus, corpus.CorpusSweep(str(out), device="cpu", resume=False, **kw))
    assert again["items"] == 5
    assert len((out / "_done.txt").read_text().splitlines()) == 10


@pytest.mark.parametrize("spectrum", ["fused_i16", "fused_bf16"])
def test_sweep_records_equal_per_file(tiny_corpus, tmp_path, spectrum):
    """The sweep's records equal per-file extract_mfcc_change in the same
    mode to 1e-5 (hop rows for the int16 buckets, float32 for the resampled
    file)."""
    cfg = MfccConfig()
    out = tmp_path / spectrum
    corpus.sweep_mfcc_change(tiny_corpus, corpus.CorpusSweep(str(out), cfg=cfg, spectrum=spectrum, device="cpu",
                                                             batch_size=3, bucket_multiple=32_768))
    names = corpus._output_names(tiny_corpus)
    for p in tiny_corpus[:2] + tiny_corpus[3:]:
        rec = np.load(out / names[p])
        y = wav_io.load_channel(p, cfg.signal_sample_rate).astype(np.float32)
        want, t = extract_mfcc_change(y, cfg, spectrum=spectrum, device="cpu")
        assert np.array_equal(rec["times"], t)
        np.testing.assert_allclose(rec["mod_cepstr"], want.numpy(), rtol=0, atol=1e-5)


EXTRA_FEATURES = ("mod_cepstr", "f0", "envelope", "mfcc39", "formants")  # tests/test_corpus.py:46


def assert_records_close(got, want, f0_atol: float = 1e-4, env_atol: float = 1e-6) -> None:
    """Two sweeps' records of one file: the same keys, shapes and times;
    values to each track's bar (mod_cepstr 1e-5, mfcc39 1e-4, envelope
    ``env_atol``, f0 ``f0_atol`` Hz with the same voicing; formants and bandwidths
    the same NaN pattern and ≥ 95 % of frames within 0.05 Hz, the
    batched-formant tests' rule for float32 Burg at silence boundaries)."""
    assert sorted(got.files) == sorted(want.files)
    bars = {"mod_cepstr": 1e-5, "mfcc39": 1e-4, "envelope": env_atol, "formants": 0.05, "formant_bw": 0.05}
    for k in want.files:
        a, b = got[k], want[k]
        assert a.shape == b.shape, k
        if k.endswith("times"):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=k)
        elif k == "f0":
            np.testing.assert_array_equal(a > 0, b > 0)
            np.testing.assert_allclose(a, b, rtol=0, atol=f0_atol)
        elif k in ("formants", "formant_bw"):
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=k)
            close = np.all(np.where(np.isfinite(b), np.abs(a - b), 0.0) <= bars[k], axis=-1)
            assert close.mean() >= 0.95, (k, close.mean())
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=bars[k], err_msg=k)


def assert_dirs_close(got_dir, want_dir, **kw) -> None:
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        if name.endswith(".npz"):
            assert_records_close(np.load(os.path.join(got_dir, name)), np.load(os.path.join(want_dir, name)), **kw)


@pytest.mark.parametrize("variant", ["extras", "pyin_rmspraat"])
def test_extras_sweep_matches_jax(tiny_corpus, tmp_path, variant):
    """The sweep with tracker extras against the JAX sweep on the same
    corpus, spectrum 'fft' on both sides, record by record and key by key
    (assert_records_close; f0 to the trackers' 0.05 Hz): the features of
    tests/test_corpus.py:46, and f0 by pyin with RMSpraat envelopes (per
    file, in dB: test_torch_envelope.py's 0.01 dB) on the first two files."""
    from modulation_mfcc_tpu.models import config as jax_config
    from modulation_mfcc_tpu_torch.models.config import AmplitudeConfig, F0Config

    paths, feats, kw, jkw, env_atol = tiny_corpus, EXTRA_FEATURES, {}, {}, 1e-6
    if variant == "pyin_rmspraat":
        paths, feats, env_atol = tiny_corpus[:2], ("mod_cepstr", "f0", "envelope"), 0.01
        kw = dict(f0_cfg=F0Config(method="pyin"), amp_cfg=AmplitudeConfig(method="RMSpraat"))
        jkw = dict(f0_cfg=jax_config.F0Config(method="pyin"), amp_cfg=jax_config.AmplitudeConfig(method="RMSpraat"))
    common = dict(batch_size=3, bucket_multiple=32_768, spectrum="fft", features=feats)
    rep = corpus.sweep_mfcc_change(paths, corpus.CorpusSweep(str(tmp_path / "port"), cfg=MfccConfig(), device="cpu",
                                                             **common, **kw))
    jrep = jax_corpus.sweep_mfcc_change(paths, jax_corpus.CorpusSweep(
        str(tmp_path / "jax"), cfg=JaxMfccConfig(), use_native_loader=False, **common, **jkw))
    assert rep["items"] == jrep["items"] == len(paths) - (variant == "extras")
    assert_dirs_close(tmp_path / "port", tmp_path / "jax", f0_atol=0.05, env_atol=env_atol)
    rec = np.load(tmp_path / "port" / "a.npz")
    assert {"f0", "f0_times", "envelope", "envelope_times"} <= set(rec.files)


def test_per_file_envelopes_are_logged_once_a_sweep(tiny_corpus, tmp_path, capsys):
    """A sweep of two batches with RMSpraat envelopes says once that they
    run file by file, and logs nothing else (its report is returned)."""
    from modulation_mfcc_tpu_torch.models.config import AmplitudeConfig

    sweep = corpus.CorpusSweep(str(tmp_path), cfg=MfccConfig(), batch_size=1, bucket_multiple=32_768, device="cpu",
                               spectrum="fft", features=("mod_cepstr", "envelope"), use_native_loader=False,
                               amp_cfg=AmplitudeConfig(method="RMSpraat"))
    rep = corpus.sweep_mfcc_change(tiny_corpus[:2], sweep)
    events = [json.loads(line)["event"] for line in capsys.readouterr().err.splitlines() if line.startswith("{")]
    assert rep["items"] == 2 and events == ["corpus.envelope_per_file"]


def test_native_loader_sweep_equals_python_loader(tiny_corpus, tmp_path, capsys):
    """The native loader (the default) and the Python reader give the same
    records (the native int16 passthrough and the Python grid check meet on
    the same int16 batches; the 16 kHz file resampled with the same taps),
    and the native loader ran."""
    from modulation_mfcc_tpu_torch.io import native

    if not native.native_available():
        pytest.skip("native library unavailable (no toolchain)")
    common = dict(cfg=MfccConfig(), batch_size=3, bucket_multiple=32_768, device="cpu", features=EXTRA_FEATURES,
                  spectrum="fft")
    assert corpus.CorpusSweep("x").use_native_loader
    calls = []

    class Spy(native.NativeBatchLoader):
        def submit(self, index, path):
            calls.append(path)
            super().submit(index, path)

    orig = native.NativeBatchLoader
    native.NativeBatchLoader = Spy
    try:
        corpus.sweep_mfcc_change(tiny_corpus, corpus.CorpusSweep(str(tmp_path / "native"), **common))
    finally:
        native.NativeBatchLoader = orig
    assert calls == tiny_corpus
    corpus.sweep_mfcc_change(tiny_corpus, corpus.CorpusSweep(str(tmp_path / "py"), use_native_loader=False, **common))
    assert "corpus.native_loader_unavailable" not in capsys.readouterr().err
    assert_dirs_close(tmp_path / "native", tmp_path / "py", f0_atol=1e-6)


def test_cli_sweep_shard_matches_jax_cli(tiny_corpus, tmp_path, monkeypatch):
    """`sweep --features mod_cepstr,f0 --num-shards 2 --shard-id 1` of the
    port's CLI (on the CPU) writes the JAX CLI's records for that shard.
    The JAX side reads with the Python reader, so it never runs
    `make -C native` beside tests/test_native.py in another worker."""
    from modulation_mfcc_tpu.cli import main as jax_main
    from modulation_mfcc_tpu_torch.cli import main

    monkeypatch.setattr(jax_corpus, "CorpusSweep", functools.partial(jax_corpus.CorpusSweep, use_native_loader=False))
    args = ["sweep", *tiny_corpus, "--spectrum", "fft", "--features", "mod_cepstr,f0", "--batch-size", "2",
            "--num-shards", "2", "--shard-id", "1"]
    assert main([*args, "--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_main([*args, "--out", str(tmp_path / "jax")]) in (0, None)
    assert_dirs_close(tmp_path / "port", tmp_path / "jax", f0_atol=0.05)
    assert len(os.listdir(tmp_path / "port")) == 1 + len(tiny_corpus[1::2]) - (tiny_corpus[2] in tiny_corpus[1::2])


def test_resume_reads_the_done_list_once(tmp_path, monkeypatch):
    """Resuming a manifest whose files are all finished reads
    _done.txt once, not once a path, and processes nothing."""
    paths = [f"/corpus/spk{i % 100:02d}/utt{i:06d}.wav" for i in range(2_000)]
    (tmp_path / "_done.txt").write_text("\n".join(paths) + "\n")
    calls = []
    load_done = corpus._load_done
    monkeypatch.setattr(corpus, "_load_done", lambda sweep: calls.append(sweep) or load_done(sweep))
    rep = corpus.sweep_mfcc_change(paths, corpus.CorpusSweep(str(tmp_path), device="cpu", features=EXTRA_FEATURES,
                                                             use_native_loader=False))
    assert rep["items"] == 0 and len(calls) == 1


def test_sweep_unported_options_raise(tmp_path):
    """An unknown feature raises before any file is read."""
    paths = ["/nonexistent.wav"]
    with pytest.raises(ValueError, match="feature"):
        corpus.sweep_mfcc_change(paths, corpus.CorpusSweep(str(tmp_path), device="cpu", features=("bogus",)))
