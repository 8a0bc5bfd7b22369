"""PyTorch port: its ctypes binding of the native IO runtime
(``native/modmfcc_io.cpp``) against the JAX package's binding of the same
source, mirroring tests/test_native.py: decode, resample, a malformed file
isolated, and the threaded batch loader."""
import fcntl
import os
import struct
import tempfile

import numpy as np
import pytest

from modulation_mfcc_tpu.io import native as jax_native
from modulation_mfcc_tpu_torch.io import native
from modulation_mfcc_tpu_torch.io.wav import read_wav, write_wav


@pytest.fixture(scope="module")
def built():
    """Both bindings' libraries; skips where g++ cannot build them (as the
    JAX package's tests do). The JAX binding's first call runs
    `make -C native`, which writes native/libmodmfcc_io.so in place; it
    runs under an exclusive lock, so two workers of this module never write
    it at once. (In a whole-suite run, tests/test_native.py's module-level
    check has already built and loaded it in every worker at collection.)"""
    if not native.native_available():
        pytest.skip("native library unavailable (no toolchain)")
    with open(os.path.join(tempfile.gettempdir(), "modmfcc_native_make.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jax_ok = jax_native.native_available()
    if not jax_ok:
        pytest.skip("native library unavailable (no toolchain)")
    return native.library_path()


def test_build_goes_to_the_port_build_dir(built):
    """The port builds its own copy under modulation_mfcc_tpu_torch/_build
    (a name hashed from source and flags), never into native/."""
    assert built.exists() and built.parent == native.BUILD_DIR and built.name.startswith("libmodmfcc_io_")
    assert native.build() == built  # cached: no second build


def test_decode_matches_jax_and_python_reader(tmp_path, rng, built):
    sr = 16_000
    y = np.clip(0.5 * rng.standard_normal(sr), -1, 1)
    p = str(tmp_path / "a.wav")
    write_wav(p, y, sr)
    xn, srn = native.decode_wav_native(p)
    xj, srj = jax_native.decode_wav_native(p)
    xp, srp = read_wav(p)
    assert srn == srj == srp == sr
    np.testing.assert_array_equal(xn, xj)
    np.testing.assert_allclose(xn, xp, atol=1e-7)


def test_resample_matches_jax_and_scipy(rng, built):
    from scipy.signal import resample_poly

    x = rng.standard_normal(20_000).astype(np.float32)
    up, down = 441, 160  # 16 kHz -> 44.1 kHz
    got = native.resample_native(x, up, down)
    np.testing.assert_array_equal(got, jax_native.resample_native(x, up, down))
    taps = native.design_resample_taps(up, down)
    np.testing.assert_array_equal(taps, jax_native.design_resample_taps(up, down))
    want = resample_poly(x.astype(np.float64), up, down, window=taps)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_malformed_bits_isolated(tmp_path, built):
    """A fmt chunk claiming bits=0 is a per-file error in both bindings, in
    the one-shot decode and through the threaded loader."""
    fmt = struct.pack("<HHIIHH", 1, 1, 8000, 0, 0, 0)  # bits=0
    data = b"\x00" * 64
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data
    p = tmp_path / "zerobits.wav"
    p.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    for mod in (native, jax_native):
        with pytest.raises(ValueError):
            mod.decode_wav_native(str(p))
    with native.NativeBatchLoader(10_000, n_threads=1) as loader:
        loader.submit(0, str(p))
        assert dict(iter(loader)) == {0: None}


@pytest.mark.parametrize("want_i16", [False, True])
def test_batch_loader_matches_jax(tmp_path, want_i16, built):
    """Files at three rates and a bad one: each index once, the bad file
    None, every file's samples equal JAX's loader's; with want_i16 the file
    already at the target rate comes back as raw int16, the others float32;
    the tones survive resampling."""
    target = 10_000
    paths = []
    for i, sr in enumerate([10_000, 16_000, 44_100]):
        p = str(tmp_path / f"f{i}.wav")
        write_wav(p, 0.4 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr), sr)
        paths.append(p)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"nope")
    paths.append(str(bad))

    def load(mod):
        loader = mod.NativeBatchLoader(target, n_threads=2, want_i16=want_i16)
        for i, p in enumerate(paths):
            loader.submit(i, p)
        got = {}
        for idx, samples in loader:
            assert idx not in got
            got[idx] = samples
        loader.close()
        return got

    got, want = load(native), load(jax_native)
    assert set(got) == set(want) == {0, 1, 2, 3}
    assert got[3] is None and want[3] is None
    for i in range(3):
        assert got[i].dtype == want[i].dtype == (np.int16 if want_i16 and i == 0 else np.float32)
        np.testing.assert_array_equal(got[i], want[i])
        x = got[i].astype(np.float32) / (32768.0 if got[i].dtype == np.int16 else 1.0)
        assert abs(len(x) - target) < 10
        spec = np.abs(np.fft.rfft(x[:8192] * np.hanning(8192)))
        assert abs(np.argmax(spec) * target / 8192 - 220) < 5


def test_batch_loader_source_rates_match_jax(tmp_path, built):
    """A 24 kHz file, outside COMMON_RATES: given source_rates=(24000,) the
    loader decodes it to 16 kHz equal to JAX's loader given the same rates
    (bit for bit), its tone intact; with the default rates both yield
    None for it. A file already at the target rate needs no taps."""
    paths = []
    for i, sr in enumerate([24_000, 16_000]):
        p = str(tmp_path / f"f{i}.wav")
        write_wav(p, 0.4 * np.sin(2 * np.pi * 330 * np.arange(sr) / sr), sr)
        paths.append(p)

    def load(mod, **kw):
        loader = mod.NativeBatchLoader(16_000, n_threads=2, **kw)
        for i, p in enumerate(paths):
            loader.submit(i, p)
        got = dict(iter(loader))
        loader.close()
        return got

    got, want = load(native, source_rates=(24_000,)), load(jax_native, source_rates=(24_000,))
    assert set(got) == set(want) == {0, 1}
    for i in (0, 1):
        assert got[i].dtype == want[i].dtype == np.float32
        np.testing.assert_array_equal(got[i], want[i])
    assert abs(len(got[0]) - 16_000) < 10
    spec = np.abs(np.fft.rfft(got[0][:8192] * np.hanning(8192)))
    assert abs(np.argmax(spec) * 16_000 / 8192 - 330) < 5
    default, jax_default = load(native), load(jax_native)
    assert default[0] is None and jax_default[0] is None
    np.testing.assert_array_equal(default[1], got[1])
