"""ctypes binding for the native host IO runtime (``native/modmfcc_io.cpp``).

The same C++ source the JAX package binds, used unchanged: WAV decode,
polyphase resampling with caller-supplied taps, and a threaded batch loader
that decodes and resamples many files while the caller drains results.

The library builds with g++ (the flags of ``native/Makefile``) at first
use into ``modulation_mfcc_tpu_torch/_build/`` (git-ignored); the file name
carries a hash of the source and flags, the build writes a temporary name
and renames it, and nothing is written into ``native/``. Nothing builds at
import. The loader is a throughput option of the corpus sweep: where the
library cannot be built, the sweep logs ``corpus.native_loader_unavailable``
and decodes with the Python reader (io/wav.py).

The polyphase taps are designed on the host (``io/wav.design_hq_taps``), so
the native resampler and the Python path filter with the same taps.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from modulation_mfcc_tpu_torch.io.wav import design_hq_taps

__all__ = ["native_available", "decode_wav_native", "resample_native", "design_resample_taps",
           "NativeBatchLoader", "library_path", "build", "load_library"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "modmfcc_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's CXXFLAGS and LDFLAGS
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    """Where the library for the current source and flags lives (built or not)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmodmfcc_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/modmfcc_io.cpp`` unless the library for this source
    exists; raises (OSError, subprocess.CalledProcessError) when it cannot."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True, capture_output=True,
                   timeout=300)
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a partial file
    return out


@lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built library, loaded once per process; raises (OSError,
    subprocess.SubprocessError) where it cannot be built or loaded."""
    lib = ctypes.CDLL(str(build()))
    lib.modmfcc_decode_wav.restype = ctypes.c_long
    lib.modmfcc_decode_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(_F32P), ctypes.POINTER(ctypes.c_int)]
    lib.modmfcc_resample.restype = ctypes.c_long
    lib.modmfcc_resample.argtypes = [_F32P, ctypes.c_long, ctypes.c_int, ctypes.c_int, _F64P, ctypes.c_int,
                                     ctypes.POINTER(_F32P)]
    lib.modmfcc_free.restype = None
    lib.modmfcc_free.argtypes = [ctypes.c_void_p]
    lib.modmfcc_loader_create2.restype = ctypes.c_void_p
    lib.modmfcc_loader_create2.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.modmfcc_loader_add_taps.restype = None
    lib.modmfcc_loader_add_taps.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _F64P, ctypes.c_int]
    lib.modmfcc_loader_submit.restype = None
    lib.modmfcc_loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.modmfcc_loader_next2.restype = ctypes.c_int
    lib.modmfcc_loader_next2.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                         ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
    lib.modmfcc_loader_destroy.restype = None
    lib.modmfcc_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here (g++ present)."""
    try:
        load_library()
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def design_resample_taps(up: int, down: int) -> np.ndarray:
    """The package's kaiser_best-grade polyphase taps (io/wav.py), without
    the ``up`` gain, which the native kernel applies: the Python and native
    resamplers filter with the same design."""
    return design_hq_taps(up, down)


def decode_wav_native(path: str) -> tuple[np.ndarray, int]:
    """(float32 samples of the first channel, sample rate); raises
    ValueError when the file does not decode."""
    lib = load_library()
    data, sr = _F32P(), ctypes.c_int()
    n = lib.modmfcc_decode_wav(path.encode(), ctypes.byref(data), ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"{path}: native WAV decode failed")
    out = np.ctypeslib.as_array(data, shape=(n,)).copy()
    lib.modmfcc_free(data)
    return out, sr.value


def resample_native(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly(x, up, down) with :func:`design_resample_taps`,
    in the native float32 kernel."""
    lib = load_library()
    taps = design_resample_taps(up, down)
    x32 = np.ascontiguousarray(x, dtype=np.float32)
    out = _F32P()
    n = lib.modmfcc_resample(x32.ctypes.data_as(_F32P), len(x32), up, down, taps.ctypes.data_as(_F64P),
                             len(taps), ctypes.byref(out))
    y = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib.modmfcc_free(out)
    return y


class NativeBatchLoader:
    """Threaded decode and resample of many files to ``target_sr``: submit
    (index, path) pairs, then iterate (index, samples or None) in the order
    files finish. A file that fails to decode, or whose rate is neither
    ``target_sr`` nor one of ``source_rates`` (default :data:`COMMON_RATES`),
    yields None. ``want_i16=True``: 16-bit PCM files that need no
    resampling come back as raw np.int16 (the corpus upload grid), every
    other file as float32."""

    COMMON_RATES = (8000, 11025, 16000, 22050, 32000, 44100, 48000, 96000)

    def __init__(self, target_sr: int, n_threads: int = 4, source_rates=None, want_i16: bool = False):
        self._lib = load_library()
        self._h = self._lib.modmfcc_loader_create2(n_threads, target_sr, int(want_i16))
        for orig in source_rates or self.COMMON_RATES:
            if orig == target_sr:
                continue
            g = math.gcd(int(orig), int(target_sr))
            up, down = target_sr // g, orig // g
            taps = design_resample_taps(up, down)  # the loader copies them
            self._lib.modmfcc_loader_add_taps(self._h, up, down, taps.ctypes.data_as(_F64P), len(taps))

    def submit(self, index: int, path: str) -> None:
        self._lib.modmfcc_loader_submit(self._h, index, path.encode())

    def __iter__(self):
        while True:
            data, n, is_i16 = ctypes.c_void_p(), ctypes.c_long(), ctypes.c_int()
            idx = self._lib.modmfcc_loader_next2(self._h, ctypes.byref(data), ctypes.byref(n), ctypes.byref(is_i16))
            if idx < 0:
                return
            if n.value < 0:
                yield idx, None
                continue
            ptr = ctypes.cast(data, ctypes.POINTER(ctypes.c_int16 if is_i16.value else ctypes.c_float))
            out = np.ctypeslib.as_array(ptr, shape=(n.value,)).copy() if n.value else (
                np.zeros(0, np.int16 if is_i16.value else np.float32))
            self._lib.modmfcc_free(data)
            yield idx, out

    def close(self) -> None:
        if self._h:
            self._lib.modmfcc_loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
