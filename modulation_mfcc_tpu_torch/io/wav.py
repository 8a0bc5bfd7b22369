"""WAV decoding and resampling to an analysis rate (host-side, numpy and
scipy float64).

:func:`read_wav` decodes PCM and float WAV files with plain numpy over the
RIFF layout and :func:`write_wav` writes 16-bit PCM; :func:`load_channel`
decodes, resamples and selects a channel, as the reference's
``librosa.load`` call does (script/mfcc.py:262-289).
The formant tracker resamples to twice its ceiling before the LPC stage,
as Praat does. The polyphase filter is kaiser_best grade
(:func:`design_hq_taps`), the JAX package's own design, so both packages
resample identically.
"""
from __future__ import annotations

import struct
import wave
from fractions import Fraction
from functools import lru_cache

import numpy as np
from scipy.signal import firwin, resample_poly

__all__ = ["read_wav", "write_wav", "load_channel", "design_hq_taps", "resample", "resample_ratio"]


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float32 samples [channels, n] or [n], sample_rate).

    Integer PCM is scaled to [-1, 1) like librosa/soundfile (int16 → /2**15,
    int32 → /2**31, 24-bit → /2**23, uint8 → offset binary); float32 and
    float64 pass through. WAVE_FORMAT_EXTENSIBLE reads its SubFormat code.
    """
    with open(path, "rb") as f:
        riff, _size, wave_id = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        fmt_payload = b""
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            payload = f.read(csize + (csize & 1))
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
                fmt_payload = payload
            elif cid == b"data":
                data = payload[:csize]
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_ch, sr, _brate, _align, bits = fmt
    if audio_format == 0xFFFE:
        audio_format = struct.unpack("<H", fmt_payload[24:26])[0] if len(fmt_payload) >= 26 else 1
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 2**15
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2**31
        elif bits == 8:
            x = (np.frombuffer(data, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, "u1").reshape(-1, 3)
            as32 = raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8) | (raw[:, 2].astype(np.int32) << 16)
            as32 = (as32 ^ 0x800000) - 0x800000  # sign-extend
            x = as32.astype(np.float32) / 2**23
        else:
            raise ValueError(f"Unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV format code {audio_format}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).T
    return x, sr


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write float [-1, 1] (or int16) samples, [n] or [channels, n], as
    16-bit PCM WAV."""
    x = np.asarray(x)
    if x.ndim > 1:
        x = x.T  # [n, channels]
    if x.dtype != np.int16:
        x = np.clip(x, -1.0, 1.0)
        x = (x * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if x.ndim == 1 else x.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())


def load_channel(path: str, signal_sample_rate: float = 10_000, channel_nb: int = 0) -> np.ndarray:
    """Decode, resample to the analysis rate (float64) and select a channel:
    mono input returns 1-D, multichannel input its channel ``channel_nb``."""
    x, sr = read_wav(path)
    y = resample(x.astype(np.float64), sr, signal_sample_rate)
    if y.ndim > 1:
        y = y[channel_nb]
    return y


@lru_cache(maxsize=16)
def design_hq_taps(up: int, down: int) -> np.ndarray:
    """kaiser_best-grade polyphase anti-alias filter (without the ``up``
    gain, which resample_poly applies): a ~64-zero-crossing Kaiser-windowed
    sinc with rolloff ≈ 0.9476 and β ≈ 14.77 (resampy's published
    kaiser_best spec); stopband < −100 dB, passband ripple ~1e-5."""
    n_zeros = 64
    rolloff = 0.9475937167399596
    beta = 14.769656459379492
    m = max(up, down)
    half_len = n_zeros * m
    return firwin(2 * half_len + 1, rolloff / m, window=("kaiser", beta)).astype(np.float64)


def resample_ratio(orig_sr: float, target_sr: float) -> tuple[int, int]:
    """(up, down) of the polyphase resampler from ``orig_sr`` to ``target_sr``."""
    frac = Fraction(int(round(target_sr)), int(round(orig_sr))).limit_denominator(1000)
    return frac.numerator, frac.denominator


def resample(x: np.ndarray, orig_sr: float, target_sr: float, taps: np.ndarray | None = None) -> np.ndarray:
    """Polyphase resampling along the last axis (kaiser_best-grade filter).
    ``taps`` overrides the designed filter (the same array, carried as a
    module buffer)."""
    if orig_sr == target_sr:
        return x
    up, down = resample_ratio(orig_sr, target_sr)
    window = design_hq_taps(up, down) if taps is None else taps
    return resample_poly(x, up, down, axis=-1, window=window)
