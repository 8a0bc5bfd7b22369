"""Microphone recording / playback (host utility, optional dependency).

Capability parity with the reference's record/play surface
(script/main.py:2007-2104: 44.1 kHz int16 InputStream recording with live
waveform callbacks, save-to-WAV, region playback) — implemented against
``sounddevice`` when present and cleanly gated when not (this framework's
deployment targets are usually headless compute hosts without audio hardware).

Design differences from the reference: no unsynchronized GUI mutation from
callback threads (SURVEY.md §5 known-racy patterns) — the recorder owns a
lock-protected buffer and the caller polls ``snapshot()``.
"""
from __future__ import annotations

import threading

import numpy as np

from modulation_mfcc_tpu_torch.io.wav import write_wav

__all__ = [
    "audio_device_available",
    "Recorder",
    "play",
    "play_region",
    "animate_position",
]


def _sd():
    try:
        import sounddevice

        return sounddevice
    except Exception as e:  # pragma: no cover - env without sounddevice
        raise RuntimeError(
            "sounddevice is not available in this environment; recording/"
            "playback are host utilities and require an audio device"
        ) from e


def audio_device_available() -> bool:
    try:
        _sd()
        return True
    except RuntimeError:
        return False


class Recorder:
    """Push-to-record microphone capture (reference toggle_recording)."""

    def __init__(self, sample_rate: int = 44_100, channels: int = 1):
        self.sample_rate = sample_rate
        self.channels = channels
        self._lock = threading.Lock()
        self._frames: list[np.ndarray] = []
        self._stream = None

    def start(self):
        sd = _sd()

        def callback(indata, frames, time_info, status):
            with self._lock:
                self._frames.append(indata.copy())

        self._stream = sd.InputStream(
            samplerate=self.sample_rate,
            channels=self.channels,
            dtype="int16",
            callback=callback,
        )
        self._stream.start()

    def snapshot(self) -> np.ndarray:
        """Samples so far (int16) — the live-waveform poll."""
        with self._lock:
            if not self._frames:
                return np.zeros((0,), dtype=np.int16)
            return np.concatenate(self._frames, axis=0)[:, 0]

    def stop(self) -> np.ndarray:
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None
        return self.snapshot()

    def save(self, path: str) -> str:
        """Write the recording (trimmed of pure-silence tail like the
        reference's non-zero check, main.py:2026-2036)."""
        data = self.snapshot()
        nz = np.flatnonzero(data)
        if len(nz):
            data = data[: nz[-1] + 1]
        write_wav(path, data, self.sample_rate)
        return path


def play(samples: np.ndarray, sample_rate: int, *, blocking: bool = True):
    sd = _sd()
    sd.play(np.asarray(samples), sample_rate)
    if blocking:
        sd.wait()


def animate_position(
    start: float,
    end: float,
    callback,
    *,
    fps: float = 60.0,
    clock=None,
):
    """Drive ``callback(pos)`` from start→end in real time at ~fps, then
    ``callback(None)`` (cursor hide) — the reference's animate_cursor loop
    (script/main.py:2081-2098) decoupled from the GUI. ``clock`` is an
    injectable (time, sleep) pair for tests."""
    import time as _time

    now, sleep = clock if clock is not None else (_time.time, _time.sleep)
    t0 = now()
    duration = max(0.0, end - start)
    while True:
        pos = min(start + (now() - t0), end)
        callback(pos)
        if pos >= end:
            break
        sleep(max(0.0, min(1.0 / fps, duration)))
    callback(None)


def play_region(
    path: str,
    start: float,
    end: float,
    *,
    blocking: bool = True,
    position_callback=None,
    fps: float = 60.0,
):
    """Play [start, end] seconds of a WAV (reference play_selected_region).

    ``position_callback`` mirrors the reference's animated playback cursor
    (main.py:2053-2098): called with the current position at ~fps on a
    worker thread while the region plays, then with None when done."""
    import threading

    from modulation_mfcc_tpu_torch.io.wav import read_wav

    x, sr = read_wav(path)
    if x.ndim > 1:
        x = x[0]
    seg = x[int(start * sr) : int(end * sr)]
    thread = None
    if position_callback is not None:
        thread = threading.Thread(
            target=animate_position, args=(start, end, position_callback),
            kwargs={"fps": fps}, daemon=True,
        )
    play(seg, sr, blocking=False)
    if thread is not None:
        thread.start()
    if blocking:
        _sd().wait()
        if thread is not None:
            thread.join(timeout=5.0)
