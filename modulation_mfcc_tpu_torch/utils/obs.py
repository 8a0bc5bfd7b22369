"""Observability: structured event records, throughput counters and a
profiler hook.

  * ``log_event`` — one-line JSON records on stderr (machine-parsable);
  * ``ThroughputMeter`` — audio-hours/sec counters (what a corpus sweep
    pays for);
  * ``kernel_profile`` — a torch.profiler window that keeps every kernel
    its block launches;
  * ``profile_trace`` — a torch.profiler trace of a block, written under a
    directory; transparent when no directory is given.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import sys
import time

__all__ = ["log_event", "ThroughputMeter", "kernel_profile", "profile_trace"]


def log_event(event: str, **fields) -> None:
    rec = {"ts": round(time.time(), 3), "event": event, **fields}
    print(json.dumps(rec), file=sys.stderr, flush=True)


class ThroughputMeter:
    """Accumulates processed audio seconds; reports audio-hours/sec."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.audio_seconds = 0.0
        self.items = 0

    def add(self, audio_seconds: float, items: int = 1):
        self.audio_seconds += audio_seconds
        self.items += items

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def audio_hours_per_sec(self) -> float:
        e = self.elapsed
        return (self.audio_seconds / 3600.0) / e if e > 0 else 0.0

    def report(self) -> dict:
        return {
            "items": self.items,
            "audio_hours": round(self.audio_seconds / 3600.0, 4),
            "elapsed_sec": round(self.elapsed, 3),
            "audio_hours_per_sec": round(self.audio_hours_per_sec, 6),
        }


PROFILER_PAD = "profile_trace.pad"  # the record_function range of kernel_profile's pad launches


def _lost_kernel_records(activities: list, x, windows: int = 3) -> int:
    """The kernel records lost at the start of the first of up to
    ``windows`` short torch.profiler windows opened now that loses any, 0
    when none does. A window holds ``n`` launches on the one-element
    tensor ``x`` and counts their records; ``n`` grows while all are
    lost."""
    import torch
    from torch.profiler import profile

    for _ in range(windows):
        n = 64
        while True:
            with profile(activities=activities) as prof:
                for _ in range(n):
                    x.add_(1)
                torch.cuda.synchronize()
            kept = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
            if kept:
                break
            n *= 8
        if kept < n:
            return n - kept
    return 0


def _block_records_lost(prof, pad: int) -> int:
    """The kernel records a padded window lost beyond its ``pad`` first
    launches: its kernel launch calls less its kernel records (a window
    loses its first records, so the pad's go first)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    launches = sum(e.device_type != cuda and "LaunchKernel" in e.name for e in events)
    kernels = sum(e.device_type == cuda and not e.name.startswith(("Memcpy", "Memset")) for e in events)
    return max(0, launches - kernels - pad)


@contextlib.contextmanager
def kernel_profile():
    """A torch.profiler window around the block, yielding the profile: CPU
    activity, and CUDA activity where CUDA is available, every kernel the
    block launches kept.

    On the card torch.profiler loses the kernel records of the first
    launches of a window, more of them as the process ages: none in a
    fresh process, dozens some minutes on (PERF.md §6). No wait inside the
    window brings them back, and a window opened right after one that lost
    records mostly loses none. So up to three short windows are opened
    first, until one loses records, and the real window opens right after
    them with a pad: as many one-element launches as that one lost, and a
    quarter more (at least 8), under ``record_function(PROFILER_PAD)``, so
    that the records a window loses are the pad's. A synchronize ends the
    block inside the window. Now and then a window loses more than its pad
    (PERF.md §6); a ``profile.kernel_records_lost`` event (log_event) then
    says how many of the block's kernel records are missing."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        x = torch.zeros(1, device="cuda")
        lost = _lost_kernel_records(activities, x)
        pad = lost + max(8, lost // 4)
    with profile(activities=activities) as prof:
        if cuda:
            with record_function(PROFILER_PAD):
                for _ in range(pad):
                    x.add_(1)
                torch.cuda.synchronize()
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if cuda and (missing := _block_records_lost(prof, pad)):
        log_event("profile.kernel_records_lost", lost=missing, pad=pad)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the block with torch.profiler when ``log_dir`` is set;
    transparent otherwise.

    Records CPU activity, and CUDA activity (every kernel launched on the
    card, the hand-written ones through ctypes included) where CUDA is
    available, through :func:`kernel_profile`, and writes one Chrome trace
    JSON, ``<host>_<pid>.<ns>.pt.trace.json``, under ``log_dir`` when the
    block ends, also when it raises. Open it in Perfetto or
    chrome://tracing, or read its ``traceEvents``: a device kernel's event
    has ``"cat": "kernel"``, and on CUDA the block's kernels follow the
    pad's, launched under the ``PROFILER_PAD`` range. The JAX package's
    ``profile_trace`` writes TensorBoard's profile format instead."""
    if not log_dir:
        yield
        return
    prof = None
    try:
        with kernel_profile() as prof:
            yield
    finally:
        if prof is not None:
            os.makedirs(log_dir, exist_ok=True)
            name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
            prof.export_chrome_trace(os.path.join(log_dir, name))
