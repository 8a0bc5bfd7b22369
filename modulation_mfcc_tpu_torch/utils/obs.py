"""Observability: structured event records, throughput counters, a
profiler hook and the program's own spans.

  * ``log_event`` — one-line JSON records on stderr (machine-parsable);
  * ``ThroughputMeter`` — audio-hours/sec counters (what a corpus sweep
    pays for);
  * ``kernel_profile`` — a torch.profiler window that keeps every kernel
    its block launches;
  * ``profile_trace`` — a torch.profiler trace of a block, written under a
    directory; transparent when no directory is given;
  * ``span`` — a layer of the program as a span: recorded, with a
    ``record_function`` range in the trace (which links the span's
    kernels to it), exactly while a torch.profiler window records in this
    process (``recording()``);
    ``setup_span`` — a piece of set-up, recorded always; ``spans()`` — the
    finished records.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import socket
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import torch
from torch._C._autograd import _profiler_enabled

__all__ = ["log_event", "ThroughputMeter", "kernel_profile", "profile_trace", "span", "setup_span", "annotate",
           "recording", "spans", "SpanRecord"]


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
        log_event("profile.kernel_records_lost", lost=missing)


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


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

RING = 16_384  # the hot path's span records kept, the newest
SETUP_KEPT = 4_096  # set-up span records kept, the newest


@dataclass
class SpanRecord:
    """A finished span. ``start_ns``/``end_ns``: ``time.perf_counter_ns``
    at the span's body's start and end; ``parent``: the id of the span open
    on this thread at its entry (None for a root), ``root``: the id of its
    root (one id a call). The span's device time is in the profiler's
    trace: its range there links the kernels it launched."""

    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int
    attrs: dict = field(default_factory=dict)


# A span's range in the profiler's trace: torch's record_function without
# its Python-level op dispatch (1.7 against 14.6 µs a range on a CPU under
# torch 2.13), so a traced call's host times stay near an untraced one's;
# the kernels a range launches are linked to it all the same.
_Range = torch._C._profiler._RecordFunctionFast
recording = _profiler_enabled  # whether spans record now: a torch.profiler window records in this process
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_ring: deque[SpanRecord] = deque(maxlen=RING)
_setup: deque[SpanRecord] = deque(maxlen=SETUP_KEPT)


def _open_spans() -> list:
    """This thread's open recording spans, innermost last."""
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


def _decorate(name: str, attrs: dict, setup: bool, fn):
    @functools.wraps(fn)
    def spanned(*args, **kw):
        with (setup_span(name) if setup else span(name, **attrs)):
            return fn(*args, **kw)

    return spanned


class _Recording:
    """A span that records: entered, it pushes itself on this thread's open
    spans and opens its range while a profiler records; left, it closes
    the range and keeps a ``SpanRecord``."""

    __slots__ = ("name", "attrs", "setup", "id", "parent", "root", "start_ns", "range")

    def __init__(self, name: str, attrs: dict, setup: bool):
        self.name, self.attrs, self.setup = name, attrs, setup

    def set(self, **attrs) -> None:
        """Add attributes to the record."""
        self.attrs.update(attrs)

    def __call__(self, fn):
        return _decorate(self.name, self.attrs, self.setup, fn)

    def __enter__(self) -> _Recording:
        stack = _open_spans()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent, self.root = (up.id, up.root) if up is not None else (None, self.id)
        self.range = None
        if _profiler_enabled():
            self.range = _Range(self.name)
            self.range.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.perf_counter_ns()
        stack = _open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = SpanRecord(self.name, self.id, self.parent, self.root, self.start_ns, end_ns, self.attrs)
        with _lock:
            (_setup if self.setup else _ring).append(rec)


class _Off:
    """A span while the recorder is off: enters as None, records nothing."""

    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None

    def __call__(self, fn):
        return _decorate(self.name, self.attrs, False, fn)


_OFF: dict[str, _Off] = {}  # one off span a name, for spans without attributes


def span(name: str, **attrs):
    """A layer of the program as a span: a context manager (entered as the
    open span, or as None while the recorder is off), also a decorator.

    The recorder is on exactly while a torch.profiler window records in
    this process (``kernel_profile``, ``profile_trace``, any profiler).
    Off, a span is one check and records nothing. On, it records its host
    times, its id, its parent's and its root's (``SpanRecord``), and opens
    a ``record_function`` range of the profiler's trace, which links the
    kernels the span launches to it: a span's device time is read from the
    trace, and a span makes no CUDA call of its own. ``attrs`` (and
    ``set(...)`` on the open span) are the record's attributes."""
    if _profiler_enabled():
        return _Recording(name, attrs, False)
    if attrs:
        return _Off(name, attrs)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name, {})
    return off


def setup_span(name: str) -> _Recording:
    """A piece of set-up as a span, recorded whether or not a profiler
    records (each runs once a process, off the hot path; its count is the
    program's count of what it built, and built again): host times, with a
    ``record_function`` range while a profiler records. A context manager,
    also a decorator."""
    return _Recording(name, {}, True)


def annotate(**attrs) -> None:
    """Add attributes to this thread's innermost open span. A hot path
    checks ``recording()`` first, so that it builds no attributes while
    the recorder is off."""
    stack = _open_spans()
    if stack:
        stack[-1].attrs.update(attrs)


def spans() -> list[SpanRecord]:
    """The finished span records kept (set-up's, and the newest ``RING`` of
    the rest), in order of entry."""
    with _lock:
        recs = [*_setup, *_ring]
    return sorted(recs, key=lambda r: (r.start_ns, r.id))
