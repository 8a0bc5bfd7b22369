"""The traced part of a ``--trace 1`` run: a torch.profiler window of a few
tens of calls inside the measured window, and the view of it that the
per-layer readers take.

On the card torch.profiler loses the kernel records of a window's first
launches, more of them as the process ages. So, as the program's
``utils.obs.kernel_profile`` does (this is the benchmark's own copy of the
technique), short windows of one-element launches first count the loss,
and the real window opens with a pad of that many launches and a quarter
more, before the calls. The view keeps only what the device did between
the first call's issue and the last call's completion.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

PAD_RANGE = "bench.pad"
RANGES = (PAD_RANGE, "bench.call", "bench.wait")


def lost_kernel_records(activities: list, x: torch.Tensor, windows: int = 3, sizes=(64, 512, 4096)) -> int:
    """The kernel records lost at the start of the first of up to
    ``windows`` short windows that loses any (0 if none does). A window of
    ``sizes[i]`` launches that keeps no record is made again with the next
    size; where the largest keeps none, the profiler records no kernel and
    this raises."""
    from torch.profiler import profile

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(windows):
        for n in sizes:
            with profile(activities=activities) as prof:
                for _ in range(n):
                    x.add_(1)
                torch.cuda.synchronize()
            kept = sum(e.device_type == cuda for e in prof.events())
            if kept:
                break
        else:
            raise RuntimeError(f"torch.profiler kept no CUDA record of {sizes[-1]} launches")
        if kept < n:
            return n - kept
    return 0


@dataclass
class Traced:
    prof: object
    pad: int
    calls: range  # the loop's calls the window holds
    attempts: int


def on_device(e) -> bool:
    """Whether a profiler event is work the device did: not a host event,
    nor the device's copy of a host range."""
    return (e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.name not in RANGES)


def call_window(events) -> tuple[float, float]:
    """(first call's issue, last call's completion) on the profiler's clock."""
    calls = [e.time_range.start for e in events if e.name == "bench.call" and not on_device(e)]
    waits = [e.time_range.end for e in events if e.name == "bench.wait" and not on_device(e)]
    if not calls or not waits:
        raise RuntimeError("the traced window holds no call")
    return min(calls), max(waits)


def kernel_records_lost(prof) -> int:
    """Kernel launches the host made between the first call's issue and the
    last call's completion, less the kernel records the device kept there
    (each launch yields one record)."""
    events = prof.events()
    t0, t1 = call_window(events)
    inside = [e for e in events if e.time_range.start >= t0 and e.time_range.end <= t1]
    launches = sum(not on_device(e) and "LaunchKernel" in e.name for e in inside)
    kernels = sum(on_device(e) and is_kernel(e) for e in inside)
    return max(0, launches - kernels)


def tracer(n_calls: int, attempts: int = 3):
    """A tracer for ``loop.run_window``: ``n_calls`` calls of the loop under
    the profiler, the loop drained inside the window; a window that lost
    kernel records past its pad is made again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def once(loop) -> Traced:
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        x = torch.zeros(1, device=loop.device)
        lost = lost_kernel_records(activities, x)
        pad = lost + max(8, lost // 4)
        with profile(activities=activities) as prof:
            with record_function(PAD_RANGE):
                for _ in range(pad):
                    x.add_(1)
                torch.cuda.synchronize()
            first = len(loop.calls)
            loop.mark = record_function
            try:
                for _ in range(n_calls):
                    loop.step()
                loop.drain()
            finally:
                loop.mark = lambda name: contextlib.nullcontext()
            torch.cuda.synchronize()
        return Traced(prof, pad, range(first, len(loop.calls)), 1)

    def trace(loop) -> Traced:
        for attempt in range(1, attempts + 1):
            traced = once(loop)
            traced.attempts = attempt
            if not kernel_records_lost(traced.prof):
                break
        return traced

    return trace


@dataclass
class Op:
    name: str
    start: float  # microseconds on the profiler's clock
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


def is_kernel(op) -> bool:
    """A device op (or event) that is a kernel, not a copy or a set."""
    return not op.name.startswith(("Memcpy", "Memset"))


def merged(ops: list[Op]) -> list[tuple[float, float]]:
    """The union of the ops' intervals, as disjoint sorted intervals."""
    out: list[list[float]] = []
    for op in sorted(ops, key=lambda o: o.start):
        if out and op.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], op.end)
        else:
            out.append([op.start, op.end])
    return [(a, b) for a, b in out]


@dataclass
class TraceView:
    """What the per-layer readers read.

    ``device_ops``: kernels, copies and sets the device ran inside the
    window; ``host_ops``: the host's events on the loop's thread;
    ``window``: (first call's issue, last call's completion), microseconds;
    ``pools``: the pool batch of each traced call; ``dispatch_s``: the host
    time of every untraced call of the run from its issue to the entry's
    return; ``cell``: the cell (configuration, traffic); ``batches``: each
    pool batch's lengths and input sample width; ``lost``: kernel records
    the window lost (its kernels are then undercounted)."""

    device_ops: list[Op]
    host_ops: list[Op]
    window: tuple[float, float]
    pools: list[int]
    dispatch_s: list[float]
    cell: object
    batches: list[dict]
    lost: int = 0

    @property
    def n_calls(self) -> int:
        return len(self.pools)

    @property
    def kernels(self) -> list[Op]:
        return [op for op in self.device_ops if is_kernel(op)]

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in merged(self.device_ops))


def view_of(traced: Traced, pools: list[int], dispatch_s: list[float], cell, batches: list[dict]) -> TraceView:
    cuda = torch.autograd.DeviceType.CUDA
    events = traced.prof.events()
    t0, t1 = call_window(events)
    thread = next(e.thread for e in events if e.name == "bench.call" and not on_device(e))
    dev, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if end < t0 or start > t1:
            continue
        if on_device(e):
            dev.append(Op(e.name, max(start, t0), min(end, t1)))
        elif e.device_type != cuda and e.thread == thread:
            host.append(Op(e.name, start, end))
    return TraceView(dev, host, (t0, t1), pools, dispatch_s, cell, batches, kernel_records_lost(traced.prof))


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device ops that took most time, and the device's idle time by
    what the host was doing when each gap began (the innermost host event
    open then), in seconds."""
    by_op: dict[str, float] = {}
    for op in view.device_ops:
        by_op[short_name(op.name)] = by_op.get(short_name(op.name), 0.0) + op.dur * 1e-6
    busy = merged(view.device_ops)
    edges = [view.window[0]] + [x for iv in busy for x in iv] + [view.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    starts = np.array([op.start for op in view.host_ops])
    ends = np.array([op.end for op in view.host_ops])
    durs = ends - starts
    by_host: dict[str, float] = {}
    for a, b in gaps:
        open_at = np.flatnonzero((starts <= a) & (ends > a))
        label = view.host_ops[open_at[np.argmin(durs[open_at])]].name if open_at.size else "(no host event)"
        by_host[label] = by_host.get(label, 0.0) + (b - a) * 1e-6
    ranked = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
