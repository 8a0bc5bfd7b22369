"""The measured window: a closed loop with two calls in flight.

Before issuing call i the loop waits for call i - 2, as the corpus sweep
keeps two batches in flight. A call is complete when its outputs are in
pinned host memory: each call's outputs are copied without blocking into a
host buffer of its own slot, and an event recorded after the copies marks
the end. The host clock is read at the call's issue, at the entry's return
(the enqueue) and when the host sees the event done.

A seeded reservoir keeps ``keep`` calls' outputs, drawn uniformly from all
the calls of the window, for the comparison after it closes.
"""
from __future__ import annotations

import contextlib
import math
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

clock = time.perf_counter


@dataclass
class Call:
    index: int
    pool: int
    t_issue: float
    t_return: float
    t_done: float = math.nan


@dataclass
class Kept:
    """One call's outputs, copied from its host buffers once it completed."""

    pool: int
    outputs: tuple[np.ndarray, ...]


class ClosedLoop:
    def __init__(self, entry, prepared: list, device, rng: np.random.Generator, *, depth: int = 2, keep: int = 4):
        self.entry, self.prepared = entry, prepared
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rng, self.depth, self.keep = rng, depth, keep
        self.calls: list[Call] = []
        self.kept: list[Kept] = []
        self.inflight: deque = deque()
        self.host: dict[tuple[int, int], tuple[torch.Tensor, ...]] = {}
        self.mark = lambda name: contextlib.nullcontext()

    def _buffers(self, slot: int, k: int, outs: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
        key = (slot, k)
        # set-up's warm-up fills every (slot, batch); outputs of another
        # shape than before (a fault) get buffers of their own
        if key not in self.host or [(b.shape, b.dtype) for b in self.host[key]] != [(o.shape, o.dtype) for o in outs]:
            self.host[key] = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=self.cuda) for o in outs)
        return self.host[key]

    def issue(self) -> None:
        i = len(self.calls)
        k = i % len(self.prepared)
        with self.mark("bench.call"):
            t0 = clock()
            outs = self.entry(self.prepared[k])
            t1 = clock()
            bufs = self._buffers(i % self.depth, k, outs)
            for b, o in zip(bufs, outs):
                b.copy_(o, non_blocking=True)
            ev = None
            if self.cuda:
                ev = torch.cuda.Event()
                ev.record()
        call = Call(i, k, t0, t1)
        self.calls.append(call)
        self.inflight.append((call, ev, bufs))

    def complete_oldest(self) -> None:
        call, ev, bufs = self.inflight.popleft()
        with self.mark("bench.wait"):
            if ev is not None:
                ev.synchronize()
        call.t_done = clock()
        # reservoir sampling (algorithm R): each call kept with probability keep / n
        n = call.index + 1
        slot = call.index if n <= self.keep else int(self.rng.integers(0, n))
        if slot < self.keep:
            kept = Kept(call.pool, tuple(b.numpy().copy() for b in bufs))
            if slot < len(self.kept):
                self.kept[slot] = kept
            else:
                self.kept.append(kept)

    def step(self) -> None:
        if len(self.inflight) >= self.depth:
            self.complete_oldest()
        self.issue()

    def drain(self) -> None:
        while self.inflight:
            self.complete_oldest()

    def reset(self) -> None:
        """Forget the calls made so far (set-up's warm-up), keep the buffers."""
        self.drain()
        self.calls, self.kept = [], []


@dataclass
class WindowResult:
    start: float
    end: float
    calls: list[Call]
    traced: object | None  # the tracer's result; its ``calls`` the traced calls
    profiled: range  # every call made under the tracer, its retries too


def run_window(loop: ClosedLoop, seconds: float, tracer=None) -> WindowResult:
    """Drive ``loop`` for ``seconds``; the calls in flight at the deadline
    complete inside the window. With ``tracer`` (a callable taking the loop
    and returning its trace), the loop drains at the window's middle and
    ``tracer`` runs its calls there."""
    loop.reset()
    start = clock()
    deadline = start + seconds
    traced, profiled = None, range(0)
    while clock() < deadline:
        if tracer is not None and traced is None and clock() >= start + seconds / 2:
            loop.drain()
            first = len(loop.calls)
            traced = tracer(loop)
            profiled = range(first, len(loop.calls))
            continue
        loop.step()
    loop.drain()
    return WindowResult(start, clock(), loop.calls, traced, profiled)
