"""Host → device input pipeline: decode-ahead thread and device prefetch.

  host thread(s): WAV decode + resample + pad into numpy batches
  prefetcher:     copies the next batches to the card while the current one
                  computes: pinned host tensors, ``non_blocking`` copies on
                  a copy stream of their own, the compute stream waiting on
                  each batch's copy event
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

__all__ = ["prefetch_to_device", "background_iter"]


def background_iter(it: Iterable, maxsize: int = 4) -> Iterator:
    """Run an iterator in a daemon thread, buffering up to ``maxsize`` items
    (the host decode stage); an exception in the thread is raised in the
    consumer."""
    q: queue.Queue = queue.Queue(maxsize=maxsize)
    end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            q.put(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def prefetch_to_device(
    batches: Iterable[dict[str, np.ndarray]], depth: int = 2, device=None, stats: dict | None = None
) -> Iterator[dict[str, torch.Tensor]]:
    """Keep ``depth`` batches in flight to ``device`` (default CUDA) ahead of
    the consumer. Each item is a dict of numpy arrays; each yielded item the
    same dict of device tensors, ready to use on the current stream.

    On CUDA each array is pinned and copied with ``non_blocking=True`` on a
    copy stream, so the copy of batch k+1 overlaps the computation on batch
    k. Before a batch is yielded the compute stream waits on its copy event,
    and every tensor is ``record_stream``-ed to the compute stream, so the
    caching allocator cannot hand its memory out again while the compute
    stream still reads it.

    ``stats`` (optional) accumulates ``upload_mb`` (bytes copied) and
    ``upload_busy_s`` (the copy stream's busy time, from CUDA events around
    each batch's copies; the copies of one stream never overlap), the latter
    when the iterator is exhausted or closed.
    """
    device = resolve_device(device)
    if stats is not None:
        stats.setdefault("upload_mb", 0.0)
        stats.setdefault("upload_busy_s", 0.0)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    events: list[tuple] = []

    def put(item: dict[str, np.ndarray]):
        if stats is not None:
            stats["upload_mb"] += sum(np.asarray(v).nbytes for v in item.values()) / 1e6
        if not cuda:
            return {k: torch.as_tensor(v, device=device) for k, v in item.items()}, None
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in item.items()}
        start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(copy_stream):
            start.record(copy_stream)
            out = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            done.record(copy_stream)
        events.append((start, done))
        return out, done

    def ready(out: dict[str, torch.Tensor], done) -> dict[str, torch.Tensor]:
        if done is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            for t in out.values():
                t.record_stream(compute)
        return out

    it = iter(batches)
    buf: deque = deque()
    try:
        for item in it:
            buf.append(put(item))
            if len(buf) >= depth:
                break
        while buf:
            out, done = buf.popleft()
            nxt = next(it, None)
            if nxt is not None:
                buf.append(put(nxt))
            yield ready(out, done)
    finally:
        if stats is not None:
            for start, done in events:
                done.synchronize()
                stats["upload_busy_s"] += start.elapsed_time(done) / 1e3
