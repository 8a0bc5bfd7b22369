"""One run of one cell: set-up, the measured window, the comparison, and
the result's line.

Set-up makes the traffic's pool of batches on the device from the seed,
hands each to the entry's ``prepare`` (the program's input format), and
warms every batch of the pool through the same loop the window runs. The
window then drives the entry for ``seconds``; with ``trace`` a profiler
window of ``TRACE_CALLS`` calls sits at its middle. After the window the
peak memory is read, the program's inputs are freed, and the kept calls'
outputs are compared with the plain reference. ``memory_peak_bytes`` is
the window's peak alone (the pool and the program's own), not set-up's,
whose generator scratch no deployment holds.
"""
from __future__ import annotations

import gc
import statistics
import sys

import numpy as np
import torch

from benchlib import check, trace as tracing
from benchlib.catalog import Cell, plugin
from benchlib.loop import ClosedLoop, clock, run_window

TRACE_CALLS = 40
WARM_ROUNDS = 2
GIB = float(1 << 30)


def pool_bytes(tensors) -> int:
    """Device bytes of the distinct storages among ``tensors``."""
    seen = {}
    for t in tensors:
        if t.device.type != "cpu":
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, *, marks: list[tuple[str, float]],
             control: bool = False, wrap=None, log=sys.stderr) -> dict:
    """The result's line of one run, as a dict (its keys in print order).
    ``marks``: (stage, its end on the ``loop.clock``) of set-up so far, the
    first the process's start. ``control`` runs the configuration's
    lower-precision route in the program's place; ``wrap`` (tests) wraps the
    entry."""
    config, traffic = cell.config, cell.traffic
    device = torch.device(device)
    cuda = device.type == "cuda"
    sr = config["signal_sample_rate"]
    entry = plugin("entries", config["entry"]).build(config, traffic, device, control=control)
    if wrap is not None:
        entry = wrap(entry)
    reference = plugin("reference", config["reference"])

    # set-up: the pool, the program's inputs, every batch warmed
    marks = [*marks, ("port", clock())]
    pool = plugin("gen", traffic["generator"]).make_pool(traffic, sr, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("pool", clock()))
    prepared = [entry.prepare(b) for b in pool]
    batches = [{"samples": b["samples"].cpu(), "lengths": b["lengths"], "sample_bytes": b["samples"].element_size(),
                "audio_s": float(np.sum(b["lengths"])) / sr} for b in pool]
    del pool
    loop = ClosedLoop(entry, prepared, device, np.random.default_rng([seed % (1 << 64), 1]))
    marks.append(("inputs", clock()))
    for _ in range(WARM_ROUNDS * len(prepared)):
        loop.step()
    loop.drain()
    marks.append(("warm-up", clock()))
    gc.collect()
    held = pool_bytes([t for p in prepared for t in entry.inputs(p)])
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = clock() - marks[0][1]
    print("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:])), file=log)

    win = run_window(loop, seconds, tracing.tracer(TRACE_CALLS) if trace else None)

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    untraced = [c for c in win.calls if c.index not in win.profiled]
    lat_ms = np.array([(c.t_done - c.t_issue) * 1e3 for c in untraced])
    audio_s = sum(batches[c.pool]["audio_s"] for c in win.calls)
    e2e = {
        "audio_h_per_s": metric(audio_s / 3600.0 / (win.end - win.start), "audio-h/s"),
        "call_ms_p95": metric(np.percentile(lat_ms, 95), "ms"),
        "peak_mem_gib": metric((peak - held) / GIB, "GiB"),
        "setup_s": metric(setup_s, "s"),
    }
    dispatch_s = [c.t_return - c.t_issue for c in untraced]
    kept = loop.kept
    del loop, prepared, entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    found = check.compare(kept, batches, config, reference, device)
    limits = config["limits"]
    checks = {k: {"value": found[k], "limit": limits[k]} for k in limits}
    correct = found["calls"] > 0 and all(found[k] <= limits[k] for k in limits)

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(win.calls), "failed": found["failed_calls"]}
    if trace:
        view = tracing.view_of(win.traced, [win.calls[i].pool for i in win.traced.calls], dispatch_s, cell, batches)
        print(f"trace: {view.n_calls} calls in {view.window_us * 1e-3:.3f} ms, attempt {win.traced.attempts}, pad "
              f"{win.traced.pad}, kernel records lost {view.lost}", file=log)
        metrics = {}
        for m in cell.per_layer:
            v = plugin("metrics", m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = metric(v, m["unit"])
        dev |= {"busy_s": view.busy_us * 1e-6, "window_s": view.window_us * 1e-6}
        result |= {"metrics": metrics, "device": dev, "breakdown": tracing.breakdown(view)}
    else:
        result |= {"metrics": {m["name"]: e2e[m["name"]] for m in cell.end_to_end}, "device": dev}
    result["checks"] = checks
    print(f"entry {config['entry']}; {len(win.calls)} calls in {win.end - win.start:.3f} s; compared {found['calls']} "
          f"calls, {found['rows']} utterances; dispatch median {1e3 * statistics.median(dispatch_s):.3f} ms",
          file=log)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log)
    return result
