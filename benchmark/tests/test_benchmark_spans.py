"""The readers of the program's spans (their ranges in the profiler's
trace, and ``utils.obs.spans``) on traces and records made by hand, the
trajectory stage's least work counted by hand, and on an NVIDIA card
(skips elsewhere) a traced run that reports them."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchlib import trace as tracing
from benchlib.catalog import BENCH_DIR, find_cell, plugin, read_json
from modulation_mfcc_tpu_torch.utils import obs

ROOT = Path(__file__).resolve().parent.parent.parent
SPAN_METRICS = ("call_device_ms", "trajectory_span_ms", "trajectory_roofline", "trajectory_dispatch_ms",
                "host_late_pct", "port_setup_s")
CFG16 = read_json(BENCH_DIR / "configs" / "modcep16k.json")
PEAKS = read_json(BENCH_DIR / "roofline" / "peaks.json")
LENGTHS = np.full(128, 480_000)


# a call's spans and, under each, the durations (µs) of the kernels it launches
CALL = (("batched_mfcc_change", ()), ("frame_mask", (20.0,)), ("frontend", ()), ("frontend.mel", (8000.0,)),
        ("frontend.peak", (10.0, 10.0)), ("frontend.tail", (500.0,)), ("trajectory", ()),
        ("trajectory.filter", (300.0, 100.0)), ("trajectory.diff", (50.0, 50.0)), ("trajectory.out", (100.0,)))
PARENT = {"frame_mask": "batched_mfcc_change", "frontend": "batched_mfcc_change",
          "trajectory": "batched_mfcc_change"}
TRAJ_US = 600.0  # the trajectory kernels' time a call
CALL_US = 9140.0  # all of a call's kernels


class Trace:
    """A traced window made by hand, as the profiler's trace gives it to
    the harness: the program's ranges, kernel launch calls and the other
    host events on the loop's thread, and the kernels of one stream, each
    starting at its launch or when the kernel before it ends."""

    def __init__(self):
        self.host, self.dev, self.t, self.free = [], [], 0.0, 0.0

    def launch(self, us):
        self.host.append(tracing.Op("cudaLaunchKernel", self.t, self.t + 3.0))
        start = max(self.t + 5.0, self.free)
        self.dev.append(tracing.Op("kernel", start, start + us))
        self.free = start + us
        self.t += 5.0

    def call(self, late_us=0.0, skip=(), launch_host_us=5.0):
        """One call: the host first idle for ``late_us`` past the device's
        last kernel; then each span's range (nested as the program nests
        them) around its launches, then the output copy and the wait."""
        self.t = max(self.t, self.free + late_us) if late_us else self.t
        self.host.append(tracing.Op("bench.call", self.t, self.t))
        opened, t0 = {}, self.t
        for name, kernels in CALL:
            if name in skip or name.split(".")[0] in skip:
                continue
            self.close(opened, name)
            opened[name] = self.t
            self.t += 1.0
            for us in kernels:
                self.launch(us)
                self.t += launch_host_us - 5.0
        self.close(opened, None)
        self.host.append(tracing.Op("aten::copy_", self.t, self.t + 2.0))
        self.dev.append(tracing.Op("Memcpy DtoH (Device -> Pinned)", self.free, self.free + 40.0))
        self.free += 40.0
        self.t += 10.0
        return t0

    def close(self, opened, name):
        """End the open ranges that do not hold ``name``, innermost first."""
        holds = {name}
        while name in PARENT or (name and "." in name):
            name = PARENT.get(name) or name.rsplit(".", 1)[0]
            holds.add(name)
        for open_name in [n for n in reversed(opened) if n not in holds]:
            self.host.append(tracing.Op(open_name, opened.pop(open_name), self.t))
            self.t += 1.0

    def view(self, n_calls):
        self.host.append(tracing.Op("bench.wait", self.t, self.free))
        batches = [{"lengths": LENGTHS, "sample_bytes": 4}]
        return tracing.TraceView(self.dev, self.host, (0.0, self.free), [0] * n_calls, [0.002],
                                 find_cell("modcep16k.uniform30s"), batches)


def records(*names, parent=None):
    """Span records of the given names, made by hand (the ring's)."""
    return [obs.SpanRecord(n, i + 1, parent, i + 1, 0, 1) for i, n in enumerate(names)]


def read_all(monkeypatch, v, recs=None):
    recs = records(*(n for n, _ in CALL)) if recs is None else recs
    monkeypatch.setattr(obs, "spans", lambda: recs)
    return {m: plugin("metrics", m).read(v) for m in SPAN_METRICS}


def test_span_readers_on_a_made_trace(monkeypatch):
    """Three calls issued well ahead of the device: each call's kernels
    back to back, so its device time is the sum of its kernels'; no span
    entry finds the stream dry after the first call."""
    tr = Trace()
    for _ in range(3):
        tr.call()
    v = tr.view(3)
    got = read_all(monkeypatch, v)
    least = plugin("roofline", "trajectory").least_seconds(CFG16, LENGTHS, PEAKS)
    assert got["call_device_ms"] == pytest.approx(CALL_US * 1e-3)
    assert got["trajectory_span_ms"] == pytest.approx(TRAJ_US * 1e-3)
    assert got["trajectory_roofline"] == pytest.approx(100 * least / (TRAJ_US * 1e-6))
    # the trajectory range: its entry (1 µs), its children's edges (6 µs) and 5 launches (25 µs)
    assert got["trajectory_dispatch_ms"] == pytest.approx(32e-3)
    assert got["host_late_pct"] == 0.0
    assert got["call_device_ms"] >= got["trajectory_span_ms"]


def test_idle_inside_a_span_is_its_device_time(monkeypatch):
    """A host that issues a call's launches 9 ms apart: the device idles
    between the trajectory stage's kernels, the span's device time holds
    the idle, and the entries made while the device waits read as the host
    late."""
    tr = Trace()
    tr.call()
    tr.call(launch_host_us=9005.0)
    v = tr.view(2)
    traj = [op for op in v.device_ops if op.name == "kernel"][-5:]  # the second call's trajectory kernels
    ms = plugin("metrics", "call_device_ms").span_ms(v, "trajectory")
    assert ms == pytest.approx([TRAJ_US * 1e-3, (traj[-1].end - traj[0].start) * 1e-3])
    assert ms[1] > 4 * 9.0 - TRAJ_US * 1e-3  # four launch gaps of 9 ms, less the kernels run in them
    assert read_all(monkeypatch, v)["host_late_pct"] > 0


def test_host_late_counts_dry_entries(monkeypatch):
    """The third of three calls issued 100 µs after the device ran dry: its
    root's entry and its first child's (before the first launch) find the
    stream dry, its other eight do not; the first call is left out."""
    tr = Trace()
    tr.call()
    tr.call()
    tr.call(late_us=100.0)
    assert read_all(monkeypatch, tr.view(3))["host_late_pct"] == pytest.approx(100 * 2 / 20)


def test_port_setup_counts_each_set_up_once_in_any_order(monkeypatch):
    """The set-up spans no other holds, less nvcc's build: a FIR operator
    designed before the model counts as itself, and inside the model it
    counts with the model; so the order of the calls does not move the
    sum."""
    def setup(order):
        recs, t = [], 0

        def add(name, ms, parent=None):
            nonlocal t
            rec = obs.SpanRecord(name, len(recs) + 1, parent and parent.id, 1, t, t + int(ms * 1e6))
            recs.append(rec)
            t += 1
            return rec

        add("setup.import", 1000.0)
        lib = add("setup.library", 500.0)
        add("setup.library.build", 400.0, lib)
        if order == "fir_first":
            add("setup.fir_operator", 150.0)
            add("setup.model", 2000.0)
        else:
            model = add("setup.model", 2150.0)
            add("setup.fir_operator", 150.0, model)
        return recs

    tr = Trace()
    tr.call()
    for order in ("fir_first", "model_first"):
        got = read_all(monkeypatch, tr.view(1), setup(order))
        assert got["port_setup_s"] == pytest.approx(1.0 + 0.5 - 0.4 + 2.15, abs=1e-6)


def test_a_missing_span_reads_none(monkeypatch):
    """A traced call without its trajectory span; launch calls that do not
    pair with the kernels (a kernel record lost); fewer roots than traced
    calls: the readers of them read None and none raises."""
    tr = Trace()
    tr.call()
    tr.call(skip=("trajectory",))
    got = read_all(monkeypatch, tr.view(2))
    assert got["call_device_ms"] is not None and got["host_late_pct"] is not None
    assert got["trajectory_span_ms"] is got["trajectory_roofline"] is got["trajectory_dispatch_ms"] is None
    tr = Trace()
    tr.call()
    tr.call()
    v = tr.view(2)
    v.device_ops = v.device_ops[1:]
    assert all(got is None for m, got in read_all(monkeypatch, v).items() if m not in ("trajectory_dispatch_ms",
                                                                                       "port_setup_s"))
    tr = Trace()
    tr.call()
    assert all(got is None for m, got in read_all(monkeypatch, tr.view(2)).items() if m != "port_setup_s")


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent of the spans (no ``obs.spans`` and no range of its own in
    the trace), or a window that traced no call: every span reader reads
    None and none raises."""
    tr = Trace()
    tr.call()
    tr.call()
    v = tr.view(2)
    v.host_ops = [op for op in v.host_ops if op.name.startswith(("bench.", "cuda", "aten::"))]
    monkeypatch.delattr(obs, "spans")
    assert all(plugin("metrics", m).read(v) is None for m in SPAN_METRICS)
    monkeypatch.undo()
    v.pools = []
    assert all(got is None for got in read_all(monkeypatch, v, records("setup.import")).values())


def test_trajectory_least_work():
    """12 trajectories and tot_change, float32, on the valid frames; a
    6th-order Butterworth is 3 sections, 18 flops a sample each, both
    ways; the bytes set the bound (40 MB at 3.35 TB/s, about 12 µs)."""
    tr = plugin("roofline", "trajectory")
    frames = 128 * 6001
    assert tr.bytes_moved(CFG16, LENGTHS) == 4 * frames * 13
    assert tr.operations(CFG16, LENGTHS) == frames * (12 * (54 + 2 + 2) + 2 + 54)
    assert tr.least_seconds(CFG16, LENGTHS, PEAKS) == pytest.approx(4 * frames * 13 / 3.35e12)
    assert tr.least_seconds(CFG16, LENGTHS, PEAKS) * 1e6 == pytest.approx(11.92, abs=0.01)
    ragged = np.array([64_000, 64_079, 64_080, 560_000])
    assert tr.bytes_moved(CFG16, ragged) == 4 * 13 * (801 + 801 + 802 + 7001)
    for out, per_frame in ((dict(outFilter="fir", outFiltLen=31), 4 * 31), (dict(outFilter="sg", outFiltLen=9), 18),
                           (dict(outFilter=None), 54)):
        assert tr.out_filter_flops(dict(CFG16, **out)) == per_frame


@pytest.mark.card
def test_spans_in_a_traced_run_on_the_card():
    """A traced run of the flagship cell reports every span metric, and the
    program's ranges add no device op to the harness's view."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "modcep16k.uniform30s", "--seed",
                          str(2**31 + 91), "--seconds", "4", "--trace", "1"], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    m = {k: v["value"] for k, v in json.loads(out.stdout.strip().splitlines()[-1])["metrics"].items()}
    assert set(SPAN_METRICS) <= set(m)
    assert m["launches_per_call"] == 64
    assert m["call_device_ms"] >= m["trajectory_span_ms"] > 0 and 0 < m["trajectory_roofline"] < 100
