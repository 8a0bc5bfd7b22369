"""The harness on the CPU at a tiny size: the result's line, the faults and
the control the comparison has to refuse, and the per-layer readers on a
trace made by hand. ``run_cell`` is the run without the look for a card."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import tiny_cell

from benchlib import trace as tracing
from benchlib.catalog import benchmark_spec, find_cell, plugin
from benchlib.loop import clock
from benchlib.run_cell import run_cell

ROOT = Path(__file__).resolve().parent.parent.parent
CELLS = [w["name"] for w in benchmark_spec()["workloads"]]


def run_tiny(workload, wrap=None, control=False, seconds=0.6):
    return run_cell(tiny_cell(workload), 2**31 + 5, seconds, False, "cpu", marks=[("start", clock())], wrap=wrap, control=control)


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload):
    r = run_tiny(workload)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    cell = find_cell(workload)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert r["metrics"][m["name"]]["unit"] == m["unit"]
    assert set(r["checks"]) == {"tot_err", "mask_err"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(r)


class Faulty:
    """The entry with a fault underneath: ``stale`` returns the previous
    call's outputs unchanged; ``half`` computes half of the batch and fills
    the other half with the mean of the computed rows; ``altered`` changes
    one output value where it is produced."""

    def __init__(self, entry, fault):
        self.entry, self.fault, self.last = entry, fault, None

    def __getattr__(self, name):
        return getattr(self.entry, name)

    def __call__(self, p):
        tot, mask = self.entry(p)
        if self.fault == "stale":
            out, self.last = (self.last or (tot, mask)), (tot, mask)
            return out
        tot = tot.clone()
        if self.fault == "half":
            h = tot.shape[0] // 2
            tot[h:] = tot[:h].mean(dim=0, keepdim=True)
        elif self.fault == "altered":
            tot[0, tot.shape[1] // 3] += 0.01 * tot[0].abs().max()
        return tot, mask


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("workload", ["modcep16k.uniform30s", "modcep16k.ragged"])
def test_faults_come_out_not_correct(workload, fault):
    r = run_tiny(workload, wrap=lambda e: Faulty(e, fault))
    assert r["correct"] is False and r["failed"] > 0
    assert r["checks"]["tot_err"]["value"] > r["checks"]["tot_err"]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_comes_out_not_correct(workload):
    r = run_tiny(workload, control=True)
    assert r["correct"] is False
    assert r["checks"]["tot_err"]["value"] > 3 * r["checks"]["tot_err"]["limit"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "{" not in out.stdout


def synthetic_view(workload="modcep16k.uniform30s"):
    """Two calls of 10 ms: each a frontend kernel of 8 ms, a tail of 0.5 ms,
    three trajectory kernels of 0.3 ms and one copy, 0.2 ms idle."""
    cell = find_cell(workload)
    lengths = np.full(128, 480_000)
    dev, t = [], 0.0
    for _ in range(2):
        for name, dur in (("void fused_mel_tc_kernel<0, float>(float const*)", 8000.0),
                          ("void mfcc_tail_kernel<float>(float const*)", 500.0), ("sosfilt", 300.0),
                          ("gather", 300.0), ("reduce", 300.0), ("Memcpy DtoH (Device -> Pinned)", 400.0)):
            dev.append(tracing.Op(name, t, t + dur))
            t += dur
        t += 200.0
    host = [tracing.Op("bench.wait", 0.0, t)]
    batches = [{"lengths": lengths, "sample_bytes": 4}]
    return tracing.TraceView(dev, host, (0.0, t), [0, 0], [0.002, 0.004, 0.003], cell, batches)


def test_readers_on_a_made_trace():
    view = synthetic_view()
    read = {m: plugin("metrics", m).read(view) for m in (
        "dispatch_ms", "launches_per_call", "fused_mel_roofline", "mfcc_tail_roofline", "traj_ms", "device_idle_pct")}
    fr, tail = plugin("roofline", "frontend"), plugin("roofline", "tail")
    cfg = view.cell.config
    assert read["dispatch_ms"] == pytest.approx(3.0)
    assert read["launches_per_call"] == 5
    assert read["fused_mel_roofline"] == pytest.approx(100 * fr.bytes_moved(cfg, view.batches[0]["lengths"], 4) / 3.35e12 / 8e-3)
    assert read["mfcc_tail_roofline"] == pytest.approx(100 * tail.bytes_moved(cfg, view.batches[0]["lengths"]) / 3.35e12 / 0.5e-3)
    assert read["traj_ms"] == pytest.approx(0.9)
    assert read["device_idle_pct"] == pytest.approx(100 * 400 / 20000)
    assert 0 < read["fused_mel_roofline"] < 100
    b = tracing.breakdown(view)
    assert b["device_ops"][0] == ["fused_mel_tc_kernel<0, float>", pytest.approx(0.016)]
    assert b["idle_gaps"] == [["bench.wait", pytest.approx(0.0004)]]


def test_readers_find_nothing_in_an_empty_trace():
    view = synthetic_view()
    view.device_ops, view.pools, view.dispatch_s = [], [], []
    assert all(plugin("metrics", m["name"]).read(view) is None for m in find_cell(CELLS[0]).per_layer)


def fake_event(name, start, end, cuda=False, thread=1, annotation=False):
    from types import SimpleNamespace

    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), device_type=dt,
                           thread=thread, is_user_annotation=annotation)


def test_view_of_a_profile():
    """The device's copies of the host's ranges are no device work; ops
    outside the calls (the pad's) are left out; a launch without its kernel
    record counts as lost."""
    from types import SimpleNamespace

    events = [
        fake_event("cudaLaunchKernel", 0, 1), fake_event("cudaLaunchKernel", 1, 2),  # the pad's, one record lost
        fake_event("pad_kernel", 3, 4, cuda=True),
        fake_event("bench.call", 10, 20), fake_event("bench.call", 10, 20, cuda=True, annotation=True),
        fake_event("cudaLaunchKernel", 11, 12), fake_event("cudaLaunchKernel", 12, 13),
        fake_event("fused_mel_tc_kernel", 12, 40, cuda=True), fake_event("mfcc_tail_kernel", 40, 45, cuda=True),
        fake_event("Memcpy DtoH (Device -> Pinned)", 45, 47, cuda=True),
        fake_event("bench.wait", 20, 50), fake_event("cudaEventSynchronize", 21, 50),
        fake_event("other thread", 10, 50, thread=2),
    ]
    prof = SimpleNamespace(events=lambda: events)
    traced = tracing.Traced(prof, pad=1, calls=range(0, 1), attempts=1)
    assert tracing.kernel_records_lost(prof) == 0
    view = tracing.view_of(traced, [0], [0.001], find_cell(CELLS[0]), [{"lengths": np.full(128, 480_000),
                                                                        "sample_bytes": 4}])
    assert view.window == (10, 50) and view.lost == 0
    assert [op.name for op in view.device_ops] == ["fused_mel_tc_kernel", "mfcc_tail_kernel",
                                                    "Memcpy DtoH (Device -> Pinned)"]
    assert {op.name for op in view.host_ops} == {"bench.call", "cudaLaunchKernel", "bench.wait", "cudaEventSynchronize"}
    assert view.busy_us == 35 and plugin("metrics", "launches_per_call").read(view) == 2
    assert tracing.breakdown(view)["idle_gaps"] == [["cudaEventSynchronize", pytest.approx(3e-6)],
                                                    ["bench.call", pytest.approx(2e-6)]]
    events.insert(6, fake_event("cudaLaunchKernel", 13, 14))
    assert tracing.kernel_records_lost(prof) == 1


def test_per_layer_metrics_have_to_list_their_cells():
    spec = benchmark_spec()
    spec = dict(spec, per_layer=[dict(spec["per_layer"][0])] + spec["per_layer"][1:])
    del spec["per_layer"][0]["workloads"]
    with pytest.raises(ValueError, match=spec["per_layer"][0]["name"]):
        find_cell(CELLS[0], spec)
    assert {m["name"] for m in find_cell(CELLS[0]).end_to_end} == {m["name"] for m in benchmark_spec()["end_to_end"]}


def test_a_profiler_that_keeps_no_kernel_record_raises(monkeypatch):
    """The loss count gives up after its largest window, not in an endless
    loop, when the profiler keeps no CUDA record at all."""
    import contextlib
    from types import SimpleNamespace

    import torch.profiler

    windows = []

    @contextlib.contextmanager
    def no_records(activities):
        windows.append(activities)
        yield SimpleNamespace(events=lambda: [fake_event("cudaLaunchKernel", 0, 1)])

    monkeypatch.setattr(torch.profiler, "profile", no_records)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    with pytest.raises(RuntimeError, match="no CUDA record"):
        tracing.lost_kernel_records([], torch.zeros(1), sizes=(2, 4))
    assert len(windows) == 2
