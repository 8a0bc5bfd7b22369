"""The timit16k.short cell's parts on the CPU: the scan adapter's refusal
of a program without the scan kernel and its hold on the scan route, the
short traffic's route, the scan filters' least work counted
by hand, the two scan readers on traces made by hand, and the cell at a
tiny size (the program's scan loop on the CPU) against the reference, with
its control refused."""
import dataclasses
import sys

import numpy as np
import pytest

from benchlib import trace as tracing
from benchlib.catalog import BENCH_DIR, find_cell, plugin, read_json
from benchlib.loop import clock
from benchlib.run_cell import run_cell
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import min_frames_for_fir

CELL = "timit16k.short"
SCAN = plugin("entries", "batched_mfcc_change_scan")
CFG = read_json(BENCH_DIR / "configs" / "timit16k.json")
PEAKS = read_json(BENCH_DIR / "roofline" / "peaks.json")
SHORT = read_json(BENCH_DIR / "traffic" / "short.json")
GEN = plugin("gen", "speechlike")


def tiny(batch=2, pool=2, keys=(2, 3), multiple=4096):
    """The cell cut to a CPU test's size: ``batch`` utterances of the
    sweep's buckets of ``multiple`` samples with ``keys``."""
    cell = find_cell(CELL)
    traffic = dict(cell.traffic, batch=batch, pool=pool, lengths={"kind": "bucket", "keys": list(keys)},
                   bucket_multiple=multiple)
    return dataclasses.replace(cell, traffic=traffic)


def test_the_configuration_is_modcep16ks_analysis():
    """timit16k is modcep16k key for key but its name, its text and its
    entry (the same adapter, held to the scan route)."""
    other = read_json(BENCH_DIR / "configs" / "modcep16k.json")
    differ = {k for k in CFG if CFG[k] != other.get(k)}
    assert differ == {"name", "what", "source", "assumed", "entry"}
    assert CFG["entry"] == "batched_mfcc_change_scan" and CFG["reduced"] == []


def test_build_raises_without_the_scan_kernel(monkeypatch):
    """A program without kernels/masked_scan stops at build, at once, with
    the reason; with it, build returns the shared adapter held to the scan
    route."""
    cell = tiny()
    monkeypatch.setitem(sys.modules, SCAN.SCAN_KERNEL, None)
    with pytest.raises(RuntimeError, match="cannot hold"):
        SCAN.build(cell.config, cell.traffic, "cpu")
    monkeypatch.undo()
    assert isinstance(SCAN.build(cell.config, cell.traffic, "cpu"), SCAN.ScanEntry)


@pytest.mark.parametrize("keys, multiple", [((31, 32), 2048), ((2, 3), 4096)], ids=["fir_lengths", "short"])
def test_prepare_holds_the_scan_route(keys, multiple):
    """Every batch is prepared for the scan route: one whose shortest
    utterance has min_frames_for_fir frames (3.84-4.10 s, which the shared
    adapter sends down the masked FIR route) and one of the cell's own
    lengths."""
    cell = tiny(keys=keys, multiple=multiple)
    batch = GEN.make_batch(cell.traffic, 16000, 2**31 + 3, 0, "cpu")
    shared = plugin("entries", "batched_mfcc_change").build(cell.config, cell.traffic, "cpu")
    assert shared.prepare(batch).kwargs["masked_fir"] is (keys[0] == 31)
    p = SCAN.build(cell.config, cell.traffic, "cpu").prepare(batch)
    assert p.kwargs["masked_fir"] is False and p.batch.samples.ndim == 3


def test_every_pool_batch_takes_the_scan_route():
    """Each of the short traffic's four pool batches (1,024 lengths a
    bucket, any seed) has its shortest utterance under min_frames_for_fir
    frames: the sweep sends it down the scan route. Valid mean 2.82 s."""
    mf = min_frames_for_fir(MfccConfig(signal_sample_rate=16000, maxFreq=8000.0))
    assert mf == 744
    hop = int(CFG["tStep"] * CFG["signal_sample_rate"])
    lengths = []
    for i in range(SHORT["pool"]):
        for seed in (1, 2**33 + 7):
            b = GEN.lengths_of(SHORT, 16000, np.random.default_rng(seed), i)
            assert len(b) == SHORT["batch"] == 1024 and 1 + int(b.min()) // hop < mf
        lengths.append(b)
    lengths = np.concatenate(lengths)
    assert lengths.mean() / 16000 == pytest.approx(2.816, abs=1e-3)
    assert lengths.min() > 16384 and lengths.max() <= 4 * 16384


def test_scan_least_work():
    """Two utterances: 12 trajectories and tot_change, each read and written
    once in float32 on the valid frames; a 6th-order Butterworth is 3
    sections of 9 flops a sample each way, for the low-pass and the final
    filter alike; the bytes set the bound."""
    scan = plugin("roofline", "scan")
    lengths = np.array([32_000, 48_079])
    frames = (1 + 400) + (1 + 600)
    assert scan.rows(CFG) == 13
    assert scan.bytes_moved(CFG, lengths) == 8 * frames * 13
    assert scan.operations(CFG, lengths) == frames * (12 * 54 + 54)
    assert scan.least_seconds(CFG, lengths, PEAKS) == pytest.approx(8 * frames * 13 / 3.35e12)
    assert scan.operations(CFG, lengths) / 67e12 < scan.least_seconds(CFG, lengths, PEAKS)
    assert scan.rows(dict(CFG, outFilter="fir")) == 12 and scan.operations(dict(CFG, outFilter="sg"), lengths) == (
        frames * 12 * 54)
    assert scan.operations(dict(CFG, outFilter=None, filtOrd=4), lengths) == frames * (12 * 36 + 36)


# a call's ranges on the scan route and, under each, its kernels' durations (µs)
CALL = (("batched_mfcc_change", ()), ("trajectory", ()), ("trajectory.filter", ()),
        ("trajectory.filter.scan", (40.0,)), ("trajectory.diff", (5.0, 5.0)), ("trajectory.out", ()),
        ("trajectory.out.scan", (30.0,)))
LENGTHS = np.array([32_000, 48_079, 60_000])


def made_view(n_calls=3, skip=None):
    """A traced window made by hand: each call's ranges nested as the
    program nests them around their launches, its kernels back to back;
    the call ``skip[0]`` lacks the span ``skip[1]``."""
    host, dev, t = [], [], 0.0
    for c in range(n_calls):
        host.append(tracing.Op("bench.call", t, t))
        for name, kernels in CALL:
            if skip is not None and c == skip[0] and name == skip[1]:
                continue
            start = t
            t += 1.0
            for us in kernels:
                host.append(tracing.Op("cudaLaunchKernel", t, t + 3.0))
                dev.append(tracing.Op("kernel", t + 5.0, t + 5.0 + us))
                t += 5.0 + us
            host.append(tracing.Op(name, start, t + 1.0))
            t += 2.0
    host.append(tracing.Op("bench.wait", t, t + 1.0))
    batches = [{"lengths": LENGTHS, "sample_bytes": 2}]
    return tracing.TraceView(dev, host, (0.0, t + 1.0), [0] * n_calls, [0.002], find_cell(CELL), batches)


def test_scan_readers_on_a_made_trace():
    """scan_ms: a call's device ms in its two scan spans, summed (40 + 30
    µs); scan_roofline: the least time of the traced calls' scan filters
    over that time."""
    v = made_view()
    least = plugin("roofline", "scan").least_seconds(CFG, LENGTHS, PEAKS)
    assert plugin("metrics", "scan_ms").read(v) == pytest.approx(0.070)
    assert plugin("metrics", "scan_roofline").read(v) == pytest.approx(100 * 3 * least / (3 * 70e-6))


@pytest.mark.parametrize("missing", ["trajectory.filter.scan", "trajectory.out.scan"])
def test_scan_readers_read_none_without_a_span(missing):
    """A traced call without one of the scan spans (a program without
    them, or another route), or a window that traced no call: both
    readers read None and neither raises."""
    v = made_view(skip=(1, missing))
    assert plugin("metrics", "scan_ms").read(v) is None and plugin("metrics", "scan_roofline").read(v) is None
    v = made_view()
    v.host_ops = [op for op in v.host_ops if not op.name.endswith(".scan")]
    assert plugin("metrics", "scan_ms").read(v) is None and plugin("metrics", "scan_roofline").read(v) is None
    v.pools = []
    assert plugin("metrics", "scan_ms").read(v) is None and plugin("metrics", "scan_roofline").read(v) is None


@pytest.mark.parametrize("control", [False, True])
def test_the_cell_at_a_tiny_size(control):
    """Two utterances of 0.26-0.77 s a batch on the CPU, through the scan
    adapter and the program's scan loop: correct against the reference;
    the control (the bf16 mel) refused."""
    r = run_cell(tiny(), 2**31 + 11, 0.5, False, "cpu", marks=[("start", clock())], control=control)
    assert r["attempted"] > 0 and r["checks"]["mask_err"]["value"] == 0
    if control:
        assert r["correct"] is False and r["checks"]["tot_err"]["value"] > r["checks"]["tot_err"]["limit"]
    else:
        assert r["correct"] is True and r["failed"] == 0
        assert set(r["metrics"]) == {m["name"] for m in find_cell(CELL).end_to_end}


@pytest.mark.card
def test_the_adapter_computes_on_its_own_stream():
    """On CUDA a call runs on the adapter's compute stream, and the
    caller's stream, where the loop copies the outputs, waits for it: the
    outputs read on the caller's stream equal the shared adapter's on the
    scan route, bit for bit."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    cell = tiny(batch=8, keys=(2, 3), multiple=16384)
    batch = GEN.make_batch(cell.traffic, 16000, 2**31 + 5, 1, "cuda")
    scan = SCAN.build(cell.config, cell.traffic, "cuda")
    assert scan.stream is not None and scan.stream != torch.cuda.current_stream()
    shared = plugin("entries", "batched_mfcc_change").build(cell.config, cell.traffic, "cuda")
    p, q = scan.prepare(batch), shared.prepare(batch)
    q.kwargs["masked_fir"] = False
    host = [o.to("cpu", non_blocking=True) for o in scan(p)]
    torch.cuda.current_stream().synchronize()
    want = [o.cpu() for o in shared(q)]
    for h, w in zip(host, want, strict=True):
        assert torch.equal(h, w)
