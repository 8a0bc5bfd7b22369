"""The port's spans (utils/obs.py) on the CPU: a call of
``batched_mfcc_change`` under torch.profiler is one tree of the layers'
spans, each span is a range of the profiler's trace, nothing is recorded
without a profiler, set-up spans count what was built, and the ring keeps
its bound."""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import modulation_mfcc_tpu_torch as mt
from modulation_mfcc_tpu_torch.models import modulation
from modulation_mfcc_tpu_torch.ops import filters
from modulation_mfcc_tpu_torch.parallel.batch import batched_mfcc_change, pad_batch
from modulation_mfcc_tpu_torch.utils import obs

CFG = mt.MfccConfig(signal_sample_rate=16000, maxFreq=8000.0)
CALL = ["batched_mfcc_change", "frame_mask", "frontend", "frontend.mel", "frontend.peak", "frontend.tail",
        "trajectory", "trajectory.filter", "trajectory.diff", "trajectory.out"]
ROUTES = {"uniform": {"uniform_lengths": True}, "masked_fir": {"masked_fir": True}, "scan": {}}
# a range's duration against its span's host time: the range opens before
# the span's clock reads and closes after it (some µs a span)
RANGE_TOL_MS = 0.25


@pytest.fixture(scope="module")
def batch():
    """Two utterances of about 4 s, above the masked FIR route's minimum;
    one call made, so the model is built and the first ranges are warm."""
    rng = np.random.default_rng(21)
    b = pad_batch([0.1 * rng.standard_normal(n).astype(np.float32) for n in (64_000, 62_000)], device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        batched_mfcc_change(b, CFG, masked_fir=True)
    return b


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def new_spans(before):
    seen = {r.id for r in before}
    return [r for r in obs.spans() if r.id not in seen]


def test_no_profiler_records_nothing(batch):
    before = [r.id for r in obs.spans()]
    batched_mfcc_change(batch, CFG, masked_fir=True)
    mt.mfcc_change(batch.samples, CFG)
    assert [r.id for r in obs.spans()] == before
    with obs.span("x", kind="test") as sp:
        assert sp is None
    assert obs.span("x") is obs.span("x") and not obs.recording()


@pytest.mark.parametrize("route", ROUTES)
def test_a_call_is_one_span_tree(batch, route):
    """One root with the call's attributes; every other span under it, its
    parent the layer above (``frontend.mel`` under ``frontend``), inside
    its parent's interval."""
    before = obs.spans()
    profiled(lambda: batched_mfcc_change(batch, CFG, **ROUTES[route]))
    recs = new_spans(before)
    assert [r.name for r in recs] == CALL
    root, by_id = recs[0], {r.id: r for r in recs}
    assert root.parent is None and root.root == root.id
    assert root.attrs == {"batch": 2, "layout": "flat", "dtype": "float32", "route": route}
    assert by_id[root.id + 2].attrs == {"algorithm": "f32"}
    for r in recs[1:]:
        up = by_id[r.parent]
        assert up.name == (r.name.rsplit(".", 1)[0] if "." in r.name else root.name)
        assert r.root == root.id and up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns


def test_spans_are_the_traces_ranges(batch):
    """Each span is one range of the profiler's trace, of the same name, in
    the same order, and of the same duration within RANGE_TOL_MS: the
    spans and the trace share a clock."""
    before = obs.spans()
    prof = profiled(lambda: batched_mfcc_change(batch, CFG, masked_fir=True))
    recs = new_spans(before)
    ranges = sorted((e for e in prof.events() if e.name in CALL), key=lambda e: e.time_range.start)
    assert [e.name for e in ranges] == [r.name for r in recs] == CALL
    for r, e in zip(recs, ranges):
        host_ms = (r.end_ns - r.start_ns) * 1e-6
        assert abs((e.time_range.end - e.time_range.start) * 1e-3 - host_ms) <= RANGE_TOL_MS, r.name


def test_frontend_and_trajectory_are_roots_without_the_batch_entry(batch):
    before = obs.spans()
    profiled(lambda: mt.mfcc_change(batch.samples, CFG))
    recs = new_spans(before)
    assert [r.name for r in recs] == CALL[2:]
    assert [r.name for r in recs if r.parent is None] == ["frontend", "trajectory"]


def test_setup_spans_count_what_was_built():
    """Set-up spans record without a profiler: the package's import once;
    a model or a FIR operator built once for each configuration, not again
    on a cache hit."""
    def count(name):
        return sum(r.name == name for r in obs.spans())

    assert count("setup.import") == 1
    cfg, other = mt.MfccConfig(filtCutoff=11.25), mt.MfccConfig(filtCutoff=11.75)
    n = count("setup.model")
    modulation._model(cfg, torch.device("cpu"))
    modulation._model(cfg, torch.device("cpu"))
    assert count("setup.model") == n + 1
    modulation._model(other, torch.device("cpu"))
    assert count("setup.model") == n + 2
    sos = filters.design_butter_sos(2, (0.3125,), "lowpass")[0]
    n = count("setup.fir_operator")
    filters.design_filtfilt_operator(filters._key_of(sos), 9)
    filters.design_filtfilt_operator(filters._key_of(sos), 9)
    assert count("setup.fir_operator") == n + 1


def test_span_as_a_decorator():
    @obs.span("decorated", kind="test")
    def add_one(x):
        return x + 1

    before = obs.spans()
    assert add_one(1) == 2 and new_spans(before) == []
    profiled(lambda: add_one(2))
    assert [(r.name, r.attrs) for r in new_spans(before)] == [("decorated", {"kind": "test"})]


def test_the_ring_keeps_its_bound(monkeypatch):
    assert obs._ring.maxlen == obs.RING == 16_384
    monkeypatch.setattr(obs, "_ring", collections.deque(maxlen=8))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(20):
            with obs.span(f"ring{i}"):
                pass
    assert [r.name for r in obs.spans() if r.name.startswith("ring")] == [f"ring{i}" for i in range(12, 20)]
