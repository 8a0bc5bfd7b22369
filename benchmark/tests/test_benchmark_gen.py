"""The traffic generator: seeded, the same work on every seed."""
import numpy as np
import pytest
import torch

from benchlib.catalog import BENCH_DIR, plugin, read_json

GEN = plugin("gen", "speechlike")


def traffic(name, **kw):
    t = read_json(BENCH_DIR / "traffic" / f"{name}.json")
    t = dict(t, batch=4, pool=2, **kw)
    if t["lengths"]["kind"] == "fixed":
        t["lengths"] = {"kind": "fixed", "seconds": 0.5}
    else:
        t["lengths"] = {"kind": "bucket", "keys": [2, 3]}
        t["bucket_multiple"] = 4096
    return t


@pytest.mark.parametrize("name", ["uniform30s", "ragged", "i16rows"])
def test_same_seed_same_batch(name):
    t = traffic(name)
    seed = 2**31 + 12345
    a = GEN.make_batch(t, 16000, seed, 1, "cpu")
    b = GEN.make_batch(t, 16000, seed, 1, "cpu")
    c = GEN.make_batch(t, 16000, seed + 1, 1, "cpu")
    assert torch.equal(a["samples"], b["samples"]) and np.array_equal(a["lengths"], b["lengths"])
    assert not torch.equal(a["samples"], c["samples"])
    assert not torch.equal(a["samples"], GEN.make_batch(t, 16000, seed, 0, "cpu")["samples"])
    assert a["samples"].dtype == (torch.int16 if t["dtype"] == "int16" else torch.float32)


def test_ragged_work_does_not_depend_on_the_seed():
    """Each pool batch is one of the sweep's buckets: the same lengths on
    every seed, in the seed's order, all inside the bucket, padded to its
    key."""
    t = traffic("ragged")
    pools = [GEN.make_pool(t, 16000, s, "cpu") for s in (1, 2**33 + 5, 987654321)]
    for i, key in enumerate(t["lengths"]["keys"]):
        batches = [p[i] for p in pools]
        assert len({tuple(sorted(b["lengths"])) for b in batches}) == 1
        assert len({tuple(b["lengths"]) for b in batches}) > 1  # the order is the seed's
        for b in batches:
            lengths = b["lengths"]
            assert len(set(lengths)) == len(lengths)
            assert lengths.min() > (key - 1) * 4096 and lengths.max() <= key * 4096
            assert b["samples"].shape == (4, key * 4096)


def test_ragged_mean_length():
    """The cell's own traffic: four buckets whose valid mean is within 1 %
    of LibriSpeech train-clean-100's 12.69 s (100.6 h over 28,539
    utterances)."""
    t = read_json(BENCH_DIR / "traffic" / "ragged.json")
    lengths = np.concatenate([GEN.lengths_of(t, 16000, np.random.default_rng(0), i) for i in range(t["pool"])])
    assert lengths.mean() / 16000 == pytest.approx(100.6 * 3600 / 28539, rel=0.01)
    assert lengths.min() / 16000 > 9.2 and lengths.max() / 16000 <= 16.384


def test_silent_edges_and_padding():
    t = traffic("ragged")
    b = GEN.make_batch(t, 16000, 7, 0, "cpu")
    edge = round(t["signal"]["silent_edge_s"] * 16000)
    x = b["samples"].double() / (32767.0 if b["samples"].dtype == torch.int16 else 1.0)
    for row, n in zip(x, b["lengths"]):
        assert torch.all(row[:edge] == 0) and torch.all(row[n - edge :] == 0)
        assert row[edge : n - edge].abs().max() > 0.2
        assert row.abs().max() <= 0.9 + 1e-4


def test_fixed_lengths_fill_the_batch():
    t = traffic("uniform30s")
    b = GEN.make_batch(t, 10000, 3, 0, "cpu")
    assert b["samples"].shape == (4, 5000) and set(b["lengths"]) == {5000}
