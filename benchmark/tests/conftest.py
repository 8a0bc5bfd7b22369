"""CPU tests of the benchmark (``python -m pytest benchmark/tests -q``), and
one card test marked ``card`` that skips without CUDA.

The harness's modules sit on ``sys.path`` as ``benchmark/run.py`` puts
them: the benchmark's directory and the checkout's root."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without CUDA)")


def tiny_cell(workload: str, batch: int = 2, pool: int = 2):
    """The cell with its traffic cut to a CPU test's size: ``batch``
    utterances of about 4 s (where the lengths come in buckets, buckets of
    2,048 samples with keys 31 and 32: 3.84-4.10 s, each above the masked
    FIR route's minimum), ``pool`` batches."""
    from benchlib.catalog import find_cell

    cell = find_cell(workload)
    traffic = dict(cell.traffic, batch=batch, pool=pool)
    if traffic["lengths"]["kind"] == "fixed":
        traffic["lengths"] = {"kind": "fixed", "seconds": 4.0}
    else:
        traffic["lengths"] = {"kind": "bucket", "keys": [31, 32]}
        traffic["bucket_multiple"] = 2048
    return dataclasses.replace(cell, traffic=traffic)
