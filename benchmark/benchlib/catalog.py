"""Where a cell's parts live, found by name.

``BENCHMARK.json`` at the checkout's root names the cells. Each cell names
its configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``). The configuration names its entry adapter
(``entries/<entry>.py``) and its plain reference (``reference/<reference>.py``);
the traffic mix names its generator (``gen/<generator>.py``). Each per-layer
metric is read by ``metrics/<name>.py``, and the roofline functions a reader
needs are ``roofline/<name>.py``, with the table of peaks in
``roofline/peaks.json``. A new cell, mix, configuration or metric is a new
file and a new entry in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
PLUGIN_KINDS = ("gen", "entries", "reference", "roofline", "metrics")


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def find_cell(name: str, spec: dict | None = None) -> Cell:
    """The cell ``name``, with the metrics it reports: an end-to-end metric
    where its ``workloads`` list it, or in every cell where it has no such
    key (as ``BENCHMARK.json``'s contract reads it); a per-layer metric
    where its ``workloads``, which it has to have, list it."""
    spec = spec if spec is not None else benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {', '.join(sorted(cells))}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = read_json(ROOT / conf["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    e2e = tuple(m for m in spec["end_to_end"] if name in m.get("workloads", (name,)))
    unlisted = [m["name"] for m in spec["per_layer"] if "workloads" not in m]
    if unlisted:
        raise ValueError(f"per-layer metrics without workloads in BENCHMARK.json: {', '.join(unlisted)}")
    per_layer = tuple(m for m in spec["per_layer"] if name in m["workloads"])
    return Cell(name, w["chips"], config, traffic, e2e, per_layer)


@lru_cache(maxsize=None)
def plugin(kind: str, name: str) -> ModuleType:
    """The module ``<kind>/<name>.py`` under the benchmark's directory."""
    if kind not in PLUGIN_KINDS:
        raise ValueError(f"unknown plugin kind {kind!r}")
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path.relative_to(BENCH_DIR)}")
    mod_name = f"_bench_{kind}__{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
