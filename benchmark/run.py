"""The benchmark of modulation_mfcc_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` in this process, on the cards the cell
asks for, and prints as its last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines of standard error).

It exits with another code than 0, and prints no result, without CUDA or
with fewer cards than the cell asks for, and when jax, jaxlib, flax or the
JAX package has been imported by the time the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "modulation_mfcc_tpu")


def process_start() -> float:
    """The process's start on the perf_counter clock (the kernel's record of
    it, at the clock tick's resolution), or this module's first line."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return min(T_START, time.perf_counter() - age)
    except (OSError, ValueError, IndexError):
        return T_START


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

    from benchlib.catalog import find_cell

    cell = find_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s), this machine has {n}; no result",
              file=sys.stderr)
        return 3
    marks = [("start", t_start), ("interpreter", T_START), ("torch", time.perf_counter())]

    from benchlib.run_cell import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", marks=marks)
    print(f"card: {card_line()}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process, and not allowed: {', '.join(bad)}; no result", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
