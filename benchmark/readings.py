"""The readings the comparison's limits are set from, in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 2

runs the cell once for each seed (the program) and once for each control
seed (the configuration's lower-precision route in the program's place),
each a whole run at the cell's own load, and prints one JSON line per run
with the numbers compared. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()

    import torch

    from benchlib.catalog import find_cell
    from benchlib.loop import clock
    from benchlib.run_cell import run_cell

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    cell = find_cell(args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + [
        (int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        r = run_cell(cell, seed, args.seconds, False, "cuda:0", marks=[("start", clock())], control=control)
        line = {"workload": cell.name, "seed": seed, "control": control, "correct": r["correct"],
                "attempted": r["attempted"]} | {k: v["value"] for k, v in r["checks"].items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
