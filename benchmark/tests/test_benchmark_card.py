"""On an NVIDIA card only (skips elsewhere): a cell for 2 s end to end as
the driver runs it, and the control at the cell's own size."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent


def last_lines(script, *args):
    out = subprocess.run([sys.executable, script, *args], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines() if line.startswith("{")]


@pytest.mark.card
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    r = last_lines("benchmark/run.py", "--workload", "modcep16k.uniform30s", "--seed", str(2**31 + 77),
                   "--seconds", "2", "--trace", "0")[-1]
    assert r["device"]["platform"] == "gpu" and r["attempted"] > 0 and r["correct"] is True


@pytest.mark.card
def test_control_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    for r in last_lines("benchmark/readings.py", "--workload", "modcep16k.uniform30s", "--control-seeds",
                        f"{2**31 + 78},{2**31 + 79},{2**31 + 80}", "--seconds", "2"):
        assert r["control"] and r["correct"] is False and r["tot_err"] > 3e-3
