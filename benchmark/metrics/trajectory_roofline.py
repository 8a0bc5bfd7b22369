"""The trajectory stage's share of its roofline, in %: the least time the
chip needs for the stage's least work on the traced calls' valid frames
(roofline/trajectory.py: the trajectories read once and tot_change written
once) over the device time in the program's ``trajectory`` spans
(trajectory_span_ms). None where a traced call lacks the span."""
from benchlib.catalog import BENCH_DIR, plugin, read_json


def read(view):
    ms = plugin("metrics", "call_device_ms").span_ms(view, "trajectory")
    t = sum(ms) * 1e-3 if ms else 0.0
    if t <= 0:
        return None
    peaks = read_json(BENCH_DIR / "roofline" / "peaks.json")
    stage, cfg = plugin("roofline", "trajectory"), view.cell.config
    return 100.0 * sum(stage.least_seconds(cfg, view.batches[k]["lengths"], peaks) for k in view.pools) / t
