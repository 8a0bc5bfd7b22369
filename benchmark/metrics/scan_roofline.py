"""The scan route's filters' share of their roofline, in %: the least time
the chip needs for the two zero-phase Butterworth filters on the traced
calls' valid frames (roofline/scan.py: the filtered rows read once and
written once) over the device time in the program's scan spans
(scan_ms.per_call, summed over the traced calls). None where a traced call
lacks either span."""
from benchlib.catalog import BENCH_DIR, plugin, read_json


def read(view):
    ms = plugin("metrics", "scan_ms").per_call(view)
    t = sum(ms) * 1e-3 if ms else 0.0
    if t <= 0:
        return None
    peaks = read_json(BENCH_DIR / "roofline" / "peaks.json")
    scan, cfg = plugin("roofline", "scan"), view.cell.config
    return 100.0 * sum(scan.least_seconds(cfg, view.batches[k]["lengths"], peaks) for k in view.pools) / t
