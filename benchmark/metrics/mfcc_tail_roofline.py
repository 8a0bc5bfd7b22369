"""The MFCC tail kernels' share of their roofline, in %: mel read once and
coefficients written once (roofline/tail.py, the frames the inputs need)
over the device time of the kernels named ``mfcc_tail_*``. None where no
such kernel ran."""
from benchlib.catalog import BENCH_DIR, plugin, read_json


def read(view):
    t = sum(op.dur for op in view.kernels if "mfcc_tail" in op.name) * 1e-6
    if t <= 0:
        return None
    peaks = read_json(BENCH_DIR / "roofline" / "peaks.json")
    tail, cfg = plugin("roofline", "tail"), view.cell.config
    return 100.0 * sum(tail.least_seconds(cfg, view.batches[k]["lengths"], peaks) for k in view.pools) / t
