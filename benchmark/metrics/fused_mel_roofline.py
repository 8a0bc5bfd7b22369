"""The MFCC frontend kernels' share of their roofline, in %: the least time
the chip needs for the frontend function on the traced calls' inputs
(roofline/frontend.py: the function's least work, a real FFT and the mel
bank's nonzero weights, on the frames the inputs need) over the device time
of the kernels named ``fused_mel_*``. None where no such kernel ran."""
from benchlib.catalog import BENCH_DIR, plugin, read_json


def read(view):
    t = sum(op.dur for op in view.kernels if "fused_mel" in op.name) * 1e-6
    if t <= 0:
        return None
    peaks = read_json(BENCH_DIR / "roofline" / "peaks.json")
    fr, cfg = plugin("roofline", "frontend"), view.cell.config
    least = sum(fr.least_seconds(cfg, view.batches[k]["lengths"], view.batches[k]["sample_bytes"], peaks)
                for k in view.pools)
    return 100.0 * least / t
