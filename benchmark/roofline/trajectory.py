"""The trajectory stage's least work, whatever kernels compute it: over
each utterance's valid frames (1 + length // hop, not the padding's), the
n_mfcc - removeFirst coefficient trajectories read once and tot_change
written once, float32.

Operations a frame: for each trajectory the zero-phase low-pass (the
Butterworth's second-order sections run forward and back, 9 flops a
section a sample: 5 multiplies, 4 adds), the derivative (a central
difference, 2 flops; the 3-point Savitzky-Golay derivative is the same)
and its square added (2); then the square root and the division (2) and
the final filter on the one trajectory (a Butterworth as above; a FIR
filtfilt, 2 flops a tap each way; a Savitzky-Golay smoother, 2 a tap).
At these sizes the bytes set the bound.
"""
from __future__ import annotations

from benchlib.catalog import plugin

BIQUAD_FLOPS = 9


def trajectories(cfg: dict) -> int:
    return cfg["n_mfcc"] - int(bool(cfg["removeFirst"]))


def bytes_moved(cfg: dict, lengths) -> float:
    return 4.0 * plugin("roofline", "frontend").frames(cfg, lengths) * (trajectories(cfg) + 1)


def _zero_phase_iir(order: int) -> float:
    return 2.0 * BIQUAD_FLOPS * -(-order // 2)


def out_filter_flops(cfg: dict) -> float:
    """Operations a frame of the final filter."""
    if cfg["outFilter"] in (None, "iir"):
        return _zero_phase_iir(cfg["filtOrd"] if cfg["outFilter"] is None else cfg["outFiltLen"])
    if cfg["outFilter"] == "fir":
        return 4.0 * cfg["outFiltLen"]
    return 2.0 * cfg["outFiltLen"]


def operations(cfg: dict, lengths) -> float:
    per_frame = trajectories(cfg) * (_zero_phase_iir(cfg["filtOrd"]) + 2.0 + 2.0) + 2.0 + out_filter_flops(cfg)
    return plugin("roofline", "frontend").frames(cfg, lengths) * per_frame


def least_seconds(cfg: dict, lengths, peaks: dict) -> float:
    return max(bytes_moved(cfg, lengths) / peaks["hbm_byte_s"], operations(cfg, lengths) / peaks["fp32_flop_s"])
