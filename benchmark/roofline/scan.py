"""The scan route's zero-phase Butterworth filters' least work, whatever
kernels compute them: the trajectory low-pass over the n_mfcc -
removeFirst coefficient trajectories and, where the final filter is a
Butterworth, that filter over tot_change, on each utterance's valid frames
(1 + length // hop, not the padding's).

Bytes: each filtered row read once and written once, float32. Operations:
9 flops a second-order section a sample each way (roofline/trajectory.py).
At these sizes the bytes set the bound.
"""
from __future__ import annotations

from benchlib.catalog import plugin


def _trajectory():
    return plugin("roofline", "trajectory")


def out_order(cfg: dict) -> int:
    """The final Butterworth's order, 0 where the final filter is another."""
    if cfg["outFilter"] is None:
        return cfg["filtOrd"]
    return cfg["outFiltLen"] if cfg["outFilter"] == "iir" else 0


def rows(cfg: dict) -> int:
    """Rows an utterance the filters run over."""
    return _trajectory().trajectories(cfg) + int(out_order(cfg) > 0)


def bytes_moved(cfg: dict, lengths) -> float:
    return 8.0 * plugin("roofline", "frontend").frames(cfg, lengths) * rows(cfg)


def operations(cfg: dict, lengths) -> float:
    tr = _trajectory()
    per_frame = tr.trajectories(cfg) * tr._zero_phase_iir(cfg["filtOrd"])
    if out_order(cfg):
        per_frame += tr._zero_phase_iir(out_order(cfg))
    return plugin("roofline", "frontend").frames(cfg, lengths) * per_frame


def least_seconds(cfg: dict, lengths, peaks: dict) -> float:
    return max(bytes_moved(cfg, lengths) / peaks["hbm_byte_s"], operations(cfg, lengths) / peaks["fp32_flop_s"])
