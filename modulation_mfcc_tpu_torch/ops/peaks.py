"""Local maxima with scipy.signal.find_peaks semantics, batched on the
device.

Replaces the reference's peak analysis (script/calc.py:651-686 MinMaxFinder,
script/main.py:1566/1601 direct find_peaks calls). scipy's rule: a sample is
a peak if it is strictly greater than its neighbours; for a plateau of equal
values bounded by strictly smaller samples on both sides, the peak is the
plateau's left-middle ``(left + right) // 2``; the first and last samples
are never peaks.

The plateau start of every sample is a running maximum (``torch.cummax``
over "last index where the value changed"), and each peak plateau's middle
is scattered into the mask with ``scatter_reduce(..., "amax")``: a fixed-shape
boolean mask for any batch, no loop over rows. Hosts read positions with
``np.flatnonzero``.
"""
from __future__ import annotations

import numpy as np
import torch

from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

__all__ = ["peak_mask", "find_peaks_host", "peaks_in_interval"]


def peak_mask(y: torch.Tensor) -> torch.Tensor:
    """Boolean mask of scipy-style local maxima along the last axis."""
    n = y.shape[-1]
    if n < 3:
        return torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    idx = torch.arange(n, device=y.device).expand(y.shape)
    changed = torch.cat([torch.ones_like(y[..., :1], dtype=torch.bool), y[..., 1:] != y[..., :-1]], dim=-1)
    # plateau_start[i] = the largest j <= i where the value changed
    plateau_start = torch.cummax(torch.where(changed, idx, -1), dim=-1).values
    y_prev = torch.gather(y, -1, torch.clamp(plateau_start - 1, 0, n - 1))
    rising = (plateau_start > 0) & (y_prev < y)
    nxt = torch.cat([y[..., 1:], y[..., -1:]], dim=-1)
    falling = (nxt < y) & (idx < n - 1)
    # a peak plateau ends at i (falling) and started rising
    is_peak = rising & falling
    mid = (plateau_start + idx) // 2
    out = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
    return out.scatter_reduce(-1, mid, is_peak.to(torch.int32), reduce="amax").bool()


def find_peaks_host(y, device=None) -> np.ndarray:
    """Peak indices of a 1-D array as a host array (np.flatnonzero of the
    mask), the mask computed on ``device`` (default: a tensor's own device,
    else CUDA; ``device="cpu"`` for the CPU)."""
    device = resolve_device(device, y)
    y = y if torch.is_tensor(y) else torch.as_tensor(np.asarray(y))
    return np.flatnonzero(peak_mask(y.to(device)).cpu().numpy())


def peaks_in_interval(
    times: np.ndarray,
    values: np.ndarray,
    interval: tuple[float, float] | None,
    *,
    minima: bool = False,
    device=None,
):
    """MinMaxFinder.analyse_maximum/minimum equivalent (script/calc.py:664-686).

    Restricts to ``start <= t <= end`` (the reference's inclusive bounds,
    script/calc.py:657) and finds peaks of y (or -y for minima) *within the
    restricted segment*, like the reference, which slices first so interval
    edges can become peaks of the slice. Returns (peak_times, peak_values).
    The peaks are found on ``device`` (default CUDA; ``device="cpu"`` for
    the CPU).
    """
    device = resolve_device(device)
    if interval is None:
        return np.array([]), np.array([])
    times = np.asarray(times)
    values = np.asarray(values)
    sel = (times >= interval[0]) & (times <= interval[1])
    t_sel, v_sel = times[sel], values[sel]
    if len(v_sel) < 3:
        return np.array([]), np.array([])
    y = -v_sel if minima else v_sel
    pk = find_peaks_host(y, device)
    return t_sel[pk], v_sel[pk]
