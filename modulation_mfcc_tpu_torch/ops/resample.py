"""Polyphase resampling on the device (a rational rate change as matmuls).

The long-form path resamples a recording to the analysis rate before the
MFCC stage; on the device the hour of audio never returns to the host. The
polyphase identity: for a rate change by up/down with the kaiser_best-grade
taps h (odd length K, centred, c = (K − 1)/2) of ``io/wav.design_hq_taps``,
output phase p of every group of ``up`` outputs reads the input directly,
with no zero-stuffed upsampled signal:

    y[up·t + p] = Σ_w kern[p, w] · x[down·t + r_lo + w],
    kern[p, w]  = up · h[p·down + c − up·(r_lo + w)]   (0 outside h)

So the frames of the input at hop ``down`` (``ops/framing.frame_by_slices``)
times kern.T give all phases at once, and a reshape interleaves them. That
flat form copies each input sample into about W/down frames, so inputs of
more than ``block_threshold`` samples take a blocked form: rows of ``tc``
outputs per phase, each row one window of the input times a banded matrix
holding kern at every output's offset, about twice the input in frames
(a 1-hour 48 kHz recording: 0.46 GB of rows where the flat frames would be
30 GB). Both forms sum the same products (the blocked one adds exact
zeros besides), in the order of the matmul, and match
scipy's ``resample_poly`` (the host path of ``io/wav.resample``, same taps)
to rounding.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as tnf

from modulation_mfcc_tpu_torch.io.wav import design_hq_taps, resample_ratio
from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

__all__ = ["n_resampled", "resample_poly_device", "resample_device"]


def n_resampled(n: int, up: int, down: int) -> int:
    """scipy resample_poly's output length: ceil(n·up/down)."""
    return -(-n * up // down)


@lru_cache(maxsize=16)
def _phase_kernel(up: int, down: int) -> tuple[np.ndarray, int, int]:
    """(kern [up, W] float64, r_lo, r_hi): each output phase's taps over the
    W input samples from x[down·t + r_lo] on."""
    h = design_hq_taps(up, down)
    k = len(h)
    c = (k - 1) // 2
    r_lo = int(np.ceil((c - k + 1) / up))  # the widest support, over p = 0
    r_hi = int(np.floor(((up - 1) * down + c) / up))
    width = r_hi - r_lo + 1
    kern = np.zeros((up, width), np.float64)
    for p in range(up):
        idx = p * down + c - up * (r_lo + np.arange(width))
        ok = (idx >= 0) & (idx < k)
        kern[p, ok] = up * h[idx[ok]]
    return kern, r_lo, r_hi


@lru_cache(maxsize=16)
def _banded_kernel(up: int, down: int) -> tuple[np.ndarray, int]:
    """(km [flen, tc·up] float64, tc): one row of the blocked form, tc
    outputs per phase, km[down·j + w, j·up + p] = kern[p, w]."""
    kern, _, _ = _phase_kernel(up, down)
    width = kern.shape[1]
    tc = max(1, -(-width // down))  # rows overlap by about their own length
    flen = down * (tc - 1) + width
    km = np.zeros((flen, tc * up), np.float64)
    for j in range(tc):
        km[down * j : down * j + width, j * up : (j + 1) * up] = kern.T
    return km, tc


def resample_poly_device(x: torch.Tensor, up: int, down: int, *, block_threshold: int = 1 << 22) -> torch.Tensor:
    """scipy.signal.resample_poly(x, up, down) along the last axis, with the
    kaiser_best-grade taps: [..., n] → [..., ceil(n·up/down)], on ``x``'s
    device and in its dtype (float32 agrees with the float64 host path to
    about 1e-6). Inputs with more than ``block_threshold`` elements take the
    blocked form."""
    if up == down:
        return x
    *lead, n = x.shape
    kern, r_lo, r_hi = _phase_kernel(up, down)
    width = kern.shape[1]
    n_out = n_resampled(n, up, down)
    t_cnt = -(-n_out // up)  # outputs per phase
    pad_lo = -r_lo
    if x.numel() <= block_threshold:
        pad_hi = max(0, down * (t_cnt - 1) + r_hi - (n - 1))
        frames = frame_by_slices(tnf.pad(x, (pad_lo, pad_hi)), 0, t_cnt, width, down)
        y = frames @ torch.as_tensor(kern.T, dtype=x.dtype, device=x.device)  # [..., t_cnt, up]
        return y.reshape(*lead, t_cnt * up)[..., :n_out]
    km, tc = _banded_kernel(up, down)
    nr = -(-t_cnt // tc)
    flen, hop = km.shape[0], down * tc
    need = (nr - 1) * hop + flen
    rows = frame_by_slices(tnf.pad(x, (pad_lo, max(0, need - (n + pad_lo)))), 0, nr, flen, hop)
    y = rows @ torch.as_tensor(km, dtype=x.dtype, device=x.device)  # [..., nr, tc·up]
    return y.reshape(*lead, nr * tc * up)[..., :n_out]


def resample_device(x, orig_sr: float, target_sr: float, *, device=None) -> torch.Tensor:
    """Rate-based :func:`resample_poly_device` (the ratio of
    ``io/wav.resample``, capped at a denominator of 1000). Computes on
    ``device`` (default: ``x``'s own if it is a tensor, else CUDA); array
    input keeps its float dtype."""
    device = resolve_device(device, x)
    x = x.to(device) if torch.is_tensor(x) else torch.as_tensor(x, device=device)
    if orig_sr == target_sr:
        return x
    return resample_poly_device(x, *resample_ratio(orig_sr, target_sr))
