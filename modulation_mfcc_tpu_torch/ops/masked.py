"""Length-masked variants of the edge-sensitive trajectory ops.

Zero-phase filters and derivative stencils reflect around the *true* end of
each utterance, so a padded batch filtered along its static time axis would
differ from per-file results near every valid/invalid boundary. These
variants take per-item valid lengths and reproduce the single-file edge
behavior inside the static buffer: edge rows are anchored at each item's
``length``, and every output position >= ``length`` is zero.

``length`` is an integer tensor broadcastable against ``x.shape[:-1]``
(e.g. [B, 1] for coefficient trajectories [B, n_coef, T], [B] for [B, T]).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tnf

import numpy as np

from modulation_mfcc_tpu_torch.ops.filters import _as, _conv_valid_lastaxis, lfilter_fir, sosfilt
from modulation_mfcc_tpu_torch.ops.savgol import _savgol_design

__all__ = ["masked_odd_ext", "masked_reverse", "masked_sosfiltfilt", "masked_filtfilt", "masked_sosfiltfilt_fir",
           "masked_gradient", "masked_savgol"]


def _shift_clamped(x: torch.Tensor, s: int) -> torch.Tensor:
    """x[..., clip(i + s, 0, t-1)] for a static shift s."""
    t = x.shape[-1]
    if s == 0:
        return x
    if s > 0:
        s = min(s, t - 1)
        return torch.cat([x[..., s:], x[..., -1:].expand(*x.shape[:-1], s)], dim=-1)
    s = min(-s, t - 1)
    return torch.cat([x[..., :1].expand(*x.shape[:-1], s), x[..., : t - s]], dim=-1)


def _dyn_window(x: torch.Tensor, start: torch.Tensor, out_len: int) -> torch.Tensor:
    """w[..., j] = x[..., start + j] for j in [0, out_len); zero where
    start + j falls outside [0, t). ``start`` broadcasts against
    ``x.shape[:-1]`` and may be negative."""
    t = x.shape[-1]
    start = torch.broadcast_to(torch.as_tensor(start, device=x.device), x.shape[:-1])
    idx = start[..., None] + torch.arange(out_len, device=x.device)
    inside = (idx >= 0) & (idx < t)
    w = torch.gather(x, -1, idx.clamp(0, t - 1))
    return torch.where(inside, w, torch.zeros((), dtype=x.dtype, device=x.device))


def _rev_window(x: torch.Tensor, c: torch.Tensor, out_len: int) -> torch.Tensor:
    """r[..., j] = x[..., c - j] for j in [0, out_len); zero outside [0, t)."""
    t = x.shape[-1]
    return _dyn_window(torch.flip(x, dims=(-1,)), t - 1 - c, out_len)


def masked_odd_ext(x: torch.Tensor, length: torch.Tensor, padlen: int) -> torch.Tensor:
    """Odd extension around [0, length) inside a static buffer: [..., T +
    2·padlen] whose first ``length + 2·padlen`` entries equal scipy's
    odd_ext of x[..., :length], zeros after. Assumes ``padlen < length``
    (scipy's own filtfilt rejects shorter inputs)."""
    t = x.shape[-1]
    out_t = t + 2 * padlen
    j = torch.arange(out_t, device=x.device) - padlen
    L = torch.as_tensor(length, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if padlen == 0:
        return torch.where(j < L[..., None], x, zero)
    xe = _dyn_window(x, torch.clamp(L - 1, 0, t - 1), 1)
    npad = min(padlen, t - 1)
    lcore = torch.flip(x[..., 1 : npad + 1], dims=(-1,))
    if npad < padlen:  # degenerate tiny buffer: clamp at the buffer's edge
        lcore = torch.cat([x[..., -1:].expand(*x.shape[:-1], padlen - npad), lcore], dim=-1)
    left = 2.0 * x[..., :1] - tnf.pad(lcore, (0, out_t - padlen))
    mid = tnf.pad(x, (padlen, padlen))
    right = 2.0 * xe - _rev_window(x, 2 * L - 2 + padlen, out_t)
    Lj = L[..., None]
    vals = torch.where(j < 0, left, torch.where(j < Lj, mid, right))
    return torch.where(j < Lj + padlen, vals, zero)


def masked_reverse(y: torch.Tensor, ext_len: torch.Tensor) -> torch.Tensor:
    """Reverse the valid prefix [0, ext_len) of y along the last axis (zeros
    beyond it)."""
    return _rev_window(y, torch.as_tensor(ext_len, device=y.device) - 1, y.shape[-1])


def masked_sosfiltfilt(
    sos: np.ndarray, zi: np.ndarray, padlen: int, x: torch.Tensor, length: torch.Tensor
) -> torch.Tensor:
    """scipy.signal.sosfiltfilt of x[..., :length] inside the static buffer
    [..., T], for any length above ``padlen``: odd extension at the true end,
    causal forward pass, reversal of the valid prefix, second pass, reversal.
    Causality keeps the junk beyond each prefix out of the valid samples;
    output positions >= length are zero."""
    t = x.shape[-1]
    L = torch.as_tensor(length, device=x.device)
    ext = masked_odd_ext(x, L, padlen)
    zi_c = _as(zi, x).reshape((zi.shape[0],) + (1,) * (x.ndim - 1) + (2,))
    y = sosfilt(sos, ext, zi=zi_c * ext[..., :1])
    ext_len = L + 2 * padlen
    yr = masked_reverse(y, ext_len)
    y2 = sosfilt(sos, yr, zi=zi_c * yr[..., :1])
    out = masked_reverse(y2, ext_len)[..., padlen : padlen + t]
    i = torch.arange(t, device=x.device)
    return torch.where(i < L[..., None], out, torch.zeros((), dtype=x.dtype, device=x.device))


def masked_filtfilt(b: np.ndarray, zi: np.ndarray, padlen: int, x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """scipy.signal.filtfilt(b, 1, ·) of x[..., :length] inside the static
    buffer [..., T]: the construction of :func:`masked_sosfiltfilt` with the
    transversal filter :func:`~modulation_mfcc_tpu_torch.ops.filters.lfilter_fir`,
    parallel over time. Output positions >= length are zero."""
    t = x.shape[-1]
    L = torch.as_tensor(length, device=x.device)
    ext = masked_odd_ext(x, L, padlen)
    zi_t = _as(zi, x)
    y = lfilter_fir(b, ext, zi_t * ext[..., :1])
    ext_len = L + 2 * padlen
    yr = masked_reverse(y, ext_len)
    y2 = lfilter_fir(b, yr, zi_t * yr[..., :1])
    out = masked_reverse(y2, ext_len)[..., padlen : padlen + t]
    i = torch.arange(t, device=x.device)
    return torch.where(i < L[..., None], out, torch.zeros((), dtype=x.dtype, device=x.device))


def masked_sosfiltfilt_fir(design, x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """FIR-operator sosfiltfilt of x[..., :length] in a static buffer.

    Same operator as filters.sosfiltfilt_fir with the right edge anchored at
    each item's ``length``:

      y[i] = left edge rows     for i <  E
      y[i] = conv interior      for E <= i < length - E   (reads x[< length])
      y[i] = right edge rows    for length - E <= i < length

    Caller contract: ``length >= design.min_len`` for every item.
    """
    t = x.shape[-1]
    k, e, w = design.K, design.E, design.W
    i = torch.arange(t, device=x.device)
    L = torch.as_tensor(length, device=x.device)[..., None]
    interior = tnf.pad(_conv_valid_lastaxis(x, design.kernel), (k, k))  # interior[i] ~ y[i]
    left = x[..., :w] @ _as(design.left, x).T
    lastwin = _dyn_window(x, torch.clamp(L[..., 0] - w, 0, t - 1), w)
    right = lastwin @ _as(design.right, x).T
    # y[i] for i in [length-E, length) = right[i - (length-E)]
    right_full = _dyn_window(right, e - L[..., 0], t)
    left_full = tnf.pad(left, (0, t - e))
    out = torch.where(i < e, left_full, torch.where(i < L - e, interior, right_full))
    return torch.where(i < L, out, torch.zeros((), dtype=x.dtype, device=x.device))


def masked_gradient(x: torch.Tensor, length: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """np.gradient (edge_order=1) of x[..., :length] in a static buffer."""
    t = x.shape[-1]
    i = torch.arange(t, device=x.device)
    L = torch.as_tensor(length, device=x.device)[..., None]
    central = (_shift_clamped(x, 1) - _shift_clamped(x, -1)) / (2.0 * spacing)
    left = (x[..., 1:2] - x[..., :1]) / spacing
    xl1 = _dyn_window(x, torch.clamp(L[..., 0] - 1, 0, t - 1), 1)
    xl2 = _dyn_window(x, torch.clamp(L[..., 0] - 2, 0, t - 1), 1)
    right = (xl1 - xl2) / spacing
    out = torch.where(i == 0, left, torch.where(i == L - 1, right, central))
    return torch.where(i < L, out, torch.zeros((), dtype=x.dtype, device=x.device))


def masked_savgol(
    x: torch.Tensor,
    window_length: int,
    polyorder: int,
    length: torch.Tensor,
    *,
    deriv: int = 0,
    delta: float = 1.0,
) -> torch.Tensor:
    """savgol_filter(mode='interp') of x[..., :length] in a static buffer:
    the interior stencil as shifted-slice adds, the polynomial edge fits on
    the first window and on the window ending at each item's length."""
    t = x.shape[-1]
    coeffs, edge_op = _savgol_design(window_length, polyorder, deriv, float(delta))
    half = window_length // 2
    i = torch.arange(t, device=x.device)
    L = torch.as_tensor(length, device=x.device)[..., None]
    # scipy applies convolve1d(x, coeffs): out[i] = Σ_j c[w-1-j]·x[i-half+j]
    acc = torch.zeros_like(x)
    for j, c in enumerate(np.asarray(coeffs)[::-1]):
        acc = acc + float(c) * _shift_clamped(x, j - half)
    e = _as(edge_op, x)
    left = x[..., :window_length] @ e[:half].T
    lastwin = _dyn_window(x, torch.clamp(L[..., 0] - window_length, 0, t - 1), window_length)
    right = lastwin @ e[window_length - half :].T
    out = acc
    for r in range(half):
        out = torch.where(i == r, left[..., r : r + 1], out)
        out = torch.where(i == L - half + r, right[..., r : r + 1], out)
    return torch.where(i < L, out, torch.zeros((), dtype=x.dtype, device=x.device))
