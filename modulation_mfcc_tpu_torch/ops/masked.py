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

from modulation_mfcc_tpu_torch.ops.filters import _as, _conv_valid_lastaxis

__all__ = ["masked_sosfiltfilt_fir", "masked_gradient"]


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

