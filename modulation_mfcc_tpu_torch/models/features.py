"""Batched MFCC post-processing: deltas and normalization (BASELINE.json
config #2: "padded+masked MFCC + delta/delta-delta", with the deltas and
the per-utterance normalization computed on the device).

  * ``delta``: librosa.feature.delta semantics, the Savitzky-Golay
    derivative (width 9, polyorder 1 by default, mode='interp') along the
    frame axis (ops/savgol.py, a matmul over unit-hop frames);
  * ``cmvn``: per-utterance cepstral mean (and variance) normalization
    with frame masks, so padded batches normalize over valid frames only;
  * ``mfcc_with_deltas``: [B, NF, 3·n_mfcc], static, delta and
    delta-delta stacked along the coefficient axis.
"""
from __future__ import annotations

import torch

from modulation_mfcc_tpu_torch.ops.savgol import savgol_filter

__all__ = ["delta", "cmvn", "mfcc_with_deltas"]


def delta(m: torch.Tensor, *, width: int = 9, order: int = 1, axis: int = -2) -> torch.Tensor:
    """librosa.feature.delta over the frame axis of m [..., NF, n_mfcc]
    (frame axis -2 by default): scipy.signal.savgol_filter(width,
    polyorder=order, deriv=order, mode='interp')."""
    moved = torch.movedim(m, axis, -1)
    return torch.movedim(savgol_filter(moved, width, order, deriv=order), -1, axis)


def cmvn(
    m: torch.Tensor,
    *,
    frame_mask: torch.Tensor | None = None,
    variance: bool = True,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Per-utterance mean (and variance) normalization over valid frames.

    m: [..., NF, C]; frame_mask: [..., NF] (1 = valid). Padded frames are
    zeroed in the output, so later masked reductions stay clean.
    """
    if frame_mask is None:
        mu = torch.mean(m, dim=-2, keepdim=True)
        if variance:
            sd = torch.std(m, dim=-2, keepdim=True, correction=0)
            return (m - mu) / (sd + eps)
        return m - mu
    w = frame_mask[..., :, None].to(m.dtype)
    n = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1.0)
    mu = torch.sum(m * w, dim=-2, keepdim=True) / n
    out = (m - mu) * w
    if variance:
        var = torch.sum((m - mu) ** 2 * w, dim=-2, keepdim=True) / n
        out = out / (torch.sqrt(var) + eps)
    return out * w


def mfcc_with_deltas(
    m: torch.Tensor,
    *,
    frame_mask: torch.Tensor | None = None,
    width: int = 9,
    normalize: bool = False,
) -> torch.Tensor:
    """[..., NF, 3·C]: static + delta + delta-delta of m [..., NF, C],
    normalized per utterance with ``normalize=True`` (over the frames
    ``frame_mask`` marks valid), padded frames zeroed."""
    d1 = delta(m, width=width, order=1)
    d2 = delta(m, width=width, order=2)
    out = torch.cat([m, d1, d2], dim=-1)
    if normalize:
        out = cmvn(out, frame_mask=frame_mask)
    elif frame_mask is not None:
        out = out * frame_mask[..., :, None].to(out.dtype)
    return out
