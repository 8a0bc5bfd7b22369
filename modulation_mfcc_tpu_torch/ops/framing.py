"""Signal framing for STFT-style analysis.

Semantics match librosa's centered STFT framing used by the reference's MFCC
call (script/mfcc.py:387): the signal is padded by ``n_fft // 2`` zeros on
both sides (``center=True, pad_mode='constant'``) and frames of ``n_fft``
samples are taken every ``hop`` samples. Frame counts and time anchors are
computed on the host from static lengths.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf


def n_frames_centered(n_samples: int, n_fft: int, hop: int) -> int:
    """Number of STFT frames for a centered transform (librosa convention)."""
    return 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop


def frame_by_slices(
    x: torch.Tensor, start0: int, n_frames: int, frame_length: int, hop: int
) -> torch.Tensor:
    """Overlapping frames ``F[..., k, i] = x[..., start0 + k*hop + i]``, a
    strided view (no copy). Requires
    ``start0 + (n_frames-1)*hop + frame_length <= x.shape[-1]``."""
    W, H, nf = int(frame_length), int(hop), int(n_frames)
    if start0 + (nf - 1) * H + W > x.shape[-1]:
        raise ValueError("frame_by_slices: frames read past the signal end")
    return x[..., start0:].unfold(-1, W, H)[..., :nf, :]


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice ``x[..., T]`` into centered overlapping frames
    ``[..., n_frames, frame_length]``: ``frame_length // 2`` zeros are padded
    on each side first (librosa ``center=True, pad_mode='constant'``)."""
    pad = frame_length // 2
    nf = n_frames_centered(x.shape[-1], frame_length, hop)
    return frame_by_slices(tnf.pad(x, (pad, pad)), 0, nf, frame_length, hop)


def frame_times_mfcc(n_frames: int, t_step: float, win_len: float) -> np.ndarray:
    """Time anchors of the reference's MFCC-change output (script/mfcc.py:390):
    ``T = round((arange(1, n_frames+1) * tStep) + winLen/2, 4)``, float64."""
    return np.round(np.arange(1, n_frames + 1) * t_step + win_len / 2.0, 4)


def hop_window_sums(series: torch.Tensor, nf: int, window: int, hop: int) -> torch.Tensor:
    """``out[..., f] = Σ series[..., f·hop : f·hop + window]``, f ∈ [0, nf).

    Frame starts are hop-aligned, so each window sum decomposes into
    ``window//hop`` whole hop-row sums plus one ``window%hop`` partial row:
    O(len) reads, no frame matrix, and no long-range cumsum (every output is
    a fresh ~window/hop-term sum of row sums, so no cancellation grows with
    position). The RMS envelope's energy (models/envelope.py). A series
    shorter than the row grid is zero-extended; callers guarantee that valid
    windows read only real data. The JAX package's ops/framing.hop_window_sums.
    """
    q, rem = divmod(int(window), int(hop))
    n_rows = nf + q if rem else nf - 1 + q
    need = n_rows * hop
    length = series.shape[-1]
    if length < need:
        series = tnf.pad(series, (0, need - length))
    elif length > need:
        series = series[..., :need]
    rows = series.reshape(*series.shape[:-1], n_rows, hop)
    rs = torch.sum(rows, dim=-1)
    out = None
    for r in range(q):
        out = rs[..., r : r + nf] if out is None else out + rs[..., r : r + nf]
    if rem:
        partial = torch.sum(rows[..., :rem], dim=-1)[..., q : q + nf]
        out = partial if out is None else out + partial
    return out
