"""Signal framing for STFT-style analysis.

Semantics match librosa's centered STFT framing used by the reference's MFCC
call (script/mfcc.py:387): the signal is padded by ``n_fft // 2`` zeros on
both sides (``center=True, pad_mode='constant'``) and frames of ``n_fft``
samples are taken every ``hop`` samples; :func:`frame_signal` also takes
``center=False`` and ``pad_mode='reflect'``. ``_pad_signal`` is np.pad on the
device, for framing and for pyin's every pad mode (ops/yin.py). Frame counts
and time anchors are computed on the host from static lengths.
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


_COPY_MODES = ("edge", "reflect", "symmetric", "wrap")  # np.pad modes that copy samples
_VALUE_MODES = ("linear_ramp", "maximum", "mean", "median", "minimum")  # modes that compute pad values
PAD_MODES = ("constant", *_COPY_MODES, *_VALUE_MODES)


def _median(x: torch.Tensor) -> torch.Tensor:
    """np.median over the last axis (keepdims): the mean of the two middle
    values of an even-length row (torch.median takes the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2 : (n - 1) // 2 + 1] + s[..., n // 2 : n // 2 + 1]) / 2


def _pad_signal(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """np.pad(x, pad, mode) along the last axis, on x's device: zeros for
    'constant'; for the modes that copy samples, a gather at np.pad's own
    indices; for the value modes, np.pad's values over the whole row
    (stat_length=None): its max, min, mean or median on both sides, or for
    'linear_ramp' (end value 0) the ramp i·(edge/pad), i = 0..pad−1, from the
    outer end towards each edge sample, as np.linspace(0, edge, pad,
    endpoint=False) computes it."""
    if mode not in PAD_MODES:
        raise ValueError(f"pad_mode {mode!r} not in {PAD_MODES}")
    if mode == "constant":
        return tnf.pad(x, (pad, pad))
    if mode in _COPY_MODES:
        idx = np.pad(np.arange(x.shape[-1]), pad, mode=mode)
        return x[..., torch.as_tensor(idx, device=x.device)]
    if mode == "linear_ramp":
        ramp = torch.arange(pad, dtype=x.dtype, device=x.device)
        left = ramp * (x[..., :1] / pad)
        right = torch.flip(ramp * (x[..., -1:] / pad), dims=(-1,))
        return torch.cat([left, x, right], dim=-1)
    stat = {
        "maximum": lambda v: torch.amax(v, dim=-1, keepdim=True),
        "minimum": lambda v: torch.amin(v, dim=-1, keepdim=True),
        "mean": lambda v: torch.mean(v, dim=-1, keepdim=True),
        "median": _median,
    }[mode](x)
    side = stat.expand(*x.shape[:-1], pad)
    return torch.cat([side, x, side], dim=-1)


def frame_signal(
    x: torch.Tensor, frame_length: int, hop: int, *, center: bool = True, pad_mode: str = "constant"
) -> torch.Tensor:
    """Slice ``x[..., T]`` into overlapping frames ``[..., n_frames,
    frame_length]``. With ``center=True`` ``frame_length // 2`` samples are
    padded on each side first (librosa's convention): zeros for
    ``pad_mode='constant'`` (the librosa>=0.10 default the reference's MFCC
    call uses), the mirrored signal for ``'reflect'``."""
    n = x.shape[-1]
    if center:
        if pad_mode not in ("constant", "reflect"):
            raise ValueError(f"Unsupported pad_mode {pad_mode!r}")
        x = _pad_signal(x, frame_length // 2, pad_mode)
    nf = 1 + (x.shape[-1] - frame_length) // hop
    if nf <= 0:
        raise ValueError(f"Signal of length {n} too short for frame_length={frame_length}")
    return frame_by_slices(x, 0, nf, frame_length, hop)


def frame_times_mfcc(n_frames: int, t_step: float, win_len: float) -> np.ndarray:
    """Time anchors of the reference's MFCC-change output (script/mfcc.py:390):
    ``T = round((arange(1, n_frames+1) * tStep) + winLen/2, 4)``, float64."""
    return np.round(np.arange(1, n_frames + 1) * t_step + win_len / 2.0, 4)


def frame_times_centered(n_frames: int, hop: int, sr: float) -> np.ndarray:
    """librosa ``frames_to_time`` anchors of centered frames: frame i at
    ``i * hop / sr`` seconds, float64."""
    return np.arange(n_frames) * (hop / sr)


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
