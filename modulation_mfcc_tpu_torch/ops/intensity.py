"""Praat-style intensity (dB SPL) with a pitch-floor-sized Kaiser-20 window.

The reference's ``call(sound, "To Intensity", minPitch, timeStep, 1)``
(script/calc.py:156 via sound.to_intensity()): windowed mean square of the
mean-subtracted signal, in dB re 2·10⁻⁵ Pa. Praat semantics, frame-exact to
the JAX package's ``ops/intensity.py``:

- physical window 6.4/minPitch; default time step 0.8/minPitch;
- frame grid from Sampled_shortTermAnalysis: nf = floor((dur − winDur)/ts)
  + 1, first mid-time = dur/2 − (nf−1)·ts/2, mid sample = nearest index per
  frame. When ts·sr is an integer the grid is uniform and frames are
  strided views; when it is rational with a small denominator q (Praat's
  auto step at min_pitch 75 and 10 kHz: ts·sr = 320/3) the grid is q
  interleaved uniform grids; otherwise frames are gathered;
- taper I₀((2π² + 0.5)·√(1 − (i/(halfDur·sr))²)) over the 2·hws+1 samples
  around the mid sample, hws = floor(halfDur·sr);
- per-frame plain mean over in-range samples subtracted before squaring,
  windowed mean square normalized by the in-range window sum (the masked
  branch runs only when a frame touches a boundary, a host-side check);
- dB = 10·log10(ms / 4e-10), −300 where ms < 1e-30.

The window reduction is a float32 matvec; CUDA float32 matmuls run in full
FP32 unless the caller turns TF32 on (``torch.backends.cuda.matmul``).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as tnf

from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices

__all__ = ["intensity_db", "intensity_times", "intensity_window"]

_HEARING_THRESHOLD_SQ = 4.0e-10  # (2e-5 Pa)^2


def _geometry(n: int, sr: float, min_pitch: float, time_step: float):
    """(hws, hop, nf, ts, first_time): Praat short-term-analysis grid. Every
    float expression matches the JAX package term for term (duration = n·dx
    with dx = 1/sr) so floors and ties resolve identically."""
    ts = 0.8 / min_pitch if time_step <= 0.0 else time_step
    dx = 1.0 / sr
    duration = n * dx
    window_dur = 6.4 / min_pitch
    hws = int(np.floor(3.2 / min_pitch * sr))
    if window_dur > duration:
        # Praat raises; a signal-sized window instead (a superset of its domain)
        hws = max((n - 1) // 2, 1)
    nf = max(1, int(np.floor((duration - window_dur) / ts)) + 1)
    first_time = 0.5 * duration - 0.5 * nf * ts + 0.5 * ts
    hop = max(1, int(round(ts * sr)))
    return hws, hop, nf, ts, first_time


def _kaiser20(hws: int, half_dur_samples: float) -> np.ndarray:
    from scipy.special import i0 as _bessel_i0

    i = np.arange(-hws, hws + 1, dtype=np.float64)
    root = 1.0 - (i / half_dur_samples) ** 2
    return np.where(
        root > 0.0,
        _bessel_i0((2.0 * np.pi**2 + 0.5) * np.sqrt(np.maximum(root, 0.0))),
        0.0,
    )


@lru_cache(maxsize=32)
def intensity_window(n: int, sr: float, min_pitch: float = 100.0, time_step: float = 0.0) -> np.ndarray:
    """The Kaiser-20 taper normalized to unit sum, float32 [2·hws+1]."""
    hws = _geometry(n, sr, min_pitch, time_step)[0]
    w = _kaiser20(hws, 3.2 / min_pitch * sr)
    return (w / np.sum(w)).astype(np.float32)


def intensity_db(
    x: torch.Tensor,
    *,
    sr: float,
    min_pitch: float = 100.0,
    time_step: float = 0.0,
    window: torch.Tensor | None = None,
) -> torch.Tensor:
    """Intensity contour [..., NF] in dB of float32 x [..., n] (Pascal).
    ``window`` is :func:`intensity_window` on x's device (a module buffer);
    designed when None or when its length does not fit this n."""
    n = x.shape[-1]
    hws, hop, nf, ts, ft = _geometry(n, sr, min_pitch, time_step)
    nw = 2 * hws + 1
    if window is None or window.shape != (nw,):
        window = torch.as_tensor(intensity_window(n, sr, min_pitch, time_step), device=x.device)
    wj = window.to(x.dtype)
    # per-frame nearest mid samples, the same float expression as the
    # oracle (round-half-up with the epsilon tie guard), host-side ints
    dx = 1.0 / sr
    mids = np.floor((ft + np.arange(nf) * ts - 0.5 * dx) * sr + 0.5 + 1e-6).astype(np.int64)
    starts = mids - hws
    uniform = bool(np.all(mids == mids[0] + np.arange(nf, dtype=np.int64) * hop))
    clips = starts[0] < 0 or starts[-1] + nw > n
    if uniform and not clips:
        frames = frame_by_slices(x, int(starts[0]), nf, nw, hop)
        d = frames - torch.mean(frames, dim=-1, keepdim=True)
        ms = (d * d) @ wj
    else:
        xpad = tnf.pad(x, (hws, hws))
        q = None
        if not uniform:
            # q interleaved uniform grids when the mid sample advances by the
            # same integer every q frames
            for cand in range(2, 17):
                if nf <= cand:
                    break
                step = int(mids[cand] - mids[0])
                if np.all(mids[cand:] - mids[:-cand] == step):
                    q = cand
                    break
        if uniform:
            frames = frame_by_slices(xpad, int(starts[0]) + hws, nf, nw, hop)
        elif q is not None:
            hopq = int(mids[q] - mids[0])
            m = (nf + q - 1) // q  # group 0 is the largest
            groups = []
            for g in range(q):
                nfg = (nf - g + q - 1) // q  # frames g, g+q, g+2q, …
                gr = frame_by_slices(xpad, int(starts[g]) + hws, nfg, nw, hopq)
                groups.append(tnf.pad(gr, (0, 0, 0, m - nfg)))
            frames = torch.stack(groups, dim=-2).reshape(*x.shape[:-1], m * q, nw)[..., :nf, :]
        else:
            idx = torch.as_tensor(starts[:, None] + np.arange(nw)[None, :] + hws, device=x.device)
            frames = xpad[..., idx]
        idx = starts[:, None] + np.arange(nw, dtype=np.int64)[None, :]
        valid = torch.as_tensor((idx >= 0) & (idx < n), dtype=x.dtype, device=x.device)
        cnt = torch.sum(valid, dim=-1, keepdim=True)
        mean = torch.sum(frames, dim=-1, keepdim=True) / cnt  # pads are 0
        d = (frames - mean) * valid
        ms = ((d * d) @ wj) / (valid @ wj)
    db = 10.0 * torch.log10(torch.clamp(ms, min=1e-300) / _HEARING_THRESHOLD_SQ)
    return torch.where(ms < 1e-30, torch.full_like(ms, -300.0), db)


def intensity_times(n: int, sr: float, min_pitch: float, time_step: float) -> np.ndarray:
    """Frame mid-times of :func:`intensity_db` (host-side, Praat nominal)."""
    _, _, nf, ts, first_time = _geometry(n, sr, min_pitch, time_step)
    return first_time + np.arange(nf) * ts
