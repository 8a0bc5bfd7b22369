"""Resampling to an analysis rate (host-side, scipy float64).

The formant tracker resamples to twice its ceiling before the LPC stage,
as Praat does. The polyphase filter is kaiser_best grade
(:func:`design_hq_taps`), the JAX package's own design, so both packages
resample identically.
"""
from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np
from scipy.signal import firwin, resample_poly

__all__ = ["design_hq_taps", "resample", "resample_ratio"]


@lru_cache(maxsize=16)
def design_hq_taps(up: int, down: int) -> np.ndarray:
    """kaiser_best-grade polyphase anti-alias filter (without the ``up``
    gain, which resample_poly applies): a ~64-zero-crossing Kaiser-windowed
    sinc with rolloff ≈ 0.9476 and β ≈ 14.77 (resampy's published
    kaiser_best spec); stopband < −100 dB, passband ripple ~1e-5."""
    n_zeros = 64
    rolloff = 0.9475937167399596
    beta = 14.769656459379492
    m = max(up, down)
    half_len = n_zeros * m
    return firwin(2 * half_len + 1, rolloff / m, window=("kaiser", beta)).astype(np.float64)


def resample_ratio(orig_sr: float, target_sr: float) -> tuple[int, int]:
    """(up, down) of the polyphase resampler from ``orig_sr`` to ``target_sr``."""
    frac = Fraction(int(round(target_sr)), int(round(orig_sr))).limit_denominator(1000)
    return frac.numerator, frac.denominator


def resample(x: np.ndarray, orig_sr: float, target_sr: float, taps: np.ndarray | None = None) -> np.ndarray:
    """Polyphase resampling along the last axis (kaiser_best-grade filter).
    ``taps`` overrides the designed filter (the same array, carried as a
    module buffer)."""
    if orig_sr == target_sr:
        return x
    up, down = resample_ratio(orig_sr, target_sr)
    window = design_hq_taps(up, down) if taps is None else taps
    return resample_poly(x, up, down, axis=-1, window=window)
