"""Window functions (host-side design, float64 numpy).

The MFCC path uses librosa's default periodic Hann window
(``scipy.signal.get_window('hann', win_length, fftbins=True)``); the window
is folded into the DFT bases at design time and never applied on device.
"""
from __future__ import annotations

import numpy as np


def hann(m: int, periodic: bool = True) -> np.ndarray:
    """Periodic (fftbins=True) or symmetric Hann window, float64."""
    if m == 1:
        return np.ones(1)
    denom = m if periodic else m - 1
    n = np.arange(m)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)


_WINDOWS = {"hann": hann}


def get_window(name: str, m: int, periodic: bool = True) -> np.ndarray:
    """Window by name; the subset of scipy.signal.get_window the MFCC path uses."""
    try:
        return _WINDOWS[name](m, periodic)
    except KeyError:
        raise ValueError(f"Unknown window {name!r}; available: {sorted(_WINDOWS)}")
