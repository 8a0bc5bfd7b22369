"""Window functions (host-side design, float64 numpy).

The MFCC path uses librosa's default periodic Hann window
(``scipy.signal.get_window('hann', win_length, fftbins=True)``), or a
Hamming window by name (:func:`get_window`); the window is folded into the
DFT bases at design time and never applied on device.
The display spectrogram uses a Gaussian (:func:`gaussian`); the trackers
use Praat's tapers: AC_HANNING and the Gaussian of
:func:`praat_gauss` (pitch), the same Gaussian (formants) and a Kaiser-20
window (intensity, ops/intensity.py).
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


def hamming(m: int, periodic: bool = True) -> np.ndarray:
    """Periodic (fftbins=True) or symmetric Hamming window, float64; matches
    ``scipy.signal.get_window('hamming', m, fftbins=periodic)``."""
    if m == 1:
        return np.ones(1)
    denom = m if periodic else m - 1
    n = np.arange(m)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / denom)


def gaussian(m: int, std: float) -> np.ndarray:
    """Gaussian window, matches scipy.signal.windows.gaussian (symmetric); the
    display spectrogram's taper (models/sound.py)."""
    n = np.arange(m) - (m - 1) / 2.0
    return np.exp(-0.5 * (n / std) ** 2)


def praat_hanning(nw: int) -> np.ndarray:
    """Praat's AC_HANNING taper: w(i) = 0.5 − 0.5·cos(2πi/(n+1)), i = 1..n —
    nonzero endpoints (scipy's symmetric Hann of n+2 with the zero endpoints
    dropped), not scipy.hann(n)."""
    i = np.arange(1, nw + 1, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (nw + 1))


def praat_gauss(nw: int) -> np.ndarray:
    """Praat's AC_GAUSS / formant Gaussian taper (float64):
    exp(−48·u²) with u = (i − imid)/(n+1), i = 1..n, edge-subtracted and
    normalized so the (virtual) endpoints hit exactly 0 — the pitch
    tracker's veryAccurate window (Sound_to_Pitch.cpp) and the formant
    pre-window (Sound_to_Formant.cpp)."""
    i = np.arange(1, nw + 1, dtype=np.float64)
    imid = 0.5 * (nw + 1)
    edge = np.exp(-12.0)
    return (np.exp(-48.0 * ((i - imid) / (nw + 1)) ** 2) - edge) / (1.0 - edge)


def kaiser(m: int, beta: float, periodic: bool = False) -> np.ndarray:
    """Kaiser window via numpy (i0-based), symmetric by default."""
    if periodic:
        return np.kaiser(m + 1, beta)[:-1]
    return np.kaiser(m, beta)


_WINDOWS = {"hann": hann, "hamming": hamming}


def get_window(name: str, m: int, periodic: bool = True) -> np.ndarray:
    """Window by name; the subset of scipy.signal.get_window the MFCC path uses."""
    try:
        return _WINDOWS[name](m, periodic)
    except KeyError:
        raise ValueError(f"Unknown window {name!r}; available: {sorted(_WINDOWS)}")
