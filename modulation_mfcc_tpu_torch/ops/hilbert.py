"""Analytic signal and Hilbert envelope (torch.fft).

Replaces the reference's ``np.abs(hilbert(x))`` amplitude path
(script/mfcc.py:200-206). Same construction as scipy.signal.hilbert: zero
negative frequencies, double positive ones, keep DC (and Nyquist for even
N). The JAX package's ops/hilbert.py.
"""
from __future__ import annotations

import torch

__all__ = ["analytic_signal", "hilbert_envelope"]


def _hilbert_transform(x: torch.Tensor) -> torch.Tensor:
    """Imaginary part of the analytic signal of real ``x`` along the last
    axis: scipy's ``ifft(fft(x) · h)`` has real part ``x`` and imaginary
    part ``irfft(−i · rfft(x))`` with the DC (and, for even N, Nyquist) bins
    zeroed, so one rfft/irfft pair computes it."""
    n = x.shape[-1]
    mask = torch.ones(n // 2 + 1, dtype=x.dtype, device=x.device)
    mask[0] = 0.0
    if n % 2 == 0:
        mask[-1] = 0.0
    xf = torch.fft.rfft(x, dim=-1)
    rot = torch.complex(xf.imag * mask, -(xf.real * mask))
    return torch.fft.irfft(rot, n=n, dim=-1)


def analytic_signal(x: torch.Tensor) -> torch.Tensor:
    """Analytic signal along the last axis (complex) of real ``x``."""
    return torch.complex(x, _hilbert_transform(x))


def hilbert_envelope(x: torch.Tensor) -> torch.Tensor:
    """|analytic signal|: the 'Hilb' amplitude method (script/mfcc.py:202)."""
    ht = _hilbert_transform(x)
    return torch.sqrt(x * x + ht * ht)
