"""Savitzky-Golay filtering and differentiation as a fixed linear operator.

scipy's ``savgol_filter(..., mode='interp')`` (the reference's smoothing and
derivative, script/mfcc.py:128-131 and :409-412) is linear: an interior
correlation with the Savitzky-Golay coefficients plus polynomial
least-squares fits on the first and last window. The stencil and the two
edge matrices are designed on the host from scipy itself (float64, so the
edge rows are scipy's own); on the device the interior is one matmul over
the unit-hop frames of the signal and each edge one small matmul. There is
no convolution, so cuDNN's TF32 default never applies.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.signal as _sps
import torch

from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices

__all__ = ["savgol_filter"]


@lru_cache(maxsize=128)
def _savgol_design(window_length: int, polyorder: int, deriv: int, delta: float):
    """(stencil [w], edge_op [w, w]) for savgol mode='interp'.

    ``edge_op`` is scipy's savgol_filter applied to the identity: rows
    0..half-1 and rows -half..-1 are exactly the polynomial edge fits.
    """
    coeffs = _sps.savgol_coeffs(window_length, polyorder, deriv=deriv, delta=delta)
    eye = np.eye(window_length)
    edge_op = _sps.savgol_filter(
        eye, window_length, polyorder, deriv=deriv, delta=delta, axis=0, mode="interp"
    )
    return coeffs, edge_op


def savgol_filter(
    x: torch.Tensor,
    window_length: int,
    polyorder: int,
    *,
    deriv: int = 0,
    delta: float = 1.0,
) -> torch.Tensor:
    """scipy.signal.savgol_filter(..., mode='interp') along the last axis."""
    t = x.shape[-1]
    if t < window_length:
        raise ValueError(
            f"If mode is 'interp', window_length must be less than or equal "
            f"to the size of x ({t})."
        )
    coeffs, edge_op = _savgol_design(window_length, polyorder, deriv, float(delta))
    half = window_length // 2
    # scipy applies convolve1d(x, coeffs) == correlation with coeffs reversed;
    # the valid part covers output indices [half, t - half)
    kernel = torch.as_tensor(coeffs[::-1].copy(), dtype=x.dtype, device=x.device)
    interior = frame_by_slices(x, 0, t - window_length + 1, window_length, 1) @ kernel
    e = torch.as_tensor(edge_op, dtype=x.dtype, device=x.device)
    left = x[..., :window_length] @ e[:half].T
    right = x[..., -window_length:] @ e[window_length - half :].T
    return torch.cat([left, interior, right], dim=-1)
