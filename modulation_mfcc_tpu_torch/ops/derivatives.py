"""Numerical differentiation of trajectories: the reference's velocity and
acceleration (script/calc.py:593-650 ``get_velocity``).

  * 'gradient': np.gradient semantics (central interior, first-order
    one-sided edges), applied ``difference`` times (script/calc.py:642-645);
  * 'sg': the Savitzky-Golay derivative (scipy savgol mode='interp',
    ops/savgol.py);
  * 'finDiff': findiff.FinDiff(0, 1/sr, difference, acc=accOrder)
    semantics: a central stencil of accuracy ``acc`` in the interior and
    one-sided stencils of the same accuracy at the boundaries, designed on
    the host in float64 with Fornberg's algorithm (findiff is not a
    dependency).

The stencils are applied as slice differences or as matmuls over unit-hop
frames of the signal, never as a convolution, so cuDNN's TF32 default
never applies.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from modulation_mfcc_tpu_torch.ops.savgol import savgol_filter

__all__ = ["np_gradient", "fornberg_weights", "findiff_stencils", "findiff_apply", "velocity"]


def np_gradient(x: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """np.gradient along the last axis (edge_order=1), the reference's default
    derivative (script/mfcc.py:407, script/calc.py:644)."""
    inv2h = 1.0 / (2.0 * spacing)
    invh = 1.0 / spacing
    interior = (x[..., 2:] - x[..., :-2]) * inv2h
    left = (x[..., 1:2] - x[..., :1]) * invh
    right = (x[..., -1:] - x[..., -2:-1]) * invh
    return torch.cat([left, interior, right], dim=-1)


def fornberg_weights(m: int, x0: float, grid: np.ndarray) -> np.ndarray:
    """Finite-difference weights for the m-th derivative at x0 on ``grid``.

    Fornberg (1988) recursion; returns weights [len(grid)] (float64).
    """
    n = len(grid)
    delta = np.zeros((m + 1, n, n))
    delta[0, 0, 0] = 1.0
    c1 = 1.0
    for nn in range(1, n):
        c2 = 1.0
        for nu in range(nn):
            c3 = grid[nn] - grid[nu]
            c2 *= c3
            for mm in range(min(nn, m) + 1):
                delta[mm, nn, nu] = (
                    (grid[nn] - x0) * delta[mm, nn - 1, nu]
                    - mm * delta[mm - 1, nn - 1, nu]
                ) / c3
        for mm in range(min(nn, m) + 1):
            delta[mm, nn, nn] = (
                c1
                / c2
                * (
                    mm * delta[mm - 1, nn - 1, nn - 1]
                    - (grid[nn - 1] - x0) * delta[mm, nn - 1, nn - 1]
                )
            )
        c1 = c2
    return delta[m, n - 1, :]


@lru_cache(maxsize=128)
def findiff_stencils(deriv: int, acc: int, spacing: float):
    """(central [w], forward [L], backward [L], half) findiff-style stencils.

    Central stencil has ``2*floor((deriv+1)/2) - 1 + acc`` points; one-sided
    stencils have one extra point when ``deriv`` is even (findiff convention).
    Weights already divided by spacing**deriv.
    """
    num_central = 2 * ((deriv + 1) // 2) - 1 + acc
    half = num_central // 2
    central_grid = np.arange(-half, half + 1, dtype=np.float64)
    num_side = num_central + (1 if deriv % 2 == 0 else 0)
    fwd_grid = np.arange(num_side, dtype=np.float64)
    scale = spacing ** (-deriv)
    central = fornberg_weights(deriv, 0.0, central_grid) * scale
    forward = fornberg_weights(deriv, 0.0, fwd_grid) * scale
    backward = fornberg_weights(deriv, 0.0, -fwd_grid[::-1]) * scale
    return central, forward, backward, half


def findiff_apply(x: torch.Tensor, deriv: int, spacing: float, acc: int = 2) -> torch.Tensor:
    """findiff.FinDiff(0, spacing, deriv, acc=acc) along the last axis: the
    central stencil over the unit-hop frames of ``x`` (one matmul), and at
    each of the first and last ``half`` samples the one-sided stencil
    anchored there (findiff convention)."""
    central, forward, backward, half = findiff_stencils(deriv, acc, float(spacing))
    t = x.shape[-1]
    w = len(central)
    L = len(forward)
    if t < max(w, L):
        raise ValueError(f"Signal length {t} too short for stencil ({max(w, L)})")
    # y[i] = Σ_j c[j]·x[i+j] over offsets -half..half: frames times the stencil, no flip
    interior = frame_by_slices(x, 0, t - w + 1, w, 1) @ torch.as_tensor(central, dtype=x.dtype, device=x.device)
    fw = torch.as_tensor(forward, dtype=x.dtype, device=x.device)
    bw = torch.as_tensor(backward, dtype=x.dtype, device=x.device)
    lefts = [(x[..., i : i + L] @ fw)[..., None] for i in range(half)]
    rights = [(x[..., t - (half - i) - L + 1 : t - (half - i) + 1] @ bw)[..., None] for i in range(half)]
    return torch.cat(lefts + [interior] + rights, dim=-1)


def velocity(
    x: torch.Tensor,
    sr: float,
    *,
    difference: int = 1,
    method: str = "gradient",
    width: int = 3,
    acc_order: int = 2,
    poly_order: int = 2,
) -> torch.Tensor:
    """Reference get_velocity (script/calc.py:593-650) along the last axis.

    Note: the app layer calls this with sr=1.0 (per-sample derivative,
    reference script/main.py:683); callers keep that quirk for parity with
    the reference's Velocity/Acceleration curves (models/pipeline.py).
    """
    if method == "finDiff":
        return findiff_apply(x, difference, 1.0 / sr, acc=acc_order)
    if method == "sg":
        return savgol_filter(x, width, poly_order, deriv=difference)
    if method == "gradient":
        for _ in range(difference):
            x = np_gradient(x, 1.0 / sr)
        return x
    raise ValueError("Méthode inconnue. Utilisez 'gradient', 'sg' ou 'finDiff'.")
