"""Numerical differentiation of trajectories."""
from __future__ import annotations

import torch


def np_gradient(x: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """np.gradient along the last axis (edge_order=1), the reference's default
    derivative (script/mfcc.py:407, script/calc.py:644)."""
    inv2h = 1.0 / (2.0 * spacing)
    invh = 1.0 / spacing
    interior = (x[..., 2:] - x[..., :-2]) * inv2h
    left = (x[..., 1:2] - x[..., :1]) * invh
    right = (x[..., -1:] - x[..., -2:-1]) * invh
    return torch.cat([left, interior, right], dim=-1)
