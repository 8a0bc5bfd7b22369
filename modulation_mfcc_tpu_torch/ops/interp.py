"""Gap filling for unvoiced/NaN regions, vectorized along the last axis.

The reference's interp_NAN (script/calc.py:345-385): the previous/next
valid neighbour of every sample comes from two cumulative maxima, and the
fill is a gather + lerp (linear) or a monotone cubic Hermite (pchip). Works
on any leading batch shape.
"""
from __future__ import annotations

import torch

__all__ = ["interp_nan", "prev_next_valid"]


def prev_next_valid(valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For each position, the index of the nearest valid sample at-or-before
    and at-or-after (−1 / n if none). ``valid`` is bool [..., n]."""
    n = valid.shape[-1]
    idx = torch.arange(n, device=valid.device)
    minus = torch.full_like(idx, -1)
    prev = torch.cummax(torch.where(valid, idx, minus), dim=-1).values
    rev_prev = torch.cummax(torch.where(torch.flip(valid, (-1,)), idx, minus), dim=-1).values
    rev = torch.flip(rev_prev, (-1,))
    nxt = torch.where(rev >= 0, n - 1 - rev, torch.full_like(rev, n))
    return prev, nxt


def _first_two_valid(valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first two valid samples along the last axis (n+1 if none)."""
    n = valid.shape[-1]
    idx = torch.arange(n, device=valid.device)
    big = torch.full_like(idx, n + 1)
    v0 = torch.amin(torch.where(valid, idx, big), dim=-1)
    v1 = torch.amin(torch.where(valid & (idx > v0[..., None]), idx, big), dim=-1)
    return v0, v1


def _last_two_valid(valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n = valid.shape[-1]
    idx = torch.arange(n, device=valid.device)
    minus = torch.full_like(idx, -1)
    u1 = torch.amax(torch.where(valid, idx, minus), dim=-1)
    u0 = torch.amax(torch.where(valid & (idx < u1[..., None]), idx, minus), dim=-1)
    return u0, u1


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[..., i] for per-row indices i [...] (clipped into range)."""
    return torch.gather(x, -1, i.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]


def interp_nan(x: torch.Tensor, method: str = "linear") -> torch.Tensor:
    """Fill NaNs along the last axis.

    'linear' matches scipy interp1d(..., fill_value='extrapolate')
    (script/calc.py:379-380): interior gaps lerp between the surrounding
    valid samples; leading/trailing gaps extrapolate the first/last valid
    segment. 'pchip' matches the reference's pchip branch
    (script/calc.py:370-377): endpoints are first filled with the nearest
    valid value, then gaps get a monotone (Fritsch-Carlson) cubic Hermite.
    """
    valid = ~torch.isnan(x)
    filled = _interp_pchip(x, valid) if method == "pchip" else _interp_linear(x, valid)
    return torch.where(valid | valid.all(), x, filled)


def _interp_linear(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    prev, nxt = prev_next_valid(valid)
    v0, v1 = _first_two_valid(valid)
    u0, u1 = _last_two_valid(valid)
    pc = prev.clamp(0, n - 1)
    nc = nxt.clamp(0, n - 1)
    xz = torch.where(valid, x, torch.zeros_like(x))
    xp = torch.gather(xz, -1, pc.expand_as(xz))
    xn = torch.gather(xz, -1, nc.expand_as(xz))
    denom = torch.clamp(nc - pc, min=1)
    interior = xp + (idx - pc).to(x.dtype) / denom * (xn - xp)

    def segment(i0, i1):
        y0, y1 = _at(xz, i0), _at(xz, i1)
        slope = (y1 - y0) / torch.clamp(i1 - i0, min=1)
        return y0[..., None] + slope[..., None] * (idx - i0[..., None])

    left = segment(v0, v1)
    right = segment(u0, u1)
    out = torch.where(prev < 0, left, torch.where(nxt >= n, right, interior))
    one_valid = (v1 > n) | (v0 == u1)  # a single valid point: constant fill
    return torch.where(one_valid[..., None], _at(xz, v0)[..., None], out)


def _interp_pchip(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Monotone cubic Hermite on the (irregular) valid grid, after filling
    the endpoints with the nearest valid value (script/calc.py:371-374)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    v0, _ = _first_two_valid(valid)
    _, u1 = _last_two_valid(valid)
    xz = torch.where(valid, x, torch.zeros_like(x))
    x2 = torch.where((idx == 0) & ~valid, _at(xz, v0)[..., None], x)
    x2 = torch.where((idx == n - 1) & torch.isnan(x2), _at(xz, u1)[..., None], x2)
    valid2 = ~torch.isnan(x2)
    prev, nxt = prev_next_valid(valid2)
    xz2 = torch.where(valid2, x2, torch.zeros_like(x2))
    pc = prev.clamp(0, n - 1).expand_as(xz2)
    nc = nxt.clamp(0, n - 1).expand_as(xz2)
    # previous valid strictly before i / next strictly after i, per valid i
    prev_excl = torch.cat([torch.full_like(prev[..., :1], -1), prev[..., :-1]], dim=-1)
    next_excl = torch.cat([nxt[..., 1:], torch.full_like(nxt[..., :1], n)], dim=-1)
    pe = prev_excl.clamp(0, n - 1).expand_as(xz2)
    ne = next_excl.clamp(0, n - 1).expand_as(xz2)
    h1 = torch.clamp(idx - pe, min=1)
    h2 = torch.clamp(ne - idx, min=1)
    d1 = (xz2 - torch.gather(xz2, -1, pe)) / h1
    d2 = (torch.gather(xz2, -1, ne) - xz2) / h2
    w1 = 2 * h2 + h1
    w2 = h2 + 2 * h1
    one = torch.ones_like(d1)
    m_interior = torch.where(
        (d1 * d2) > 0,
        (w1 + w2) / (w1 / torch.where(d1 == 0, one, d1) + w2 / torch.where(d2 == 0, one, d2)),
        torch.zeros_like(d1),
    )
    m = torch.where(prev_excl < 0, d2, torch.where(next_excl >= n, d1, m_interior))
    xa = torch.gather(xz2, -1, pc)
    xb = torch.gather(xz2, -1, nc)
    ma = torch.gather(m, -1, pc)
    mb = torch.gather(m, -1, nc)
    h = torch.clamp(nc - pc, min=1)
    t = (idx - pc).to(x.dtype) / h
    t2, t3 = t * t, t * t * t
    val = (2 * t3 - 3 * t2 + 1) * xa + (t3 - 2 * t2 + t) * h * ma + (-2 * t3 + 3 * t2) * xb + (t3 - t2) * h * mb
    return torch.where(valid2, x2, val)
