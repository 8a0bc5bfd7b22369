"""Windowed-sinc peak refinement of the pitch tracker, through a CUDA kernel.

The hand-written kernel ``sinc_refine_f32`` (csrc/sinc_refine.cu, wrapper
:func:`refine_sinc_band`) replaces the Pallas kernel of
modulation_mfcc_tpu/pallas/sinc_refine.py (``refine_sinc_band_pallas`` →
``_refine_kernel``). For every row of the autocorrelation ``r_ext`` and
every integer lag of the band [lag_lo, lag_max] it evaluates the windowed
-sinc interpolant at 17 offsets in [−1, 1], takes the first maximum over the
interior offsets and polishes it with a parabola, giving the position and
value of the interpolant's maximum around that lag (Praat's
NUMimproveMaximum with the sinc scheme). Bound: FP32 FFMA (45 GFLOP at the
tracker's 32 × 30 s batch at 16 kHz). A thread keeps a register tile of
:data:`LAGS_PER_THREAD` neighbouring lags of one row; :func:`sinc_plan` is
the kernel's tiling, which the wrapper computes and passes to the launcher.

Beside it is its plain PyTorch version, :func:`refine_sinc_band_reference`
(the JAX package's ``ops/pitch._refine_sinc_dense``: one banded matmul
against :func:`sinc_band_matrix`, the argmax, and reads of the neighbours).
The wrapper takes the plain version only for a CPU tensor; on a CUDA tensor
it launches the kernel or raises. ``LAUNCHES`` counts kernel launches.

The weights are the JAX package's host design (``_sinc_weights``), kept
here in numpy so both packages interpolate with identical constants.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from modulation_mfcc_tpu_torch.kernels._launch import check_cuda, raise_on, route, stream_of

__all__ = [
    "LAUNCHES", "GRID", "LAGS_PER_THREAD", "SincPlan", "sinc_plan", "sinc_weights",
    "sinc_band_matrix", "refine_sinc_band", "refine_sinc_band_reference",
]

LAUNCHES = {"sinc_refine_f32": 0}

GRID = 17  # offsets per lag (kG in the .cu): spacing 1/8 over [-1, 1]
LAGS_PER_THREAD = 8            # kJ: J, the lags of a thread's register tile
ROWS = 32                      # kRows: rows of a group, one a lane
WARPS = 8                      # kWarps: lag groups of a lag block, one a warp
WEIGHT_ROW = 20                # kGP: a weight row padded to five float4
TAPS_RESIDENT = 160            # S up to this keeps the weights staged once a block
TAP_CHUNK = 128                # taps a chunk when the weights are streamed


class SincPlan(NamedTuple):
    """The kernel's tiling for a band of ``nl`` lags and ``S`` taps (the
    launcher's ``Plan``, passed by value in this field order)."""

    lag_block: int     # lags of an item: J a warp, 8 warps
    lag_blocks: int    # items a row group
    taps_chunk: int    # taps staged at once (all S when the weights stay resident)
    chunks: int
    x_stride: int      # floats a staged row (4 mod 8: lanes are rows, float4 loads on distinct banks)
    out_stride: int    # floats a row of the (pos, val) tile (odd)
    shared_bytes: int


def sinc_plan(nl: int, s: int) -> SincPlan:
    """The tiling of ``sinc_refine_f32``: items of 32 rows × 8·J lags; the
    x band of an item (one float in, so each lane's x of four taps is one
    aligned float4), and with S > 160 the weights, staged in chunks of taps
    into one of two buffers; shared bytes of a block."""
    if nl < 1 or s < 1:
        raise ValueError(f"sinc_refine_f32 takes nl ≥ 1 and S ≥ 1; got {nl}, {s}")
    lag_block = WARPS * LAGS_PER_THREAD
    taps = s if s <= TAPS_RESIDENT else TAP_CHUNK
    chunks = -(-s // taps)
    x_stride, out_stride = (lag_block + taps + 3) // 8 * 8 + 4, lag_block | 1
    resident = s * WEIGHT_ROW if chunks == 1 else 0
    slot = (0 if chunks == 1 else taps * WEIGHT_ROW) + ROWS * x_stride
    return SincPlan(lag_block, -(-nl // lag_block), taps, chunks, x_stride, out_stride,
                    4 * (resident + 2 * slot + 2 * ROWS * out_stride))


# ---------------------------------------------------------------------------
# Host design (numpy float64, as the JAX package designs it)
# ---------------------------------------------------------------------------


def _sinc_weights(offsets: np.ndarray, depth: int) -> np.ndarray:
    """Interpolation weights [2·depth+3, n_offsets] of the windowed-sinc
    interpolant (sinc × raised cosine over ±(depth+1) samples of the
    evaluation point) at fractional ``offsets`` from an integer grid point,
    over the support samples −(depth+1) … +(depth+1) around it."""
    k = np.arange(-(depth + 1), depth + 2, dtype=np.float64)
    dist = offsets[None, :] - k[:, None]
    w = np.sinc(dist) * (0.5 + 0.5 * np.cos(np.pi * dist / (depth + 1)))
    w[np.abs(dist) > depth + 1] = 0.0
    return w


@lru_cache(maxsize=8)
def sinc_weights(depth: int, grid: int = GRID) -> np.ndarray:
    """The weights [S = 2·depth+3, grid] at offsets linspace(−1, 1, grid), float32."""
    return _sinc_weights(np.linspace(-1.0, 1.0, grid), depth).astype(np.float32)


def sinc_band_matrix(w: torch.Tensor, nl: int) -> torch.Tensor:
    """The banded-GEMM operator [nl+S−1, G·nl] built from weights ``w``
    [S, G]: column g·nl + l carries w[:, g] on rows l … l+S−1 (the JAX
    package's ``_sinc_band_matrix`` with dense packing)."""
    s, g = w.shape
    band = torch.zeros((nl + s - 1, g, nl), dtype=w.dtype, device=w.device)
    rows = torch.arange(s, device=w.device)[:, None] + torch.arange(nl, device=w.device)[None, :]
    band[rows, :, torch.arange(nl, device=w.device)[None, :]] = w[:, None, :].expand(s, nl, g)
    return band.reshape(nl + s - 1, g * nl)


def _band_args(r_ext: torch.Tensor, ext_left: int, lag_lo: int, lag_max: int, depth: int):
    nl = lag_max - lag_lo + 1
    s = 2 * depth + 3
    start = ext_left - (depth + 1) + lag_lo
    if nl < 1 or start < 0 or start + nl + s - 1 > r_ext.shape[-1]:
        raise ValueError(
            f"refine_sinc_band: band [{lag_lo}, {lag_max}] at depth {depth} does not fit "
            f"r_ext of length {r_ext.shape[-1]} with ext_left {ext_left}"
        )
    return nl, s, start


def _weights_on(w: torch.Tensor | None, depth: int, grid: int, like: torch.Tensor) -> torch.Tensor:
    if w is None:
        return torch.as_tensor(sinc_weights(depth, grid), device=like.device)
    if w.shape != (2 * depth + 3, grid):
        raise ValueError(f"refine_sinc_band: weights {tuple(w.shape)} != {(2 * depth + 3, grid)}")
    return w


# ---------------------------------------------------------------------------
# Plain version and kernel wrapper
# ---------------------------------------------------------------------------


def refine_sinc_band_reference(
    r_ext: torch.Tensor,
    ext_left: int,
    lag_lo: int,
    lag_max: int,
    depth: int,
    grid: int = GRID,
    w: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``sinc_refine_f32``: (pos, val)
    [..., lag_max−lag_lo+1]. The interpolant at every (lag, offset) is one
    banded matmul [..., nl+S−1] @ [nl+S−1, G·nl]; neighbours of the argmax
    are read with gathers (the same values as the JAX one-hot sums)."""
    nl, s, start = _band_args(r_ext, ext_left, lag_lo, lag_max, depth)
    w = _weights_on(w, depth, grid, r_ext).to(r_ext.dtype)
    x = r_ext[..., start : start + nl + s - 1]
    interp = (x @ sinc_band_matrix(w, nl)).reshape(*x.shape[:-1], grid, nl)
    imax = torch.argmax(interp[..., 1:-1, :], dim=-2, keepdim=True) + 1  # [..., 1, nl]
    f0 = torch.gather(interp, -2, imax)[..., 0, :]
    fm = torch.gather(interp, -2, imax - 1)[..., 0, :]
    fp = torch.gather(interp, -2, imax + 1)[..., 0, :]
    denom = fm - 2.0 * f0 + fp
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (fm - fp) / denom, torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    h = 2.0 / (grid - 1)
    offs = torch.as_tensor(np.linspace(-1.0, 1.0, grid), dtype=r_ext.dtype, device=r_ext.device)
    lag_grid = torch.arange(lag_lo, lag_lo + nl, dtype=r_ext.dtype, device=r_ext.device)
    pos = lag_grid + offs[imax[..., 0, :]] + delta * h
    val = f0 - 0.25 * (fm - fp) * delta
    return pos, val


class _Plan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in SincPlan._fields]


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from modulation_mfcc_tpu_torch.kernels._build import load_library

    lib = load_library()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sinc_refine_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, _Plan, p]
    lib.sinc_refine_f32.restype = i
    return lib


def refine_sinc_band(
    r_ext: torch.Tensor,
    ext_left: int,
    lag_lo: int,
    lag_max: int,
    depth: int,
    grid: int = GRID,
    w: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos, val) [..., lag_max−lag_lo+1] of the windowed-sinc interpolant's
    maximum around each integer lag of [lag_lo, lag_max] of ``r_ext``
    [..., L] (the arguments of the JAX ``refine_sinc_band_pallas``). ``w``
    is :func:`sinc_weights` on r_ext's device (a module buffer); designed
    when None."""
    if not route(r_ext, "refine_sinc_band"):
        return refine_sinc_band_reference(r_ext, ext_left, lag_lo, lag_max, depth, grid, w)
    nl, s, start = _band_args(r_ext, ext_left, lag_lo, lag_max, depth)
    if grid != GRID:
        raise ValueError(f"refine_sinc_band: the kernel takes grid {GRID}, got {grid}")
    plan = _Plan(*sinc_plan(nl, s))
    w = _weights_on(w, depth, grid, r_ext)
    check_cuda("refine_sinc_band", r_ext, w)
    *lead, length = r_ext.shape
    m = int(np.prod(lead)) if lead else 1
    pos = torch.empty((*lead, nl), dtype=torch.float32, device=r_ext.device)
    val = torch.empty_like(pos)
    rc = _lib().sinc_refine_f32(
        r_ext.data_ptr(), w.data_ptr(), pos.data_ptr(), val.data_ptr(),
        m, length, start, nl, s, grid, lag_lo, 2.0 / (grid - 1), plan, stream_of(r_ext),
    )
    raise_on(rc, "sinc_refine_f32")
    LAUNCHES["sinc_refine_f32"] += 1
    return pos, val
