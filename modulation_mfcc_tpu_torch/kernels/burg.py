"""Burg LPC of the formant tracker, through a CUDA kernel.

The hand-written kernel ``burg_lpc_f32`` (csrc/burg.cu, wrappers
:func:`burg_lpc` and :func:`burg_reflections`) replaces the Pallas kernel
of modulation_mfcc_tpu/pallas/burg.py (``_burg_call`` → ``_burg_kernel``,
via ``burg_lpc_pallas`` and ``burg_reflections``): the whole order-p Burg
recursion of each frame with the forward and backward prediction errors
kept in registers (lane i of a warp holds elements [i·C, (i+1)·C)), and,
as with the TPU kernel's ``levinson`` flag, optionally the fused Levinson
update to the LPC coefficients. Bound: FP32 FFMA (10.4 GFLOP at the
tracker's 32 × 30 s batch) and about as long in the one read of the frames
(422 MB). :func:`burg_plan` is the launcher's choice of C, warps a frame
and blocks an SM; the wrappers check it against the library's own.

Beside it is its plain PyTorch version, :func:`burg_lpc_reference` (the
JAX package's ``ops/lpc.burg_lpc``). The wrappers take the plain version
only for a CPU tensor; on a CUDA tensor they launch the kernel or raise.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from modulation_mfcc_tpu_torch.kernels._launch import check_cuda, raise_on, route, stream_of

__all__ = [
    "LAUNCHES", "BurgPlan", "burg_plan", "burg_lpc", "burg_reflections", "burg_lpc_reference",
    "levinson_from_reflections",
]

LAUNCHES = {"burg_lpc_f32": 0}

_MAX_ORDER = 32  # kMaxOrder: lane i of a warp holds coefficient i
_MAX_NW = 3632   # kMaxNw: the frame widths the first design's shared memory held
_WARPS = 8       # kWarps: warps a block
_CHUNKS = (1, 2, 4, 6, 8, 12, 16, 18, 20, 24, 28, 32)  # kChunks: the C instantiations
_XCH = 5         # kXch: floats of a warp's exchange slot


class BurgPlan(NamedTuple):
    """The launcher's plan for frames of ``nw`` (csrc/burg.cu make_plan)."""

    chunk: int            # C: elements a lane holds
    warps_per_frame: int  # 1, 2 or 4
    blocks_per_sm: int    # the kernel's launch bound (minimum blocks an SM)
    shared_bytes: int     # staging rows and exchange slots of a block


def burg_plan(nw: int, order: int) -> BurgPlan:
    """C, warps a frame and blocks an SM for frames of ``nw`` at ``order``:
    the fewest warps (1, 2, 4) whose lanes hold the frame at C ≤ 32, then
    the smallest instantiated C that covers it. Raises outside the kernel's
    range (2 ≤ nw ≤ 3632, 1 ≤ order ≤ 32, order < nw)."""
    if not (2 <= nw <= _MAX_NW and 1 <= order <= _MAX_ORDER and order < nw):
        raise ValueError(
            f"burg_lpc_f32 takes 1 ≤ order ≤ {_MAX_ORDER}, order < nw and 2 ≤ nw ≤ {_MAX_NW}; "
            f"got order {order}, nw {nw}"
        )
    wf = 1 if nw <= 32 * 32 else 2 if nw <= 2 * 32 * 32 else 4
    need = -(-nw // (32 * wf))
    chunk = next(c for c in _CHUNKS if c >= need)
    blocks = 4 if chunk <= 12 else 3 if chunk <= 20 else 2
    return BurgPlan(chunk, wf, blocks, 4 * (_WARPS * 32 * chunk + 2 * _WARPS * _XCH))


def burg_lpc_reference(frames: torch.Tensor, order: int, *, levinson: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``burg_lpc_f32``: [..., order] LPC
    coefficients a_1..a_p of frames [..., N], with x[n] ≈ −Σ a_k x[n−k]
    (polynomial 1 + Σ a_k z^−k); with ``levinson=False`` the reflection
    coefficients k_1..k_p instead."""
    f = frames
    b = frames
    a = torch.zeros(frames.shape[:-1] + (order,), dtype=frames.dtype, device=frames.device)
    for m in range(order):
        fk = f[..., 1:]
        bk = b[..., :-1]
        num = -2.0 * torch.sum(fk * bk, dim=-1)
        den = torch.sum(fk * fk, dim=-1) + torch.sum(bk * bk, dim=-1)
        k = num / torch.clamp(den, min=1e-30)
        f, b = fk + k[..., None] * bk, bk + k[..., None] * fk
        if levinson and m > 0:
            a[..., :m] = a[..., :m] + k[..., None] * torch.flip(a[..., :m], dims=(-1,))
        a[..., m] = k
    return a


def levinson_from_reflections(ks: torch.Tensor) -> torch.Tensor:
    """LPC coefficients a_1..a_p from reflection coefficients [..., p] (the
    update :func:`burg_lpc_reference` interleaves with its recursion)."""
    order = ks.shape[-1]
    a = torch.zeros_like(ks)
    for m in range(order):
        k = ks[..., m : m + 1]
        if m > 0:
            a[..., :m] = a[..., :m] + k * torch.flip(a[..., :m], dims=(-1,))
        a[..., m] = k[..., 0]
    return a


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from modulation_mfcc_tpu_torch.kernels._build import load_library

    lib = load_library()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.burg_lpc_f32.argtypes = [p, p, i, i, i, i, p]
    lib.burg_lpc_f32.restype = i
    lib.burg_lpc_f32_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.burg_lpc_f32_plan.restype = i
    return lib


@lru_cache(maxsize=None)
def library_plan(nw: int, order: int) -> BurgPlan:
    """The plan the built library's launcher uses (``burg_lpc_f32_plan``)."""
    out = (ctypes.c_int * 4)()
    raise_on(_lib().burg_lpc_f32_plan(nw, order, out), "burg_lpc_f32_plan")
    return BurgPlan(*out)


def _burg(frames: torch.Tensor, order: int, levinson: bool) -> torch.Tensor:
    name = "burg_lpc" if levinson else "burg_reflections"
    if not route(frames, name):
        return burg_lpc_reference(frames, order, levinson=levinson)
    check_cuda(name, frames)
    *lead, nw = frames.shape
    plan = burg_plan(nw, order)
    if library_plan(nw, order) != plan:
        raise RuntimeError(f"{name}: the launcher's plan {library_plan(nw, order)} is not {plan}")
    m = int(np.prod(lead)) if lead else 1
    out = torch.empty((*lead, order), dtype=torch.float32, device=frames.device)
    rc = _lib().burg_lpc_f32(frames.data_ptr(), out.data_ptr(), m, nw, order, int(levinson), stream_of(frames))
    raise_on(rc, "burg_lpc_f32")
    LAUNCHES["burg_lpc_f32"] += 1
    return out


def burg_lpc(frames: torch.Tensor, order: int) -> torch.Tensor:
    """LPC coefficients a_1..a_p [..., order] of float32 frames [..., nw],
    the Levinson update fused into the kernel (JAX ``burg_lpc_pallas``)."""
    return _burg(frames, order, levinson=True)


def burg_reflections(frames: torch.Tensor, order: int) -> torch.Tensor:
    """Reflection coefficients k_1..k_p [..., order] of float32 frames
    [..., nw] (JAX ``burg_reflections``)."""
    return _burg(frames, order, levinson=False)
