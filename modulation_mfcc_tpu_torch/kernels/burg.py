"""Burg LPC of the formant tracker, through a CUDA kernel.

The hand-written kernel ``burg_lpc_f32`` (csrc/burg.cu, wrappers
:func:`burg_lpc` and :func:`burg_reflections`) replaces the Pallas kernel
of modulation_mfcc_tpu/pallas/burg.py (``_burg_call`` → ``_burg_kernel``,
via ``burg_lpc_pallas`` and ``burg_reflections``): the whole order-p Burg
recursion of each frame with the forward and backward prediction errors
kept on chip, and, as with the TPU kernel's ``levinson`` flag, optionally
the fused Levinson update to the LPC coefficients. Bound: the one read of
the frames (422 MB at the tracker's 32 × 30 s batch) and about as long in
FP32 FFMA.

Beside it is its plain PyTorch version, :func:`burg_lpc_reference` (the
JAX package's ``ops/lpc.burg_lpc``). The wrappers take the plain version
only for a CPU tensor; on a CUDA tensor they launch the kernel or raise.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from modulation_mfcc_tpu_torch.kernels._launch import check_cuda, raise_on, route, stream_of

__all__ = [
    "LAUNCHES", "burg_lpc", "burg_reflections", "burg_lpc_reference",
    "levinson_from_reflections",
]

LAUNCHES = {"burg_lpc_f32": 0}

_MAX_ORDER = 32  # kMaxOrder: lane i of a warp holds coefficient i
_WARPS = 8       # kWarps: frames per block, 2·nw floats of shared memory each
_SMEM_MAX = 232_448


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
    return lib


def _burg(frames: torch.Tensor, order: int, levinson: bool) -> torch.Tensor:
    name = "burg_lpc" if levinson else "burg_reflections"
    if not route(frames, name):
        return burg_lpc_reference(frames, order, levinson=levinson)
    check_cuda(name, frames)
    *lead, nw = frames.shape
    if not 1 <= order <= _MAX_ORDER or order >= nw or _WARPS * 2 * nw * 4 > _SMEM_MAX:
        raise ValueError(
            f"{name}: the kernel takes 1 ≤ order ≤ {_MAX_ORDER}, order < nw and "
            f"nw ≤ {_SMEM_MAX // (_WARPS * 8)}; got order {order}, nw {nw}"
        )
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
