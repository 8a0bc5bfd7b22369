"""The scan route's length-masked zero-phase Butterworth, and the gradient
norm after it, through CUDA kernels.

The hand-written kernel ``masked_sosfiltfilt_f64`` (csrc/masked_scan.cu,
wrapper :func:`masked_sosfiltfilt_f64`) runs, for every row of a padded
batch, ``scipy.signal.sosfiltfilt`` of the row's valid prefix inside its
static buffer: the odd extension at the row's true end, the forward
cascade, the reversal of the valid prefix, the backward cascade, the
reversal, zeros at and past the length. It is the trajectory low-pass and
the final filter of ``batched_mfcc_change``'s scan route (batches with an
utterance shorter than ``min_frames_for_fir``), in FP64 with every product
and sum rounded on its own, so that it equals its plain version bit for bit.

The plain version is ``ops/masked.masked_sosfiltfilt`` on the rows in
float64, rounded once: a per-sample loop of small tensor ops (about 10 a
sample a section, the same count at any batch size). The wrapper takes it
only for a CPU tensor; on a CUDA tensor it launches the kernel or raises.
:func:`masked_scan_mirror` is the kernel's per-row order in plain Python
floats, for the CPU tests.

``masked_grad_norm_f32`` (wrapper :func:`masked_grad_norm`) is the next
stage of both masked routes (the scan and the FIR operators), √(Σ_c
g_c²)/C of the masked gradient g of the filtered trajectories, in one
launch; its plain version is the torch ops
it replaces (``ops/masked.masked_gradient``, the square, the sum, the root,
the division), about 40 small launches. ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from modulation_mfcc_tpu_torch.kernels._launch import raise_on, route, stream_of
from modulation_mfcc_tpu_torch.ops.masked import masked_gradient, masked_sosfiltfilt

__all__ = ["LAUNCHES", "MAX_SECTIONS", "masked_sosfiltfilt_f64", "masked_scan_mirror", "scratch_elems",
           "masked_grad_norm"]

NAME = "masked_sosfiltfilt_f64"
NORM = "masked_grad_norm_f32"
LAUNCHES = {NAME: 0, NORM: 0}
MAX_SECTIONS = 8  # kMaxSections: a Butterworth up to order 16


def scratch_elems(rows: int, t: int, padlen: int) -> int:
    """float64 elements of the kernel's scratch: each warp's 32 rows of the
    forward pass's T + 2·padlen outputs (csrc/masked_scan.cu scratch_needed)."""
    return -(-rows // 32) * 32 * (t + 2 * padlen)


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from modulation_mfcc_tpu_torch.kernels._build import load_library

    lib = load_library()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.masked_sosfiltfilt_f64.argtypes = [p, ll, ll, i, i, i, p, p, p, i, i, p, ll, p, p]
    lib.masked_sosfiltfilt_f64.restype = i
    lib.masked_grad_norm_f32.argtypes = [p, ll, ll, i, i, i, p, p, p]
    lib.masked_grad_norm_f32.restype = i
    return lib


def masked_sosfiltfilt_f64(sos: np.ndarray, zi: np.ndarray, padlen: int, x: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """``scipy.signal.sosfiltfilt`` of each row's valid prefix in its static
    buffer, in float64: rows x [B, T] or [B, C, T] (C rows an utterance),
    ``lengths`` [B] valid samples an utterance, the design (sos [ns, 6], zi
    [ns, 2], padlen) of ``ops/filters.FiltFilt``.
    Returns [B, T] or [B, C, T] in x's dtype, zero at and past each length:
    on the CPU the plain version, on CUDA the kernel (on the rows rounded to
    float32, as the route's rows are, and copied where their samples are not
    contiguous; the loop's result on those rows)."""
    if x.ndim not in (2, 3):
        raise ValueError(f"{NAME}: rows [B, T] or [B, C, T], got {tuple(x.shape)}")
    if not route(x, NAME):
        length = lengths[:, None] if x.ndim == 3 else lengths
        return masked_sosfiltfilt(sos, zi, padlen, x.double(), length).to(x.dtype)
    sos = np.ascontiguousarray(sos, dtype=np.float64)
    zi = np.ascontiguousarray(zi, dtype=np.float64)
    ns = sos.shape[0]
    if not (1 <= ns <= MAX_SECTIONS and sos.shape == (ns, 6) and zi.shape == (ns, 2) and padlen >= 0):
        raise ValueError(f"{NAME}: 1 to {MAX_SECTIONS} sections with zi [ns, 2] and padlen >= 0; got sos "
                         f"{sos.shape}, zi {zi.shape}, padlen {padlen}")
    b, t = x.shape[0], x.shape[-1]
    c = x.shape[1] if x.ndim == 3 else 1
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.to(x.dtype)
    lengths = torch.as_tensor(lengths).to(device=x.device, dtype=torch.int64).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"{NAME}: lengths [{b}], got {tuple(lengths.shape)}")
    rows = b * c
    x32 = _float32_rows(x)
    scratch = torch.empty(scratch_elems(rows, t, padlen), dtype=torch.float64, device=x.device)
    rc = _lib().masked_sosfiltfilt_f64(
        x32.data_ptr(), x32.stride(0), x32.stride(1) if x.ndim == 3 else t, c, rows, t, lengths.data_ptr(),
        sos.ctypes.data, zi.ctypes.data, ns, int(padlen), scratch.data_ptr(), scratch.numel(), out.data_ptr(),
        stream_of(x),
    )
    raise_on(rc, NAME)
    LAUNCHES[NAME] += 1
    return out.to(x.dtype)


def _float32_rows(x: torch.Tensor) -> torch.Tensor:
    """x in float32 with contiguous samples (the kernels' operand), a copy
    only where x is not already that."""
    x = x.to(torch.float32)
    return x if x.stride(-1) == 1 else x.contiguous()


def masked_grad_norm(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """√(Σ_c g_c²)/C [B, T] of trajectories x [B, C, T],
    g the gradient of each trajectory's valid prefix (``ops/masked.
    masked_gradient``: np.gradient, edges at 0 and at each of ``lengths``
    [B]); zero at and past each length, in x's dtype. On the CPU the plain
    torch ops, on CUDA the kernel (on x rounded to float32, copied where
    its frames are not contiguous)."""
    if x.ndim != 3:
        raise ValueError(f"{NORM}: trajectories [B, C, T], got {tuple(x.shape)}")
    if not route(x, NORM):
        g = masked_gradient(x, lengths[:, None])
        return torch.sqrt(torch.sum(g * g, dim=-2)) / x.shape[-2]
    b, c, t = x.shape
    if t < 2 or not 1 <= b <= 65535:
        raise ValueError(f"{NORM}: [B <= 65535, C, T >= 2], got {tuple(x.shape)}")
    lengths = torch.as_tensor(lengths).to(device=x.device, dtype=torch.int64).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"{NORM}: lengths [{b}], got {tuple(lengths.shape)}")
    x32 = _float32_rows(x)
    out = torch.empty((b, t), dtype=torch.float32, device=x.device)
    rc = _lib().masked_grad_norm_f32(x32.data_ptr(), x32.stride(0), x32.stride(1), c, b, t, lengths.data_ptr(),
                                     out.data_ptr(), stream_of(x))
    raise_on(rc, NORM)
    LAUNCHES[NORM] += 1
    return out.to(x.dtype)


def masked_scan_mirror(sos: np.ndarray, zi: np.ndarray, padlen: int, x: np.ndarray, lengths) -> np.ndarray:
    """The kernel's per-row arithmetic in its order, in Python floats (IEEE
    float64, each operation rounded on its own): rows x [R, T] (any float
    dtype), ``lengths`` [R]; float32 [R, T]. The odd extension read as the
    kernel reads it; each pass a pipeline of the sections, section k taking
    at step t its input t - k from step k on, run NS - 1 steps past the last
    input (on inputs no kept output reads); the backward pass over the
    forward outputs in reverse, its output of step t at j = t - (NS - 1)."""
    p = int(padlen)
    coef = [tuple(float(v) for v in (s[0], s[1], s[2], s[4], s[5])) for s in np.asarray(sos, dtype=np.float64)]
    zis = [tuple(float(v) for v in z) for z in np.asarray(zi, dtype=np.float64)]
    ns = len(coef)
    rows, t = x.shape
    out = np.zeros((rows, t), dtype=np.float32)

    def run(inputs: list, n: int) -> list:
        """One pass over ``inputs`` (n of them, then NS - 1 more steps): the
        last section's output of each step."""
        u0 = inputs[0] if n else 0.0
        z = [[zs[0] * u0, zs[1] * u0] for zs in zis]
        v = [0.0] * ns
        outs = []
        for step in range(n + ns - 1):
            u = inputs[step] if step < n else 0.0
            y = [0.0] * ns
            for k, (b0, b1, b2, a1, a2) in enumerate(coef):
                inp = u if k == 0 else v[k]
                y[k] = b0 * inp + z[k][0]
                if step >= k:
                    z[k] = [(b1 * inp - a1 * y[k]) + z[k][1], b2 * inp - a2 * y[k]]
            v = [0.0] + y[:-1]
            outs.append(y[-1])
        return outs

    for r in range(rows):
        row = [float(v) for v in x[r]]
        n = min(max(int(lengths[r]), 0), t)
        two_x0, two_xe = 2.0 * row[0], 2.0 * row[min(max(n - 1, 0), t - 1)]

        def ext(e):
            if e < p:
                return two_x0 - row[min(p - e, t - 1)]
            if e < n + p:
                return row[e - p]
            idx = n - 2 - (e - n - p)
            return two_xe - (row[idx] if idx >= 0 else 0.0)

        e_len = n + 2 * p
        if e_len == 0:
            continue
        fwd = run([ext(e) for e in range(e_len)], e_len)[ns - 1 :]
        back = run(fwd[::-1][: n + p], n + p)
        for step, y in enumerate(back):
            j = step - (ns - 1)
            if p <= j < n + p:
                out[r, n + p - 1 - j] = np.float32(y)
    return out
