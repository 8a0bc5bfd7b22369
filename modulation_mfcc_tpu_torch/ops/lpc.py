"""LPC formant analysis: Burg recursion + polynomial roots, batched.

The reference's Praat call (script/calc.py:142-148
``sound.to_formant_burg``): resample to 2× the formant ceiling,
pre-emphasize, Gaussian-window the frames, Burg LPC of order
2·max_formants, polynomial roots → formant frequencies and bandwidths.

The Burg stage runs through the CUDA kernel ``burg_lpc_f32``
(kernels/burg.py) by default; ``burg_engine='plain'`` runs its plain
PyTorch version. Roots come from Durand–Kerner simultaneous iteration in
complex64, a fixed 40 iterations (the JAX package's solver, parallel over
frames), as plain torch.
"""
from __future__ import annotations

import numpy as np
import torch

from modulation_mfcc_tpu_torch.kernels import burg as burg_kernel
from modulation_mfcc_tpu_torch.kernels.burg import burg_lpc_reference as burg_lpc
from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from modulation_mfcc_tpu_torch.ops.windows import praat_gauss

__all__ = ["burg_lpc", "poly_roots_dk", "formant_frames", "formant_window_length", "formant_window", "lpc_formants"]

BURG_ENGINES = ("auto", "plain")


def poly_roots_dk(coeffs: torch.Tensor, iters: int = 40) -> torch.Tensor:
    """Roots [..., p] (complex64) of the monic polynomials z^p + c_1 z^(p−1)
    + … + c_p, coeffs [..., p]. Durand–Kerner from the standard
    (0.4+0.9i)^k start; 40 iterations match a 120-iteration run to ≤ 0.001 Hz
    on Burg coefficient sets (the JAX package's measurement)."""
    p = coeffs.shape[-1]
    c = coeffs.to(torch.complex64)
    seed = torch.as_tensor((0.4 + 0.9j) ** np.arange(1, p + 1), dtype=torch.complex64, device=coeffs.device)
    z = seed.expand(*coeffs.shape[:-1], p)
    eye = torch.eye(p, dtype=torch.complex64, device=coeffs.device)
    tiny = torch.full((), 1e-20, dtype=torch.complex64, device=coeffs.device)
    for _ in range(iters):
        pz = torch.ones_like(z)
        for i in range(p):
            pz = pz * z + c[..., i : i + 1]
        diff = z[..., :, None] - z[..., None, :] + eye  # avoid self-division
        denom = diff[..., 0]
        for j in range(1, p):
            denom = denom * diff[..., j]
        z = z - pz / torch.where(torch.abs(denom) < 1e-20, tiny, denom)
    return z


def formant_window_length(n: int, sr: float, window_length: float) -> int:
    """Samples of Praat's physical formant window, 2×window_length."""
    return min(max(int(round(2.0 * window_length * sr)), 4), n)


def formant_frames(n: int, sr: float, window_length: float, time_step: float):
    """Frame geometry: Praat's physical window is 2×window_length with a
    Gaussian taper. (starts [NF], nw, frame centre times [NF])."""
    nw = formant_window_length(n, sr, window_length)
    hop = max(1, int(round(time_step * sr)))
    nf = max(1, 1 + (n - nw) // hop)
    start0 = max(0, (n - nw - (nf - 1) * hop) // 2)  # Praat-centred grid
    starts = start0 + np.arange(nf) * hop
    times = (starts + nw / 2.0) / sr
    return starts, nw, times


def formant_window(nw: int) -> np.ndarray:
    """Praat's formant Gaussian window (Sound_to_Formant.cpp), float32 [nw]."""
    return praat_gauss(nw).astype(np.float32)


def lpc_formants(
    x: torch.Tensor,
    *,
    sr: float,
    order: int = 10,
    window_length: float = 0.025,
    time_step: float = 0.005,
    pre_emphasis_from: float = 50.0,
    max_formant: float = 5500.0,
    burg_engine: str = "auto",
    window: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(freqs [..., NF, order//2], bandwidths [..., NF, order//2]), sorted
    ascending by frequency, of float32 x [..., n] already resampled to
    2·max_formant. Frequencies outside (50 Hz, max_formant − 50) are NaN,
    like Praat's out-of-range formants; silent frames are all NaN.

    ``burg_engine``: 'auto' (the CUDA kernel on a CUDA tensor, its plain
    version on a CPU tensor) or 'plain'. ``window`` is
    :func:`formant_window` on x's device (a module buffer); designed when
    None or when its length does not fit this n.
    """
    if burg_engine not in BURG_ENGINES:
        raise ValueError(f"burg_engine {burg_engine!r} not in {BURG_ENGINES}")
    n = x.shape[-1]
    # pre-emphasis: x[i] -= exp(-2π·F·dt)·x[i-1] (Praat's PreEmphasis)
    alpha = float(np.exp(-2.0 * np.pi * pre_emphasis_from / sr))
    xp = torch.cat([x[..., :1], x[..., 1:] - alpha * x[..., :-1]], dim=-1)
    starts, nw, _ = formant_frames(n, sr, window_length, time_step)
    hop = int(starts[1] - starts[0]) if len(starts) > 1 else 1
    frames = frame_by_slices(xp, int(starts[0]), len(starts), nw, hop)
    frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    if window is None or window.shape != (nw,):
        window = torch.as_tensor(formant_window(nw), device=x.device)
    frames = frames * window.to(x.dtype)
    if burg_engine == "plain":
        a = burg_lpc(frames, order)
    else:
        a = burg_kernel.burg_lpc(frames, order)
    # A(z) = 1 + Σ a_k z^-k: its zeros solve z^p + a_1 z^(p-1) + … + a_p = 0
    roots = poly_roots_dk(a)
    ang = torch.angle(roots)
    mag = torch.abs(roots)
    freq = torch.abs(ang) * (sr / (2.0 * np.pi))
    bw = -torch.log(torch.clamp(mag, min=1e-12)) * (sr / np.pi)
    valid = (freq > 50.0) & (freq < max_formant - 50.0) & (ang > 0)
    freq = torch.where(valid, freq, torch.full_like(freq, float("inf")))
    # stable sort by frequency; ties occur only among +inf entries
    freq_sorted, perm = torch.sort(freq, dim=-1, stable=True)
    bw_sorted = torch.gather(bw, -1, perm)[..., : order // 2]
    freq_sorted = freq_sorted[..., : order // 2]
    nan = torch.full_like(freq_sorted, float("nan"))
    freq_out = torch.where(torch.isfinite(freq_sorted), freq_sorted, nan)
    # silent frames: Burg gives all-zero coefficients, whose only root is the
    # origin, but a fixed Durand-Kerner iteration count leaves spurious
    # partly converged roots there; Praat reports no formants for silence
    dead = torch.sum(frames * frames, dim=-1, keepdim=True) <= 0.0
    return torch.where(dead, nan, freq_out), torch.where(dead, nan, bw_sorted)
