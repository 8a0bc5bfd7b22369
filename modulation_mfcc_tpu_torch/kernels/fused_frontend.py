"""Fused spectral frontend: audio → mel power → MFCC, through two CUDA kernels.

Two hand-written kernels (csrc/fused_frontend.cu) carry the MFCC stage of
the flagship path on the GPU:

  * ``fused_mel_f32`` (wrapper :func:`fused_mel_frontend`) replaces the
    Pallas frontend of modulation_mfcc_tpu/pallas/fused_frontend.py
    (``fused_mel_frontend`` → ``_launch`` → ``_kernel``, algorithm 'f32').
    Frames are built in shared memory from the contiguous audio span of a
    64-frame block, so no frame matrix exists in device memory; the
    windowed real DFT, power and mel projection run as FP32 FFMA GEMMs, and
    each block writes the max of its valid frames for the top_db clip.
    Bound: FP32 CUDA-core FLOPs (~315 GFLOP DFT + ~50 GFLOP mel per
    128 × 30 s batch at 16 kHz).
  * ``mfcc_tail_f32`` (wrapper :func:`mfcc_tail`) replaces the Pallas tail
    kernels (``mfcc_tail`` → ``_tail_kernel_t`` / ``_tail_kernel``):
    10·log10(max(mel, 1e-10)), the clip at peak − 80 dB, and the DCT-II,
    written coef-major [B, n_mfcc, NF] or frame-major [B, NF, n_mfcc].
    Bound: the one read of the mel tensor.

Beside each wrapper is its plain PyTorch version
(:func:`fused_mel_frontend_reference`, :func:`mfcc_tail_reference`). A
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches, so a run can show that its main path went through the kernels.

The weight construction (window-support trim, zero-mel-bin trim, Nyquist
packing) is a verbatim numpy port of the JAX frontend's host code
(fused_mel_frontend, lines 746-799, and mfcc_tail, lines 1179-1181): it
decides the numbers, so both packages compute from identical constants.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as tnf

from modulation_mfcc_tpu_torch.kernels._launch import check_cuda, raise_on, route, stream_of
from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from modulation_mfcc_tpu_torch.ops.spectral import dct_matrix, dft_bases, mel_filterbank
from modulation_mfcc_tpu_torch.utils.helpers import round_up_to_multiple

__all__ = [
    "LAUNCHES", "frontend_weights", "tail_dct", "eff_pad",
    "fused_mel_frontend", "fused_mel_frontend_reference",
    "mfcc_tail", "mfcc_tail_reference", "fused_mfcc",
]

LAUNCHES = {"fused_mel_f32": 0, "mfcc_tail_f32": 0}

BLOCK_FRAMES = 64  # frames per fused_mel_f32 block: one bmax entry each (kBF in the .cu)
_BIN_TILE = 128    # bins_pad must be a multiple (kBT)
_MEL_MAX = 128     # kMelMax
_MFCC_MAX = 32     # kMfccMax


# ---------------------------------------------------------------------------
# Host design (numpy, verbatim from the JAX frontend)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def frontend_weights(
    sr: float,
    n_fft: int = 512,
    win_length: int | None = None,
    n_mels: int = 128,
    fmin: float = 100.0,
    fmax: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(wri [K, 2·bins_pad], melw [bins_pad, n_mels]), both float32.

    K is the trimmed window support (win_length). Columns [0, bins_pad) of
    ``wri`` are the real DFT bases and [bins_pad, 2·bins_pad) the imaginary
    ones; trailing bins with zero mel weight are trimmed, and when every bin
    is live the Nyquist real column rides the always-zero im₀ slot with its
    mel weight moved onto the DC power row.
    """
    win_length = win_length or n_fft
    pw = (n_fft - win_length) // 2
    sup = win_length
    wr, wi = dft_bases(n_fft, "hann", win_length)
    n_bins_full = wr.shape[1]
    wr = wr[pw : pw + sup]
    wi = wi[pw : pw + sup]
    m_full = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    nz = np.flatnonzero(np.abs(m_full).sum(axis=0) > 0)
    n_bins = int(nz[-1]) + 1 if nz.size else n_bins_full
    half = n_fft // 2
    packed = (
        n_bins == half + 1
        and half % 128 == 0
        and nz.size
        and int(nz[0]) >= 1
    )
    if packed:
        bins_pad = half
        wr_eff = wr[:, :half].copy()
        wr_eff[:, 0] = 0.0  # DC power must not pollute the Nyquist slot
        wi_eff = wi[:, :half].copy()
        wi_eff[:, 0] = wr[:, half]  # Nyquist re rides the im₀ column
        m_p = np.zeros((bins_pad, n_mels), np.float32)
        m_p[:half, :] = m_full.T[:half]
        m_p[0, :] = m_full.T[half]  # DC power slot now carries Nyquist power
    else:
        bins_pad = round_up_to_multiple(n_bins, 128)
        wr_eff = wr[:, :n_bins]
        wi_eff = wi[:, :n_bins]
        m_p = np.zeros((bins_pad, n_mels), np.float32)
        m_p[:n_bins, :] = m_full.T[:n_bins]
    ncol = wr_eff.shape[1]
    wri_p = np.zeros((sup, 2 * bins_pad), np.float32)
    wri_p[:, :ncol] = wr_eff
    wri_p[:, bins_pad : bins_pad + ncol] = wi_eff
    return wri_p, m_p


@lru_cache(maxsize=16)
def tail_dct(n_mfcc: int, n_mels: int) -> np.ndarray:
    """DCT-II ortho as [n_mels, n_mfcc] float32 (the live columns of the JAX
    tail's padded DCT)."""
    return np.ascontiguousarray(dct_matrix(n_mfcc, n_mels).T, dtype=np.float32)


def eff_pad(n_fft: int, win_length: int | None) -> int:
    """Left pad so frame f's trimmed window support starts at f·hop."""
    win_length = win_length or n_fft
    return n_fft // 2 - (n_fft - win_length) // 2


def _weights_on(audio: torch.Tensor, sr, n_fft, win_length, n_mels, fmin, fmax):
    wri, melw = frontend_weights(sr, n_fft, win_length, n_mels, fmin, fmax)
    to = dict(dtype=torch.float32, device=audio.device)
    return torch.as_tensor(wri, **to), torch.as_tensor(melw, **to)


# ---------------------------------------------------------------------------
# Kernel binding
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from modulation_mfcc_tpu_torch.kernels._build import load_library

    lib = load_library()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mel_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.fused_mel_f32.restype = i
    lib.mfcc_tail_f32.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mfcc_tail_f32.restype = i
    return lib


# ---------------------------------------------------------------------------
# fused_mel_f32
# ---------------------------------------------------------------------------


def fused_mel_frontend_reference(
    audio: torch.Tensor, wri: torch.Tensor, melw: torch.Tensor, *, hop: int, eff_pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``fused_mel_f32``: frame matrix, then matmuls."""
    bsz, t = audio.shape
    k = wri.shape[0]
    bins_pad = wri.shape[1] // 2
    nf = 1 + t // hop
    right = max(0, (nf - 1) * hop + k - eff_pad - t)
    frames = frame_by_slices(tnf.pad(audio, (eff_pad, right)), 0, nf, k, hop)
    reim = frames @ wri
    re, im = reim[..., :bins_pad], reim[..., bins_pad:]
    mel = (re * re + im * im) @ melw
    n_blocks = -(-nf // BLOCK_FRAMES)
    fmax = tnf.pad(torch.amax(mel, dim=-1), (0, n_blocks * BLOCK_FRAMES - nf))
    bmax = torch.amax(fmax.reshape(bsz, n_blocks, BLOCK_FRAMES), dim=-1)
    return mel, bmax


def fused_mel_frontend(
    audio: torch.Tensor,
    *,
    sr: float,
    n_fft: int = 512,
    hop: int = 80,
    win_length: int | None = None,
    n_mels: int = 128,
    fmin: float = 100.0,
    fmax: float | None = None,
    weights: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mel [B, nf, n_mels], block_maxes [B, ceil(nf/64)]) for audio [B, T]
    float32, nf = 1 + T // hop (librosa centered framing, zero pad).

    ``block_maxes[b, j]`` is the max of mel over frames [64j, 64j+64) ∩
    [0, nf); their max over j is the utterance's peak mel power.
    ``weights`` = (wri, melw) on the audio's device (a module's buffers);
    designed from the other arguments when None.
    """
    if audio.ndim != 2 or audio.dtype != torch.float32:
        raise ValueError(f"fused_mel_frontend: audio must be float32 [B, T], got {audio.dtype} {tuple(audio.shape)}")
    if weights is None:
        weights = _weights_on(audio, sr, n_fft, win_length, n_mels, fmin, fmax)
    wri, melw = weights
    pad = eff_pad(n_fft, win_length)
    if not route(audio, "fused_mel_frontend"):
        return fused_mel_frontend_reference(audio, wri, melw, hop=hop, eff_pad=pad)
    check_cuda("fused_mel_frontend", audio, wri, melw)
    bsz, t = audio.shape
    k, two_bins = wri.shape
    bins_pad, n_mels = melw.shape
    if two_bins != 2 * bins_pad or bins_pad % _BIN_TILE or n_mels > _MEL_MAX:
        raise ValueError(
            f"fused_mel_frontend: wri {tuple(wri.shape)} / melw {tuple(melw.shape)} need "
            f"2·bins_pad columns, bins_pad a multiple of {_BIN_TILE}, n_mels ≤ {_MEL_MAX}"
        )
    nf = 1 + t // hop
    mel = torch.empty((bsz, nf, n_mels), dtype=torch.float32, device=audio.device)
    bmax = torch.empty((bsz, -(-nf // BLOCK_FRAMES)), dtype=torch.float32, device=audio.device)
    rc = _lib().fused_mel_f32(
        audio.data_ptr(), wri.data_ptr(), melw.data_ptr(), mel.data_ptr(), bmax.data_ptr(),
        bsz, t, k, hop, pad, nf, bins_pad, n_mels,
        stream_of(audio),
    )
    raise_on(rc, "fused_mel_f32")
    LAUNCHES["fused_mel_f32"] += 1
    return mel, bmax


# ---------------------------------------------------------------------------
# mfcc_tail_f32
# ---------------------------------------------------------------------------


def mfcc_tail_reference(
    mel: torch.Tensor, peak: torch.Tensor, dct: torch.Tensor, *, transposed: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of ``mfcc_tail_f32``."""
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    db = torch.maximum(db, (peak - 80.0)[:, None, None])
    out = db @ dct
    return out.transpose(-1, -2).contiguous() if transposed else out


def mfcc_tail(
    mel: torch.Tensor,
    peak: torch.Tensor,
    n_mfcc: int,
    *,
    transposed: bool = False,
    dct: torch.Tensor | None = None,
) -> torch.Tensor:
    """dB/clip/DCT over mel [B, nf, n_mels] with per-utterance dB peaks [B]
    (librosa power_to_db top_db=80 + DCT-II ortho): [B, nf, n_mfcc], or
    coef-major [B, n_mfcc, nf] with ``transposed=True``. ``dct`` is the
    [n_mels, n_mfcc] matrix on mel's device (designed when None)."""
    bsz, nf, n_mels = mel.shape
    if dct is None:
        dct = torch.as_tensor(tail_dct(n_mfcc, n_mels), dtype=torch.float32, device=mel.device)
    if dct.shape != (n_mels, n_mfcc):
        raise ValueError(f"mfcc_tail: dct {tuple(dct.shape)} != {(n_mels, n_mfcc)}")
    if not route(mel, "mfcc_tail"):
        return mfcc_tail_reference(mel, peak, dct, transposed=transposed)
    check_cuda("mfcc_tail", mel, peak, dct)
    if peak.shape != (bsz,) or n_mfcc > _MFCC_MAX:
        raise ValueError(f"mfcc_tail: peak {tuple(peak.shape)} != ({bsz},) or n_mfcc > {_MFCC_MAX}")
    shape = (bsz, n_mfcc, nf) if transposed else (bsz, nf, n_mfcc)
    out = torch.empty(shape, dtype=torch.float32, device=mel.device)
    rc = _lib().mfcc_tail_f32(
        mel.data_ptr(), peak.data_ptr(), dct.data_ptr(), out.data_ptr(),
        bsz, nf, n_mels, n_mfcc, int(transposed),
        stream_of(mel),
    )
    raise_on(rc, "mfcc_tail_f32")
    LAUNCHES["mfcc_tail_f32"] += 1
    return out


# ---------------------------------------------------------------------------
# Both kernels
# ---------------------------------------------------------------------------


def fused_mfcc(
    audio: torch.Tensor,
    *,
    sr: float,
    n_fft: int = 512,
    hop: int = 80,
    win_length: int | None = None,
    n_mfcc: int = 13,
    n_mels: int = 128,
    fmin: float = 100.0,
    fmax: float | None = None,
    frame_mask: torch.Tensor | None = None,
    transposed: bool = False,
    weights: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """MFCC [B, nf, n_mfcc] of float32 audio [B, T] (or [T]) via the fused
    kernels, or coef-major [B, n_mfcc, nf] with ``transposed=True``.

    librosa semantics (power=2, power_to_db top_db=80, DCT-II ortho), the
    contract of ops/spectral.mfcc_from_frames. The top_db peak comes from
    the kernel's block maxes, or, with ``frame_mask`` [B, nf] (1 = valid),
    from one masked reduction over mel. ``weights`` = (wri, melw, dct) on
    the audio's device; designed from the other arguments when None.
    """
    single = audio.ndim == 1
    if single:
        audio = audio[None, :]
    if weights is None:
        wri, melw = _weights_on(audio, sr, n_fft, win_length, n_mels, fmin, fmax)
        dct = torch.as_tensor(tail_dct(n_mfcc, n_mels), dtype=torch.float32, device=audio.device)
    else:
        wri, melw, dct = weights
    mel, bmax = fused_mel_frontend(
        audio, sr=sr, n_fft=n_fft, hop=hop, win_length=win_length,
        weights=(wri, melw),
    )
    if frame_mask is not None:
        valid = frame_mask[..., : mel.shape[1], None] > 0
        pmax = torch.amax(torch.where(valid, mel, torch.zeros_like(mel)), dim=(1, 2))
    else:
        pmax = torch.amax(bmax, dim=1)
    peak = 10.0 * torch.log10(torch.clamp(pmax, min=1e-10))
    out = mfcc_tail(mel, peak, dct.shape[1], transposed=transposed, dct=dct)
    return out[0] if single else out
