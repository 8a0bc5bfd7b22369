"""Spectral transforms: STFT power, mel filterbank, log compression, DCT → MFCC.

The reference calls ``librosa.feature.mfcc`` once (script/mfcc.py:387). Here
that is static-shape tensor code:

    frames [N, n_fft] --(rFFT, or matmul vs. windowed DFT bases)--> re, im
    power = re^2 + im^2
    mel   = power @ M^T          (mel filterbank, Slaney-normalized)
    db    = power_to_db(mel)     (librosa ref=1.0, amin=1e-10, top_db=80)
    mfcc  = db @ D^T             (DCT-II, ortho)

All matrices are designed on the host in float64 numpy (cached) and cast to
the frames' dtype and device where they are used. float32 matmuls on CUDA
must run in full float32: callers keep ``torch.backends.cuda.matmul.allow_tf32``
False (PyTorch's default).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from modulation_mfcc_tpu_torch.ops.windows import get_window
from modulation_mfcc_tpu_torch.utils.helpers import pad_center

# ---------------------------------------------------------------------------
# Host-side designs (float64 numpy, cached)
# ---------------------------------------------------------------------------


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    """Center frequencies of rFFT bins (librosa.fft_frequencies)."""
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, endpoint=True)


def hz_to_mel(f, htk: bool = False):
    """Hz→mel. Slaney (librosa default) unless htk=True."""
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(mels, htk: bool = False):
    """mel→Hz inverse of :func:`hz_to_mel`."""
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@lru_cache(maxsize=64)
def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape [n_mels, 1+n_fft//2].

    Matches ``librosa.filters.mel``. The reference passes fmax above Nyquist;
    like librosa, filters whose support exceeds Nyquist have empty rows.
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney normalization: scale each filter to ~constant energy per channel
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights = weights * enorm[:, None]
    return weights


@lru_cache(maxsize=16)
def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """DCT-II with 'ortho' norm as a matrix [n_out, n_in]:
    ``dct_matrix(k, n) @ x == scipy.fft.dct(x, type=2, norm='ortho')[:k]``."""
    n = np.arange(n_in)
    k = np.arange(n_out)[:, None]
    mat = 2.0 * np.cos(np.pi * k * (2 * n[None, :] + 1) / (2 * n_in))
    scale = np.full((n_out, 1), np.sqrt(1.0 / (2 * n_in)))
    scale[0, 0] = np.sqrt(1.0 / (4 * n_in))
    return mat * scale


@lru_cache(maxsize=64)
def dft_bases(n_fft: int, window: str = "hann", win_length: int | None = None):
    """Windowed real-DFT bases (wr, wi), each [n_fft, 1+n_fft//2] float32, such
    that for a raw frame row-vector f: ``f @ wr`` and ``f @ wi`` are the real
    and imaginary rFFT of (f * padded_window)."""
    if win_length is None:
        win_length = n_fft
    w = pad_center(get_window(window, win_length, periodic=True), n_fft)
    n = np.arange(n_fft)[:, None]
    k = np.arange(1 + n_fft // 2)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    wr = np.cos(ang) * w[:, None]
    wi = np.sin(ang) * w[:, None]
    return wr.astype(np.float32), wi.astype(np.float32)


@lru_cache(maxsize=64)
def analysis_window(n_fft: int, window: str = "hann", win_length: int | None = None) -> np.ndarray:
    """Zero-padded (centered) analysis window of length n_fft, float64."""
    if win_length is None:
        win_length = n_fft
    return pad_center(get_window(window, win_length, periodic=True), n_fft)


# ---------------------------------------------------------------------------
# Device-side ops (torch)
# ---------------------------------------------------------------------------


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def power_spectrum_fft(frames: torch.Tensor, n_fft: int, window_vec: np.ndarray) -> torch.Tensor:
    """|rFFT(frames * window)|^2 via torch.fft (the reference spectrum)."""
    spec = torch.fft.rfft(frames * _const(window_vec, frames), n=n_fft, dim=-1)
    return spec.real**2 + spec.imag**2


def power_spectrum_matmul(frames: torch.Tensor, wr, wi) -> torch.Tensor:
    """|DFT|^2 as two matmuls against windowed DFT bases."""
    re = frames @ _const(wr, frames)
    im = frames @ _const(wi, frames)
    return re * re + im * im


def power_to_db(
    s: torch.Tensor,
    *,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """librosa.power_to_db with ref=1.0: 10*log10(max(s, amin)), clipped to
    ``max - top_db``.

    The max is per utterance: the trailing (frames, mel) axes are reduced and
    leading batch axes kept. For padded batches pass ``mask`` (broadcastable,
    1=valid) so padding does not raise the clip floor.
    """
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    if top_db is None:
        return log_spec
    axes = (s.ndim - 2, s.ndim - 1)
    if mask is not None:
        neg = torch.finfo(log_spec.dtype).min
        log_masked = torch.where(mask > 0, log_spec, torch.full_like(log_spec, neg))
        peak = torch.amax(log_masked, dim=axes, keepdim=True)
    else:
        peak = torch.amax(log_spec, dim=axes, keepdim=True)
    return torch.maximum(log_spec, peak - top_db)


def melspectrogram(
    frames: torch.Tensor,
    *,
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    window: str = "hann",
    win_length: int | None = None,
    use_fft: bool = True,
) -> torch.Tensor:
    """Mel power spectrogram of pre-cut frames [..., N, n_fft] → [..., N, n_mels]."""
    if use_fft:
        p = power_spectrum_fft(frames, n_fft, analysis_window(n_fft, window, win_length))
    else:
        p = power_spectrum_matmul(frames, *dft_bases(n_fft, window, win_length))
    return p @ _const(mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T, frames)


def mfcc_from_frames(
    frames: torch.Tensor,
    *,
    sr: float,
    n_fft: int,
    n_mfcc: int = 13,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    window: str = "hann",
    win_length: int | None = None,
    use_fft: bool = True,
    top_db: float | None = 80.0,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """MFCCs [..., N, n_mfcc] from frames, frame-major (time on rows).

    librosa.feature.mfcc composition: melspectrogram(power=2) →
    power_to_db(top_db=80) → DCT-II-ortho over the mel axis → first n_mfcc
    coefficients, transposed to [time, coef].
    """
    mel = melspectrogram(
        frames,
        sr=sr,
        n_fft=n_fft,
        n_mels=n_mels,
        fmin=fmin,
        fmax=fmax,
        window=window,
        win_length=win_length,
        use_fft=use_fft,
    )
    db = power_to_db(mel, top_db=top_db, mask=mask)
    return db @ _const(dct_matrix(n_mfcc, n_mels).T, frames)
