"""Sound and spectrogram adapters (the reference's parselmouth layer).

Replaces script/praat_py_ui/parselmouth_calc.py:6-39: WAV → ``Sound``
(timestamps + amplitudes) and a Praat-style wideband spectrogram in dB
(``10*log10`` of the power matrix, Gaussian analysis window). Praat's
``to_spectrogram`` defaults: 5 ms effective window (physical window twice
that, Gaussian taper), 5 kHz view ceiling, 2 ms time step.

The power spectrum is one framed ``torch.fft.rfft`` on the device, not a
per-column loop; the dB conversion and the optional display zoom run on the
host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from modulation_mfcc_tpu_torch.io.wav import read_wav
from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from modulation_mfcc_tpu_torch.ops.windows import gaussian
from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

__all__ = ["Sound", "Spectrogram", "load_sound", "praat_spectrogram"]


@dataclass
class Sound:
    timestamps: np.ndarray
    amplitudes: np.ndarray  # [channels, n]
    sample_rate: float


@dataclass
class Spectrogram:
    timestamps: np.ndarray
    frequencies: np.ndarray
    data_matrix: np.ndarray  # dB, [n_freqs, n_times]


def load_sound(path: str) -> Sound:
    """WAV → Sound (reference Parselmouth.get_sound semantics)."""
    x, sr = read_wav(path)
    if x.ndim == 1:
        x = x[None, :]
    n = x.shape[-1]
    return Sound(np.arange(n) / sr, x, float(sr))


def _spec_power(x: torch.Tensor, nw: int, hop: int, n_fft: int) -> torch.Tensor:
    """Power spectra [n_frames, n_fft//2 + 1] of the mean-removed,
    Gaussian-windowed frames of x [n]."""
    nf = 1 + (x.shape[-1] - nw) // hop
    frames = frame_by_slices(x, 0, nf, nw, hop)
    frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    w = torch.as_tensor(gaussian(nw, nw / 6.0), dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(frames * w, n=n_fft, dim=-1)
    return spec.real**2 + spec.imag**2


def praat_spectrogram(
    x: np.ndarray,
    sr: float,
    *,
    window_length: float = 0.005,
    max_frequency: float = 5000.0,
    time_step: float = 0.002,
    zoom_blur: bool = False,
    device=None,
) -> Spectrogram:
    """Wideband dB spectrogram with Praat-flavoured defaults
    (reference parselmouth_calc.py:31-39: to_spectrogram + 10*log10), its
    power spectrum computed in float32 on ``device`` (default CUDA;
    ``device="cpu"`` for the CPU).

    ``zoom_blur`` reproduces the reference display's optional smoothing
    (praat_py_ui/spectrogram.py:70-71): the dB matrix is upsampled 6× with
    an order-4 spline (scipy.ndimage.zoom) before display; the time and
    frequency axes are re-gridded to match (the reference scales its image
    rect, which is the same mapping)."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim > 1:
        x = x[0]
    nw = max(8, int(round(2 * window_length * sr)))
    hop = max(1, int(round(time_step * sr)))
    n_fft = 1
    while n_fft < nw:
        n_fft *= 2
    p = _spec_power(torch.as_tensor(x, device=resolve_device(device)), nw, hop, n_fft).cpu().numpy()
    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    keep = freqs <= max_frequency
    db = 10.0 * np.log10(np.maximum(p[:, keep], 1e-12))
    times = (np.arange(p.shape[0]) * hop + nw / 2) / sr
    fkept = freqs[keep]
    if zoom_blur:
        from scipy.ndimage import zoom as nd_zoom

        mat = nd_zoom(db.T, 6, order=4)  # [freq*6, time*6]
        fkept = np.linspace(fkept[0], fkept[-1], mat.shape[0])
        times = np.linspace(times[0], times[-1], mat.shape[1])
        return Spectrogram(times, fkept, mat)
    return Spectrogram(times, fkept, db.T)
