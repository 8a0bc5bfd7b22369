"""Amplitude envelope extraction (RMS / Hilbert / pitch-adaptive intensity).

The reference's get_amplitude / calculate_amplitude_envelope
(script/mfcc.py:137-259, duplicated at script/calc.py:221-343); the JAX
package's models/envelope.py:

  * 'RMS'      — librosa.feature.rms semantics: centered framing with
                 constant padding, sqrt(mean(x²)) per frame, from hop-row
                 sums (ops/framing.hop_window_sums).
  * 'Hilb'     — |analytic signal| via torch.fft (ops/hilbert.py).
  * 'RMSpraat' — Praat-style pitch-adaptive intensity
                 (models/pitch_adaptive.py, ops/intensity.py).

Reference quirk kept: the ``method != 'hilb'`` comparison at
script/mfcc.py:249 is case-sensitive, so even for method='Hilb' the time
axis is ``arange(len(amp)) * hopLen`` (``envelope_times``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

from modulation_mfcc_tpu_torch.models.config import AmplitudeConfig
from modulation_mfcc_tpu_torch.models.pitch_adaptive import praat_style_intensity
from modulation_mfcc_tpu_torch.ops.filters import apply_filter
from modulation_mfcc_tpu_torch.ops.framing import frame_signal, hop_window_sums
from modulation_mfcc_tpu_torch.ops.hilbert import hilbert_envelope
from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

__all__ = ["rms_envelope", "amplitude_envelope", "extract_envelope", "envelope_times"]


def rms_envelope(y: torch.Tensor, frame_length: int, hop_length: int, *, center: bool = True) -> torch.Tensor:
    """librosa.feature.rms along the last axis → [..., n_frames].

    Every frame start is a multiple of ``hop_length`` (in padded
    coordinates), so a frame's energy is ``W//hop`` whole hop-row sums of x²
    plus one ``W%hop`` row prefix: the signal is read once, with no frame
    matrix. Where that would add more than 64 shifted row sums, the frames
    are gathered instead.
    """
    w, h = int(frame_length), int(hop_length)
    n = y.shape[-1]
    if w // h > 64:
        frames = frame_signal(y, w, h, center=center)
        return torch.sqrt(torch.mean(frames * frames, dim=-1))
    pad = w // 2 if center else 0
    nf = 1 + (n + 2 * pad - w) // h
    if nf <= 0:
        raise ValueError(f"Signal of length {n} too short for frame_length={w}")
    # x² in padded coordinates; hop_window_sums zero-extends past the signal
    # end (never read by a valid frame: frame nf-1 ends inside the padding)
    sq = tnf.pad(y, (pad, 0)) ** 2
    return torch.sqrt(hop_window_sums(sq, nf, w, h) / w)


def amplitude_envelope(y: torch.Tensor, sr: float, cfg: AmplitudeConfig = AmplitudeConfig()) -> torch.Tensor:
    """Amplitude track per the reference's method switch (script/mfcc.py:200-247)."""
    if cfg.method == "Hilb":
        amp, amp_sr = hilbert_envelope(y), sr
    elif cfg.method == "RMS":
        amp = rms_envelope(y, int(cfg.winLen * sr), int(cfg.hopLen * sr), center=cfg.center)
        amp_sr = 1.0 / cfg.hopLen
    elif cfg.method == "RMSpraat":
        amp, amp_sr = praat_style_intensity(y, sr, hop=cfg.hopLen)
    else:
        raise ValueError(f"Unknown amplitude method {cfg.method!r}")
    if cfg.outFilter is not None:
        amp = apply_filter(amp, amp_sr, filt=cfg.outFilter, cut_off=cfg.outFiltCutOff, filt_len=cfg.outFiltLen,
                           filt_type=cfg.outFiltType, poly_ord=cfg.outFiltPolyOrd)
    return amp


def envelope_times(n_samples: int, sr: float, cfg: AmplitudeConfig) -> np.ndarray:
    """Host-side time axis with the reference's case quirk
    (script/mfcc.py:249: 'Hilb' != 'hilb'): the reference computes
    arange(len(x))/sr for Hilbert (mfcc.py:204), then overwrites it with
    arange(len(amp))·hopLen (mfcc.py:251), and len(amp) == n_samples, so the
    axis is arange(n)·hopLen."""
    if cfg.method == "Hilb":
        return np.arange(n_samples) * cfg.hopLen
    if cfg.method == "RMS":
        fr_len = int(cfg.hopLen * sr)
        win_len = int(cfg.winLen * sr)
        nf = (1 + (n_samples + 2 * (win_len // 2) - win_len) // fr_len if cfg.center
              else 1 + (n_samples - win_len) // fr_len)
        return np.arange(nf) * cfg.hopLen
    raise ValueError("RMSpraat times come from praat_style_intensity directly")


def extract_envelope(y, sr: float, cfg: AmplitudeConfig = AmplitudeConfig(), device=None):
    """(amplitude tensor, times ndarray) of one utterance, the reference's
    AmplitudeEnvelope source (script/main.py:840-851). Computes on
    ``device`` (default: ``y``'s own if it is a tensor, else CUDA;
    ``device="cpu"`` for the CPU)."""
    y = torch.as_tensor(y, dtype=torch.float32, device=resolve_device(device, y))
    if cfg.method == "RMSpraat":
        amp, amp_sr = praat_style_intensity(y, sr, hop=cfg.hopLen)
        return amp, np.arange(amp.shape[-1]) / amp_sr
    return amplitude_envelope(y, float(sr), cfg), envelope_times(y.shape[-1], sr, cfg)
