"""Long-form extraction: the MFCC stage of an hour-scale recording in chunks.

The reference loads whole recordings and filters them in one bidirectional
pass (script/mfcc.py:373, sosfiltfilt). A whole-file MFCC stage at 1 h
holds every frame's spectrum at once; here the *sample* axis, where the
memory and the operations are, is cut into chunks of frames, while the
trajectory-rate (1/tStep Hz) stages run once over the whole [n_mfcc, NF]
trajectory, about a thousand times smaller than the audio:

  * :func:`chunked_mfcc_trajectories` frames one chunk of the padded signal
    at a time (a strided view, no frame matrix of the whole file) and
    computes its mel power with the fft spectrum. MFCC frames depend only on
    their own window, so chunking changes no number; the per-utterance
    top_db clip needs the global mel peak, reduced over the chunks first.
  * :func:`chunked_mfcc_change` runs the model's trajectory tail
    (``MfccChange.trajectory_tail``) on the result, so chunked and
    whole-file results are equal to rounding.

The time-sharded form over several devices (a halo exchange and a global
peak) is not ported yet (ROADMAP A.16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tnf

from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import _model
from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from modulation_mfcc_tpu_torch.ops.spectral import dct_matrix, melspectrogram

__all__ = ["chunked_mfcc_trajectories", "chunked_mfcc_change"]


def _chunk_frame_windows(n_samples: int, cfg: MfccConfig, frames_per_chunk: int) -> tuple[int, int, int, int]:
    """(nf, n_chunks, samples a chunk's frames span, centered pad)."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    pad = n_fft // 2
    nf = 1 + (n_samples + 2 * pad - n_fft) // hop
    n_chunks = -(-nf // frames_per_chunk)
    window = (frames_per_chunk - 1) * hop + n_fft
    return nf, n_chunks, window, pad


def chunked_mfcc_trajectories(
    y: torch.Tensor, cfg: MfccConfig, *, frames_per_chunk: int = 4096,
    mel_stack_cap_bytes: int = 512 * 1024 * 1024,
) -> torch.Tensor:
    """MFCCs [NF, n_mfcc] of a long 1-D signal, ``frames_per_chunk`` frames
    at a time, on ``y``'s device and in its dtype.

    Two schedules with the same numbers, chosen by size: when the stacked
    mel of the whole file fits in ``mel_stack_cap_bytes`` (the 1-hour
    16 kHz recording: 369 MB), one pass keeps each chunk's mel and the
    running peak, then clips and projects every chunk; above the cap, a
    first pass finds the peak and a second recomputes each chunk's mel, so
    one chunk of mel is live at a time. Each chunk's dB, clip and DCT are
    the same operations in both.
    """
    n = y.shape[-1]
    nf, n_chunks, window, pad = _chunk_frame_windows(n, cfg, frames_per_chunk)
    hop = cfg.hop_length
    ypad = tnf.pad(y, (pad, max(0, (n_chunks - 1) * frames_per_chunk * hop + window - n - pad)))
    d = torch.as_tensor(dct_matrix(cfg.n_mfcc, cfg.n_mels).T, dtype=y.dtype, device=y.device)

    def mel_of_chunk(c: int) -> torch.Tensor:
        frames = frame_by_slices(ypad, c * frames_per_chunk * hop, frames_per_chunk, cfg.n_fft, hop)
        return melspectrogram(frames, sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, n_mels=cfg.n_mels,
                              fmin=cfg.minFreq, fmax=cfg.maxFreq, win_length=cfg.win_length)

    def chunk_peak(c: int, mel: torch.Tensor) -> torch.Tensor:
        valid = nf - c * frames_per_chunk  # frames of this chunk below nf
        return torch.amax(mel[:valid])

    def mfcc_of_chunk(mel: torch.Tensor, log_peak: torch.Tensor) -> torch.Tensor:
        db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
        return torch.maximum(db, log_peak - 80.0) @ d

    stacked = n_chunks * frames_per_chunk * cfg.n_mels * y.element_size() <= mel_stack_cap_bytes
    peak = torch.zeros((), dtype=y.dtype, device=y.device)
    mels = []
    for c in range(n_chunks):
        mel = mel_of_chunk(c)
        peak = torch.maximum(peak, chunk_peak(c, mel))
        if stacked:
            mels.append(mel)
    log_peak = 10.0 * torch.log10(torch.clamp(peak, min=1e-10))
    out = [mfcc_of_chunk(mels[c] if stacked else mel_of_chunk(c), log_peak) for c in range(n_chunks)]
    return torch.cat(out)[:nf]


def _trajectory_postprocess(m: torch.Tensor, cfg: MfccConfig) -> torch.Tensor:
    """The trajectory-rate tail of the modulation pipeline over frame-major
    MFCCs [..., NF, n_mfcc] (script/mfcc.py:393-425): the whole-file path's
    own ``MfccChange.trajectory_tail``."""
    return _model(cfg, m.device).trajectory_tail(m.transpose(-1, -2))


def chunked_mfcc_change(
    y: torch.Tensor, cfg: MfccConfig, *, frames_per_chunk: int = 4096,
    mel_stack_cap_bytes: int = 512 * 1024 * 1024,
) -> torch.Tensor:
    """Long-form modulation cepstrum [NF] of a 1-D signal: the chunked MFCC
    stage, then the exact trajectory tail (it never needs chunking)."""
    m = chunked_mfcc_trajectories(
        y, cfg, frames_per_chunk=frames_per_chunk, mel_stack_cap_bytes=mel_stack_cap_bytes,
    )
    return _trajectory_postprocess(m, cfg)
