"""Batched F0 and formant tracking over padded batches, on the batch
tensor's device.

  * F0: frames are local, but the path finder decodes over the padded frame
    range; padded frames are strongly unvoiced, so the valid region matches
    the single-file decode except occasionally at the final voiced/padding
    boundary (tolerance-grade, like the tracker). The global mean and peak
    are per utterance (``valid_len``).
  * Formants: per-frame LPC is local, so valid frames are exact.
"""
from __future__ import annotations

import numpy as np
import torch

from modulation_mfcc_tpu_torch.models.config import F0Config, FormantConfig
from modulation_mfcc_tpu_torch.models.formants import FormantTracker
from modulation_mfcc_tpu_torch.models.pitch import PitchTracker
from modulation_mfcc_tpu_torch.parallel.batch import AudioBatch

__all__ = ["batched_f0", "batched_formants"]


def batched_f0(batch: AudioBatch, sr: float, cfg: F0Config = F0Config(), *, sinc_engine: str = "auto"):
    """(f0 [B, NF], valid [B, NF]): raw tracks, 0 = unvoiced, for praatac and
    praatcc; ``valid`` marks frames whose analysis span lies inside the
    utterance. Post-processing (NaN interpolation, filtering) is per file,
    as in extract_f0."""
    tracker = PitchTracker(cfg, sr).to(batch.samples.device)
    f0 = tracker(batch.samples, valid_len=batch.lengths, sinc_engine=sinc_engine)
    nf = f0.shape[-1]
    hop_s = max(1, int(round(cfg.hopSize * sr)))
    periods = (6.0 if cfg.veryAccurate else 3.0) if cfg.method == "praatac" else 1.0
    nw = int(round(periods / cfg.minPitch * sr))
    span = nw if cfg.method == "praatac" else nw + int(np.ceil(sr / cfg.minPitch))
    nf_real = torch.clamp(1 + (batch.lengths - span) // hop_s, min=0)
    valid = torch.arange(nf, device=f0.device)[None, :] < nf_real[:, None]
    return torch.where(valid, f0, 0.0), valid


def batched_formants(batch_resampled: torch.Tensor, sr: float, cfg: FormantConfig = FormantConfig(), *,
                     burg_engine: str = "auto"):
    """(freqs, bandwidths) [B, NF, max_num_formants] of a batch [B, T]
    already resampled to 2·max_formant (on the host, io/wav.resample)."""
    tracker = FormantTracker(cfg).to(batch_resampled.device)
    return tracker.lpc(batch_resampled, sr=float(sr), burg_engine=burg_engine)
