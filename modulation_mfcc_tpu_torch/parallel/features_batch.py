"""Batched F0 and formant tracking over padded batches, on the batch
tensor's device.

  * F0: frames are local, but the path finder (praat) and the Viterbi
    decode (pyin) run over the padded frame range; padded frames are
    strongly unvoiced, so the valid region matches the single-file decode
    except occasionally at the final voiced/padding boundary
    (tolerance-grade, like the tracker). The praat global mean and peak are
    per utterance (``valid_len``); pyin's centred constant padding equals
    the batch's zero padding, so its frames are exact on the valid range.
  * Formants: per-frame LPC is local, so valid frames are exact.
  * Envelopes: 'RMS' frames are local, so valid frames are exact; 'Hilb' is
    one FFT over the padded width (edge ripple near the padding).
"""
from __future__ import annotations

import numpy as np
import torch

from modulation_mfcc_tpu_torch.models.config import AmplitudeConfig, F0Config, FormantConfig
from modulation_mfcc_tpu_torch.models.envelope import rms_envelope
from modulation_mfcc_tpu_torch.models.formants import FormantTracker
from modulation_mfcc_tpu_torch.models.pitch import PitchTracker, PyinTracker
from modulation_mfcc_tpu_torch.ops.hilbert import hilbert_envelope
from modulation_mfcc_tpu_torch.parallel.batch import AudioBatch

__all__ = ["batched_f0", "batched_envelope", "batched_formants"]


def batched_f0(batch: AudioBatch, sr: float, cfg: F0Config = F0Config(), *, sinc_engine: str = "auto",
               viterbi_engine: str = "auto"):
    """(f0 [B, NF], valid [B, NF]): raw tracks, 0 = unvoiced, for praatac,
    praatcc and pyin. ``valid`` marks, for praat, the frames whose analysis
    span lies inside the utterance and, for pyin, the centred frames of the
    utterance (1 + length // hop). Post-processing (NaN interpolation,
    filtering) is per file, as in extract_f0. With pyinpad_mode other than
    'constant' the tail frames see the batch's zeros instead of the
    extension: use extract_f0 for those."""
    hop_s = max(1, int(round(cfg.hopSize * sr)))
    if cfg.method == "pyin":
        f0 = PyinTracker(cfg, sr).to(batch.samples.device)(batch.samples, viterbi_engine=viterbi_engine)
        nf = f0.shape[-1]
        valid = torch.arange(nf, device=f0.device)[None, :] < torch.clamp(1 + batch.lengths // hop_s, max=nf)[:, None]
        return torch.where(valid, f0, 0.0), valid
    tracker = PitchTracker(cfg, sr).to(batch.samples.device)
    f0 = tracker(batch.samples, valid_len=batch.lengths, sinc_engine=sinc_engine)
    nf = f0.shape[-1]
    periods = (6.0 if cfg.veryAccurate else 3.0) if cfg.method == "praatac" else 1.0
    nw = int(round(periods / cfg.minPitch * sr))
    span = nw if cfg.method == "praatac" else nw + int(np.ceil(sr / cfg.minPitch))
    nf_real = torch.clamp(1 + (batch.lengths - span) // hop_s, min=0)
    valid = torch.arange(nf, device=f0.device)[None, :] < nf_real[:, None]
    return torch.where(valid, f0, 0.0), valid


def batched_envelope(batch: AudioBatch, sr: float, cfg: AmplitudeConfig = AmplitudeConfig()):
    """(amp [B, NF], valid [B, NF]) on the batch's device, zero past each
    utterance's frames.

    * 'RMS': exact per-file parity (frames are local); valid = the first
      1 + length // hop frames.
    * 'Hilb': the analytic signal over the zero-padded batch width. The FFT
      is global, so values differ from the per-file transform by edge
      ripple that decays away from the valid/pad boundary; dense per sample.
    * 'RMSpraat' picks its own output rate per file (pitch-adaptive): use
      the per-file :func:`extract_envelope`.
    """
    x, lengths = batch.samples, batch.lengths
    if cfg.method == "RMS":
        fr_len = int(cfg.hopLen * sr)
        amp = rms_envelope(x, int(cfg.winLen * sr), fr_len, center=cfg.center)
        nf_real = 1 + lengths // fr_len
    elif cfg.method == "Hilb":
        amp, nf_real = hilbert_envelope(x), lengths
    else:
        raise ValueError("batched_envelope supports method='RMS' or 'Hilb' "
                         "(RMSpraat is per-file adaptive; use extract_envelope)")
    valid = torch.arange(amp.shape[-1], device=amp.device)[None, :] < nf_real[:, None]
    return torch.where(valid, amp, 0.0), valid


def batched_formants(batch_resampled: torch.Tensor, sr: float, cfg: FormantConfig = FormantConfig(), *,
                     burg_engine: str = "auto"):
    """(freqs, bandwidths) [B, NF, max_num_formants] of a batch [B, T]
    already resampled to 2·max_formant (on the host, io/wav.resample)."""
    tracker = FormantTracker(cfg).to(batch_resampled.device)
    return tracker.lpc(batch_resampled, sr=float(sr), burg_engine=burg_engine)
