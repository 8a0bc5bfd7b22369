"""Pitch-adaptive ('RMSpraat') intensity envelope.

Reference flow (script/mfcc.py:208-240): estimate pitch with a wide range
(50-700 Hz), take the 25/75 % quantiles of voiced frames, re-estimate with
[0.75·q25, 2.5·q75], then compute Praat intensity with a window sized by the
minimum of the raw second-pass track (unvoiced frames count as 0 Hz), or,
if that minimum is ≤ 120 Hz (whenever any frame is unvoiced), with
minPitch = 120 at sample-rate time resolution. The JAX package's
models/pitch_adaptive.py, on this package's ``pitch_ac`` and
``intensity_db``.
"""
from __future__ import annotations

import numpy as np
import torch

from modulation_mfcc_tpu_torch.ops.intensity import intensity_db
from modulation_mfcc_tpu_torch.ops.pitch import pitch_ac
from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

__all__ = ["praat_style_intensity"]


def praat_style_intensity(x, sr: float, *, hop: float = 0.01, device=None) -> tuple[torch.Tensor, float]:
    """(intensity_db [NF], rate_hz) of one utterance following the
    reference's two-pass logic. Computes on ``device`` (default: ``x``'s
    own if it is a tensor, else CUDA; ``device="cpu"`` for the CPU); the
    quantiles and the minimum are taken on the host."""
    x = torch.as_tensor(x, dtype=torch.float32, device=resolve_device(device, x))
    f0 = pitch_ac(x, sr=float(sr), hop=hop, min_pitch=50.0, max_pitch=700.0).cpu().numpy()
    voiced = f0[f0 > 20]
    if voiced.size:
        q = np.quantile(voiced, [0.25, 0.75])
        lo, hi = 0.75 * float(q[0]), 2.5 * float(q[1])
        if hi > lo > 0:
            f0 = pitch_ac(x, sr=float(sr), hop=hop, min_pitch=lo, max_pitch=hi).cpu().numpy()
    # the minimum over the RAW second-pass track (script/mfcc.py:227):
    # unvoiced frames are 0 Hz, so any unvoiced frame takes the dense branch
    min_obs = float(f0.min()) if f0.size else 0.0
    if min_obs > 120.0:
        return intensity_db(x, sr=float(sr), min_pitch=min_obs, time_step=hop), 1.0 / hop
    return intensity_db(x, sr=float(sr), min_pitch=120.0, time_step=1.0 / float(sr)), float(sr)
