"""Formant tracking, the reference's calc_formants surface
(script/calc.py:131-170).

Burg LPC formants with Praat's conventions (resample to 2× the ceiling,
50 Hz pre-emphasis, a Gaussian window twice the nominal length, order
2·max_number_of_formants), F1–F3 at the frame times, and frames whose
intensity is below ``energy_threshold`` dB dropped (sound.to_intensity()
with Praat's defaults: minPitch 100, time step 0.8/minPitch). Resampling
and the ragged selection run on the host; LPC, roots and intensity on the
tensors' device. :class:`FormantTracker` holds the designed constants as
buffers.
"""
from __future__ import annotations

import numpy as np
import torch

from modulation_mfcc_tpu_torch.io.wav import design_hq_taps, resample, resample_ratio
from modulation_mfcc_tpu_torch.models.config import FormantConfig
from modulation_mfcc_tpu_torch.ops.intensity import intensity_db, intensity_times, intensity_window
from modulation_mfcc_tpu_torch.ops.lpc import formant_frames, formant_window, formant_window_length, lpc_formants
from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

__all__ = ["FormantTracker", "extract_formants", "formants_with_gating"]

_NOMINAL_N = 2**31 - 1
_GATE_MIN_PITCH = 100.0  # Praat's to_intensity defaults (calc.py:156)
_GATE_TIME_STEP = 0.0


class FormantTracker(torch.nn.Module):
    """Formant tracking of ``cfg`` for audio at ``sr`` (default: already at
    the LPC rate 2·max_formant), with its designed constants as buffers:

    * ``window`` [nw]: Praat's formant Gaussian at the LPC rate;
    * ``kaiser`` [2·hws+1]: the intensity gate's Kaiser-20 taper at ``sr``,
      normalized to unit sum;
    * ``taps`` [L] float64: the kaiser_best polyphase filter from ``sr`` to
      the LPC rate (empty when no resampling is needed).
    """

    def __init__(self, cfg: FormantConfig = FormantConfig(), sr: float | None = None):
        super().__init__()
        self.cfg = cfg
        self.lpc_sr = 2.0 * cfg.max_formant
        self.sr = self.lpc_sr if sr is None else float(sr)
        nw = formant_window_length(_NOMINAL_N, self.lpc_sr, cfg.window_length)
        self.register_buffer("window", torch.tensor(formant_window(nw)))
        self.register_buffer("kaiser", torch.tensor(
            intensity_window(_NOMINAL_N, self.sr, _GATE_MIN_PITCH, _GATE_TIME_STEP)))
        taps = np.zeros(0) if self.sr == self.lpc_sr else design_hq_taps(*resample_ratio(self.sr, self.lpc_sr))
        self.register_buffer("taps", torch.tensor(taps, dtype=torch.float64))

    def lpc(self, x: torch.Tensor, *, sr: float | None = None, burg_engine: str = "auto"):
        """(freqs, bandwidths) [..., NF, max_num_formants] of float32 x
        [..., n] at the LPC rate (ops/lpc.lpc_formants)."""
        cfg = self.cfg
        return lpc_formants(
            x, sr=self.lpc_sr if sr is None else float(sr), order=2 * cfg.max_num_formants,
            window_length=cfg.window_length, time_step=cfg.time_step,
            pre_emphasis_from=cfg.pre_emphasis_from, max_formant=cfg.max_formant,
            burg_engine=burg_engine, window=self.window,
        )

    def intensity(self, x: torch.Tensor) -> torch.Tensor:
        """The gate's intensity contour [..., NF] in dB of float32 x at ``sr``."""
        return intensity_db(x, sr=self.sr, min_pitch=_GATE_MIN_PITCH, time_step=_GATE_TIME_STEP,
                            window=self.kaiser)

    def resample(self, x: np.ndarray) -> np.ndarray:
        """x (float64, host) resampled from ``sr`` to the LPC rate."""
        taps = self.taps.cpu().numpy() if self.taps.numel() else None
        return resample(x, self.sr, self.lpc_sr, taps=taps)


def formants_with_gating(x, sr: float, cfg: FormantConfig = FormantConfig(), device=None, *,
                         burg_engine: str = "auto"):
    """(times [NF] ndarray, [f1, f2, f3] tensors [NF], keep [NF] bool ndarray)
    of one utterance [n] at ``sr``. Every frame is computed on ``device``
    (default: ``x``'s own if it is a tensor, else CUDA; ``device="cpu"`` for
    the CPU); ``keep`` is the host-side intensity gate."""
    device = resolve_device(device, x)
    x64 = np.asarray(x.cpu() if torch.is_tensor(x) else x, dtype=np.float64)
    tracker = FormantTracker(cfg, sr).to(device)
    xr = tracker.resample(x64)
    freqs, _bw = tracker.lpc(torch.as_tensor(xr, dtype=torch.float32, device=device), burg_engine=burg_engine)
    _, _, times = formant_frames(len(xr), tracker.lpc_sr, cfg.window_length, cfg.time_step)
    db = tracker.intensity(torch.as_tensor(x64, dtype=torch.float32, device=device)).cpu().numpy()
    tdb = intensity_times(len(x64), float(sr), _GATE_MIN_PITCH, _GATE_TIME_STEP)
    keep = np.interp(times, tdb, db) > cfg.energy_threshold
    return times, [freqs[:, 0], freqs[:, 1], freqs[:, 2]], keep


def extract_formants(x, sr: float, cfg: FormantConfig = FormantConfig(), device=None, *,
                     burg_engine: str = "auto"):
    """(times, [f1, f2, f3]) of the frames that pass the intensity gate, the
    reference calc_formants output (script/calc.py:164-170)."""
    t, f123, keep = formants_with_gating(x, sr, cfg, device, burg_engine=burg_engine)
    k = torch.as_tensor(keep, device=f123[0].device)
    return t[keep], [f[k] for f in f123]
