"""Typed configuration of the modulation-cepstrum pipeline and the trackers.

Same field names and defaults as the reference's JSON schema (``tStep``,
``winLen``, ``outFiltCutOff``, ...). Frozen, so a config can key the host
design caches.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["MfccConfig", "FormantConfig", "F0Config", "AmplitudeConfig"]


@dataclass(frozen=True)
class MfccConfig:
    """Parameters of get_MFCCS_change (reference script/mfcc.py:291-310 defaults,
    overridden by the GUI to the values of script/main.py:732-748)."""

    signal_sample_rate: int = 10_000
    channelN: int = 0  # multichannel selection (script/mfcc.py:295, :377-380)
    tStep: float = 0.005
    winLen: float = 0.025
    n_mfcc: int = 13
    n_fft: int = 512
    minFreq: float = 100.0
    maxFreq: float = 10_000.0
    removeFirst: int = 1
    filtCutoff: float = 12.0
    filtOrd: int = 6
    diffMethod: str = "grad"
    outFilter: str | None = "iir"
    outFiltType: str = "low"
    outFiltCutOff: tuple = (12.0,)
    outFiltLen: int = 6
    outFiltPolyOrd: int = 3
    n_mels: int = 128

    @property
    def win_length(self) -> int:
        return int(self.winLen * self.signal_sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.tStep * self.signal_sample_rate)


@dataclass(frozen=True)
class FormantConfig:
    """Parameters of calc_formants (reference script/calc.py:131-141)."""

    energy_threshold: float = 20.0
    time_step: float = 0.005
    max_num_formants: int = 5
    max_formant: float = 5500.0
    window_length: float = 0.025
    pre_emphasis_from: float = 50.0


@dataclass(frozen=True)
class F0Config:
    """Parameters of get_f0 (reference script/calc.py:386-420)."""

    method: str = "praatac"  # praatac | praatcc | pyin
    hopSize: float = 0.01
    minPitch: float = 75.0
    maxPitch: float = 600.0
    interpUnvoiced: str | None = "linear"
    outFilter: str | None = "iir"
    outFiltType: str = "low"
    outFiltCutOff: tuple = (12.0,)
    outFiltLen: int = 6
    outFiltPolyOrd: int = 3
    # Praat-specific cost parameters (script/calc.py:400-406)
    minMaxQuant: tuple | None = None
    maxCandNum: int = 15
    veryAccurate: bool = False
    silenceThresh: float = 0.03
    voicingThresh: float = 0.45
    octaveCost: float = 0.01
    octaveJumpCost: float = 0.35
    voicedUnvoicedCost: float = 0.14
    # pyin-specific (script/calc.py:408-419)
    pyinframe_length: int = 2048
    pyinwin_length: int | None = None
    n_thresholds: int = 100
    beta_parameters: tuple = (2, 18)
    boltzmann_parameter: int = 2
    resolution: float = 0.1
    max_transition_rate: float = 35.92
    switch_prob: float = 0.01
    no_trough_prob: float = 0.01
    # fill value for unvoiced frames (None = NaN), centered framing flag and
    # pad mode for the centered frames (script/calc.py:417-419)
    pyinfill_na: float | None = None
    pyincenter: bool = True
    pyinpad_mode: str = "constant"


@dataclass(frozen=True)
class AmplitudeConfig:
    """Parameters of get_amplitude / calculate_amplitude_envelope
    (reference script/mfcc.py:137-150)."""

    method: str = "RMS"  # RMS | RMSpraat | Hilb
    winLen: float = 0.1
    hopLen: float = 0.01
    center: bool = True
    outFilter: str | None = None
    outFiltType: str = "low"
    outFiltCutOff: tuple = (12.0,)
    outFiltLen: int = 6
    outFiltPolyOrd: int = 3
