"""Typed configuration of the modulation-cepstrum pipeline.

Same field names and defaults as the reference's JSON schema (``tStep``,
``winLen``, ``outFiltCutOff``, ...). Frozen, so a config can key the host
design caches.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["MfccConfig"]


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
