"""The MFCC frontend's least work, whatever kernel computes it: centred
frames, the window, a real FFT, the power, the mel projection.

Operations a frame: the window, win_length multiplies; the real FFT of
n_fft points, 2.5 * n_fft * log2(n_fft) flops (half the 5 N log2 N of a
complex radix-2 FFT of N points, the usual count); the power, 3 flops for
each bin some mel filter weights; the mel projection, a multiply and an add
for each nonzero weight of the mel bank (each bin feeds at most two
triangles). Bytes: the audio the frames read, once, and the float32 mel
written once. Only the frames the inputs need count: each utterance's
1 + length // hop, not the padding's. At these sizes the bytes set the
bound.
"""
from __future__ import annotations

import math

import numpy as np

from benchlib.catalog import plugin


def mel_weights(cfg: dict) -> tuple[int, int]:
    """(bins some filter weights, nonzero weights) of the configuration's
    mel bank, from the plain reference's design."""
    mel = plugin("reference", "modcep").mel_bank(cfg["signal_sample_rate"], cfg["n_fft"], cfg["n_mels"],
                                                 cfg["minFreq"], cfg["maxFreq"])
    return int(np.count_nonzero(mel.any(axis=0))), int(np.count_nonzero(mel))


def frames(cfg: dict, lengths) -> int:
    hop = int(cfg["tStep"] * cfg["signal_sample_rate"])
    return int(np.sum(1 + np.asarray(lengths, dtype=np.int64) // hop))


def operations_per_frame(cfg: dict) -> float:
    n, win = cfg["n_fft"], int(cfg["winLen"] * cfg["signal_sample_rate"])
    bins, nonzero = mel_weights(cfg)
    return win + 2.5 * n * math.log2(n) + 3.0 * bins + 2.0 * nonzero


def operations(cfg: dict, lengths) -> float:
    return frames(cfg, lengths) * operations_per_frame(cfg)


def bytes_moved(cfg: dict, lengths, sample_bytes: int) -> float:
    return float(np.sum(lengths)) * sample_bytes + 4.0 * frames(cfg, lengths) * cfg["n_mels"]


def least_seconds(cfg: dict, lengths, sample_bytes: int, peaks: dict) -> float:
    """The larger of the operations over the chip's highest dense rate and
    the bytes over its memory bandwidth."""
    return max(operations(cfg, lengths) / peaks["bf16_flop_s"], bytes_moved(cfg, lengths, sample_bytes) / peaks["hbm_byte_s"])
