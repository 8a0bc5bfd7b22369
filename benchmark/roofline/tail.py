"""The MFCC tail's work: dB, the clip at the peak less 80 dB and the DCT,
over the frames the inputs need. Bytes: the float32 mel read once and the
float32 coefficients written once. Operations: the DCT, 2 * frames *
n_mels * n_mfcc, on the FP32 units."""
from __future__ import annotations

from benchlib.catalog import plugin


def bytes_moved(cfg: dict, lengths) -> float:
    return 4.0 * plugin("roofline", "frontend").frames(cfg, lengths) * (cfg["n_mels"] + cfg["n_mfcc"])


def operations(cfg: dict, lengths) -> float:
    return 2.0 * plugin("roofline", "frontend").frames(cfg, lengths) * cfg["n_mels"] * cfg["n_mfcc"]


def least_seconds(cfg: dict, lengths, peaks: dict) -> float:
    return max(bytes_moved(cfg, lengths) / peaks["hbm_byte_s"], operations(cfg, lengths) / peaks["fp32_flop_s"])
