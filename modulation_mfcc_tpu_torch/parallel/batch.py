"""Padded batches of variable-length audio."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from modulation_mfcc_tpu_torch.utils.helpers import resolve_device, round_up_to_multiple

__all__ = ["AudioBatch", "pad_batch"]


@dataclass
class AudioBatch:
    """A padded batch of utterances: samples [B, T_pad], lengths [B]."""

    samples: torch.Tensor
    lengths: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.samples.shape[0]


def pad_batch(signals: list[np.ndarray], *, bucket_multiple: int = 2048, dtype=np.float32,
              device=None) -> AudioBatch:
    """Zero-pad 1-D signals to a shared length, a multiple of
    ``bucket_multiple``, on ``device`` (default CUDA; ``device="cpu"`` for
    the CPU)."""
    device = resolve_device(device)
    lengths = np.array([len(s) for s in signals], dtype=np.int64)
    t_pad = round_up_to_multiple(int(lengths.max()), bucket_multiple)
    out = np.zeros((len(signals), t_pad), dtype=dtype)
    for i, s in enumerate(signals):
        out[i, : len(s)] = s
    return AudioBatch(torch.as_tensor(out, device=device), torch.as_tensor(lengths, device=device))
