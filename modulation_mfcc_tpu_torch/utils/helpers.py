"""Shape/padding helpers and device resolution shared by ops and kernels."""
from __future__ import annotations

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up_to_multiple(x: int, m: int) -> int:
    """Round ``x`` up to the nearest multiple of ``m``."""
    return ((x + m - 1) // m) * m


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p


def pad_center(data: np.ndarray, size: int, axis: int = -1) -> np.ndarray:
    """Center-pad a 1-D window to ``size`` samples with zeros
    (librosa.util.pad_center: a 250-sample window inside a 512-point FFT)."""
    n = data.shape[axis]
    lpad = (size - n) // 2
    lengths = [(0, 0)] * data.ndim
    lengths[axis] = (lpad, size - n - lpad)
    if lpad < 0:
        raise ValueError(f"Target size {size} < input size {n}")
    return np.pad(data, lengths, mode="constant")


def dequantize_samples(samples: torch.Tensor) -> torch.Tensor:
    """int16 PCM → float32 as v·2⁻¹⁵ (exact for every int16); floats pass
    through unchanged."""
    if samples.is_floating_point():
        return samples
    return samples.to(torch.float32) * 2.0**-15


def resolve_device(device, like=None) -> torch.device:
    """The device a public function computes on: ``device`` when given, else
    the device of tensor ``like``, else the first CUDA device. Passing
    ``device="cpu"`` is the way onto the CPU. Needing CUDA where no CUDA
    device exists raises; nothing silently runs on the CPU instead."""
    if device is None:
        device = like.device if torch.is_tensor(like) else torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested (the default for non-tensor input) but CUDA "
            "is not available; pass device='cpu' to compute on the CPU"
        )
    return device
