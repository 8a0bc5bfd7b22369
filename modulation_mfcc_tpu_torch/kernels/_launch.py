"""What every kernel wrapper shares: the route rule, operand checks and the
launch-error check.

A wrapper takes its plain PyTorch version only for a tensor on the CPU; on
a CUDA tensor it launches its kernel, and on any other device it raises.
"""
from __future__ import annotations

import torch


def route(t: torch.Tensor, name: str) -> bool:
    """True for the CUDA kernel, False for the plain version (CPU tensors
    only); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every operand a contiguous float32 tensor on the first one's device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: every operand must be a contiguous float32 tensor on "
                f"{dev}; got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )


def raise_on(rc: int, name: str) -> None:
    """Raise when a launcher returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {rc}")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
