"""modulation_mfcc_tpu_torch: the MFCC modulation-cepstrum pipeline in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``modulation_mfcc_tpu`` (JAX), which stays the reference it is
tested against. This package imports torch, numpy and scipy, never jax.

    import modulation_mfcc_tpu_torch as mt
    tot, times = mt.extract_mfcc_change(y, device="cuda")     # one utterance
    tot = mt.mfcc_change(batch_on_cuda, mt.MfccConfig(signal_sample_rate=16000, maxFreq=8000.0))

The CUDA kernels build with nvcc at first use (kernels/_build.py).
"""
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import (
    MfccChange,
    extract_mfcc_change,
    mfcc_change,
    mfcc_trajectories,
)

__all__ = ["MfccConfig", "MfccChange", "extract_mfcc_change", "mfcc_change", "mfcc_trajectories"]
