"""modulation_mfcc_tpu_torch: the MFCC modulation-cepstrum pipeline, the
Praat and pyin F0 trackers and the formant tracker in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``modulation_mfcc_tpu`` (JAX), which stays the reference it is
tested against. This package imports torch, numpy and scipy, never jax.
Entry points compute on CUDA unless given ``device="cpu"`` (or a CPU tensor).

    import modulation_mfcc_tpu_torch as mt
    tot, times = mt.extract_mfcc_change(y)                    # one utterance, on CUDA
    tot = mt.mfcc_change(batch_on_cuda, mt.MfccConfig(signal_sample_rate=16000, maxFreq=8000.0))
    f0, t = mt.extract_f0(y, 16000, mt.F0Config())            # Praat ac, interpolated + filtered
    t, (f1, f2, f3) = mt.extract_formants(y, 16000, mt.FormantConfig())
    f0, valid = mt.batched_f0(mt.pad_batch(signals), 16000, mt.F0Config())
    f0, t = mt.extract_f0(y, 16000, mt.F0Config(method="pyin"))  # pyin, unvoiced NaN-filled
    f0 = mt.pyin_f0(batch_on_cuda, sr=16000.0)                 # raw pyin tracks, 0 = unvoiced
    spec = mt.modulation_spectrum(batch_on_cuda, cfg)          # [B, n_coef, n_modframes, 65]
    amp, t = mt.extract_envelope(y, 16000, mt.AmplitudeConfig())  # RMS, Hilb or RMSpraat
    amp, valid = mt.batched_envelope(mt.pad_batch(signals), 16000, mt.AmplitudeConfig())
    y16 = mt.resample_device(y48k_on_cuda, 48000, 16000)        # polyphase, on the device
    tot = mt.chunked_mfcc_change(y16, cfg)                      # an hour-long recording in chunks

The CUDA kernels build with nvcc at first use (kernels/_build.py).
``modmfcc-torch verify`` (cli.py) holds every tracker to its float64 oracle
(oracle.py).
"""
from modulation_mfcc_tpu_torch.models.config import AmplitudeConfig, F0Config, FormantConfig, MfccConfig
from modulation_mfcc_tpu_torch.models.envelope import extract_envelope
from modulation_mfcc_tpu_torch.models.formants import FormantTracker, extract_formants, formants_with_gating
from modulation_mfcc_tpu_torch.models.modulation import (
    MfccChange,
    extract_mfcc_change,
    mfcc_change,
    mfcc_trajectories,
    modulation_spectrum,
    modulation_spectrum_axes,
)
from modulation_mfcc_tpu_torch.models.pitch import PitchTracker, PyinTracker, extract_f0
from modulation_mfcc_tpu_torch.ops.resample import resample_device
from modulation_mfcc_tpu_torch.ops.yin import pyin_f0
from modulation_mfcc_tpu_torch.parallel.batch import AudioBatch, pad_batch
from modulation_mfcc_tpu_torch.parallel.features_batch import batched_envelope, batched_f0, batched_formants
from modulation_mfcc_tpu_torch.parallel.streaming import chunked_mfcc_change

__all__ = [
    "MfccConfig", "MfccChange", "extract_mfcc_change", "mfcc_change", "mfcc_trajectories",
    "F0Config", "PitchTracker", "PyinTracker", "pyin_f0", "extract_f0", "FormantConfig", "FormantTracker",
    "extract_formants", "formants_with_gating", "AudioBatch", "pad_batch", "batched_f0",
    "batched_formants", "modulation_spectrum", "modulation_spectrum_axes", "resample_device",
    "chunked_mfcc_change", "AmplitudeConfig", "extract_envelope", "batched_envelope",
]
