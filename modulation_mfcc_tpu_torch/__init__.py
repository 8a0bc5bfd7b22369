"""modulation_mfcc_tpu_torch: the MFCC modulation-cepstrum pipeline, the
Praat and pyin F0 trackers, the formant tracker, the envelopes and the
reference's analysis workflow (named features with their derivations,
peaks, EMA, TextGrid, CSV) in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (H100).

A port of ``modulation_mfcc_tpu`` (JAX), which stays the reference it is
tested against. This package imports torch, numpy and scipy, never jax.
Entry points compute on CUDA unless given ``device="cpu"`` (or a CPU tensor).

    import modulation_mfcc_tpu_torch as mt
    tot, times = mt.extract_mfcc_change(y)                    # one utterance, on CUDA
    times, m = mt.extract_mfcc(y)                              # its MFCC matrix [NF, n_mfcc]
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
    cfg = mt.config_from_reference_json(saved_dialog_json)     # the reference's config schema
    t, vel = mt.extract_feature("a.wav", "f0", cfg, derivation=1)  # a named feature, derived
    mask = mt.frame_validity_mask(batch.lengths, batch.samples.shape[-1], cfg16k)
    m = mt.mfcc_trajectories(batch.samples, cfg16k, frame_mask=mask)
    m39 = mt.mfcc_with_deltas(m, frame_mask=mask, normalize=True)  # [B, NF, 39], padded frames 0
    s = mt.AnalysisSession("a.wav", cfg)                        # the workbench: curves, peaks, EMA, CSV
    s.add_curve("mod_cepstr"); s.set_region(0.5, 1.5); s.analyze_max_peaks(); s.export_csv("a.csv")

The corpus sweep (``parallel/corpus.py``: ``sweep_mfcc_change`` with
tracker extras, the native decode loader ``io/native.py``, and ``mesh=``)
and the sharded paths on torch.distributed (``parallel/{mesh,multislice}.py``,
``parallel/batch.sharded_mfcc_change``,
``parallel/streaming.sharded_longform_mfcc_change``; ``dryrun.py`` spawns a
world to check them) are imported from their modules.

The CUDA kernels build with nvcc at first use (kernels/_build.py).
``modmfcc-torch verify`` (cli.py) holds every tracker to its float64 oracle
(oracle.py).
"""
from modulation_mfcc_tpu_torch.utils import obs as _obs

with _obs.setup_span("setup.import"):  # the package's own imports (torch is loaded by then)
    from modulation_mfcc_tpu_torch.models.config import (
        AmplitudeConfig,
        DerivationConfig,
        EmaConfig,
        F0Config,
        FormantConfig,
        MfccConfig,
        PipelineConfig,
        config_from_reference_json,
        config_to_reference_json,
        load_config,
        save_config,
    )
    from modulation_mfcc_tpu_torch.models.envelope import extract_envelope
    from modulation_mfcc_tpu_torch.models.features import cmvn, delta, mfcc_with_deltas
    from modulation_mfcc_tpu_torch.models.formants import FormantTracker, extract_formants, formants_with_gating
    from modulation_mfcc_tpu_torch.models.modulation import (
        MfccChange,
        extract_mfcc_change,
        extract_mfcc_matrix,
        mfcc_change,
        mfcc_trajectories,
        modulation_spectrum,
        modulation_spectrum_axes,
    )
    from modulation_mfcc_tpu_torch.models.pipeline import extract_feature
    from modulation_mfcc_tpu_torch.models.pitch import PitchTracker, PyinTracker, extract_f0
    from modulation_mfcc_tpu_torch.models.workbench import AnalysisSession
    from modulation_mfcc_tpu_torch.ops.derivatives import velocity
    from modulation_mfcc_tpu_torch.ops.peaks import peak_mask, peaks_in_interval
    from modulation_mfcc_tpu_torch.ops.resample import resample_device
    from modulation_mfcc_tpu_torch.ops.yin import pyin_f0
    from modulation_mfcc_tpu_torch.parallel.batch import AudioBatch, frame_validity_mask, pad_batch
    from modulation_mfcc_tpu_torch.parallel.features_batch import batched_envelope, batched_f0, batched_formants
    from modulation_mfcc_tpu_torch.parallel.streaming import chunked_mfcc_change

# the API names of BASELINE.json, as the JAX package defines them
extract_modulation = extract_mfcc_change


def extract_mfcc(y, cfg: MfccConfig | None = None, **kw):
    """(times, mfcc [NF, n_mfcc]): the librosa-semantics MFCC matrix of one
    utterance (or [B, NF, n_mfcc] of a batch), :func:`extract_mfcc_matrix`
    under ``cfg`` (default ``MfccConfig()``); ``kw`` as it takes them
    (``spectrum``, ``device``: CUDA unless given the CPU or a CPU tensor)."""
    return extract_mfcc_matrix(y, cfg or MfccConfig(), **kw)


__version__ = "0.1.0"

__all__ = [
    "MfccConfig", "MfccChange", "extract_mfcc_change", "extract_mfcc", "extract_modulation", "mfcc_change",
    "mfcc_trajectories",
    "F0Config", "PitchTracker", "PyinTracker", "pyin_f0", "extract_f0", "FormantConfig", "FormantTracker",
    "extract_formants", "formants_with_gating", "AudioBatch", "pad_batch", "batched_f0",
    "batched_formants", "modulation_spectrum", "modulation_spectrum_axes", "resample_device",
    "chunked_mfcc_change", "AmplitudeConfig", "extract_envelope", "batched_envelope",
    "PipelineConfig", "EmaConfig", "DerivationConfig", "config_from_reference_json", "config_to_reference_json",
    "save_config", "load_config", "extract_feature", "delta", "cmvn", "mfcc_with_deltas", "frame_validity_mask",
    "AnalysisSession", "velocity", "peak_mask", "peaks_in_interval",
]
