"""PyTorch port: its float64 oracles (modulation_mfcc_tpu_torch/oracle.py,
built on the port's own host designs, importable without jax) equal the JAX
package's (modulation_mfcc_tpu/oracle.py) bit for bit, function by function,
on the same seeded inputs, on the CPU."""
import inspect

import numpy as np
import pytest

from modulation_mfcc_tpu import oracle as jax_oracle
from modulation_mfcc_tpu_torch import oracle

SR = 10_000


def speech(seconds: float = 0.6, sr: int = SR, seed: int = 20261017) -> np.ndarray:
    """Amplitude-modulated harmonics on a gliding f0 with noise, float64."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(120.0 + 30.0 * np.sin(2 * np.pi * 2.5 * t)) / sr
    sig = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 6))
    return sig * 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t - np.pi / 2)) + 0.01 * rng.standard_normal(len(t))


def same(a, b) -> bool:
    """Equal bit for bit (NaN where NaN), through tuples."""
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def test_oracle_has_every_function_of_the_jax_oracle():
    """The same public functions, with the same signatures."""
    def public(mod):
        return {n: inspect.signature(f) for n, f in vars(mod).items()
                if inspect.isfunction(f) and f.__module__ == mod.__name__ and not n.startswith("_")}

    assert public(oracle) == public(jax_oracle)
    assert {"stft_power_np", "power_to_db_np", "mfcc_np", "get_mfccs_change_np", "transition_local_np", "pyin_np",
            "viterbi_path_score_np", "boersma_pitch_np", "burg_np", "praat_intensity_np", "praat_formants_np",
            "praat_spectrogram_np"} <= set(public(oracle))


CASES = {
    "stft_power_np": lambda o, y: o.stft_power_np(y, 512, 50, 250),
    "power_to_db_np": lambda o, y: o.power_to_db_np(o.stft_power_np(y, 512, 50, 250)),
    "mfcc_np": lambda o, y: o.mfcc_np(y, SR, win_length=250, hop_length=50),
    "get_mfccs_change_np": lambda o, y: o.get_mfccs_change_np(y, SR),
    "get_mfccs_change_np 16k": lambda o, y: o.get_mfccs_change_np(speech(0.8, 16_000), 16_000, max_freq=8000.0),
    "transition_local_np": lambda o, y: o.transition_local_np(361, 21.5),
    "pyin_np": lambda o, y: o.pyin_np(y, SR, hop_length=100, return_model=True),
    "pyin_np bin_shift": lambda o, y: o.pyin_np(y, SR, hop_length=100, bin_shift=3e-3),
    "viterbi_path_score_np": lambda o, y: o.viterbi_path_score_np(
        *o.pyin_np(y, SR, hop_length=100, return_model=True)[2:]),
    "boersma_pitch_np": lambda o, y: o.boersma_pitch_np(y, SR),
    "boersma_pitch_np cc": lambda o, y: o.boersma_pitch_np(y, SR, method="cc"),
    "burg_np": lambda o, y: o.burg_np(y[1000:1250], 10),
    "praat_intensity_np": lambda o, y: o.praat_intensity_np(y, SR),
    "praat_intensity_np dense": lambda o, y: o.praat_intensity_np(y, SR, min_pitch=120.0, time_step=1.0 / SR),
    "praat_formants_np": lambda o, y: o.praat_formants_np(y, SR, max_formant=SR / 2),
    "praat_spectrogram_np": lambda o, y: o.praat_spectrogram_np(y, SR),
}


@pytest.mark.parametrize("name", CASES)
def test_oracle_equals_the_jax_oracle(name):
    """Each function on the same input: np.array_equal, every output."""
    y = speech()
    got, want = CASES[name](oracle, y), CASES[name](jax_oracle, y)
    assert same(tuple(got) if isinstance(got, (list, tuple)) else got,
                tuple(want) if isinstance(want, (list, tuple)) else want), name
