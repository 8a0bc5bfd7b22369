"""PyTorch port: the modulation spectrum (BASELINE config #3) against the JAX
package's fft path, in float64 and float32, with the shape contract of
tests/test_mfcc.py::test_modulation_spectrum_shape."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modulation_mfcc_tpu.models import modulation as jax_mod
from modulation_mfcc_tpu.models.config import MfccConfig as JaxMfccConfig
from modulation_mfcc_tpu_torch import MfccConfig, modulation_spectrum, modulation_spectrum_axes
from tests.test_torch_modulation import CONFIGS, speechlike

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def noise():
    return np.random.default_rng(20260816).standard_normal((2, 24_000))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype,bar", [(np.float64, 1e-10), (np.float32, 1e-4)], ids=["float64", "float32"])
def test_modulation_spectrum_matches_jax(noise, name, dtype, bar):
    """Both packages' fft paths on the same input: within ``bar`` of each
    utterance's peak (float32: the MFCCs agree to 1e-4-grade rounding)."""
    cfg = MfccConfig(**CONFIGS[name])
    y = noise.astype(dtype)
    for kw in (dict(), dict(mod_n_fft=64, mod_hop=8)):
        want = np.asarray(jax_mod.modulation_spectrum(jnp.asarray(y), JaxMfccConfig(**CONFIGS[name]), **kw))
        got = modulation_spectrum(torch.tensor(y), cfg, spectrum="fft", **kw).numpy()
        assert got.dtype == dtype and got.shape == want.shape
        peak = want.max(axis=(1, 2, 3))
        assert (np.abs(got - want).max(axis=(1, 2, 3)) <= bar * peak).all()


def test_fused_spectra_agree_with_fft(noise):
    """The fused spectrum (plain on the CPU) within 1e-4 of each
    utterance's peak of the float64 fft path, and the bf16 one finite and
    of the same shape."""
    cfg = MfccConfig(**CONFIGS["16k"])
    want = modulation_spectrum(torch.tensor(noise), cfg, spectrum="fft").numpy()
    y = torch.tensor(noise.astype(np.float32))
    got = modulation_spectrum(y, cfg).numpy()
    peak = want.max(axis=(1, 2, 3))
    assert (np.abs(got - want).max(axis=(1, 2, 3)) <= 1e-4 * peak).all()
    bf16 = modulation_spectrum(y, cfg, spectrum="fused_bf16")
    assert bf16.shape == got.shape and bool(torch.isfinite(bf16).all())


@pytest.mark.parametrize("name", CONFIGS)
def test_modulation_spectrum_shape_and_axes(name):
    """One utterance [T] → [n_coef, n_modframes, n_modbins] = [12, ·, 65],
    finite; the axes equal JAX's modulation_spectrum_axes."""
    cfg = MfccConfig(**CONFIGS[name])
    y = speechlike(2.5, cfg.signal_sample_rate)
    spec = modulation_spectrum(y, cfg, device="cpu", mod_n_fft=128, mod_hop=16)
    freqs, times = modulation_spectrum_axes(len(y), cfg)
    assert spec.shape == (12, len(times), 65) == (12, 1 + (1 + len(y) // cfg.hop_length) // 16, len(freqs))
    assert bool(torch.isfinite(spec).all())
    jf, jt = jax_mod.modulation_spectrum_axes(len(y), JaxMfccConfig(**CONFIGS[name]))
    assert np.array_equal(freqs, jf) and np.array_equal(times, jt)
    assert freqs[-1] == 100.0
