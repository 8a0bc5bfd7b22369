"""PyTorch port: long-form extraction (parallel/streaming.py) and the device
resampler (ops/resample.py) against the JAX package and scipy, in float64
(the bars of tests/test_ops_misc.py and tests/test_parallel.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modulation_mfcc_tpu.io.wav import resample as jax_host_resample
from modulation_mfcc_tpu.models import modulation as jax_mod
from modulation_mfcc_tpu.models.config import MfccConfig as JaxMfccConfig
from modulation_mfcc_tpu.ops.resample import resample_device as jax_resample_device
from modulation_mfcc_tpu.ops.resample import resample_poly_device as jax_resample_poly_device
from modulation_mfcc_tpu.parallel.streaming import chunked_mfcc_change as jax_chunked_mfcc_change
from modulation_mfcc_tpu_torch import MfccConfig, chunked_mfcc_change, extract_mfcc_change, mfcc_change
from modulation_mfcc_tpu_torch.io.wav import resample
from modulation_mfcc_tpu_torch.ops.resample import n_resampled, resample_device, resample_poly_device
from modulation_mfcc_tpu_torch.parallel import streaming

torch.set_num_threads(1)

SMALL = dict(n_fft=256, n_mels=40)  # tests/test_parallel.py's configuration


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("orig,target", [(10_000, 11_000), (44_100, 10_000), (16_000, 10_000), (48_000, 16_000)])
def test_resample_device_matches_jax_and_host(rng, orig, target):
    x = rng.standard_normal(8011)
    got = resample_device(torch.tensor(x), float(orig), float(target)).numpy()
    want = resample(x, orig, target)
    assert got.shape == want.shape == (n_resampled(8011, *(np.array([target, orig]) // np.gcd(orig, target))),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, jax_host_resample(x, orig, target), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, np.asarray(jax_resample_device(jnp.asarray(x), float(orig), float(target))),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("up,down,n", [(1, 3, 10_000), (3, 2, 8_011), (160, 441, 9_000), (2, 3, 4_097)])
def test_resample_blocked_equals_flat(rng, up, down, n):
    """The blocked form (every input above block_threshold) against the flat
    one and JAX's, ragged last rows and leading dims included."""
    x = torch.tensor(rng.standard_normal((2, 3, n)))
    flat = resample_poly_device(x, up, down)
    blocked = resample_poly_device(x, up, down, block_threshold=0)
    assert blocked.shape == flat.shape == (2, 3, n_resampled(n, up, down))
    np.testing.assert_allclose(blocked.numpy(), flat.numpy(), rtol=0, atol=1e-12)
    want = np.asarray(jax_resample_poly_device(jnp.asarray(x.numpy()), up, down))
    np.testing.assert_allclose(flat.numpy(), want, rtol=0, atol=1e-10)


def test_resample_float32_and_identity(rng):
    """float32 in, float32 out within 1e-6 of the float64 host path; equal
    rates return the input."""
    x = rng.standard_normal(20_000).astype(np.float32)
    got = resample_device(torch.tensor(x), 48_000, 16_000)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), resample(x.astype(np.float64), 48_000, 16_000), rtol=0, atol=1e-6)
    t = torch.tensor(x)
    assert resample_device(t, 16_000, 16_000) is t


def test_chunked_equals_wholefile_and_jax(rng):
    """Chunked equals whole-file to 1e-8 in float64; the two-pass schedule
    equals the single pass bit for bit; the port equals JAX's chunked path."""
    cfg = MfccConfig(**SMALL)
    y = rng.standard_normal(120_000)
    whole = mfcc_change(torch.tensor(y), cfg, spectrum="fft")
    chunked = chunked_mfcc_change(torch.tensor(y), cfg, frames_per_chunk=512)
    assert chunked.dtype == torch.float64 and chunked.shape == whole.shape == (1 + 120_000 // cfg.hop_length,)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0, atol=1e-8)
    two_pass = chunked_mfcc_change(torch.tensor(y), cfg, frames_per_chunk=512, mel_stack_cap_bytes=0)
    assert torch.equal(two_pass, chunked)
    want = np.asarray(jax_chunked_mfcc_change(jnp.asarray(y), JaxMfccConfig(**SMALL), frames_per_chunk=512))
    np.testing.assert_allclose(chunked.numpy(), want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("opts", [dict(), dict(diffMethod="sg", outFilter="sg", outFiltLen=31)],
                         ids=["default", "sg"])
def test_chunked_matches_jax_float32(rng, opts):
    """float32 at the reference defaults (10 kHz) and with the Savitzky-Golay
    options: the port's chunked path within 1e-5 of JAX's."""
    y = rng.standard_normal(70_000).astype(np.float32)
    got = chunked_mfcc_change(torch.tensor(y), MfccConfig(**opts), frames_per_chunk=1024).numpy()
    want = np.asarray(jax_chunked_mfcc_change(jnp.asarray(y), JaxMfccConfig(**opts), frames_per_chunk=1024))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_extract_mfcc_change_longform_route(rng, monkeypatch):
    """Utterances of at least longform_threshold samples take the chunked
    route, as JAX's extract_mfcc_change routes them, and agree with JAX's."""
    cfg = MfccConfig()
    y = rng.standard_normal(50_000).astype(np.float32)
    calls = []
    orig = streaming.chunked_mfcc_change
    monkeypatch.setattr(streaming, "chunked_mfcc_change", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    got, t = extract_mfcc_change(y, cfg, device="cpu", longform_threshold=50_000)
    assert calls == [1]
    assert torch.equal(got, orig(torch.tensor(y), cfg))
    extract_mfcc_change(y, cfg, device="cpu", longform_threshold=50_001)
    assert calls == [1]
    want, want_t = jax_mod.extract_mfcc_change(y, JaxMfccConfig(), longform_threshold=50_000)
    assert np.array_equal(t, want_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
