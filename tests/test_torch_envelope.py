"""PyTorch port: the amplitude envelopes (models/envelope.py, ops/hilbert.py,
ops/framing.hop_window_sums, models/pitch_adaptive.py, parallel/
features_batch.batched_envelope) against the JAX package on the same seeded
inputs, on the CPU. Bars (the verify harness's, modulation_mfcc_tpu/
runner.py): RMS ≤ 1e-4, Hilbert ≤ 1e-3, RMSpraat ≤ 0.01 dB frame-exact;
the batch against the per-file results; RMSpraat against the pinned
golden tests/goldens/rmspraat.npz."""
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax.numpy as jnp

from modulation_mfcc_tpu.models import envelope as jax_env
from modulation_mfcc_tpu.models.config import AmplitudeConfig as JaxAmplitudeConfig
from modulation_mfcc_tpu.models.pitch_adaptive import praat_style_intensity as jax_praat_style_intensity
from modulation_mfcc_tpu.ops.framing import hop_window_sums as jax_hop_window_sums
from modulation_mfcc_tpu.ops.hilbert import analytic_signal as jax_analytic_signal
from modulation_mfcc_tpu.ops.hilbert import hilbert_envelope as jax_hilbert_envelope
from modulation_mfcc_tpu_torch import AmplitudeConfig, batched_envelope, extract_envelope, pad_batch
from modulation_mfcc_tpu_torch.models import envelope as env
from modulation_mfcc_tpu_torch.models.pitch_adaptive import praat_style_intensity
from modulation_mfcc_tpu_torch.ops.framing import hop_window_sums
from modulation_mfcc_tpu_torch.ops.hilbert import analytic_signal, hilbert_envelope

torch.set_num_threads(1)

SR = 10_000
GOLDEN = Path(__file__).resolve().parent / "goldens" / "rmspraat.npz"


def noise(n: int, seed: int = 20261017, batch: int | None = None) -> np.ndarray:
    shape = (n,) if batch is None else (batch, n)
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def tones() -> list[np.ndarray]:
    """Three harmonic tones of 1.0, 0.7 and 0.85 s at 10 kHz (the JAX
    batched-feature test's signals), float32."""
    t = np.arange(SR) / SR
    return [sum((0.7 / k) * np.sin(2 * np.pi * k * f * t[: int(d * SR)]) for k in range(1, 4)).astype(np.float32)
            for f, d in ((140.0, 1.0), (200.0, 0.7), (110.0, 0.85))]


@pytest.mark.parametrize("window, hop", [(1000, 100), (250, 50), (1001, 100), (37, 50), (400, 80)])
def test_hop_window_sums_matches_jax(window, hop):
    """Whole hop rows plus a partial row (rem > 0), whole rows only, and a
    window shorter than a hop (q = 0), on a series shorter and one longer
    than the row grid."""
    for n in (9_000, 20_000):
        x = noise(n, batch=2) ** 2
        nf = 1 + (n - window) // hop
        got = hop_window_sums(torch.tensor(x), nf, window, hop).numpy()
        want = np.asarray(jax_hop_window_sums(jnp.asarray(x), nf, window, hop))
        assert got.shape == want.shape == (2, nf)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [4096, 4097])
def test_hilbert_matches_jax_and_scipy(n):
    """|analytic signal| within 1e-3 of JAX (the harness's bar) and of
    scipy.signal.hilbert; the analytic signal's real part is x."""
    x = noise(n, seed=n)
    got = hilbert_envelope(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_hilbert_envelope(jnp.asarray(x))), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, np.abs(sps.hilbert(x.astype(np.float64))), rtol=0, atol=1e-5)
    z = analytic_signal(torch.tensor(x)).numpy()
    zj = np.asarray(jax_analytic_signal(jnp.asarray(x)))
    assert np.array_equal(z.real, x)
    np.testing.assert_allclose(z.imag, zj.imag, rtol=0, atol=1e-5)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("win, hop", [(1000, 100), (250, 50), (6500, 100)])
def test_rms_envelope_matches_jax(win, hop, center):
    """Hop-row sums, and gathered frames where W/hop > 64 (6500 / 100),
    centered or not, within the harness's 1e-4."""
    x = noise(20_000, batch=2)
    got = env.rms_envelope(torch.tensor(x), win, hop, center=center).numpy()
    want = np.asarray(jax_env.rms_envelope(jnp.asarray(x), win, hop, center=center))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("cfg", [
    dict(method="RMS"), dict(method="Hilb"), dict(method="RMS", outFilter="iir"),
    dict(method="RMS", center=False, winLen=0.025, hopLen=0.005),
])
def test_amplitude_envelope_and_times_match_jax(cfg):
    """amplitude_envelope and extract_envelope against JAX: RMS ≤ 1e-4,
    Hilbert ≤ 1e-3, the times equal, with 'Hilb' on the hop grid (the
    reference's case quirk: 'Hilb' != 'hilb')."""
    x = noise(15_000)
    tol = 1e-3 if cfg["method"] == "Hilb" else 1e-4
    got = env.amplitude_envelope(torch.tensor(x), float(SR), AmplitudeConfig(**cfg)).numpy()
    want = np.asarray(jax_env.amplitude_envelope(jnp.asarray(x), float(SR), JaxAmplitudeConfig(**cfg)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    amp, t = extract_envelope(x, SR, AmplitudeConfig(**cfg), device="cpu")
    jamp, jt = jax_env.extract_envelope(x, SR, JaxAmplitudeConfig(**cfg))
    assert amp.device.type == "cpu" and np.array_equal(t, jt)
    np.testing.assert_allclose(amp.numpy(), np.asarray(jamp), rtol=0, atol=tol)
    if cfg["method"] == "Hilb":
        assert np.array_equal(t, np.arange(len(x)) * 0.01)


def test_rmspraat_matches_jax_and_golden(speechlike):
    """praat_style_intensity (the two pitch_ac passes, their quantiles, the
    minimum over the raw track) within 0.01 dB of JAX, frame-exact and at
    the same rate, and of the pinned golden; extract_envelope's RMSpraat
    times are the frames over that rate."""
    y, sr = speechlike
    got, rate = praat_style_intensity(torch.tensor(y, dtype=torch.float32), sr)
    want, want_rate = jax_praat_style_intensity(jnp.asarray(y, dtype=jnp.float32), sr)
    want = np.asarray(want)
    assert rate == want_rate and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.01)
    golden = np.load(GOLDEN)
    assert rate == float(golden["rate"][0])
    np.testing.assert_allclose(got.double().numpy(), golden["amp"], rtol=0, atol=0.01)
    amp, t = extract_envelope(y, sr, AmplitudeConfig(method="RMSpraat"), device="cpu")
    assert torch.equal(amp, got) and np.array_equal(t, np.arange(len(got)) / rate)


def test_batched_envelope_matches_per_file():
    """RMS: the masked batch equals each file's envelope on its valid frames
    (1 + length // hop) and is zero past them; Hilb: the interior within
    2e-2 of the per-file transform (the padded-width FFT's edge ripple), and
    valid = the file's samples; RMSpraat raises (per-file adaptive)."""
    sigs = tones()
    batch = pad_batch(sigs, bucket_multiple=1024, device="cpu")
    cfg = AmplitudeConfig(method="RMS")
    amp, valid = batched_envelope(batch, SR, cfg)
    hop = int(cfg.hopLen * SR)
    for i, s in enumerate(sigs):
        single = env.rms_envelope(torch.tensor(s), int(cfg.winLen * SR), hop).numpy()
        nf = int(valid[i].sum())
        assert nf == 1 + len(s) // hop == len(single)
        np.testing.assert_allclose(amp[i, :nf].numpy(), single, rtol=0, atol=1e-6)
        assert not amp[i, nf:].any()
    amp, valid = batched_envelope(batch, SR, AmplitudeConfig(method="Hilb"))
    for i, s in enumerate(sigs):
        n = int(valid[i].sum())
        assert n == len(s) and not amp[i, n:].any()
        single = hilbert_envelope(torch.tensor(s)).numpy()
        m = n // 10
        np.testing.assert_allclose(amp[i, m : n - m].numpy(), single[m : n - m], rtol=0, atol=2e-2)
    with pytest.raises(ValueError, match="RMSpraat"):
        batched_envelope(batch, SR, AmplitudeConfig(method="RMSpraat"))
