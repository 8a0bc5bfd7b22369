"""PyTorch port: the Praat ac/cc pitch tracker and F0 chain against the JAX
package on the CPU (the JAX sinc kernel in Pallas interpret mode where it is
used), the float64 post-processing, the goldens and the batched path."""
import dataclasses
from functools import partial

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax.numpy as jnp

import modulation_mfcc_tpu.pallas.sinc_refine as jax_sinc
from modulation_mfcc_tpu.models.config import F0Config as JaxF0Config
from modulation_mfcc_tpu.models.pitch import extract_f0 as jax_extract_f0
from modulation_mfcc_tpu.ops.interp import interp_nan as jax_interp_nan
from modulation_mfcc_tpu.ops.pitch import _sinc_weights, pitch_ac as jax_pitch_ac
from modulation_mfcc_tpu.ops.windows import praat_gauss as jax_praat_gauss
from modulation_mfcc_tpu.parallel.batch import pad_batch as jax_pad_batch
from modulation_mfcc_tpu.parallel.features_batch import batched_f0 as jax_batched_f0
from modulation_mfcc_tpu_torch import F0Config, PitchTracker, batched_f0, extract_f0, pad_batch
from modulation_mfcc_tpu_torch.convert import pitch_params_from_jax
from modulation_mfcc_tpu_torch.ops.interp import interp_nan
from modulation_mfcc_tpu_torch.ops.pitch import pitch_ac, pitch_constants, pitch_geometry
from tests.test_goldens import GOLDEN_DIR

torch.set_num_threads(1)

CASES = [("ac", False), ("cc", False), ("ac", True), ("cc", True)]


def speech(seconds: float, sr: int, seed: int, f0: float = 120.0) -> np.ndarray:
    """Speech-like float32: harmonics of a gliding f0 under a 4 Hz envelope,
    noise, and silent lead-in/out (the conftest fixture's recipe)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(f0 + 30.0 * np.sin(2 * np.pi * 2.5 * t)) / sr
    sig = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 6))
    sig = sig * 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t - np.pi / 2)) + 0.01 * rng.standard_normal(len(t))
    sig[: sr // 10] = 0.0
    sig[-(sr // 10):] = 0.0
    return sig.astype(np.float32)


def assert_tracks_agree(got: np.ndarray, want: np.ndarray, atol: float = 0.05):
    """Voiced/unvoiced pattern equal; voiced f0 within ``atol`` Hz."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got > 0, want > 0)
    v = want > 0
    assert v.sum() > 20
    np.testing.assert_allclose(got[v], want[v], rtol=0, atol=atol)


def test_f0_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(F0Config)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxF0Config)}
    assert ours == theirs


@pytest.mark.parametrize("method,very_accurate", CASES)
@pytest.mark.parametrize("sr", [10_000, 16_000])
def test_pitch_ac_matches_jax(speechlike, method, very_accurate, sr):
    """The conftest fixture (10 kHz) and a 16 kHz take (band 26..214)."""
    y = speechlike[0].astype(np.float32) if sr == 10_000 else speech(2.0, sr, seed=3)
    kw = dict(sr=float(sr), method=method, very_accurate=very_accurate)
    want = np.asarray(jax_pitch_ac(jnp.asarray(y, dtype=jnp.float32), **kw))
    got = pitch_ac(torch.tensor(y), **kw)
    assert got.dtype == torch.float32
    assert_tracks_agree(got.numpy(), want)


def test_pitch_ac_pallas_sinc_engine_matches(speechlike, monkeypatch):
    """Against JAX with its Pallas sinc kernel (interpret mode), as
    tests/test_pitch.py drives sinc_engine='pallas'."""
    monkeypatch.setattr(jax_sinc, "refine_sinc_band_pallas", partial(jax_sinc.refine_sinc_band_pallas, interpret=True))
    y = speechlike[0].astype(np.float32)
    want = np.asarray(jax_pitch_ac(jnp.asarray(y, dtype=jnp.float32), sr=10_000.0, sinc_engine="pallas"))
    got = pitch_ac(torch.tensor(y), sr=10_000.0)
    plain = pitch_ac(torch.tensor(y), sr=10_000.0, sinc_engine="plain")
    assert torch.equal(got, plain)  # on the CPU 'auto' is the plain version
    assert_tracks_agree(got.numpy(), want)


@pytest.mark.parametrize("method", ["ac", "cc"])
def test_pitch_ac_valid_len_matches_jax(method):
    """A zero-padded batch with per-utterance lengths: each row equals the
    JAX tracker run on that row with valid_len (mean, peak and the cc edge
    sample per utterance)."""
    sr = 10_000
    ys = [speech(2.0, sr, seed=1), speech(1.6, sr, seed=2, f0=180.0)]
    x = np.zeros((2, 21_000), np.float32)
    for i, y in enumerate(ys):
        x[i, : len(y)] = y
    lengths = np.array([len(y) for y in ys])
    got = pitch_ac(torch.tensor(x), sr=float(sr), method=method, valid_len=torch.tensor(lengths)).numpy()
    for i in range(2):
        want = np.asarray(jax_pitch_ac(jnp.asarray(x[i]), sr=float(sr), method=method,
                                       valid_len=jnp.asarray(lengths[i])))
        assert_tracks_agree(got[i], want)


@pytest.mark.parametrize("method", ["ac", "cc"])
def test_pitch_ac_short_signal_matches_jax(method):
    """Shorter than one analysis span: zero-extended, one frame, unvoiced."""
    y = speech(0.02, 10_000, seed=4)
    want = np.asarray(jax_pitch_ac(jnp.asarray(y), sr=10_000.0, method=method))
    got = pitch_ac(torch.tensor(y), sr=10_000.0, method=method).numpy()
    assert got.shape == want.shape == (1,)
    np.testing.assert_array_equal(got, want)


def test_pitch_engines_and_geometry_checks(speechlike):
    y = torch.tensor(speechlike[0].astype(np.float32))
    with pytest.raises(ValueError, match="TPU-only"):
        pitch_ac(y, sr=10_000.0, ac_engine="mxu")
    with pytest.raises(ValueError, match="sinc_engine"):
        pitch_ac(y, sr=10_000.0, sinc_engine="pallas")
    with pytest.raises(ValueError, match="incompatible"):
        pitch_ac(y, sr=10_000.0, min_pitch=5000.0, max_pitch=6000.0)
    assert torch.equal(pitch_ac(y, sr=10_000.0, ac_engine="fft"), pitch_ac(y, sr=10_000.0))


CHAINS = {
    "default": {},
    "praatcc": dict(method="praatcc"),
    "pchip": dict(interpUnvoiced="pchip"),
    "minmaxquant": dict(minMaxQuant=(0.05, 0.95)),
    "cc_minmaxquant": dict(method="praatcc", minMaxQuant=(0.1, 0.9)),
    "very_accurate": dict(veryAccurate=True),
}


@pytest.mark.parametrize("name", CHAINS)
def test_extract_f0_matches_jax(speechlike, name):
    """The full chain (unvoiced → NaN, interpolation, 12 Hz 'iir' filter,
    the minMaxQuant second pass that is always 'ac'), float64 after the
    tracker, against JAX at 0.05 Hz (tests/test_goldens.py's bar)."""
    y, sr = speechlike
    want, want_t = jax_extract_f0(y, sr, JaxF0Config(**CHAINS[name]))
    got, t = extract_f0(y, sr, F0Config(**CHAINS[name]), device="cpu")
    assert got.dtype == torch.float64 and np.array_equal(t, want_t)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.05, equal_nan=True)


@pytest.mark.parametrize("method,golden", [("praatac", "f0_ac"), ("praatcc", "f0_cc")])
def test_extract_f0_matches_goldens(speechlike, method, golden):
    y, sr = speechlike
    f0, t = extract_f0(y, sr, F0Config(method=method, outFilter=None, interpUnvoiced=None), device="cpu")
    want = np.load(f"{GOLDEN_DIR}/{golden}.npz")
    np.testing.assert_allclose(t, want["t"], rtol=0, atol=0.05)
    np.testing.assert_allclose(f0.numpy(), want["f0"], rtol=0, atol=0.05, equal_nan=True)


def test_extract_f0_unported_and_invalid_options(speechlike):
    y, sr = speechlike
    with pytest.raises(ValueError, match="pad_mode"):
        extract_f0(y, sr, F0Config(method="pyin", pyinpad_mode="empty"), device="cpu")
    with pytest.raises(ValueError, match="Unknown f0 method"):
        extract_f0(y, sr, F0Config(method="yin"), device="cpu")
    # the 'fir' out-filter is ported: scipy's filtfilt of the unfiltered track
    got, _ = extract_f0(y, sr, F0Config(outFilter="fir", outFiltLen=31), device="cpu")
    raw, _ = extract_f0(y, sr, F0Config(outFilter=None), device="cpu")
    b = sps.firwin(31, 12.0 / 50.0, window=("kaiser", 7.4), pass_zero="lowpass")
    np.testing.assert_allclose(got.numpy(), sps.filtfilt(b, 1.0, raw.numpy().astype(np.float64)), rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="not interpolated"):
        extract_f0(y, sr, F0Config(interpUnvoiced=None), device="cpu")
    with pytest.raises(ValueError, match="one utterance"):
        extract_f0(np.stack([y, y]), sr, F0Config(), device="cpu")
    silent, _ = extract_f0(np.zeros(20_000), sr, F0Config(), device="cpu")
    assert bool(torch.isnan(silent).all())


@pytest.mark.parametrize("method", ["linear", "pchip"])
def test_interp_nan_matches_jax(method):
    """NaN runs inside, at both ends, and a row with one valid sample, in
    float64: equal to float64 rounding."""
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.standard_normal((4, 60)), axis=-1)
    x[0, :5] = x[0, 20:31] = x[0, -7:] = np.nan
    x[1, 10:12] = np.nan
    x[2, rng.random(60) < 0.4] = np.nan
    x[3, :] = np.nan
    x[3, 17] = 2.5
    for row in x:
        want = np.asarray(jax_interp_nan(jnp.asarray(row), method))
        got = interp_nan(torch.tensor(row), method).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(interp_nan(torch.tensor(x[:3]), method).numpy(),
                               np.stack([np.asarray(jax_interp_nan(jnp.asarray(r), method)) for r in x[:3]]),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["praatac", "praatcc"])
def test_batched_f0_matches_jax(method):
    sr = 10_000
    signals = [speech(2.0, sr, seed=1), speech(1.5, sr, seed=2, f0=170.0), speech(2.2, sr, seed=6)]
    cfg = F0Config(method=method)
    want_f0, want_valid = jax_batched_f0(jax_pad_batch(signals), float(sr), JaxF0Config(method=method))
    got_f0, got_valid = batched_f0(pad_batch(signals, device="cpu"), float(sr), cfg)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    want_f0 = np.asarray(want_f0)
    for i in range(3):
        assert_tracks_agree(got_f0[i].numpy(), want_f0[i])
    with pytest.raises(ValueError, match="Unknown f0 method"):
        batched_f0(pad_batch(signals, device="cpu"), float(sr), F0Config(method="yin"))


def jax_pitch_constants(method: str, very_accurate: bool, sr: float) -> dict:
    """The tracker's constants as the JAX package's host code builds them
    (ops/pitch.py: the AC_HANNING expression, praat_gauss, the window
    autocorrelation of its 'mxu' branch, _sinc_weights)."""
    g = pitch_geometry(2**31 - 1, sr, 0.01, 75.0, 600.0, method, 3.0, very_accurate)
    arrays = {"sinc_weights": _sinc_weights(np.linspace(-1.0, 1.0, 17), g.depth)}
    if method == "ac":
        i = np.arange(1, g.nw + 1, dtype=np.float64)
        w = jax_praat_gauss(g.nw) if very_accurate else 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (g.nw + 1))
        wf = np.fft.rfft(w, n=g.nfft)
        arrays.update(window=w, wac=np.fft.irfft(wf * np.conj(wf), n=g.nfft)[: g.lag_hi + 1])
    return arrays


@pytest.mark.parametrize("method,very_accurate", CASES)
def test_pitch_params_from_jax(speechlike, method, very_accurate):
    """The tracker loaded with the JAX package's constants holds exactly
    its own designs and computes exactly the same tracks."""
    sr = speechlike[1]
    cfg = F0Config(method="praatac" if method == "ac" else "praatcc", veryAccurate=very_accurate)
    own = PitchTracker(cfg, sr)
    carried = PitchTracker(cfg, sr)
    carried.load_state_dict(pitch_params_from_jax(jax_pitch_constants(method, very_accurate, float(sr))))
    for k, v in own.state_dict().items():
        assert torch.equal(carried.state_dict()[k], v), k
    assert set(own.state_dict()) == set(pitch_constants(own.geometry(2**31 - 1)))
    y = torch.tensor(speechlike[0].astype(np.float32))
    assert torch.equal(carried(y), own(y))
