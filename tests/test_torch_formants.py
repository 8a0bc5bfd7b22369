"""PyTorch port: intensity, resampling and the Burg formant tracker against
the JAX package on the CPU (its Pallas Burg kernel in interpret mode where
it is used), the float64 oracle and the goldens."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from modulation_mfcc_tpu.io.wav import design_hq_taps as jax_design_hq_taps, resample as jax_resample
from modulation_mfcc_tpu.models.config import FormantConfig as JaxFormantConfig
from modulation_mfcc_tpu.models.formants import formants_with_gating as jax_formants_with_gating
from modulation_mfcc_tpu.ops.intensity import _kaiser20 as jax_kaiser20, intensity_db as jax_intensity_db
from modulation_mfcc_tpu.ops.intensity import intensity_times as jax_intensity_times
from modulation_mfcc_tpu.ops.lpc import lpc_formants as jax_lpc_formants, poly_roots_dk as jax_poly_roots_dk
from modulation_mfcc_tpu.ops.windows import kaiser as jax_kaiser, praat_gauss as jax_praat_gauss
from modulation_mfcc_tpu.oracle import praat_formants_np
from modulation_mfcc_tpu.parallel.features_batch import batched_formants as jax_batched_formants
from modulation_mfcc_tpu_torch import FormantConfig, FormantTracker, batched_formants, extract_formants
from modulation_mfcc_tpu_torch import formants_with_gating
from modulation_mfcc_tpu_torch.convert import formant_params_from_jax
from modulation_mfcc_tpu_torch.io.wav import design_hq_taps, resample
from modulation_mfcc_tpu_torch.ops import intensity as I
from modulation_mfcc_tpu_torch.ops.lpc import formant_frames, lpc_formants, poly_roots_dk
from modulation_mfcc_tpu_torch.ops.windows import kaiser, praat_gauss
from tests.test_goldens import GOLDEN_DIR
from tests.test_torch_pitch import speech

torch.set_num_threads(1)


def test_formant_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(FormantConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxFormantConfig)}
    assert ours == theirs


@pytest.mark.parametrize("nw", [4, 550, 551])
def test_windows_bit_identical(nw):
    assert np.array_equal(praat_gauss(nw), jax_praat_gauss(nw))
    for periodic in (False, True):
        assert np.array_equal(kaiser(nw, 14.0, periodic), jax_kaiser(nw, 14.0, periodic))
    assert np.array_equal(I._kaiser20(nw, nw + 0.5), jax_kaiser20(nw, nw + 0.5))


@pytest.mark.parametrize("orig,target", [(10_000, 11_000.0), (16_000, 11_000.0), (44_100, 11_000.0), (11_000, 11_000.0)])
def test_resample_matches_jax(orig, target):
    x = np.random.default_rng(2).standard_normal(3 * orig // 10)
    np.testing.assert_array_equal(resample(x, orig, target), jax_resample(x, orig, target))
    assert np.array_equal(design_hq_taps(11, 16), jax_design_hq_taps(11, 16))


INTENSITY = {
    "uniform_10k": (10_000, 100.0, 0.0),   # ts·sr = 80: strided frames
    "interleaved_10k": (10_000, 75.0, 0.0),  # ts·sr = 320/3: three hop-320 grids
    "gather_10k": (10_000, 100.0, 0.00731),  # irregular nearest-index grid
    "uniform_16k": (16_000, 100.0, 0.0),
}


@pytest.mark.parametrize("name", INTENSITY)
def test_intensity_matches_jax(speechlike, name):
    """Every framing branch, ≤ 0.01 dB (tests/test_goldens.py's bar), with
    the frame times equal."""
    sr, min_pitch, ts = INTENSITY[name]
    y = speechlike[0].astype(np.float32) if sr == 10_000 else speech(2.0, sr, seed=3)
    want = np.asarray(jax_intensity_db(jnp.asarray(y), sr=float(sr), min_pitch=min_pitch, time_step=ts))
    got = I.intensity_db(torch.tensor(y), sr=float(sr), min_pitch=min_pitch, time_step=ts).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
    np.testing.assert_array_equal(I.intensity_times(len(y), sr, min_pitch, ts),
                                  jax_intensity_times(len(y), sr, min_pitch, ts))


def test_intensity_boundary_frames_and_golden(speechlike):
    """A clip whose frames overhang its ends (the masked branch) and the
    pinned golden."""
    y = speechlike[0].astype(np.float32)
    short = y[5_000:5_000 + 1_301]
    want = np.asarray(jax_intensity_db(jnp.asarray(short), sr=10_000.0, min_pitch=100.0))
    got = I.intensity_db(torch.tensor(short), sr=10_000.0, min_pitch=100.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
    golden = np.load(f"{GOLDEN_DIR}/intensity.npz")["db"]
    np.testing.assert_allclose(I.intensity_db(torch.tensor(y), sr=10_000.0, min_pitch=100.0).numpy(),
                               golden, rtol=0, atol=0.01)


def test_poly_roots_dk_matches_jax():
    """Polynomials with known roots: the port's Durand-Kerner (complex64, 40
    iterations) converges where the JAX one does, to the same roots."""
    roots = np.array([0.9 * np.exp(1j * 0.3), 0.8 * np.exp(1j * 1.1), 0.95 * np.exp(1j * 2.0)])
    roots = np.concatenate([roots, roots.conj()])
    coeffs = np.poly(roots)[1:].real.astype(np.float32)[None]
    got = poly_roots_dk(torch.tensor(coeffs)).numpy()[0]
    want = np.asarray(jax_poly_roots_dk(jnp.asarray(coeffs)))[0]
    assert got.dtype == np.complex64
    assert np.abs(got[:, None] - roots[None, :]).min(axis=0).max() < 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


LPC_CASES = {
    "default": (dict(), 5.0, 10),
    "nondefault": (dict(window_length=0.015, time_step=0.01, pre_emphasis_from=75.0), 4.0, 8),
}


@pytest.mark.parametrize("name", LPC_CASES)
def test_lpc_formants_float64_matches_jax_and_oracle(speechlike, name):
    """The whole chain on float64 input, as tests/test_formants.py runs it
    against the float64 oracle (np.roots): NaN patterns equal, frequencies
    and bandwidths ≤ 0.05 Hz, against the oracle and against JAX."""
    kw, max_formants, order = LPC_CASES[name]
    y, sr = speechlike
    y = y[:sr]
    got_f, got_b = (v.numpy() for v in lpc_formants(torch.tensor(y), sr=float(sr), order=order,
                                                     max_formant=sr / 2, **kw))
    jax_f, jax_b = (np.asarray(v) for v in jax_lpc_formants(jnp.asarray(y), sr=float(sr), order=order,
                                                             max_formant=sr / 2, burg_engine="xla", **kw))
    _, want_f, want_b = praat_formants_np(y, sr, max_formant=sr / 2, max_formants=max_formants, **kw)
    for ref_f, ref_b in ((want_f, want_b), (jax_f, jax_b)):
        np.testing.assert_array_equal(np.isfinite(got_f), np.isfinite(ref_f))
        m = np.isfinite(ref_f)
        assert m.sum() > 20
        np.testing.assert_allclose(got_f[m], ref_f[m], rtol=0, atol=0.05)
        mb = m & np.isfinite(ref_b) & np.isfinite(got_b)
        np.testing.assert_allclose(got_b[mb], ref_b[mb], rtol=0, atol=0.05)


def f64_chain(x: np.ndarray, sr: float) -> np.ndarray:
    """The JAX formant chain fed float64 (the resampled signal and every
    stage before the complex64 roots): where the float32 chain is
    ill-conditioned, this is the truth both packages are held to."""
    return np.asarray(jax_lpc_formants(jnp.asarray(jax_resample(x, sr, 11_000.0)), sr=11_000.0, burg_engine="xla")[0])


def assert_formants_agree(got: np.ndarray, want: np.ndarray, truth: np.ndarray):
    """Formants [NF, n] of the port against JAX's, both float32 chains, on
    the frames where float32 is well conditioned: where JAX's float32 chain
    has the float64 chain's NaN pattern and is within 0.05 Hz of it. There
    the port has JAX's NaN pattern and is within 0.05 Hz of JAX. The other
    frames are quiet frames at silence boundaries, where Burg in float32 is
    ill-conditioned (a different summation order moves the LPC coefficients
    by ~1e-3, and both packages sit ~2e-2 from float64); they must be few."""
    same_nan = np.all(np.isfinite(want) == np.isfinite(truth), axis=-1)
    close = np.all(np.where(np.isfinite(want), np.abs(want - truth), 0.0) <= 0.05, axis=-1)
    conditioned = same_nan & close
    assert conditioned.mean() > 0.95
    got, want = got[conditioned], want[conditioned]
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=0.05)


def test_formants_with_gating_matches_jax_and_golden(speechlike):
    """Times and the intensity gate equal, NaN patterns equal, and the kept
    frames as :func:`assert_formants_agree` holds them; the gated surface
    against the pinned golden at its 0.5 Hz."""
    y, sr = speechlike
    want_t, want_f, want_keep = jax_formants_with_gating(y, sr)
    got_t, got_f, got_keep = formants_with_gating(y, sr, device="cpu")
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_keep, want_keep)
    truth = f64_chain(y, sr)[:, :3]
    got = np.stack([f.numpy() for f in got_f], -1)
    want = np.stack([np.asarray(f) for f in want_f], -1)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert_formants_agree(got[got_keep], want[got_keep], truth[got_keep])
    t, f123 = extract_formants(y, sr, device="cpu")
    golden = np.load(f"{GOLDEN_DIR}/formants.npz")
    np.testing.assert_allclose(t, golden["t"], rtol=0, atol=0.5)
    for f, key in zip(f123, ("f1", "f2", "f3")):
        np.testing.assert_allclose(f.numpy(), golden[key], rtol=0, atol=0.5, equal_nan=True)


def test_batched_formants_match_jax():
    """Three utterances resampled to 11 kHz against the JAX batch, and the
    first against the JAX tracker with its Pallas Burg kernel (interpret
    mode)."""
    sr = 10_000
    xs = np.stack([jax_resample(speech(1.0, sr, seed=s).astype(np.float64), sr, 11_000.0) for s in (1, 2, 3)])
    x32 = xs.astype(np.float32)
    got_f, got_b = batched_formants(torch.tensor(x32), 11_000.0)
    want_f, _ = (np.asarray(v) for v in jax_batched_formants(jnp.asarray(x32), 11_000.0))
    with pltpu.force_tpu_interpret_mode():
        want_p = np.asarray(jax_lpc_formants(jnp.asarray(x32[0]), sr=11_000.0, burg_engine="pallas")[0])
    assert got_f.shape == want_f.shape == (3, formant_frames(xs.shape[1], 11_000.0, 0.025, 0.005)[0].size, 5)
    truths = [np.asarray(jax_lpc_formants(jnp.asarray(x), sr=11_000.0, burg_engine="xla")[0]) for x in xs]
    for i in range(3):
        assert_formants_agree(got_f[i].numpy(), want_f[i], truths[i])
    assert_formants_agree(got_f[0].numpy(), want_p, truths[0])
    assert bool(torch.isfinite(got_b[torch.isfinite(got_f)]).all())


def test_formant_params_from_jax(speechlike):
    """The tracker loaded with the JAX package's constants holds exactly its
    own designs and computes exactly the same formants."""
    y, sr = speechlike
    own = FormantTracker(FormantConfig(), sr)
    nw = formant_frames(2**31 - 1, 11_000.0, 0.025, 0.005)[1]
    hws = int(np.floor(3.2 / 100.0 * sr))
    carried = FormantTracker(FormantConfig(), sr)
    carried.load_state_dict(formant_params_from_jax({
        "window": jax_praat_gauss(nw),
        "kaiser": jax_kaiser20(hws, 3.2 / 100.0 * sr),
        "taps": jax_design_hq_taps(11, 10),
    }))
    for k, v in own.state_dict().items():
        assert torch.equal(carried.state_dict()[k], v), k
    x = torch.tensor(carried.resample(y), dtype=torch.float32)
    for a, b in zip(carried.lpc(x), own.lpc(x), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    xi = torch.tensor(y, dtype=torch.float32)
    assert torch.equal(carried.intensity(xi), own.intensity(xi))
