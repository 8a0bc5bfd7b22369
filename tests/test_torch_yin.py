"""PyTorch port: pyin (ops/yin.py, models/pitch.PyinTracker, the pyin branches
of extract_f0 and batched_f0) against the JAX package and the librosa-exact
float64 oracle on the CPU, with the JAX package's own bars: the host designs
bit-identical, the CMNDF to rounding, identical voicing and voiced states,
f0 to rtol 1e-12 in float64 and 1e-5 in float32. Unvoiced states may differ
only at exact ties of the decode model (certified by path score), and a
float32 voiced bin only at a rounding boundary (oracle ``bin_shift``)."""
import numpy as np
import pytest
import scipy.signal
import torch

import jax.numpy as jnp

import modulation_mfcc_tpu.ops.yin as jax_yin
from modulation_mfcc_tpu import oracle
from modulation_mfcc_tpu.models.config import F0Config as JaxF0Config
from modulation_mfcc_tpu.models.pitch import extract_f0 as jax_extract_f0
from modulation_mfcc_tpu.ops.framing import frame_by_slices as jax_frame_by_slices
from modulation_mfcc_tpu.parallel.batch import pad_batch as jax_pad_batch
from modulation_mfcc_tpu.parallel.features_batch import batched_f0 as jax_batched_f0
from modulation_mfcc_tpu_torch import F0Config, PyinTracker, batched_f0, extract_f0, pad_batch, pyin_f0
from modulation_mfcc_tpu_torch.convert import pyin_params_from_jax
from modulation_mfcc_tpu_torch.kernels import viterbi as V
from modulation_mfcc_tpu_torch.ops import yin as Y
from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from tests.test_goldens import GOLDEN_DIR
from tests.test_torch_pitch import speech

torch.set_num_threads(1)


def speechlike_sig() -> tuple[np.ndarray, int]:
    """tests/test_yin.py's _speechlike_sig: 2 s at 10 kHz, float64."""
    rng = np.random.default_rng(20260816)
    sr = 10_000
    t = np.arange(int(2.0 * sr)) / sr
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 2.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t - np.pi / 2))
    sig = sig * env + 0.01 * rng.standard_normal(len(t))
    sig[: sr // 10] = 0.0
    sig[-sr // 10 :] = 0.0
    return sig, sr


def collision_sig() -> tuple[np.ndarray, int]:
    """tests/test_yin.py's 44.1 kHz collision-heavy take, cut to 0.25 s."""
    rng = np.random.default_rng(0)
    sr = 44100
    t = np.arange(int(0.25 * sr)) / sr
    return np.sin(2 * np.pi * 110 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t)) + 0.05 * rng.standard_normal(t.shape), sr


# ---------------------------------------------------------------------------
# Host designs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,width", [(361, 43.1), (361, 43.99), (181, 14.368), (602, 109.5), (10, 1.0), (12, 12.0)])
def test_transition_local_bit_identical(n, width):
    got = Y._transition_local(n, width)
    assert np.array_equal(got, jax_yin._transition_local(n, width))
    np.testing.assert_allclose(got, oracle.transition_local_np(n, width), rtol=1e-12, atol=1e-15)


def test_transition_width_guard():
    """width < 1 (librosa raises) and a window wider than the grid raise, as in the JAX package."""
    for width, match in ((0.5, "width"), (11.0, "exceeds")):
        for fn in (Y._transition_local, jax_yin._transition_local):
            with pytest.raises(ValueError, match=match):
                fn(10, width)
    np.testing.assert_allclose(Y._transition_local(10, 1.0), np.eye(10))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 7, 8, 43, 44])
def test_triang_window_bit_identical(m):
    got = Y._triang_window(m)
    assert np.array_equal(got, jax_yin._triang_window(m))
    np.testing.assert_allclose(got, scipy.signal.windows.triang(m), rtol=1e-15, atol=0)


@pytest.mark.parametrize("t,a,b", [(100, 2.0, 18.0), (50, 1.5, 10.0)])
def test_beta_threshold_probs_bit_identical(t, a, b):
    assert np.array_equal(Y._beta_threshold_probs(t, a, b), jax_yin._beta_threshold_probs(t, a, b))


# ---------------------------------------------------------------------------
# CMNDF
# ---------------------------------------------------------------------------


def test_cmndf_matches_direct():
    """librosa's difference function written out directly (tests/test_yin.py)."""
    rng = np.random.default_rng(20260816)
    n, max_lag = 512, 200
    w = n - max_lag - 1
    x = rng.standard_normal(n)
    c = np.array([np.sum(x[: w + 1] * x[tau : tau + w + 1]) for tau in range(max_lag + 1)])
    e = np.array([np.sum(x[tau + 1 : tau + w + 1] ** 2) for tau in range(max_lag + 1)])
    c[np.abs(c) < 1e-6] = 0.0
    e[np.abs(e) < 1e-6] = 0.0
    d = e[0] + e - 2 * c
    cm = np.ones(max_lag + 1)
    for tau in range(1, max_lag + 1):
        cm[tau] = d[tau] / (np.mean(d[1 : tau + 1]) + np.finfo(np.float64).tiny)
    got = Y.yin_cmndf(torch.tensor(x[None, :]), max_lag)[0].numpy()
    np.testing.assert_allclose(got, cm, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_yin_cmndf_matches_jax(dtype):
    frames = np.random.default_rng(3).standard_normal((3, 4, 700)).astype(dtype)
    for win_length in (None, 400):
        want = np.asarray(jax_yin.yin_cmndf(jnp.asarray(frames), 250, win_length=win_length))
        got = Y.yin_cmndf(torch.tensor(frames), 250, win_length=win_length).numpy()
        assert got.dtype == dtype
        tol = dict(rtol=1e-10, atol=1e-12) if dtype == np.float64 else dict(rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got, want, **tol)
    with pytest.raises(ValueError, match="too short"):
        Y.yin_cmndf(torch.tensor(frames), 250, win_length=500)


GRID = [(10, 64, 17, 500), (7, 50, 12, 301), (25, 100, 30, 800), (100, 1024, 133, 10_000)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("hop,w,ml,n", GRID)
def test_sliding_cmndf_matches_jax_and_framed(dtype, hop, w, ml, n):
    """The frameless form against the JAX one (FFT engine) and against the
    port's own framed yin_cmndf; float32 at tests/test_yin.py's 2e-4/2e-5."""
    x = np.random.default_rng(20260816).standard_normal(n).astype(dtype)
    nf = 1 + (n - (w + ml + 1)) // hop
    got = Y._sliding_cmndf(torch.tensor(x), nf, hop, w, ml).numpy()
    want = np.asarray(jax_yin._sliding_cmndf(jnp.asarray(x), nf, hop, w, ml, engine="fft"))
    framed = Y.yin_cmndf(frame_by_slices(torch.tensor(x), 0, nf, w + ml + 1, hop), ml, win_length=w).numpy()
    tol = dict(rtol=1e-10, atol=1e-12) if dtype == np.float64 else dict(rtol=2e-4, atol=2e-5)
    assert got.shape == want.shape == (nf, ml + 1)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, framed, **tol)
    jax_framed = np.asarray(jax_yin.yin_cmndf(jax_frame_by_slices(jnp.asarray(x), 0, nf, w + ml + 1, hop), ml,
                                              win_length=w))
    np.testing.assert_allclose(framed, jax_framed, **tol)


# ---------------------------------------------------------------------------
# pyin_f0 against the JAX package and the float64 oracle
# ---------------------------------------------------------------------------

KNOBS = dict(fmin=65.0, fmax=500.0, n_thresholds=50, beta_parameters=(1.5, 10.0), boltzmann_parameter=4,
             resolution=0.2, max_transition_rate=20.0, switch_prob=0.05, no_trough_prob=0.05)
F64_CASES = {
    "default": ("speech", {}),
    "nondefault_knobs": ("speech", KNOBS),
    "uncentered": ("speech", {"center": False}),
    "reflect": ("speech", {"pad_mode": "reflect"}),
    "edge": ("speech", {"pad_mode": "edge"}),
    "linear_ramp": ("live_edges", {"pad_mode": "linear_ramp"}),
    "maximum": ("speech", {"pad_mode": "maximum"}),
    "mean": ("speech", {"pad_mode": "mean"}),
    "median": ("speech", {"pad_mode": "median"}),
    "minimum": ("speech", {"pad_mode": "minimum"}),
    "collision_44k_2048": ("collision", dict(fmin=65.0, fmax=2093.0, frame_length=2048)),
    "collision_44k_2047": ("collision", dict(fmin=65.0, fmax=2093.0, frame_length=2047)),
    # past 1,024 pitch bins (the CUDA kernels' wide layouts): 75-600 Hz at
    # resolution 0.025 (1,441 bins), librosa's C2-C7 at 0.05 (1,201 bins)
    "bins_1441": ("speech_0.5s", {"resolution": 0.025}),
    "bins_1201": ("speech_0.5s", dict(fmin=65.406, fmax=2093.0, resolution=0.05)),
}


def case_signal(kind: str) -> tuple[np.ndarray, int, int]:
    """(signal, sr, hop in samples): 10 ms hops, 512 at 44.1 kHz. 'live_edges'
    is the speech rolled by half a second, so that it starts and ends on
    voiced samples (which 'linear_ramp' ramps towards); 'speech_0.5s' its
    0.5 s from 0.2 s on (the wide trellises decode densely on the CPU)."""
    if kind in ("speech", "live_edges", "speech_0.5s"):
        sig, sr = speechlike_sig()
        if kind == "speech_0.5s":
            return sig[sr // 5 : sr // 5 + sr // 2], sr, 100
        return (np.roll(sig, sr // 2) if kind == "live_edges" else sig), sr, 100
    sig, sr = collision_sig()
    return sig, sr, 512


def assert_ties_certified(got: np.ndarray, want: np.ndarray, voiced: np.ndarray, model: tuple):
    """Decoded states identical, except on unvoiced frames where the model
    has an exact tie: unvoiced observations are equal across bins and the
    transition triangle is symmetric, so paths through an unvoiced stretch
    can score the same, and rounding picks one. Such a path must score what
    the oracle's own path scores under the float64 decode model (a decode
    fault loses whole log factors)."""
    assert got.shape == want.shape
    diff = got != want
    if diff.any():
        assert not (diff & voiced).any(), np.flatnonzero(diff & voiced)
        gap = oracle.viterbi_path_score_np(want, model) - oracle.viterbi_path_score_np(got, model)
        assert abs(gap) <= 1e-9, (np.flatnonzero(diff), gap)


@pytest.mark.parametrize("name", F64_CASES)
def test_pyin_float64_matches_jax_and_oracle(name):
    """States and f0 in float64 against JAX (xla Viterbi, fft CMNDF) and
    oracle.pyin_np: identical voicing, f0 to rtol 1e-12 (so identical
    voiced states), the unvoiced states identical up to certified exact
    ties of the decode model (where the JAX package differs from the oracle
    on the same frames)."""
    kind, kw = F64_CASES[name]
    sig, sr, hop = case_signal(kind)
    of0, ov, ostates, model = oracle.pyin_np(sig, sr, hop_length=hop, return_model=True, **kw)
    jf0, jstates = jax_yin.pyin_f0(jnp.asarray(sig), sr=float(sr), hop=hop / sr, viterbi_engine="xla",
                                   cmndf_engine="fft", return_states=True, **kw)
    f0, states = pyin_f0(torch.tensor(sig), sr=float(sr), hop=hop / sr, return_states=True, **kw)
    assert f0.dtype == torch.float64 and states.dtype == torch.int32
    f0, states = f0.numpy(), states.numpy()
    assert f0.shape == of0.shape
    np.testing.assert_array_equal(f0 > 0, ov)
    np.testing.assert_allclose(f0[ov], of0[ov], rtol=1e-12)
    np.testing.assert_allclose(f0, np.asarray(jf0), rtol=1e-12, atol=0)
    assert_ties_certified(states, ostates, ov, model)
    assert_ties_certified(states, np.asarray(jstates), ov, model)
    assert 0.05 < ov.mean() < 0.98


def bin_shift_certified(sig, sr, hop, states, ostates, **kw) -> bool:
    """Every differing state matches a decode of the oracle with the bin
    rounding boundary moved by ±3e-3 bins (a057e05): the float32 candidate
    sat on a .5 boundary and rounded the other way."""
    flips = np.flatnonzero(states != ostates)
    cert = np.zeros(len(flips), dtype=bool)
    for delta in (-3e-3, 3e-3):
        shifted = oracle.pyin_np(sig, sr, hop_length=hop, bin_shift=delta, **kw)[2]
        cert |= shifted[flips] == states[flips]
    return bool(cert.all())


F32_CASES = {
    "speech_10k": lambda: (speechlike_sig(), {}),
    "speech_16k": lambda: ((speech(2.0, 16_000, seed=3).astype(np.float64), 16_000), {}),
    "nondefault_knobs": lambda: (speechlike_sig(), KNOBS),
}


@pytest.mark.parametrize("name", F32_CASES)
def test_pyin_float32_matches_oracle(name):
    """The production type (extract_f0 casts to float32) against the float64
    oracle: identical voicing, f0 to rtol 1e-5 on frames of the same bin; a
    voiced frame of another bin is accepted only when every differing frame
    is certified at a rounding boundary, and unvoiced-only differences only
    as exact ties."""
    (sig, sr), kw = F32_CASES[name]()
    hop = int(round(0.01 * sr))
    of0, ov, ostates, model = oracle.pyin_np(sig, sr, hop_length=hop, return_model=True, **kw)
    f0, states = pyin_f0(torch.tensor(sig, dtype=torch.float32), sr=float(sr), return_states=True, **kw)
    f0, states = f0.numpy(), states.numpy()
    assert f0.dtype == np.float32
    np.testing.assert_array_equal(f0 > 0, ov)
    same = states == ostates
    np.testing.assert_allclose(f0[ov & same], of0[ov & same], rtol=1e-5)
    if (ov & ~same).any():
        assert bin_shift_certified(sig, sr, hop, states, ostates, **kw)
    else:
        assert_ties_certified(states, ostates, ov, model)


@pytest.mark.parametrize("n", [1, 6, 7])
@pytest.mark.parametrize("mode", Y.PAD_MODES)
def test_pad_signal_matches_np_pad(mode, n):
    """_pad_signal is np.pad over the last axis for every mode, on rows
    shorter and longer than the pad, odd and even (the median of an even row
    is the mean of its middle pair), in float64 (to a few ulps of the row's
    scale: np.mean's pairwise sum and torch's differ in order) and in
    float32; jnp.pad agrees to the same bar."""
    x = np.random.default_rng(n).standard_normal((3, n)) + 0.5
    want = np.pad(x, ((0, 0), (4, 4)), mode=mode)
    got = Y._pad_signal(torch.tensor(x), 4, mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-16)
    np.testing.assert_allclose(np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (4, 4)), mode=mode)), want,
                               rtol=0, atol=4e-16)
    x32 = x.astype(np.float32)
    got32 = Y._pad_signal(torch.tensor(x32), 4, mode)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.pad(x32, ((0, 0), (4, 4)), mode=mode), rtol=0, atol=4e-7)


def test_pyin_batch_rows_and_options():
    """A [2, n] batch equals its rows; unknown engines and pad modes raise;
    'plain' is the CPU's 'auto'."""
    sig, sr = speechlike_sig()
    x = torch.tensor(np.stack([sig, sig[::-1].copy()]), dtype=torch.float32)
    got, states = pyin_f0(x, sr=float(sr), return_states=True)
    for i in range(2):
        row, row_states = pyin_f0(x[i], sr=float(sr), return_states=True)
        assert torch.equal(got[i], row) and torch.equal(states[i], row_states)
    assert torch.equal(pyin_f0(x, sr=float(sr), viterbi_engine="plain"), got)
    with pytest.raises(ValueError, match="viterbi_engine"):
        pyin_f0(x, sr=float(sr), viterbi_engine="pallas_full")
    with pytest.raises(ValueError, match="pad_mode"):
        pyin_f0(x, sr=float(sr), pad_mode="empty")
    with pytest.raises(ValueError, match="empty lag band"):
        pyin_f0(x, sr=float(sr), frame_length=32)
    with pytest.raises(ValueError, match="float32 or float64"):
        pyin_f0(x.half(), sr=float(sr))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

CHAINS = {
    "interp_iir": {},
    "raw": dict(interpUnvoiced=None, outFilter=None),
    "minmaxquant_first_pass_only": dict(minMaxQuant=(0.05, 0.95)),
    "minmaxquant_second_pass": dict(minMaxQuant=(0.3, 0.9)),
    "fill_zero": dict(pyinfill_na=0.0, interpUnvoiced=None, outFilter=None),
    "pchip": dict(interpUnvoiced="pchip"),
}


@pytest.mark.parametrize("name", CHAINS)
def test_extract_f0_pyin_matches_jax(name):
    """The chain in float64 after the float32 tracker, against the JAX
    extract_f0: the same NaN pattern (fill_na), the minMaxQuant second pass
    (quantiles over the non-NaN values, unvoiced zeros included), linear or
    pchip interpolation and the 12 Hz 'iir' filter. Both trackers' f0 values
    are fmin·2^(bin/120) in float32, which two pow implementations round
    apart by an ulp: rtol 1e-6, 1e-3 Hz after the filter."""
    sig, sr = speechlike_sig()
    cfg = dict(method="pyin", **CHAINS[name])
    want, want_t = jax_extract_f0(sig, sr, JaxF0Config(**cfg))
    got, t = extract_f0(sig, sr, F0Config(**cfg), device="cpu")
    got = got.numpy()
    assert got.dtype == np.float64 and np.array_equal(t, want_t)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3, equal_nan=True)


def test_extract_f0_pyin_matches_golden(speechlike):
    y, sr = speechlike
    f0, t = extract_f0(y, sr, F0Config(method="pyin", outFilter=None, interpUnvoiced=None), device="cpu")
    want = np.load(f"{GOLDEN_DIR}/f0_pyin.npz")
    np.testing.assert_allclose(t, want["t"], rtol=0, atol=0.05)
    np.testing.assert_allclose(f0.numpy(), want["f0"], rtol=0, atol=0.05, equal_nan=True)


def test_batched_f0_pyin_matches_jax():
    """A padded batch of unequal lengths: identical validity, identical
    voicing and f0 to float32 rounding on the valid frames."""
    sr = 10_000
    signals = [speech(2.0, sr, seed=1), speech(1.5, sr, seed=2, f0=170.0), speech(2.2, sr, seed=6)]
    cfg = F0Config(method="pyin")
    want_f0, want_valid = jax_batched_f0(jax_pad_batch(signals), float(sr), JaxF0Config(method="pyin"))
    got_f0, got_valid = batched_f0(pad_batch(signals, device="cpu"), float(sr), cfg)
    want_f0 = np.asarray(want_f0)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_f0.numpy() > 0, want_f0 > 0)
    np.testing.assert_allclose(got_f0.numpy(), want_f0, rtol=1e-6, atol=0)
    assert not got_f0[~got_valid].any()
    before = dict(V.LAUNCHES)
    plain, _ = batched_f0(pad_batch(signals, device="cpu"), float(sr), cfg, viterbi_engine="plain")
    assert torch.equal(plain, got_f0) and V.LAUNCHES == before


def jax_pyin_arrays(cfg: F0Config, sr: float) -> dict:
    """The decoder's host arrays as the JAX package's _pyin_f0_jit builds them."""
    hop_length = max(1, int(round(cfg.hopSize * sr)))
    nbps = int(np.ceil(1.0 / cfg.resolution))
    n_bins = int(np.floor(12.0 * nbps * np.log2(cfg.maxPitch / cfg.minPitch))) + 1
    p_init = np.zeros(2 * n_bins)
    p_init[n_bins:] = 1.0 / n_bins
    a, b = cfg.beta_parameters
    return {
        "transition": jax_yin._transition_local(n_bins, cfg.max_transition_rate * 12.0 * nbps * hop_length / sr),
        "beta_probs": jax_yin._beta_threshold_probs(cfg.n_thresholds, float(a), float(b)),
        "thresholds": np.linspace(0, 1, cfg.n_thresholds + 1)[1:],
        "p_init": p_init,
    }


@pytest.mark.parametrize("sr,kw", [(10_000, {}), (16_000, dict(resolution=0.2, n_thresholds=50))])
def test_pyin_params_from_jax(sr, kw):
    """The tracker loaded with the JAX package's constants holds exactly its
    own designs and computes exactly the same tracks; a second-pass pitch
    range designs its own."""
    cfg = F0Config(method="pyin", **kw)
    own = PyinTracker(cfg, sr)
    carried = PyinTracker(cfg, sr)
    carried.load_state_dict(pyin_params_from_jax(jax_pyin_arrays(cfg, float(sr))))
    for k, v in own.state_dict().items():
        assert torch.equal(carried.state_dict()[k], v), k
    assert set(own.state_dict()) == {"log_tri", "beta_probs", "thresholds", "log_p_init"}
    y = torch.tensor(speech(1.0, sr, seed=4))
    assert torch.equal(carried(y), own(y))
    assert torch.equal(own(y, fmin=90.0, fmax=300.0), pyin_f0(y, sr=float(sr), fmin=90.0, fmax=300.0, **kw))
    with pytest.raises(ValueError, match="PitchTracker"):
        PyinTracker(F0Config(), sr)
