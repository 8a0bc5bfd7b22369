"""PyTorch port: the flagship modulation cepstrum end to end against the JAX
package (spectrum='pallas', interpret mode) and the float64 oracle, on the
CPU. Bars: ≤ 1e-5 against JAX (its own fft-vs-pallas gap is 8.9e-7 on
noise), ≤ 1e-4 against the oracle (BASELINE.md)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from modulation_mfcc_tpu.models import modulation as jax_mod
from modulation_mfcc_tpu.models.config import MfccConfig as JaxMfccConfig
from modulation_mfcc_tpu.oracle import get_mfccs_change_np
from modulation_mfcc_tpu.ops import filters as jax_filters
from modulation_mfcc_tpu.ops.spectral import dct_matrix as jax_dct_matrix
from modulation_mfcc_tpu_torch import MfccChange, MfccConfig, extract_mfcc_change, mfcc_change
from modulation_mfcc_tpu_torch.convert import params_from_jax
from modulation_mfcc_tpu_torch.models import modulation as mod
from tests.test_torch_frontend import jax_frontend_weights

torch.set_num_threads(1)

CONFIGS = {
    "10k": dict(signal_sample_rate=10_000),
    "16k": dict(signal_sample_rate=16_000, maxFreq=8000.0),
}


def speechlike(seconds: float, sr: int, seed: int = 20260816) -> np.ndarray:
    """Amplitude-modulated harmonics with a gliding f0, noise and silent
    lead-in/out, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(120.0 + 30.0 * np.sin(2 * np.pi * 2.5 * t)) / sr
    sig = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 6))
    sig = sig * 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t - np.pi / 2)) + 0.01 * rng.standard_normal(len(t))
    sig[: sr // 10] = 0.0
    sig[-sr // 10 :] = 0.0
    return sig.astype(np.float32)


def oracle(y: np.ndarray, cfg: MfccConfig) -> np.ndarray:
    return get_mfccs_change_np(y.astype(np.float64), cfg.signal_sample_rate, max_freq=cfg.maxFreq)[0]


@pytest.fixture(scope="module")
def noise():
    return np.random.default_rng(20260816).standard_normal((2, 40_000)).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_mfcc_change_matches_jax_and_oracle(noise, name):
    """[2, 40000] (801 trajectory frames at 10 kHz ≥ min_len 744: the FIR
    filter route; 501 at 16 kHz: the scan route)."""
    cfg = MfccConfig(**CONFIGS[name])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_mod.mfcc_change(jnp.asarray(noise), JaxMfccConfig(**CONFIGS[name]),
                                              spectrum="pallas"))
    got = mfcc_change(torch.tensor(noise), cfg).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 1 + 40_000 // cfg.hop_length)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for b in range(2):
        np.testing.assert_allclose(got[b], oracle(noise[b], cfg), rtol=0, atol=1e-4)


def test_masked_mfcc_change_matches_jax_and_single_file(noise):
    """frame_lengths + masked_fir=True: the padded batch equals JAX's masked
    route, and each item equals its own single-file result on valid frames."""
    cfg = MfccConfig()
    lengths = np.array([801, 760])
    y = noise.copy()
    y[1, (lengths[1] - 1) * cfg.hop_length + 1 :] = 0.0  # item 1 is shorter
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_mod.mfcc_change(jnp.asarray(y), JaxMfccConfig(), spectrum="pallas",
                                              frame_lengths=jnp.asarray(lengths), masked_fir=True))
    got = mfcc_change(torch.tensor(y), cfg, frame_lengths=torch.tensor(lengths), masked_fir=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[1, lengths[1] :].any()
    n1 = (lengths[1] - 1) * cfg.hop_length + 1
    single = mfcc_change(torch.tensor(y[1:, :n1]), cfg).numpy()[0]
    np.testing.assert_allclose(got[1, : lengths[1]], single, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seconds", [4.0, 2.0], ids=["fir_route", "host_tail_route"])
def test_extract_mfcc_change_matches_jax_and_oracle(seconds):
    """One utterance: 4 s (801 frames) takes the masked FIR route, 2 s (401
    frames) the host-scipy tail. The port runs the exact length where JAX
    pads to a 16384-sample bucket; valid frames agree."""
    cfg = MfccConfig()
    y = speechlike(seconds, cfg.signal_sample_rate)
    route_fir = 1 + len(y) // cfg.hop_length >= mod.min_frames_for_fir(cfg)
    assert route_fir == (seconds == 4.0)
    with pltpu.force_tpu_interpret_mode():
        want, want_t = jax_mod.extract_mfcc_change(y, JaxMfccConfig(), spectrum="pallas")
    got, t = extract_mfcc_change(y, cfg, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (len(t),)
    assert np.array_equal(t, want_t) and np.array_equal(t, mod.change_times(len(y), cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), oracle(y, cfg), rtol=0, atol=1e-4)


def test_extract_mfcc_matrix_matches_jax(noise):
    """On noise, as the JAX frontend tests measure: in quiet frames f32
    cancellation in bins near the top_db floor costs both packages up to
    9e-4 against the float64 oracle."""
    cfg = MfccConfig(**CONFIGS["16k"])
    y = noise[0, :24_000]
    with pltpu.force_tpu_interpret_mode():
        want_t, want = jax_mod.extract_mfcc_matrix(y, JaxMfccConfig(**CONFIGS["16k"]), spectrum="pallas")
    t, got = mod.extract_mfcc_matrix(y, cfg, device="cpu")
    assert np.array_equal(t, want_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_spectra_agree(noise):
    """'fused', 'fft' and 'matmul' give the same MFCC to f32 rounding."""
    cfg = MfccConfig()
    y = torch.tensor(noise)
    ms = {s: mod.mfcc_trajectories(y, cfg, spectrum=s, coef_major=True) for s in mod.SPECTRA}
    for s in ("fft", "matmul"):
        np.testing.assert_allclose(ms[s].numpy(), ms["fused"].numpy(), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="spectrum"):
        mod.mfcc_trajectories(y, cfg, spectrum="pallas")


def jax_constants(cfg: MfccConfig) -> dict:
    """The slice's constants as the JAX package's own host code makes them."""
    wri, melw = jax_frontend_weights(cfg)
    fs = 1.0 / cfg.tStep
    arrays = {"wri": wri, "melw": melw, "dct": jax_dct_matrix(cfg.n_mfcc, cfg.n_mels)}
    for prefix, order, cut in (("traj", cfg.filtOrd, cfg.filtCutoff), ("out", cfg.outFiltLen, cfg.outFiltCutOff[0])):
        sos, _, padlen = jax_filters.design_butter_sos(order, (cut / (fs / 2.0),), "lowpass")
        d = jax_filters.design_filtfilt_operator(jax_filters._key_of(sos), padlen)
        arrays.update({f"{prefix}_kernel": d.kernel, f"{prefix}_left": d.left, f"{prefix}_right": d.right})
    return arrays


@pytest.mark.parametrize("name", CONFIGS)
def test_params_from_jax_whole_slice(noise, name):
    """The port fed the JAX package's constants computes exactly what it
    computes from its own designs."""
    cfg = MfccConfig(**CONFIGS[name])
    own = MfccChange(cfg)
    carried = MfccChange(cfg)
    carried.load_state_dict(params_from_jax(jax_constants(cfg)))
    y = torch.tensor(noise)
    lengths = torch.tensor([1 + 40_000 // cfg.hop_length] * 2)
    for kw in ({}, dict(frame_lengths=lengths, masked_fir=True)):
        if kw and lengths[0] < mod.min_frames_for_fir(cfg):
            continue
        assert torch.equal(carried(y, **kw), own(y, **kw))


def test_unported_options_raise(noise, tmp_path):
    """Savitzky-Golay (A.5), the 'fir'/'sg' out-filters (A.6), the
    scan-based masked filters (A.7) and the sweep's native loader (A.16)
    are ported, so they run and give finite results of the right shape
    (tests/test_torch_savgol_fir.py holds the filters to JAX and the
    oracle; tests/test_torch_native.py and test_torch_corpus.py the
    loader)."""
    from modulation_mfcc_tpu_torch.parallel.corpus import CorpusSweep, sweep_mfcc_change

    y = torch.tensor(noise)
    for kw in (dict(diffMethod="sg"), dict(outFilter="fir", outFiltLen=31), dict(outFilter="sg", outFiltLen=31)):
        tot = mfcc_change(y, MfccConfig(**kw))
        assert tot.shape == (2, 801) and bool(torch.isfinite(tot).all())
    assert sweep_mfcc_change([], CorpusSweep(str(tmp_path), use_native_loader=True, device="cpu"))["items"] == 0
    tot = mfcc_change(y, MfccConfig(), frame_lengths=torch.tensor([801, 801]))
    np.testing.assert_allclose(tot.numpy(), mfcc_change(y, MfccConfig()).numpy(), rtol=0, atol=1e-5)


def test_host_tail_route_runs_every_out_filter():
    """Short files take the host-scipy tail, which has every out-filter."""
    cfg = MfccConfig(outFilter="fir", outFiltLen=31)
    y = speechlike(2.0, cfg.signal_sample_rate)
    got, _ = extract_mfcc_change(y, cfg, device="cpu")
    want = get_mfccs_change_np(y.astype(np.float64), cfg.signal_sample_rate, out_filter="fir", out_filt_len=31)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name, kw, seconds, jax_spectrum", [
    ("16k, 256 mel bands, 40 MFCCs", dict(signal_sample_rate=16_000, maxFreq=8000.0, n_mels=256, n_mfcc=40), 2.5,
     "pallas"),
    ("44.1k, n_fft 2048", dict(signal_sample_rate=44_100, n_fft=2048), 1.0, "fft"),
])
def test_mfcc_change_matches_jax_at_other_widths_and_rates(name, kw, seconds, jax_spectrum):
    """The widths and rates the fused kernels now take (past 128 mel bands
    and 32 MFCCs; hop 220 and a 1102-sample window at 44.1 kHz) against
    JAX at the 1e-5 of test_mfcc_change_matches_jax_and_oracle: its 'pallas'
    path, and at 44.1 kHz its default 'fft' path (its Pallas frontend takes
    no hop above 128 that is not a multiple of 128)."""
    cfg = MfccConfig(**kw)
    y = np.random.default_rng(20260816).standard_normal((2, int(seconds * cfg.signal_sample_rate))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_mod.mfcc_change(jnp.asarray(y), JaxMfccConfig(**kw), spectrum=jax_spectrum))
    got = mfcc_change(torch.tensor(y), cfg).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 1 + y.shape[1] // cfg.hop_length)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
