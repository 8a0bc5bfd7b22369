"""PyTorch port: configuration, host designs and the plain MFCC path against
the JAX package (the reference) and the float64 oracle, on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modulation_mfcc_tpu import oracle
from modulation_mfcc_tpu.models.config import MfccConfig as JaxMfccConfig
from modulation_mfcc_tpu.ops import filters as jax_filters
from modulation_mfcc_tpu.ops import framing as jax_framing
from modulation_mfcc_tpu.ops import spectral as jax_spectral
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import _out_design, _traj_design
from modulation_mfcc_tpu_torch.ops import filters, framing, spectral

torch.set_num_threads(1)

# the reference's 10 kHz default (every bin live: packed Nyquist) and the
# 16 kHz flagship (fmax = Nyquist: bins trim to 256)
CONFIGS = {
    "10k": dict(signal_sample_rate=10_000),
    "16k": dict(signal_sample_rate=16_000, maxFreq=8000.0),
}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_jax(name):
    cfg, jcfg = MfccConfig(**CONFIGS[name]), JaxMfccConfig(**CONFIGS[name])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.hop_length, cfg.win_length) == (jcfg.hop_length, jcfg.win_length)


def _assert_operator_equal(got, want):
    assert (got is None) == (want is None)
    for f in ("kernel", "left", "right"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for f in ("K", "E", "W", "min_len"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", CONFIGS)
def test_host_designs_bit_identical(name):
    """Every host-designed constant the port computes from equals the JAX
    package's numpy output bit for bit."""
    cfg = MfccConfig(**CONFIGS[name])
    sr, n_fft, win = cfg.signal_sample_rate, cfg.n_fft, cfg.win_length
    args = (sr, n_fft, cfg.n_mels, cfg.minFreq, cfg.maxFreq)
    assert np.array_equal(spectral.mel_filterbank(*args), jax_spectral.mel_filterbank(*args))
    assert np.array_equal(spectral.dct_matrix(13, 128), jax_spectral.dct_matrix(13, 128))
    for got, want in zip(spectral.dft_bases(n_fft, "hann", win), jax_spectral.dft_bases(n_fft, "hann", win)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(
        spectral.analysis_window(n_fft, "hann", win), jax_spectral.analysis_window(n_fft, "hann", win)
    )
    fs_traj = 1.0 / cfg.tStep
    jax_designs = [
        jax_filters.design_butter_sos(cfg.filtOrd, (cfg.filtCutoff / (fs_traj / 2.0),), "lowpass"),
        jax_filters.design_butter_sos(cfg.outFiltLen, (cfg.outFiltCutOff[0] / (fs_traj / 2.0),), "lowpass"),
    ]
    kind, out = _out_design(cfg)
    assert kind == "iir"
    for (sos, zi, padlen), (jsos, jzi, jpadlen) in zip((_traj_design(cfg), out), jax_designs):
        assert np.array_equal(sos, jsos) and np.array_equal(zi, jzi) and padlen == jpadlen
        _assert_operator_equal(
            filters.design_filtfilt_operator(filters._key_of(sos), padlen),
            jax_filters.design_filtfilt_operator(jax_filters._key_of(jsos), jpadlen),
        )


@pytest.mark.parametrize("n_fft,hop", [(512, 50), (512, 80), (128, 16)])
def test_frame_signal_matches_jax(rng, n_fft, hop):
    x = rng.standard_normal((2, 3001))
    got = framing.frame_signal(torch.tensor(x), n_fft, hop).numpy()
    want = np.asarray(jax_framing.frame_signal(jnp.asarray(x), n_fft, hop))
    assert np.array_equal(got, want)
    assert got.shape[-2] == framing.n_frames_centered(3001, n_fft, hop)


@pytest.mark.parametrize("use_fft", [True, False], ids=["fft", "matmul"])
@pytest.mark.parametrize("name", CONFIGS)
def test_mfcc_from_frames_matches_jax_and_oracle(name, use_fft):
    """The plain spectra ≤ 1e-4 at the MFCC (BASELINE.md's bar) against the
    JAX function and the float64 oracle, on float32 audio."""
    cfg = MfccConfig(**CONFIGS[name])
    y = np.random.default_rng(20260816).standard_normal((2, 24_000)).astype(np.float32)
    kw = dict(sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, win_length=cfg.win_length,
              fmin=cfg.minFreq, fmax=cfg.maxFreq, use_fft=use_fft)
    got = spectral.mfcc_from_frames(
        framing.frame_signal(torch.tensor(y), cfg.n_fft, cfg.hop_length), **kw
    ).numpy()
    want = np.asarray(jax_spectral.mfcc_from_frames(
        jax_framing.frame_signal(jnp.asarray(y), cfg.n_fft, cfg.hop_length), **kw
    ))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for b in range(2):
        ref = oracle.mfcc_np(
            y[b].astype(np.float64), cfg.signal_sample_rate, win_length=cfg.win_length,
            hop_length=cfg.hop_length, fmin=cfg.minFreq, fmax=cfg.maxFreq,
        ).T
        np.testing.assert_allclose(got[b], ref, atol=1e-4, rtol=0)


def test_power_to_db_mask_matches_jax(rng):
    """A mask keeps padded frames out of the per-utterance top_db peak."""
    s = rng.uniform(0.0, 10.0, (2, 50, 8)) ** 4
    s[1, 30:] *= 1e6  # loud padding that must not raise the clip
    mask = np.ones((2, 50, 1))
    mask[1, 30:] = 0.0
    got = spectral.power_to_db(torch.tensor(s), mask=torch.tensor(mask)).numpy()
    want = np.asarray(jax_spectral.power_to_db(jnp.asarray(s), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
