"""PyTorch port: trajectory filters, masked edge variants and the gradient,
in float64, against the JAX functions and scipy/numpy (≤ 1e-8)."""
import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax
import jax.numpy as jnp

from modulation_mfcc_tpu.ops import derivatives as jax_deriv
from modulation_mfcc_tpu.ops import filters as jax_filters
from modulation_mfcc_tpu.ops import masked as jax_masked
from modulation_mfcc_tpu_torch.ops import filters
from modulation_mfcc_tpu_torch.ops.derivatives import np_gradient
from modulation_mfcc_tpu_torch.ops.masked import masked_gradient, masked_sosfiltfilt_fir

torch.set_num_threads(1)

TOL = dict(rtol=0, atol=1e-8)
# the flagship's 12 Hz order-6 Butterworth at the 200 Hz trajectory rate
SOS, ZI, PADLEN = filters.design_butter_sos(6, (0.12,), "lowpass")
DESIGN = filters.design_filtfilt_operator(filters._key_of(SOS), PADLEN)


def test_operator_geometry():
    assert (DESIGN.K, DESIGN.E, DESIGN.W, DESIGN.min_len, DESIGN.kernel.shape[0]) == (241, 262, 744, 744, 483)


@pytest.mark.parametrize("t", [DESIGN.min_len, 1500], ids=["min_len", "long"])
def test_sosfiltfilt_fir_branch(rng, t):
    x = rng.standard_normal((2, 12, t))
    got = filters.sosfiltfilt(SOS, ZI, PADLEN, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, sps.sosfiltfilt(SOS, x, axis=-1), **TOL)
    want = np.asarray(jax_filters.sosfiltfilt(SOS, ZI, PADLEN, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_sosfiltfilt_scan_branch(rng):
    """Shorter than min_len: scipy's construction, step by step."""
    x = rng.standard_normal((3, 200))
    got = filters.sosfiltfilt(SOS, ZI, PADLEN, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, sps.sosfiltfilt(SOS, x, axis=-1), **TOL)
    want = np.asarray(jax_filters.sosfiltfilt_scan(SOS, ZI, PADLEN, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_odd_ext_matches_scipy(rng):
    from scipy.signal._arraytools import odd_ext

    x = rng.standard_normal((2, 40))
    np.testing.assert_array_equal(filters.odd_ext(torch.tensor(x), 7).numpy(), odd_ext(x, 7, axis=-1))


@pytest.mark.parametrize("klen,t", [(483, 1200), (31, 500)], ids=["toeplitz", "short"])
def test_conv_valid_lastaxis(rng, klen, t):
    """Both branches (blocked Toeplitz matmul, unfolded windows) are the
    valid cross-correlation."""
    x = rng.standard_normal((3, t))
    k = rng.standard_normal(klen)
    got = filters._conv_valid_lastaxis(torch.tensor(x), k).numpy()
    want = np.stack([np.correlate(row, k, mode="valid") for row in x])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_masked_sosfiltfilt_fir(rng):
    """Each item's edges are anchored at its own length: equal to scipy on
    the valid prefix, zero beyond, and to the JAX masked filter."""
    t_buf = 1024
    lengths = np.array([DESIGN.min_len, 900, t_buf])
    x = rng.standard_normal((3, 4, t_buf))
    for b, n in enumerate(lengths):
        x[b, :, n:] = rng.standard_normal((4, t_buf - n)) * 100.0  # junk past the end
    got = masked_sosfiltfilt_fir(DESIGN, torch.tensor(x), torch.tensor(lengths)[:, None]).numpy()
    want = np.asarray(jax.vmap(lambda v, n: jax_masked.masked_sosfiltfilt_fir(DESIGN, v, n))(
        jnp.asarray(x), jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, **TOL)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :, :n], sps.sosfiltfilt(SOS, x[b, :, :n], axis=-1), **TOL)
        assert not got[b, :, n:].any()


def test_masked_gradient(rng):
    t_buf = 64
    lengths = np.array([5, 40, 64])
    x = rng.standard_normal((3, t_buf))
    got = masked_gradient(torch.tensor(x), torch.tensor(lengths)).numpy()
    want = np.asarray(jax.vmap(jax_masked.masked_gradient)(jnp.asarray(x), jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, **TOL)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], np.gradient(x[b, :n]), **TOL)
        assert not got[b, n:].any()


def test_np_gradient(rng):
    x = rng.standard_normal((2, 3, 50))
    got = np_gradient(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.gradient(x, axis=-1), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_deriv.np_gradient(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("cut_off,filt_type", [((12.0,), "low"), ((5.0, 30.0), "band"), ((20.0,), "high")])
def test_apply_filter_iir(rng, cut_off, filt_type):
    x = rng.standard_normal((2, 1500))
    got = filters.apply_filter(torch.tensor(x), 200.0, filt="iir", cut_off=cut_off, filt_len=4,
                               filt_type=filt_type).numpy()
    want = np.asarray(jax_filters.apply_filter(jnp.asarray(x), 200.0, filt="iir", cut_off=cut_off,
                                               filt_len=4, filt_type=filt_type))
    np.testing.assert_allclose(got, want, **TOL)
    btype = filters.resolve_filt_type(filt_type)
    wn = np.asarray(cut_off) / 100.0
    sos = sps.butter(4, wn if wn.size > 1 else wn[0], btype=btype, output="sos")
    np.testing.assert_allclose(got, sps.sosfiltfilt(sos, x, axis=-1), **TOL)


def test_apply_filter_validation_and_unported_branches():
    x = torch.zeros(2, 300, dtype=torch.float64)
    with pytest.raises(ValueError, match="half of the"):
        filters.apply_filter(x, 200.0, cut_off=(150.0,))
    with pytest.raises(ValueError, match="cut Off"):
        filters.apply_filter(x, 200.0, cut_off=(None,))
    for kind in ("fir", "sg"):  # ported now: a zero signal stays zero
        out = filters.apply_filter(x, 200.0, filt=kind, cut_off=(12.0,), filt_len=31)
        assert out.shape == x.shape and not out.any()
