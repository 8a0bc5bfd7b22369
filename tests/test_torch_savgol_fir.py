"""PyTorch port: Savitzky-Golay, the FIR and SG filters of applyFilter, their
length-masked forms, and the modulation cepstrum's diffMethod='sg' and
'fir'/'sg' out-filters, against the JAX package and scipy (float64, ≤ 1e-8,
the bars of tests/test_filters.py and tests/test_masked.py) and, end to
end, against JAX (≤ 1e-5) and the float64 oracle (≤ 1e-4)."""
import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from modulation_mfcc_tpu.models import modulation as jax_mod
from modulation_mfcc_tpu.models.config import MfccConfig as JaxMfccConfig
from modulation_mfcc_tpu.oracle import get_mfccs_change_np
from modulation_mfcc_tpu.ops import filters as jax_filters
from modulation_mfcc_tpu.ops import masked as jax_masked
from modulation_mfcc_tpu.ops.savgol import savgol_filter_jax
from modulation_mfcc_tpu_torch import MfccConfig, extract_mfcc_change, mfcc_change, pad_batch
from modulation_mfcc_tpu_torch.models import modulation as mod
from modulation_mfcc_tpu_torch.ops import filters
from modulation_mfcc_tpu_torch.ops.masked import masked_filtfilt, masked_savgol
from modulation_mfcc_tpu_torch.ops.savgol import savgol_filter
from modulation_mfcc_tpu_torch.parallel.batch import batched_mfcc_change
from tests.test_torch_modulation import speechlike

torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-9)
# diffMethod='sg', and the 'fir' and 'sg' out-filters (the reference's applyFilter lengths)
OPTIONS = {
    "sg_diff": dict(diffMethod="sg"),
    "fir_out": dict(outFilter="fir", outFiltLen=31),
    "sg_out": dict(outFilter="sg", outFiltLen=31, outFiltPolyOrd=3),
}


def oracle_kw(opts: dict) -> dict:
    return dict(diff_method=opts.get("diffMethod", "grad"), out_filter=opts.get("outFilter", "iir"),
                out_filt_len=opts.get("outFiltLen", 6), out_filt_poly_ord=opts.get("outFiltPolyOrd", 3))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("win,poly,deriv", [(9, 3, 0), (3, 2, 1), (7, 2, 2), (11, 4, 1)])
def test_savgol_matches_jax_and_scipy(rng, win, poly, deriv):
    x = rng.standard_normal((5, 200))
    got = savgol_filter(torch.tensor(x), win, poly, deriv=deriv).numpy()
    np.testing.assert_allclose(got, sps.savgol_filter(x, win, poly, deriv=deriv, axis=-1, mode="interp"), **TOL)
    np.testing.assert_allclose(got, np.asarray(savgol_filter_jax(jnp.asarray(x), win, poly, deriv=deriv)), **TOL)
    with pytest.raises(ValueError, match="window_length"):
        savgol_filter(torch.tensor(x[:, : win - 1]), win, poly)


@pytest.mark.parametrize("numtaps,wn,pass_zero", [(6, (0.2,), "lowpass"), (31, (0.12,), "lowpass"),
                                                  (101, (0.1,), "lowpass"), (31, (0.1, 0.3), "bandpass")])
def test_filtfilt_matches_jax_and_scipy(rng, numtaps, wn, pass_zero):
    """The parallel transversal filtfilt; 101 taps reach the blocked Toeplitz
    correlation."""
    x = rng.standard_normal((3, 700))
    b, zi, padlen = filters.design_firwin(numtaps, wn, pass_zero)
    jb, jzi, jpad = jax_filters.design_firwin(numtaps, wn, pass_zero)
    assert np.array_equal(b, jb) and np.array_equal(zi, jzi) and padlen == jpad
    got = filters.filtfilt(b, zi, padlen, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, sps.filtfilt(b, 1.0, x, axis=-1), **TOL)
    want = np.asarray(jax_filters.filtfilt(jb, np.array([1.0]), jzi, jpad, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("filt,cut_off,filt_type,filt_len", [
    ("fir", (12.0,), "low", 31), ("fir", (20.0,), "high", 31), ("fir", (5.0, 30.0), "band", 41),
    ("sg", (12.0,), "low", 31), ("sg", (None,), "low", 9),
])
def test_apply_filter_fir_sg(rng, filt, cut_off, filt_type, filt_len):
    """applyFilter's 'fir' (Kaiser firwin filtfilt) and 'sg' branches."""
    x = rng.standard_normal((2, 1500))
    kw = dict(filt=filt, cut_off=cut_off, filt_len=filt_len, filt_type=filt_type, poly_ord=3)
    got = filters.apply_filter(torch.tensor(x), 200.0, **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_filters.apply_filter(jnp.asarray(x), 200.0, **kw)), **TOL)
    if filt == "sg":
        want = sps.savgol_filter(x, filt_len, 3, axis=-1, mode="interp")
    else:
        btype = filters.resolve_filt_type(filt_type)
        wn = np.asarray(cut_off) / 100.0
        b = sps.firwin(filt_len, wn if wn.size > 1 else wn[0], window=("kaiser", 7.4), pass_zero=btype)
        want = sps.filtfilt(b, 1.0, x, axis=-1)
    np.testing.assert_allclose(got, want, **TOL)


def test_apply_filter_validation():
    """JAX's validation: 'sg' skips the cutoff checks but takes exactly one
    cutoff; 'fir' checks them as 'iir' does."""
    x = torch.zeros(2, 300, dtype=torch.float64)
    filters.apply_filter(x, 200.0, filt="sg", cut_off=(150.0,), filt_len=9)  # beyond Nyquist: unchecked
    with pytest.raises(ValueError, match="one cutOff"):
        filters.apply_filter(x, 200.0, filt="sg", cut_off=(5.0, 30.0), filt_len=9)
    with pytest.raises(ValueError, match="half of the"):
        filters.apply_filter(x, 200.0, filt="fir", cut_off=(150.0,), filt_len=31)
    with pytest.raises(ValueError, match="cutOff\\[0\\]<cutOff\\[1\\]"):
        filters.apply_filter(x, 200.0, filt="fir", cut_off=(30.0, 5.0), filt_len=31, filt_type="band")
    with pytest.raises(ValueError, match="cut Off"):
        filters.apply_filter(x, 200.0, filt="fir", cut_off=(None,), filt_len=31)
    with pytest.raises(ValueError, match="Unknown filter"):
        filters.apply_filter(x, 200.0, filt="median", cut_off=(12.0,))


@pytest.mark.parametrize("L", [50, 64, 99, 100])
def test_masked_filtfilt_matches_jax_and_scipy(rng, L):
    x = rng.standard_normal((2, 100))
    buf = np.zeros((2, 100))
    buf[:, :L] = x[:, :L]
    b, zi, padlen = filters.design_firwin(6, (0.2,), "lowpass")
    got = masked_filtfilt(b, zi, padlen, torch.tensor(buf), torch.tensor(L)).numpy()
    np.testing.assert_allclose(got[:, :L], sps.filtfilt(b, 1.0, x[:, :L], axis=-1), **TOL)
    assert not got[:, L:].any()
    want = np.asarray(jax_masked.masked_filtfilt(b, np.array([1.0]), zi, padlen, jnp.asarray(buf), L))
    np.testing.assert_allclose(got[:, :L], want[:, :L], **TOL)


@pytest.mark.parametrize("w,p,d,L", [(3, 2, 1, 60), (7, 3, 0, 80), (11, 4, 2, 95)])
def test_masked_savgol_matches_jax_and_scipy(rng, w, p, d, L):
    x = rng.standard_normal(100)
    buf = np.zeros(100)
    buf[:L] = x[:L]
    got = masked_savgol(torch.tensor(buf), w, p, torch.tensor(L), deriv=d).numpy()
    np.testing.assert_allclose(got[:L], sps.savgol_filter(x[:L], w, p, deriv=d, mode="interp"), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_masked.masked_savgol(jnp.asarray(buf), w, p, L, deriv=d)), **TOL)


def test_masked_forms_per_item_lengths(rng):
    """A batch of trajectories [B, C, T] with lengths [B, 1]: each item
    equals its own unmasked result on its valid frames."""
    x = rng.standard_normal((3, 4, 120))
    lengths = np.array([120, 90, 61])
    for i, n in enumerate(lengths):
        x[i, :, n:] = 0.0
    b, zi, padlen = filters.design_firwin(6, (0.2,), "lowpass")
    got_f = masked_filtfilt(b, zi, padlen, torch.tensor(x), torch.tensor(lengths)[:, None]).numpy()
    got_s = masked_savgol(torch.tensor(x), 3, 2, torch.tensor(lengths)[:, None], deriv=1).numpy()
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got_f[i, :, :n], sps.filtfilt(b, 1.0, x[i, :, :n], axis=-1), **TOL)
        np.testing.assert_allclose(got_s[i, :, :n], sps.savgol_filter(x[i, :, :n], 3, 2, deriv=1, mode="interp"),
                                   **TOL)


@pytest.fixture(scope="module")
def noise():
    return np.random.default_rng(20260816).standard_normal((2, 40_000)).astype(np.float32)


@pytest.mark.parametrize("option", OPTIONS)
def test_mfcc_change_options_match_jax_and_oracle(noise, option):
    """[2, 40000] at 10 kHz (801 trajectory frames), unmasked: ≤ 1e-5
    against JAX's Pallas path, ≤ 1e-4 against the float64 oracle. JAX's
    'fir' out-filter runs float64 input only under the tests' x64 mode (its
    scan multiplies the float32 carry by a float64 numpy tap), so that
    option is compared on both packages' fft paths in float64."""
    cfg = MfccConfig(**OPTIONS[option])
    jcfg = JaxMfccConfig(**OPTIONS[option])
    got = mfcc_change(torch.tensor(noise), cfg).numpy()
    if option == "fir_out":
        x64 = noise.astype(np.float64)
        want = np.asarray(jax_mod.mfcc_change(jnp.asarray(x64), jcfg, spectrum="fft"))
        got64 = mfcc_change(torch.tensor(x64), cfg, spectrum="fft").numpy()
        np.testing.assert_allclose(got64, want, rtol=0, atol=1e-5)
    else:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_mod.mfcc_change(jnp.asarray(noise), jcfg, spectrum="pallas"))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.shape == want.shape == (2, 801)
    for b in range(2):
        ref = get_mfccs_change_np(noise[b].astype(np.float64), 10_000, **oracle_kw(OPTIONS[option]))[0]
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("option", OPTIONS)
def test_extract_mfcc_change_options_match_jax_and_oracle(option):
    """One 4 s utterance: diffMethod='sg' takes the masked FIR route (and
    masked_savgol), the 'fir'/'sg' out-filters the host-scipy tail, in both
    packages."""
    cfg = MfccConfig(**OPTIONS[option])
    y = speechlike(4.0, cfg.signal_sample_rate)
    assert (mod.min_frames_for_fir(cfg) is not None) == (option == "sg_diff")
    with pltpu.force_tpu_interpret_mode():
        want, want_t = jax_mod.extract_mfcc_change(y, JaxMfccConfig(**OPTIONS[option]), spectrum="pallas")
    got, t = extract_mfcc_change(y, cfg, device="cpu")
    assert np.array_equal(t, want_t) and got.shape == (len(t),)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    ref = get_mfccs_change_np(y.astype(np.float64), 10_000, **oracle_kw(OPTIONS[option]))[0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("option", OPTIONS)
def test_batched_options_equal_per_file(option):
    """batched_mfcc_change (scan filters, masked_savgol / masked_filtfilt)
    equals each utterance's extract_mfcc_change on its valid frames; the
    masked FIR route agrees too where it applies."""
    cfg = MfccConfig(**OPTIONS[option])
    sigs = [speechlike(s, cfg.signal_sample_rate, seed=i) for i, s in enumerate((4.0, 3.1, 2.2))]
    batch = pad_batch(sigs, device="cpu")
    tot, mask = batched_mfcc_change(batch, cfg)
    fir_ok = mod.min_frames_for_fir(cfg) is not None
    if fir_ok:
        nf = 1 + batch.lengths // cfg.hop_length
        tot_fir = mfcc_change(batch.samples[:1], cfg, frame_lengths=nf[:1], masked_fir=True)
    for i, y in enumerate(sigs):
        single, _ = extract_mfcc_change(y, cfg, device="cpu")
        nf_i = single.shape[0]
        assert float(mask[i].sum()) == nf_i and not tot[i, nf_i:].any()
        np.testing.assert_allclose(tot[i, :nf_i].numpy(), single.numpy(), rtol=0, atol=1e-5)
        if fir_ok and i == 0:
            np.testing.assert_allclose(tot_fir[0, :nf_i].numpy(), single.numpy(), rtol=0, atol=1e-5)


def test_out_filter_validation():
    """The model validates its out-filter at construction, as applyFilter
    would at the end of the pipeline."""
    with pytest.raises(ValueError, match="half of the"):
        mod.MfccChange(MfccConfig(outFilter="fir", outFiltCutOff=(150.0,), outFiltLen=31))
    with pytest.raises(ValueError, match="one cutOff"):
        mod.MfccChange(MfccConfig(outFilter="sg", outFiltCutOff=(5.0, 30.0), outFiltLen=31))
    with pytest.raises(ValueError, match="Unknown outFilter"):
        mod.MfccChange(MfccConfig(outFilter="median"))
    model = mod.MfccChange(MfccConfig(outFilter="fir", outFiltLen=31))
    assert model.out_filter is None and len(model.out_fir[0]) == 31
