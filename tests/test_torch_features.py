"""PyTorch port: the analysis workflow's compute modules against the JAX
package on the same seeded inputs, on the CPU: deltas, CMVN and mfcc39
(models/features.py), peaks (ops/peaks.py), the derivatives
(ops/derivatives.py), the EMA reader and its resampler (io/ag50x.py), the
display spectrogram (models/sound.py) and the host helpers they use.

Bars: float64 atol 1e-10 and float32 atol 1e-6 (on unit-scale values) for
the features and the derivatives; peaks exact; the Fornberg stencils
bit-identical; linear_resample float64 atol 1e-12; the spectrogram 1e-4 dB
from JAX within 40 dB of its maximum and 0.01 dB from the float64 oracle
over the display range (80 dB, the JAX package's own bar), the bins below
it dark on both sides."""
import numpy as np
import pytest
import scipy.signal as sps
import torch
from scipy.interpolate import interp1d

import jax.numpy as jnp

from modulation_mfcc_tpu.io import ag50x as jax_ag50x
from modulation_mfcc_tpu.io.wav import write_wav as jax_write_wav
from modulation_mfcc_tpu.models import features as jax_features
from modulation_mfcc_tpu.models.sound import praat_spectrogram as jax_praat_spectrogram
from modulation_mfcc_tpu.oracle import praat_spectrogram_np
from modulation_mfcc_tpu.ops import derivatives as jax_deriv
from modulation_mfcc_tpu.ops import peaks as jax_peaks
from modulation_mfcc_tpu.ops.windows import gaussian as jax_gaussian
from modulation_mfcc_tpu_torch.io import ag50x
from modulation_mfcc_tpu_torch.io.wav import read_wav, write_wav
from modulation_mfcc_tpu_torch.models import features
from modulation_mfcc_tpu_torch.models.sound import load_sound, praat_spectrogram
from modulation_mfcc_tpu_torch.ops import derivatives as deriv
from modulation_mfcc_tpu_torch.ops import peaks
from modulation_mfcc_tpu_torch.ops.windows import gaussian

torch.set_num_threads(1)

SEED = 20260816
ATOL = {np.float64: 1e-10, np.float32: 1e-6}


def _mfcc_like(dtype, shape=(3, 60, 13), scale: float = 1.0):
    """Seeded values, coefficient k of scale ``scale``·(1 − k/13) (unit scale
    by default, where float32's absolute bar is meaningful), and a ragged
    mask (items of 60, 41 and 12 frames)."""
    rng = np.random.default_rng(SEED)
    m = (rng.standard_normal(shape) * scale * np.linspace(1.0, 0.1, shape[-1])).astype(dtype)
    mask = np.zeros(shape[:2], np.float32)
    for b, n in enumerate((60, 41, 12)[: shape[0]]):
        mask[b, :n] = 1.0
    return m, mask


def _close(got: torch.Tensor, want, dtype) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_delta_cmvn_mfcc_with_deltas_match_jax(dtype, masked):
    m, mask = _mfcc_like(dtype)
    fm = mask if masked else None
    jm, jfm = jnp.asarray(m), (None if fm is None else jnp.asarray(fm))
    tm, tfm = torch.from_numpy(m), (None if fm is None else torch.from_numpy(fm))
    for order in (1, 2):
        _close(features.delta(tm, order=order), jax_features.delta(jm, order=order), dtype)
    _close(features.delta(tm.transpose(-1, -2), axis=-1), jax_features.delta(jm.swapaxes(-1, -2), axis=-1), dtype)
    for variance in (True, False):
        _close(features.cmvn(tm, frame_mask=tfm, variance=variance),
               jax_features.cmvn(jm, frame_mask=jfm, variance=variance), dtype)
    for normalize in (False, True):
        got = features.mfcc_with_deltas(tm, frame_mask=tfm, normalize=normalize)
        _close(got, jax_features.mfcc_with_deltas(jm, frame_mask=jfm, normalize=normalize), dtype)
        assert got.shape == (3, 60, 39)
        if masked:
            assert not got.numpy()[mask == 0].any()


def test_mfcc_with_deltas_at_mfcc_scale_f32():
    """float32 at the MFCC's own scale (coefficients up to 60): within
    1e-6 of the largest magnitude, i.e. a few ulps, of JAX."""
    m, mask = _mfcc_like(np.float32, scale=20.0)
    for fm in (None, mask):
        got = features.mfcc_with_deltas(torch.from_numpy(m), frame_mask=None if fm is None else torch.from_numpy(fm))
        jfm = None if fm is None else jnp.asarray(fm)
        want = np.asarray(jax_features.mfcc_with_deltas(jnp.asarray(m), frame_mask=jfm))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_delta_is_librosa_and_cmvn_normalizes_valid_frames():
    """The JAX tests' bars (tests/test_features.py): delta equals scipy's
    savgol_filter; masked CMVN gives each item mean 0 (1e-6) and std 1
    (1e-4) over its valid frames and equals the per-item normalization of
    its valid slice (1e-5)."""
    m, mask = _mfcc_like(np.float64, scale=20.0)
    got = features.delta(torch.from_numpy(m[0])).numpy()
    np.testing.assert_allclose(got, sps.savgol_filter(m[0], 9, 1, deriv=1, axis=0, mode="interp"), atol=1e-8)
    out = features.cmvn(torch.from_numpy(m), frame_mask=torch.from_numpy(mask)).numpy()
    v = out[1, :41]
    np.testing.assert_allclose(v.mean(axis=0), 0.0, atol=1e-6)
    np.testing.assert_allclose(v.std(axis=0), 1.0, atol=1e-4)
    direct = (m[1, :41] - m[1, :41].mean(0)) / (m[1, :41].std(0) + 1e-8)
    np.testing.assert_allclose(v, direct, atol=1e-5)
    with pytest.raises(ValueError, match="window_length"):
        features.delta(torch.from_numpy(m[2, :8]))  # 8 frames < width 9: savgol's interp edge


def _peak_rows() -> np.ndarray:
    """Noise rows, a row of plateaus (even and odd widths, at the ends, a
    plateau that only rises, one that falls), and quantized rows full of ties."""
    rng = np.random.default_rng(SEED)
    rows = [rng.standard_normal(40) for _ in range(4)]
    rows.append(np.array([1.0, 1, 0, 1, 1, 1, 0, 2, 2, 0, 3, 0, 0, 1, 1, 2, 2, 2, 2, 1, 5, 5, 0, 4, 4, 4, 4, 4, 4, 3,
                          0, 1, 2, 2, 1, 1, 3, 3, 3, 3]))
    rows += [np.round(rng.standard_normal(40) * 1.5) for _ in range(3)]
    return np.stack(rows)


def test_peak_mask_matches_jax_and_scipy():
    """Row by row against scipy.signal.find_peaks and JAX's peak_mask,
    exactly, on a batch [8, 40], float64 and float32; the JAX package's own
    plateau case (tests/test_ops_misc.py)."""
    y = _peak_rows()
    for dtype in (np.float64, np.float32):
        got = peaks.peak_mask(torch.from_numpy(y.astype(dtype))).numpy()
        assert got.dtype == bool and got.shape == y.shape
        np.testing.assert_array_equal(got, np.asarray(jax_peaks.peak_mask(jnp.asarray(y.astype(dtype)))))
        for row, mask in zip(y.astype(dtype), got):
            np.testing.assert_array_equal(np.flatnonzero(mask), sps.find_peaks(row)[0])
    case = np.array([0.0, 1, 1, 1, 0, 2, 2, 0, 3, 0, 0, 1, 1])
    np.testing.assert_array_equal(peaks.find_peaks_host(case, device="cpu"), sps.find_peaks(case)[0])
    np.testing.assert_array_equal(peaks.find_peaks_host(case, device="cpu"), jax_peaks.find_peaks_host(case))
    assert not peaks.peak_mask(torch.ones((2, 2))).any() and peaks.peak_mask(torch.ones((2, 2))).shape == (2, 2)


def test_peaks_in_interval_matches_jax():
    """Inclusive bounds, the slice taken first (its edges never peaks),
    minima on −y, and empty results for no interval or fewer than 3 samples."""
    t = np.linspace(0, 1, 101)
    y = np.sin(2 * np.pi * 5 * t) + 0.3 * np.sin(2 * np.pi * 13 * t)
    for interval in [(0.2, 0.8), (0.0, 1.0), (0.15, 0.15), (0.3, 0.32), (0.31, 0.33), None]:
        for minima in (False, True):
            got = peaks.peaks_in_interval(t, y, interval, minima=minima, device="cpu")
            want = jax_peaks.peaks_in_interval(t, y, interval, minima=minima)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w))
    pt, _ = peaks.peaks_in_interval(t, y, (0.2, 0.8), device="cpu")
    sel = (t >= 0.2) & (t <= 0.8)
    np.testing.assert_array_equal(pt, t[sel][sps.find_peaks(y[sel])[0]])
    assert len(peaks.peaks_in_interval(t, y, (0.3, 0.32), device="cpu")[0]) == 0  # 3 samples: the slice's edges only


@pytest.mark.parametrize("deriv_order", [1, 2, 3])
@pytest.mark.parametrize("acc", [2, 4, 6])
def test_fornberg_stencils_bit_identical(deriv_order, acc):
    for spacing in (1.0, 0.005, 0.37):
        got = deriv.findiff_stencils(deriv_order, acc, spacing)
        want = jax_deriv.findiff_stencils(deriv_order, acc, spacing)
        assert got[3] == want[3]
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype == np.float64 and np.array_equal(g, w)
    grid = np.array([-1.5, -0.25, 0.0, 0.6, 2.0])
    want = jax_deriv.fornberg_weights(deriv_order, 0.1, grid)
    assert np.array_equal(deriv.fornberg_weights(deriv_order, 0.1, grid), want)


@pytest.mark.parametrize("method", ["gradient", "sg", "finDiff"])
@pytest.mark.parametrize("difference", [1, 2])
def test_velocity_matches_jax(method, difference):
    """velocity (and findiff_apply under it) in float64 at atol 1e-10 (times
    the output's magnitude where that exceeds 1), on a batch [3, 57] at
    sr 1 (the reference's per-sample quirk) and 200 Hz,
    with sg widths 3 and 7 and finDiff accuracies 2 and 4."""
    x = np.random.default_rng(SEED).standard_normal((3, 57)).cumsum(-1)
    for sr in (1.0, 200.0):
        for kw in ({"width": 3, "poly_order": 2, "acc_order": 2}, {"width": 7, "poly_order": 3, "acc_order": 4}):
            got = deriv.velocity(torch.from_numpy(x), sr, difference=difference, method=method, **kw)
            want = np.asarray(jax_deriv.velocity(jnp.asarray(x), sr, difference=difference, method=method, **kw))
            scale = max(1.0, np.abs(want).max())  # finDiff at 200 Hz multiplies by 200² = 4e4
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * scale)
    got = deriv.findiff_apply(torch.from_numpy(x[0]), difference, 0.01, acc=4)
    _close(got, jax_deriv.findiff_apply(jnp.asarray(x[0]), difference, 0.01, acc=4), np.float64)


def test_derivative_errors_keep_their_messages():
    short = np.arange(4.0)
    for fn, mod in ((deriv.findiff_apply, torch.from_numpy), (jax_deriv.findiff_apply, jnp.asarray)):
        with pytest.raises(ValueError, match=r"Signal length 4 too short for stencil \(6\)"):
            fn(mod(short), 2, 1.0, acc=4)
    with pytest.raises(ValueError, match="window_length must be less than or equal"):
        deriv.velocity(torch.from_numpy(short), 1.0, method="sg", width=5)
    with pytest.raises(ValueError) as got:
        deriv.velocity(torch.from_numpy(short), 1.0, method="spline")
    with pytest.raises(ValueError) as want:
        jax_deriv.velocity(jnp.asarray(short), 1.0, method="spline")
    assert str(got.value) == str(want.value) == "Méthode inconnue. Utilisez 'gradient', 'sg' ou 'finDiff'."


def test_linear_resample_matches_jax_and_interp1d():
    """[100, 4, 7] onto a grid that runs past the end (extrapolation) and
    starts before the start, float64 atol 1e-12."""
    rng = np.random.default_rng(SEED)
    src_t = np.linspace(0, 1, 100)
    vals = rng.standard_normal((100, 4, 7))
    dst_t = np.arange(-0.05, 1.2, 0.013)
    got = ag50x.linear_resample(torch.from_numpy(vals), torch.from_numpy(src_t), torch.from_numpy(dst_t)).numpy()
    want = np.asarray(jax_ag50x.linear_resample(jnp.asarray(vals), jnp.asarray(src_t), jnp.asarray(dst_t)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    f = interp1d(src_t, vals, kind="linear", axis=0, fill_value="extrapolate")
    np.testing.assert_allclose(got, f(dst_t), rtol=0, atol=1e-12)


@pytest.mark.parametrize("channels", [8, 16])
def test_ag50x_files_match_jax(tmp_path, channels):
    """The port writes JAX's bytes, and reads a JAX-written file as JAX
    does (the resampling at atol 1e-12)."""
    pos = np.random.default_rng(SEED).standard_normal((313, channels, 7)).astype(np.float32).cumsum(0)
    mine, theirs = str(tmp_path / "port.pos"), str(tmp_path / "jax.pos")
    ag50x.write_ag50x(mine, pos, 250)
    jax_ag50x.write_ag50x(theirs, pos, 250)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    got = ag50x.read_ag50x(theirs, 200, device="cpu")
    want = jax_ag50x.read_ag50x(theirs, 200)
    assert (got.original_samplerate, got.resampled_samplerate, got.dimensions) == (250, 200, ag50x.DIMS)
    np.testing.assert_array_equal(got.time, want.time)
    np.testing.assert_array_equal(got.channels, want.channels)
    np.testing.assert_allclose(got.ema, want.ema, rtol=0, atol=1e-12)
    assert got.duration == want.duration
    for g, w in zip(got.channel(3, "y"), want.channel(3, "y")):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="channels"):
        ag50x.write_ag50x(mine, pos[:, :5], 250)


def _burst_tone(sr: int = 16_000) -> np.ndarray:
    """The JAX oracle test's input: a tone, a noise burst and near-silence."""
    rng = np.random.default_rng(3)
    t = np.arange(sr) / sr
    y = 0.5 * np.sin(2 * np.pi * 800 * t) * (t < 0.4)
    y[int(0.55 * sr) : int(0.58 * sr)] += 0.4 * rng.standard_normal(int(0.03 * sr))
    y += 1e-4 * rng.standard_normal(sr)
    return y.astype(np.float32)


def test_praat_spectrogram_matches_jax_and_oracle():
    """Within 40 dB of the maximum 1e-4 dB from JAX; over the display range
    (80 dB) 0.01 dB from the float64 oracle, the JAX package's own bar
    (both float32 routes sit about 4e-3 dB from float64 there: a bin 70 dB
    down carries the float32 rounding of the frame's whole energy)."""
    y, sr = _burst_tone(), 16_000
    got = praat_spectrogram(y, sr, device="cpu")
    want = jax_praat_spectrogram(y, sr)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    np.testing.assert_array_equal(got.frequencies, want.frequencies)
    g, w = got.data_matrix, np.asarray(want.data_matrix)
    assert g.shape == w.shape
    near = w > w.max() - 40.0
    assert np.abs(g[near] - w[near]).max() <= 1e-4  # dB
    times, freqs, ref = praat_spectrogram_np(y, sr)
    np.testing.assert_allclose(got.timestamps, times, atol=1e-12)
    np.testing.assert_allclose(got.frequencies, freqs, atol=1e-9)
    g = g.T
    lively = ref > ref.max() - 80.0
    assert np.abs(g[lively] - ref[lively]).max() <= 0.01  # dB
    assert (g[~lively] < ref.max() - 75.0).all()


def test_praat_spectrogram_zoom_blur_matches_jax():
    """zoom_blur is scipy's order-4 spline zoom ×6 of the port's own dB
    matrix, bit for bit, on JAX's re-gridded axes; within 40 dB of the
    maximum 1e-3 dB from JAX's (the spline's prefilter spreads each bin's
    float32 rounding over its neighbours)."""
    from scipy.ndimage import zoom

    y, sr = _burst_tone(), 16_000
    plain = praat_spectrogram(y, sr, device="cpu")
    got = praat_spectrogram(y, sr, zoom_blur=True, device="cpu")
    want = jax_praat_spectrogram(y, sr, zoom_blur=True)
    assert np.array_equal(got.data_matrix, zoom(plain.data_matrix, 6, order=4))
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    np.testing.assert_array_equal(got.frequencies, want.frequencies)
    w = np.asarray(want.data_matrix)
    near = w > w.max() - 40.0
    assert got.data_matrix.shape == w.shape and np.abs(got.data_matrix[near] - w[near]).max() <= 1e-3  # dB


def test_wav_writer_sound_and_window_match_jax(tmp_path):
    """write_wav writes JAX's bytes (mono float, stereo, int16); load_sound
    reads them; gaussian is JAX's (scipy's) window."""
    rng = np.random.default_rng(SEED)
    for name, x in (("mono", rng.uniform(-1.2, 1.2, 1000)), ("stereo", rng.uniform(-1, 1, (2, 700))),
                    ("int16", rng.integers(-32768, 32767, 500).astype(np.int16))):
        mine, theirs = str(tmp_path / f"{name}.wav"), str(tmp_path / f"{name}_jax.wav")
        write_wav(mine, x, 16_000)
        jax_write_wav(theirs, x, 16_000)
        assert open(mine, "rb").read() == open(theirs, "rb").read(), name
    s = load_sound(str(tmp_path / "stereo.wav"))
    x, sr = read_wav(str(tmp_path / "stereo.wav"))
    assert s.sample_rate == sr == 16_000 and s.amplitudes.shape == (2, 700)
    np.testing.assert_array_equal(s.amplitudes, x)
    np.testing.assert_array_equal(s.timestamps, np.arange(700) / 16_000)
    for m, std in ((80, 80 / 6.0), (7, 1.3)):
        assert np.array_equal(gaussian(m, std), jax_gaussian(m, std))
        np.testing.assert_allclose(gaussian(m, std), sps.windows.gaussian(m, std), rtol=1e-15)
