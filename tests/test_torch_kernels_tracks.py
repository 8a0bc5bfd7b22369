"""PyTorch port: the trackers' kernel modules (kernels/sinc_refine.py,
kernels/burg.py) against the JAX Pallas kernels, run as the JAX package's
own tests run them on the CPU (interpret mode). On the CPU the wrappers take
their plain PyTorch versions; the CUDA kernels themselves are checked
against those on the card by chip_smoke.py."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from modulation_mfcc_tpu.ops.lpc import burg_lpc as jax_burg_lpc
from modulation_mfcc_tpu.ops.pitch import _refine_sinc_dense, _sinc_band_matrix, _sinc_weights
from modulation_mfcc_tpu.oracle import burg_np
from modulation_mfcc_tpu.pallas.burg import burg_lpc_pallas, burg_reflections as jax_burg_reflections
from modulation_mfcc_tpu.pallas.sinc_refine import refine_sinc_band_pallas
from modulation_mfcc_tpu_torch.kernels import burg, sinc_refine

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "modulation_mfcc_tpu_torch" / "csrc"

# (depth, lag_lo, lag_max): 10 kHz defaults (one 128-lane tile on the TPU),
# the 16 kHz band at veryAccurate depth (two tiles), a short band
BANDS = [(35, 16, 134), (70, 26, 214), (35, 2, 60)]


def band_rows(depth: int, lag_max: int, seed: int = 7) -> np.ndarray:
    """Smooth autocorrelation-like rows (near-tie argmax decisions) and
    noise rows, as tests/test_pitch.py builds them."""
    rng = np.random.default_rng(seed)
    ln = depth + 2 + lag_max + depth + 3
    t = np.arange(ln)[None, :]
    smooth = np.cos(2 * np.pi * t / rng.uniform(20, 80, (5, 1))) * np.exp(-t / 400.0)
    return np.concatenate([smooth, rng.standard_normal((5, ln))]).astype(np.float32)


@pytest.mark.parametrize("depth,lag_lo,lag_max", BANDS)
def test_sinc_reference_matches_jax_kernel(depth, lag_lo, lag_max):
    """The plain version against the Pallas kernel and the XLA band, with
    the bars of tests/test_pitch.py: values ≤ 1e-5; positions differ beyond
    1e-4 only on f32 ties between grid offsets (< 5 % of entries, by at
    most one grid step)."""
    rows = band_rows(depth, lag_max)
    ext_left = depth + 2
    got_p, got_v = sinc_refine.refine_sinc_band_reference(torch.tensor(rows), ext_left, lag_lo, lag_max, depth)
    pallas = refine_sinc_band_pallas(jnp.asarray(rows), ext_left, lag_lo, lag_max, depth, interpret=True)
    dense = _refine_sinc_dense(jnp.asarray(rows), ext_left, lag_max, depth, lag_lo=lag_lo)
    for want_p, want_v in (pallas, dense):
        want_p, want_v = np.asarray(want_p), np.asarray(want_v)
        assert got_p.shape == want_p.shape == (10, lag_max - lag_lo + 1)
        np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=1e-5)
        dp = np.abs(got_p.numpy() - want_p)
        assert np.mean(dp > 1e-4) < 0.05 and dp.max() <= 0.26


@pytest.mark.parametrize("depth", [35, 70])
def test_sinc_weights_and_band_bit_identical(depth):
    """The weights and the band operator built from them equal the JAX
    package's host design (cast to float32) bit for bit."""
    w = sinc_refine.sinc_weights(depth)
    assert np.array_equal(w, _sinc_weights(np.linspace(-1.0, 1.0, 17), depth).astype(np.float32))
    band = sinc_refine.sinc_band_matrix(torch.tensor(w), 23).numpy()
    assert np.array_equal(band, _sinc_band_matrix(17, depth, 23).astype(np.float32))


def test_sinc_wrapper_takes_the_plain_version_on_cpu():
    rows = torch.tensor(band_rows(35, 134))
    before = dict(sinc_refine.LAUNCHES)
    got = sinc_refine.refine_sinc_band(rows, 37, 16, 134, 35)
    want = sinc_refine.refine_sinc_band_reference(rows, 37, 16, 134, 35)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sinc_refine.LAUNCHES == before
    with pytest.raises(ValueError, match="does not fit"):
        sinc_refine.refine_sinc_band(rows, 37, 16, 300, 35)
    with pytest.raises(ValueError, match="weights"):
        sinc_refine.refine_sinc_band(rows, 37, 16, 134, 35, w=torch.zeros(3, 17))


@pytest.fixture(scope="module")
def burg_frames():
    """tests/test_pallas_frontend.py::test_pallas_burg_matches_xla's input."""
    return np.random.default_rng(0).standard_normal((3, 41, 213)).astype(np.float32) * 0.3


def test_burg_reference_matches_jax_kernel(burg_frames):
    """LPC coefficients and reflection coefficients against the Pallas
    kernel in interpret mode and the XLA recursion, ≤ 2e-6."""
    with pltpu.force_tpu_interpret_mode():
        want_a = np.asarray(burg_lpc_pallas(jnp.asarray(burg_frames), 10))
        want_k = np.asarray(jax_burg_reflections(jnp.asarray(burg_frames), 10))
    frames = torch.tensor(burg_frames)
    got_a = burg.burg_lpc_reference(frames, 10)
    got_k = burg.burg_lpc_reference(frames, 10, levinson=False)
    np.testing.assert_allclose(got_a.numpy(), want_a, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(jax_burg_lpc(jnp.asarray(burg_frames), 10)), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got_k.numpy(), want_k, rtol=0, atol=2e-6)
    assert got_k.shape == (3, 41, 10) and bool((got_k.abs() <= 1.0 + 1e-5).all())
    np.testing.assert_allclose(burg.levinson_from_reflections(got_k).numpy(), got_a.numpy(), rtol=0, atol=2e-6)


@pytest.mark.parametrize("order", [8, 10, 16])
def test_burg_reference_float64_matches_oracle(order):
    """Float64 recursion against the published Andersen recursion
    (oracle.burg_np), at the JAX package's 1e-10."""
    frames = np.random.default_rng(1).standard_normal((6, 550))
    got = burg.burg_lpc_reference(torch.tensor(frames), order).numpy()
    want = np.stack([burg_np(f, order) for f in frames])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_burg_wrappers_take_the_plain_version_on_cpu(burg_frames):
    frames = torch.tensor(burg_frames)
    before = dict(burg.LAUNCHES)
    assert torch.equal(burg.burg_lpc(frames, 10), burg.burg_lpc_reference(frames, 10))
    assert torch.equal(burg.burg_reflections(frames, 10), burg.burg_lpc_reference(frames, 10, levinson=False))
    zero = burg.burg_lpc(torch.zeros(2, 50), 6)
    assert not zero.any()  # a zero frame gives k = 0
    assert burg.LAUNCHES == before


def test_wrapper_limits_match_cuda_sources():
    """The wrappers' limits are the constants the CUDA sources compile with."""
    sinc_src = (CSRC / "sinc_refine.cu").read_text()
    burg_src = (CSRC / "burg.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const(sinc_src, "kG") == sinc_refine.GRID
    assert const(burg_src, "kMaxOrder") == burg._MAX_ORDER
    assert const(burg_src, "kWarps") == burg._WARPS
    # the kernel's layout, which sinc_plan's tiling (passed to the launcher) is computed from
    assert const(sinc_src, "kGP") == sinc_refine.WEIGHT_ROW
    assert const(sinc_src, "kRows") == sinc_refine.ROWS
    assert const(sinc_src, "kWarps") == sinc_refine.WARPS
    assert const(sinc_src, "kJ") == sinc_refine.LAGS_PER_THREAD
    # burg_plan mirrors the launcher's make_plan
    assert const(burg_src, "kMaxNw") == burg._MAX_NW
    assert const(burg_src, "kXch") == burg._XCH
    chunks = re.search(r"constexpr int kChunks\[\] = \{([^}]*)\};", burg_src).group(1)
    assert tuple(int(c) for c in chunks.split(",")) == burg._CHUNKS
    assert burg._CHUNKS == tuple(int(c) for c in re.findall(r"case (\d+): return launch<", burg_src))
