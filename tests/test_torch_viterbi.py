"""PyTorch port: the pyin Viterbi kernel module (kernels/viterbi.py) against
the JAX Pallas kernels of pallas/viterbi.py in interpret mode, as
tests/test_yin.py runs them. Adds and maxes are exact, so the bar is bit
identity. On the CPU the wrappers take their plain versions; the CUDA kernels
themselves are checked against those on the card by chip_smoke.py."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modulation_mfcc_tpu.pallas.viterbi import (
    viterbi_decode_batched,
    viterbi_decode_pallas,
    viterbi_forward_pallas,
)
from modulation_mfcc_tpu_torch.kernels import viterbi as V

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "modulation_mfcc_tpu_torch" / "csrc"
C_STAY, C_SW = float(np.log(0.99)), float(np.log(0.01))
# (n_bins, nf) of tests/test_yin.py's Pallas Viterbi tests, plus one frame
SHAPES = [(360, 40), (130, 7), (37, 25), (40, 600), (40, 1)]


def trellis(n_bins: int, nf: int, seed: int, batch: int | None = None):
    """Random dense log_obs [(B,) NF, 2n], delta0 [(B,) 2n] and column-
    normalized log_tri [n, n], float32, as tests/test_yin.py builds them."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    log_obs = np.log(rng.random((*lead, nf, 2 * n_bins)) + 1e-12).astype(np.float32)
    delta0 = np.log(rng.random((*lead, 2 * n_bins)) + 1e-12).astype(np.float32)
    tri = rng.random((n_bins, n_bins))
    log_tri = np.log(tri / tri.sum(0) + 1e-30).astype(np.float32)
    return log_obs, delta0, log_tri


def torch_args(*arrays):
    return [torch.tensor(a) for a in arrays] + [C_STAY, C_SW]


@pytest.mark.parametrize("n_bins,nf", SHAPES)
def test_forward_reference_matches_pallas(n_bins, nf):
    """δ history and final δ bit-identical to viterbi_forward_pallas."""
    arrays = trellis(n_bins, nf, seed=11)
    want_f, want_hist = viterbi_forward_pallas(*map(jnp.asarray, arrays), C_STAY, C_SW, interpret=True)
    got_f, got_hist = V.viterbi_forward_reference(*torch_args(*arrays))
    assert got_hist.shape == (nf - 1, 2 * n_bins) and got_f.shape == (2 * n_bins,)
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_hist.numpy(), np.asarray(want_hist))


@pytest.mark.parametrize("n_bins,nf", SHAPES)
def test_decode_reference_matches_pallas(n_bins, nf):
    """Decoded paths identical to viterbi_decode_pallas (first-max ties)."""
    arrays = trellis(n_bins, nf, seed=13)
    want = np.asarray(viterbi_decode_pallas(*map(jnp.asarray, arrays), C_STAY, C_SW, interpret=True))
    got = V.viterbi_decode_reference(*torch_args(*arrays))
    assert got.dtype == torch.int32 and got.shape == (nf,)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_bins,nf", [(130, 40), (40, 300)])
def test_batched_decode_reference_matches_pallas(n_bins, nf):
    """A batch of 3 against viterbi_decode_batched and against the per-row
    plain decode."""
    arrays = trellis(n_bins, nf, seed=17, batch=3)
    want = np.asarray(viterbi_decode_batched(*map(jnp.asarray, arrays), C_STAY, C_SW, interpret=True))
    log_obs, delta0, log_tri, c_stay, c_sw = torch_args(*arrays)
    got = V.viterbi_decode_reference(log_obs, delta0, log_tri, c_stay, c_sw)
    assert got.shape == (3, nf)
    assert np.array_equal(got.numpy(), want)
    rows = [V.viterbi_decode_reference(log_obs[b], delta0[b], log_tri, c_stay, c_sw) for b in range(3)]
    assert torch.equal(got, torch.stack(rows))


def test_decode_prefers_voiced_and_first_max_on_ties():
    """Exact ties everywhere: equal observations, a constant transition and
    switch = stay. The backtrace takes the first maximum over sources and
    the voiced block on block ties; the final state is δ_f's first maximum."""
    n, nf = 5, 4
    log_obs = torch.zeros((nf, 2 * n))
    log_tri = torch.zeros((n, n))
    path = V.viterbi_decode_reference(log_obs, torch.zeros(2 * n), log_tri, -0.5, -0.5)
    assert path.tolist() == [0, 0, 0, 0]
    jax_path = viterbi_decode_pallas(jnp.zeros((nf, 2 * n)), jnp.zeros(2 * n), jnp.zeros((n, n)), -0.5, -0.5,
                                     interpret=True)
    assert np.array_equal(path.numpy(), np.asarray(jax_path))


def test_wrappers_take_the_plain_versions_on_cpu():
    log_obs, delta0, log_tri, c_stay, c_sw = torch_args(*trellis(37, 25, seed=19, batch=2))
    before = dict(V.LAUNCHES)
    fwd = V.viterbi_forward(log_obs, delta0, log_tri, c_stay, c_sw)
    ref = V.viterbi_forward_reference(log_obs, delta0, log_tri, c_stay, c_sw)
    assert all(torch.equal(a, b) for a, b in zip(fwd, ref))
    assert torch.equal(V.viterbi_backtrace(ref[1], ref[0], log_tri, c_stay, c_sw),
                       V.viterbi_backtrace_reference(ref[1], ref[0], log_tri, c_stay, c_sw))
    assert torch.equal(V.viterbi_decode(log_obs, delta0, log_tri, c_stay, c_sw),
                       V.viterbi_decode_reference(log_obs, delta0, log_tri, c_stay, c_sw))
    assert V.LAUNCHES == before
    with pytest.raises(ValueError, match="shapes"):
        V.viterbi_forward(log_obs[..., 1:], delta0, log_tri, c_stay, c_sw)


def test_wrappers_raise_on_devices_without_a_kernel():
    log_obs = torch.empty((2, 25, 74), device="meta")
    delta0 = torch.empty((2, 74), device="meta")
    log_tri = torch.empty((37, 37), device="meta")
    for fn, args in ((V.viterbi_forward, (log_obs, delta0)), (V.viterbi_decode, (log_obs, delta0)),
                     (V.viterbi_backtrace, (log_obs[:, 1:], delta0))):
        with pytest.raises(ValueError, match="no kernel"):
            fn(*args, log_tri, C_STAY, C_SW)


def test_wrapper_limits_match_cuda_source():
    src = (CSRC / "viterbi.cu").read_text()
    assert int(re.search(r"constexpr int kMaxBins = (\d+);", src).group(1)) == V.MAX_BINS
    for name in V.LAUNCHES:
        assert f'extern "C" int {name}(' in src
