"""PyTorch port: the pyin Viterbi kernel module (kernels/viterbi.py) against
the JAX Pallas kernels of pallas/viterbi.py in interpret mode, as
tests/test_yin.py runs them. Adds and maxes are exact, so the bar is bit
identity. On the CPU the wrappers take their plain versions; the CUDA kernels
themselves are checked against those on the card by chip_smoke.py. Both
kernels work on the band of log_tri (viterbi_band); their banded steps,
written plainly (viterbi_forward_banded_reference,
viterbi_backtrace_banded_reference), are held here to the dense plain
versions and to JAX bit for bit, the backtrace's also on crafted rows that
set its traps (ties between an out-of-band and an in-band source, sums that
round together, −0 against +0)."""
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
from modulation_mfcc_tpu_torch.ops import yin as Y
from tests.test_torch_modulation import speechlike

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
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kMaxThreads"], const["kRingBins"]) == (V._MAX_THREADS, V._RING_BINS)
    assert re.search(r"constexpr int kMaxWarps = kMaxThreads / 32;", src) and const["kMaxThreads"] // 32 == V._MAX_WARPS
    assert (const["kSmemLimit"], const["kMaxRegBand"], const["kMaxRegThreads"], const["kAhead"]) == (
        V._SMEM_LIMIT, V._MAX_REG_BAND, V._MAX_REG_THREADS, V._AHEAD)
    assert "kMaxBins" not in src and not hasattr(V, "MAX_BINS")  # no limit on n: past 1,024 the wide kernels
    # the launcher's layout rule and the shared memory it counts, which band_layout mirrors
    assert "if (n > kMaxThreads) {" in src and "if (n > kRingBins) {" in src
    assert "if (width <= n && fwd_wide_smem_bytes(n, h, kShared) <= (size_t)kSmemLimit)" in src
    assert "else if (fwd_wide_smem_bytes(n, h, kL2) <= (size_t)kSmemLimit)" in src
    assert "} else if (width <= kMaxRegBand && n <= kMaxRegThreads) {" in src
    assert "} else if (width <= n && fwd_smem_bytes(n, h, 0, kShared) <= (size_t)kSmemLimit) {" in src
    assert ("sizeof(float) * ((size_t)4 * m_stride(n, kw) + 4 * kMaxWarps + (size_t)kAhead * 2 * fwd_threads(n) +\n"
            "                            (at == kShared ? (size_t)(2 * h + 1) * n : 0))") in src
    assert ("sizeof(float) * ((at == kHist ? 0 : (size_t)4 * n) + 4 * kMaxWarps +\n"
            "                            (at == kShared ? (size_t)(2 * h + 1) * n : 0))") in src
    assert "if (nb < 1 || nf < 1 || n < 1 || h < 0 || h >= n) return (int)cudaErrorInvalidValue;" in src
    for name in V.LAUNCHES:
        assert f'extern "C" int {name}(' in src
    # the toeplitz layout: its constants, the launchers' checks and rule, and the block's bytes (cluster_partition)
    assert (const["kToeThreads"], const["kToeGroup"], const["kMaxCluster"], const["kRuleCluster"],
            const["kToeSlice"]) == (V._TOE_THREADS, V._TOE_GROUP, V._MAX_CLUSTER, V._RULE_CLUSTER, V._TOE_SLICE)
    assert "constexpr int kToeWarps = kToeThreads / 32;" in src and V._TOE_WARPS == V._TOE_THREADS // 32
    assert src.count("if (toeplitz && (lo != h || hi != n - 1 - h || lo > hi)) return (int)cudaErrorInvalidValue;") == 2
    assert "if (n > kMaxThreads && toeplitz && toe_plan(n, h, lo, hi, cluster, plan)) {" in src
    assert "if (cluster && (!toeplitz || n <= kMaxThreads)) return (int)cudaErrorInvalidValue;" in src
    assert "if (n > kRingBins && toeplitz && bwd_toe_smem_bytes(h) <= (size_t)kSmemLimit)" in src
    assert ("return sizeof(float) * (size_t)(kspan + 4 * lm + 8L * ng + 4L * ne + 4L * g * kToeWarps + 4L * ne + e);"
            in src)
    assert "a = imax(t0, u - h) / 4 * 4;" in src and "return z > imax(t0, u - h) ? (z + 3) / 4 * 4 - a : 0;" in src
    assert "const long lm = 4L * ng + kspan;" in src
    assert "k0 = (h + 1) % 4 == 0 ? 0 : (h + 1) % 4 - 4;\n    kspan = (2 * h + 1 - k0 + 31) / 32 * 32;" in src
    assert ("return (size_t)kSlots * (16 + 32) + sizeof(float) * (2 * h + 1);" in src)
    assert ("p.split = 8 * ng <= kToeThreads ? 8 : 4 * ng <= kToeThreads ? 4 : 2 * ng <= kToeThreads ? 2 : 1;"
            in src)
    assert const["kEdgeCost"] == V._EDGE_COST
    assert src.count("(long)kspan * a + kEdgeCost * e > cost") == 1
    assert src.count("(long)kspan * (z1 - z) + kEdgeCost * e > cost") == 1
    assert "for (int g = 1; g <= kRuleCluster; g *= 2) {" in src and "if (widest <= kToeSlice) break;" in src


# ---------------------------------------------------------------------------
# The band
# ---------------------------------------------------------------------------

TINY_LOG = float(np.log(np.float32(np.finfo(np.float32).tiny)).astype(np.float32))  # fl32(log(tiny))


def pyin_log_tri(sr: float) -> np.ndarray:
    return Y.pyin_constants(Y.pyin_geometry(sr), 100, (2, 18), torch.float32)["log_tri"]


@pytest.mark.parametrize("sr", [16_000.0, 10_000.0])
def test_band_of_pyin_transition(sr):
    """pyin's log_tri at 16 and 10 kHz: n = 361, every entry farther than 21
    from the diagonal is fl32(log(tiny)) and none within it is; the host
    design (pyin_band) and the tensor give the same band, which the kernel
    holds in registers."""
    lt = pyin_log_tri(sr)
    n = lt.shape[0]
    dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    assert n == 361 and (lt[dist > 21] == np.float32(TINY_LOG)).all() and (lt[dist <= 21] > TINY_LOG).all()
    assert Y.pyin_band(Y.pyin_geometry(sr), torch.float32) == (21, TINY_LOG)
    assert V.viterbi_band(torch.tensor(lt)) == (21, TINY_LOG)
    assert V.band_layout(n, 21) == "registers"
    # its window changes nothing up to 1,024 bins: the same layouts
    rows = V.viterbi_band(torch.tensor(lt)).rows
    assert rows == (21, 339) and V.band_layout(n, 21, rows) == "registers" and V.backtrace_layout(n, 21, rows) == "shared"


def test_band_of_random_matrix_is_dense():
    """A transition with no floor (the random trellises) has h = n − 1: the
    dense recursion, read from L2; a NaN makes the band dense with C = −inf."""
    for n_bins, _ in SHAPES:
        lt = trellis(n_bins, 2, seed=5)[2]
        h, floor = V.viterbi_band(lt)
        assert (h, floor) == (n_bins - 1, float(lt.min())) and V.band_layout(n_bins, h) == "L2"
    lt[3, 4] = np.nan
    assert V.viterbi_band(lt) == (lt.shape[0] - 1, float("-inf"))


def test_band_widens_to_an_offband_entry():
    """One entry above C at distance 30 widens h to 30; one below C moves C
    itself and makes the whole matrix the band."""
    lt = pyin_log_tri(16_000.0).copy()
    lt[100, 130] = -50.0
    assert V.viterbi_band(lt) == (30, TINY_LOG)
    lt[200, 100] = -100.0
    h, floor = V.viterbi_band(lt)
    assert floor == -100.0 and h == 360


def banded_trellis(kind: str, seed: int):
    """Crafted banded trellises, float32 numpy (log_obs [3, NF, 2n], delta0
    [3, 2n], log_tri [n, n], c_stay, c_sw, h):

    * 'floor': a random band of half-width 4 over a floor C = −30, with C
      also at a fifth of the entries inside the band;
    * 'ties': small integers everywhere (band entries −8..−1 over C = −8,
      observations −3..0, c_stay = −1, c_sw = −2), so band terms tie with
      each other and with fl(gmax + C);
    * 'diagonal': h = 0, only the diagonal above the floor.
    """
    rng = np.random.default_rng(seed)
    n, h, floor, nf = {"floor": (50, 4, -30.0, 60), "ties": (24, 3, -8.0, 40), "diagonal": (30, 0, -20.0, 30)}[kind]
    dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    lt = np.full((n, n), floor, np.float32)
    if kind == "ties":
        lt[dist <= h] = rng.integers(-8, 0, int((dist <= h).sum()))
        lt[dist == h] = -1.0  # keep h the band's reach
        log_obs = rng.integers(-3, 1, (3, nf, 2 * n)).astype(np.float32)
        delta0 = rng.integers(-3, 1, (3, 2 * n)).astype(np.float32)
        return log_obs, delta0, lt, -1.0, -2.0, h
    lt[dist <= h] = rng.uniform(-10.0, 0.0, int((dist <= h).sum()))
    if kind == "floor":
        lt[(dist <= h) & (dist > 0) & (rng.random((n, n)) < 0.2)] = floor
        lt[dist == h] = -5.0
    log_obs = np.log(rng.random((3, nf, 2 * n)) + 1e-12).astype(np.float32)
    delta0 = np.log(rng.random((3, 2 * n)) + 1e-12).astype(np.float32)
    return log_obs, delta0, lt, C_STAY, C_SW, h


def pyin_trellis():
    """pyin's own trellis (log_obs, delta0, log_tri, c_stay, c_sw, h) of 2 × 3
    s of speech-like audio at 16 kHz, captured where pyin_f0 decodes it."""
    x = torch.tensor(np.stack([speechlike(3.0, 16_000, seed=s) for s in (1, 2)]))
    calls = []
    real = Y.viterbi_decode

    def capture(*args):
        calls.append(args)
        return real(*args)

    Y.viterbi_decode = capture
    try:
        Y.pyin_f0(x, sr=16_000.0)
    finally:
        Y.viterbi_decode = real
    log_obs, delta0, log_tri, c_stay, c_sw, band = calls[0]
    return log_obs.numpy(), delta0.numpy(), log_tri.numpy(), c_stay, c_sw, band[0]


def same_bits(a: torch.Tensor, b) -> bool:
    """Equal bit for bit (±0 and NaN payloads included)."""
    return np.array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32))


@pytest.mark.parametrize("kind", ["pyin", "floor", "ties", "diagonal"])
def test_banded_step_matches_dense_and_pallas(kind):
    """The kernel's banded step, written plainly, gives the dense plain
    version's δ history and δ_f, and JAX viterbi_forward_pallas's (interpret
    mode, per utterance), bit for bit, on pyin's trellis and the crafted
    ones; viterbi_band finds each trellis's band (pyin_f0 passes its
    designed band, h = 21, to the decode)."""
    log_obs, delta0, lt, c_stay, c_sw, h = pyin_trellis() if kind == "pyin" else banded_trellis(kind, seed=23)
    band = V.viterbi_band(lt)
    assert band == (h, float(lt.min())) and (kind != "pyin" or (h == 21 and log_obs.shape == (2, 301, 722)))
    args = (torch.tensor(log_obs), torch.tensor(delta0), torch.tensor(lt), c_stay, c_sw)
    got_f, got_hist = V.viterbi_forward_banded_reference(*args, band)
    want_f, want_hist = V.viterbi_forward_reference(*args)
    assert same_bits(got_f, want_f) and same_bits(got_hist, want_hist)
    for b in range(log_obs.shape[0]):
        jf, jhist = viterbi_forward_pallas(jnp.asarray(log_obs[b]), jnp.asarray(delta0[b]), jnp.asarray(lt),
                                           c_stay, c_sw, interpret=True)
        assert same_bits(got_f[b], jf) and same_bits(got_hist[b], jhist)


@pytest.mark.parametrize("n,h,layout", [(361, 21, "registers"), (361, 31, "registers"), (361, 32, "shared"),
                                        (361, 73, "shared"), (361, 74, "L2"), (600, 2, "shared"),
                                        (1024, 20, "shared"), (1024, 22, "L2"), (40, 39, "L2"),
                                        (1025, 0, "shared"), (1025, 21, "shared"), (1201, 43, "L2"),
                                        (6001, 2, "shared"), (6001, 3, "L2"), (14496, 0, "L2"),
                                        (14497, 0, "history"), (20000, 215, "history")])
def test_band_layout(n, h, layout):
    """The launcher's layout by size: up to 1,024 bins registers up to 64
    sources in blocks of at most 512 threads, shared memory for a band
    narrower than the matrix that fits beside m, the maxima and the row
    ring, else L2; past them (each thread ⌈n/1,024⌉ targets, no row ring)
    the band in shared memory where it fits beside m and the maxima, else
    L2 while m fits (14,496 bins), else m from the history."""
    assert V.band_layout(n, h) == layout


def test_band_cache_follows_the_tensor():
    """viterbi_forward derives the band of a log_tri tensor once, and again
    after an in-place edit of that tensor."""
    t = torch.tensor(pyin_log_tri(10_000.0))
    assert V._band_of(t) == (21, TINY_LOG) and V._band_of(t) == (21, TINY_LOG)
    t[100, 130] = -50.0
    assert V._band_of(t) == (30, TINY_LOG)



@pytest.mark.parametrize("kind", ["pyin", "floor", "ties", "diagonal"])
def test_banded_backtrace_matches_dense_and_pallas(kind):
    """The backtrace kernel's banded step, written plainly, gives the dense
    plain version's state paths bit for bit on the forward's history of
    pyin's trellis and the crafted banded ones, and JAX
    viterbi_decode_pallas's paths (interpret mode, per utterance); the CPU
    wrappers given the band take the dense plain versions."""
    log_obs, delta0, lt, c_stay, c_sw, h = pyin_trellis() if kind == "pyin" else banded_trellis(kind, seed=29)
    band = V.viterbi_band(lt)
    assert band[0] == h
    args = (torch.tensor(log_obs), torch.tensor(delta0), torch.tensor(lt), c_stay, c_sw)
    delta_f, hist = V.viterbi_forward_reference(*args)
    got = V.viterbi_backtrace_banded_reference(hist, delta_f, *args[2:], band)
    want = V.viterbi_backtrace_reference(hist, delta_f, *args[2:])
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(V.viterbi_decode(*args, band), want)
    assert torch.equal(V.viterbi_backtrace(hist, delta_f, *args[2:], band), want)
    for b in range(log_obs.shape[0]):
        jpath = viterbi_decode_pallas(jnp.asarray(log_obs[b]), jnp.asarray(delta0[b]), jnp.asarray(lt), c_stay, c_sw,
                                      interpret=True)
        assert np.array_equal(got[b].numpy(), np.asarray(jpath))


def backtrace_traps(kind: str, seed: int, n: int = 48, h: int = 3, steps: int = 40, batch: int = 2):
    """Crafted backtrace inputs, float32 numpy: (hist [B, steps, 2n], delta_f
    [B, 2n], log_tri [n, n], c_stay, c_sw, want [B, steps + 1]). The last
    state is chosen at random; each row, from the last back, is made for the
    bin pos and the voicing of the state the step after it takes, so that
    its first maximum is a trap of the banded step, and ``want`` is the path
    the traps lead to:

    * 'ties' (c_stay = −0, in-band entries −0, C = −10): an out-of-band
      source at a lower index ties the best in-band score, fl(9 + C) = −1 =
      −1 + (−0); or, where no source lies below the band, two in-band
      sources tie at −0 (the lower index) and +0, which order-preserving
      keys would tell apart;
    * 'rounding' (in-band entries −1, C = −1000): two out-of-band sources
      u1 < u2 with m = 0.5 − 2⁻¹⁷ and 0.5, whose sums with C both round to
      −999.5, above every in-band score: argmax(m) would take u2.

    The winner's block (voiced or unvoiced) is drawn per row, and the other
    entries sit far below."""
    rng = np.random.default_rng(seed)
    dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    if kind == "ties":
        c_stay, c_sw, floor, inner, low = -0.0, -2.0, -10.0, -0.0, -40.0
    else:
        c_stay, c_sw, floor, inner, low = -1.0, -2.0, -1000.0, -1.0, -3000.0
    lt = np.where(dist <= h, np.float32(inner), np.float32(floor)).astype(np.float32)
    hist = np.full((batch, steps, 2 * n), low, np.float32)
    delta_f = np.full((batch, 2 * n), -100.0, np.float32)
    want = np.empty((batch, steps + 1), np.int64)
    for b in range(batch):
        state = int(rng.integers(2 * n))
        delta_f[b, state] = 0.0
        want[b, steps] = state
        for t in range(steps - 1, -1, -1):
            row, pos = hist[b, t], state % n
            adds = (c_stay, c_sw) if state < n else (c_sw, c_stay)  # (a, c): what each block adds

            def put(u: int, m: float, block: int) -> None:
                row[block * n + u] = np.float32(m - adds[block])  # then m[u] = m, exactly

            block = int(rng.integers(2))
            if kind == "rounding":
                put(pos, -998.75, int(rng.integers(2)))  # in band: -999.75
                u1, u2 = sorted(rng.choice(np.flatnonzero(dist[pos] > h), 2, replace=False))
                put(int(u1), 0.5 - 2.0**-17, block)
                put(int(u2), 0.5, int(rng.integers(2)))
                win = int(u1)
            elif pos > h and rng.random() < 0.5:
                put(pos, -1.0, int(rng.integers(2)))  # in band: -1 + (-0) = -1
                win = int(rng.integers(pos - h))
                put(win, 9.0, block)  # out of band: fl(9 - 10) = -1, the lower index
            else:
                block = 0 if state < n else 1  # the block that adds c_stay = -0
                inside = np.flatnonzero(dist[pos] <= h)
                win, u2 = sorted(rng.choice(inside, 2, replace=False))
                row[block * n + win], row[block * n + u2] = np.float32(-0.0), np.float32(0.0)
                win = int(win)
            state = win + n * block
            want[b, t] = state
    return hist, delta_f, lt, c_stay, c_sw, want


@pytest.mark.parametrize("kind", ["ties", "rounding"])
def test_banded_backtrace_traps(kind):
    """On the crafted rows of backtrace_traps the banded step, written
    plainly, and the dense plain version both decode the path the traps were
    made for, bit for bit; and JAX agrees: each row, as δ_0 of a two-frame
    trellis whose last frame's observations force the state after it,
    decodes in viterbi_decode_batched (interpret mode) to the designed
    state, as it does in the port's plain decode."""
    hist, delta_f, lt, c_stay, c_sw, want = backtrace_traps(kind, seed=31)
    band = V.viterbi_band(lt)
    assert band == (3, float(lt.min()))
    args = (torch.tensor(hist), torch.tensor(delta_f), torch.tensor(lt), c_stay, c_sw)
    got = V.viterbi_backtrace_banded_reference(*args, band)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(V.viterbi_backtrace_reference(*args), got)
    nb, steps, two_n = hist.shape
    delta0 = hist.reshape(nb * steps, two_n)
    obs = np.zeros((nb * steps, 2, two_n), np.float32)
    obs[:, 1] = -1e4
    obs[np.arange(nb * steps), 1, want[:, 1:].reshape(-1)] = 0.0
    jpath = np.asarray(viterbi_decode_batched(jnp.asarray(obs), jnp.asarray(delta0), jnp.asarray(lt), c_stay, c_sw,
                                              interpret=True))
    assert np.array_equal(jpath[:, 1], want[:, 1:].reshape(-1)) and np.array_equal(jpath[:, 0], want[:, :-1].reshape(-1))
    port = V.viterbi_decode_reference(torch.tensor(obs), torch.tensor(delta0), torch.tensor(lt), c_stay, c_sw)
    assert np.array_equal(port.numpy(), jpath)


@pytest.mark.parametrize("n,h,layout", [(361, 21, "shared"), (361, 63, "shared"), (361, 64, "L2"),
                                        (361, 360, "L2"), (130, 129, "shared"), (40, 39, "shared"),
                                        (600, 20, "shared"), (1024, 0, "shared"), (1024, 20, "L2"),
                                        (1025, 20, "shared"), (1201, 23, "shared"), (1201, 24, "L2"),
                                        (6001, 4, "shared"), (6001, 5, "L2"), (6001, 6000, "L2")])
def test_backtrace_layout(n, h, layout):
    """The backtrace launcher's layout by size: up to 1,024 bins the band in
    shared memory when it fits beside the ring of 8 rows of (m, sel) pairs
    (pyin's 62 KB band does), past them beside the C candidates alone (the
    wide backtrace keeps no row), else the transposed log_tri from L2."""
    assert V.backtrace_layout(n, h) == layout


def test_backtrace_layout_matches_cuda_source():
    """backtrace_layout mirrors the launcher: the ring's depth, the shared
    memory it counts and its rule are the source's."""
    src = (CSRC / "viterbi.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kSlots"], const["kSmemLimit"]) == (V._SLOTS, V._SMEM_LIMIT)
    assert ("return (size_t)kSlots * (16 + 32 + 16 * (size_t)n) + (banded ? sizeof(float) * n * (2 * h + 1) : 0);"
            in src)
    assert ("return (size_t)kSlots * (16 + 32) + (banded ? sizeof(float) * (size_t)n * (2 * h + 1) : 0);" in src)
    assert "const bool banded = bwd_smem_bytes(n, h, true) <= (size_t)kSmemLimit;" in src
    assert "const bool banded = bwd_wide_smem_bytes(n, h, true) <= (size_t)kSmemLimit;" in src
    assert src.count("if (!banded && !log_tri_t) return (int)cudaErrorInvalidValue;") == 2


def test_backtrace_band_layout():
    """The band the backtrace stages: [n, 2h + 1], entry [pos, j] =
    log_tri[pos − h + j, pos], C past the matrix's edges."""
    lt = pyin_log_tri(16_000.0)
    n = lt.shape[0]
    band = V.backtrace_band(torch.tensor(lt), (21, TINY_LOG)).numpy()
    assert band.shape == (n, 43) and band.dtype == np.float32
    for pos in (0, 5, 180, 355, 360):
        for j in range(43):
            u = pos - 21 + j
            assert band[pos, j] == (lt[u, pos] if 0 <= u < n else np.float32(TINY_LOG))


def test_transposed_cache_follows_the_tensor():
    """The backtrace's L2 layout transposes a log_tri tensor once, and again
    after an in-place edit of that tensor."""
    t = torch.tensor(trellis(40, 2, seed=3)[2])
    first = V._transposed(t)
    assert torch.equal(first, t.t()) and first.is_contiguous() and V._transposed(t) is first
    t[1, 2] = 5.0
    again = V._transposed(t)
    assert again is not first and torch.equal(again, t.t())


# ---------------------------------------------------------------------------
# Past 1,024 bins (pyin at fine resolutions)
# ---------------------------------------------------------------------------

# (n, pyin's band at 16 kHz, hop 10 ms): 75-600 Hz at resolution 0.025 and
# 0.01; librosa's C2-C7 (65.406-2093 Hz) at 0.05 and 0.01; one bin past 1,024
WIDE = {1025: 21, 1201: 43, 1441: 86, 3601: 215, 6001: 215}


def test_wide_bins_are_pyins():
    """The wide sizes are pyin's own: n_bins = ⌊12·⌈1/resolution⌉·log2(fmax/
    fmin)⌋ + 1 and the designed band (pyin_band) at 75-600 Hz and C2-C7."""
    for (fmin, fmax, res), n in (((75.0, 600.0, 0.025), 1441), ((75.0, 600.0, 0.01), 3601),
                                 ((65.406, 2093.0, 0.05), 1201), ((65.406, 2093.0, 0.01), 6001)):
        g = Y.pyin_geometry(16_000.0, fmin, fmax, resolution=res)
        assert g.n_bins == n and Y.pyin_band(g, torch.float32)[0] == WIDE[n]


@pytest.mark.parametrize("n", WIDE)
def test_layouts_fit_past_1024_bins(n):
    """At 1,025 to 6,001 bins, with pyin's band, a narrow band, no band
    (h = 0) and the dense matrix (h = n − 1), both launchers' layouts fit a
    block's shared memory (forward_bytes, backtrace_bytes: the sums of the
    source's fwd_wide_smem_bytes and bwd_wide_smem_bytes), the forward
    keeps m in shared memory (14,496 bins and less), and neither holds a
    history row: the backtrace's bytes without the band are its barriers and
    C candidates alone, 384."""
    for h in sorted({0, 2, WIDE[n], n - 1}):
        fwd, bwd = V.band_layout(n, h), V.backtrace_layout(n, h)
        assert fwd in ("shared", "L2") and V.forward_bytes(n, h, fwd) <= V._SMEM_LIMIT, (h, fwd)
        assert V.forward_bytes(n, h, "L2") == 4 * (4 * n + 4 * V._MAX_WARPS)
        assert bwd in ("shared", "L2") and V.backtrace_bytes(n, h, bwd) <= V._SMEM_LIMIT, (h, bwd)
        assert V.backtrace_bytes(n, h, "L2") == V._SLOTS * 48 == 384
        assert (fwd == "shared") == (2 * h + 1 <= n and 4 * (4 * n + 4 * V._MAX_WARPS + (2 * h + 1) * n) <= 232_448)
        assert (bwd == "shared") == (384 + 4 * n * (2 * h + 1) <= 232_448)
    assert V.forward_bytes(14_497, 0, "history") == 4 * 4 * V._MAX_WARPS
    assert V.forward_bytes(1024, 20, "shared") == 4 * (4 * 1024 + 4 * 32 + 8 * 1024 + 41 * 1024)  # unchanged below
    # pyin's Toeplitz band: the toeplitz layouts, the forward's block the launcher's sum for the rule's plan
    h = WIDE[n]
    rows = (h, n - 1 - h)
    plan = V.cluster_plan(n, h, rows)
    assert V.band_layout(n, h, rows) == V.backtrace_layout(n, h, rows) == "toeplitz"
    kspan = -(-(2 * h + 1 - plan.k0) // 32) * 32
    lm = 4 * plan.ng + kspan
    want = 4 * (kspan + 4 * lm + 8 * plan.ng + 4 * 2 * h + 4 * plan.g * 16 + 4 * 2 * h + plan.emax)
    assert V.forward_bytes(n, h, "toeplitz", rows) == plan.smem == want <= V._SMEM_LIMIT
    assert V.backtrace_bytes(n, h, "toeplitz") == 384 + 4 * (2 * h + 1)
    assert plan.g == {1025: 4, 1201: 4, 1441: 4, 3601: 16, 6001: 16}[n]


@pytest.mark.parametrize("kind", ["dense", "banded"])
def test_plain_viterbi_matches_pallas_at_1201_bins(kind):
    """Past 1,024 bins the plain versions the kernels are held to on the
    card still equal JAX's Pallas Viterbi (interpret mode) bit for bit: δ
    history, δ_f and the decoded path on a dense trellis of 1,201 bins
    (librosa's C2-C7 at resolution 0.05) and on a banded one (h = 43 over a
    floor, pyin's band there); the kernels' banded steps, written plainly,
    equal the dense plain versions on the banded one."""
    nf = 6
    if kind == "dense":
        log_obs, delta0, lt = trellis(1201, nf, seed=37, batch=2)
        c_stay, c_sw = C_STAY, C_SW
    else:
        rng = np.random.default_rng(41)
        n, h, floor = 1201, 43, -87.3
        dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
        lt = np.full((n, n), floor, np.float32)
        lt[dist <= h] = rng.uniform(-10.0, 0.0, int((dist <= h).sum()))
        lt[(dist <= h) & (dist > 0) & (rng.random((n, n)) < 0.2)] = floor
        lt[dist == h] = -5.0
        log_obs = np.log(rng.random((2, nf, 2 * n)) + 1e-12).astype(np.float32)
        delta0 = np.log(rng.random((2, 2 * n)) + 1e-12).astype(np.float32)
        c_stay, c_sw = C_STAY, C_SW
    args = (torch.tensor(log_obs), torch.tensor(delta0), torch.tensor(lt), c_stay, c_sw)
    band = V.viterbi_band(lt)
    assert band[0] == (1200 if kind == "dense" else 43)
    got_f, got_hist = V.viterbi_forward(*args, band)
    path = V.viterbi_decode(*args, band)
    assert path.shape == (2, nf) and got_hist.shape == (2, nf - 1, 2402)
    for b in range(2):
        jf, jhist = viterbi_forward_pallas(jnp.asarray(log_obs[b]), jnp.asarray(delta0[b]), jnp.asarray(lt),
                                           c_stay, c_sw, interpret=True)
        assert same_bits(got_f[b], jf) and same_bits(got_hist[b], jhist)
        jpath = viterbi_decode_pallas(jnp.asarray(log_obs[b]), jnp.asarray(delta0[b]), jnp.asarray(lt), c_stay, c_sw,
                                      interpret=True)
        assert np.array_equal(path[b].numpy(), np.asarray(jpath))
    if kind == "banded":
        bf, bhist = V.viterbi_forward_banded_reference(*args, band)
        assert same_bits(bf, got_f) and same_bits(bhist, got_hist)
        assert torch.equal(V.viterbi_backtrace_banded_reference(got_hist, got_f, *args[2:], band), path)
