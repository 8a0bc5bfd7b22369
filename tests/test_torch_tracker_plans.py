"""PyTorch port: the plans and the arithmetic order of the two tracker
kernels, sinc_refine_f32 (csrc/sinc_refine.cu: a register tile of eight
neighbouring lags a thread, lanes on rows) and burg_lpc_f32 (csrc/burg.cu:
a frame's f and b in the lanes' registers). The CUDA kernels cannot run on
the CPU, so each is mirrored in numpy, tile by tile and lane by lane, and
the mirror is held to chip_smoke.py phase 6's bars against the plain
version and float64, and to the JAX Pallas kernels (interpret mode) at
their own tests' tolerances."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from modulation_mfcc_tpu.pallas.burg import burg_lpc_pallas, burg_reflections as jax_burg_reflections
from modulation_mfcc_tpu.pallas.sinc_refine import refine_sinc_band_pallas
from modulation_mfcc_tpu_torch.kernels import burg, sinc_refine

torch.set_num_threads(1)

# (depth, lag_lo, lag_max): the JAX kernel test's bands (10 kHz defaults,
# the 16 kHz band at veryAccurate depth, a short band), the tracker's 16 kHz
# band at the default depth (nl = 189, S = 73) and depths whose S = 163 and
# 403 stream the weights in two and four chunks of taps
BANDS = [(35, 16, 134), (70, 26, 214), (35, 2, 60), (35, 26, 214), (80, 20, 90), (200, 20, 90)]
CARD_REGISTERS, CARD_THREADS, CARD_SHARED = 65_536, 2048, 232_448  # an SM's; a block's shared memory


def fma32(a, b, c):
    """fl32(a·b + c) as FFMA rounds it: the float32 product is exact in
    float64, the sum rounded once more to float32 (a double rounding that
    can part from FFMA by one ulp in rare ties)."""
    return (np.float64(1.0) * a * b + c).astype(np.float32)


def band_rows(depth: int, lag_max: int, n: int = 5, seed: int = 7) -> np.ndarray:
    """Smooth autocorrelation-like rows (near-tie argmax decisions) and
    noise rows, as tests/test_pitch.py builds them."""
    rng = np.random.default_rng(seed)
    ln = depth + 2 + lag_max + depth + 3
    t = np.arange(ln)[None, :]
    smooth = np.cos(2 * np.pi * t / rng.uniform(20, 80, (n, 1))) * np.exp(-t / 400.0)
    return np.concatenate([smooth, rng.standard_normal((n, ln))]).astype(np.float32)


# ---------------------------------------------------------------------------
# sinc_refine_f32
# ---------------------------------------------------------------------------


def sinc_mirror(rows: np.ndarray, ext_left: int, lag_lo: int, lag_max: int, depth: int):
    """The kernel's arithmetic in numpy: items of 32 rows × 8·J lags, warp w
    of an item owning lags w·J .. w·J+J−1 of every row, each output one FMA
    chain over the taps in ascending order from 0 (chunk by chunk), then the
    first interior maximum and the parabola in explicitly rounded float32.
    Returns (pos, val, how often each output was written)."""
    m_rows = rows.shape[0]
    nl, s = lag_max - lag_lo + 1, 2 * depth + 3
    start = ext_left - (depth + 1) + lag_lo
    plan = sinc_refine.sinc_plan(nl, s)
    j = sinc_refine.LAGS_PER_THREAD
    w = sinc_refine.sinc_weights(depth)
    band = np.zeros((m_rows, plan.lag_blocks * plan.lag_block + s - 1), np.float32)
    band[:, : nl + s - 1] = rows[:, start : start + nl + s - 1]  # zero fill past the band
    pos = np.zeros((m_rows, nl), np.float32)
    val = np.zeros((m_rows, nl), np.float32)
    written = np.zeros((m_rows, nl), np.int64)
    h = np.float32(2.0 / (sinc_refine.GRID - 1))
    for row0 in range(0, m_rows, sinc_refine.ROWS):
        r = np.arange(row0, min(row0 + sinc_refine.ROWS, m_rows))
        for l0 in range(0, plan.lag_blocks * plan.lag_block, plan.lag_block):
            for warp in range(sinc_refine.WARPS):
                lags = l0 + warp * j + np.arange(j)
                acc = np.zeros((len(r), j, sinc_refine.GRID), np.float32)
                for c in range(plan.chunks):
                    for tap in range(c * plan.taps_chunk, min((c + 1) * plan.taps_chunk, s)):
                        xv = band[r[:, None], lags[None, :] + tap]
                        acc = fma32(xv[..., None], w[tap], acc)
                gb = np.argmax(acc[..., 1:-1], axis=-1) + 1  # the first maximum
                pick = lambda d: np.take_along_axis(acc, (gb + d)[..., None], -1)[..., 0]  # noqa: E731
                best, fm, fp = pick(0), pick(-1), pick(1)
                diff = fm - fp
                denom = (fm - np.float32(2.0) * best) + fp
                with np.errstate(divide="ignore", invalid="ignore"):
                    delta = np.where(np.abs(denom) > np.float32(1e-12), (np.float32(0.5) * diff) / denom,
                                     np.float32(0.0)).astype(np.float32)
                delta = np.clip(delta, np.float32(-0.5), np.float32(0.5))
                off = np.float32(-1.0) + gb.astype(np.float32) * h
                ok = lags < nl
                lag = lags[ok]
                pos[r[:, None], lag] = ((np.float32(lag_lo) + lag.astype(np.float32)) + off[:, ok]) + delta[:, ok] * h
                val[r[:, None], lag] = best[:, ok] - (np.float32(0.25) * diff[:, ok]) * delta[:, ok]
                written[r[:, None], lag] += 1
    return pos, val, written


def sinc_bars(got: tuple, want: tuple) -> tuple[float, float, float]:
    """chip_smoke.py's sinc_errors: (value err, share of positions off by
    more than 1e-4, max position err); bars 1e-5, < 5 %, 0.26."""
    dv = float(np.abs(got[1] - want[1]).max())
    dp = np.abs(got[0] - want[0])
    return dv, float(np.mean(dp > 1e-4)), float(dp.max())


@pytest.mark.parametrize("nl", [119, 189])
@pytest.mark.parametrize("s", [73, 143])
def test_sinc_plan_tiles_the_band(nl, s):
    """The items cover the band exactly; a staged row holds the
    item's lags and taps one float in, at a stride of 4 mod 8 words (each
    quarter warp's float4 x loads, one a lane and row, on distinct banks);
    the (pos, val) tile's stride is odd; a block's shared bytes fit the card
    with room for two blocks an SM."""
    plan = sinc_refine.sinc_plan(nl, s)
    j = sinc_refine.LAGS_PER_THREAD
    assert plan.lag_block == sinc_refine.WARPS * j
    assert (plan.lag_blocks - 1) * plan.lag_block < nl <= plan.lag_blocks * plan.lag_block
    assert plan.chunks == 1 and plan.taps_chunk == s  # the tracker's depths keep the weights resident
    assert plan.x_stride % 8 == 4 and plan.x_stride >= 1 + plan.lag_block + s - 1
    assert len({(r * plan.x_stride // 4) % 8 for r in range(8)}) == 8
    assert plan.out_stride % 2 == 1 and plan.out_stride >= plan.lag_block
    assert 2 * plan.shared_bytes <= CARD_SHARED
    # registers: 17·J accumulators, the window, a weight row and addressing
    assert sinc_refine.GRID * j + j + sinc_refine.GRID + 24 <= 255


@pytest.mark.parametrize("nl,s", [(1, 3), (59, 73), (600, 143), (189, 161), (300, 1001)])
def test_sinc_plan_takes_any_band(nl, s):
    """Wide bands take more lag blocks; S past 160 streams the weights with
    x in chunks of 128 taps; a block still fits the card's shared memory."""
    plan = sinc_refine.sinc_plan(nl, s)
    assert plan.lag_blocks * plan.lag_block >= nl
    assert plan.chunks * plan.taps_chunk >= s and (plan.chunks == 1) == (s <= sinc_refine.TAPS_RESIDENT)
    assert plan.shared_bytes <= CARD_SHARED
    for bad in ((0, s), (nl, 0)):
        with pytest.raises(ValueError, match="takes nl ≥ 1 and S ≥ 1"):
            sinc_refine.sinc_plan(*bad)


@pytest.mark.parametrize("m_rows", [1, 33, 70])
def test_sinc_mirror_writes_every_output_once(m_rows):
    """Rows that fill no whole group of 32 and a band that fills no whole
    lag block: the tiling writes each (row, lag) exactly once."""
    rows = np.random.default_rng(3).standard_normal((m_rows, 37 + 134 + 38)).astype(np.float32)
    _, _, written = sinc_mirror(rows, 37, 16, 134, 35)
    assert (written == 1).all()


@pytest.mark.parametrize("depth,lag_lo,lag_max", BANDS)
def test_sinc_mirror_meets_phase6_bars(depth, lag_lo, lag_max):
    """The mirror against the plain version (value ≤ 1e-5, positions off by
    more than 1e-4 under 5 %, by at most 0.26) and against the float64
    evaluation of the plain version: its values no further than the FP32
    plain version's, plus 1e-6."""
    rows = band_rows(depth, lag_max)
    ext_left = depth + 2
    pos, val, written = sinc_mirror(rows, ext_left, lag_lo, lag_max, depth)
    assert (written == 1).all()
    plain = [t.numpy() for t in sinc_refine.refine_sinc_band_reference(torch.tensor(rows), ext_left, lag_lo,
                                                                        lag_max, depth)]
    dv, share, dmax = sinc_bars((pos, val), plain)
    assert dv <= 1e-5 and share < 0.05 and dmax <= 0.26
    w64 = torch.tensor(sinc_refine.sinc_weights(depth), dtype=torch.float64)
    exact = sinc_refine.refine_sinc_band_reference(torch.tensor(rows, dtype=torch.float64), ext_left, lag_lo,
                                                   lag_max, depth, w=w64)[1].numpy()
    assert np.abs(val - exact).max() <= np.abs(plain[1] - exact).max() + 1e-6


@pytest.mark.parametrize("depth,lag_lo,lag_max", BANDS[:3])
def test_sinc_mirror_matches_jax_kernel(depth, lag_lo, lag_max):
    """The mirror against the Pallas kernel in interpret mode, at
    tests/test_pitch.py's tolerances."""
    rows = band_rows(depth, lag_max)
    ext_left = depth + 2
    want_p, want_v = (np.asarray(t) for t in refine_sinc_band_pallas(jnp.asarray(rows), ext_left, lag_lo, lag_max,
                                                                     depth, interpret=True))
    got = sinc_mirror(rows, ext_left, lag_lo, lag_max, depth)
    np.testing.assert_allclose(got[1], want_v, rtol=0, atol=1e-5)
    dp = np.abs(got[0] - want_p)
    assert np.mean(dp > 1e-4) < 0.05 and dp.max() <= 0.26


# ---------------------------------------------------------------------------
# burg_lpc_f32
# ---------------------------------------------------------------------------


def test_burg_plan_covers_the_range():
    """For every nw in 2..3,632 and every order 1..32 below it: an
    instantiated C, 1, 2 or 4 warps a frame whose lanes hold the frame, the
    fewest warps that can; registers (f and b chunks and about 32 more)
    under the launch bound's cap, shared bytes and threads under the card's."""
    for nw in range(2, burg._MAX_NW + 1):
        plan = burg.burg_plan(nw, 1)
        assert all(burg.burg_plan(nw, order) == plan for order in range(2, min(burg._MAX_ORDER, nw - 1) + 1))
        c, wf = plan.chunk, plan.warps_per_frame
        assert c in burg._CHUNKS and wf in (1, 2, 4)
        assert 32 * c * wf >= nw and (c == 1 or 32 * wf * burg._CHUNKS[burg._CHUNKS.index(c) - 1] < nw)
        assert wf == 1 or 32 * 32 * wf // 2 < nw
        threads = burg._WARPS * 32 * plan.blocks_per_sm
        assert 2 * c + 32 <= min(255, CARD_REGISTERS // threads)  # the launch bound's register cap
        assert threads <= CARD_THREADS
        assert plan.shared_bytes * plan.blocks_per_sm <= CARD_SHARED
        assert burg._WARPS % wf == 0


@pytest.mark.parametrize("nw,order", [(1, 1), (3633, 10), (550, 0), (550, 33), (10, 10), (2, 2)])
def test_burg_plan_raises_outside_the_range(nw, order):
    with pytest.raises(ValueError, match="burg_lpc_f32 takes"):
        burg.burg_plan(nw, order)


def burg_mirror(frames: np.ndarray, order: int, levinson: bool = True) -> np.ndarray:
    """The kernel's arithmetic in numpy float32: the frame in [warp, lane,
    C] chunks; each step one register update of f and b, then the next
    step's lane partial sums in ascending element order below the prefix,
    xor butterflies, and across warps the partials and boundary terms added
    in warp order; k = −2·num / max(sum_f + sum_b, 1e-30)."""
    n_frames, nw = frames.shape
    plan = burg.burg_plan(nw, order)
    c_n, wf = plan.chunk, plan.warps_per_frame
    x = np.zeros((n_frames, wf * 32 * c_n), np.float32)
    x[:, :nw] = frames
    f = x.reshape(n_frames, wf, 32, c_n)
    b = f.copy()
    first = np.arange(wf)[:, None] * 32 * c_n + np.arange(32)[None, :] * c_n
    lanes = np.arange(32)

    def step_sums(f, b, m):
        lm = nw - 1 - m
        lim = lm - first
        fnext = np.zeros(f.shape[:-1], np.float32)
        fnext[..., :31] = f[..., 1:, 0]
        pn, pf, pb = (np.zeros(f.shape[:-1], np.float32) for _ in range(3))
        for c in range(c_n):
            fk = f[..., c + 1] if c + 1 < c_n else fnext
            on = c < lim
            pn = np.where(on, fma32(fk, b[..., c], pn), pn)
            pf = np.where(on, fma32(fk, fk, pf), pf)
            pb = np.where(on, fma32(b[..., c], b[..., c], pb), pb)
        for o in (16, 8, 4, 2, 1):
            pn, pf, pb = pn + pn[..., lanes ^ o], pf + pf[..., lanes ^ o], pb + pb[..., lanes ^ o]
        pn, pf, pb = pn[..., 0], pf[..., 0], pb[..., 0]  # [frames, wf], equal in every lane
        if wf > 1:
            f0, blast = f[:, :, 0, 0], b[:, :, 31, c_n - 1]
            tn, tf, tb = (np.zeros(n_frames, np.float32) for _ in range(3))
            for v in range(wf):
                tn, tf, tb = tn + pn[:, v], tf + pf[:, v], tb + pb[:, v]
                if v + 1 < wf and (v + 1) * 32 * c_n - 1 < lm:
                    tn = fma32(f0[:, v + 1], blast[:, v], tn)
                    tf = fma32(f0[:, v + 1], f0[:, v + 1], tf)
            fnext[:, :-1, 31] = f0[:, 1:]
            return tn, tf, tb, fnext
        return pn[:, 0], pf[:, 0], pb[:, 0], fnext

    pn, pf, pb, fnext = step_sums(f, b, 0)
    a = np.zeros((n_frames, 32), np.float32)
    for m in range(order):
        k = (np.float32(-2.0) * pn) / np.maximum(pf + pb, np.float32(1e-30))
        rev = a[:, (m - 1 - lanes) & 31]
        if levinson:
            a[:, :m] = a[:, :m] + k[:, None] * rev[:, :m]
        a[:, m] = k
        if m + 1 == order:
            break
        fk = np.concatenate([f[..., 1:], fnext[..., None]], axis=-1)
        kk = k[:, None, None, None]
        f, b = fk + kk * b, b + kk * fk
        pn, pf, pb, fnext = step_sums(f, b, m + 1)
    return a[:, :order]


@pytest.fixture(scope="module")
def burg_frames():
    """tests/test_pallas_frontend.py::test_pallas_burg_matches_xla's input."""
    return np.random.default_rng(0).standard_normal((3, 41, 213)).astype(np.float32) * 0.3


@pytest.mark.parametrize("levinson", [True, False])
def test_burg_mirror_meets_phase6_bars(burg_frames, levinson):
    """On the JAX kernel test's frames: ≤ 2e-6 from the plain version and
    from the Pallas kernel in interpret mode; against float64 no further
    than 2 × the plain version's distance + 2e-6."""
    flat = burg_frames.reshape(-1, burg_frames.shape[-1])
    got = burg_mirror(flat, 10, levinson)
    plain = burg.burg_lpc_reference(torch.tensor(flat), 10, levinson=levinson).numpy()
    exact = burg.burg_lpc_reference(torch.tensor(flat, dtype=torch.float64), 10, levinson=levinson).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=2e-6)
    assert np.abs(got - exact).max() <= 2 * np.abs(plain - exact).max() + 2e-6
    with pltpu.force_tpu_interpret_mode():
        jax_fn = burg_lpc_pallas if levinson else jax_burg_reflections
        want = np.asarray(jax_fn(jnp.asarray(burg_frames), 10)).reshape(-1, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("nw,order", [(2, 1), (33, 32), (550, 10), (1500, 16), (3632, 32)])
def test_burg_mirror_across_the_range(nw, order):
    """At the ends of the range (one, two and four warps a frame; C 1, 2,
    18, 24, 32; order 32): against float64 within phase 6's bar, and the
    reflection coefficients inside the unit circle."""
    frames = np.random.default_rng(11).standard_normal((5, nw)).astype(np.float32) * 0.3
    got = burg_mirror(frames, order, levinson=False)
    plain = burg.burg_lpc_reference(torch.tensor(frames), order, levinson=False).numpy()
    exact = burg.burg_lpc_reference(torch.tensor(frames, dtype=torch.float64), order, levinson=False).numpy()
    assert np.abs(got - exact).max() <= 2 * np.abs(plain - exact).max() + 2e-6
    assert (np.abs(got) <= 1.0 + 1e-5).all()
    a = burg_mirror(frames, order)
    np.testing.assert_allclose(a, burg.levinson_from_reflections(torch.tensor(got)).numpy(), rtol=0, atol=2e-6)
