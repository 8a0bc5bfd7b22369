"""PyTorch port: the Viterbi kernels' 'toeplitz' layout (kernels/viterbi.py,
csrc/viterbi.cu) past 1,024 bins, against the dense plain versions and the
JAX Pallas kernels of pallas/viterbi.py in interpret mode.

pyin's transition is librosa's local triangle: every interior row carries
the same window, shifted, bit for bit, and only the 2h rows nearest the ends
(each renormalised by its own sum) differ. viterbi_band finds that window;
the kernels then read the window from shared memory and the edge rows from
log_tri, and split each utterance's targets over a thread-block cluster.
Here: the detection, the compact steps written plainly (bit for bit with
the dense plain versions and JAX), and a mirror of the cluster's partition
(every in-band pair read once, every halo value pushed by its owner). The
kernels themselves run on the card in chip_smoke.py phase 11."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modulation_mfcc_tpu.pallas.viterbi import viterbi_decode_pallas, viterbi_forward_pallas
from modulation_mfcc_tpu_torch.kernels import viterbi as V
from modulation_mfcc_tpu_torch.ops import yin as Y
from tests.test_torch_viterbi import C_STAY, C_SW, WIDE, same_bits

torch.set_num_threads(1)

# (fmin, fmax, resolution) of pyin's transitions at 16 kHz -> (n_bins, h)
PYIN = {(75.0, 600.0, 0.1): (361, 21), (65.406, 2093.0, 0.05): (1201, 43), (75.0, 600.0, 0.025): (1441, 86),
        (75.0, 600.0, 0.01): (3601, 215), (65.406, 2093.0, 0.01): (6001, 215)}


def pyin_log_tri(fmin: float, fmax: float, res: float) -> tuple[np.ndarray, V.Band]:
    g = Y.pyin_geometry(16_000.0, fmin, fmax, resolution=res)
    return Y._log_tri(g, torch.float32), Y.pyin_band(g, torch.float32)


@pytest.mark.parametrize("geo", PYIN)
def test_pyin_transitions_are_toeplitz(geo):
    """pyin's designed transitions at 361 to 6,001 bins report their window
    with rows [h, n − 1 − h]: every interior row's 2h + 1 in-band entries
    have the window's bits, the edge rows' do not; viterbi_band on the
    tensor gives the host design's band (pyin_band), window and rows."""
    lt, band = pyin_log_tri(*geo)
    n, h = PYIN[geo]
    assert lt.shape == (n, n) and band[0] == h and band.rows == (h, n - 1 - h)
    win = band.window
    assert win.dtype == np.float32 and win.shape == (2 * h + 1,)
    assert same_bits(win, lt[h, : 2 * h + 1])
    rows = np.lib.stride_tricks.sliding_window_view(np.pad(lt, ((0, 0), (h, h))), 2 * h + 1, axis=1)
    inband = rows[np.arange(n), np.arange(n)]  # [u, k]: log_tri[u, u − h + k] (0 past the edges)
    interior = np.arange(h, n - h)
    assert (inband[interior].view(np.int32) == win.view(np.int32)).all()
    assert not (inband[:h].view(np.int32) == win.view(np.int32)).all(1).any()
    assert not (inband[n - h :].view(np.int32) == win.view(np.int32)).all(1).any()
    got = V.viterbi_band(torch.tensor(lt))
    assert got == band and got.rows == band.rows and same_bits(got.window, win)


@pytest.mark.parametrize("kind", ["ulp", "random", "edge"])
def test_toeplitz_detection_is_exact(kind):
    """One interior entry of pyin's 1,201-bin transition moved by one ulp, or
    a random band of the same reach, has no window (the band itself stays);
    an edge row changed keeps it: the edge rows are read from log_tri."""
    lt, band = pyin_log_tri(65.406, 2093.0, 0.05)
    lt = lt.copy()
    h = band[0]
    if kind == "ulp":
        lt[600, 610] = np.nextafter(lt[600, 610], np.float32(0.0))
    elif kind == "random":
        rng = np.random.default_rng(7)
        dist = np.abs(np.arange(1201)[:, None] - np.arange(1201)[None, :])
        lt = np.where(dist <= h, rng.uniform(-10.0, -1.0, lt.shape), band[1]).astype(np.float32)
        lt[dist == h] = -5.0
    else:
        lt[3, 10] = np.float32(-3.0)
    got = V.viterbi_band(torch.tensor(lt))
    assert got == (h, band[1])
    if kind == "edge":
        assert got.rows == (h, 1201 - 1 - h) and same_bits(got.window, band.window)
        assert V.band_layout(1201, h, got.rows) == "toeplitz"
    else:
        assert got.window is None and got.rows is None
        assert V.band_layout(1201, h, got.rows) == V.band_layout(1201, h) == "L2"
        assert V.backtrace_layout(1201, h, got.rows) == "L2"


def pyin_trellis_1201(nf: int = 6, batch: int = 2):
    """Random observations [2, NF, 2n] on pyin's own transition at 1,201 bins
    (librosa's C2-C7 at resolution 0.05, h = 43)."""
    lt, band = pyin_log_tri(65.406, 2093.0, 0.05)
    rng = np.random.default_rng(43)
    log_obs = np.log(rng.random((batch, nf, 2 * 1201)) + 1e-12).astype(np.float32)
    delta0 = np.log(rng.random((batch, 2 * 1201)) + 1e-12).astype(np.float32)
    return log_obs, delta0, lt, band


def test_compact_forward_matches_dense_and_pallas_at_1201_bins():
    """The toeplitz forward's compact step, written plainly (the window for
    interior sources, log_tri's edge rows, the floor term), gives the dense
    plain version's δ history and δ_f bit for bit, and JAX
    viterbi_forward_pallas's (interpret mode), on pyin's transition at
    1,201 bins; the CPU wrapper, given the band and a cluster, takes the
    plain version."""
    log_obs, delta0, lt, band = pyin_trellis_1201()
    args = (torch.tensor(log_obs), torch.tensor(delta0), torch.tensor(lt), C_STAY, C_SW)
    got_f, got_hist = V.viterbi_forward_toeplitz_reference(*args, band)
    want_f, want_hist = V.viterbi_forward_reference(*args)
    assert same_bits(got_f, want_f) and same_bits(got_hist, want_hist)
    before = dict(V.LAUNCHES)
    wrap_f, wrap_hist = V.viterbi_forward(*args, band, cluster=8)
    assert same_bits(wrap_f, want_f) and same_bits(wrap_hist, want_hist) and V.LAUNCHES == before
    for b in range(2):
        jf, jhist = viterbi_forward_pallas(jnp.asarray(log_obs[b]), jnp.asarray(delta0[b]), jnp.asarray(lt),
                                           C_STAY, C_SW, interpret=True)
        assert same_bits(got_f[b], jf) and same_bits(got_hist[b], jhist)


def test_compact_backtrace_matches_dense_and_pallas_at_1201_bins():
    """The toeplitz backtrace's scores, written plainly (toeplitz_band: the
    window where the source is an interior row, log_tri where it is an edge
    row), are backtrace_band's bit for bit, and its paths are the dense
    plain version's and JAX viterbi_decode_pallas's (interpret mode), on
    pyin's transition at 1,201 bins."""
    log_obs, delta0, lt, band = pyin_trellis_1201()
    tri = torch.tensor(lt)
    assert same_bits(V.toeplitz_band(tri, band), V.backtrace_band(tri, band))
    args = (torch.tensor(log_obs), torch.tensor(delta0), tri, C_STAY, C_SW)
    delta_f, hist = V.viterbi_forward_reference(*args)
    got = V.viterbi_backtrace_toeplitz_reference(hist, delta_f, tri, C_STAY, C_SW, band)
    want = V.viterbi_backtrace_reference(hist, delta_f, tri, C_STAY, C_SW)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(V.viterbi_decode(*args, band), want)
    for b in range(2):
        jpath = viterbi_decode_pallas(jnp.asarray(log_obs[b]), jnp.asarray(delta0[b]), jnp.asarray(lt), C_STAY, C_SW,
                                      interpret=True)
        assert np.array_equal(got[b].numpy(), np.asarray(jpath))


# (n, h) of the partition's mirror: one bin past 1,024 (pyin's band there),
# pyin's 1,201, 3,601 and 6,001 bins, and the triangle band at 14,497 bins
# that chip_smoke.py builds on the card
PARTITIONS = [(1025, 21), (1201, 43), (3601, 215), (6001, 215), (14497, 215)]


def mirror_partition(n: int, h: int, plan: V.ClusterPlan) -> None:
    """The kernel's index arithmetic for one step, rank by rank: the sweep
    (groups of 4 targets, split runs of window offsets, float4 loads of m
    from a slide of 7 sources), the edge loop (edge rows from the rank's
    table) and the pushes (an owner writes m of source v into every rank
    whose targets reach v: an interior source into its m slot, an edge row
    into the edge rows' m). Asserts every (target, in-band source) pair is
    read exactly once, from a slot or edge entry its owner pushed, every
    other read slot stays −inf or meets a −inf window entry, and every
    address lies inside its buffer."""
    lo, hi = h, n - 1 - h
    k0, kspan, split = plan.k0, plan.kspan, plan.split
    lm, seg = 4 * plan.ng + kspan, kspan // 4 // split
    bounds = np.asarray(plan.bounds)
    edge_rows = np.r_[0:lo, hi + 1 : n]
    emax = 0
    for q in range(plan.g):
        t0, t1 = int(bounds[q]), int(bounds[q + 1])
        base = t0 + h - k0 - kspan + 1
        assert base % 4 == 0 and t0 % 4 == 0
        # pushes into rank q: every source v that its targets reach, by v's owner
        src = np.arange(max(0, t0 - h), min(n, t1 + h))
        owner = np.searchsorted(bounds, src, side="right") - 1
        assert ((bounds[owner] <= src) & (src < bounds[owner + 1])).all()
        inner = (src >= lo) & (src <= hi)
        pushed = np.zeros(lm, bool)
        slots = src[inner] - base
        assert slots.min() >= 0 and slots.max() < lm
        pushed[slots] = True
        pushed_edges = set(src[~inner].tolist())
        # the sweep
        ngr = -(-(t1 - t0) // 4)
        grp, kseg, bi, dk, j = np.meshgrid(np.arange(ngr), np.arange(split), np.arange(seg), np.arange(4),
                                           np.arange(4), indexing="ij")
        c = 4 * grp - 4 * kseg * seg + kspan - 1 - 4 * bi
        assert (c % 4 == 3).all() and (c - 3).min() >= 0 and (c + 4).max() < lm  # the float4 loads
        slot, k, v = c + j - dk, k0 + 4 * (kseg * seg + bi) + dk, t0 + 4 * grp + j
        assert (base + slot == v + h - k).all()
        live = (k >= 0) & (k <= 2 * h) & (v < t1)  # a finite window entry into a real target
        u = (base + slot)[live]
        in_matrix = (u >= 0) & (u < n)
        inner_read = in_matrix & (u >= lo) & (u <= hi)
        assert pushed[slot[live][inner_read]].all()          # an interior source: its owner's push
        assert not pushed[slot[live][~inner_read]].any()     # an edge row or past the matrix: −inf
        pairs = [v[live][inner_read] * n + u[inner_read]]
        # the edge phase: each window of 128 targets walks the edge rows within h of it, the rows split in
        # chunks over the warps; a lane reads a float4 of its 4 targets' weights from the row's padded run
        run_a, run_len = V._table_runs(t0, t1, n, h, lo, hi)
        offsets = np.r_[0, np.cumsum(run_len)]
        assert (offsets % 4 == 0).all() and (run_a % 4 == 0).all()
        table = {}  # the staged table: entry -> the (row, target) it holds, or None (−inf)
        for e_ in range(len(edge_rows)):
            for j in range(run_len[e_]):
                vv_, uu_ = run_a[e_] + j, edge_rows[e_]
                table[offsets[e_] + j] = (uu_, vv_) if abs(int(uu_) - int(vv_)) <= h and vv_ < t1 else None
        nwin = -(-(t1 - t0) // 128)
        nch = max(1, V._TOE_WARPS // nwin)
        for item in range(nwin * nch):
            w0 = t0 + 128 * (item // nch)
            w1 = min(t1, w0 + 128) - 1
            a0, b0 = max(0, w0 - h), max(hi + 1, w0 - h)
            nlow = max(0, min(lo, w1 + h + 1) - a0)
            nrows = nlow + max(0, min(n, w1 + h + 1) - b0)
            per_ch = -(-nrows // nch)
            for r in range((item % nch) * per_ch, min(nrows, (item % nch + 1) * per_ch)):
                u_ = a0 + r if r < nlow else b0 + r - nlow
                e_ = u_ if u_ < lo else lo + u_ - hi - 1
                for v0 in range(w0, w0 + 128, 4):
                    if not run_a[e_] <= v0 < run_a[e_] + run_len[e_]:
                        continue
                    at = offsets[e_] + v0 - run_a[e_]
                    assert at % 4 == 0 and at + 4 <= offsets[e_ + 1]  # an aligned float4 inside the run
                    for j in range(4):
                        held = table[at + j]
                        assert held is None or held == (u_, v0 + j)
                        if held is not None and v0 + j <= w1:
                            assert u_ in pushed_edges
                            pairs.append(np.array([(v0 + j) * n + u_]))
        emax = max(emax, int(offsets[-1]))
        # every in-band pair of the rank's targets exactly once
        got = np.concatenate(pairs)
        uniq, counts = np.unique(got, return_counts=True)
        tv = np.arange(t0, t1)
        want = int((np.minimum(n - 1, tv + h) - np.maximum(0, tv - h) + 1).sum())
        assert (counts == 1).all() and len(uniq) == want
    assert emax == plan.emax


@pytest.mark.parametrize("n,h", PARTITIONS)
def test_cluster_partition_mirror(n, h):
    """At every cluster size with a plan (the rule picks one of 1, 2, 4, 8,
    16), the ranks cover the n targets in order, each holds a target at
    least and fits a block's shared memory, and one step of the
    kernel's reads and pushes (mirror_partition) reads every (target,
    in-band source) pair exactly once from what its owner pushed."""
    rows = (h, n - 1 - h)
    plans = {g: V.cluster_plan(n, h, rows, g) for g in (1, 2, 4, 8, 16)}
    rule = V.cluster_plan(n, h, rows)
    assert rule is not None and rule == plans[rule.g]
    for g, plan in plans.items():
        if plan is None:
            continue
        b = np.asarray(plan.bounds)
        assert plan.g == g and b[0] == 0 and b[-1] == n and (np.diff(b) >= 1).all()
        assert plan.smem <= V._SMEM_LIMIT and plan.smem == V.forward_bytes(n, h, "toeplitz", rows) or g != rule.g
        mirror_partition(n, h, plan)
