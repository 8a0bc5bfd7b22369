"""The pyin Viterbi decode, through two CUDA kernels.

pyin decodes 2·n states (n pitch bins, voiced then unvoiced) with the
transition ``kron([[1−s, s], [s, 1−s]], tri)``. In max-plus (log) space the
block structure factors each step into an elementwise [n] max and two
[n, n] max-plus products against ``log_tri``:

    m_v = max(δ_v + log(1−s), δ_u + log s),  m_u = max(δ_v + log s, δ_u + log(1−s))
    δ'_v[v] = max_u (m_v[u] + log_tri[u, v]) + log_obs[t+1, v]     (δ'_u likewise)

The hand-written kernels of csrc/viterbi.cu replace the Pallas kernels of
modulation_mfcc_tpu/pallas/viterbi.py:

* ``viterbi_fwd_f32`` (wrapper :func:`viterbi_forward`) replaces ``_forward``
  → ``_fwd_kernel`` (per signal) and ``viterbi_decode_batched`` →
  ``_fwd_kernel_b`` (batched): the forward recursion, emitting the δ history
  and the final δ. It works on the band of ``log_tri``
  (:func:`viterbi_band`): with C = min(log_tri) and every entry farther than
  h from the diagonal equal to C, the max over the out-of-band sources is
  fl(max(m) + C), exactly, so a step reads 2h + 1 sources a target instead
  of n (pyin's transition: h = 21 of n = 361). Past 1,024 bins each of a
  block's 1,024 threads owns ⌈n/1,024⌉ targets (:func:`band_layout`); there,
  where the band is Toeplitz (pyin's: every interior row the same window,
  shifted), the window sits in shared memory and a thread-block cluster
  splits each utterance's targets (:func:`cluster_plan`, the 'toeplitz'
  layout);
* ``viterbi_bwd_f32`` (wrapper :func:`viterbi_backtrace`) replaces
  ``viterbi_decode_pallas`` → ``_bwd_kernel`` and ``viterbi_decode_batched``
  → ``_bwd_kernel_b``: the reverse backtrace over that history, first
  maximum on ties, the voiced block preferred on block ties. It works on the
  same band: a step's first maximum is that of the union of fl(m[u] + C)
  over every source (reduced off the chain of dependent steps) and the 2h + 1
  in-band scores at the next state's bin, read from the band staged in
  shared memory (:func:`backtrace_layout`). Past 1,024 bins the producers
  stream each history row in pieces and keep only the C candidates, and
  the chain reads its in-band sources from the history itself, so no
  shared-memory buffer grows with n; with a Toeplitz band it scores them
  against the window in shared memory and the edge rows of ``log_tri``.

Both take any n that device memory holds (tested to 14,497 bins; librosa's
C2-C7 at resolution 0.01 is 6,001; pyin's n_bins = ⌊12·⌈1/resolution⌉·
log2(fmax/fmin)⌋ + 1).

The TPU had a per-signal and a batched kernel of each pass only because of
``vmap``; here the grid carries the batch, so a single signal is a batch of
one. Adds and maxes are exact, so the kernels are bit-identical to their
plain PyTorch versions beside them (:func:`viterbi_forward_reference`,
:func:`viterbi_backtrace_reference`: the JAX package's ``vstep`` and
``back`` scans as loops over frames, batched over utterances).

Every function takes ``log_obs`` [NF, 2n] or [B, NF, 2n]. A wrapper takes
its plain version only for a CPU tensor; on a CUDA tensor it launches its
kernel (float32 only) or raises. ``LAUNCHES`` counts kernel launches.
:func:`viterbi_forward_banded_reference` and
:func:`viterbi_backtrace_banded_reference` are the kernels' banded steps
written plainly, and :func:`viterbi_forward_toeplitz_reference` and
:func:`viterbi_backtrace_toeplitz_reference` their compact steps (the window
and the edge rows), for the tests: they show the identities the kernels
stand on.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from modulation_mfcc_tpu_torch.kernels._launch import check_cuda, raise_on, route, stream_of

__all__ = [
    "LAUNCHES", "Band", "ClusterPlan", "viterbi_band", "band_layout", "backtrace_layout", "forward_bytes",
    "backtrace_bytes", "backtrace_band", "toeplitz_band", "cluster_plan", "cluster_partition", "viterbi_forward",
    "viterbi_backtrace", "viterbi_decode", "viterbi_forward_reference", "viterbi_forward_banded_reference",
    "viterbi_forward_toeplitz_reference", "viterbi_backtrace_reference", "viterbi_backtrace_banded_reference",
    "viterbi_backtrace_toeplitz_reference", "viterbi_decode_reference",
]

LAUNCHES = {"viterbi_fwd_f32": 0, "viterbi_bwd_f32": 0}

# the launchers' layout rules (csrc/viterbi.cu), mirrored by band_layout and backtrace_layout
_MAX_THREADS = 1024     # kMaxThreads: a forward block's threads, one a target up to this many targets
_RING_BINS = 1024       # kRingBins: the widest n of the backtrace's ring of (m, sel) rows
_MAX_WARPS = 32         # kMaxWarps: the forward's per-warp maxima
_SMEM_LIMIT = 232448    # kSmemLimit: shared-memory bytes a block may opt in to on sm_90
_MAX_REG_BAND = 64      # kMaxRegBand: the widest band a thread holds in registers,
_MAX_REG_THREADS = 512  # kMaxRegThreads: in blocks of at most this many threads
_AHEAD = 4              # kAhead: observation rows in flight
_SLOTS = 8              # kSlots: history rows a backtrace block holds ready, as (m, sel) pairs
_TOE_THREADS = 512      # kToeThreads: a block of the toeplitz forward
_TOE_WARPS = _TOE_THREADS // 32
_TOE_GROUP = 4          # kToeGroup: adjacent targets a thread sweeps together
_MAX_CLUSTER = 16       # kMaxCluster: the largest cluster a launch may be given
_RULE_CLUSTER = 16      # kRuleCluster: the largest cluster the rule picks (past 8 the non-portable size)
_TOE_SLICE = 512        # kToeSlice: the targets a rank takes before the rule doubles the cluster
_EDGE_COST = 3          # kEdgeCost: an edge entry against one window offset of one target (the balance)


class Band(tuple):
    """The band of a transition: unpacks as ``(h, C)`` and equals that pair
    (:func:`viterbi_band`). When the band is Toeplitz, ``window`` holds the
    2h + 1 values (the tensor's type) that every interior row carries and
    ``rows`` those rows (lo, hi) = (h, n − 1 − h): log_tri[u, u − h + k] has
    the bits of window[k] for every u in [lo, hi] and k in [0, 2h]. Both
    are None otherwise, as for a plain (h, C) pair."""

    def __new__(cls, h: int, floor: float, window: np.ndarray | None = None, rows: tuple[int, int] | None = None):
        band = super().__new__(cls, (h, floor))
        band.window, band.rows = window, rows
        return band

    def __repr__(self) -> str:
        return f"Band(h={self[0]}, C={self[1]!r}, rows={self.rows})"


def _rows_of(band) -> tuple[int, int] | None:
    """A band's Toeplitz rows (lo, hi), or None (a plain (h, C) pair too)."""
    return getattr(band, "rows", None)


def _batched(*tensors: torch.Tensor, ndim: int) -> tuple[bool, list[torch.Tensor]]:
    """(whether the first tensor carries a batch axis, the tensors with one)."""
    if tensors[0].ndim == ndim:
        return False, [t[None] for t in tensors]
    return True, list(tensors)


def _check_shapes(name: str, per_frame: torch.Tensor, per_utt: torch.Tensor, log_tri: torch.Tensor) -> int:
    """n; raises unless per_frame is [B, F, 2n], per_utt [B, 2n], log_tri [n, n]."""
    n = log_tri.shape[0]
    if (log_tri.shape != (n, n) or per_frame.ndim != 3 or per_frame.shape[-1] != 2 * n
            or per_utt.shape != (per_frame.shape[0], 2 * n)):
        raise ValueError(
            f"{name}: shapes {tuple(per_frame.shape)}, {tuple(per_utt.shape)}, {tuple(log_tri.shape)} "
            "are not [B, F, 2n], [B, 2n], [n, n]"
        )
    return n


# ---------------------------------------------------------------------------
# The band of log_tri
# ---------------------------------------------------------------------------


def viterbi_band(log_tri) -> Band:
    """The :class:`Band` (h, C) of a transition ``log_tri`` [n, n] (numpy
    array or tensor): C = min(log_tri) and h the largest |u − v| of an entry
    above C (0 when none is). The forward kernel relies on two conditions,
    checked here: every entry with |u − v| > h equals C, and no entry lies
    below C. Where they fail (a NaN), the band is (n − 1, −inf): the dense
    recursion, whose extra term fl(max(m) − inf) is −inf. The band is
    Toeplitz when every interior row u ∈ [h, n − 1 − h] carries row h's
    2h + 1 in-band values, shifted, bit for bit (each in-band entry of row u
    has the bits of the entry of row u + 1 one column on); then ``window``
    is row h's and ``rows`` = (h, n − 1 − h). A tensor on the card costs one
    device→host sync; :func:`viterbi_forward` caches the band per tensor."""
    t = torch.as_tensor(log_tri)
    n = t.shape[0]
    floor = t.min()
    idx = torch.arange(n, device=t.device)
    dist = (idx[:, None] - idx[None, :]).abs()
    h = torch.where(t > floor, dist, 0).max()
    ok = ((t == floor) | (dist <= h)).all() & (t >= floor).all()
    bits = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    shifted = ((bits[:-1, :-1] == bits[1:, 1:]) | (dist[:-1, :-1] > h)).all(1)  # row u against row u + 1
    interior = (idx[:-1] >= h) & (idx[:-1] < n - 1 - h)
    toeplitz = (shifted | ~interior).all() & (2 * h + 1 <= n)
    head = torch.stack([h.double(), floor.double(), ok.double(), toeplitz.double()])
    vals = torch.cat([head, t[h.clamp(max=n - 1)].double()]).cpu().numpy()  # the one sync: row h holds the window
    h, floor, ok, toeplitz = int(vals[0]), float(vals[1]), bool(vals[2]), bool(vals[3])
    if not ok:
        return Band(n - 1, float("-inf"))
    if not toeplitz:
        return Band(h, floor)
    window = vals[4 : 4 + 2 * h + 1].astype(np.float32 if t.dtype == torch.float32 else np.float64)
    return Band(h, floor, window, (h, n - 1 - h))


def forward_bytes(n: int, h: int, layout: str, rows: tuple[int, int] | None = None) -> int:
    """The shared memory of a ``viterbi_fwd_f32`` block in ``layout`` (the
    launcher's sums, fwd_smem_bytes, fwd_wide_smem_bytes and
    toe_smem_bytes): up to 1,024 bins, two m buffers of (m_v, m_u) pairs
    with the register layout's guard slots, the warp maxima, the ring of
    observation rows and the staged band; past them, m (not for 'history'),
    the maxima and the band; 'toeplitz' (a Toeplitz band's ``rows``) the
    block of :func:`cluster_plan`."""
    if layout == "toeplitz":
        return cluster_plan(n, h, rows).smem
    width = 2 * h + 1
    band = width * n if layout == "shared" else 0
    if n <= _MAX_THREADS:
        kw = next(w for w in (16, 32, 48, 64) if width <= w) if layout == "registers" else 0
        stride = n + max(kw - 1, 0)  # m_stride: the register layout's guard slots
        return 4 * (4 * stride + 4 * _MAX_WARPS + 2 * _AHEAD * (-(-n // 32) * 32) + band)
    return 4 * ((0 if layout == "history" else 4 * n) + 4 * _MAX_WARPS + band)


def band_layout(n: int, h: int, rows: tuple[int, int] | None = None) -> str:
    """Where ``viterbi_fwd_f32`` keeps the band of an n-bin transition of
    half-width h (the launcher's rule). Up to 1,024 bins (a thread a
    target): 'registers' (each thread its target's 2h + 1 sources, up to
    64, in blocks of at most 512 threads), else 'shared' (staged as
    [2h + 1, n], when narrower than the matrix and the block's shared memory
    holds it with m, the maxima and the ring of observation rows), else
    'L2' (log_tri itself). Past them: 'toeplitz' when the band is Toeplitz
    (``rows``, the :class:`Band`'s) and :func:`cluster_plan` finds a plan
    (the window in shared memory, a cluster of blocks an utterance); else
    each thread of one block takes ⌈n/1,024⌉ targets: 'shared' when the
    band fits beside m and the maxima, else 'L2' while m fits (n up to
    14,496), else 'history' (log_tri from L2, and each source's m
    recomputed from the history row the block wrote a step before)."""
    width = 2 * h + 1
    if n <= _MAX_THREADS and width <= _MAX_REG_BAND and n <= _MAX_REG_THREADS:
        return "registers"
    if n > _MAX_THREADS and rows is not None and cluster_plan(n, h, rows) is not None:
        return "toeplitz"
    if width <= n and forward_bytes(n, h, "shared") <= _SMEM_LIMIT:
        return "shared"
    if n <= _MAX_THREADS or forward_bytes(n, h, "L2") <= _SMEM_LIMIT:
        return "L2"
    return "history"


def backtrace_bytes(n: int, h: int, layout: str) -> int:
    """The shared memory of a ``viterbi_bwd_f32`` block in ``layout`` (the
    launcher's sums, bwd_smem_bytes, bwd_wide_smem_bytes and
    bwd_toe_smem_bytes): per slot two mbarriers and 8 words of C
    candidates, up to 1,024 bins the ring's (m, sel) pairs of both cases
    (16n bytes a slot), and the band where it is staged ('shared') or the
    window ('toeplitz')."""
    ring = 16 * n if n <= _RING_BINS else 0
    staged = {"shared": n * (2 * h + 1), "toeplitz": 2 * h + 1}.get(layout, 0)
    return _SLOTS * (48 + ring) + 4 * staged


def backtrace_layout(n: int, h: int, rows: tuple[int, int] | None = None) -> str:
    """Where ``viterbi_bwd_f32`` reads the transition of an n-bin band of
    half-width h (the launcher's rule): past 1,024 bins 'toeplitz' when the
    band is Toeplitz (``rows``, the :class:`Band`'s; the window in shared
    memory, the edge rows from ``log_tri``); else 'shared' (the band staged
    as [n, 2h + 1] beside the barriers, the C candidates and, up to 1,024
    bins, the ring of 8 rows of (m, sel) pairs, when they fit in a block's
    shared memory), else 'L2' (log_tri transposed: up to 1,024 bins every
    source scored, past them the in-band entries of row pos)."""
    if n > _RING_BINS and rows is not None and backtrace_bytes(n, h, "toeplitz") <= _SMEM_LIMIT:
        return "toeplitz"
    return "shared" if backtrace_bytes(n, h, "shared") <= _SMEM_LIMIT else "L2"


# ---------------------------------------------------------------------------
# The cluster of the toeplitz forward (the launcher's toe_partition and
# toe_plan, mirrored)
# ---------------------------------------------------------------------------


class ClusterPlan(NamedTuple):
    """How the toeplitz forward splits an utterance over a cluster."""

    g: int                   # blocks (ranks) in the cluster
    bounds: tuple[int, ...]  # rank r's targets [bounds[r], bounds[r + 1]), each bound but n a multiple of 4
    k0: int                  # window offsets swept: k0 .. k0 + kspan − 1 (−inf past [0, 2h])
    kspan: int
    ng: int                  # groups of 4 adjacent targets of the widest rank
    ne: int                  # edge rows: lo + n − 1 − hi
    emax: int                # edge-table floats of the fullest rank
    split: int               # threads that share a group's sweep (up to 8), each a run of offsets
    smem: int                # dynamic shared memory of a block


def _toe_span(h: int) -> tuple[int, int]:
    """(k0, kspan): the offsets a group sweeps start at k0 ≡ h + 1 (mod 4),
    so that its loads of m are aligned float4s, and span a multiple of 32,
    so that up to 8 threads split them."""
    k0 = 0 if (h + 1) % 4 == 0 else (h + 1) % 4 - 4
    return k0, -(-(2 * h + 1 - k0) // 32) * 32


def _edge_counts(v: np.ndarray, n: int, h: int, lo: int, hi: int) -> np.ndarray:
    """toe_edge_count: the edge rows within h of each target v (its column's
    entries the edge table holds)."""
    low = np.maximum(0, np.minimum(lo - 1, v + h) - np.maximum(0, v - h) + 1)
    return low + np.maximum(0, np.minimum(n - 1, v + h) - np.maximum(hi + 1, v - h) + 1)


def _edge_floats(t0: int, t1: int, n: int, h: int, lo: int, hi: int) -> int:
    """toe_edge_floats: the in-band edge entries of targets [t0, t1)."""
    return int(_edge_counts(np.arange(t0, t1), n, h, lo, hi).sum())


def _table_runs(t0: int, t1: int, n: int, h: int, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
    """toe_run of every edge row (in edge-row order): (first target of the
    run, its length), the run of targets in [t0, t1) within h of the row,
    its ends rounded out to multiples of 4 (0 where it is empty)."""
    u = np.r_[0:lo, hi + 1 : n]
    start, z = np.maximum(t0, u - h), np.minimum(t1, u + h + 1)
    a = start // 4 * 4
    return a, np.where(z > start, -(-z // 4) * 4 - a, 0)


def _table_floats(t0: int, t1: int, n: int, h: int, lo: int, hi: int) -> int:
    """toe_table_floats: a rank's edge table with its runs padded."""
    return int(_table_runs(t0, t1, n, h, lo, hi)[1].sum())


def _toe_bytes(h: int, ne: int, g: int, ng: int, e: int) -> int:
    """toe_smem_bytes: the window, two m buffers of both halves over 4·ng +
    kspan slots, the groups' maxima, two buffers of the edge rows' m, every
    rank's warp maxima (two buffers, two halves), the edge table's rows
    (an int4 each) and the table (``e`` floats, :func:`_table_floats`)."""
    kspan = _toe_span(h)[1]
    lm = 4 * ng + kspan
    return 4 * (kspan + 4 * lm + 8 * ng + 4 * ne + 4 * g * _TOE_WARPS + 4 * ne + e)


def _toe_split(n: int, h: int, lo: int, hi: int, g: int, share: int, e_cap: int, cost: int) -> list[int] | None:
    """toe_split: the ranks' bounds. Up to two ranks, even shares. Else from
    each end, while targets there read edge rows, a rank takes the share,
    less 4 targets at a time (not below 4) until its in-band edge entries
    fit ``e_cap`` and its work (kspan a target, 3 an edge entry) the
    cluster's average ``cost``; the ranks left (at least one) split the
    middle evenly."""
    kspan = _toe_span(h)[1]
    if g <= 2:
        return [min(n, r * share) for r in range(g)] + [n]
    low = [0]
    while low[-1] < lo + h and len(low) < g - 1:
        e = np.cumsum(_edge_counts(np.arange(low[-1], low[-1] + share), n, h, lo, hi))  # e[a - 1]: a targets
        a = share
        while a > 4 and (e[a - 1] > e_cap or kspan * a + _EDGE_COST * e[a - 1] > cost):
            a -= 4
        low.append(low[-1] + a)
    high = [n]
    while high[-1] > hi - h + 1 and len(low) + len(high) < g + 1:
        z = -(-(high[-1] - share) // 4) * 4
        e = np.cumsum(_edge_counts(np.arange(high[-1] - 1, z - 1, -1), n, h, lo, hi))  # e[k - 1]: top k targets
        while high[-1] - z > 4 and (e[high[-1] - z - 1] > e_cap
                                    or kspan * (high[-1] - z) + _EDGE_COST * e[high[-1] - z - 1] > cost):
            z += 4
        high.append(z)
    mid, a, z = g + 2 - len(low) - len(high), low[-1], high[-1]
    if z <= a:
        return None
    ms = -(-(-(-(z - a) // mid)) // 4) * 4
    return low + [min(z, a + i * ms) for i in range(1, mid)] + high[::-1]


@lru_cache(maxsize=256)
def cluster_partition(n: int, h: int, lo: int, hi: int, g: int) -> ClusterPlan | None:
    """The launcher's split of an n-bin Toeplitz band over a cluster of g
    ranks (its toe_partition), or None where none fits: shares of ⌈n/g⌉
    rounded up to 4 targets, end ranks shrunk until their edge tables fit
    the room that middle ranks of the widest slice leave and their work
    the cluster's average (:func:`_toe_split`), that room found again (up
    to 4 times) from the split it gives. Every rank holds a target at least
    and fits a block's shared memory."""
    if not 1 <= g <= _MAX_CLUSTER:
        return None
    k0, kspan = _toe_span(h)
    ne = lo + n - 1 - hi
    share = -(-(-(-n // g)) // 4) * 4
    if (g - 1) * share >= n:
        return None  # a rank without targets
    cost = -(-(kspan * n + _EDGE_COST * _edge_floats(0, n, n, h, lo, hi)) // g)
    ng_room = share // 4
    for _ in range(4):
        # the room for the edge table, less each row's padding (at most 6 floats) for the split's in-band count
        room = _SMEM_LIMIT // 4 - _toe_bytes(h, ne, g, ng_room, 0) // 4
        t = _toe_split(n, h, lo, hi, g, share, room - 6 * ne, cost) if room - 6 * ne >= 0 else None
        if t is None:
            return None
        sizes = [b - a for a, b in zip(t, t[1:])]
        edges = [_table_floats(a, b, n, h, lo, hi) for a, b in zip(t, t[1:])]
        if min(sizes) <= 0 or max(edges) > room:
            return None
        ng, emax = -(-max(sizes) // 4), max(edges)
        smem = _toe_bytes(h, ne, g, ng, emax)
        if smem <= _SMEM_LIMIT:
            split = next(s for s in (8, 4, 2, 1) if s * ng <= _TOE_THREADS or s == 1)
            return ClusterPlan(g, tuple(t), k0, kspan, ng, ne, emax, split, smem)
        ng_room = ng
    return None


def cluster_plan(n: int, h: int, rows: tuple[int, int] | None, cluster: int | None = None) -> ClusterPlan | None:
    """The toeplitz forward's plan for an n-bin Toeplitz band of
    half-width h and interior rows ``rows`` (the launcher's toe_plan), or
    None (no window, or no plan). ``cluster`` forces the cluster size;
    else the rule: the smallest of 1, 2, 4, 8, 16 ranks whose widest rank
    takes at most 512 targets, else the largest that fits (past 8 the
    cluster is non-portable, which the H100 schedules)."""
    if rows is None:
        return None
    lo, hi = rows
    if cluster:
        return cluster_partition(n, h, lo, hi, cluster)
    plan = None
    g = 1
    while g <= _RULE_CLUSTER:
        found = cluster_partition(n, h, lo, hi, g)
        if found is not None:
            plan = found
            if max(b - a for a, b in zip(found.bounds, found.bounds[1:])) <= _TOE_SLICE:
                break
        g *= 2
    return plan


def backtrace_band(log_tri: torch.Tensor, band: Band) -> torch.Tensor:
    """The backtrace kernel's band of ``log_tri`` [n, n] as it stages it in
    shared memory: [n, 2h + 1], entry [pos, j] = log_tri[pos − h + j, pos], C
    past the matrix's edges."""
    h, floor = band
    n = log_tri.shape[0]
    pos = torch.arange(n, device=log_tri.device)[:, None]
    u = pos - h + torch.arange(2 * h + 1, device=log_tri.device)[None, :]
    inside = (u >= 0) & (u < n)
    return torch.where(inside, log_tri[u.clamp(0, n - 1), pos.expand_as(u)], floor)


def toeplitz_band(log_tri: torch.Tensor, band: Band) -> torch.Tensor:
    """:func:`backtrace_band` as the compact layout sees it, from the
    Toeplitz band's window and ``log_tri``'s edge rows alone: entry [pos, j]
    (source u = pos − h + j) is window[2h − j] where u is an interior row,
    log_tri[u, pos] where it is an edge row, C past the matrix's edges."""
    h, floor = band
    lo, hi = band.rows
    n = log_tri.shape[0]
    pos = torch.arange(n, device=log_tri.device)[:, None]
    j = torch.arange(2 * h + 1, device=log_tri.device)[None, :]
    u = pos - h + j
    inside, interior = (u >= 0) & (u < n), (u >= lo) & (u <= hi)
    win = torch.as_tensor(band.window, device=log_tri.device).flip(0)
    edge = torch.where(inside, log_tri[u.clamp(0, n - 1), pos.expand_as(u)], floor)
    return torch.where(interior, win[j.expand_as(u)], edge)


# per log_tri tensor, (its version, what was derived from it), so an in-place edit derives it again
_BANDS: WeakIdKeyDictionary = WeakIdKeyDictionary()
_TRANSPOSED: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _cached(table: WeakIdKeyDictionary, log_tri: torch.Tensor, derive):
    hit = table.get(log_tri)
    if hit is None or hit[0] != log_tri._version:
        hit = (log_tri._version, derive(log_tri))
        table[log_tri] = hit
    return hit[1]


def _band_of(log_tri: torch.Tensor) -> Band:
    """viterbi_band of a tensor, once per tensor (and per in-place edit)."""
    return _cached(_BANDS, log_tri, viterbi_band)


def _transposed(log_tri: torch.Tensor) -> torch.Tensor:
    """log_tri transposed (row v = log_tri[:, v]) for the backtrace's L2
    layout, once per tensor (and per in-place edit)."""
    return _cached(_TRANSPOSED, log_tri, lambda t: t.t().contiguous())


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def viterbi_forward_reference(
    log_obs: torch.Tensor, delta0: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``viterbi_fwd_f32``: (delta_f [..., 2n],
    hist [..., NF−1, 2n]) with ``hist[t]`` = δ_t, the δ entering step t+1.
    ``c_stay`` = log(1−s) and ``c_sw`` = log s, already rounded to the
    tensors' type."""
    batched, (obs, d) = _batched(log_obs, delta0, ndim=2)
    n = _check_shapes("viterbi_forward", obs, d, log_tri)
    nf = obs.shape[1]
    hist = obs.new_empty((obs.shape[0], max(nf - 1, 0), 2 * n))
    for t in range(nf - 1):
        hist[:, t] = d
        d_v, d_u = d[:, :n], d[:, n:]
        m_v = torch.maximum(d_v + c_stay, d_u + c_sw)
        m_u = torch.maximum(d_v + c_sw, d_u + c_stay)
        new = torch.cat([(m_v[:, :, None] + log_tri).amax(1), (m_u[:, :, None] + log_tri).amax(1)], -1)
        d = new + obs[:, t + 1]
    return (d, hist) if batched else (d[0], hist[0])


def viterbi_forward_banded_reference(
    log_obs: torch.Tensor, delta0: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float,
    band: Band | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's banded step, written plainly: each target's maximum over
    the sources within h of it, then the maximum of that and fl(max(m) + C).
    Equal to :func:`viterbi_forward_reference` bit for bit whenever ``band``
    is :func:`viterbi_band`'s (derived here when None). Used by the tests."""
    h, floor = viterbi_band(log_tri) if band is None else band
    batched, (obs, d) = _batched(log_obs, delta0, ndim=2)
    n = _check_shapes("viterbi_forward", obs, d, log_tri)
    nf = obs.shape[1]
    idx = torch.arange(n, device=log_tri.device)
    in_band = (idx[:, None] - idx[None, :]).abs() <= h
    tri = torch.where(in_band, log_tri, -torch.inf)
    hist = obs.new_empty((obs.shape[0], max(nf - 1, 0), 2 * n))
    for t in range(nf - 1):
        hist[:, t] = d
        d_v, d_u = d[:, :n], d[:, n:]
        halves = []
        for m in (torch.maximum(d_v + c_stay, d_u + c_sw), torch.maximum(d_v + c_sw, d_u + c_stay)):
            near = (m[:, :, None] + tri).amax(1)
            halves.append(torch.maximum(near, m.amax(1, keepdim=True) + floor))
        d = torch.cat(halves, -1) + obs[:, t + 1]
    return (d, hist) if batched else (d[0], hist[0])


def viterbi_forward_toeplitz_reference(
    log_obs: torch.Tensor, delta0: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float, band: Band,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The toeplitz kernel's compact step, written plainly: each target's
    maximum over its interior sources, against the window (an edge row's m
    taken as −inf), and over its edge sources, against ``log_tri``'s edge
    rows; then the maximum of those and fl(max(m) + C). Equal to
    :func:`viterbi_forward_reference` bit for bit whenever ``band`` is a
    Toeplitz :func:`viterbi_band`. Used by the tests."""
    h, floor = band
    lo, hi = band.rows
    batched, (obs, d) = _batched(log_obs, delta0, ndim=2)
    n = _check_shapes("viterbi_forward", obs, d, log_tri)
    nf = obs.shape[1]
    idx = torch.arange(n, device=log_tri.device)
    interior = (idx >= lo) & (idx <= hi)
    win = torch.as_tensor(band.window, device=log_tri.device).flip(0)  # [j] = window[2h − j]: source v − h + j
    edge_rows = idx[~interior]
    edge_tri = torch.where((edge_rows[:, None] - idx[None, :]).abs() <= h, log_tri[edge_rows], -torch.inf)
    hist = obs.new_empty((obs.shape[0], max(nf - 1, 0), 2 * n))
    for t in range(nf - 1):
        hist[:, t] = d
        d_v, d_u = d[:, :n], d[:, n:]
        halves = []
        for m in (torch.maximum(d_v + c_stay, d_u + c_sw), torch.maximum(d_v + c_sw, d_u + c_stay)):
            m_in = torch.nn.functional.pad(torch.where(interior, m, -torch.inf), (h, h), value=-torch.inf)
            near = (m_in.unfold(-1, 2 * h + 1, 1) + win).amax(-1)  # [b, v, j]: source v − h + j
            edges = (m[:, ~interior, None] + edge_tri).amax(1)
            halves.append(torch.maximum(torch.maximum(near, edges), m.amax(1, keepdim=True) + floor))
        d = torch.cat(halves, -1) + obs[:, t + 1]
    return (d, hist) if batched else (d[0], hist[0])


def viterbi_backtrace_reference(
    hist: torch.Tensor, delta_f: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float
) -> torch.Tensor:
    """Plain PyTorch version of ``viterbi_bwd_f32``: the decoded state path
    [..., NF] (int32; state = bin, or bin + n when unvoiced) from the
    forward's history [..., NF−1, 2n] and final δ [..., 2n]. The last state
    is the first argmax of δ_f; each earlier one the first argmax over the
    sources of the kron-factored score, the voiced block winning block ties."""
    batched, (h, df) = _batched(hist, delta_f, ndim=2)
    n = _check_shapes("viterbi_backtrace", h, df, log_tri)
    nb, steps = h.shape[:2]
    trit = log_tri.t()  # row v = log_tri[:, v]
    stay = torch.tensor(c_stay, dtype=h.dtype, device=h.device)
    switch = torch.tensor(c_sw, dtype=h.dtype, device=h.device)
    path = torch.empty((nb, steps + 1), dtype=torch.int32, device=h.device)
    nxt = torch.argmax(df, -1)
    path[:, -1] = nxt
    for t in range(steps - 1, -1, -1):
        d = h[:, t]
        voiced = nxt < n
        pos = torch.where(voiced, nxt, nxt - n)
        a = torch.where(voiced, stay, switch)[:, None]
        b = torch.where(voiced, switch, stay)[:, None]
        from_v, from_u = d[:, :n] + a, d[:, n:] + b
        sel = from_u > from_v  # True: the source was unvoiced
        base = torch.argmax(torch.maximum(from_v, from_u) + trit[pos], -1)
        nxt = base + n * torch.gather(sel, 1, base[:, None])[:, 0]
        path[:, t] = nxt
    return path if batched else path[0]


def viterbi_backtrace_banded_reference(
    hist: torch.Tensor, delta_f: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float,
    band: Band | None = None,
) -> torch.Tensor:
    """The backtrace kernel's banded step, written plainly: the first maximum
    of fl(m[u] + C) over every source, the first maximum of the in-band scores
    m[u] + band[pos, u − pos + h] (:func:`backtrace_band`), and of the two the
    larger, the lower index on equal values; each first maximum is the
    largest value, then the least index holding it (±0 equal), as the kernel
    reduces. Equal to :func:`viterbi_backtrace_reference` bit for bit
    whenever ``band`` is :func:`viterbi_band`'s (derived here when None).
    Used by the tests."""
    h, floor = viterbi_band(log_tri) if band is None else band
    return _banded_backtrace(hist, delta_f, log_tri, c_stay, c_sw, (h, floor), backtrace_band(log_tri, (h, floor)))


def viterbi_backtrace_toeplitz_reference(
    hist: torch.Tensor, delta_f: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float, band: Band,
) -> torch.Tensor:
    """The toeplitz backtrace's step, written plainly: the banded step of
    :func:`viterbi_backtrace_banded_reference` with each in-band score
    taken against the window for an interior source and against
    ``log_tri`` for an edge row (:func:`toeplitz_band`). Equal to
    :func:`viterbi_backtrace_reference` bit for bit whenever ``band`` is a
    Toeplitz :func:`viterbi_band`. Used by the tests."""
    return _banded_backtrace(hist, delta_f, log_tri, c_stay, c_sw, band, toeplitz_band(log_tri, band))


def _banded_backtrace(hist, delta_f, log_tri, c_stay, c_sw, band, tri_band) -> torch.Tensor:
    """The banded backtrace step over ``tri_band`` [n, 2h + 1] (entry [pos, j]
    the weight of source pos − h + j into pos)."""
    h, floor = band
    batched, (hb, df) = _batched(hist, delta_f, ndim=2)
    n = _check_shapes("viterbi_backtrace", hb, df, log_tri)
    nb, steps = hb.shape[:2]
    src = torch.arange(n, device=hb.device)
    offs = torch.arange(2 * h + 1, device=hb.device)
    stay = torch.tensor(c_stay, dtype=hb.dtype, device=hb.device)
    switch = torch.tensor(c_sw, dtype=hb.dtype, device=hb.device)

    def first_max(vals: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        top = torch.where(ok, vals, -torch.inf).amax(-1)
        return top, torch.where(ok & (vals == top[:, None]), idx, torch.iinfo(idx.dtype).max).amin(-1)

    path = torch.empty((nb, steps + 1), dtype=torch.int32, device=hb.device)
    nxt = first_max(df, torch.arange(2 * n, device=hb.device).expand_as(df), torch.ones_like(df, dtype=torch.bool))[1]
    path[:, -1] = nxt
    for t in range(steps - 1, -1, -1):
        d = hb[:, t]
        voiced = nxt < n
        pos = torch.where(voiced, nxt, nxt - n)
        from_v = d[:, :n] + torch.where(voiced, stay, switch)[:, None]
        from_u = d[:, n:] + torch.where(voiced, switch, stay)[:, None]
        m = torch.maximum(from_v, from_u)
        all_src = torch.ones_like(m, dtype=torch.bool)
        v_off, i_off = first_max(m + floor, src.expand_as(m), all_src)
        u = pos[:, None] - h + offs[None, :]
        ok = (u >= 0) & (u < n)
        uc = u.clamp(0, n - 1)
        v_in, i_in = first_max(torch.gather(m, 1, uc) + tri_band[pos], uc, ok)
        base = torch.where((v_off > v_in) | ((v_off == v_in) & (i_off < i_in)), i_off, i_in)
        nxt = base + n * torch.gather(from_u > from_v, 1, base[:, None])[:, 0]
        path[:, t] = nxt
    return path if batched else path[0]


def viterbi_decode_reference(
    log_obs: torch.Tensor, delta0: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float
) -> torch.Tensor:
    """Plain decode: the state path [..., NF] (int32); with one frame, the
    first argmax of δ_0."""
    if log_obs.shape[-2] == 1:
        return torch.argmax(delta0, -1, keepdim=True).to(torch.int32)
    delta_f, hist = viterbi_forward_reference(log_obs, delta0, log_tri, c_stay, c_sw)
    return viterbi_backtrace_reference(hist, delta_f, log_tri, c_stay, c_sw)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from modulation_mfcc_tpu_torch.kernels._build import load_library

    lib = load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.viterbi_fwd_f32.argtypes = [p, p, p, p, p, i, i, i, i, f, f, f, i, i, i, p]
    lib.viterbi_fwd_f32.restype = i
    lib.viterbi_bwd_f32.argtypes = [p, p, p, p, p, i, i, i, i, f, f, f, i, i, p]
    lib.viterbi_bwd_f32.restype = i
    return lib


def viterbi_forward(
    log_obs: torch.Tensor, delta0: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float,
    band: Band | None = None, cluster: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(delta_f [..., 2n], hist [..., NF−1, 2n]) of the forward recursion
    over log_obs [..., NF, 2n] from delta0 [..., 2n] (JAX
    ``viterbi_forward_pallas``'s return values, unpadded). ``band`` is
    :func:`viterbi_band` of ``log_tri``, when the caller designed it on the
    host; None derives it from the tensor, once per tensor. With a Toeplitz
    band past 1,024 bins the kernel reads the window from row lo of
    ``log_tri`` on the card (nothing is copied). ``cluster`` forces the
    cluster size of the 'toeplitz' layout (:func:`cluster_partition`; the
    launch raises where it has no plan or the card refuses the cluster);
    None takes the launcher's rule (:func:`cluster_plan`)."""
    if not route(log_obs, "viterbi_forward"):
        return viterbi_forward_reference(log_obs, delta0, log_tri, c_stay, c_sw)
    check_cuda("viterbi_forward", log_obs, delta0, log_tri)
    batched, (obs, d0) = _batched(log_obs, delta0, ndim=2)
    n = _check_shapes("viterbi_forward", obs, d0, log_tri)
    band = _band_of(log_tri) if band is None else band
    h, floor = band
    _check_band("viterbi_forward", (h, floor), n)
    lo, hi = _rows_of(band) or (-1, -1)
    nb, nf = obs.shape[:2]
    hist = obs.new_empty((nb, nf - 1, 2 * n))
    delta_f = obs.new_empty((nb, 2 * n))
    rc = _lib().viterbi_fwd_f32(
        obs.data_ptr(), d0.data_ptr(), log_tri.data_ptr(), hist.data_ptr(), delta_f.data_ptr(),
        nb, nf, n, h, floor, c_stay, c_sw, lo, hi, cluster or 0, stream_of(obs),
    )
    raise_on(rc, "viterbi_fwd_f32")
    LAUNCHES["viterbi_fwd_f32"] += 1
    return (delta_f, hist) if batched else (delta_f[0], hist[0])


def _check_band(name: str, band: Band, n: int) -> None:
    if not 0 <= band[0] < n:
        raise ValueError(f"{name}: band half-width {band[0]} is not in [0, {n})")


def viterbi_backtrace(
    hist: torch.Tensor, delta_f: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float,
    band: Band | None = None,
) -> torch.Tensor:
    """The state path [..., NF] (int32) from the forward's history
    [..., NF−1, 2n] and final δ [..., 2n] (JAX ``viterbi_decode_pallas``'s
    backtrace). ``band`` as for :func:`viterbi_forward`; the kernel reads
    the band where :func:`backtrace_layout` says, and for 'L2' the transposed
    ``log_tri``, made once per tensor ('toeplitz' makes no copy)."""
    if not route(hist, "viterbi_backtrace"):
        return viterbi_backtrace_reference(hist, delta_f, log_tri, c_stay, c_sw)
    check_cuda("viterbi_backtrace", hist, delta_f, log_tri)
    batched, (hb, df) = _batched(hist, delta_f, ndim=2)
    n = _check_shapes("viterbi_backtrace", hb, df, log_tri)
    band = _band_of(log_tri) if band is None else band
    h, floor = band
    _check_band("viterbi_backtrace", (h, floor), n)
    rows = _rows_of(band)
    log_tri_t = _transposed(log_tri).data_ptr() if backtrace_layout(n, h, rows) == "L2" else None
    lo, hi = rows or (-1, -1)
    nb, nf = hb.shape[0], hb.shape[1] + 1
    path = torch.empty((nb, nf), dtype=torch.int32, device=hb.device)
    rc = _lib().viterbi_bwd_f32(
        hb.data_ptr(), df.data_ptr(), log_tri.data_ptr(), log_tri_t, path.data_ptr(), nb, nf, n, h, floor,
        c_stay, c_sw, lo, hi, stream_of(hb),
    )
    raise_on(rc, "viterbi_bwd_f32")
    LAUNCHES["viterbi_bwd_f32"] += 1
    return path if batched else path[0]


def viterbi_decode(
    log_obs: torch.Tensor, delta0: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float,
    band: Band | None = None,
) -> torch.Tensor:
    """The decoded state path [..., NF] (int32): one forward and one
    backtrace launch on a CUDA tensor; with one frame, the first argmax of
    δ_0 and no launch (JAX ``viterbi_decode_pallas`` /
    ``viterbi_decode_batched``). ``band`` as for :func:`viterbi_forward`,
    and both kernels take it."""
    if not route(log_obs, "viterbi_decode"):
        return viterbi_decode_reference(log_obs, delta0, log_tri, c_stay, c_sw)
    if log_obs.shape[-2] == 1:
        return torch.argmax(delta0, -1, keepdim=True).to(torch.int32)
    if band is None:
        band = _band_of(log_tri)
    delta_f, hist = viterbi_forward(log_obs, delta0, log_tri, c_stay, c_sw, band)
    return viterbi_backtrace(hist, delta_f, log_tri, c_stay, c_sw, band)
