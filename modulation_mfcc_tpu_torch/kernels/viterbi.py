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
  block's 1,024 threads owns ⌈n/1,024⌉ targets (:func:`band_layout`);
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
  shared-memory buffer grows with n.

Both take any n that device memory holds (tested to 6,001 bins: librosa's
C2-C7 at resolution 0.01; pyin's n_bins = ⌊12·⌈1/resolution⌉·log2(fmax/
fmin)⌋ + 1).

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
written plainly, for the tests: they show the identities the kernels stand
on.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
from torch.utils.weak import WeakIdKeyDictionary

from modulation_mfcc_tpu_torch.kernels._launch import check_cuda, raise_on, route, stream_of

__all__ = [
    "LAUNCHES", "viterbi_band", "band_layout", "backtrace_layout", "forward_bytes", "backtrace_bytes", "backtrace_band",
    "viterbi_forward", "viterbi_backtrace", "viterbi_decode", "viterbi_forward_reference",
    "viterbi_forward_banded_reference", "viterbi_backtrace_reference", "viterbi_backtrace_banded_reference",
    "viterbi_decode_reference",
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

Band = tuple[int, float]  # (h, C) of viterbi_band


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
    """(h, C) of a transition ``log_tri`` [n, n] (numpy array or tensor):
    C = min(log_tri) and h the largest |u − v| of an entry above C (0 when
    none is). The forward kernel relies on two conditions, checked here:
    every entry with |u − v| > h equals C, and no entry lies below C. Where
    they fail (a NaN), the band is (n − 1, −inf): the dense recursion, whose
    extra term fl(max(m) − inf) is −inf. A tensor on the card costs one
    device→host sync; :func:`viterbi_forward` caches the band per tensor."""
    t = torch.as_tensor(log_tri)
    n = t.shape[0]
    floor = t.min()
    idx = torch.arange(n, device=t.device)
    dist = (idx[:, None] - idx[None, :]).abs()
    h = torch.where(t > floor, dist, 0).max()
    ok = ((t == floor) | (dist <= h)).all() & (t >= floor).all()
    h, floor, ok = torch.stack([h.double(), floor.double(), ok.double()]).tolist()  # the one sync
    return (int(h), floor) if ok else (n - 1, float("-inf"))


def forward_bytes(n: int, h: int, layout: str) -> int:
    """The shared memory of a ``viterbi_fwd_f32`` block in ``layout`` (the
    launcher's sums, fwd_smem_bytes and fwd_wide_smem_bytes): up to 1,024
    bins, two m buffers of (m_v, m_u) pairs with the register layout's
    guard slots, the warp maxima, the ring of observation rows and the
    staged band; past them, m (not for 'history'), the maxima and the band."""
    width = 2 * h + 1
    band = width * n if layout == "shared" else 0
    if n <= _MAX_THREADS:
        kw = next(w for w in (16, 32, 48, 64) if width <= w) if layout == "registers" else 0
        stride = n + max(kw - 1, 0)  # m_stride: the register layout's guard slots
        return 4 * (4 * stride + 4 * _MAX_WARPS + 2 * _AHEAD * (-(-n // 32) * 32) + band)
    return 4 * ((0 if layout == "history" else 4 * n) + 4 * _MAX_WARPS + band)


def band_layout(n: int, h: int) -> str:
    """Where ``viterbi_fwd_f32`` keeps the band of an n-bin transition of
    half-width h (the launcher's rule). Up to 1,024 bins (a thread a
    target): 'registers' (each thread its target's 2h + 1 sources, up to
    64, in blocks of at most 512 threads), else 'shared' (staged as
    [2h + 1, n], when narrower than the matrix and the block's shared memory
    holds it with m, the maxima and the ring of observation rows), else
    'L2' (log_tri itself). Past them (each thread ⌈n/1,024⌉ targets):
    'shared' when the band fits beside m and the maxima, else 'L2' while m
    fits (n up to 14,496), else 'history' (log_tri from L2, and each
    source's m recomputed from the history row the block wrote a step
    before)."""
    width = 2 * h + 1
    if n <= _MAX_THREADS and width <= _MAX_REG_BAND and n <= _MAX_REG_THREADS:
        return "registers"
    if width <= n and forward_bytes(n, h, "shared") <= _SMEM_LIMIT:
        return "shared"
    if n <= _MAX_THREADS or forward_bytes(n, h, "L2") <= _SMEM_LIMIT:
        return "L2"
    return "history"


def backtrace_bytes(n: int, h: int, layout: str) -> int:
    """The shared memory of a ``viterbi_bwd_f32`` block in ``layout`` (the
    launcher's sums, bwd_smem_bytes and bwd_wide_smem_bytes): per slot two
    mbarriers and 8 words of C candidates, up to 1,024 bins the ring's
    (m, sel) pairs of both cases (16n bytes a slot), and the band where it
    is staged ('shared')."""
    ring = 16 * n if n <= _RING_BINS else 0
    return _SLOTS * (48 + ring) + (4 * n * (2 * h + 1) if layout == "shared" else 0)


def backtrace_layout(n: int, h: int) -> str:
    """Where ``viterbi_bwd_f32`` reads the transition of an n-bin band of
    half-width h (the launcher's rule): 'shared' (the band staged as [n,
    2h + 1] beside the barriers, the C candidates and, up to 1,024 bins,
    the ring of 8 rows of (m, sel) pairs, when they fit in a block's shared
    memory), else 'L2' (log_tri transposed: up to 1,024 bins every source
    scored, past them the in-band entries of row pos)."""
    return "shared" if backtrace_bytes(n, h, "shared") <= _SMEM_LIMIT else "L2"


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
    batched, (hb, df) = _batched(hist, delta_f, ndim=2)
    n = _check_shapes("viterbi_backtrace", hb, df, log_tri)
    nb, steps = hb.shape[:2]
    tri_band = backtrace_band(log_tri, (h, floor))
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
    lib.viterbi_fwd_f32.argtypes = [p, p, p, p, p, i, i, i, i, f, f, f, p]
    lib.viterbi_fwd_f32.restype = i
    lib.viterbi_bwd_f32.argtypes = [p, p, p, p, p, i, i, i, i, f, f, f, p]
    lib.viterbi_bwd_f32.restype = i
    return lib


def viterbi_forward(
    log_obs: torch.Tensor, delta0: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float,
    band: Band | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(delta_f [..., 2n], hist [..., NF−1, 2n]) of the forward recursion
    over log_obs [..., NF, 2n] from delta0 [..., 2n] (JAX
    ``viterbi_forward_pallas``'s return values, unpadded). ``band`` is
    :func:`viterbi_band` of ``log_tri``, when the caller designed it on the
    host; None derives it from the tensor, once per tensor."""
    if not route(log_obs, "viterbi_forward"):
        return viterbi_forward_reference(log_obs, delta0, log_tri, c_stay, c_sw)
    check_cuda("viterbi_forward", log_obs, delta0, log_tri)
    batched, (obs, d0) = _batched(log_obs, delta0, ndim=2)
    n = _check_shapes("viterbi_forward", obs, d0, log_tri)
    h, floor = _band_of(log_tri) if band is None else band
    _check_band("viterbi_forward", (h, floor), n)
    nb, nf = obs.shape[:2]
    hist = obs.new_empty((nb, nf - 1, 2 * n))
    delta_f = obs.new_empty((nb, 2 * n))
    rc = _lib().viterbi_fwd_f32(
        obs.data_ptr(), d0.data_ptr(), log_tri.data_ptr(), hist.data_ptr(), delta_f.data_ptr(),
        nb, nf, n, h, floor, c_stay, c_sw, stream_of(obs),
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
    ``log_tri``, made once per tensor."""
    if not route(hist, "viterbi_backtrace"):
        return viterbi_backtrace_reference(hist, delta_f, log_tri, c_stay, c_sw)
    check_cuda("viterbi_backtrace", hist, delta_f, log_tri)
    batched, (hb, df) = _batched(hist, delta_f, ndim=2)
    n = _check_shapes("viterbi_backtrace", hb, df, log_tri)
    h, floor = _band_of(log_tri) if band is None else band
    _check_band("viterbi_backtrace", (h, floor), n)
    log_tri_t = _transposed(log_tri).data_ptr() if backtrace_layout(n, h) == "L2" else None
    nb, nf = hb.shape[0], hb.shape[1] + 1
    path = torch.empty((nb, nf), dtype=torch.int32, device=hb.device)
    rc = _lib().viterbi_bwd_f32(
        hb.data_ptr(), df.data_ptr(), log_tri.data_ptr(), log_tri_t, path.data_ptr(), nb, nf, n, h, floor,
        c_stay, c_sw, stream_of(hb),
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
