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
  of n (pyin's transition: h = 21 of n = 361);
* ``viterbi_bwd_f32`` (wrapper :func:`viterbi_backtrace`) replaces
  ``viterbi_decode_pallas`` → ``_bwd_kernel`` and ``viterbi_decode_batched``
  → ``_bwd_kernel_b``: the reverse backtrace over that history, first
  maximum on ties, the voiced block preferred on block ties.

The TPU had a per-signal and a batched kernel of each pass only because of
``vmap``; here the grid carries the batch, so a single signal is a batch of
one. Adds and maxes are exact, so the kernels are bit-identical to their
plain PyTorch versions beside them (:func:`viterbi_forward_reference`,
:func:`viterbi_backtrace_reference`: the JAX package's ``vstep`` and
``back`` scans as loops over frames, batched over utterances).

Every function takes ``log_obs`` [NF, 2n] or [B, NF, 2n]. A wrapper takes
its plain version only for a CPU tensor; on a CUDA tensor it launches its
kernel (float32 only) or raises. ``LAUNCHES`` counts kernel launches.
:func:`viterbi_forward_banded_reference` is the banded step written plainly,
for the tests: it shows the identity the kernel stands on.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
from torch.utils.weak import WeakIdKeyDictionary

from modulation_mfcc_tpu_torch.kernels._launch import check_cuda, raise_on, route, stream_of

__all__ = [
    "LAUNCHES", "MAX_BINS", "viterbi_band", "band_layout", "viterbi_forward", "viterbi_backtrace",
    "viterbi_decode", "viterbi_forward_reference", "viterbi_forward_banded_reference",
    "viterbi_backtrace_reference", "viterbi_decode_reference",
]

LAUNCHES = {"viterbi_fwd_f32": 0, "viterbi_bwd_f32": 0}

MAX_BINS = 1024  # kMaxBins in the .cu: the backtrace holds n / 32 sources per lane
# the forward launcher's layout rule (csrc/viterbi.cu), mirrored by band_layout
_MAX_WARPS = 32         # kMaxWarps: the forward's per-warp maxima
_SMEM_LIMIT = 232448    # kSmemLimit: shared-memory bytes a block may opt in to on sm_90
_MAX_REG_BAND = 64      # kMaxRegBand: the widest band a thread holds in registers,
_MAX_REG_THREADS = 512  # kMaxRegThreads: in blocks of at most this many threads
_AHEAD = 4              # kAhead: observation rows in flight

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


def band_layout(n: int, h: int) -> str:
    """Where ``viterbi_fwd_f32`` keeps the band of an n-bin transition of
    half-width h (the launcher's rule): 'registers' (each thread its
    target's 2h + 1 sources, up to 64, in blocks of at most 512 threads),
    else 'shared' (staged as [2h + 1, n], when narrower than the matrix and
    the block's shared memory holds it with m, the maxima and the ring of
    observation rows), else 'L2' (log_tri itself)."""
    width, threads = 2 * h + 1, -(-n // 32) * 32
    if width <= _MAX_REG_BAND and n <= _MAX_REG_THREADS:
        return "registers"
    if width <= n and 4 * (4 * n + 4 * _MAX_WARPS + 2 * _AHEAD * threads + width * n) <= _SMEM_LIMIT:
        return "shared"
    return "L2"


_BANDS: WeakIdKeyDictionary = WeakIdKeyDictionary()  # log_tri tensor → (its version, band)


def _band_of(log_tri: torch.Tensor) -> Band:
    """viterbi_band of a tensor, once per tensor (and per in-place edit)."""
    hit = _BANDS.get(log_tri)
    if hit is None or hit[0] != log_tri._version:
        hit = (log_tri._version, viterbi_band(log_tri))
        _BANDS[log_tri] = hit
    return hit[1]


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
    lib.viterbi_bwd_f32.argtypes = [p, p, p, p, i, i, i, f, f, p]
    lib.viterbi_bwd_f32.restype = i
    return lib


def _check_bins(name: str, n: int) -> None:
    if n > MAX_BINS:
        raise ValueError(f"{name}: the kernel takes at most {MAX_BINS} pitch bins, got {n}")


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
    _check_bins("viterbi_forward", n)
    h, floor = _band_of(log_tri) if band is None else band
    if not 0 <= h < n:
        raise ValueError(f"viterbi_forward: band half-width {h} is not in [0, {n})")
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


def viterbi_backtrace(
    hist: torch.Tensor, delta_f: torch.Tensor, log_tri: torch.Tensor, c_stay: float, c_sw: float
) -> torch.Tensor:
    """The state path [..., NF] (int32) from the forward's history
    [..., NF−1, 2n] and final δ [..., 2n] (JAX ``viterbi_decode_pallas``'s
    backtrace)."""
    if not route(hist, "viterbi_backtrace"):
        return viterbi_backtrace_reference(hist, delta_f, log_tri, c_stay, c_sw)
    check_cuda("viterbi_backtrace", hist, delta_f, log_tri)
    batched, (h, df) = _batched(hist, delta_f, ndim=2)
    n = _check_shapes("viterbi_backtrace", h, df, log_tri)
    _check_bins("viterbi_backtrace", n)
    nb, nf = h.shape[0], h.shape[1] + 1
    log_tri_t = log_tri.t().contiguous()  # row v = log_tri[:, v]: coalesced reads of one target's sources
    path = torch.empty((nb, nf), dtype=torch.int32, device=h.device)
    rc = _lib().viterbi_bwd_f32(
        h.data_ptr(), df.data_ptr(), log_tri_t.data_ptr(), path.data_ptr(), nb, nf, n, c_stay, c_sw,
        stream_of(h),
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
    ``viterbi_decode_batched``). ``band`` as for :func:`viterbi_forward`."""
    if not route(log_obs, "viterbi_decode"):
        return viterbi_decode_reference(log_obs, delta0, log_tri, c_stay, c_sw)
    if log_obs.shape[-2] == 1:
        return torch.argmax(delta0, -1, keepdim=True).to(torch.int32)
    delta_f, hist = viterbi_forward(log_obs, delta0, log_tri, c_stay, c_sw, band)
    return viterbi_backtrace(hist, delta_f, log_tri, c_stay, c_sw)
