"""Zero-phase filtering of trajectories: the 12 Hz Butterworth stages and the
reference's applyFilter ('iir', 'fir', 'sg').

Design is host-side: Butterworth SOS, Kaiser FIR taps, steady-state ``zi``
and the probed FIR operator are computed once with scipy in float64 and
cached. Application is tensor code along the last axis, vectorized over
every leading axis, with the semantics of ``scipy.signal.sosfiltfilt`` and
``filtfilt`` (same odd extension, default ``padlen`` and ``zi`` scaling by
the first extended sample):

  * signals of at least ``min_len`` samples go through the FIR operator
    form (:func:`sosfiltfilt_fir`): one valid convolution with the probed
    zero-phase kernel, as a blocked Toeplitz matmul, plus two dense edge
    matmuls;
  * shorter signals run scipy's construction literally
    (:func:`sosfiltfilt_scan`), a per-sample loop;
  * the transversal (FIR) filter of :func:`filtfilt` is a correlation plus
    the initial state on its first outputs (:func:`lfilter_fir`), parallel
    over time.

Everything here is matmuls and elementwise ops; there is no convolution, so
cuDNN's TF32 default never applies.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.signal as _sps
import torch
import torch.nn.functional as tnf

from modulation_mfcc_tpu_torch.ops.savgol import savgol_filter
from modulation_mfcc_tpu_torch.utils import obs

# ---------------------------------------------------------------------------
# Host-side design
# ---------------------------------------------------------------------------


@lru_cache(maxsize=128)
def design_butter_sos(order: int, wn: tuple, btype: str) -> tuple:
    """Butterworth SOS + steady-state zi, designed by scipy in float64.

    Returns (sos [ns,6], zi [ns,2], padlen). ``wn`` is the normalized cutoff
    tuple (1 value low/high, 2 values bandpass), cutOff / (sr/2) as the
    reference computes it (script/mfcc.py:101,398).
    """
    wn_arr = np.asarray(wn, dtype=np.float64)
    sos = _sps.butter(order, wn_arr if wn_arr.size > 1 else wn_arr[0], btype=btype, output="sos")
    zi = _sps.sosfilt_zi(sos)
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    padlen = 3 * int(ntaps)
    return sos, zi, padlen


@lru_cache(maxsize=128)
def design_firwin(numtaps: int, wn: tuple, pass_zero, beta: float = 7.4) -> tuple:
    """Kaiser-window FIR design of the reference's firwin call
    (script/mfcc.py:120: ``firwin(filtLen, w, window=('kaiser', 7.4),
    pass_zero=filtType)``): (b, zi, padlen) for :func:`filtfilt`."""
    wn_arr = np.asarray(wn, dtype=np.float64)
    b = _sps.firwin(numtaps, wn_arr if wn_arr.size > 1 else wn_arr[0], window=("kaiser", beta), pass_zero=pass_zero)
    zi = _sps.lfilter_zi(b, np.array([1.0]))
    padlen = 3 * len(b)
    return b, zi, padlen


# scipy's sosfiltfilt is a *linear* operator H on the input vector. Away from
# the signal ends H is Toeplitz: row n is a shifted copy of the zero-phase
# impulse response h (symmetric, decaying like the slowest pole). Within
# E = K + padlen samples of either end the rows differ (odd extension + zi
# scaling), but they only depend on the first/last W samples. So the whole
# operator is one valid convolution with the truncated kernel (length 2K+1)
# plus two small dense edge matmuls. Kernel and edge blocks are probed from
# scipy itself (an identity matrix pushed through scipy.sosfiltfilt), so the
# only approximation is the kernel truncation at the pole-decay tolerance.


class FirFiltfiltDesign:
    """Probed operator: kernel [2K+1], left/right edge blocks [E, W] (float64)."""

    __slots__ = ("kernel", "left", "right", "K", "E", "W", "min_len")

    def __init__(self, kernel, left, right, K, E, W, min_len):
        self.kernel = kernel
        self.left = left
        self.right = right
        self.K = K
        self.E = E
        self.W = W
        self.min_len = min_len


@lru_cache(maxsize=64)
@obs.setup_span("setup.fir_operator")
def _operator_cache(sos_bytes: bytes, n_sections: int, padlen: int):
    sos = np.frombuffer(sos_bytes, dtype=np.float64).reshape(n_sections, 6).copy()
    # slowest pole sets the kernel truncation length
    pmax = 0.0
    for s in range(n_sections):
        rts = np.roots(sos[s, 3:])
        if len(rts):
            pmax = max(pmax, float(np.max(np.abs(rts))))
    if pmax >= 0.99999:
        return None  # effectively infinite memory: keep the scan path
    K = int(np.ceil(np.log(1e-10) / np.log(max(pmax, 1e-6))))
    K = max(K, padlen + 1)
    if K > 8192:
        return None
    E = K + padlen
    W = E + 2 * K
    n_probe = 2 * W + 2 * K
    H = _sps.sosfiltfilt(sos, np.eye(n_probe), axis=0)
    mid = n_probe // 2
    kernel = H[mid, mid - K : mid + K + 1].copy()
    left = H[:E, :W].copy()
    right = H[-E:, -W:].copy()
    # support check: edge rows must not reach beyond W
    if np.max(np.abs(H[:E, W:])) > 1e-9 or np.max(np.abs(H[-E:, :-W])) > 1e-9:
        return None
    # self-check: operator reproduces scipy on a random vector
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n_probe)
    want = _sps.sosfiltfilt(sos, x)
    interior = np.convolve(x, kernel[::-1], mode="valid")  # y[K .. n-K)
    got = np.concatenate([left @ x[:W], interior[E - K : n_probe - E - K], right @ x[-W:]])
    if np.max(np.abs(got - want)) > 1e-7:
        return None
    min_len = max(2 * E + 1, W)
    return FirFiltfiltDesign(kernel, left, right, K, E, W, min_len)


def _key_of(sos: np.ndarray):
    sos64 = np.ascontiguousarray(sos, dtype=np.float64)
    return sos64.tobytes(), sos64.shape[0]


def design_filtfilt_operator(key, padlen: int):
    return _operator_cache(key[0], key[1], padlen)


# ---------------------------------------------------------------------------
# Device-side application
# ---------------------------------------------------------------------------


def _as(a, like: torch.Tensor) -> torch.Tensor:
    """``a`` (numpy array or tensor) in ``like``'s dtype, on its device."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension around the endpoints, scipy.signal._arraytools.odd_ext."""
    if n < 1:
        return x
    if n > x.shape[-1] - 1:
        raise ValueError(
            f"Extension length {n} must be < signal length {x.shape[-1]}"
        )
    left = 2.0 * x[..., :1] - torch.flip(x[..., 1 : n + 1], dims=(-1,))
    right = 2.0 * x[..., -1:] - torch.flip(x[..., -(n + 1) : -1], dims=(-1,))
    return torch.cat([left, x, right], dim=-1)


def sosfilt(sos: np.ndarray, x: torch.Tensor, zi: torch.Tensor | None = None) -> torch.Tensor:
    """Cascaded biquads along the last axis (scipy.signal.sosfilt), direct form
    II transposed, one time step at a time (short signals only).

    ``zi`` has shape [ns, ..., 2] broadcastable against x's leading dims
    (scipy convention); None means zero initial state.
    """
    lead = x.shape[:-1]
    for s in range(sos.shape[0]):
        b0, b1, b2 = (float(v) for v in sos[s, :3])
        a1, a2 = float(sos[s, 4]), float(sos[s, 5])
        if zi is None:
            z0 = torch.zeros(lead, dtype=x.dtype, device=x.device)
            z1 = torch.zeros(lead, dtype=x.dtype, device=x.device)
        else:
            z0 = torch.broadcast_to(zi[s][..., 0], lead).to(x.dtype)
            z1 = torch.broadcast_to(zi[s][..., 1], lead).to(x.dtype)
        y = torch.empty_like(x)
        for n in range(x.shape[-1]):
            xn = x[..., n]
            yn = b0 * xn + z0
            z0 = b1 * xn - a1 * yn + z1
            z1 = b2 * xn - a2 * yn
            y[..., n] = yn
        x = y
    return x


def sosfiltfilt(sos: np.ndarray, zi: np.ndarray, padlen: int, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase SOS filtering along the last axis == scipy.signal.sosfiltfilt:
    the FIR operator form for signals of at least its ``min_len`` samples,
    the literal scan otherwise."""
    design = design_filtfilt_operator(_key_of(sos), padlen)
    if design is not None and x.shape[-1] >= design.min_len:
        return sosfiltfilt_fir(design, x)
    return sosfiltfilt_scan(sos, zi, padlen, x)


def sosfiltfilt_scan(sos: np.ndarray, zi: np.ndarray, padlen: int, x: torch.Tensor) -> torch.Tensor:
    """scipy's sosfiltfilt construction: odd-extend by padlen → forward pass
    with zi scaled by the first sample → reverse pass with zi scaled by the
    (new) first sample → trim."""
    ext = odd_ext(x, padlen)
    zi_b = _as(zi, x).reshape((zi.shape[0],) + (1,) * (x.ndim - 1) + (2,))
    y = sosfilt(sos, ext, zi=zi_b * ext[None, ..., :1])
    y = torch.flip(y, dims=(-1,))
    y = sosfilt(sos, y, zi=zi_b * y[None, ..., :1])
    y = torch.flip(y, dims=(-1,))
    return y[..., padlen:-padlen] if padlen > 0 else y


_TOEPLITZ_BLK = 128


def _toeplitz_blocks(kernel: torch.Tensor, blk: int = _TOEPLITZ_BLK) -> torch.Tensor:
    """[wpad, blk] banded matrix with km[j + i, j] = kernel[i]: one block of
    ``blk`` valid-correlation outputs is window @ km."""
    klen = kernel.shape[0]
    wpad = -(-(blk + klen - 1) // blk) * blk
    r = torch.arange(wpad, device=kernel.device)[:, None] - torch.arange(blk, device=kernel.device)
    inside = (r >= 0) & (r < klen)
    return torch.where(inside, kernel[r.clamp(0, klen - 1)], torch.zeros((), dtype=kernel.dtype, device=kernel.device))


def _conv_valid_lastaxis(x: torch.Tensor, kernel) -> torch.Tensor:
    """VALID cross-correlation along the last axis, as matmuls.

    Long kernels run as a blocked Toeplitz matmul: 128 outputs per block
    against a [128+K-1 (padded), 128] banded kernel matrix (built in float64,
    then cast to x's dtype). Short kernels multiply the unfolded windows."""
    kernel64 = torch.as_tensor(kernel, dtype=torch.float64, device=x.device)
    klen = kernel64.shape[0]
    t = x.shape[-1]
    n_out = t - klen + 1
    if klen >= 96 and n_out >= 128:
        blk = _TOEPLITZ_BLK
        km = _toeplitz_blocks(kernel64, blk).to(x.dtype)
        wpad = km.shape[0]
        nb = -(-n_out // blk)
        xp = tnf.pad(x, (0, (nb - 1) * blk + wpad - t))
        windows = xp.unfold(-1, wpad, blk)  # [..., nb, wpad]: windows[b, l] = xp[b*blk + l]
        return (windows @ km).flatten(-2)[..., :n_out]
    return x.unfold(-1, klen, 1) @ kernel64.to(x.dtype)


def sosfiltfilt_fir(d, x: torch.Tensor) -> torch.Tensor:
    """Apply a probed filtfilt operator ``d`` (a :class:`FirFiltfiltDesign`,
    or any object with its fields as tensors) along the last axis; exact ==
    scipy for ``x.shape[-1] >= d.min_len``."""
    n = x.shape[-1]
    interior = _conv_valid_lastaxis(x, d.kernel)  # covers y[K .. n-K)
    mid = interior[..., d.E - d.K : n - d.E - d.K]
    left = x[..., : d.W] @ _as(d.left, x).T
    right = x[..., -d.W :] @ _as(d.right, x).T
    return torch.cat([left, mid, right], dim=-1)


def lfilter_fir(b: np.ndarray, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """scipy.signal.lfilter(b, [1], x, zi=zi)[0] along the last axis, in
    parallel over time: y[n] = Σ_k b[k]·x[n−k] (zeros before the start),
    plus zi[..., n] on the first len(b) − 1 outputs (the transposed direct
    form's initial state reaches output n through n shifts)."""
    nb = len(b)
    y = _conv_valid_lastaxis(tnf.pad(x, (nb - 1, 0)), np.ascontiguousarray(b[::-1]))
    m = min(nb - 1, x.shape[-1])
    return torch.cat([y[..., :m] + zi[..., :m], y[..., m:]], dim=-1)


def filtfilt(b: np.ndarray, zi: np.ndarray, padlen: int, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase transversal filtering == scipy.signal.filtfilt(b, 1, x)
    (padtype odd), the reference's FIR branch (script/mfcc.py:126)."""
    ext = odd_ext(x, padlen)
    zi_t = _as(zi, x)
    y = torch.flip(lfilter_fir(b, ext, zi_t * ext[..., :1]), dims=(-1,))
    y = torch.flip(lfilter_fir(b, y, zi_t * y[..., :1]), dims=(-1,))
    return y[..., padlen:-padlen] if padlen > 0 else y


class FiltFilt(torch.nn.Module):
    """scipy.signal.sosfiltfilt of one SOS design along the last axis, with
    its probed FIR operator held as float64 buffers (``kernel``, ``left``,
    ``right``) that move with ``.to(device)``. ``min_len`` is None when the
    probe declined the design; the scan then serves every length."""

    def __init__(self, sos: np.ndarray, zi: np.ndarray, padlen: int):
        super().__init__()
        self.sos, self.zi, self.padlen = sos, zi, padlen
        d = design_filtfilt_operator(_key_of(sos), padlen)
        self.min_len = None if d is None else d.min_len
        if d is not None:
            self.K, self.E, self.W = d.K, d.E, d.W
            for name in ("kernel", "left", "right"):
                self.register_buffer(name, torch.tensor(getattr(d, name)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.min_len is not None and x.shape[-1] >= self.min_len:
            return sosfiltfilt_fir(self, x)
        return sosfiltfilt_scan(self.sos, self.zi, self.padlen, x)


# ---------------------------------------------------------------------------
# applyFilter equivalent (reference script/mfcc.py:29-135 / calc.py:23-129)
# ---------------------------------------------------------------------------

_FILT_TYPES = ("bandpass", "lowpass", "highpass")


def resolve_filt_type(filt_type: str) -> str:
    """Prefix match against bandpass/lowpass/highpass (script/mfcc.py:88-92)."""
    matches = [t for t in _FILT_TYPES if t.startswith(filt_type)]
    if len(matches) != 1:
        raise ValueError(
            "filtType must be one among: lowpass, highpass, bandpass. "
            "Partial matches allowed."
        )
    return matches[0]


def validated_cutoffs(sr: float, filt: str, cut_off, filt_type: str) -> tuple[str, tuple | None]:
    """applyFilter's validation (script/mfcc.py:29-135): (filter type,
    normalized cutoffs cut/(sr/2)). Cutoffs must be < sr/2 and increasing,
    one for low/high-pass and two for band-pass; 'sg' skips the cutoff
    checks (its wn is None) but takes exactly one cutoff."""
    if filt is None:
        raise ValueError(
            "Cannot apply filter without specifying a filter method among "
            "'iir', 'fir' and 'sg' (filt is None)."
        )
    if cut_off is None or (filt != "sg" and any(c is None for c in cut_off)):
        raise ValueError(
            "Cannot apply filter without specifying a cut Off freq. (CutOff is None)."
        )
    ftype = resolve_filt_type(filt_type)
    if filt == "sg":
        if len(cut_off) != 1:
            raise ValueError(
                "sg (savitsky Golay) filters can only be lowpass (one cutOff freq allowed)"
            )
        return ftype, None
    cut = np.asarray(list(cut_off), dtype=np.float64)
    if np.any(cut >= sr / 2.0):
        raise ValueError(
            "Cut off frequencies must be smaller than the half of the "
            "sampling freq. of the signal submitted to the filter"
        )
    if cut.size > 1 and np.any(np.diff(cut) <= 0):
        raise ValueError("If two cut off freqs are provided: cutOff[0]<cutOff[1]")
    ok = (cut.size == 1 and ftype in ("lowpass", "highpass")) or (
        cut.size == 2 and ftype == "bandpass"
    )
    if not ok:
        raise ValueError(
            "only one or two cut off frequencies allowed. If two freqs are "
            "provided, filtType must be bandpass"
        )
    return ftype, tuple((cut / (sr / 2.0)).tolist())


def iir_design(sr: float, cut_off, filt_len: int, filt_type: str) -> tuple:
    """Validated Butterworth design of applyFilter's 'iir' branch:
    (sos, zi, padlen)."""
    ftype, wn = validated_cutoffs(sr, "iir", cut_off, filt_type)
    return design_butter_sos(filt_len, wn, ftype)


def fir_design(sr: float, cut_off, filt_len: int, filt_type: str) -> tuple:
    """Validated Kaiser FIR design of applyFilter's 'fir' branch:
    (b, zi, padlen)."""
    ftype, wn = validated_cutoffs(sr, "fir", cut_off, filt_type)
    return design_firwin(filt_len, wn, ftype)


def apply_filter(
    x: torch.Tensor,
    sr: float,
    *,
    filt: str = "iir",
    cut_off=(None,),
    filt_len: int = 6,
    filt_type: str = "low",
    poly_ord: int = 3,
) -> torch.Tensor:
    """The reference's applyFilter (script/mfcc.py:29-135) along the last
    axis: 'iir' (Butterworth sosfiltfilt), 'fir' (Kaiser firwin filtfilt)
    or 'sg' (Savitzky-Golay smoothing of ``filt_len`` and ``poly_ord``)."""
    ftype, wn = validated_cutoffs(sr, filt, cut_off, filt_type)
    if filt == "iir":
        return sosfiltfilt(*design_butter_sos(filt_len, wn, ftype), x)
    if filt == "fir":
        return filtfilt(*design_firwin(filt_len, wn, ftype), x)
    if filt == "sg":
        return savgol_filter(x, filt_len, poly_ord, deriv=0)
    raise ValueError(f"Unknown filter kind {filt!r}")
