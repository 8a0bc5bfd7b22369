"""pYIN fundamental-frequency estimation (probabilistic YIN), batched over
utterances [..., n].

The reference's ``librosa.pyin`` path (script/calc.py:562-581), as the JAX
package's ``ops/yin.py`` computes it (Mauch & Dixon 2014, librosa's
formulation and quirks):

  1. librosa's cumulative-mean-normalized difference function (CMNDF) on the
     lag band, from row-level FFT correlations over non-overlapping hop rows
     (torch.fft) and a prefix-sum energy term;
  2. trough candidates with librosa's band-edge rules; the threshold sweep
     with a Beta prior over thresholds and a Boltzmann prior over trough
     rank, in segment form (troughs sorted by height); the no-trough mass on
     the lowest trough;
  3. candidate periods refined by a parabola (``|shift| > 1 → 0``),
     projected onto a log-spaced pitch-bin grid last-write-wins, with
     voiced and unvoiced copies of every bin;
  4. the Viterbi decode of the kron-factored transition (the CUDA kernels
     ``viterbi_fwd_f32`` and ``viterbi_bwd_f32``, kernels/viterbi.py), from
     the uniform unvoiced initial distribution.

The host designs (Beta threshold masses, librosa's ``transition_local``
triangle) are the JAX package's, kept here in numpy so both packages decode
with identical constants. Where the JAX package reduces one-hot products
because a TPU scatters slowly (the unsort and the bin projection), this
module gathers and scatters: the lag ids of a row are unique, and so are the
last-write winners of a bin, so the result is the same.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import scipy.stats
import torch
import torch.nn.functional as tnf

from modulation_mfcc_tpu_torch.kernels.viterbi import Band, viterbi_band, viterbi_decode, viterbi_decode_reference
from modulation_mfcc_tpu_torch.ops.framing import PAD_MODES, _pad_signal, frame_by_slices  # pyin_f0 takes PAD_MODES
from modulation_mfcc_tpu_torch.utils.helpers import next_pow2

__all__ = ["PyinGeometry", "pyin_geometry", "pyin_constants", "pyin_observations", "pyin_f0", "yin_cmndf"]

VITERBI_ENGINES = ("auto", "plain")


# ---------------------------------------------------------------------------
# Host designs (numpy float64, as the JAX package designs them)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _beta_threshold_probs(n_thresholds: int, a: float, b: float) -> np.ndarray:
    thresholds = np.linspace(0, 1, n_thresholds + 1)
    cdf = scipy.stats.beta.cdf(thresholds, a, b)
    return np.diff(cdf)


def _triang_window(m: int) -> np.ndarray:
    """scipy.signal.windows.triang(M, sym=True), host-side f64."""
    n = np.arange(1, (m + 1) // 2 + 1, dtype=np.float64)
    if m % 2 == 0:
        w = (2 * n - 1.0) / m
        return np.concatenate([w, w[::-1]])
    w = 2.0 * n / (m + 1.0)
    return np.concatenate([w, w[-2::-1]])


@lru_cache(maxsize=32)
def _transition_local(n_states: int, width: float) -> np.ndarray:
    """librosa.sequence.transition_local(n, width, window='triangle',
    wrap=False), host-side f64: row i carries a triangular window of FULL
    length int(width) centered at column i (librosa's pad_center + roll
    construction), truncated at the band edges and row-normalized."""
    m = int(width)
    if m < 1:
        # librosa raises ParameterError for width < 1; without this the
        # empty triangle gives all-zero rows and 0/0 NaN normalization
        raise ValueError(f"transition window width {width} must be >= 1")
    if m > n_states:
        raise ValueError(f"transition window {m} exceeds n_states {n_states}")
    win = _triang_window(m)
    base = np.zeros(n_states)
    lo = (n_states - m) // 2  # librosa util.pad_center left offset
    base[lo : lo + m] = win
    trans = np.zeros((n_states, n_states))
    for i in range(n_states):
        row = np.roll(base, n_states // 2 + i + 1)
        row[min(n_states, i + m // 2 + 1) :] = 0
        row[: max(0, i - m // 2)] = 0
        trans[i] = row
    return trans / trans.sum(axis=1, keepdims=True)


class PyinGeometry(NamedTuple):
    """Host-side lag band, pitch grid and transition width of one pyin call."""

    win_length: int
    hop_length: int
    min_lag: int
    max_lag: int
    nbps: int      # pitch bins per semitone
    n_bins: int
    twidth: float  # full length of the transition triangle, in bins


@lru_cache(maxsize=64)
def pyin_geometry(
    sr: float,
    fmin: float = 75.0,
    fmax: float = 600.0,
    frame_length: int = 2048,
    win_length: int | None = None,
    hop: float = 0.01,
    resolution: float = 0.1,
    max_transition_rate: float = 35.92,
) -> PyinGeometry:
    """librosa.pyin's lag band (max_period clipped so every read stays
    inside the frame) and pitch grid (ceil(1/resolution) bins per semitone)."""
    if win_length is None:
        win_length = frame_length // 2
    hop_length = max(1, int(round(hop * sr)))
    min_lag = max(1, int(np.floor(sr / fmax)))
    max_lag = min(int(np.ceil(sr / fmin)), frame_length - win_length - 1)
    if max_lag <= min_lag:
        raise ValueError(
            f"frame_length={frame_length} too short for win_length="
            f"{win_length} with fmin={fmin}/fmax={fmax}: empty lag band"
        )
    nbps = int(np.ceil(1.0 / resolution))
    n_bins = int(np.floor(12.0 * nbps * np.log2(fmax / fmin))) + 1
    twidth = max_transition_rate * 12.0 * nbps * hop_length / sr
    return PyinGeometry(win_length, hop_length, min_lag, max_lag, nbps, n_bins, twidth)


@lru_cache(maxsize=16)
def pyin_constants(g: PyinGeometry, n_thresholds: int, beta_parameters: tuple, dtype: torch.dtype) -> dict:
    """The decoder's designed constants in ``dtype`` (whose ``tiny`` keeps
    the logs finite), as numpy arrays:

    * ``log_tri`` [n, n]: log(transition_local + tiny);
    * ``beta_probs`` [T]: the Beta(a, b) mass of each threshold interval;
    * ``thresholds`` [T]: the upper ends 1/T … 1;
    * ``log_p_init`` [2n]: log(p_init + tiny), p_init uniform over the
      unvoiced states only (librosa).
    """
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    tiny = float(torch.finfo(dtype).tiny)
    p_init = np.zeros(2 * g.n_bins)
    p_init[g.n_bins :] = 1.0 / g.n_bins
    beta = _beta_threshold_probs(n_thresholds, float(beta_parameters[0]), float(beta_parameters[1]))
    return {
        "log_tri": _log_tri(g, dtype),
        "beta_probs": beta.astype(np_dtype),
        "thresholds": np.linspace(0, 1, n_thresholds + 1)[1:].astype(np_dtype),
        "log_p_init": np.log(p_init + tiny).astype(np_dtype),
    }


def _log_tri(g: PyinGeometry, dtype: torch.dtype) -> np.ndarray:
    """log(transition_local + tiny) [n, n] in ``dtype``'s numpy type."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return np.log(_transition_local(g.n_bins, g.twidth) + float(torch.finfo(dtype).tiny)).astype(np_dtype)


@lru_cache(maxsize=16)
def pyin_band(g: PyinGeometry, dtype: torch.dtype) -> Band:
    """The band (h, C) of the designed ``log_tri`` (kernels/viterbi.viterbi_band),
    on the host: the band the Viterbi kernels work on, known before any
    tensor reaches the card (pyin's triangle: h = 21 of n = 361), with its
    Toeplitz window and interior rows [h, n − 1 − h] (librosa's triangle
    shifted, bit for bit), which past 1,024 bins take the kernels' 'toeplitz'
    layout."""
    return viterbi_band(_log_tri(g, dtype))


def _constants_on(want: dict, consts: dict | None, dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """``consts`` (module buffers) when they have the designed shapes and
    type, else the design ``want`` on ``device``."""
    if consts is not None and all(
        k in consts and tuple(consts[k].shape) == v.shape and consts[k].dtype == dtype for k, v in want.items()
    ):
        return {k: consts[k] for k in want}
    return {k: torch.as_tensor(v, device=device) for k, v in want.items()}


# ---------------------------------------------------------------------------
# CMNDF
# ---------------------------------------------------------------------------


def _cmndf_from_terms(cross: torch.Tensor, e_tau: torch.Tensor) -> torch.Tensor:
    """librosa CMNDF from the correlation/energy window sums.

    ``cross[..., τ] = Σ_{j=0}^{w} x[j]·x[j+τ]`` (w+1 products — librosa's
    off-by-one), ``e_tau[..., τ] = Σ_{j=τ+1}^{τ+w} x[j]²`` (w terms).
    Magnitudes below 1e-6 snap to zero, then d(τ) = e(0) + e(τ) − 2·c(τ) and
    d'(τ) = d(τ) / (mean(d(1..τ)) + tiny); d'(0) = 1 (never read)."""
    cross = torch.where(cross.abs() < 1e-6, 0.0, cross)
    e_tau = torch.where(e_tau.abs() < 1e-6, 0.0, e_tau)
    d = e_tau[..., :1] + e_tau - 2.0 * cross
    tau = torch.arange(1, d.shape[-1], dtype=d.dtype, device=d.device)
    cum_mean = torch.cumsum(d[..., 1:], dim=-1) / tau
    cmndf = d[..., 1:] / (cum_mean + torch.finfo(d.dtype).tiny)
    return torch.cat([torch.ones_like(d[..., :1]), cmndf], dim=-1)


def yin_cmndf(frames: torch.Tensor, max_lag: int, win_length: int | None = None) -> torch.Tensor:
    """librosa's CMNDF d'(τ), τ ∈ [0, max_lag], of frames [..., N];
    ``win_length`` defaults to N − max_lag − 1. FFT cross-correlation form."""
    n = frames.shape[-1]
    w = n - max_lag - 1 if win_length is None else win_length
    if w + 1 + max_lag > n:
        raise ValueError("frames too short for win_length + max_lag + 1")
    csum = torch.cumsum(frames**2, dim=-1)
    total = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    e_tau = total[..., w + 1 : w + max_lag + 2] - total[..., 1 : max_lag + 2]
    # no aliasing: every product index j+τ ≤ w + max_lag stays inside one period
    nfft = next_pow2(max(n, w + 1 + max_lag))
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    specw = torch.fft.rfft(frames[..., : w + 1], n=nfft, dim=-1)
    cross = torch.fft.irfft(torch.conj(specw) * spec, n=nfft, dim=-1)[..., : max_lag + 1]
    return _cmndf_from_terms(cross, e_tau)


def _sliding_cmndf(xp: torch.Tensor, nf: int, hop: int, w: int, max_lag: int) -> torch.Tensor:
    """librosa CMNDF [..., nf, max_lag+1] of the frames starting at f·hop
    of xp [..., T], without a frame matrix.

    YIN's difference function is unwindowed, so every frame quantity is a
    window sum over hop-aligned rows: with R[u, r] = xp[u·hop + r] and the
    local context C[u, m] = xp[u·hop + m] (m < hop + max_lag + 1),
        cross[f, τ] = Σ_{b<q1} P_τ[f+b] + (partial row),  P_τ[u] = Σ_{r<hop} R[u,r]·C[u,r+τ]
        e_tau[f, τ] = Σ_{b<q2} Q_{τ+1}[f+b] + (partial row), Q_λ[u] = Σ_{r<hop} C²[u,r+λ]
    P is one FFT cross-correlation of each row against its context; Q is a
    difference of prefix sums of C² (an FFT energy term rounds differently
    in float32 and flips voicing decisions on speech). Equal to
    ``yin_cmndf(frames, max_lag, win_length=w)`` up to float rounding."""
    q1, rem1 = divmod(w + 1, hop)  # cross windows are w+1 products long
    q2, rem2 = divmod(w, hop)  # energy windows are w products long
    n_rows = nf + q1
    m_ctx = hop + max_lag + 1
    nfft = next_pow2(max(m_ctx, 2))
    need = (n_rows - 1) * hop + m_ctx
    if xp.shape[-1] < need:
        xp = tnf.pad(xp, (0, need - xp.shape[-1]))
    rows = xp[..., : n_rows * hop].reshape(*xp.shape[:-1], n_rows, hop)
    ctx = frame_by_slices(xp, 0, n_rows, m_ctx, hop)
    lags = max_lag + 1

    fc = torch.fft.rfft(ctx, n=nfft, dim=-1)
    fr = torch.fft.rfft(rows, n=nfft, dim=-1)
    # circular correlation == linear here: r + λ ≤ hop−1 + max_lag+1 < nfft
    p_full = torch.fft.irfft(torch.conj(fr) * fc, n=nfft, dim=-1)
    s_inc = torch.cumsum(ctx * ctx, dim=-1)
    q_lam = s_inc[..., hop : hop + lags] - s_inc[..., :lags]  # index i carries λ = i+1

    def window_sum(full, part, q, rem):
        """Σ_{b<q} full[f+b, :lags] (+ part[f+q, :lags])."""
        out = None
        for b in range(q):
            sl = full[..., b : b + nf, :lags]
            out = sl if out is None else out + sl
        if rem:
            sl = part[..., q : q + nf, :lags]
            out = sl if out is None else out + sl
        return out

    pp = None
    if rem1:
        fr1 = torch.fft.rfft(rows[..., :rem1], n=nfft, dim=-1)
        pp = torch.fft.irfft(torch.conj(fr1) * fc, n=nfft, dim=-1)
    cross = window_sum(p_full, pp, q1, rem1)
    qp_lam = s_inc[..., rem2 : rem2 + lags] - s_inc[..., :lags] if rem2 else None
    e_tau = window_sum(q_lam, qp_lam, q2, rem2)
    return _cmndf_from_terms(cross, e_tau)


# ---------------------------------------------------------------------------
# Candidates and observation probabilities
# ---------------------------------------------------------------------------


def pyin_observations(
    cmb: torch.Tensor,
    beta_probs: torch.Tensor,
    thresholds: torch.Tensor,
    *,
    sr: float,
    g: PyinGeometry,
    fmin: float,
    boltzmann_parameter: float,
    no_trough_prob: float,
) -> torch.Tensor:
    """log observation probabilities [..., NF, 2n] (voiced bins, then
    unvoiced) from the CMNDF on the lag band, cmb [..., NF, L]."""
    dtype, dev = cmb.dtype, cmb.device
    L = cmb.shape[-1]
    # librosa trough rules on the band (util.localmin with edge padding, then
    # the pyin first-bin override): interior strict-left/loose-right, first
    # bin iff band[0] < band[1], last bin iff band[-1] < band[-2]
    left = torch.cat([cmb[..., :1], cmb[..., :-1]], dim=-1)
    right = torch.cat([cmb[..., 1:], cmb[..., -1:]], dim=-1)
    is_trough = (cmb < left) & (cmb <= right)
    is_trough[..., 0] = cmb[..., 0] < cmb[..., 1]

    # parabolic refinement of the trough period only (the sweep thresholds
    # the raw heights); band edges get shift 0, |shift| > 1 is zeroed
    denom = left - 2 * cmb + right
    shift = torch.where(denom != 0, 0.5 * (left - right) / denom, 0.0)
    shift = torch.where(shift.abs() > 1.0, 0.0, shift)
    shift[..., 0] = 0.0
    shift[..., -1] = 0.0
    lag_ref = torch.arange(g.min_lag, g.min_lag + L, dtype=dtype, device=dev) + shift

    # Threshold sweep in segment form: sorting troughs by height, the
    # T-threshold sum becomes one over K = ceil(L/2) entry segments; on
    # segment s (the s+1 lowest troughs have entered) trough j's Boltzmann
    # rank is pos[j, s] = #{entered troughs preceding τ_j}. The stable sort
    # keeps τ order on ties (librosa's in-order assignment).
    K = (L + 1) // 2
    hs, taus = torch.sort(torch.where(is_trough, cmb, math.inf), dim=-1, stable=True)
    hK, tK = hs[..., :K], taus[..., :K]
    # A_j: beta mass of the thresholds above trough j's height (strict
    # 'below'); segment masses are adjacent differences (0 past the last)
    A = torch.where(hK[..., None] < thresholds, beta_probs, 0.0).sum(-1)
    W = A - torch.cat([A[..., 1:], torch.zeros_like(A[..., :1])], dim=-1)
    # pos[j, s] = #{i ≤ s : τ_i < τ_j}: a prefix count as one GEMM of the
    # 0/1 precedence matrix against upper-triangular ones, integer-exact in
    # any summation order (an innermost-dim cumsum is ten times slower on
    # the H100)
    upper = torch.ones(K, K, dtype=dtype, device=dev).triu()
    pos = (tK[..., :, None] > tK[..., None, :]).to(dtype) @ upper
    n_s = torch.arange(1, K + 1, dtype=dtype, device=dev)
    # the Boltzmann prior scipy.stats.boltzmann.pmf(pos, lam, n_s), in place
    # (the [.., K, K] tensors are the memory peak), in the JAX package's order
    lam = float(boltzmann_parameter)
    prior = pos.mul_(-lam).exp_().mul_(1 - math.exp(-lam)).div_(1 - torch.exp(-lam * n_s) + 1e-30)
    probs_sorted = prior.mul_(upper).mul_(W[..., None, :]).sum(-1)  # trough j is active on segments s ≥ j
    del pos, prior
    # back to lag order (lag ids are unique per row; padded slots carry 0)
    probs = torch.zeros_like(cmb).scatter_(-1, tK, probs_sorted)

    # thresholds no trough clears: no_trough_prob mass on the lowest trough,
    # only when the frame has one (librosa leaves troughless frames unvoiced)
    miss_mass = torch.where(hK[..., :1] >= thresholds, beta_probs, 0.0).sum(-1)
    has_trough = torch.isfinite(hK[..., 0]).to(dtype)
    probs.scatter_add_(-1, tK[..., :1], (no_trough_prob * miss_mass * has_trough)[..., None])

    freqs = sr / torch.clamp(lag_ref, min=torch.finfo(dtype).tiny)
    bin_f = torch.round(12.0 * g.nbps * torch.log2(torch.clamp(freqs, min=1e-12) / fmin))
    # librosa clips the rounded bin into [0, n_bins] inclusive: index n_bins
    # lands in the overwritten unvoiced block, so such candidates drop out
    keep = bin_f <= g.n_bins - 1
    bin_idx = torch.clamp(bin_f.to(torch.int64), 0, g.n_bins - 1)
    # librosa's fancy assignment is last-write-wins on duplicate bins, among
    # the kept positive-probability candidates. Their bins are non-increasing
    # along τ, so a candidate wins its bin iff the nearest candidate to its
    # right carries another bin; winners are unique per bin.
    cand = keep & (probs > 0)
    bmask = torch.where(cand, bin_idx, -1)
    rmax = torch.flip(torch.cummax(torch.flip(bmask, [-1]), dim=-1).values, [-1])
    rmax_next = torch.cat([rmax[..., 1:], torch.full_like(rmax[..., :1], -1)], dim=-1)
    win = cand & (bin_idx != rmax_next)
    obs_v = torch.zeros((*cmb.shape[:-1], g.n_bins), dtype=dtype, device=dev)
    obs_v.scatter_add_(-1, bin_idx, torch.where(win, probs, 0.0))
    voiced_prob = torch.clamp(obs_v.sum(-1), 0.0, 1.0)
    obs_u = ((1.0 - voiced_prob) / g.n_bins)[..., None].expand_as(obs_v)
    return torch.log(torch.cat([obs_v, obs_u], dim=-1) + torch.finfo(dtype).tiny)


# ---------------------------------------------------------------------------
# pyin
# ---------------------------------------------------------------------------


def pyin_f0(
    x: torch.Tensor,
    *,
    sr: float,
    fmin: float = 75.0,
    fmax: float = 600.0,
    frame_length: int = 2048,
    win_length: int | None = None,
    hop: float = 0.01,
    n_thresholds: int = 100,
    beta_parameters: tuple = (2, 18),
    boltzmann_parameter: int = 2,
    resolution: float = 0.1,
    max_transition_rate: float = 35.92,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    center: bool = True,
    pad_mode: str = "constant",
    viterbi_engine: str = "auto",
    return_states: bool = False,
    consts: dict[str, torch.Tensor] | None = None,
):
    """F0 tracks [..., NF] in Hz of float32 or float64 x [..., n]; 0 where
    decoded unvoiced. ``return_states=True`` also returns the decoded states
    [..., NF] (int32: the bin, or bin + n_bins when unvoiced — the oracle's
    convention).

    ``center``/``pad_mode`` follow librosa.pyin: centred framing pads
    frame_length//2 on each side with any np.pad mode of
    :data:`PAD_MODES` ('constant', the copying modes 'edge', 'reflect',
    'symmetric', 'wrap', and the value modes 'linear_ramp', 'maximum',
    'mean', 'median', 'minimum'). ``viterbi_engine``: 'auto' (the CUDA
    kernels on a CUDA tensor, their plain versions on a CPU tensor) or
    'plain'. ``consts`` are :func:`pyin_constants` on x's device (module
    buffers), used when their shapes and type fit; the decode takes the band
    of their ``log_tri`` from the design (:func:`pyin_band`), with no sync.
    """
    if viterbi_engine not in VITERBI_ENGINES:
        raise ValueError(f"viterbi_engine {viterbi_engine!r} not in {VITERBI_ENGINES}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pyin_f0 takes float32 or float64 audio, got {x.dtype}")
    g = pyin_geometry(float(sr), float(fmin), float(fmax), int(frame_length), win_length, float(hop),
                      float(resolution), float(max_transition_rate))
    dtype = x.dtype
    c = _constants_on(pyin_constants(g, int(n_thresholds), tuple(beta_parameters), dtype), consts, dtype, x.device)
    lead, n = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, n)
    if center:
        pad = frame_length // 2
        xp = _pad_signal(x, pad, pad_mode)
        # librosa's frame count on the padded signal (odd frame_length loses
        # one sample of span)
        nf = 1 + (n + 2 * pad - frame_length) // g.hop_length
    else:
        xp = x
        nf = max(1, 1 + (n - frame_length) // g.hop_length)

    cm = _sliding_cmndf(xp, nf, g.hop_length, g.win_length, g.max_lag)
    log_obs = pyin_observations(
        cm[..., g.min_lag :], c["beta_probs"], c["thresholds"], sr=float(sr), g=g, fmin=float(fmin),
        boltzmann_parameter=boltzmann_parameter, no_trough_prob=no_trough_prob,
    )
    delta0 = log_obs[:, 0] + c["log_p_init"]
    # log(1−s) and log s rounded to the working type, as the scans add them
    c_stay = float(torch.tensor(np.log(1.0 - switch_prob), dtype=dtype))
    c_sw = float(torch.tensor(np.log(switch_prob), dtype=dtype))
    if viterbi_engine == "auto":
        path = viterbi_decode(log_obs, delta0, c["log_tri"], c_stay, c_sw, pyin_band(g, dtype))
    else:
        path = viterbi_decode_reference(log_obs, delta0, c["log_tri"], c_stay, c_sw)

    voiced = path < g.n_bins
    bin_of = torch.where(voiced, path, path - g.n_bins)
    f0 = fmin * 2.0 ** (bin_of.to(dtype) / (12.0 * g.nbps))
    out = torch.where(voiced, f0, 0.0).reshape(*lead, nf)
    if return_states:
        return out, path.reshape(*lead, nf)
    return out
