"""Autocorrelation pitch tracking (Boersma 1993) with a Viterbi path finder.

The reference's Praat calls (script/calc.py:535-560: ``To Pitch (ac)`` /
``To Pitch (cc)`` with the full cost-parameter surface), as batched tensor
code over utterances [B, n]:

  frames → mean-subtract → window → FFT autocorrelation normalized by the
  window's own autocorrelation ('ac'), or frame-to-frame normalized cross
  correlation ('cc') → local maxima with parabolic scores → the best
  maxCandNum−1 candidates → windowed-sinc refinement of every lag of the
  band (the CUDA kernel ``sinc_refine_f32``, kernels/sinc_refine.py) read
  off at the candidates → strengths with octave cost and the
  silence/voicing unvoiced candidate → Viterbi path over the candidates.

Semantics follow the JAX package's ``ops/pitch.py`` (Praat's cost
conventions, the true right neighbour at the lag_max band edge, the
veryAccurate window and sinc depth). The path finder is a loop over frames,
batched over utterances, on the tensors' device.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as tnf

from modulation_mfcc_tpu_torch.kernels.sinc_refine import (
    refine_sinc_band,
    refine_sinc_band_reference,
    sinc_weights,
)
from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from modulation_mfcc_tpu_torch.ops.windows import praat_gauss, praat_hanning
from modulation_mfcc_tpu_torch.utils.helpers import next_pow2

__all__ = ["PitchGeometry", "pitch_geometry", "pitch_constants", "pitch_ac", "viterbi_path"]

AC_ENGINES = ("auto", "fft")
SINC_ENGINES = ("auto", "plain")


class PitchGeometry(NamedTuple):
    """Host-side frame and lag geometry of one tracker call."""

    method: str
    very_accurate: bool
    depth: int         # sinc support per side
    nw: int            # analysis window
    hop_s: int         # hop in samples
    lag_min: int
    lag_max: int
    span: int          # frame length (nw, plus lag_max for 'cc')
    nf: int
    start0: int
    lag_hi: int        # last lag of r_full
    nfft: int
    nsamp_period: int  # local-mean half width


@lru_cache(maxsize=64)
def pitch_geometry(
    n: int,
    sr: float,
    hop: float,
    min_pitch: float,
    max_pitch: float,
    method: str = "ac",
    periods_per_window: float = 3.0,
    very_accurate: bool = False,
) -> PitchGeometry:
    """The geometry of :func:`pitch_ac` for a signal of n samples."""
    if method not in ("ac", "cc"):
        raise ValueError(f"Unknown pitch method {method!r}; one of 'ac', 'cc'")
    if method == "cc":
        periods_per_window = 1.0
    elif very_accurate:
        periods_per_window *= 2.0  # Praat AC_GAUSS: 3 → 6 periods
    depth = 70 if very_accurate else 35
    nw = min(int(round(periods_per_window / min_pitch * sr)), n)
    hop_s = int(round(hop * sr))
    lag_min = max(2, int(np.floor(sr / max_pitch)))
    lag_max = min(n - 1, int(np.ceil(sr / min_pitch)))
    if method == "ac":
        lag_max = min(lag_max, nw - 1)
    if lag_max <= lag_min:
        raise ValueError("max_pitch/min_pitch incompatible with window length")
    span = nw + (lag_max if method == "cc" else 0)
    nf = max(1, 1 + (n - span) // hop_s)
    # Praat centres the frame grid on the signal midpoint
    start0 = max(0, (n - span - (nf - 1) * hop_s) // 2)
    # 'ac' needs alias-free r out to lag_max+depth+2 (the sinc's right support)
    lag_hi = lag_max + depth + 2 if method == "ac" else lag_max
    nfft = next_pow2(int(span + lag_hi))
    nsamp_period = max(1, int(np.floor(sr / min_pitch)))
    return PitchGeometry(method, very_accurate, depth, nw, hop_s, lag_min, lag_max, span, nf,
                         start0, lag_hi, nfft, nsamp_period)


@lru_cache(maxsize=16)
def pitch_constants(g: PitchGeometry) -> dict[str, np.ndarray]:
    """The tracker's designed constants, float32: ``sinc_w`` [S, 17] and,
    for 'ac', the window ``window`` [nw] (AC_HANNING, or AC_GAUSS with
    veryAccurate) and its normalized autocorrelation ``rw`` [lag_hi+1]."""
    out = {"sinc_w": sinc_weights(g.depth)}
    if g.method == "ac":
        w = praat_gauss(g.nw) if g.very_accurate else praat_hanning(g.nw)
        wf = np.fft.rfft(w, n=g.nfft)
        wac = np.fft.irfft(wf * np.conj(wf), n=g.nfft)[: g.lag_hi + 1]
        out["window"] = w.astype(np.float32)
        out["rw"] = (wac / (wac[0] + 1e-30)).astype(np.float32)
    return out


def _constants_on(g: PitchGeometry, consts: dict | None, device) -> dict[str, torch.Tensor]:
    """``consts`` (module buffers) when their shapes fit ``g``, else designed."""
    want = pitch_constants(g)
    if consts is not None and all(k in consts and tuple(consts[k].shape) == v.shape for k, v in want.items()):
        return consts
    return {k: torch.as_tensor(v, device=device) for k, v in want.items()}


def viterbi_path(strength: torch.Tensor, freq: torch.Tensor, jump_c: float, vuv_c: float) -> torch.Tensor:
    """Praat's path finder over candidates: indices [B, NF] of the best path
    through strengths [B, NF, K] with octave-jump cost jump_c·|log2 f/f'|
    between voiced candidates and vuv_c between voiced and unvoiced (f = 0).
    A loop over frames, batched over B, on the tensors' device; ties keep
    the first maximum. Each forward step is three launches and each
    backtrace step one: frame-major buffers let the maxima, back pointers
    and path entries be written in place (``out=``)."""
    lf = torch.log2(torch.clamp(freq, min=1e-6)).transpose(0, 1)  # [NF, B, K]
    vflag = (freq > 0).transpose(0, 1)
    vp, v = vflag[:-1, :, :, None], vflag[1:, :, None, :]
    jump = torch.abs(lf[:-1, :, :, None] - lf[1:, :, None, :])
    zero = torch.zeros((), dtype=strength.dtype, device=strength.device)
    cost = torch.where(vp & v, jump_c * jump, torch.where(vp ^ v, zero + vuv_c, zero))  # [NF-1, B, K, K]
    bsz, nf, k = strength.shape
    strength = strength.transpose(0, 1)
    delta = strength[0]
    best = torch.empty((bsz, k), dtype=strength.dtype, device=strength.device)
    backptrs = torch.empty((max(nf - 1, 0), bsz, k), dtype=torch.long, device=strength.device)
    for t in range(nf - 1):
        torch.max(delta[:, :, None] - cost[t], dim=1, out=(best, backptrs[t]))
        delta = strength[t + 1] + best
    path = torch.empty((nf, bsz, 1), dtype=torch.long, device=strength.device)
    path[-1] = torch.argmax(delta, dim=-1, keepdim=True)
    for t in range(nf - 2, -1, -1):
        torch.gather(backptrs[t], 1, path[t + 1], out=path[t])
    return path[..., 0].transpose(0, 1)


def pitch_ac(
    x: torch.Tensor,
    *,
    sr: float,
    hop: float = 0.01,
    min_pitch: float = 75.0,
    max_pitch: float = 600.0,
    max_cand: int = 15,
    method: str = "ac",
    silence_thresh: float = 0.03,
    voicing_thresh: float = 0.45,
    octave_cost: float = 0.01,
    octave_jump_cost: float = 0.35,
    voiced_unvoiced_cost: float = 0.14,
    periods_per_window: float = 3.0,
    very_accurate: bool = False,
    ac_engine: str = "auto",
    sinc_engine: str = "auto",
    valid_len: torch.Tensor | None = None,
    consts: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """F0 tracks [..., NF] in Hz (0 where unvoiced) of float32 x [..., n].

    ``method='ac'``: 3-period window normalized by the window's own
    autocorrelation (Praat's To Pitch (ac)); ``'cc'``: 1-period window and
    normalized cross-correlation. ``very_accurate`` doubles the 'ac' window
    (Gaussian taper) and the sinc depth (35 → 70 taps per side).
    ``ac_engine``: 'auto' or 'fft' (both torch.fft; the JAX 'mxu' engine is
    a TPU speed choice). ``sinc_engine``: 'auto' (the CUDA kernel on a CUDA
    tensor, its plain version on a CPU tensor) or 'plain'. ``valid_len``
    [...] (ints) is each utterance's true length when x is a zero-padded
    batch: the global mean and peak then cover only the utterance.
    ``consts`` are :func:`pitch_constants` on x's device (module buffers).
    """
    if ac_engine not in AC_ENGINES:
        raise ValueError(f"ac_engine {ac_engine!r} not in {AC_ENGINES} (the JAX 'mxu' engine is TPU-only)")
    if sinc_engine not in SINC_ENGINES:
        raise ValueError(f"sinc_engine {sinc_engine!r} not in {SINC_ENGINES}")
    lead, n = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, n)
    g = pitch_geometry(n, float(sr), hop, float(min_pitch), float(max_pitch), method,
                       float(periods_per_window), bool(very_accurate))
    c = _constants_on(g, consts, x.device)
    nw, span, nf, lag_max, lag_min, depth = g.nw, g.span, g.nf, g.lag_max, g.lag_min, g.depth

    if valid_len is None:
        xg = x - torch.mean(x, dim=-1, keepdim=True)
        lim_n = torch.full((x.shape[0], 1), n, device=x.device)
    else:
        lim_n = torch.as_tensor(valid_len, device=x.device).reshape(-1, 1)
        in_sig = torch.arange(n, device=x.device) < lim_n
        mean = torch.sum(torch.where(in_sig, x, 0.0), dim=-1, keepdim=True) / torch.clamp(lim_n, min=1)
        xg = torch.where(in_sig, x - mean, 0.0)
    global_peak = torch.amax(torch.abs(xg), dim=-1, keepdim=True) + 1e-30
    if n < span:
        # shorter than one analysis span: zero-extend so the single frame
        # exists; its tail reads silence and the clip decodes unvoiced
        xg = tnf.pad(xg, (0, span - n))
    frames = frame_by_slices(xg, g.start0, nf, span, g.hop_s)  # [B, NF, span]
    # Praat's local mean looks one longest period to both sides of the midpoint
    mid = span // 2
    mlo, mhi = max(0, mid - g.nsamp_period), min(span, mid + g.nsamp_period)
    local_mean = torch.mean(frames[..., mlo:mhi], dim=-1, keepdim=True)
    fr = frames - local_mean
    local_peak = torch.amax(torch.abs(fr[..., :nw]), dim=-1) + 1e-30

    if method == "ac":
        spec = torch.fft.rfft(fr * c["window"], n=g.nfft, dim=-1)
        ac = torch.fft.irfft(spec * torch.conj(spec), n=g.nfft, dim=-1)[..., : g.lag_hi + 1]
        r_full = ac / (ac[..., :1] + 1e-30)
        r_full = r_full / torch.clamp(c["rw"], min=1e-6)
        r = r_full[..., : lag_max + 1]
        r_edge = r_full[..., lag_max + 1]
    else:
        base = fr[..., :nw]
        spec_full = torch.fft.rfft(fr, n=g.nfft, dim=-1)
        spec_base = torch.fft.rfft(base, n=g.nfft, dim=-1)
        cross = torch.fft.irfft(torch.conj(spec_base) * spec_full, n=g.nfft, dim=-1)[..., : lag_max + 1]
        csum = torch.cumsum(fr * fr, dim=-1)
        total = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
        e_tau = total[..., nw : nw + lag_max + 1] - total[..., : lag_max + 1]
        r = cross / torch.sqrt(torch.clamp(e_tau[..., :1] * e_tau, min=1e-30))
        # sinc support past lag_max: edge-replicated
        r_full = torch.cat([r, r[..., -1:].expand(*r.shape[:-1], depth + 2)], dim=-1)
        # the true right neighbour at lag_max+1 needs one sample past the
        # frame span: read it per frame with a strided slice, zero where it
        # leaves the utterance
        xgp = tnf.pad(xg, (0, 1))
        s0 = g.start0 + span
        ext_raw = xgp[..., s0 : s0 + (nf - 1) * g.hop_s + 1 : g.hop_s]  # [B, NF]
        idx_ext = s0 + torch.arange(nf, device=x.device) * g.hop_s
        ext_adj = torch.where(idx_ext < lim_n, ext_raw - local_mean[..., 0], 0.0)
        cross_e = torch.sum(base[..., : nw - 1] * fr[..., lag_max + 1 :], dim=-1) + base[..., -1] * ext_adj
        e_ext = (total[..., -1] - total[..., lag_max + 1]) + ext_adj**2
        r_edge = cross_e / torch.sqrt(torch.clamp(e_tau[..., 0] * e_ext, min=1e-30))

    # local maxima of r over lag, with parabolic scores for the selection
    lags = torch.arange(lag_max + 1, device=x.device)
    neg_inf = torch.full_like(r[..., :1], float("-inf"))
    r_left = torch.cat([neg_inf, r[..., :-1]], dim=-1)
    r_right = torch.cat([r[..., 1:], r_edge[..., None]], dim=-1)
    is_max = (r > r_left) & (r >= r_right) & (lags >= lag_min)
    rp = torch.roll(r, 1, dims=-1)
    denom = rp - 2 * r + r_right
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (rp - r_right) / denom, 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    val_par = r - 0.25 * (rp - r_right) * delta
    tau_par = (lags + delta) / sr
    # Praat reflects correlations above 1 (short windows): r > 1 → 1/r
    val_par = torch.where(val_par > 1.0, 1.0 / torch.clamp(val_par, min=1e-12), val_par)
    sel_score = val_par - octave_cost * torch.log2(torch.clamp(min_pitch * tau_par, min=1e-12))
    band_score = torch.where(is_max, sel_score, float("-inf"))[..., lag_min:]

    # the best max_cand-1 maxima by repeated (masked max, first index):
    # value descending, index ascending on ties, exhausted rows give
    # distinct ascending picks that the was_cand gate discards
    nl = lag_max - lag_min + 1
    iot = torch.arange(nl, device=x.device)
    excl = torch.zeros(band_score.shape, dtype=torch.bool, device=x.device)
    picks = []
    for _ in range(max_cand - 1):
        avail = torch.where(excl, float("-inf"), band_score)
        mx = torch.amax(avail, dim=-1, keepdim=True)
        idx = torch.amin(torch.where((avail == mx) & ~excl, iot, nl), dim=-1, keepdim=True)
        excl = excl | (iot == idx)
        picks.append(idx)
    pick = torch.cat(picks, dim=-1)  # [B, NF, k]; nl where a row ran out of lags
    at = torch.clamp(pick, max=nl - 1)

    # sinc refinement of every lag of the band, read off at the candidates;
    # r is mirrored at lag 0 for the left support
    ext_left = depth + 2
    r_ext = torch.cat([torch.flip(r_full[..., 1 : ext_left + 1], dims=(-1,)), r_full], dim=-1)
    refine = refine_sinc_band if sinc_engine == "auto" else refine_sinc_band_reference
    pos_l, val_l = refine(r_ext, ext_left, lag_min, lag_max, depth, w=c["sinc_w"])
    top_lag = torch.gather(pos_l, -1, at)
    val_sinc = torch.gather(val_l, -1, at)
    was_cand = torch.gather(is_max[..., lag_min:], -1, at) & (pick < nl)
    val_sinc = torch.where(val_sinc > 1.0, 1.0 / torch.clamp(val_sinc, min=1e-12), val_sinc)
    # the path finder's octave cost is referenced to the ceiling (Praat)
    top_s = val_sinc - octave_cost * torch.log2(torch.clamp(max_pitch * (top_lag / sr), min=1e-12))
    freqs = torch.where(was_cand, sr / torch.clamp(top_lag, min=1e-6), 0.0)
    valid = was_cand & (freqs > min_pitch * 0.99) & (freqs < max_pitch * 1.01)
    strengths = torch.where(valid, top_s, -1e30)

    # the unvoiced candidate: localPeak/globalPeak capped at 1
    intensity = torch.clamp(local_peak / global_peak, max=1.0)
    ratio = intensity / (silence_thresh / (1.0 + voicing_thresh))
    s_unvoiced = voicing_thresh + torch.clamp(2.0 - ratio, min=0.0)
    all_strength = torch.cat([strengths, s_unvoiced[..., None]], dim=-1)  # [B, NF, K]
    all_freq = torch.cat([freqs, torch.zeros_like(s_unvoiced[..., None])], dim=-1)

    # Praat's transition costs are per 0.01 s
    corr = 0.01 / hop
    path = viterbi_path(all_strength, all_freq, octave_jump_cost * corr, voiced_unvoiced_cost * corr)
    f0 = torch.gather(all_freq, -1, path[..., None])[..., 0]
    return f0.reshape(*lead, nf)
