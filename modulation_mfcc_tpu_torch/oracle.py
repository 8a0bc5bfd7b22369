"""CPU parity oracle: float64 numpy/scipy reimplementations of the
reference pipeline's semantics, the second bar the port is held to (``modmfcc-torch
verify``, chip_smoke.py). The same functions as the JAX package's
``modulation_mfcc_tpu/oracle.py``, built on this package's own host designs
(ops/spectral: ``analysis_window``, ``dct_matrix``, ``mel_filterbank``, which
equal the JAX package's bit for bit), so it imports neither jax nor that
package and runs where jax is not installed.

The reference (script/mfcc.py, script/calc.py in aaron-randreth/modulation-mfcc)
delegates to librosa/scipy/Praat. This module re-derives the *exact* librosa
formulas in plain numpy (float64) + scipy:

  - librosa.feature.mfcc = dct(power_to_db(melspectrogram(...)), type=2,
    norm='ortho')[:n_mfcc]   with melspectrogram power=2.0, n_mels=128,
    stft center=True, pad_mode='constant', periodic hann window.
  - power_to_db: ref=1.0, amin=1e-10, top_db=80.0 (global max clip).
  - mel filterbank: Slaney scale + Slaney normalization.

The filter stages (butter/sosfiltfilt/savgol/...) use scipy, the library the
reference calls.
"""
from __future__ import annotations

import numpy as np
import scipy.stats
from scipy.signal import butter, filtfilt, firwin, savgol_filter, sosfiltfilt

from modulation_mfcc_tpu_torch.ops.spectral import (
    analysis_window,
    dct_matrix,
    mel_filterbank,
)


def stft_power_np(
    y: np.ndarray, n_fft: int, hop: int, win_length: int, pad_mode: str = "constant"
) -> np.ndarray:
    """|STFT|^2 with librosa conventions (center=True). Returns [n_bins, n_frames]."""
    w = analysis_window(n_fft, "hann", win_length)
    pad = n_fft // 2
    ypad = np.pad(y.astype(np.float64), pad, mode=pad_mode)
    nf = 1 + (len(ypad) - n_fft) // hop
    idx = np.arange(nf)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = ypad[idx] * w[None, :]
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    return (np.abs(spec) ** 2).T


def power_to_db_np(s: np.ndarray, amin: float = 1e-10, top_db: float | None = 80.0):
    log_spec = 10.0 * np.log10(np.maximum(amin, s))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def mfcc_np(
    y: np.ndarray,
    sr: float,
    *,
    n_mfcc: int = 13,
    win_length: int,
    hop_length: int,
    n_fft: int = 512,
    fmin: float = 100.0,
    fmax: float = 10000.0,
    n_mels: int = 128,
) -> np.ndarray:
    """librosa.feature.mfcc equivalent. Returns [n_mfcc, n_frames]."""
    p = stft_power_np(y, n_fft, hop_length, win_length)
    m = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    mel = m @ p
    db = power_to_db_np(mel)
    d = dct_matrix(n_mfcc, n_mels)
    return d @ db


def get_mfccs_change_np(
    y: np.ndarray,
    sig_sr: float,
    *,
    t_step: float = 0.005,
    win_len: float = 0.025,
    n_mfcc: int = 13,
    n_fft: int = 512,
    min_freq: float = 100.0,
    max_freq: float = 10000.0,
    remove_first: int = 1,
    filt_cutoff: float = 12.0,
    filt_ord: int = 6,
    diff_method: str = "grad",
    out_filter: str | None = "iir",
    out_filt_cutoff=(12.0,),
    out_filt_len: int = 6,
    out_filt_poly_ord: int = 3,
):
    """Oracle for reference get_MFCCS_change (script/mfcc.py:291-427).

    Follows the reference line by line: librosa MFCC → drop C0 → per-coef
    Butterworth sosfiltfilt low-pass → gradient (or SG deriv) → L2-norm/n →
    final low-pass. Uses real scipy for every filter stage.
    """
    win_length = int(win_len * sig_sr)
    hop_length = int(t_step * sig_sr)
    m = mfcc_np(
        y,
        sig_sr,
        n_mfcc=n_mfcc,
        win_length=win_length,
        hop_length=hop_length,
        n_fft=n_fft,
        fmin=min_freq,
        fmax=max_freq,
    )
    n_frames = m.shape[1]
    t = np.round(np.arange(1, n_frames + 1) * t_step + win_len / 2.0, 4)
    if remove_first:
        m = m[1:, :]
    cut_norm = filt_cutoff / ((1.0 / t_step) / 2.0)
    sos = butter(filt_ord, cut_norm, btype="low", output="sos")
    filt = sosfiltfilt(sos, m)
    if diff_method == "grad":
        diff = np.gradient(filt, axis=1)
    else:
        diff = savgol_filter(filt, 3, 2, deriv=1, axis=1, mode="interp")
    tot = np.sqrt(np.sum(diff**2, axis=0)) / m.shape[0]
    if out_filter is None:
        tot = sosfiltfilt(sos, tot)
    elif out_filter == "iir":
        w = np.asarray(out_filt_cutoff) / ((1.0 / t_step) / 2.0)
        sos2 = butter(out_filt_len, w if len(w) > 1 else w[0], btype="low", output="sos")
        tot = sosfiltfilt(sos2, tot)
    elif out_filter == "fir":
        w = np.asarray(out_filt_cutoff) / ((1.0 / t_step) / 2.0)
        b = firwin(out_filt_len, w if len(w) > 1 else w[0], window=("kaiser", 7.4), pass_zero="lowpass")
        tot = filtfilt(b, 1.0, tot)
    elif out_filter == "sg":
        tot = savgol_filter(tot, out_filt_len, out_filt_poly_ord, deriv=0, mode="interp")
    else:
        raise NotImplementedError(out_filter)
    return tot, t


# ---------------------------------------------------------------------------
# pYIN oracle — librosa.pyin re-derived in float64 numpy
# ---------------------------------------------------------------------------
#
# The reference calls librosa.pyin (script/calc.py:562-581). librosa is pure
# numpy/scipy and deterministic, so its formulas are re-derived here exactly
# (same approach as the MFCC oracle above), including the implementation
# quirks that differ from the Mauch & Dixon paper:
#   * the difference function's index conventions (correlation sums
#     j = 0..win_length inclusive, energies sum j = τ+1..τ+win_length) and
#     the |value| < 1e-6 snapping;
#   * thresholds applied to the RAW trough heights (parabolic refinement
#     adjusts only the decoded period), |shift| > 1 → 0;
#   * the no-trough mass added at the lowest trough, skipped entirely for
#     frames with no troughs;
#   * pitch-bin index clipped into [0, n_bins] INCLUSIVE, where bin n_bins
#     falls into the (later overwritten) unvoiced block = candidate dropped;
#   * transition_local's triangular window of FULL length
#     int(rate·12·bins_per_semitone·hop/sr), and the Viterbi initial
#     distribution uniform over the unvoiced states only.


def _localmin_np(x: np.ndarray) -> np.ndarray:
    """librosa.util.localmin along the last axis (edge padding)."""
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(1, 1)], mode="edge")
    return (x < xp[..., :-2]) & (x <= xp[..., 2:])


def _triang_np(m: int) -> np.ndarray:
    """scipy.signal.windows.triang(M, sym=True)."""
    n = np.arange(1, (m + 1) // 2 + 1, dtype=np.float64)
    if m % 2 == 0:
        w = (2 * n - 1.0) / m
        return np.concatenate([w, w[::-1]])
    w = 2.0 * n / (m + 1.0)
    return np.concatenate([w, w[-2::-1]])


def transition_local_np(n_states: int, width: float) -> np.ndarray:
    """librosa.sequence.transition_local(n, width, window='triangle',
    wrap=False): a triangular window of full length int(width) is
    pad_center'd to n, rolled so its peak lands on the diagonal, truncated
    to the band [i - width//2, i + width//2], and row-normalized."""
    m = int(width)
    if m < 1:
        raise ValueError(f"transition window width {width} must be >= 1")
    if m > n_states:
        raise ValueError(f"transition window {m} exceeds n_states {n_states}")
    base = np.zeros(n_states)
    lo = (n_states - m) // 2
    base[lo : lo + m] = _triang_np(m)
    trans = np.zeros((n_states, n_states))
    for i in range(n_states):
        row = np.roll(base, n_states // 2 + i + 1)
        row[min(n_states, i + m // 2 + 1) :] = 0
        row[: max(0, i - m // 2)] = 0
        trans[i] = row
    return trans / trans.sum(axis=1, keepdims=True)


def pyin_np(
    x: np.ndarray,
    sr: float,
    *,
    fmin: float = 75.0,
    fmax: float = 600.0,
    frame_length: int = 2048,
    win_length: int | None = None,
    hop_length: int | None = None,
    n_thresholds: int = 100,
    beta_parameters: tuple = (2, 18),
    boltzmann_parameter: int = 2,
    resolution: float = 0.1,
    max_transition_rate: float = 35.92,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    center: bool = True,
    pad_mode: str = "constant",
    return_model: bool = False,
    bin_shift: float = 0.0,
):
    """librosa.pyin oracle. Returns ``(f0, voiced_flag, states)`` with f0 in
    Hz for every frame (the decoded bin's frequency even when unvoiced,
    exactly as librosa returns before fill_na) and the Viterbi state path.

    ``return_model=True`` appends the float64 decode model
    ``(log_obs, log_trans, log_p_init)`` so callers can score an
    ALTERNATIVE state path under the exact model this decode maximised
    (:func:`viterbi_path_score_np`).

    ``bin_shift`` perturbs the candidate pitch-bin ROUNDING boundary by
    the given fraction of a bin (round(v + bin_shift) instead of
    round(v)): the verify harness's near-tie certificate for device f32
    single-bin flips — a candidate whose pre-round value sits within
    ~1e-3 bins of the .5 boundary lands on either side depending on f32
    arithmetic ulps (measured on v5e at 16 kHz: such flips carry the
    WHOLE beta mass with them, so they are observation-level, not
    Viterbi-tie, disagreements — the decode that results is librosa's own
    under a measure-zero boundary perturbation).
    """
    if win_length is None:
        win_length = frame_length // 2
    if hop_length is None:
        hop_length = frame_length // 4
    x = np.asarray(x, np.float64)
    xp = np.pad(x, frame_length // 2, mode=pad_mode) if center else x
    nf = 1 + (len(xp) - frame_length) // hop_length
    idx = np.arange(nf)[:, None] * hop_length + np.arange(frame_length)[None, :]
    frames = xp[idx]  # [NF, frame_length]

    min_period = max(int(np.floor(sr / fmax)), 1)
    max_period = min(int(np.ceil(sr / fmin)), frame_length - win_length - 1)

    # --- cumulative mean normalized difference (librosa's exact form) ----
    w = win_length
    acf = np.empty((nf, max_period + 1))
    for tau in range(max_period + 1):
        acf[:, tau] = np.sum(frames[:, : w + 1] * frames[:, tau : tau + w + 1], axis=1)
    acf[np.abs(acf) < 1e-6] = 0.0
    cs = np.cumsum(frames**2, axis=1)
    energy = (cs[:, w:] - cs[:, :-w])[:, : max_period + 1]
    energy = energy.copy()
    energy[np.abs(energy) < 1e-6] = 0.0
    d = energy[:, :1] + energy - 2.0 * acf  # yin_frames, lags 0..max_period
    tau_range = np.arange(1, max_period + 1, dtype=np.float64)
    cum_mean = np.cumsum(d[:, 1:], axis=1) / tau_range
    tiny = np.finfo(np.float64).tiny
    band = d[:, min_period : max_period + 1] / (
        cum_mean[:, min_period - 1 : max_period] + tiny
    )  # [NF, L]

    # --- parabolic shifts on the band ------------------------------------
    shifts = np.zeros_like(band)
    with np.errstate(divide="ignore", invalid="ignore"):
        a2 = band[:, :-2] + band[:, 2:] - 2.0 * band[:, 1:-1]
        s = (band[:, :-2] - band[:, 2:]) / (2.0 * a2)
    shifts[:, 1:-1] = s
    shifts[np.abs(shifts) > 1.0] = 0.0  # NaNs survive in librosa too; they
    # are only ever read at troughs, where the parabola is well-defined.

    thresholds = np.linspace(0, 1, n_thresholds + 1)
    beta_probs = np.diff(
        scipy.stats.beta.cdf(thresholds, beta_parameters[0], beta_parameters[1])
    )
    nbps = int(np.ceil(1.0 / resolution))
    n_pitch_bins = int(np.floor(12.0 * nbps * np.log2(fmax / fmin))) + 1

    obs = np.zeros((nf, 2 * n_pitch_bins))
    for f in range(nf):
        yf = band[f]
        is_trough = _localmin_np(yf)
        is_trough[0] = yf[0] < yf[1]
        (ti,) = np.nonzero(is_trough)
        if len(ti) == 0:
            obs[f, n_pitch_bins:] = 1.0 / n_pitch_bins
            continue
        heights = yf[ti]
        below = np.less.outer(heights, thresholds[1:])  # [n_troughs, n_thr]
        positions = np.cumsum(below, axis=0) - 1
        n_below = np.count_nonzero(below, axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            prior = scipy.stats.boltzmann.pmf(
                positions, boltzmann_parameter, n_below
            )
        prior[~below] = 0.0
        probs = np.sum(prior * beta_probs, axis=1)
        gmin = int(np.argmin(heights))
        n_miss = int(np.count_nonzero(~below[gmin]))
        probs[gmin] += no_trough_prob * np.sum(beta_probs[:n_miss])
        periods = min_period + ti + shifts[f, ti]
        f0c = sr / periods
        bins = np.clip(
            np.round(12.0 * nbps * np.log2(f0c / fmin) + bin_shift),
            0, n_pitch_bins,
        ).astype(int)
        row = np.zeros(2 * n_pitch_bins)
        row[bins] = probs  # fancy assignment: duplicate bins last-write-win
        voiced_prob = min(1.0, max(0.0, float(np.sum(row[:n_pitch_bins]))))
        row[n_pitch_bins:] = (1.0 - voiced_prob) / n_pitch_bins
        obs[f] = row

    # --- Viterbi ---------------------------------------------------------
    twidth = max_transition_rate * 12.0 * nbps * hop_length / sr
    tri = transition_local_np(n_pitch_bins, twidth)
    t_switch = np.array(
        [[1 - switch_prob, switch_prob], [switch_prob, 1 - switch_prob]]
    )
    trans = np.kron(t_switch, tri)
    p_init = np.zeros(2 * n_pitch_bins)
    p_init[n_pitch_bins:] = 1.0 / n_pitch_bins
    lt = np.log(trans + tiny)
    lo = np.log(obs + tiny)
    lp0 = np.log(p_init + tiny)
    value = lo[0] + lp0
    ptrs = np.zeros((nf, 2 * n_pitch_bins), dtype=int)
    for t in range(1, nf):
        scores = value[:, None] + lt
        ptrs[t] = np.argmax(scores, axis=0)
        value = lo[t] + np.max(scores, axis=0)
    states = np.zeros(nf, dtype=int)
    states[-1] = int(np.argmax(value))
    for t in range(nf - 2, -1, -1):
        states[t] = ptrs[t + 1][states[t + 1]]
    freqs = fmin * 2.0 ** (np.arange(n_pitch_bins) / (12.0 * nbps))
    f0 = freqs[states % n_pitch_bins]
    voiced = states < n_pitch_bins
    if return_model:
        return f0, voiced, states, (lo, lt, lp0)
    return f0, voiced, states


def viterbi_path_score_np(states: np.ndarray, model: tuple) -> float:
    """Float64 log-score of a given state path under a pyin decode model
    (``pyin_np(..., return_model=True)``'s third extra return).

    The oracle's own decoded path maximises this score by construction, so
    ``score(oracle_path) - score(other_path) >= 0`` up to float64 rounding
    — and for a device f32 decode that differs only at genuine numerical
    ties the gap is bounded by the f32 resolution of the accumulated
    deltas, while a real decode bug loses whole transition/observation
    log-factors (orders of magnitude larger)."""
    lo, lt, lp0 = model
    states = np.asarray(states, dtype=int)
    s = float(lp0[states[0]] + lo[0, states[0]])
    for t in range(1, len(states)):
        s += float(lt[states[t - 1], states[t]] + lo[t, states[t]])
    return s


# ---------------------------------------------------------------------------
# Boersma-1993 autocorrelation pitch oracle (Praat "To Pitch (ac)")
# ---------------------------------------------------------------------------
#
# Written straight from Boersma (1993) and Praat's published semantics
# (Sound_to_Pitch.cpp / Pitch_pathFinder), NOT from the JAX implementation:
# per-frame loops, direct lag sums for the autocorrelation, per-candidate
# Brent refinement of the windowed-sinc interpolant (Praat's floor-anchored
# NUM_interpolate_sinc), and an explicit O(NF·K²) Viterbi. This gives the
# JAX tracker (ops/pitch.py) a derivation-independent check — the two share
# only the published algorithm and the frame-grid convention.


def _praat_sinc_interp(y: np.ndarray, x: float, max_depth: int) -> float:
    """Praat NUM_interpolate_sinc: windowed-sinc interpolation of y at
    fractional 0-based position x; the raised-cosine taper is anchored at
    floor(x) (so the support set shifts when x crosses an integer)."""
    n = len(y)
    if x <= 0:
        return float(y[0])
    if x >= n - 1:
        return float(y[-1])
    midleft = int(np.floor(x))
    if x == midleft:
        return float(y[midleft])
    midright = midleft + 1
    depth = min(max_depth, midright, n - 1 - midleft)
    if depth < 1:
        return float(y[int(round(x))])
    left, right = midright - depth, midleft + depth
    lix = np.arange(left, midleft + 1)
    dl = x - lix
    wl = (0.5 * np.sin(np.pi * dl) / (np.pi * dl)) * (
        1.0 + np.cos(np.pi * dl / (x - left + 1.0))
    )
    rix = np.arange(midright, right + 1)
    dr = rix - x
    wr = (0.5 * np.sin(np.pi * dr) / (np.pi * dr)) * (
        1.0 + np.cos(np.pi * dr / (right - x + 1.0))
    )
    return float(np.sum(y[lix] * wl) + np.sum(y[rix] * wr))


def _improve_maximum(y: np.ndarray, ix: int, depth: int) -> tuple[float, float]:
    """Praat NUMimproveMaximum: maximize the sinc interpolant of y on
    (ix−1, ix+1) by golden-section/Brent. Returns (position, value)."""
    from scipy.optimize import minimize_scalar

    if ix <= 0 or ix >= len(y) - 1:
        return float(ix), float(y[ix])
    res = minimize_scalar(
        lambda t: -_praat_sinc_interp(y, t, depth),
        bounds=(ix - 1.0, ix + 1.0),
        method="bounded",
        options={"xatol": 1e-7},
    )
    return float(res.x), float(-res.fun)


def boersma_pitch_np(
    x: np.ndarray,
    sr: float,
    *,
    hop: float = 0.01,
    min_pitch: float = 75.0,
    max_pitch: float = 600.0,
    max_cand: int = 15,
    silence_thresh: float = 0.03,
    voicing_thresh: float = 0.45,
    octave_cost: float = 0.01,
    octave_jump_cost: float = 0.35,
    voiced_unvoiced_cost: float = 0.14,
    periods_per_window: float = 3.0,
    very_accurate: bool = False,
    method: str = "ac",
) -> np.ndarray:
    """Boersma-1993 pitch track [NF] in Hz (0 where unvoiced), f64.

    Praat semantics implemented independently: 'ac' = AC_HANNING window
    0.5−0.5·cos(2πi/(n+1)) (AC_GAUSS when very_accurate, with the window
    doubled to 6 periods), window-autocorrelation normalization; 'cc' =
    forward normalized cross-correlation of a ONE-period rectangular
    window against its lag-shifted copy (To Pitch (cc), energies per lag),
    with the sinc support carrying GENUINE cross-correlation values from
    the signal rather than an edge extrapolation. Both share candidate
    reflection around 1, elite selection by R − octaveCost·log2(minPitch·τ),
    path-finder strengths R − octaveCost·log2(ceiling/f) with the unvoiced
    strength voicingThresh + max(0, 2 − intensity·(1+vt)/st), transition
    costs scaled by 0.01/dt. Frame grid matches the convention documented in
    ops/pitch.py (midpoint-centered regular grid).
    """
    x = np.asarray(x, np.float64)
    n = len(x)
    if method == "cc":
        periods_per_window = 1.0
    elif very_accurate:
        periods_per_window *= 2.0
    depth = 700 if very_accurate else 70  # Praat sinc700 / sinc70
    nw = min(int(round(periods_per_window / min_pitch * sr)), n)
    hop_s = int(round(hop * sr))
    lag_min = max(2, int(np.floor(sr / max_pitch)))
    lag_max = min(n - 1, int(np.ceil(sr / min_pitch)))
    if method == "ac":
        lag_max = min(lag_max, nw - 1)
    span = nw + lag_max if method == "cc" else nw
    nf = max(1, 1 + (n - span) // hop_s)
    start0 = max(0, (n - span - (nf - 1) * hop_s) // 2)

    xg = x - np.mean(x)
    global_peak = np.max(np.abs(xg)) + 1e-30

    if method == "ac":
        i = np.arange(1, nw + 1, dtype=np.float64)
        imid = 0.5 * (nw + 1)
        if very_accurate:
            edge = np.exp(-12.0)
            w = (np.exp(-48.0 * ((i - imid) / (nw + 1)) ** 2) - edge) / (1.0 - edge)
        else:
            w = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (nw + 1))
        lag_hi = lag_max + depth + 2
        # window autocorrelation (direct sums, zero-extended)
        wac = np.array(
            [np.dot(w[: nw - t], w[t:nw]) for t in range(min(lag_hi + 1, nw))]
        )
        wac = np.concatenate([wac, np.zeros(lag_hi + 1 - len(wac))])
        rw = wac / wac[0]

    nsamp_period = max(1, int(np.floor(sr / min_pitch)))
    ext = depth + 2
    cands_per_frame = []  # list of (freqs[], strengths[]) per frame
    for f in range(nf):
        s0 = start0 + f * hop_s
        fr = xg[s0 : s0 + span].copy()
        mid = span // 2
        mlo, mhi = max(0, mid - nsamp_period), min(span, mid + nsamp_period)
        lmean = np.mean(fr[mlo:mhi])
        fr -= lmean
        local_peak = np.max(np.abs(fr[:nw])) + 1e-30
        if method == "ac":
            fw = fr * w
            ac = np.array(
                [np.dot(fw[: nw - t], fw[t:nw]) for t in range(min(lag_hi + 1, nw))]
            )
            ac = np.concatenate([ac, np.zeros(lag_hi + 1 - len(ac))])
            r = ac / (ac[0] + 1e-30) / np.maximum(rw, 1e-6)
            # mirror r at lag 0 for the left sinc support (r is symmetric)
            r_ext = np.concatenate([r[1 : ext + 1][::-1], r])
        else:
            # forward normalized cross-correlation; the sinc support beyond
            # [0, lag_max] reads the TRUE r(τ) of the signal (shifted
            # windows taken directly from xg minus the same local mean,
            # zero where they leave the signal)
            base = fr[:nw]
            e0 = np.dot(base, base)

            def _shifted(tau, _s0=s0, _lm=lmean):
                a = _s0 + tau
                seg = np.zeros(nw)
                lo, hi = max(0, a), min(n, a + nw)
                if hi > lo:
                    seg[lo - a : hi - a] = xg[lo:hi] - _lm
                return seg

            taus = np.arange(-ext, lag_max + ext + 1)
            r_ext = np.empty(len(taus))
            for ti, tau in enumerate(taus):
                seg = _shifted(int(tau))
                r_ext[ti] = np.dot(base, seg) / np.sqrt(
                    max(e0 * np.dot(seg, seg), 1e-30)
                )
            r = r_ext[ext:]
        # local maxima in the search band
        cands = []
        for lagi in range(lag_min, lag_max + 1):
            if r[lagi] > r[lagi - 1] and r[lagi] >= r[lagi + 1]:
                pos, val = _improve_maximum(r_ext, ext + lagi, depth)
                pos -= ext
                if val > 1.0:
                    val = 1.0 / val  # Praat's reflection
                freq = sr / pos if pos > 0 else 0.0
                if not (min_pitch * 0.99 < freq < max_pitch * 1.01):
                    continue
                sel = val - octave_cost * np.log2(min_pitch * (pos / sr))
                cands.append((sel, freq, val))
        # elite: keep the max_cand−1 best by selection score
        cands.sort(key=lambda c: -c[0])
        cands = cands[: max_cand - 1]
        intensity = min(local_peak / global_peak, 1.0)
        s_unv = voicing_thresh + max(
            0.0, 2.0 - intensity * (1.0 + voicing_thresh) / silence_thresh
        )
        freqs = [c[1] for c in cands] + [0.0]
        strengths = [
            c[2] - octave_cost * np.log2(max_pitch / c[1]) for c in cands
        ] + [s_unv]
        cands_per_frame.append((np.array(freqs), np.array(strengths)))

    # Viterbi (Praat Pitch_pathFinder conventions)
    corr = 0.01 / hop
    jump_c = octave_jump_cost * corr
    vuv_c = voiced_unvoiced_cost * corr
    fr0, st0 = cands_per_frame[0]
    delta = st0.copy()
    backs = []
    prev_freqs = fr0
    for f in range(1, nf):
        fcur, scur = cands_per_frame[f]
        cost = np.zeros((len(prev_freqs), len(fcur)))
        for a in range(len(prev_freqs)):
            for b in range(len(fcur)):
                pv, cv = prev_freqs[a] > 0, fcur[b] > 0
                if pv and cv:
                    cost[a, b] = jump_c * abs(np.log2(prev_freqs[a] / fcur[b]))
                elif pv != cv:
                    cost[a, b] = vuv_c
        scores = delta[:, None] - cost
        backs.append(np.argmax(scores, axis=0))
        delta = scur + np.max(scores, axis=0)
        prev_freqs = fcur
    path = np.zeros(nf, dtype=int)
    path[-1] = int(np.argmax(delta))
    for f in range(nf - 2, -1, -1):
        path[f] = backs[f][path[f + 1]]
    return np.array(
        [cands_per_frame[f][0][path[f]] for f in range(nf)]
    )


# ---------------------------------------------------------------------------
# Burg LPC + formant oracle (Praat "To Formant (burg)")
# ---------------------------------------------------------------------------


def burg_np(frame: np.ndarray, order: int) -> np.ndarray:
    """Burg's method (Andersen 1974 recursion), float64, one frame.

    Returns a_1..a_p with x[n] ≈ −Σ a_k x[n−k] (polynomial 1 + Σ a_k z^-k),
    written from the published recursion: forward/backward prediction error
    updates with reflection coefficient k_m = −2·Σf·b / (Σf² + Σb²) and the
    Levinson coefficient update.
    """
    f = np.asarray(frame, np.float64).copy()
    b = f.copy()
    a = np.zeros(order)
    for m in range(order):
        fk = f[1:]
        bk = b[:-1]
        den = np.dot(fk, fk) + np.dot(bk, bk)
        k = -2.0 * np.dot(fk, bk) / den if den > 0 else 0.0
        f, b = fk + k * bk, bk + k * fk
        if m > 0:
            a[:m] = a[:m] + k * a[:m][::-1]
        a[m] = k
    return a


def praat_intensity_np(
    x: np.ndarray,
    sr: float,
    *,
    min_pitch: float = 100.0,
    time_step: float = 0.0,
    subtract_mean: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Praat ``Sound: To Intensity...`` oracle, float64. Returns (times, dB).

    Independent re-derivation of the published algorithm (Sound_to_Intensity
    in the Praat sources; the reference calls it via parselmouth at
    script/calc.py:156 ``sound.to_intensity()`` and script/mfcc.py:229
    ``call(xObj, "To Intensity", minPitch, hopLen, 1)``):

    - physical window 6.4/minPitch (twice the documented 3.2-period
      *effective* duration); default time step 0.8/minPitch ("four times
      oversampling Hanning-wise");
    - frame grid from Sampled_shortTermAnalysis on a Sound with x1 = dx/2:
      nf = floor((duration − windowDur)/timeStep) + 1, first mid-time =
      duration/2 − (nf − 1)·timeStep/2, frame mid SAMPLE = nearest index;
    - Kaiser taper w(i) = I₀((2π² + 0.5)·√(1 − (i·dx/halfDur)²)) on the
      2·hws+1 samples around the mid sample (hws = floor(halfDur·sr)) —
      Praat evaluates it with the float NUMbessel_i0_f approximation,
      ~1e-7 relative, far below the dB scale;
    - per-frame PLAIN mean over the in-range samples subtracted before
      squaring (subtractMeanPressure), windowed mean square normalized by
      the in-range window sum; out-of-range samples (possible only at the
      exact right boundary) drop out of every sum;
    - dB = 10·log10(ms / 4e-10), −300 where ms < 1e-30.
    """
    from scipy.special import i0 as _bessel_i0

    x = np.asarray(x, np.float64)
    n = len(x)
    dx = 1.0 / sr
    if time_step <= 0.0:
        time_step = 0.8 / min_pitch
    window_dur = 6.4 / min_pitch
    half_dur = 0.5 * window_dur
    hws = int(np.floor(half_dur * sr))
    duration = n * dx
    if window_dur > duration:
        raise ValueError("signal shorter than the 6.4/minPitch analysis window")
    nf = int(np.floor((duration - window_dur) / time_step)) + 1
    first_time = 0.5 * duration - 0.5 * nf * time_step + 0.5 * time_step
    i = np.arange(-hws, hws + 1, dtype=np.float64)
    root = 1.0 - (i * dx / half_dur) ** 2
    w = np.where(root > 0.0, _bessel_i0((2.0 * np.pi**2 + 0.5) * np.sqrt(np.maximum(root, 0.0))), 0.0)
    times = first_time + np.arange(nf) * time_step
    db = np.empty(nf)
    for f in range(nf):
        # nearest 0-based sample (Melder_iround = round-half-up). When the
        # grid puts a mid-time EXACTLY halfway between samples (every frame
        # does when duration·sr and timeStep·sr are integers of equal
        # parity), the outcome of Praat's own float evaluation is
        # ulp-arbitrary; pin the exact-arithmetic answer (round up) with an
        # epsilon far above f64 noise (~1e-11 here) and far below any
        # legitimate fractional part.
        mid = int(np.floor((times[f] - 0.5 * dx) * sr + 0.5 + 1e-6))
        lo, hi = mid - hws, mid + hws + 1
        clo, chi = max(lo, 0), min(hi, n)
        seg = x[clo:chi]
        wseg = w[clo - lo : chi - lo]
        mean = np.mean(seg) if subtract_mean else 0.0
        d = seg - mean
        ms = np.dot(d * d, wseg) / np.sum(wseg)
        db[f] = -300.0 if ms < 1e-30 else 10.0 * np.log10(ms / 4.0e-10)
    return times, db


def praat_formants_np(
    x: np.ndarray,
    sr: float,
    *,
    max_formants: float = 5.0,
    window_length: float = 0.025,
    time_step: float = 0.005,
    pre_emphasis_from: float = 50.0,
    max_formant: float = 5500.0,
):
    """Formant tracks via Burg LPC, float64 (x already at 2·max_formant).

    Pipeline follows Praat's To Formant (burg) semantics: pre-emphasis
    x[i] −= exp(−2π·F·dt)·x[i−1], physical window 2·window_length with the
    Gaussian taper exp(−48·u²) edge-normalized, Burg LPC of order
    2·max_formants, np.roots of the prediction polynomial, formants =
    |angle|·sr/2π with bandwidth −ln|z|·sr/π, kept in
    (50, max_formant−50) and sorted ascending. Frame mean subtraction
    before windowing matches ops/lpc.py's documented pipeline. Returns
    (times, freqs [NF, p/2], bws [NF, p/2]) NaN-padded.
    """
    x = np.asarray(x, np.float64)
    n = len(x)
    order = int(2 * max_formants)
    alpha = np.exp(-2.0 * np.pi * pre_emphasis_from / sr)
    xp = x.copy()
    xp[1:] = x[1:] - alpha * x[:-1]
    nw = min(max(int(round(2.0 * window_length * sr)), 4), n)
    hop = max(1, int(round(time_step * sr)))
    nf = max(1, 1 + (n - nw) // hop)
    start0 = max(0, (n - nw - (nf - 1) * hop) // 2)
    i = np.arange(1, nw + 1, dtype=np.float64)
    imid = 0.5 * (nw + 1)
    edge = np.exp(-12.0)
    w = (np.exp(-48.0 * ((i - imid) / (nw + 1)) ** 2) - edge) / (1.0 - edge)
    nform = order // 2
    freqs = np.full((nf, nform), np.nan)
    bws = np.full((nf, nform), np.nan)
    times = (start0 + np.arange(nf) * hop + nw / 2.0) / sr
    for f in range(nf):
        s0 = start0 + f * hop
        fr = xp[s0 : s0 + nw].copy()
        fr -= np.mean(fr)
        a = burg_np(fr * w, order)
        roots = np.roots(np.concatenate([[1.0], a]))
        fs, bs = [], []
        for z in roots:
            ang = np.angle(z)
            if ang <= 0:
                continue
            fq = ang * sr / (2.0 * np.pi)
            if 50.0 < fq < max_formant - 50.0:
                fs.append(fq)
                bs.append(-np.log(max(abs(z), 1e-12)) * sr / np.pi)
        order_ix = np.argsort(fs)
        for j, ix in enumerate(order_ix[:nform]):
            freqs[f, j] = fs[ix]
            bws[f, j] = bs[ix]
    return times, freqs, bws


def praat_spectrogram_np(
    x: np.ndarray,
    sr: float,
    window_length: float = 0.005,
    max_frequency: float = 5000.0,
    time_step: float = 0.002,
):
    """Float64 re-derivation of the display spectrogram
    (models/sound.praat_spectrogram; reference
    script/praat_py_ui/parselmouth_calc.py:31-39 = to_spectrogram +
    10*log10): Gaussian window (std = nw/6) over mean-subtracted frames,
    power rFFT, bins kept up to the view ceiling, 10*log10 with the 1e-12
    display floor. Returns (times, freqs, dB [n_times, n_freqs])."""
    x = np.asarray(x, np.float64)
    if x.ndim > 1:
        x = x[0]
    nw = max(8, int(round(2 * window_length * sr)))
    hop = max(1, int(round(time_step * sr)))
    n_fft = 1
    while n_fft < nw:
        n_fft *= 2
    n = np.arange(nw) - (nw - 1) / 2.0
    w = np.exp(-0.5 * (n / (nw / 6.0)) ** 2)
    nf = 1 + (len(x) - nw) // hop
    if nf < 1:
        raise ValueError(
            f"input too short for the analysis window: {len(x)} samples "
            f"< window {nw} ({2 * window_length:g} s at {sr:g} Hz)"
        )
    frames = np.stack([x[f * hop : f * hop + nw] for f in range(nf)])
    frames = frames - frames.mean(axis=-1, keepdims=True)
    spec = np.fft.rfft(frames * w, n=n_fft, axis=-1)
    p = spec.real**2 + spec.imag**2
    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    keep = freqs <= max_frequency
    db = 10.0 * np.log10(np.maximum(p[:, keep], 1e-12))
    times = (np.arange(nf) * hop + nw / 2) / sr
    return times, freqs[keep], db
