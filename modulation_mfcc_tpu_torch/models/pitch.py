"""F0 extraction, the reference's get_f0 surface (script/calc.py:386-592).

Methods praatac/praatcc (ops/pitch.py autocorrelation + sinc refinement
kernel + path finder) and pyin (ops/yin.py CMNDF + threshold sweep + the
Viterbi kernels), the optional two-pass quantile-adaptive pitch range
(minMaxQuant), unvoiced → NaN (pyin: ``pyinfill_na``), NaN interpolation
and the zero-phase 'iir' post filter, all on the tensors' device
(post-processing in float64). :class:`PitchTracker` and
:class:`PyinTracker` hold the trackers' designed constants as buffers.
"""
from __future__ import annotations

import numpy as np
import torch

from modulation_mfcc_tpu_torch.models.config import F0Config
from modulation_mfcc_tpu_torch.ops import filters as F
from modulation_mfcc_tpu_torch.ops.interp import interp_nan
from modulation_mfcc_tpu_torch.ops.pitch import PitchGeometry, pitch_ac, pitch_constants, pitch_geometry
from modulation_mfcc_tpu_torch.ops.yin import PyinGeometry, pyin_constants, pyin_f0, pyin_geometry
from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

__all__ = ["PitchTracker", "PyinTracker", "extract_f0", "PRAAT_METHODS"]

PRAAT_METHODS = {"praatac": "ac", "praatcc": "cc"}
_NOMINAL_N = 2**31 - 1  # geometry of a signal long enough that nothing is clipped to it


def check_method(cfg: F0Config) -> str:
    """'pyin', or the pitch_ac method ('ac', 'cc') of ``cfg.method``."""
    if cfg.method == "pyin":
        return "pyin"
    if cfg.method not in PRAAT_METHODS:
        raise ValueError(f"Unknown f0 method {cfg.method!r}")
    return PRAAT_METHODS[cfg.method]


class PitchTracker(torch.nn.Module):
    """Praat ac/cc pitch tracking of ``cfg`` at sample rate ``sr``, with
    its designed constants as buffers (see ops/pitch.pitch_constants):

    * ``sinc_w`` [S, 17]: the windowed-sinc interpolation weights;
    * 'ac' only: ``window`` [nw], the AC_HANNING (or, with veryAccurate,
      AC_GAUSS) taper, and ``rw`` [lag_hi+1], its normalized
      autocorrelation.

    A call whose geometry differs (a signal shorter than one window, or
    another pitch range) designs its own constants.
    """

    def __init__(self, cfg: F0Config = F0Config(), sr: float = 10_000):
        super().__init__()
        self.method = check_method(cfg)
        if self.method == "pyin":
            raise ValueError("PitchTracker runs praatac and praatcc; pyin runs in PyinTracker")
        self.cfg, self.sr = cfg, float(sr)
        for name, value in pitch_constants(self.geometry(_NOMINAL_N)).items():
            self.register_buffer(name, torch.tensor(value))

    def geometry(self, n: int) -> PitchGeometry:
        cfg = self.cfg
        return pitch_geometry(n, self.sr, cfg.hopSize, float(cfg.minPitch), float(cfg.maxPitch),
                              self.method, 3.0, bool(cfg.veryAccurate))

    def forward(
        self,
        x: torch.Tensor,
        valid_len: torch.Tensor | None = None,
        *,
        sinc_engine: str = "auto",
        min_pitch: float | None = None,
        max_pitch: float | None = None,
        method: str | None = None,
    ) -> torch.Tensor:
        """Raw F0 [..., NF] (0 = unvoiced) of float32 x [..., n]; the pitch
        range and method default to the config's."""
        cfg = self.cfg
        return pitch_ac(
            x,
            sr=self.sr,
            hop=cfg.hopSize,
            min_pitch=float(cfg.minPitch if min_pitch is None else min_pitch),
            max_pitch=float(cfg.maxPitch if max_pitch is None else max_pitch),
            max_cand=cfg.maxCandNum,
            method=method or self.method,
            silence_thresh=cfg.silenceThresh,
            voicing_thresh=cfg.voicingThresh,
            octave_cost=cfg.octaveCost,
            octave_jump_cost=cfg.octaveJumpCost,
            voiced_unvoiced_cost=cfg.voicedUnvoicedCost,
            very_accurate=bool(cfg.veryAccurate),
            sinc_engine=sinc_engine,
            valid_len=valid_len,
            consts=dict(self.named_buffers()),
        )


class PyinTracker(torch.nn.Module):
    """pyin tracking of ``cfg`` at sample rate ``sr``, with the decoder's
    designed float32 constants as buffers (see ops/yin.pyin_constants):

    * ``log_tri`` [n_bins, n_bins]: log of librosa's transition triangle;
    * ``beta_probs`` [n_thresholds], ``thresholds`` [n_thresholds]: the
      Beta prior's interval masses and the thresholds' upper ends;
    * ``log_p_init`` [2·n_bins]: the initial distribution, uniform over the
      unvoiced states.

    A call with another pitch range (minMaxQuant's second pass) or with
    float64 audio designs its own constants.
    """

    def __init__(self, cfg: F0Config = F0Config(method="pyin"), sr: float = 10_000):
        super().__init__()
        if check_method(cfg) != "pyin":
            raise ValueError(f"PyinTracker runs pyin, not {cfg.method!r}; praat methods run in PitchTracker")
        self.cfg, self.sr = cfg, float(sr)
        consts = pyin_constants(self.geometry(), cfg.n_thresholds, tuple(cfg.beta_parameters), torch.float32)
        for name, value in consts.items():
            self.register_buffer(name, torch.tensor(value))

    def geometry(self) -> PyinGeometry:
        cfg = self.cfg
        return pyin_geometry(self.sr, float(cfg.minPitch), float(cfg.maxPitch), cfg.pyinframe_length,
                             cfg.pyinwin_length, cfg.hopSize, cfg.resolution, cfg.max_transition_rate)

    def forward(
        self,
        x: torch.Tensor,
        *,
        fmin: float | None = None,
        fmax: float | None = None,
        viterbi_engine: str = "auto",
        return_states: bool = False,
    ):
        """Raw F0 [..., NF] (0 = unvoiced) of x [..., n] (and the decoded
        states with ``return_states``); the pitch range defaults to the
        config's."""
        cfg = self.cfg
        fmin = float(cfg.minPitch if fmin is None else fmin)
        fmax = float(cfg.maxPitch if fmax is None else fmax)
        own_range = (fmin, fmax) == (float(cfg.minPitch), float(cfg.maxPitch))
        return pyin_f0(
            x,
            sr=self.sr,
            fmin=fmin,
            fmax=fmax,
            frame_length=cfg.pyinframe_length,
            win_length=cfg.pyinwin_length,
            hop=cfg.hopSize,
            n_thresholds=cfg.n_thresholds,
            beta_parameters=cfg.beta_parameters,
            boltzmann_parameter=cfg.boltzmann_parameter,
            resolution=cfg.resolution,
            max_transition_rate=cfg.max_transition_rate,
            switch_prob=cfg.switch_prob,
            no_trough_prob=cfg.no_trough_prob,
            center=cfg.pyincenter,
            pad_mode=cfg.pyinpad_mode,
            viterbi_engine=viterbi_engine,
            return_states=return_states,
            consts=dict(self.named_buffers()) if own_range else None,
        )


def _second_pass_range(f0: torch.Tensor, cfg: F0Config, keep) -> tuple[float, float] | None:
    """minMaxQuant's pitch range for the second pass: the quantiles of the
    first pass's values that ``keep`` selects, rounded to 0.1 Hz, or None."""
    v = f0.cpu().numpy()
    v = v[keep(v)]
    if not v.size:
        return None
    q = np.quantile(v, [cfg.minMaxQuant[0], cfg.minMaxQuant[1]])
    lo, hi = round(float(q[0]), 1), round(float(q[1]), 1)
    return (lo, hi) if hi > lo > 0 else None


def extract_f0(x, sr: float, cfg: F0Config = F0Config(), device=None, *, sinc_engine: str = "auto",
               viterbi_engine: str = "auto"):
    """(f0 [NF] float64 tensor, times [NF] ndarray) of one utterance [n]
    with the reference's post-processing chain: unvoiced → NaN (pyin:
    ``pyinfill_na``, NaN by default), then ``interpUnvoiced`` and
    ``outFilter``. Computes on ``device`` (default: ``x``'s own if it is a
    tensor, else CUDA; ``device="cpu"`` for the CPU).

    minMaxQuant: the first pass's values go to the host for their
    quantiles, rounded to 0.1 Hz. Praat keeps the voiced F0 (> 20 Hz) and
    its second pass is always 'ac', even for praatcc (the reference's
    quirk, script/calc.py:548-556); pyin keeps the non-NaN values, which in
    the JAX package include the unvoiced zeros, and re-runs pyin.
    """
    if cfg.interpUnvoiced is None and cfg.outFilter is not None:
        raise ValueError(
            "Post processing filters should be applied (outFilter is not "
            "None) but unvoiced regions are not interpolated (interpUnvoiced "
            "is None). Cannot filter f0 signal with gaps due to unvoiced regions"
        )
    device = resolve_device(device, x)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.ndim != 1:
        raise ValueError(f"extract_f0 takes one utterance [n], got {tuple(x.shape)}; batches go to batched_f0")
    if check_method(cfg) == "pyin":
        tracker = PyinTracker(cfg, sr).to(device)
        f0 = tracker(x, viterbi_engine=viterbi_engine)
        rng = None if cfg.minMaxQuant is None else _second_pass_range(f0, cfg, lambda v: ~np.isnan(v))
        if rng is not None:
            f0 = tracker(x, fmin=rng[0], fmax=rng[1], viterbi_engine=viterbi_engine)
        f0 = f0.double()
        # pyin marks unvoiced with fill_na (script/calc.py:417)
        f0 = torch.where(f0 <= 0, float("nan") if cfg.pyinfill_na is None else float(cfg.pyinfill_na), f0)
    else:
        tracker = PitchTracker(cfg, sr).to(device)
        f0 = tracker(x, sinc_engine=sinc_engine)
        rng = None if cfg.minMaxQuant is None else _second_pass_range(f0, cfg, lambda v: v > 20)
        if rng is not None:
            f0 = tracker(x, sinc_engine=sinc_engine, min_pitch=rng[0], max_pitch=rng[1], method="ac")
        f0 = f0.double()
        f0 = torch.where(f0 <= 20, float("nan"), f0)  # unvoiced → NaN (script/calc.py:559)
    f0t = np.arange(f0.shape[-1]) * cfg.hopSize
    if cfg.interpUnvoiced is not None:
        if bool(torch.isnan(f0).all()):
            return f0, f0t  # fully unvoiced: nothing to interpolate
        f0 = interp_nan(f0, cfg.interpUnvoiced)
    if cfg.outFilter is not None:
        f0 = F.apply_filter(
            f0, 1.0 / cfg.hopSize, filt=cfg.outFilter, cut_off=cfg.outFiltCutOff,
            filt_len=cfg.outFiltLen, filt_type=cfg.outFiltType, poly_ord=cfg.outFiltPolyOrd,
        )
    return f0, f0t
