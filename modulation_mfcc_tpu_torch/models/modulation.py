"""MFCC rate-of-change ("modulation cepstrum"), the flagship pipeline.

PyTorch port of the reference's ``get_MFCCS_change`` (script/mfcc.py:291-427,
Goldstein-2019 formulation):

    audio → centered frames → (window·DFT → power → mel → dB → DCT) → drop C0
          → per-coefficient zero-phase Butterworth low-pass (12 Hz default)
          → time derivative (np.gradient, or Savitzky-Golay with
            ``diffMethod='sg'``) → sqrt(Σ_coef d²)/n_coef
          → final filter (the low-pass, or the 'iir', 'fir' or 'sg' out-filter)

The MFCC stage runs through the fused CUDA kernels by default
(``spectrum='fused'``, the counterpart of the JAX package's 'pallas' f32
mode; 'fused_bf16', 'fused_x3', 'fused_i16' and 'fused_i24' are its
'pallas_bf16', 'pallas_x3', 'pallas_i16' and 'pallas_i24' modes); 'fft'
and 'matmul' are the plain torch spectra. The fused spectra also take int16
audio and hop rows [B, rows, hop] with ``n_samples`` (the corpus sweep's
upload format). The trajectory stage is the probed FIR operator as
matmuls, or for padded batches the length-masked filters; it runs in
float32 in every mode (the JAX package's bf16 filter precision is a TPU
speed choice). :class:`MfccChange` holds every designed constant as a
buffer and moves with ``.to(device)``; the functional entry points use one
per configuration and device.

:func:`modulation_spectrum` is the second-stage STFT over the MFCC
trajectories (BASELINE config #3); recordings of at least
``longform_threshold`` samples stream through
``parallel/streaming.chunked_mfcc_change`` (config #4).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.signal as sps
import torch

from modulation_mfcc_tpu_torch.kernels.fused_frontend import fused_mfcc, kernel_layouts, mode_weights, tail_dct
from modulation_mfcc_tpu_torch.kernels.masked_scan import masked_grad_norm, masked_sosfiltfilt_f64
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.ops import filters as F
from modulation_mfcc_tpu_torch.ops.derivatives import np_gradient
from modulation_mfcc_tpu_torch.ops.framing import frame_signal, frame_times_mfcc, n_frames_centered
from modulation_mfcc_tpu_torch.ops.masked import (
    masked_filtfilt,
    masked_savgol,
    masked_sosfiltfilt_fir,
)
from modulation_mfcc_tpu_torch.ops.savgol import savgol_filter
from modulation_mfcc_tpu_torch.ops.spectral import analysis_window, mfcc_from_frames, power_spectrum_fft
from modulation_mfcc_tpu_torch.utils import obs
from modulation_mfcc_tpu_torch.utils.helpers import resolve_device

__all__ = [
    "MfccChange", "mfcc_trajectories", "mfcc_change", "change_times",
    "min_frames_for_fir", "extract_mfcc_change", "extract_mfcc_matrix",
    "modulation_spectrum", "modulation_spectrum_axes",
]

# fused spectrum → frontend algorithm (kernels/fused_frontend.py)
FUSED = {"fused": "f32", "fused_bf16": "bf16", "fused_x3": "x3", "fused_i16": "i16", "fused_i24": "i24"}
SPECTRA = (*FUSED, "fft", "matmul")


def _traj_design(cfg: MfccConfig) -> tuple:
    """(sos, zi, padlen) of the coefficient-trajectory low-pass."""
    cut_norm = cfg.filtCutoff / ((1.0 / cfg.tStep) / 2.0)
    return F.design_butter_sos(cfg.filtOrd, (cut_norm,), "lowpass")


def _out_design(cfg: MfccConfig) -> tuple[str, tuple | None]:
    """The validated final filter: ('iir', (sos, zi, padlen)) for the
    trajectory low-pass (``outFilter`` None) or the 'iir' out-filter,
    ('fir', (b, zi, padlen)) for the Kaiser FIR, or ('sg', None)."""
    fs = 1.0 / cfg.tStep
    if cfg.outFilter is None:
        return "iir", _traj_design(cfg)
    if cfg.outFilter == "iir":
        return "iir", F.iir_design(fs, cfg.outFiltCutOff, cfg.outFiltLen, cfg.outFiltType)
    if cfg.outFilter == "fir":
        return "fir", F.fir_design(fs, cfg.outFiltCutOff, cfg.outFiltLen, cfg.outFiltType)
    if cfg.outFilter == "sg":
        F.validated_cutoffs(fs, "sg", cfg.outFiltCutOff, cfg.outFiltType)
        return "sg", None
    raise ValueError(f"Unknown outFilter {cfg.outFilter!r}")


class MfccChange(torch.nn.Module):
    """The flagship pipeline with its designed constants as buffers:

    * ``wri`` [K, 2·bins_pad], ``melw`` [bins_pad, n_mels]: packed windowed
      real-DFT bases and mel matrix of the fused frontend (f32 mode); the
      other modes' constants (kernels/fused_frontend.mode_weights), and what
      each mode's CUDA kernel reads at this geometry (kernel_layouts: the
      tensor-core layouts, or for 'f32' where fft_ok takes the geometry the
      FFT kernel's constants ``f32_fft_tab``, ``f32_fft_bands``,
      ``f32_fft_w``), ride along as non-persistent buffers
      ``<mode>_<name>``;
    * ``dct`` [n_mels, n_mfcc]: DCT-II ortho of the MFCC tail;
    * ``traj_filter`` / ``out_filter``: the two zero-phase Butterworth
      filters, each with its probed FIR operator (``kernel``, ``left``,
      ``right``); ``out_filter`` is None for the 'fir' out-filter, whose
      taps are ``out_fir`` = (b, zi, padlen), and for 'sg'.
    """

    def __init__(self, cfg: MfccConfig = MfccConfig()):
        super().__init__()
        self.cfg = cfg
        design = (cfg.signal_sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels, cfg.minFreq, cfg.maxFreq)
        for alg in FUSED.values():
            for name, arr in mode_weights(alg, *design).items():
                if alg == "f32":
                    self.register_buffer(name, torch.tensor(arr))
                else:
                    self.register_buffer(f"{alg}_{name}", torch.tensor(arr), persistent=False)
            for name, t in kernel_layouts(alg, self.frontend_weights(alg), cfg.hop_length, *design).items():
                self.register_buffer(f"{alg}_{name}", t, persistent=False)
        self.register_buffer("dct", torch.tensor(tail_dct(cfg.n_mfcc, cfg.n_mels)))
        self.traj_filter = F.FiltFilt(*_traj_design(cfg))
        self.out_kind, out = _out_design(cfg)
        self.out_filter = F.FiltFilt(*out) if self.out_kind == "iir" else None
        self.out_fir = out if self.out_kind == "fir" else None

    def frontend_weights(self, algorithm: str) -> dict[str, torch.Tensor]:
        """The buffers of one frontend mode, keyed as mode_weights keys them."""
        prefix = f"{algorithm}_"
        own = {k[len(prefix):]: v for k, v in self.named_buffers() if k.startswith(prefix)}
        return {"wri": self.wri, "melw": self.melw} | own if algorithm == "f32" else own

    def trajectories(
        self,
        y: torch.Tensor,
        *,
        frame_mask: torch.Tensor | None = None,
        spectrum: str = "fused",
        coef_major: bool = False,
        n_samples: int | None = None,
    ) -> torch.Tensor:
        """MFCC matrix [..., n_frames, n_mfcc] (librosa semantics), or
        [..., n_mfcc, n_frames] with ``coef_major=True``. ``frame_mask``
        [..., n_frames] (1 = valid) keeps padding out of the top_db peak.
        The fused spectra also take int16 audio and hop rows [B, rows, hop]
        with ``n_samples``."""
        cfg = self.cfg
        if spectrum not in SPECTRA:
            raise ValueError(f"Unknown spectrum {spectrum!r}; one of {', '.join(SPECTRA)}")
        with obs.span("frontend") as sp:
            if sp:
                sp.set(algorithm=FUSED.get(spectrum, spectrum))
            if spectrum in FUSED:
                alg = FUSED[spectrum]
                return fused_mfcc(
                    y, sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, hop=cfg.hop_length,
                    win_length=cfg.win_length, n_mels=cfg.n_mels, frame_mask=frame_mask,
                    transposed=coef_major, algorithm=alg, n_samples=n_samples,
                    weights=self.frontend_weights(alg), dct=self.dct,
                )
            if y.ndim == 3 or not y.is_floating_point():
                raise ValueError("hop rows and int16 audio need a fused spectrum; fft/matmul take float [..., T]")
            m = mfcc_from_frames(
                frame_signal(y, cfg.n_fft, cfg.hop_length),
                sr=cfg.signal_sample_rate,
                n_fft=cfg.n_fft,
                n_mfcc=cfg.n_mfcc,
                n_mels=cfg.n_mels,
                fmin=cfg.minFreq,
                fmax=cfg.maxFreq,
                win_length=cfg.win_length,
                use_fft=(spectrum == "fft"),
                mask=None if frame_mask is None else frame_mask[..., :, None],
            )
            return m.transpose(-1, -2) if coef_major else m

    def forward(
        self,
        y: torch.Tensor,
        *,
        frame_mask: torch.Tensor | None = None,
        frame_lengths: torch.Tensor | None = None,
        spectrum: str = "fused",
        masked_fir: bool = False,
        n_samples: int | None = None,
    ) -> torch.Tensor:
        """Total MFCC change over time, [..., n_frames], of audio [..., T]
        (or hop rows [B, rows, hop] with ``n_samples``).

        For padded batches [B, T] pass ``frame_lengths`` [B] (valid frames per
        utterance): the top_db peak, filter edges and gradient edges are then
        anchored at each utterance's length, so each output equals its
        single-file result on valid frames (zeros beyond). ``masked_fir=True``
        takes the FIR-operator forms of the Butterworth filters, which need
        every length to be at least :func:`min_frames_for_fir`; ``False``
        the scan filters, which take any length. The 'fir' and 'sg'
        out-filters have one masked form each, used either way.

        ``frame_mask`` [..., n_frames] (1 = valid) sets the frames whose mel
        power the top_db peak is taken over, as in :meth:`trajectories`;
        without ``frame_lengths`` the filters then run unmasked over every
        frame. Given ``frame_lengths`` and no ``frame_mask``, the mask is
        derived from the lengths.
        """
        cfg = self.cfg
        if frame_mask is not None:
            frame_mask = torch.as_tensor(frame_mask, device=y.device)
        if frame_lengths is not None:
            if masked_fir and (self.traj_filter.min_len is None
                               or (self.out_filter is not None and self.out_filter.min_len is None)):
                raise ValueError("masked_fir=True needs FIR operators for the Butterworth filters")
            frame_lengths = torch.as_tensor(frame_lengths, device=y.device)
            if frame_mask is None:
                t = int(n_samples) if y.ndim == 3 else y.shape[-1]
                nf = n_frames_centered(t, cfg.n_fft, cfg.hop_length)
                frame_mask = (
                    torch.arange(nf, device=y.device)[None, :] < frame_lengths[:, None]
                ).to(torch.float32)
        # coef-major trajectories, so the filters run along the last (time) axis
        m = self.trajectories(y, frame_mask=frame_mask, spectrum=spectrum, coef_major=True, n_samples=n_samples)
        return self.trajectory_tail(m, frame_lengths=frame_lengths, masked_fir=masked_fir)

    def trajectory_tail(
        self, m: torch.Tensor, *, frame_lengths: torch.Tensor | None = None, masked_fir: bool = False
    ) -> torch.Tensor:
        """The trajectory-rate tail (script/mfcc.py:393-425) over coef-major
        MFCCs [..., n_mfcc, NF]: drop C0, low-pass, derivative, √Σd²/n_coef,
        final filter; with ``frame_lengths`` [B] the length-masked forms
        (see :meth:`forward`)."""
        cfg = self.cfg
        with obs.span("trajectory"):
            if cfg.removeFirst:
                m = m[..., 1:, :]
            n_coef = m.shape[-2]
            lengths = None if frame_lengths is None else frame_lengths[:, None]
            with obs.span("trajectory.filter"):
                if lengths is None:
                    filt = self.traj_filter(m)
                else:
                    filt = self._masked_filter(self.traj_filter, m, frame_lengths, masked_fir,
                                               "trajectory.filter.scan")
            with obs.span("trajectory.diff"):
                if lengths is not None and cfg.diffMethod == "grad":
                    tot = masked_grad_norm(filt, frame_lengths)  # both masked routes: one kernel on CUDA
                else:
                    if lengths is None:
                        diff = np_gradient(filt) if cfg.diffMethod == "grad" else savgol_filter(filt, 3, 2, deriv=1)
                    else:
                        diff = masked_savgol(filt, 3, 2, lengths, deriv=1)
                    tot = torch.sqrt(torch.sum(diff * diff, dim=-2)) / n_coef
            with obs.span("trajectory.out"):
                return self._out_filter(tot, frame_lengths, masked_fir)

    def _out_filter(self, tot: torch.Tensor, frame_lengths: torch.Tensor | None, masked_fir: bool) -> torch.Tensor:
        """The final filter over tot [..., NF], length-masked with ``frame_lengths``."""
        cfg = self.cfg
        if frame_lengths is None:
            if self.out_kind == "iir":
                return self.out_filter(tot)
            if self.out_kind == "fir":
                return F.filtfilt(*self.out_fir, tot)
            return savgol_filter(tot, cfg.outFiltLen, cfg.outFiltPolyOrd, deriv=0)
        if self.out_kind == "iir":
            return self._masked_filter(self.out_filter, tot, frame_lengths, masked_fir, "trajectory.out.scan")
        if self.out_kind == "fir":
            return masked_filtfilt(*self.out_fir, tot, frame_lengths)
        return masked_savgol(tot, cfg.outFiltLen, cfg.outFiltPolyOrd, frame_lengths, deriv=0)

    @staticmethod
    def _masked_filter(filt: F.FiltFilt, x: torch.Tensor, frame_lengths: torch.Tensor, fir: bool,
                       scan_span: str) -> torch.Tensor:
        """The Butterworth ``filt`` over x [B, T] or [B, C, T], each
        utterance's edges at its ``frame_lengths`` [B]: the FIR operator
        with ``fir``, else the scan in float64 (kernels/masked_scan: the CUDA
        kernel on the card, the plain per-sample loop on the CPU) inside the
        span ``scan_span``."""
        if fir:
            return masked_sosfiltfilt_fir(filt, x, frame_lengths[:, None] if x.ndim == 3 else frame_lengths)
        with obs.span(scan_span) as sp:
            if sp:
                sp.set(rows=x.shape[0] * (x.shape[1] if x.ndim == 3 else 1), frames=x.shape[-1],
                       route="kernel" if x.is_cuda else "loop")
            return masked_sosfiltfilt_f64(filt.sos, filt.zi, filt.padlen, x, frame_lengths)


@lru_cache(maxsize=8)
def _model(cfg: MfccConfig, device: torch.device) -> MfccChange:
    """One :class:`MfccChange` per configuration and device."""
    with obs.setup_span("setup.model"):
        return MfccChange(cfg).to(device)


def mfcc_trajectories(
    y: torch.Tensor,
    cfg: MfccConfig,
    *,
    frame_mask: torch.Tensor | None = None,
    spectrum: str = "fused",
    coef_major: bool = False,
    n_samples: int | None = None,
) -> torch.Tensor:
    """MFCC matrix [..., n_frames, n_mfcc] of audio [..., T] (see
    :meth:`MfccChange.trajectories`), computed on ``y``'s device."""
    return _model(cfg, y.device).trajectories(
        y, frame_mask=frame_mask, spectrum=spectrum, coef_major=coef_major, n_samples=n_samples
    )


def mfcc_change(
    y: torch.Tensor,
    cfg: MfccConfig,
    *,
    frame_mask: torch.Tensor | None = None,
    frame_lengths: torch.Tensor | None = None,
    spectrum: str = "fused",
    masked_fir: bool = False,
    n_samples: int | None = None,
) -> torch.Tensor:
    """Total MFCC change over time, [..., n_frames] (see
    :meth:`MfccChange.forward`), computed on ``y``'s device."""
    return _model(cfg, y.device)(
        y, frame_mask=frame_mask, frame_lengths=frame_lengths, spectrum=spectrum, masked_fir=masked_fir,
        n_samples=n_samples,
    )


def change_times(n_samples: int, cfg: MfccConfig) -> np.ndarray:
    """Host-side time anchors (reference script/mfcc.py:390)."""
    nf = n_frames_centered(n_samples, cfg.n_fft, cfg.hop_length)
    return frame_times_mfcc(nf, cfg.tStep, cfg.winLen)


def min_frames_for_fir(cfg: MfccConfig) -> int | None:
    """Minimum valid frame count for the masked FIR filter path (None when
    an operator probe declined, or the out-filter has no FIR operator)."""
    sos, _, padlen = _traj_design(cfg)
    d1 = F.design_filtfilt_operator(F._key_of(sos), padlen)
    if d1 is None:
        return None
    if cfg.outFilter is None:
        return d1.min_len
    if cfg.outFilter != "iir":
        return None  # fir/sg out-filters have no FIR operator
    _, (sos2, _, padlen2) = _out_design(cfg)
    d2 = F.design_filtfilt_operator(F._key_of(sos2), padlen2)
    if d2 is None:
        return None
    return max(d1.min_len, d2.min_len)


def _host_trajectory_tail(m: np.ndarray, cfg: MfccConfig) -> np.ndarray:
    """The trajectory-rate tail on host with scipy (float64), for files too
    short for the FIR operator. Bit-identical to the scipy calls the
    reference makes (script/mfcc.py:393-425)."""
    if cfg.removeFirst:
        m = m[:, 1:]
    traj = m.T.astype(np.float64)  # [n_coef, NF]
    fs_traj = 1.0 / cfg.tStep
    cut_norm = cfg.filtCutoff / (fs_traj / 2.0)
    sos = sps.butter(cfg.filtOrd, cut_norm, btype="low", output="sos")
    filt = sps.sosfiltfilt(sos, traj)
    if cfg.diffMethod == "grad":
        diff = np.gradient(filt, axis=1)
    else:
        diff = sps.savgol_filter(filt, 3, 2, deriv=1, axis=1, mode="interp")
    tot = np.sqrt(np.sum(diff**2, axis=0)) / traj.shape[0]
    if cfg.outFilter is None:
        return sps.sosfiltfilt(sos, tot)
    if cfg.outFilter == "iir":
        ftype = F.resolve_filt_type(cfg.outFiltType)
        cut = np.asarray([c for c in cfg.outFiltCutOff if c is not None])
        wn = cut / (fs_traj / 2.0)
        sos2 = sps.butter(cfg.outFiltLen, wn if wn.size > 1 else wn[0], btype=ftype, output="sos")
        return sps.sosfiltfilt(sos2, tot)
    if cfg.outFilter == "fir":
        ftype = F.resolve_filt_type(cfg.outFiltType)
        cut = np.asarray([c for c in cfg.outFiltCutOff if c is not None])
        b = sps.firwin(cfg.outFiltLen, cut / (fs_traj / 2.0), window=("kaiser", 7.4), pass_zero=ftype)
        return sps.filtfilt(b, 1.0, tot)
    if cfg.outFilter == "sg":
        return sps.savgol_filter(tot, cfg.outFiltLen, cfg.outFiltPolyOrd, deriv=0, mode="interp")
    raise ValueError(f"Unknown outFilter {cfg.outFilter!r}")


def extract_mfcc_change(
    y,
    cfg: MfccConfig = MfccConfig(),
    *,
    spectrum: str = "fused",
    device=None,
    longform_threshold: int = 4_194_304,
):
    """User-facing: (tot_change tensor, times ndarray) for one utterance [T]
    or a batch [B, T]; the reference's Mfcc DataSource (script/main.py:726-770).

    Computes on ``device`` (default: ``y``'s own if it is a tensor, else
    CUDA; ``device="cpu"`` for the CPU). One utterance runs at its exact
    length: through the masked FIR filters when it has at least
    :func:`min_frames_for_fir` frames, else the MFCC stage on the device
    and the 200 Hz filter tail on the host with scipy (exact by
    construction). An utterance of at least ``longform_threshold`` samples
    streams through ``parallel.streaming.chunked_mfcc_change`` (its fft
    spectrum, whatever ``spectrum`` says), as the JAX package routes it.
    """
    device = resolve_device(device, y)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    if y.ndim != 1:
        return mfcc_change(y, cfg, spectrum=spectrum), change_times(y.shape[-1], cfg)
    n = y.shape[-1]
    if n >= longform_threshold:
        from modulation_mfcc_tpu_torch.parallel.streaming import chunked_mfcc_change

        return chunked_mfcc_change(y, cfg), change_times(n, cfg)
    nf_valid = 1 + n // cfg.hop_length
    t = change_times(n, cfg)
    mf = min_frames_for_fir(cfg)
    if mf is not None and nf_valid >= mf:
        fl = torch.tensor([nf_valid], device=device)
        tot = mfcc_change(y[None], cfg, frame_lengths=fl, spectrum=spectrum, masked_fir=True)
        return tot[0], t
    # the peak over the valid frames' stored mel, as the masked routes take it
    # (the bf16 mode stores a rounded mel)
    m = mfcc_trajectories(y[None], cfg, spectrum=spectrum, frame_mask=torch.ones((1, nf_valid), device=device))
    tot = _host_trajectory_tail(m[0].double().cpu().numpy(), cfg)
    return torch.tensor(np.ascontiguousarray(tot), dtype=torch.float32, device=device), t


def extract_mfcc_matrix(
    y,
    cfg: MfccConfig = MfccConfig(),
    *,
    spectrum: str = "fused",
    device=None,
):
    """(times, mfcc [NF, n_mfcc]) for one utterance (or [B, NF, n_mfcc] for
    a batch), on ``device`` as in :func:`extract_mfcc_change`. One
    utterance runs as a batch of one, its peak over its valid frames."""
    device = resolve_device(device, y)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    t = change_times(y.shape[-1], cfg)
    if y.ndim != 1:
        return t, mfcc_trajectories(y, cfg, spectrum=spectrum)
    mask = torch.ones((1, 1 + y.shape[-1] // cfg.hop_length), device=device)
    return t, mfcc_trajectories(y[None], cfg, spectrum=spectrum, frame_mask=mask)[0]


def modulation_spectrum_axes(
    n_samples: int, cfg: MfccConfig, *, mod_n_fft: int = 128, mod_hop: int = 16
) -> tuple[np.ndarray, np.ndarray]:
    """(mod_freqs [n_bins], mod_times [n_modframes]) of
    :func:`modulation_spectrum`: the modulation frequencies run to half the
    trajectory rate 1/tStep (100 Hz at the default 200 Hz)."""
    fs_traj = 1.0 / cfg.tStep
    nf = n_frames_centered(n_samples, cfg.n_fft, cfg.hop_length)
    n_mod = 1 + nf // mod_hop
    freqs = np.linspace(0.0, fs_traj / 2.0, 1 + mod_n_fft // 2)
    times = frame_times_mfcc(nf, cfg.tStep, cfg.winLen)[np.minimum(np.arange(n_mod) * mod_hop, nf - 1)]
    return freqs, times


def modulation_spectrum(
    y,
    cfg: MfccConfig,
    *,
    mod_n_fft: int = 128,
    mod_hop: int = 16,
    spectrum: str = "fused",
    device=None,
) -> torch.Tensor:
    """Modulation power spectrum [..., n_coef, n_modframes, n_modbins] of
    audio [..., T] (BASELINE config #3): each MFCC coefficient trajectory
    (sampled at 1/tStep Hz), mean removed, analysed by a second centered,
    Hann-windowed rFFT of ``mod_n_fft`` points every ``mod_hop`` frames.
    ``spectrum`` selects the MFCC stage as in :func:`mfcc_change` (the
    fused spectra run their frontend kernel and the frame-major tail
    kernel). Computes on ``device`` (default: ``y``'s own if it is a
    tensor, else CUDA)."""
    device = resolve_device(device, y)
    y = y.to(device) if torch.is_tensor(y) else torch.as_tensor(y, dtype=torch.float32, device=device)
    m = mfcc_trajectories(y, cfg, spectrum=spectrum)
    if cfg.removeFirst:
        m = m[..., 1:]
    traj = m.transpose(-1, -2)  # [..., n_coef, n_frames]
    traj = traj - torch.mean(traj, dim=-1, keepdim=True)
    frames = frame_signal(traj, mod_n_fft, mod_hop)
    return power_spectrum_fft(frames, mod_n_fft, analysis_window(mod_n_fft, "hann", mod_n_fft))
