"""Long-form extraction: the MFCC stage of an hour-scale recording in chunks.

The reference loads whole recordings and filters them in one bidirectional
pass (script/mfcc.py:373, sosfiltfilt). A whole-file MFCC stage at 1 h
holds every frame's spectrum at once; here the *sample* axis, where the
memory and the operations are, is cut into chunks of frames, while the
trajectory-rate (1/tStep Hz) stages run once over the whole [n_mfcc, NF]
trajectory, about a thousand times smaller than the audio:

  * :func:`chunked_mfcc_trajectories` frames one chunk of the padded signal
    at a time (a strided view, no frame matrix of the whole file) and
    computes its mel power with the fft spectrum. MFCC frames depend only on
    their own window, so chunking changes no number; the per-utterance
    top_db clip needs the global mel peak, reduced over the chunks first.
  * :func:`chunked_mfcc_change` runs the model's trajectory tail
    (``MfccChange.trajectory_tail``) on the result, so chunked and
    whole-file results are equal to rounding.
  * :func:`sharded_longform_mfcc_change` splits the sample axis over the
    ranks of a mesh's "time" axis (torch.distributed): each rank frames its
    shard extended by halos from its neighbours (one all_gather of the small
    halo slices), computes its frames' mel with ``fused_mel_f32``, takes the
    global peak with one all-reduce MAX, runs ``mfcc_tail_f32`` and
    all-gathers the [frames, n_mfcc] trajectory, whose tail every rank then
    computes whole. The per-shard step is two plain functions,
    :func:`shard_mel` and :func:`shard_mfcc`, of (extended shard, shard id,
    number of shards), so one device can run the shards in turn.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as tnf

from modulation_mfcc_tpu_torch.kernels.fused_frontend import fused_mel_frontend, hop_rows_geometry, mfcc_tail
from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import _model
from modulation_mfcc_tpu_torch.ops.framing import frame_by_slices
from modulation_mfcc_tpu_torch.ops.spectral import dct_matrix, melspectrogram
from modulation_mfcc_tpu_torch.parallel.mesh import DeviceMesh, all_reduce, axis_index, axis_size, gather_rows

__all__ = ["chunked_mfcc_trajectories", "chunked_mfcc_change", "sharded_longform_mfcc_change", "LongformShards",
           "longform_shards", "extended_shard", "shard_mel", "shard_mfcc"]


def _chunk_frame_windows(n_samples: int, cfg: MfccConfig, frames_per_chunk: int) -> tuple[int, int, int, int]:
    """(nf, n_chunks, samples a chunk's frames span, centered pad)."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    pad = n_fft // 2
    nf = 1 + (n_samples + 2 * pad - n_fft) // hop
    n_chunks = -(-nf // frames_per_chunk)
    window = (frames_per_chunk - 1) * hop + n_fft
    return nf, n_chunks, window, pad


def chunked_mfcc_trajectories(
    y: torch.Tensor, cfg: MfccConfig, *, frames_per_chunk: int = 4096,
    mel_stack_cap_bytes: int = 512 * 1024 * 1024,
) -> torch.Tensor:
    """MFCCs [NF, n_mfcc] of a long 1-D signal, ``frames_per_chunk`` frames
    at a time, on ``y``'s device and in its dtype.

    Two schedules with the same numbers, chosen by size: when the stacked
    mel of the whole file fits in ``mel_stack_cap_bytes`` (the 1-hour
    16 kHz recording: 369 MB), one pass keeps each chunk's mel and the
    running peak, then clips and projects every chunk; above the cap, a
    first pass finds the peak and a second recomputes each chunk's mel, so
    one chunk of mel is live at a time. Each chunk's dB, clip and DCT are
    the same operations in both.
    """
    n = y.shape[-1]
    nf, n_chunks, window, pad = _chunk_frame_windows(n, cfg, frames_per_chunk)
    hop = cfg.hop_length
    ypad = tnf.pad(y, (pad, max(0, (n_chunks - 1) * frames_per_chunk * hop + window - n - pad)))
    d = torch.as_tensor(dct_matrix(cfg.n_mfcc, cfg.n_mels).T, dtype=y.dtype, device=y.device)

    def mel_of_chunk(c: int) -> torch.Tensor:
        frames = frame_by_slices(ypad, c * frames_per_chunk * hop, frames_per_chunk, cfg.n_fft, hop)
        return melspectrogram(frames, sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, n_mels=cfg.n_mels,
                              fmin=cfg.minFreq, fmax=cfg.maxFreq, win_length=cfg.win_length)

    def chunk_peak(c: int, mel: torch.Tensor) -> torch.Tensor:
        valid = nf - c * frames_per_chunk  # frames of this chunk below nf
        return torch.amax(mel[:valid])

    def mfcc_of_chunk(mel: torch.Tensor, log_peak: torch.Tensor) -> torch.Tensor:
        db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
        return torch.maximum(db, log_peak - 80.0) @ d

    stacked = n_chunks * frames_per_chunk * cfg.n_mels * y.element_size() <= mel_stack_cap_bytes
    peak = torch.zeros((), dtype=y.dtype, device=y.device)
    mels = []
    for c in range(n_chunks):
        mel = mel_of_chunk(c)
        peak = torch.maximum(peak, chunk_peak(c, mel))
        if stacked:
            mels.append(mel)
    log_peak = 10.0 * torch.log10(torch.clamp(peak, min=1e-10))
    out = [mfcc_of_chunk(mels[c] if stacked else mel_of_chunk(c), log_peak) for c in range(n_chunks)]
    return torch.cat(out)[:nf]


def _trajectory_postprocess(m: torch.Tensor, cfg: MfccConfig) -> torch.Tensor:
    """The trajectory-rate tail of the modulation pipeline over frame-major
    MFCCs [..., NF, n_mfcc] (script/mfcc.py:393-425): the whole-file path's
    own ``MfccChange.trajectory_tail``."""
    return _model(cfg, m.device).trajectory_tail(m.transpose(-1, -2))


def chunked_mfcc_change(
    y: torch.Tensor, cfg: MfccConfig, *, frames_per_chunk: int = 4096,
    mel_stack_cap_bytes: int = 512 * 1024 * 1024,
) -> torch.Tensor:
    """Long-form modulation cepstrum [NF] of a 1-D signal: the chunked MFCC
    stage, then the exact trajectory tail (it never needs chunking)."""
    m = chunked_mfcc_trajectories(
        y, cfg, frames_per_chunk=frames_per_chunk, mel_stack_cap_bytes=mel_stack_cap_bytes,
    )
    return _trajectory_postprocess(m, cfg)


class LongformShards(NamedTuple):
    """Geometry of a signal of ``t_true`` samples split over ``n_t`` shards
    (JAX ``sharded_longform_mfcc_change``'s arithmetic): the signal is
    zero-padded to ``t`` = n_t·shard_len samples; shard i owns frames
    [i·fps, (i+1)·fps) of the nf_total centered frames and samples
    [i·shard_len, (i+1)·shard_len); its extended shard adds ``pad`` samples
    from the left neighbour and ``halo_r`` from the right one."""

    t_true: int
    n_t: int
    t: int
    shard_len: int
    nf_total: int
    fps: int
    pad: int
    halo_r: int


def longform_shards(t_true: int, cfg: MfccConfig, n_t: int) -> LongformShards:
    hop, n_fft = cfg.hop_length, cfg.n_fft
    pad = n_fft // 2
    nf_total = 1 + t_true // hop
    fps = -(-nf_total // n_t)
    t = -(-t_true // n_t) * n_t
    shard_len = t // n_t
    # the right overhang of a shard's frame windows grows with the shard
    # index (frames are owned by count, samples by count), largest at the last
    max_off = (n_t - 1) * (fps * hop - shard_len)
    halo_r = max(0, max_off + (fps - 1) * hop + n_fft - shard_len)
    halo_r = min(max(halo_r, hop), shard_len)
    if shard_len < pad:
        raise ValueError(f"{t_true} samples over {n_t} shards: a shard ({shard_len}) is shorter than n_fft/2")
    return LongformShards(t_true, n_t, t, shard_len, nf_total, fps, pad, halo_r)


def extended_shard(y: torch.Tensor, shard_id: int, g: LongformShards) -> torch.Tensor:
    """Shard ``shard_id`` of the whole signal ``y`` [t_true] with its halos,
    sliced from ``y`` (wrapping around at the ends, as the exchange does):
    global samples [start − pad, start + shard_len + halo_r)."""
    y = tnf.pad(y, (0, g.t - g.t_true))
    idx = (shard_id * g.shard_len - g.pad + torch.arange(g.pad + g.shard_len + g.halo_r, device=y.device)) % g.t
    return y[idx]


def shard_mel(ext: torch.Tensor, shard_id: int, n_t: int, t_true: int,
              cfg: MfccConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(mel [1, n, n_mels], the largest mel power of the shard's valid frames)
    of shard ``shard_id``'s own frames from its extended shard ``ext`` (see
    :func:`extended_shard`): the frames of global index < nf_total, n =
    their count (at least 1; a shard past the last frame gives peak 0).

    The frames go through ``fused_mel_frontend`` (``fused_mel_f32`` on CUDA,
    its plain version on the CPU) as hop rows whose first row starts at the
    shard's first frame, with ``n_samples`` set so the kernel computes
    exactly these frames; samples outside [0, t_true) are zero, as centered
    framing's zero extension. The peak is the max of the kernel's block
    maxima, which cover only these frames."""
    g = longform_shards(t_true, cfg, n_t)
    hop = cfg.hop_length
    first = shard_id * g.fps
    n_valid = min(g.fps, g.nf_total - first)
    n = max(n_valid, 1)
    weights = _model(cfg, ext.device).frontend_weights("f32")
    rows_total, left = hop_rows_geometry((n - 1) * hop, n_fft=cfg.n_fft, hop=hop, win_length=cfg.win_length)
    g0 = first * hop - left  # global sample of the rows' first sample
    lo = g0 - (shard_id * g.shard_len - g.pad)  # ... and its index in ext
    # the samples the frames read (each frame k = the window's trimmed support), inside [0, t_true)
    a, b = max(0, -g0), min((n - 1) * hop + weights["wri"].shape[-2], t_true - g0)
    if lo + b > ext.shape[-1]:
        raise ValueError(f"shard {shard_id}: its frames reach past its right halo ({g.halo_r} samples)")
    buf = torch.zeros(rows_total * hop, dtype=ext.dtype, device=ext.device)
    if b > a:
        buf[a:b] = ext[lo + a : lo + b]
    mel, bmax = fused_mel_frontend(
        buf.reshape(1, rows_total, hop), sr=cfg.signal_sample_rate, n_fft=cfg.n_fft, hop=hop,
        win_length=cfg.win_length, n_mels=cfg.n_mels, fmin=cfg.minFreq, fmax=cfg.maxFreq, algorithm="f32",
        n_samples=(n - 1) * hop, weights=weights,
    )
    peak = torch.amax(bmax) if n_valid > 0 else torch.zeros((), dtype=mel.dtype, device=mel.device)
    return mel, peak


def shard_mfcc(mel: torch.Tensor, peak: torch.Tensor, shard_id: int, n_t: int, t_true: int,
               cfg: MfccConfig) -> torch.Tensor:
    """MFCCs [fps, n_mfcc] of a shard's frames from :func:`shard_mel`'s mel
    and the global peak mel power (``mfcc_tail_f32`` on CUDA, the top_db
    clip at the global peak), zero past the last frame."""
    g = longform_shards(t_true, cfg, n_t)
    n_valid = max(0, min(g.fps, g.nf_total - shard_id * g.fps))
    peak_db = 10.0 * torch.log10(torch.clamp(peak.reshape(1), min=1e-10))
    m = mfcc_tail(mel, peak_db, cfg.n_mfcc, dct=_model(cfg, mel.device).dct)[0, :n_valid]
    return tnf.pad(m, (0, 0, 0, g.fps - n_valid))


def sharded_longform_mfcc_change(y: torch.Tensor, cfg: MfccConfig, mesh: DeviceMesh) -> torch.Tensor:
    """Time-sharded long-form modulation cepstrum [NF] of a 1-D signal over
    the mesh's "time" axis (sequence parallelism with halos).

    Every rank passes the whole signal on its own device and returns the
    whole result. Rank i of the axis takes shard i (:func:`longform_shards`),
    and one all_gather of each shard's first ``halo_r`` and last ``pad``
    samples gives it its neighbours' halos (at any axis size, 1 included;
    the wrapped-around halos of the end shards are masked). Then
    :func:`shard_mel`, an all-reduce MAX of the peak, :func:`shard_mfcc`, an
    all_gather of the [fps, n_mfcc] trajectories and the trajectory tail on
    the whole [NF, n_mfcc]."""
    n_t, r = axis_size(mesh, ("time",)), axis_index(mesh, ("time",))
    g = longform_shards(y.shape[-1], cfg, n_t)
    shard = tnf.pad(y, (0, g.t - g.t_true))[r * g.shard_len : (r + 1) * g.shard_len]
    edges = gather_rows(torch.cat([shard[: g.halo_r], shard[-g.pad :]])[None], mesh, ("time",))
    ext = torch.cat([edges[(r - 1) % n_t, g.halo_r :], shard, edges[(r + 1) % n_t, : g.halo_r]])
    mel, peak = shard_mel(ext, r, n_t, g.t_true, cfg)
    all_reduce(peak, mesh, ("time",), dist.ReduceOp.MAX)
    m = shard_mfcc(mel, peak, r, n_t, g.t_true, cfg)
    return _trajectory_postprocess(gather_rows(m, mesh, ("time",))[: g.nf_total], cfg)
