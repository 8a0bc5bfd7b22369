"""Padded batches of variable-length audio and the batched modulation
cepstrum: one padded [B, T] batch (or hop rows [B, rows, hop], the corpus
sweep's upload format) in, each utterance's result on its valid frames out,
equal to its single-file result there; :func:`sharded_mfcc_change` splits
the batch's rows over the ranks of a mesh (torch.distributed)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.models.modulation import mfcc_change
from modulation_mfcc_tpu_torch.ops.framing import n_frames_centered
from modulation_mfcc_tpu_torch.parallel.mesh import DeviceMesh, all_reduce, axis_index, axis_size, gather_rows, shard_rows
from modulation_mfcc_tpu_torch.utils import obs
from modulation_mfcc_tpu_torch.utils.helpers import dequantize_samples, resolve_device, round_up_to_multiple

__all__ = ["AudioBatch", "pad_batch", "dequantize_samples", "frame_validity_mask", "batched_mfcc_change",
           "sharded_mfcc_change"]


@dataclass
class AudioBatch:
    """A padded batch of utterances: samples [B, T_pad] (or hop rows
    [B, rows, hop]), lengths [B]."""

    samples: torch.Tensor
    lengths: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.samples.shape[0]


def pad_batch(signals: list[np.ndarray], *, bucket_multiple: int = 2048, dtype=np.float32,
              device=None) -> AudioBatch:
    """Zero-pad 1-D signals to a shared length, a multiple of
    ``bucket_multiple``, on ``device`` (default CUDA; ``device="cpu"`` for
    the CPU)."""
    device = resolve_device(device)
    lengths = np.array([len(s) for s in signals], dtype=np.int64)
    t_pad = round_up_to_multiple(int(lengths.max()), bucket_multiple)
    out = np.zeros((len(signals), t_pad), dtype=dtype)
    for i, s in enumerate(signals):
        out[i, : len(s)] = s
    return AudioBatch(torch.as_tensor(out, device=device), torch.as_tensor(lengths, device=device))


def frame_validity_mask(lengths: torch.Tensor, t_pad: int, cfg: MfccConfig) -> torch.Tensor:
    """[B, n_frames] 1.0 where the frame index is a real frame of the
    unpadded signal (librosa frame count: 1 + len//hop for centered STFT)."""
    nf_pad = n_frames_centered(t_pad, cfg.n_fft, cfg.hop_length)
    nf_real = 1 + lengths // cfg.hop_length
    fidx = torch.arange(nf_pad, device=lengths.device)[None, :]
    return (fidx < nf_real[:, None]).to(torch.float32)


def batched_mfcc_change(
    batch: AudioBatch,
    cfg: MfccConfig,
    *,
    spectrum: str = "fused",
    uniform_lengths: bool = False,
    masked_fir: bool = False,
    n_samples: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked batched modulation cepstrum: (tot_change [B, NF], frame_mask
    [B, NF]), each utterance equal to its single-file result on its valid
    frames (the filter and gradient edges are anchored at each length,
    ops/masked.py).

    ``masked_fir=True`` takes the FIR-operator filters, valid when every
    utterance has at least ``min_frames_for_fir`` frames; ``False`` the scan
    filters, for any length. ``uniform_lengths=True`` asserts that every
    utterance fills the batch and skips the masked edges.

    Samples are float32 or int16 (dequantized as v·2⁻¹⁵, exact). 3-D
    samples are hop rows [B, rows, hop] (``n_samples`` = the batch's padded
    sample count then required; fused spectra only): int16 rows go straight
    into the fused kernel, which dequantizes while it stages them.
    """
    with obs.span("batched_mfcc_change") as sp:
        if sp:
            sp.set(batch=batch.samples.shape[0], layout="hop_rows" if batch.samples.ndim == 3 else "flat",
                   dtype=str(batch.samples.dtype).removeprefix("torch."),
                   route="uniform" if uniform_lengths else "masked_fir" if masked_fir else "scan")
        if batch.samples.ndim == 3:
            if n_samples is None:
                raise ValueError("hop-rows batch requires n_samples")
            samples = batch.samples
            t_pad = int(n_samples)
        else:
            samples = batch.samples if spectrum.startswith("fused") else dequantize_samples(batch.samples)
            t_pad = samples.shape[-1]
            n_samples = None
        lengths = torch.as_tensor(batch.lengths, device=samples.device)
        with obs.span("frame_mask"):
            mask = frame_validity_mask(lengths, t_pad, cfg)
        if uniform_lengths:
            return mfcc_change(samples, cfg, spectrum=spectrum, n_samples=n_samples), mask
        nf_real = 1 + lengths // cfg.hop_length
        tot = mfcc_change(
            samples, cfg, frame_lengths=nf_real, spectrum=spectrum, masked_fir=masked_fir, n_samples=n_samples,
        )
        return tot, mask


def sharded_mfcc_change(
    batch: AudioBatch, cfg: MfccConfig, mesh: DeviceMesh, *, spectrum: str = "fused", masked_fir: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Data-parallel :func:`batched_mfcc_change` over the mesh's "data" axis:
    (tot [B, NF], mask [B, NF], corpus mean change over valid frames).

    Every rank passes the whole batch, on its own device (``cuda:LOCAL_RANK``
    under NCCL, the CPU under gloo), and computes its block of rows; ``tot``
    and ``mask`` are all-gathered, so every rank returns the whole batch,
    and the mean's two sums (Σ tot·mask, Σ mask, float64) are one all-reduce.
    A batch whose size the axis does not divide is padded with copies of its
    last row to ceil(B / n_data) rows a rank; their results are cut off and
    enter no sum."""
    return _sharded_mfcc_change(batch, cfg, mesh, ("data",), spectrum=spectrum, masked_fir=masked_fir)


def _sharded_mfcc_change(batch: AudioBatch, cfg: MfccConfig, mesh: DeviceMesh, dims: tuple[str, ...], *,
                         spectrum: str, masked_fir: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if batch.samples.ndim != 2:
        raise ValueError("sharded_mfcc_change takes flat [B, T] samples")
    n_blocks, block = axis_size(mesh, dims), axis_index(mesh, dims)
    b = batch.batch_size
    per = -(-b // n_blocks)
    lengths = torch.as_tensor(batch.lengths, device=batch.samples.device)
    local = AudioBatch(shard_rows(batch.samples, n_blocks, block), shard_rows(lengths, n_blocks, block))
    tot, mask = batched_mfcc_change(local, cfg, spectrum=spectrum, masked_fir=masked_fir)
    real = (block * per + torch.arange(per, device=tot.device) < b).to(tot.dtype)[:, None]
    sums = torch.stack([(tot.double() * mask * real).sum(), (mask.double() * real).sum()])
    all_reduce(sums, mesh, dims, dist.ReduceOp.SUM)
    mean = (sums[0] / torch.clamp(sums[1], min=1.0)).to(tot.dtype)
    return gather_rows(tot, mesh, dims)[:b], gather_rows(mask, mesh, dims)[:b], mean
