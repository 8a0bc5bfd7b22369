"""Multi-host scale-out for corpus sweeps.

A mesh with a leading ``slice`` axis: ("slice", "data", "time"). Corpus
extraction is independent per utterance, so the only traffic between
slices is the corpus statistics' all-reduce over ("slice", "data") and the
gather of the results; the audio never crosses a slice. At the file level a
sweep shards its manifest per process (:func:`shard_manifest`, the CLI's
``--num-shards``/``--shard-id``): each process sweeps its own files into its
own output directory.

Deployment: launch one process per GPU with PyTorch's launcher (``torchrun``
sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK), call
:func:`init_distributed` once per process, then build the mesh.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from modulation_mfcc_tpu_torch.models.config import MfccConfig
from modulation_mfcc_tpu_torch.parallel.batch import AudioBatch, _sharded_mfcc_change

__all__ = ["init_distributed", "make_multislice_mesh", "multislice_sharded_mfcc_change", "shard_manifest"]


def init_distributed(init_method: str | None = None, world_size: int | None = None, rank: int | None = None, *,
                     backend: str | None = None) -> bool:
    """Join the default process group. The arguments default from PyTorch's
    launcher environment (MASTER_ADDR/MASTER_PORT through ``env://``,
    WORLD_SIZE, RANK, LOCAL_RANK); the backend is NCCL where CUDA is
    available, with this process on ``cuda:LOCAL_RANK``, else gloo.

    Returns True when a process group is initialized, False for a single
    process started without that environment (no MASTER_ADDR and no
    ``init_method``): callers take the same code path either way."""
    if dist.is_initialized():
        return True
    if init_method is None and "MASTER_ADDR" not in os.environ:
        return False
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
                            timeout=timedelta(minutes=10))
    return True


def make_multislice_mesh(n_slice: int, n_data: int | None = None, n_time: int = 1, *,
                         device_type: str = "cuda") -> DeviceMesh:
    """A ("slice", "data", "time") mesh over every rank of the default
    process group; ranks are numbered slice-major, so a slice is a block of
    consecutive ranks (one host's GPUs under torchrun)."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // (n_slice * n_time)
    if n_slice * n_data * n_time != world:
        raise ValueError(f"mesh {n_slice}x{n_data}x{n_time} does not cover the world of {world} ranks")
    return init_device_mesh(device_type, (n_slice, n_data, n_time), mesh_dim_names=("slice", "data", "time"))


def multislice_sharded_mfcc_change(batch: AudioBatch, cfg: MfccConfig, mesh: DeviceMesh, *,
                                   spectrum: str = "fused", masked_fir: bool = False):
    """(tot [B, NF], mask [B, NF], corpus mean) with the batch's rows split
    over ("slice", "data") jointly; as :func:`parallel.batch.sharded_mfcc_change`
    otherwise. The corpus mean's sums are all-reduced over both axes."""
    return _sharded_mfcc_change(batch, cfg, mesh, ("slice", "data"), spectrum=spectrum, masked_fir=masked_fir)


def shard_manifest(paths: list[str], n_shards: int, shard_id: int) -> list[str]:
    """Deterministic file-level sharding for multi-process sweeps: process
    ``shard_id`` of ``n_shards`` takes every n-th file (round-robin keeps
    per-shard duration balanced for roughly-sorted corpora)."""
    if not (0 <= shard_id < n_shards):
        raise ValueError(f"shard_id {shard_id} not in [0, {n_shards})")
    return paths[shard_id::n_shards]
