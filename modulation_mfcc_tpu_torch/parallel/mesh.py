"""Device meshes over torch.distributed and the collectives of the sharded
paths.

Axes:
  * ``data``: utterances of a batch (corpus sweeps, ``sharded_mfcc_change``);
  * ``time``: the sample axis of a long recording
    (``sharded_longform_mfcc_change``, halo exchange);
  * ``slice`` (parallel/multislice.py): groups of hosts, leading.

One process per device, each in the default process group (NCCL on GPUs,
gloo on the CPU). A mesh names the ranks' layout; a collective over one or
more of its axes runs on each axis's subgroup in turn. Rows of a batch are
split over the given axes in row-major order of their coordinates, as a
JAX ``PartitionSpec(("slice", "data"))`` splits a global array.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "DeviceMesh", "axis_size", "axis_index", "shard_rows", "gather_rows", "all_reduce"]


def make_mesh(n_data: int | None = None, n_time: int = 1, *, device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "time") mesh over every rank of the default process group
    (initialized first, parallel/multislice.init_distributed); ``n_data``
    defaults to world_size // n_time. ``device_type``: "cuda" (NCCL) or
    "cpu" (gloo)."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_time
    if n_data * n_time != world:
        raise ValueError(f"mesh {n_data}x{n_time} does not cover the world of {world} ranks")
    return init_device_mesh(device_type, (n_data, n_time), mesh_dim_names=("data", "time"))


def axis_size(mesh: DeviceMesh, dims: tuple[str, ...]) -> int:
    """Ranks along ``dims`` jointly."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(d)) for d in dims)


def axis_index(mesh: DeviceMesh, dims: tuple[str, ...]) -> int:
    """This rank's row-major index over ``dims`` (the block of rows it owns)."""
    idx = 0
    for d in dims:
        idx = idx * axis_size(mesh, (d,)) + mesh.get_local_rank(d)
    return idx


def shard_rows(x: torch.Tensor, n_blocks: int, block: int) -> torch.Tensor:
    """Rows [block·per, (block+1)·per) of ``x``, per = ceil(rows / n_blocks);
    where the batch ends first, copies of its last row fill the block, so
    every block has ``per`` rows (their results are cut off by
    :func:`gather_rows`' caller)."""
    per = -(-x.shape[0] // n_blocks)
    own = x[block * per : (block + 1) * per]
    short = per - own.shape[0]
    if short:
        own = torch.cat([own, x[-1:].expand(short, *x.shape[1:])])
    return own


def _wire(x: torch.Tensor) -> torch.Tensor:
    # gloo has no bool collectives: booleans travel as uint8
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def gather_rows(x: torch.Tensor, mesh: DeviceMesh, dims: tuple[str, ...]) -> torch.Tensor:
    """Every rank's block of rows along ``dims``, concatenated in block
    order on every rank (an all_gather on each axis, innermost first)."""
    out = _wire(x)
    for d in reversed(dims):
        group = mesh.get_group(d)
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, dims: tuple[str, ...], op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced with ``op`` over the ranks along ``dims``, in place."""
    for d in dims:
        dist.all_reduce(x, op=op, group=mesh.get_group(d))
    return x
