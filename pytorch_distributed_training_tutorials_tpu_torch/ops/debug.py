"""Sharding observability: the tutorials' shape-print lessons (port of the
JAX package's ``ops/debug.py``).

Lesson 01 proves the DataParallel scatter by printing ``Input shape: [8,
32]`` from each of 4 replicas. A JAX array knows its shards
(``addressable_shards``); in the port each rank holds its own block, so
the shapes are gathered over the process group (or a mesh axis's group)
that splits the tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group(group, mesh, axis: str | None):
    if mesh is not None:
        return mesh.get_group(axis)
    return group


def _gather(x: torch.Tensor, group) -> list[tuple[tuple, str]]:
    """Each rank's ``(shape, device)`` of its ``x``, in the group's rank
    order; this process's alone without an initialized group."""
    mine = (tuple(x.shape), str(x.device))
    if not dist.is_initialized():
        return [mine]
    out: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, mine, group=group)
    return out


def per_shard_shapes(x: torch.Tensor, group=None, *, mesh=None,
                     axis: str | None = None) -> list[tuple]:
    """Shapes of each rank's block of ``x`` over ``group`` (or ``mesh``'s
    ``axis``): for a batch of 32 split over 4 ranks, four ``(8, ...)``
    entries — the observable twin of lesson 01's ``Input shape: [8, 32]``
    prints. One process with no group: ``[x.shape]``. Every rank of the
    group must call it (it gathers)."""
    return [shape for shape, _ in _gather(x, _group(group, mesh, axis))]


def describe_sharding(x: torch.Tensor, group=None, *, mesh=None, axis: str | None = None,
                      dim: int | None = 0) -> str:
    """One-line device/shape audit of a tensor split over ``group`` (or
    ``mesh``'s ``axis``) along ``dim`` (None: replicated, every rank holds
    it whole): ``global (32, 8) torch.float32 -> [rank0 cuda:0:(8, 8), ...]``,
    like lesson 03's parameter audit. Every rank of the group must call
    it."""
    blocks = _gather(x, _group(group, mesh, axis))
    shape = list(blocks[0][0])
    if dim is not None and shape:
        shape[dim] = sum(s[dim] for s, _ in blocks)
    shards = ", ".join(f"rank{r} {dev}:{s}" for r, (s, dev) in enumerate(blocks))
    return f"global {tuple(shape)} {x.dtype} -> [{shards}]"
