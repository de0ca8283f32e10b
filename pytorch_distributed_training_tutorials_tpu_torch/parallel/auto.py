"""Checkpoints and placement: the ``device_map="auto"`` twin, in PyTorch.

Port of the JAX package's ``parallel/auto.py``. The reference lesson
(SURVEY.md C13) streams a published checkpoint's shards with
``from_pretrained(..., device_map="auto", load_in_8bit=True)`` and then
audits every parameter's device and dtype (``03.model_parallel.ipynb``
cells 2 and 4). Here placement is declared per leaf (a device, or a
rank's block of one dimension), and every leaf is read on its own.

The JAX module writes orbax checkpoints; the port writes its own: one
safetensors file (:mod:`.hf_llama`'s container: an 8-byte header length,
a JSON header of ``name -> {dtype, shape, data_offsets}``, then the raw
little-endian bytes) whose tensor names are the tree's key paths joined
with ``/``. Restoring one leaf is one ``seek`` + ``readinto`` of that
leaf's bytes — the host bound orbax gives the JAX functions — and a
dimension-0 block reads only its rows. Trees are nested mappings of
tensors or arrays; what comes back is torch tensors.

The JAX ``device_materialize`` has no counterpart: a tensor placed on
the card is resident already.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from collections.abc import Callable, Mapping

import numpy as np
import torch

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
from pytorch_distributed_training_tutorials_tpu_torch.parallel.hf_llama import (
    SafetensorsFile,
    _torch_dtype,
    save_safetensors,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    shard_tensor,
)
from pytorch_distributed_training_tutorials_tpu_torch.utils.tree import keystr

@dataclasses.dataclass(frozen=True)
class LeafMeta:
    """A checkpoint leaf's shape and dtype, read from the header only."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's block of one dimension, the form of
    :func:`..parallel.tensor_parallel.shard_tensor`: block ``rank`` of
    ``parts`` contiguous blocks of dimension ``dim``, placed on
    ``device``."""

    dim: int
    rank: int
    parts: int
    device: str | torch.device = "cpu"


def tree_leaves(tree, prefix: tuple = ()):
    """``(key path, leaf)`` of every leaf of a tree of nested mappings, in
    order."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from tree_leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _set(tree: dict, path: tuple, leaf) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = leaf


def save_checkpoint(path: str | os.PathLike, tree) -> None:
    """Write a tree (nested mappings of tensors or arrays, on any device)
    as one checkpoint file at ``path``, leaf by leaf through the host.

    Overwrites an existing checkpoint at ``path``: the file is written
    under a temporary name beside it and renamed over it, so a reader
    never sees a half-written checkpoint."""
    flat = {}
    for kp, leaf in tree_leaves(tree):
        if any("/" in str(k) or not str(k) for k in kp):
            raise ValueError(f"key path {kp}: keys must be non-empty and hold no '/'")
        flat[keystr(kp)] = leaf
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(prefix=".ckpt-", dir=os.path.dirname(path))
    os.close(fd)
    try:
        save_safetensors(tmp, flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def checkpoint_leaf_metadata(path: str | os.PathLike) -> list[tuple[tuple[str, ...], LeafMeta]]:
    """``(key_path, LeafMeta)`` of every leaf of a checkpoint, in the
    file's order, from its header alone."""
    f = SafetensorsFile(path)
    return [(tuple(name.split("/")), LeafMeta(shape, _torch_dtype(tag)))
            for name, (tag, shape, _) in f.tensors.items()]


def restore_leaf(path: str | os.PathLike, key_path: tuple, place=None, *,
                 file: SafetensorsFile | None = None) -> torch.Tensor:
    """Restore exactly one leaf: that tensor's bytes and no others, so the
    host peak is this leaf's size. ``place``: None (a host tensor), a
    device, or a :class:`Shard` — the block alone, on its device; a
    dimension-0 block reads only its rows' bytes. Pass an open ``file``
    when restoring many leaves in a loop (one header parse)."""
    f = file if file is not None else SafetensorsFile(path)
    name = keystr(key_path)
    if not isinstance(place, Shard):
        t = f.get(name)
        return t if place is None else t.to(place)
    shape = f.tensors[name][1]
    dim = place.dim % len(shape)
    if shape[dim] % place.parts:
        raise ValueError(f"{name}: dimension {dim} of {shape} does not split into "
                         f"{place.parts} blocks")
    if dim == 0:
        n = shape[0] // place.parts
        return f.get(name, rows=(place.rank * n, (place.rank + 1) * n)).to(place.device)
    return shard_tensor(f.get(name), dim, place.rank, place.parts).to(place.device)


def load_sharded(path: str | os.PathLike,
                 placement: Callable[[tuple, LeafMeta], object]):
    """Restore a checkpoint placed per leaf, one leaf at a time.

    ``placement(key_path, meta)`` is the declarative twin of accelerate's
    ``infer_auto_device_map``: the caller states where every leaf lives —
    a device (the whole leaf there), a :class:`Shard` (a rank's block of
    one dimension, on its device), or None (the host) — and each leaf is
    read straight into that placement, with no whole-model host copy.
    A tensor-parallel rank's placement is a :class:`Shard` wherever
    :func:`..parallel.tensor_parallel.split_dim` splits the leaf."""
    f = SafetensorsFile(path)
    out: dict = {}
    for kp, meta in checkpoint_leaf_metadata(path):
        _set(out, kp, restore_leaf(path, kp, placement(kp, meta), file=f))
    return out


def restore_checkpoint(path: str | os.PathLike, like=None):
    """Restore a checkpoint. With ``like=None``: every leaf as a host
    tensor. With ``like`` (a tree of tensors or arrays): that tree's
    structure, each leaf in its ``like`` leaf's dtype and on its device
    (an array's: the host)."""
    if like is None:
        return load_sharded(path, lambda kp, meta: None)
    f = SafetensorsFile(path)
    out: dict = {}
    for kp, ref in tree_leaves(like):
        t = restore_leaf(path, kp, file=f)
        if isinstance(ref, torch.Tensor):
            t = t.to(device=ref.device, dtype=ref.dtype)
        else:
            t = t.to(dtype=torch.from_numpy(np.empty(0, np.asarray(ref).dtype)).dtype)
        _set(out, kp, t)
    return out


def _default_should_quantize(name: str, meta: LeafMeta) -> bool:
    return name.endswith("kernel") and meta.ndim >= 2


def load_quantized(path: str | os.PathLike, should_quantize=None, channel_axis: int = -1,
                   placement=None, *, device=None):
    """Restore a checkpoint with selected weights quantized to int8 on
    load, **streaming one leaf at a time**.

    The ``load_in_8bit=True`` twin (reference ``03.model_parallel.ipynb``
    cell 2, SURVEY.md C13): matmul weights come back as
    :class:`..ops.quant.Int8Param` (int8 values + per-channel float32
    scales, 1/4 of the bytes) while norms, biases and embeddings stay
    float — the mixed layout of the tutorial's parameter audit (cell 4).
    Each leaf is read alone, quantized, and freed before the next read:
    the float checkpoint is never resident in full.

    ``should_quantize(path_str, meta) -> bool`` selects the weights from
    the header's :class:`LeafMeta` (``shape``, ``dtype``, ``ndim``), so
    the choice is made before a byte is read; the default, as in the JAX
    package, quantizes every leaf of rank >= 2 whose path ends in
    ``kernel``. Leaves land on ``device`` (``cuda`` unless the caller
    passes another), or where ``placement(key_path, meta)`` says (as for
    :func:`load_sharded`). A quantized leaf placed as a :class:`Shard` is
    quantized whole and then cut — a block quantized alone would take
    other scales — its scale cut with it along the channel axis and
    whole along the others."""
    from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import (
        Int8Param,
        quantize_int8,
    )

    should_quantize = should_quantize or _default_should_quantize
    dev = resolve_device(device) if placement is None else None
    f = SafetensorsFile(path)
    out: dict = {}
    for kp, meta in checkpoint_leaf_metadata(path):
        place = dev if placement is None else placement(kp, meta)
        if not should_quantize(keystr(kp), meta):
            _set(out, kp, restore_leaf(path, kp, place, file=f))
            continue
        shard = place if isinstance(place, Shard) else None
        leaf = restore_leaf(path, kp, shard.device if shard else place, file=f)
        qp = quantize_int8(leaf, channel_axis=channel_axis)
        del leaf  # free the float leaf before the next read
        if shard is not None:
            dim = shard.dim % qp.q.ndim
            scale_dim = dim if qp.scale.shape[dim] > 1 else None
            qp = Int8Param(q=shard_tensor(qp.q, dim, shard.rank, shard.parts),
                           scale=shard_tensor(qp.scale, scale_dim, shard.rank, shard.parts))
        _set(out, kp, qp)
    return out


def audit_placement(tree) -> list[str]:
    """One line per leaf, ``name: shape dtype on device`` — the twin of
    the reference's parameter audit (``03.model_parallel.ipynb`` cell 4:
    ``for name, param: print(name, param.device, param.dtype)``). Names
    are key paths joined with ``/`` (a flat state dict's names as they
    are); an :class:`..ops.quant.Int8Param` gives its ``q`` and ``scale``
    lines; an array is ``on host``."""
    from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import Int8Param

    lines = []
    for kp, leaf in tree_leaves(tree):
        name = keystr(kp)
        parts = ([(f"{name}/q", leaf.q), (f"{name}/scale", leaf.scale)]
                 if isinstance(leaf, Int8Param) else [(name, leaf)])
        for n, x in parts:
            if isinstance(x, torch.Tensor):
                where, dtype = str(x.device), str(x.dtype).removeprefix("torch.")
            else:
                x = np.asarray(x)
                where, dtype = "host", str(x.dtype)
            lines.append(f"{n}: {tuple(x.shape)} {dtype} on {where}")
    return lines
