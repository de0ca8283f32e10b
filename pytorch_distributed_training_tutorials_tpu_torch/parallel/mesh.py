"""The data-parallel mesh over the ``torch.distributed`` world.

Port of the JAX package's ``parallel/mesh.py`` for its ``data`` axis. With
a process group initialized (:func:`..parallel.distributed.init`),
:func:`create_mesh` returns a ``torch.distributed.device_mesh.DeviceMesh``
of the whole world with one axis named ``data``. A single process with no
group — the default, and the CPU tests — gets a :class:`LocalMesh`, a
mesh of one with the same read surface (``mesh_dim_names``, ``size``,
``get_local_rank``, ``get_group``), so no group has to be formed to train
on one device. Other axes (``model``, ``stage``, ``seq``, ``expert``)
arrive with the parallel strategies that use them and raise here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"

_LATER = "the remaining parallel strategies (FSDP, tensor, pipeline, sequence, expert)"


class LocalMesh:
    """A data mesh of one process and one device, with no process group."""

    mesh_dim_names = (DATA_AXIS,)

    def __init__(self, device: torch.device):
        self.device = device

    def size(self, mesh_dim: int | str | None = None) -> int:
        return 1

    def get_local_rank(self, mesh_dim: int | str | None = None) -> int:
        return 0

    def get_group(self, mesh_dim: int | str | None = None):
        return None

    def __repr__(self) -> str:
        return f"LocalMesh(data=1, device={self.device})"


def create_mesh(axes: dict[str, int] | None = None, *, device=None):
    """The data mesh over every process of the world: ``{'data': world}``.

    ``axes`` may name only ``data``, with the world size or ``-1``; a data
    axis over part of the world is not supported. ``device`` is ``cuda``
    unless the caller passes another (raises without a GPU)."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    axes = dict(axes) if axes is not None else {DATA_AXIS: world}
    other = sorted(set(axes) - {DATA_AXIS})
    if other:
        raise NotImplementedError(
            f"mesh axes {other} are not supported by the PyTorch port yet; they "
            f"arrive with {_LATER}"
        )
    size = axes.get(DATA_AXIS, world)
    if size == -1:
        size = world
    if size != world:
        raise ValueError(f"a data axis of {size} over a world of {world} processes: "
                         "the port's data axis spans the whole world")
    if not dist.is_initialized():
        return LocalMesh(dev)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, (world,), mesh_dim_names=(DATA_AXIS,))


def axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` in ``mesh`` (1 if the axis does not exist)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This process's coordinate along ``axis`` (0 if the axis does not
    exist)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def mesh_device(mesh) -> torch.device:
    """The device this process holds in ``mesh``: a :class:`LocalMesh`'s
    own, else the current CUDA device or the CPU."""
    if isinstance(mesh, LocalMesh):
        return mesh.device
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
