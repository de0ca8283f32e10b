"""The mesh over the ``torch.distributed`` world: its ``data`` axis, the
``model`` axis of tensor parallelism and the ``stage`` axis of the
pipelines.

Port of the JAX package's ``parallel/mesh.py`` for those three axes. With
a process group initialized (:func:`..parallel.distributed.init`),
:func:`create_mesh` returns a ``torch.distributed.device_mesh.DeviceMesh``
of the whole world with one axis named ``data``. A single process with no
group — the default, and the CPU tests — gets a :class:`LocalMesh`, a
mesh of one with the same read surface (``mesh_dim_names``, ``size``,
``get_local_rank``, ``get_group``), so no group has to be formed to train
on one device. ``{"model": tp}`` is the tensor-parallel mesh over a world
of ``tp`` processes, and ``{"data": d, "model": tp}`` the data x model
mesh over a world of ``d * tp``, the model axis inner (rank ``i * tp + j``
is data coordinate ``i``, model coordinate ``j``: the JAX layout
``devices.reshape(data, model)``);
:class:`..parallel.tensor_parallel.TensorParallel` takes either.

``{"data": d, "stage": s}`` is a :class:`StageMesh`: a world of ``d``
processes, each holding all ``s`` stages, stage i on its own device
(``stage_devices``, default ``cuda:0 … cuda:s-1``), the data axis over
the world as above (the JAX mesh puts the ``d * s`` devices in one grid;
the port's layout of ``d * s`` ranks with point-to-point sends is
``pipeline_spmd``'s, not ported). One card, or the CPU, holds every stage
only when the caller passes the same device ``s`` times: nothing repeats
a device silently. ``stage`` beside ``model``, and the ``seq`` and
``expert`` axes, raise.
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

_LATER = "the remaining parallel strategies (sequence and expert parallelism)"


class LocalMesh:
    """A mesh of one process and one device, with no process group: the
    data axis (``mesh_dim_names`` ``("data",)``), or a model axis of one."""

    def __init__(self, device: torch.device, mesh_dim_names: tuple = (DATA_AXIS,)):
        self.device = device
        self.mesh_dim_names = tuple(mesh_dim_names)

    def size(self, mesh_dim: int | str | None = None) -> int:
        return 1

    def get_local_rank(self, mesh_dim: int | str | None = None) -> int:
        return 0

    def get_group(self, mesh_dim: int | str | None = None):
        return None

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}=1" for a in self.mesh_dim_names)
        return f"LocalMesh({axes}, device={self.device})"


class StageMesh:
    """``{"data": d, "stage": s}``: the data axis over the world (a
    ``DeviceMesh``, or a :class:`LocalMesh` of one process) and this
    process's ``s`` stage devices. ``size``, ``get_local_rank`` and
    ``get_group`` answer for the data axis (the stage axis has no group:
    its hops are ``x.to(device)`` inside the process) and ``size("stage")``
    is ``s``."""

    def __init__(self, data_mesh, stage_devices):
        self.data_mesh = data_mesh
        self.stage_devices = tuple(torch.device(d) for d in stage_devices)
        self.mesh_dim_names = (DATA_AXIS, STAGE_AXIS)

    def size(self, mesh_dim: int | str | None = None) -> int:
        if mesh_dim in (STAGE_AXIS, 1):
            return len(self.stage_devices)
        data = self.data_mesh.size(0)
        return data * len(self.stage_devices) if mesh_dim is None else data

    def get_local_rank(self, mesh_dim: int | str | None = None) -> int:
        if mesh_dim in (STAGE_AXIS, 1):
            raise ValueError("a process holds every stage: it has no stage coordinate")
        return self.data_mesh.get_local_rank(0)

    def get_group(self, mesh_dim: int | str | None = None):
        if mesh_dim in (STAGE_AXIS, 1):
            return None
        return self.data_mesh.get_group(0)

    def __repr__(self) -> str:
        devices = ", ".join(str(d) for d in self.stage_devices)
        return f"StageMesh(data={self.data_mesh.size(0)}, stage=[{devices}])"


def create_mesh(axes: dict[str, int] | None = None, *, device=None, stage_devices=None):
    """The mesh over every process of the world: ``{'data': world}`` by
    default, with a ``model`` axis the tensor-parallel mesh, with a
    ``stage`` axis a :class:`StageMesh`.

    ``axes`` may name ``data`` alone, with the world size or ``-1`` (a data
    axis over part of the world is not supported), or ``model`` with a
    ``data`` axis beside it (default 1) whose product is the world size
    (either one ``-1``: the rest of the world), or ``stage`` with a
    ``data`` axis beside it (default: the world). ``device`` is ``cuda``
    unless the caller passes another (raises without a GPU).
    ``stage_devices`` (a ``stage`` axis only): one device a stage, default
    ``cuda:0 … cuda:s-1``; on the CPU, or on fewer cards than stages, the
    caller names them (the same device ``s`` times for one)."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    axes = dict(axes) if axes is not None else {DATA_AXIS: world}
    if MODEL_AXIS in axes:
        return _model_mesh(axes, world, dev)
    if STAGE_AXIS in axes:
        return _stage_mesh(axes, world, dev, stage_devices)
    if stage_devices is not None:
        raise ValueError("stage_devices needs a 'stage' axis")
    return _data_mesh(axes, world, dev)


def _data_mesh(axes: dict[str, int], world: int, dev: torch.device):
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


def _stage_mesh(axes: dict[str, int], world: int, dev: torch.device, stage_devices):
    """``{'stage': s}`` or ``{'data': d, 'stage': s}``: a data mesh over
    the world and ``s`` stage devices in this process."""
    stages = axes[STAGE_AXIS]
    if stages < 1:
        raise ValueError(f"a stage axis of {stages}")
    if stage_devices is None:
        if dev.type != "cuda" or torch.cuda.device_count() < stages:
            raise ValueError(
                f"{stages} stages need stage_devices: the default, cuda:0 … "
                f"cuda:{stages - 1}, needs {stages} cards; name the devices (the same "
                "one repeated to hold several stages)")
        stage_devices = [torch.device("cuda", i) for i in range(stages)]
    if len(stage_devices) != stages:
        raise ValueError(f"{len(stage_devices)} stage_devices for a stage axis of {stages}")
    data = {k: v for k, v in axes.items() if k != STAGE_AXIS}
    return StageMesh(_data_mesh(data, world, dev), stage_devices)


def _model_mesh(axes: dict[str, int], world: int, dev: torch.device):
    """``{'model': tp}`` or ``{'data': d, 'model': tp}`` over a world of
    ``d * tp`` processes, the model axis inner."""
    if STAGE_AXIS in axes:
        raise NotImplementedError("a stage axis beside a model axis is not supported by "
                                  "the PyTorch port")
    other = sorted(set(axes) - {DATA_AXIS, MODEL_AXIS})
    if other:
        raise NotImplementedError(
            f"mesh axes {other} are not supported by the PyTorch port yet; they "
            f"arrive with {_LATER}"
        )
    size, data = axes[MODEL_AXIS], axes.get(DATA_AXIS, 1)
    if size == -1 and data > 0 and world % data == 0:
        size = world // data
    elif data == -1 and size > 0 and world % size == 0:
        data = world // size
    if size < 1 or data < 1 or data * size != world:
        raise ValueError(f"a data axis of {data} and a model axis of {size} over a world "
                         f"of {world} processes: the port's mesh spans the whole world")
    names = tuple(a for a in (DATA_AXIS, MODEL_AXIS) if a in axes)
    if not dist.is_initialized():
        return LocalMesh(dev, names)
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(data if a == DATA_AXIS else size for a in names)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


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
