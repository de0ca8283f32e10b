"""The mesh over the ``torch.distributed`` world: its ``data`` axis, the
``model`` axis of tensor parallelism, the ``seq`` axis of sequence
parallelism, the ``expert`` axis of expert parallelism and the ``stage``
axis of the pipelines.

Port of the JAX package's ``parallel/mesh.py``. With a process group
initialized (:func:`..parallel.distributed.init`), :func:`create_mesh`
returns a ``torch.distributed.device_mesh.DeviceMesh`` of the whole world
whose axes are the ones the caller names, in the JAX package's order
``devices.reshape(data, seq, model)`` / ``(data, expert)`` / ``(data,
stage)``: the last axis innermost (rank ``i * tp + j`` of a ``{"data": d,
"model": tp}`` mesh is data coordinate ``i``, model coordinate ``j``). The
axes' product is the world size (one axis may be ``-1``: the rest of the
world). A single process with no group — the default, and the CPU tests —
gets a :class:`LocalMesh`, a mesh of one with the same read surface
(``mesh_dim_names``, ``size``, ``get_local_rank``, ``get_group``), so no
group has to be formed to train on one device.

A ``stage`` axis has two layouts, and the call names the one it wants:

- ``stage_devices=[...]``: a :class:`StageMesh` — a world of ``d``
  processes, each holding all ``s`` stages, stage i on its own device (the
  layout of :class:`..parallel.pipeline.GPipe`; one card, or the CPU,
  holds every stage only when the caller passes the same device ``s``
  times: nothing repeats a device silently);
- ``stage_ranks=True``: a ``DeviceMesh`` of ``d * s`` ranks, one stage a
  rank, the hops point-to-point sends on the stage group (the layout of
  :mod:`.pipeline_spmd`).

Neither is guessed from the world size. Still refused with
``NotImplementedError``: ``expert`` beside ``model`` (dp x tp x ep), and a
``stage`` axis beside ``seq``, ``model`` or ``expert``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"

# the JAX layout: every axis present, in this order, the last innermost
_ORDER = (DATA_AXIS, SEQ_AXIS, EXPERT_AXIS, STAGE_AXIS, MODEL_AXIS)
_UNSCHEDULED = "no slice of the port schedules it yet (ROADMAP: what the port refuses)"


class LocalMesh:
    """A mesh of one process and one device, with no process group: the
    data axis (``mesh_dim_names`` ``("data",)``), or any axes of one."""

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


def create_mesh(axes: dict[str, int] | None = None, *, device=None, stage_devices=None,
                stage_ranks: bool = False):
    """The mesh over every process of the world: ``{'data': world}`` by
    default; with a ``stage`` axis a :class:`StageMesh` (``stage_devices``)
    or a stage axis over ranks (``stage_ranks=True``); otherwise a mesh of
    the named axes over the world (module docstring).

    ``axes`` names ``data`` with any of ``seq`` and ``model``, or ``data``
    with ``expert``, or ``data`` with ``stage``; their product is the world
    size, one of them ``-1`` for the rest of it (a ``data`` axis alone over
    part of the world is not supported). ``device`` is ``cuda`` unless the
    caller passes another (raises without a GPU). ``stage_devices`` (a
    :class:`StageMesh` only): one device a stage; on the CPU, or on fewer
    cards than stages, the caller names them (the same device ``s`` times
    for one)."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    axes = dict(axes) if axes is not None else {DATA_AXIS: world}
    unknown = sorted(set(axes) - set(_ORDER))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown} (the port's axes: {_ORDER})")
    if EXPERT_AXIS in axes and MODEL_AXIS in axes:
        raise NotImplementedError(
            "an expert axis beside a model axis (dp x tp x ep) is not supported by the "
            f"PyTorch port: {_UNSCHEDULED}")
    if STAGE_AXIS in axes:
        beside = sorted(set(axes) - {DATA_AXIS, STAGE_AXIS})
        if beside:
            raise NotImplementedError(
                f"a stage axis beside a {' / '.join(beside)} axis is not supported by the "
                f"PyTorch port: {_UNSCHEDULED}")
        if stage_ranks:
            if stage_devices is not None:
                raise ValueError("stage_ranks=True puts one stage on each rank; "
                                 "stage_devices is the in-process StageMesh's")
            return _grid_mesh(axes, world, dev)
        return _stage_mesh(axes, world, dev, stage_devices)
    if stage_devices is not None or stage_ranks:
        what = "stage_devices" if stage_devices is not None else "stage_ranks=True"
        raise ValueError(f"{what} needs a 'stage' axis")
    if set(axes) == {DATA_AXIS}:
        return _data_mesh(axes, world, dev)
    return _grid_mesh(axes, world, dev)


def _data_mesh(axes: dict[str, int], world: int, dev: torch.device):
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
    """``{'stage': s}`` or ``{'data': d, 'stage': s}`` in one process: a
    data mesh over the world and ``s`` stage devices in this process."""
    stages = axes[STAGE_AXIS]
    if stages < 1:
        raise ValueError(f"a stage axis of {stages}")
    if stage_devices is None:
        if dev.type != "cuda" or torch.cuda.device_count() < stages:
            raise ValueError(
                f"{stages} stages need stage_devices: the default, cuda:0 … "
                f"cuda:{stages - 1}, needs {stages} cards; name the devices (the same "
                "one repeated to hold several stages), or pass stage_ranks=True for "
                "one stage a rank")
        stage_devices = [torch.device("cuda", i) for i in range(stages)]
    if len(stage_devices) != stages:
        raise ValueError(f"{len(stage_devices)} stage_devices for a stage axis of {stages}")
    data = {k: v for k, v in axes.items() if k != STAGE_AXIS}
    return StageMesh(_data_mesh(data, world, dev), stage_devices)


def _grid_mesh(axes: dict[str, int], world: int, dev: torch.device):
    """The named axes over a world of their product, in the JAX order
    (:data:`_ORDER`, the last innermost); one ``-1`` takes the rest of the
    world."""
    names = tuple(a for a in _ORDER if a in axes)
    sizes = {a: axes[a] for a in names}
    rest = [a for a in names if sizes[a] == -1]
    known = math.prod(v for v in sizes.values() if v != -1)
    if len(rest) == 1 and known > 0 and world % known == 0:
        sizes[rest[0]] = world // known
    if any(v < 1 for v in sizes.values()) or math.prod(sizes.values()) != world:
        shape = " and a ".join(f"{a} axis of {axes[a]}" for a in names)
        raise ValueError(f"a {shape} over a world of {world} processes: the port's mesh "
                         "spans the whole world")
    if not dist.is_initialized():
        return LocalMesh(dev, names)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, tuple(sizes[a] for a in names), mesh_dim_names=names)


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
