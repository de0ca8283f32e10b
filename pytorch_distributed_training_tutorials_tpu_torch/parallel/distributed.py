"""The ``torch.distributed`` runtime: port of the JAX package's
``parallel/distributed.py``, with its two launch contracts.

- **spawn contract**: explicit ``(coordinator, num_processes,
  process_id)``, ``init("localhost:12355", num_processes=4,
  process_id=rank)`` — a TCP rendezvous at the coordinator;
- **torchrun contract**: ``init()`` with ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the environment
  (what ``torchrun`` and :func:`..launch.spawn` with ``env_contract=True``
  inject).

A process with neither is a single-process run and needs no group:
:func:`init` returns without forming one (the mesh is then a
:class:`..parallel.mesh.LocalMesh`). On ``cuda`` (the default) the
backend is NCCL, after ``torch.cuda.set_device(local_rank)``; with
``device="cpu"`` it is gloo. A world of one on one card, asked for
explicitly, is a real NCCL group. ``backend="gloo"`` on ``cuda`` is the
caller's explicit choice for ranks that share a card (NCCL refuses a
communicator with two ranks on one device): gloo stages CUDA tensors
through host memory.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device

ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# how long a collective or the rendezvous waits for a missing peer
TIMEOUT_S = 300.0


def init(coordinator_address: str | None = None, num_processes: int | None = None,
         process_id: int | None = None, *, device=None, backend: str | None = None) -> None:
    """Form the process group (no-op for a single-process run, and when a
    group exists already).

    Spawn contract::

        init("localhost:12355", num_processes=4, process_id=rank)

    Torchrun contract (``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
    ``MASTER_ADDR``/``MASTER_PORT`` in the environment)::

        init()
    """
    if dist.is_initialized():
        return
    local_rank = None
    explicit = coordinator_address is not None or num_processes is not None
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("the spawn contract needs coordinator_address, "
                             "num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif all(k in os.environ for k in ENV_KEYS):
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if "LOCAL_RANK" in os.environ:
            local_rank = int(os.environ["LOCAL_RANK"])
    else:
        return  # a single process: no group to form
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be None, 'nccl' or 'gloo', got {backend!r}")
    dev = resolve_device(device)
    kwargs = {}
    if dev.type == "cuda":
        local = local_rank if local_rank is not None else rank % torch.cuda.device_count()
        torch.cuda.set_device(local)
        if backend in (None, "nccl"):
            backend = "nccl"
            kwargs["device_id"] = torch.device("cuda", local)
    elif backend in (None, "gloo"):
        backend = "gloo"
    else:
        raise ValueError(f"backend {backend!r} on {dev}: NCCL needs a card")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **kwargs)


def shutdown() -> None:
    """Tear down the process group; safe when :func:`init` formed none."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the logging process, rank 0."""
    return process_index() == 0
