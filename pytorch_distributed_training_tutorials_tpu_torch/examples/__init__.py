"""The port's examples: twins of the JAX package's ``examples/`` scripts,
run as modules::

    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.train_resnet_mnist --fsdp
    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.train_llm_3d --mode pp --nprocs 2
    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.serve_llm_int8 --preset 1b --server

Each runs on ``cuda`` unless given ``--device cpu``, and raises without a
GPU otherwise. Where the JAX script's ``create_mesh()`` takes every chip
of one process, a twin runs one rank a card: in-process at world 1, and a
spawned world with ``--nprocs N`` (:func:`run_world`).
"""

from __future__ import annotations

from collections.abc import Callable, Sequence


def run_world(fn: Callable, nprocs: int, args: Sequence = (), *, device=None) -> list:
    """``fn(world, *args)`` on every rank of a spawned world of ``nprocs``
    processes on ``device`` (``cuda`` unless the caller passes another;
    without a GPU that raises here, before anything is spawned), rank ``r``
    on card ``r % device_count``; the ranks' results in rank order. The
    ranks share the host's cores: each takes ``cpu_count // nprocs``
    threads (PyTorch's default, every core a rank, oversubscribes them)."""
    import os

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.launch import world_backend
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        spawn_tp,
    )

    dev = resolve_device(device)
    threads = max(1, (os.cpu_count() or 1) // nprocs)
    return spawn_tp(_rank, nprocs, (fn, threads, *args), backend=world_backend(nprocs, dev),
                    device=dev.type, join_timeout_s=1800.0)


def _rank(world, fn: Callable, threads: int, *args):
    import torch

    torch.set_num_threads(threads)
    return fn(world, *args)
