"""Multi-process spawn launcher: the ``mp.spawn`` twin (port of the JAX
package's ``launch/_spawn.py``).

:func:`spawn` forks ``nprocs`` workers with ``torch.multiprocessing``'s
spawn start method, runs ``target(rank, *args)`` in each (the rank is
argument 0), joins them, and surfaces failures. The worker body forms
its group itself with :func:`..parallel.distributed.init`: explicitly
(the spawn contract: ``coordinator``, ``nprocs``, ``rank``) or from the
environment (``env_contract=True``: the launcher plays the torchrun
agent and injects ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``).
"""

from __future__ import annotations

import os
import socket
import time
import warnings
from collections.abc import Callable, Sequence

import torch.multiprocessing as mp

DEFAULT_JOIN_TIMEOUT_S = 300.0


def pick_unused_port() -> int:
    """An OS-assigned free TCP port for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def coordinator_for_spawn(port: int | None = None) -> str:
    """The spawn contract's rendezvous endpoint, ``localhost:<port>`` (an
    OS-assigned port by default: a fixed one is what makes a re-run
    flaky)."""
    return f"localhost:{port if port is not None else pick_unused_port()}"


def world_backend(nprocs: int, device) -> str:
    """The group's backend for ``nprocs`` ranks on ``device``: NCCL when
    every rank has a card of its own; gloo on the CPU, and on a card
    shared by several ranks (NCCL refuses two ranks on one device: gloo
    stages CUDA tensors through host memory)."""
    import torch

    if torch.device(device).type == "cuda" and nprocs <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _worker_env(rank: int, nprocs: int, coordinator: str, env_contract: bool) -> dict[str, str]:
    """The environment one child adds (the torchrun agent's variables)."""
    if not env_contract:
        return {}
    host, port = coordinator.rsplit(":", 1)
    return {"RANK": str(rank), "WORLD_SIZE": str(nprocs), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": host, "MASTER_PORT": port}


def _bootstrap(env_delta: dict, target: Callable, rank: int, args: Sequence) -> None:
    """Child entry: the environment delta applied inside the child (never
    in the parent's ``os.environ``), then ``target(rank, *args)``."""
    os.environ.update(env_delta)
    target(rank, *args)


def _run_world(target: Callable, nprocs: int, args: Sequence, coordinator: str,
               env_contract: bool, join_timeout_s: float) -> list[tuple[int, int | None]]:
    """Fork one world and watch it; returns ``[(rank, exitcode or None)]``
    of the failed ranks (empty on success). The moment a rank exits
    non-zero the survivors — likely blocked in a collective on the dead
    peer — are terminated (SIGKILL if they ignore SIGTERM), not left to
    hang until the timeout."""
    ctx = mp.get_context("spawn")
    procs = []
    try:
        for rank in range(nprocs):
            p = ctx.Process(
                target=_bootstrap,
                args=(_worker_env(rank, nprocs, coordinator, env_contract), target, rank,
                      tuple(args)),
                name=f"spawn-rank{rank}",
            )
            p.start()
            procs.append(p)
    except BaseException:
        # earlier ranks would wait at the rendezvous forever: reap them
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
        raise
    deadline = time.monotonic() + join_timeout_s
    while True:
        alive = [p for p in procs if p.is_alive()]
        failed = [(r, p.exitcode) for r, p in enumerate(procs)
                  if not p.is_alive() and p.exitcode != 0]
        if not alive or failed:
            break
        if time.monotonic() > deadline:
            failed = [(r, None) for r, p in enumerate(procs) if p.is_alive()]
            break
        time.sleep(0.1)
    if failed:
        for p in procs:
            if p.is_alive():
                p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)
    return failed


def _failure_detail(failed: list[tuple[int, int | None]]) -> str:
    return ", ".join(f"rank {r}: {'timeout' if c is None else f'exit {c}'}" for r, c in failed)


def spawn(target: Callable, nprocs: int, args: Sequence = (), *, coordinator: str | None = None,
          env_contract: bool = False, join_timeout_s: float = DEFAULT_JOIN_TIMEOUT_S,
          max_restarts: int = 0) -> None:
    """Fork ``nprocs`` workers running ``target(rank, *args)``; join all.

    ``target`` is a module-level (picklable) callable that forms its group
    with :func:`..parallel.distributed.init`. ``max_restarts > 0`` is the
    torchrun agent's elasticity: when a rank dies the whole gang is torn
    down and re-forked, up to ``max_restarts`` times, with a fresh
    rendezvous endpoint each attempt (unless ``coordinator`` pins one).
    Raises ``RuntimeError`` naming the failed ranks if the last attempt
    fails."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    if max_restarts > 0 and not env_contract and nprocs > 1:
        # a spawn-contract target gets its endpoint through `args`, which
        # the launcher cannot refresh between attempts
        warnings.warn(
            "spawn(max_restarts>0) with the explicit-coordinator contract reuses the "
            "coordinator baked into `args` across restarts; use env_contract=True for "
            "restart-safe rendezvous", stacklevel=2)
    for attempt in range(max_restarts + 1):
        att_coordinator = coordinator or coordinator_for_spawn()
        failed = _run_world(target, nprocs, args, att_coordinator, env_contract, join_timeout_s)
        if not failed:
            return
        if attempt < max_restarts:
            print(f"spawn: world failed ({_failure_detail(failed)}); "
                  f"restarting ({attempt + 1}/{max_restarts})", flush=True)
            continue
        raise RuntimeError(f"spawn: {len(failed)}/{nprocs} workers failed "
                           f"({_failure_detail(failed)})")
