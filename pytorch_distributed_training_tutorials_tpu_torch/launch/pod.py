"""Multi-host launch contract: the same command on every host (port of
the JAX package's ``launch/pod.py``).

On GPU hosts the agent that finds peers, assigns ranks and points every
process at a rendezvous is ``torchrun``. Each host runs one ``torchrun``
with the world's node count, its own node rank and the shared rendezvous
endpoint; the training script owns no topology (it reads ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, as
``launch.train_ddp_env`` does). :func:`pod_run_command` builds one host's
argv (pure, tested without a cluster); :func:`launch_pod` runs it, with
``torchrun``'s own restarts, and resuming from a checkpoint after a
restart is the script's ``Trainer.restore``.
"""

from __future__ import annotations

import shlex
import subprocess
from collections.abc import Sequence


def pod_run_command(script: str, script_args: Sequence[str] = (), *, nnodes: int,
                    node_rank: int, rdzv_endpoint: str, nproc_per_node: int = 1,
                    max_restarts: int = 0, module: bool = False) -> list[str]:
    """The ``torchrun`` argv host ``node_rank`` of ``nnodes`` runs::

        torchrun --nnodes 2 --node-rank 0 --rdzv-endpoint host0:29500 \\
            --nproc-per-node 8 --max-restarts 0 train.py --max_epochs 10

    ``module=True`` runs ``script`` as ``-m module``. Every host runs the
    same argv but for ``--node-rank``."""
    if nnodes < 1 or not 0 <= node_rank < nnodes:
        raise ValueError(f"node_rank {node_rank} outside a world of {nnodes} nodes")
    if nproc_per_node < 1:
        raise ValueError(f"nproc_per_node must be >= 1, got {nproc_per_node}")
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    host, _, port = rdzv_endpoint.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"rdzv_endpoint must be HOST:PORT, got {rdzv_endpoint!r}")
    return ["torchrun", "--nnodes", str(nnodes), "--node-rank", str(node_rank),
            "--rdzv-endpoint", rdzv_endpoint, "--nproc-per-node", str(nproc_per_node),
            "--max-restarts", str(max_restarts), *(["-m"] if module else []), script,
            *script_args]


def launch_pod(script: str, script_args: Sequence[str] = (), **kwargs) -> int:
    """Run this host's share of the world (:func:`pod_run_command`'s
    arguments) and return ``torchrun``'s exit code. Raises
    ``FileNotFoundError`` with the command when ``torchrun`` is missing."""
    cmd = pod_run_command(script, script_args, **kwargs)
    try:
        return subprocess.run(cmd).returncode
    except FileNotFoundError as e:
        raise FileNotFoundError(
            "torchrun not found: launch_pod runs torchrun (PyTorch's launcher) on "
            f"each host; install PyTorch there or run: {shlex.join(cmd)}") from e
