"""Env-contract DDP training CLI (port of the JAX package's
``launch/train_ddp_env.py``, the reference's ``ddp_gpus_torchrun.py``).

The script owns no topology: ``torchrun`` (or :func:`..launch.spawn` with
``env_contract=True``) injects ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; without them it is a single
process. Run the same command in every process::

    torchrun --nproc-per-node 4 -m \\
        pytorch_distributed_training_tutorials_tpu_torch.launch.train_ddp_env
    python -m pytorch_distributed_training_tutorials_tpu_torch.launch.train_ddp_env --device cpu
"""

from __future__ import annotations

from pytorch_distributed_training_tutorials_tpu_torch.data import ShardedLoader, synthetic_regression
from pytorch_distributed_training_tutorials_tpu_torch.launch.train_ddp import (
    DATASET_SIZE,
    LEARNING_RATE,
    build_parser,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import LinearRegressor
from pytorch_distributed_training_tutorials_tpu_torch.parallel import distributed
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, sgd


def main(max_epochs: int, batch_size: int, loss: str = "mse", device: str | None = None) -> None:
    """No rank or world arguments: the topology is read from the
    environment."""
    distributed.init(device=device)
    mesh = create_mesh(device=device)
    loader = ShardedLoader(synthetic_regression(DATASET_SIZE), batch_size, mesh)
    Trainer(LinearRegressor(), loader, sgd(LEARNING_RATE), loss=loss).train(max_epochs)
    distributed.shutdown()


def env_worker(rank: int, max_epochs: int, batch_size: int, device: str | None = None) -> None:
    """A :func:`..launch.spawn` target for the env contract: the launcher
    injects the environment and the body never sees its rank."""
    del rank  # read from the environment inside main()
    main(max_epochs, batch_size, device=device)


if __name__ == "__main__":
    args = build_parser(launch_flags=False).parse_args()
    main(args.max_epochs, args.batch_size, loss=args.loss, device=args.device)
