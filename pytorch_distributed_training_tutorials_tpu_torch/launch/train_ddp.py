"""Spawn-flavor DDP training CLI (port of the JAX package's
``launch/train_ddp.py``, the reference's ``ddp_gpus.py``).

The same flags (``--max_epochs``; ``--batch_size``, per device) and
workload (``Linear(20, 1)`` on the 2,048-sample regression set, SGD
lr 1e-2, ``--loss mse`` by default). ``--nprocs N`` forks an N-process
world with an explicit rendezvous (the ``mp.spawn`` contract); each
process holds one device's rows. ``--device cpu`` runs the world on the
CPU with gloo (the hardware-free harness); without it every process takes
a CUDA device (``rank % device_count``) and the group is NCCL, or gloo
when the ranks outnumber the cards (``launch.world_backend``).

    python -m pytorch_distributed_training_tutorials_tpu_torch.launch.train_ddp \\
        --max_epochs 10 --batch_size 32
    python -m pytorch_distributed_training_tutorials_tpu_torch.launch.train_ddp \\
        --nprocs 4 --device cpu
"""

from __future__ import annotations

import argparse

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
from pytorch_distributed_training_tutorials_tpu_torch.data import ShardedLoader, synthetic_regression
from pytorch_distributed_training_tutorials_tpu_torch.launch._spawn import world_backend
from pytorch_distributed_training_tutorials_tpu_torch.models import LinearRegressor
from pytorch_distributed_training_tutorials_tpu_torch.parallel import distributed
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, sgd

DATASET_SIZE = 2048
LEARNING_RATE = 1e-2


def main(rank: int, world_size: int, max_epochs: int, batch_size: int,
         coordinator: str | None = None, loss: str = "mse", device: str | None = None) -> None:
    """Per-process entry: setup -> dataset -> sharded loader ->
    Linear(20, 1) -> SGD -> Trainer -> train -> teardown."""
    if world_size > 1:
        distributed.init(coordinator, num_processes=world_size, process_id=rank, device=device,
                         backend=world_backend(world_size, resolve_device(device)))
    mesh = create_mesh(device=device)
    loader = ShardedLoader(synthetic_regression(DATASET_SIZE), batch_size, mesh)
    Trainer(LinearRegressor(), loader, sgd(LEARNING_RATE), loss=loss).train(max_epochs)
    distributed.shutdown()


def build_parser(launch_flags: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DDP training on torch.distributed (spawn flavor)")
    p.add_argument("--max_epochs", type=int, default=10, help="Total epochs to train the model")
    p.add_argument("--batch_size", type=int, default=32,
                   help="Input batch size on each device (default: 32)")
    if launch_flags:
        p.add_argument("--nprocs", type=int, default=1,
                       help="processes to fork (>1: a multi-process world, the mp.spawn twin)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default: NCCL, gloo where ranks share a card) or cpu (gloo)")
    p.add_argument("--loss", choices=("mse", "cross_entropy"), default="mse")
    return p


if __name__ == "__main__":
    args = build_parser().parse_args()
    if args.nprocs == 1:
        main(0, 1, args.max_epochs, args.batch_size, loss=args.loss, device=args.device)
    else:
        from pytorch_distributed_training_tutorials_tpu_torch.launch import (
            coordinator_for_spawn,
            spawn,
        )

        coordinator = coordinator_for_spawn()
        spawn(main, args.nprocs,
              args=(args.nprocs, args.max_epochs, args.batch_size, coordinator, args.loss,
                    args.device),
              coordinator=coordinator)
