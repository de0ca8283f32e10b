"""Flagship example: data-parallel ResNet-18 on MNIST (the headline
workload), the twin of the JAX package's ``examples/train_resnet_mnist.py``.

    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.train_resnet_mnist --max_epochs 2
    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.train_resnet_mnist \\
        --nprocs 2 --fsdp --ckpt /tmp/resnet_ckpt
    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.train_resnet_mnist \\
        --device cpu --max_epochs 1

The reference's two flags keep their semantics (``--batch_size`` is per
rank, ``ddp_gpus.py:101``); ``--fsdp`` shards the parameters and optimizer
state over the data axis instead of replicating them (ZeRO-3); ``--ckpt``
resumes from the checkpoint when it exists (``resumed at epoch N``) and
saves after every epoch. ResNet-18 with the cifar stem computes in
bfloat16 on the device-resident uint8 ``mnist("train", raw=True)`` set,
SGD lr ``--lr`` with momentum 0.9, and ends with ``eval: {...}`` over the
test split.

The JAX script's ``create_mesh()`` takes every chip of its process; here a
rank is one card: world 1 in-process, ``--nprocs N`` a spawned world (NCCL
with a card a rank, gloo on card 0 when N exceeds the cards).
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max_epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=32,
                   help="Input batch size on each rank (reference semantics)")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--fsdp", action="store_true",
                   help="shard params + optimizer state over data (ZeRO-3)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint dir: resume if present, save per epoch")
    p.add_argument("--nprocs", type=int, default=1,
                   help="ranks (one a card; >1: a spawned world)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    return p


def mnist(split: str):
    """The split the example trains and evaluates on (uint8 images)."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import mnist as _mnist

    return _mnist(split, raw=True)


def build(args):
    """``(trainer, test loader)`` of one rank (the world, if any, formed
    already)."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.data import DeviceResidentLoader
    from pytorch_distributed_training_tutorials_tpu_torch.models import resnet18
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import FSDP, create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, sgd

    def transform(x, y):
        return x.to(torch.bfloat16) / 255.0, y

    mesh = create_mesh(device=args.device)
    loader = DeviceResidentLoader(mnist("train"), args.batch_size, mesh, seed=0,
                                  transform=transform)
    trainer = Trainer(
        resnet18(num_classes=10, stem="cifar", dtype=torch.bfloat16, in_channels=1),
        loader, sgd(args.lr, momentum=0.9),
        strategy=FSDP(mesh) if args.fsdp else None, loss="cross_entropy",
    )
    test = DeviceResidentLoader(mnist("test"), args.batch_size, mesh, seed=0,
                                transform=transform)
    return trainer, test


def fit(trainer, args) -> tuple[int | None, dict]:
    """Resume from ``args.ckpt`` when it exists, then train to
    ``args.max_epochs``, saving after every epoch. Returns the epoch it
    resumed at (None: a fresh start) and the last epoch's metrics."""
    from pytorch_distributed_training_tutorials_tpu_torch.utils.logging import log0

    resumed_at = None
    if args.ckpt and os.path.exists(args.ckpt):
        trainer.restore(args.ckpt)
        resumed_at = trainer.epoch
        log0(f"resumed at epoch {trainer.epoch}")
    last = {}
    while trainer.epoch < args.max_epochs:
        last = trainer.train(trainer.epoch + 1)
        if args.ckpt:
            trainer.save(args.ckpt)
    return resumed_at, last


def run(args) -> dict:
    """One rank's run: :func:`build`, :func:`fit`, then evaluate. Returns
    ``resumed_at``, the last epoch's metrics, ``eval`` and the rank's
    model state on the host."""
    from pytorch_distributed_training_tutorials_tpu_torch.utils.logging import log0

    trainer, test = build(args)
    resumed_at, last = fit(trainer, args)
    metrics = trainer.evaluate(test)
    log0(f"eval: {metrics}")
    return {"resumed_at": resumed_at, "epoch": trainer.epoch, "last": last, "eval": metrics,
            "state": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}}


def _rank(world, args) -> dict:
    return run(args)


def main(argv=None) -> list[dict]:
    """Parse ``argv`` and run: in this process at ``--nprocs 1``, else in a
    spawned world. Returns every rank's :func:`run` result."""
    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.examples import run_world

    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no GPU and no --device cpu: raise before any work
    if args.nprocs == 1:
        return [run(args)]
    return run_world(_rank, args.nprocs, (args,), device=args.device)


if __name__ == "__main__":
    main()
    sys.exit(0)
