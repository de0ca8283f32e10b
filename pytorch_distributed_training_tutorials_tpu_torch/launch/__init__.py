"""Launchers of the PyTorch port: :func:`spawn` (the ``mp.spawn`` twin,
explicit or environment rendezvous, gang restarts) and the two DDP
training CLIs, ``launch.train_ddp`` (spawn contract) and
``launch.train_ddp_env`` (torchrun contract). The pod launcher arrives in
a later slice."""

from pytorch_distributed_training_tutorials_tpu_torch.launch._spawn import (
    coordinator_for_spawn,
    pick_unused_port,
    spawn,
)

__all__ = ["coordinator_for_spawn", "pick_unused_port", "spawn"]
