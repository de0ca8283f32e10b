"""Launchers of the PyTorch port: :func:`spawn` (the ``mp.spawn`` twin,
explicit or environment rendezvous, gang restarts) and the two DDP
training CLIs, ``launch.train_ddp`` (spawn contract) and
``launch.train_ddp_env`` (torchrun contract), and the multi-host contract
(:func:`launch_pod`, :func:`pod_run_command`: one ``torchrun`` a host)."""

from pytorch_distributed_training_tutorials_tpu_torch.launch._spawn import (
    coordinator_for_spawn,
    pick_unused_port,
    spawn,
    world_backend,
)
from pytorch_distributed_training_tutorials_tpu_torch.launch.pod import launch_pod, pod_run_command

__all__ = ["coordinator_for_spawn", "launch_pod", "pick_unused_port", "pod_run_command", "spawn",
           "world_backend"]
