"""Logging: the reference's per-epoch line, printed from rank 0 only (an
own copy of the JAX package's ``utils/logging.py``)."""

from __future__ import annotations

from pytorch_distributed_training_tutorials_tpu_torch.parallel.distributed import is_primary


def log0(msg: str) -> None:
    """Print from rank 0 only."""
    if is_primary():
        print(msg, flush=True)


def epoch_line(device_count: int, epoch: int, batch_size: int, steps: int) -> str:
    """``[Chips: N Epoch: e, Batch size: b | Steps s]``: one line for the
    whole world, ``Chips`` the number of devices the batch is split over."""
    return (f"[Chips: {device_count} Epoch: {epoch}, "
            f"Batch size: {batch_size} | Steps {steps}]")
