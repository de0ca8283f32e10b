"""Continuous-batching serving for the PyTorch port: :class:`ServeEngine`
over a slot-indexed KV cache, with its own copy of the FIFO scheduler."""

from pytorch_distributed_training_tutorials_tpu_torch.serve.engine import ServeEngine
from pytorch_distributed_training_tutorials_tpu_torch.serve.scheduler import (
    Completion,
    FifoScheduler,
    QueueClosed,
    QueueFull,
    Request,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.slots import (
    SlotState,
    bucket_len,
    init_slot_state,
    write_slot,
)

__all__ = [
    "Completion",
    "FifoScheduler",
    "QueueClosed",
    "QueueFull",
    "Request",
    "ServeEngine",
    "SlotState",
    "bucket_len",
    "init_slot_state",
    "write_slot",
]
