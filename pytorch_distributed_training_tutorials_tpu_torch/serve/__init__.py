"""Continuous-batching serving for the PyTorch port: :class:`ServeEngine`
over a slot-indexed or paged KV cache, with its own copies of the FIFO
scheduler, the page pool and the radix prefix index."""

from pytorch_distributed_training_tutorials_tpu_torch.serve.engine import ServeEngine
from pytorch_distributed_training_tutorials_tpu_torch.serve.pages import (
    PagePool,
    PoolExhausted,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.prefix import (
    PrefixIndex,
    Segment,
)
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
    park_slot_paged,
    seed_history,
    upload,
    write_slot,
    write_slot_paged,
)

__all__ = [
    "Completion",
    "FifoScheduler",
    "PagePool",
    "PoolExhausted",
    "PrefixIndex",
    "QueueClosed",
    "QueueFull",
    "Request",
    "Segment",
    "ServeEngine",
    "SlotState",
    "bucket_len",
    "init_slot_state",
    "park_slot_paged",
    "seed_history",
    "upload",
    "write_slot",
    "write_slot_paged",
]
