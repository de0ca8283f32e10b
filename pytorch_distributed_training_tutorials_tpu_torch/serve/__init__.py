"""Continuous-batching serving for the PyTorch port: :class:`ServeEngine`
over a slot-indexed or paged KV cache, with its own copies of the FIFO
scheduler (and its SLO tiers, :mod:`.slo`), the page pool and the radix
prefix index; the disaggregation record :class:`.scheduler.Handoff`; and
the fleet front
door over several engines, :class:`.router.FleetRouter` (with
:class:`.router.DispatchLedger` and :func:`.router.affinity_hash`),
exported lazily (PEP 562, as ``adapters/``): importing the router loads
nothing but the scheduler and the standard library. The contract sentry
every engine and router of a process may carry,
:class:`..obs.sentry.ContractSentry`, is exported here too, lazily."""

import importlib

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
    Handoff,
    QueueClosed,
    QueueFull,
    Request,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.slo import (
    PriorityScheduler,
    SwapRecord,
    choose_victim,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.slots import (
    SlotState,
    bucket_len,
    init_slot_state,
    pack,
    park_slot_paged,
    seed_history,
    unpack,
    upload,
    write_slot,
    write_slot_paged,
)

__all__ = [
    "Completion",
    "FifoScheduler",
    "Handoff",
    "PagePool",
    "PoolExhausted",
    "PrefixIndex",
    "PriorityScheduler",
    "QueueClosed",
    "QueueFull",
    "Request",
    "Segment",
    "ServeEngine",
    "SlotState",
    "SwapRecord",
    "bucket_len",
    "choose_victim",
    "init_slot_state",
    "pack",
    "park_slot_paged",
    "seed_history",
    "unpack",
    "upload",
    "write_slot",
    "write_slot_paged",
]

# name -> submodule; resolved on first access via __getattr__
_LAZY_EXPORTS = {
    "DispatchLedger": "pytorch_distributed_training_tutorials_tpu_torch.serve.router",
    "FleetRouter": "pytorch_distributed_training_tutorials_tpu_torch.serve.router",
    "affinity_hash": "pytorch_distributed_training_tutorials_tpu_torch.serve.router",
    "ContractSentry": "pytorch_distributed_training_tutorials_tpu_torch.obs.sentry",
}
__all__ += sorted(_LAZY_EXPORTS)


def __getattr__(name: str):
    try:
        module_name = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module_name), name)
    globals()[name] = value  # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY_EXPORTS))
