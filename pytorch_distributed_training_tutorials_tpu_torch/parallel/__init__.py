"""Parallelism of the PyTorch port: the ``torch.distributed`` runtime, the
mesh (``data`` and ``model`` axes), the data-parallel strategy and tensor
parallelism for serving and training (:class:`TensorParallel`). The other
strategies of the JAX package (FSDP, pipeline, ring and Ulysses
attention) arrive in later slices."""

from pytorch_distributed_training_tutorials_tpu_torch.parallel.data_parallel import DataParallel
from pytorch_distributed_training_tutorials_tpu_torch.parallel.distributed import (
    init,
    is_primary,
    process_count,
    process_index,
    shutdown,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    STAGE_AXIS,
    create_mesh,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    SLOT_STATE_RULES,
    TensorParallel,
    shard_params,
    spawn_tp,
)

__all__ = [
    "DATA_AXIS",
    "EXPERT_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "SLOT_STATE_RULES",
    "STAGE_AXIS",
    "DataParallel",
    "TensorParallel",
    "create_mesh",
    "init",
    "is_primary",
    "process_count",
    "process_index",
    "shard_params",
    "shutdown",
    "spawn_tp",
]
