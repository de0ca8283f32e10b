"""Parallelism of the PyTorch port: the ``torch.distributed`` runtime, the
data mesh and the data-parallel strategy. The other strategies of the JAX
package (FSDP, tensor, pipeline, ring and Ulysses attention) arrive in
later slices."""

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

__all__ = [
    "DATA_AXIS",
    "EXPERT_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "STAGE_AXIS",
    "DataParallel",
    "create_mesh",
    "init",
    "is_primary",
    "process_count",
    "process_index",
    "shutdown",
]
