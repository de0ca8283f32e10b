"""Parallelism of the PyTorch port: the ``torch.distributed`` runtime, the
mesh (``data``, ``model`` and ``stage`` axes), the data-parallel strategy,
tensor parallelism for serving and training (:class:`TensorParallel`),
the pipelines (:class:`ManualPipeline`, :class:`GPipe`) and FSDP
(:class:`FSDP`, :class:`HybridFSDP`), checkpoints with per-leaf
placement and 8-bit load (:mod:`.auto`) and HF-layout Llama loading
(:mod:`.hf_llama`). The other strategies of the JAX package (the
single-program pipeline, ring and Ulysses attention) arrive in later
slices."""

from pytorch_distributed_training_tutorials_tpu_torch.parallel.auto import (
    LeafMeta,
    Shard,
    audit_placement,
    checkpoint_leaf_metadata,
    load_quantized,
    load_sharded,
    restore_checkpoint,
    restore_leaf,
    save_checkpoint,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.data_parallel import DataParallel
from pytorch_distributed_training_tutorials_tpu_torch.parallel.distributed import (
    init,
    is_primary,
    process_count,
    process_index,
    shutdown,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.fsdp import (
    FSDP,
    HybridFSDP,
    shard_dim_for,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.hf_llama import (
    HFCheckpoint,
    SafetensorsFile,
    config_from_hf,
    load_hf_llama,
    save_safetensors,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    STAGE_AXIS,
    StageMesh,
    create_mesh,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.pipeline import (
    GPipe,
    ManualPipeline,
    partition_variables,
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
    "FSDP",
    "GPipe",
    "HFCheckpoint",
    "HybridFSDP",
    "LeafMeta",
    "ManualPipeline",
    "SafetensorsFile",
    "Shard",
    "StageMesh",
    "TensorParallel",
    "audit_placement",
    "checkpoint_leaf_metadata",
    "config_from_hf",
    "create_mesh",
    "init",
    "is_primary",
    "load_hf_llama",
    "load_quantized",
    "load_sharded",
    "partition_variables",
    "process_count",
    "process_index",
    "restore_checkpoint",
    "restore_leaf",
    "save_checkpoint",
    "save_safetensors",
    "shard_dim_for",
    "shard_params",
    "shutdown",
    "spawn_tp",
]
