"""Models of the PyTorch port: ``TransformerLM`` (int8 serving and float
training), its sampling pipeline, ``generate``, the weight bridge and the
seeded weight builders."""

from pytorch_distributed_training_tutorials_tpu_torch.models.convert import (
    from_jax_params,
    init_lm,
    init_quantized_lm,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.generate import generate
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    KVCache,
    PagedKVCache,
    TransformerConfig,
    TransformerLM,
    bind_params,
    quantize_lm_params,
)

__all__ = [
    "KVCache",
    "PagedKVCache",
    "TransformerConfig",
    "TransformerLM",
    "bind_params",
    "from_jax_params",
    "generate",
    "init_lm",
    "init_quantized_lm",
    "quantize_lm_params",
]
