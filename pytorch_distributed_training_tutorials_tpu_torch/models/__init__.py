"""Models of the PyTorch port: the int8 serving ``TransformerLM``, its
sampling pipeline, ``generate`` and the weight bridge."""

from pytorch_distributed_training_tutorials_tpu_torch.models.convert import (
    from_jax_params,
    init_quantized_lm,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.generate import generate
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    KVCache,
    TransformerConfig,
    TransformerLM,
    bind_params,
    quantize_lm_params,
)

__all__ = [
    "KVCache",
    "TransformerConfig",
    "TransformerLM",
    "bind_params",
    "from_jax_params",
    "generate",
    "init_quantized_lm",
    "quantize_lm_params",
]
