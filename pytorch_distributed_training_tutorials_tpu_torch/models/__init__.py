"""Models of the PyTorch port: ``TransformerLM`` (int8 serving and float
training), its sampling pipeline, ``generate``, the ResNets and the
linear and MLP models, the weight bridge and the seeded weight
builders."""

from pytorch_distributed_training_tutorials_tpu_torch.models.convert import (
    from_jax_params,
    init_lm,
    init_params,
    init_quantized_lm,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.generate import generate
from pytorch_distributed_training_tutorials_tpu_torch.models.mlp import (
    MLP,
    LinearRegressor,
    SampleModel,
    ToyModel,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import (
    ResNet,
    resnet18,
    resnet34,
    resnet50,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    INT8_TP_RULES,
    TP_RULES,
    KVCache,
    PagedKVCache,
    TransformerConfig,
    TransformerLM,
    bind_params,
    int8_param_sharding,
    place_int8_lm_params,
    quantize_lm_params,
    tp_layout,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.utils import (
    model_flops_per_token,
    model_size,
)

__all__ = [
    "INT8_TP_RULES",
    "KVCache",
    "LinearRegressor",
    "MLP",
    "PagedKVCache",
    "ResNet",
    "SampleModel",
    "TP_RULES",
    "ToyModel",
    "TransformerConfig",
    "TransformerLM",
    "bind_params",
    "from_jax_params",
    "generate",
    "init_lm",
    "init_params",
    "init_quantized_lm",
    "int8_param_sharding",
    "model_flops_per_token",
    "model_size",
    "place_int8_lm_params",
    "quantize_lm_params",
    "resnet18",
    "resnet34",
    "resnet50",
    "tp_layout",
]
