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
    KVCache,
    PagedKVCache,
    TransformerConfig,
    TransformerLM,
    bind_params,
    quantize_lm_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.utils import (
    model_flops_per_token,
    model_size,
)

__all__ = [
    "KVCache",
    "LinearRegressor",
    "MLP",
    "PagedKVCache",
    "ResNet",
    "SampleModel",
    "ToyModel",
    "TransformerConfig",
    "TransformerLM",
    "bind_params",
    "from_jax_params",
    "generate",
    "init_lm",
    "init_params",
    "init_quantized_lm",
    "model_flops_per_token",
    "model_size",
    "quantize_lm_params",
    "resnet18",
    "resnet34",
    "resnet50",
]
