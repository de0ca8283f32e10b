"""Models of the PyTorch port: ``TransformerLM`` (int8 serving and float
training, dense or mixture-of-experts blocks), the MoE FFN with its
aux loss and expert-parallel rules, its sampling pipeline, ``generate``,
the ResNets and the linear and MLP models, the weight bridge (whole trees
and one leaf at a time), the streaming int8 checkpoint loader and the
seeded weight builders."""

from pytorch_distributed_training_tutorials_tpu_torch.models.convert import (
    from_jax_params,
    init_lm,
    init_params,
    init_quantized_lm,
    jax_leaf_to_port,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.generate import generate
from pytorch_distributed_training_tutorials_tpu_torch.models.moe import (
    MOE_RULES,
    MoEFFN,
    moe_aux_loss,
    moe_dropped,
)
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
    ep_rules,
    int8_param_sharding,
    load_quantized_lm,
    place_int8_lm_params,
    quantize_lm_params,
    stack_quantized_lm_params,
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
    "MOE_RULES",
    "MoEFFN",
    "PagedKVCache",
    "ResNet",
    "SampleModel",
    "TP_RULES",
    "ToyModel",
    "TransformerConfig",
    "TransformerLM",
    "bind_params",
    "ep_rules",
    "from_jax_params",
    "generate",
    "init_lm",
    "init_params",
    "init_quantized_lm",
    "int8_param_sharding",
    "jax_leaf_to_port",
    "load_quantized_lm",
    "model_flops_per_token",
    "model_size",
    "moe_aux_loss",
    "moe_dropped",
    "place_int8_lm_params",
    "quantize_lm_params",
    "resnet18",
    "resnet34",
    "resnet50",
    "stack_quantized_lm_params",
    "tp_layout",
]
