"""Multi-tenant LoRA adapters of the PyTorch port: fine-tune -> register
-> serve.

Public surface (the JAX package's ``adapters``):

- :class:`.bank.AdapterBank` — the stacked factor bank + registry an
  engine serves from (``ServeEngine(adapter_bank=...)``);
- :func:`.bank.apply_lora` — the per-row gathered low-rank delta (run by
  ``models.transformer.LoRADelta``);
- :class:`.registry.AdapterRegistry` / :class:`.registry.RegistryFull` —
  the host-side name -> bank-row registry (admission + byte accounting);
- :func:`.lora.lora_init` / :func:`.lora.lora_param_mask` /
  :func:`.lora.extract_adapter` / :func:`.lora.merge_adapter` /
  :func:`.lora.lora_tree` — the training-side lifecycle.

The re-exports are lazy (PEP 562), as in the JAX package: importing the
registry loads nothing but the standard library.
"""

import importlib

# name -> submodule; resolved on first access via __getattr__
_LAZY_EXPORTS = {
    "AdapterBank": "pytorch_distributed_training_tutorials_tpu_torch.adapters.bank",
    "apply_lora": "pytorch_distributed_training_tutorials_tpu_torch.adapters.bank",
    "AdapterRegistry": "pytorch_distributed_training_tutorials_tpu_torch.adapters.registry",
    "RegistryFull": "pytorch_distributed_training_tutorials_tpu_torch.adapters.registry",
    "extract_adapter": "pytorch_distributed_training_tutorials_tpu_torch.adapters.lora",
    "lora_init": "pytorch_distributed_training_tutorials_tpu_torch.adapters.lora",
    "lora_param_mask": "pytorch_distributed_training_tutorials_tpu_torch.adapters.lora",
    "lora_tree": "pytorch_distributed_training_tutorials_tpu_torch.adapters.lora",
    "merge_adapter": "pytorch_distributed_training_tutorials_tpu_torch.adapters.lora",
}

__all__ = sorted(_LAZY_EXPORTS)


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
