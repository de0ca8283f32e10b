"""The weight bridge: JAX param trees -> the port's parameters, and the
seeded on-device builders of random weights (:func:`init_quantized_lm`
for int8 serving, :func:`init_lm` for training, :func:`init_params` for
the ResNets and MLPs).

Given a ``torch.nn.Module`` (a ResNet or an MLP of :mod:`.resnet` /
:mod:`.mlp`) in place of a ``TransformerConfig``, :func:`from_jax_params`
takes the Conv and NHWC leg: a Conv kernel HWIO becomes OIHW, a Dense
kernel (in, out) becomes (out, in), BatchNorm ``scale`` and ``bias`` are
parameters and the ``batch_stats`` collection's ``mean`` and ``var`` the
norms' buffers; flax's module names map to the port's nesting
(``layer_groups_i_j`` -> ``layer_groups.i.j``, ``Conv_k`` / ``BatchNorm_k``
/ ``Dense_k`` -> ``convs.k`` / ``norms.k`` / ``denses.k``).

:func:`from_jax_params` takes the JAX tree as nested dicts of numpy arrays
(a caller holding jax arrays converts them on its side, e.g.
``jax.tree_util.tree_map(np.asarray, params)``; the port never sees a jax
object) and returns a state dict for :class:`.transformer.TransformerLM`.
Float trees and ``quantize_lm_params`` trees, unrolled (``block_i/...``)
and stacked (``layers/block/...``, leading layer axis) layouts all give
the same port weights. For ``cfg.quantized`` a float tree is quantized
here, and int8 weights are converted once to the layout the CUDA kernel
reads: ``q`` (K, N) is stored as ``qt`` (N, K), K-contiguous. For a float
``cfg`` the tree stays float: each kernel — (in, out) for ``nn.Dense``,
(d_model, H, D) for q/k/v, (H, D, d_model) for o_proj — becomes a
``weight`` (K, N), its input axes flattened into K and its output axes
into N. A LoRA model's ``*_lora`` subtrees (``lora_a`` (N, d_in, r),
``lora_b`` (N, r, d_out), a leading L axis when stacked) carry across in
the JAX layout, float32 for int8 and float weights alike;
:func:`adapter_from_jax` converts one adapter's rows (the JAX
``extract_adapter`` output) for ``AdapterBank.register``.

A tensor-parallel ``cfg`` (``cfg.int8_mesh`` over ``tp`` ranks) gets the
rank's shard: the whole tree is converted (or, by the seeded builders,
drawn) as for the unsharded config, then cut by
:func:`..parallel.tensor_parallel.shard_params` — each shard a copy, so
the whole tree is freed when the call returns — and the builders' random
weights are the unsharded ones' blocks, whatever ``tp``.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import numpy as np
import torch

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    _QUANTIZED_KERNELS,
    Dense,
    LoRADelta,
    TransformerConfig,
    TransformerLM,
    quantize_lm_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import (
    Int8Linear,
    quantize_int8,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    shard_params,
)

# port module path inside a block -> the JAX subtree path
_BLOCK_LEAVES = {
    "attn_norm": ("attn_norm",),
    "attn.q_proj": ("attn", "q_proj"),
    "attn.k_proj": ("attn", "k_proj"),
    "attn.v_proj": ("attn", "v_proj"),
    "attn.o_proj": ("attn", "o_proj"),
    "mlp_norm": ("mlp_norm",),
    "mlp.gate_proj": ("mlp", "gate_proj"),
    "mlp.up_proj": ("mlp", "up_proj"),
    "mlp.down_proj": ("mlp", "down_proj"),
}
# the LoRA siblings of a block (cfg.lora_adapters > 0), the same way
_LORA_LEAVES = {f"{k}_lora": (*v[:-1], f"{v[-1]}_lora")
                for k, v in _BLOCK_LEAVES.items() if not k.endswith("_norm")}


def _to_torch(tree, device):
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def _unstack(tree: dict, n_layers: int) -> dict:
    """``layers/block/...`` (leading L axis) -> ``block_i/...``."""
    if "layers" not in tree:
        return tree
    stacked = tree["layers"]["block"]

    def take(sub, i):
        if isinstance(sub, Mapping):
            return {k: take(v, i) for k, v in sub.items()}
        return sub[i]

    out = {k: v for k, v in tree.items() if k != "layers"}
    for i in range(n_layers):
        out[f"block_{i}"] = take(stacked, i)
    return out


def _is_float_tree(tree) -> bool:
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            if name in _QUANTIZED_KERNELS and "kernel" in sub:
                return True
            if _is_float_tree(sub):
                return True
    return False


def _int8_leaves(prefix: str, name: str, sub: Mapping) -> dict:
    return {
        f"{prefix}.qt": sub["q"].t().contiguous(),
        f"{prefix}.scale": sub["scale"].reshape(1, -1).float().contiguous(),
    }


def _float_leaves(prefix: str, name: str, sub: Mapping) -> dict:
    kern = sub["kernel"].float()
    if name == "o_proj":  # (H, D, d_model): both leading axes contract
        w = kern.reshape(-1, kern.shape[-1])
    else:  # (in, out...) : the first axis contracts
        w = kern.reshape(kern.shape[0], -1)
    return {f"{prefix}.weight": w.contiguous()}


def from_jax_params(tree, cfg: TransformerConfig | torch.nn.Module, device=None, *,
                    batch_stats=None) -> dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of numpy arrays) -> the port's state
    dict on ``device`` (``cuda`` unless the caller passes another). For an
    int8 ``cfg`` a float tree is quantized here, per layer, bitwise the JAX
    quantizer; for a float ``cfg`` the tree must be float and stays so.
    With a module in place of ``cfg``, the Conv/Dense leg (module
    docstring); ``batch_stats`` is the JAX ``batch_stats`` collection."""
    dev = resolve_device(device)
    if isinstance(cfg, torch.nn.Module):
        return _module_state_dict(tree, batch_stats, cfg, dev)
    if cfg.int8_mesh is not None:
        return _shard_for(cfg, from_jax_params(tree, _whole(cfg), dev))
    t = _unstack(_to_torch(dict(tree), dev), cfg.n_layers)
    is_float = _is_float_tree(t)
    if cfg.quantized and is_float:
        t = quantize_lm_params(t)
    elif not cfg.quantized and not is_float:
        raise ValueError(
            "a quantized param tree cannot load into a float "
            "TransformerConfig(quantized=False)"
        )
    leaves = _int8_leaves if cfg.quantized else _float_leaves
    out = {"tok_emb.weight": t["tok_emb"]["embedding"].float().contiguous()}
    for i in range(cfg.n_layers):
        blk = t[f"block_{i}"]
        for port_name, path in _BLOCK_LEAVES.items():
            sub = blk
            for key in path:
                sub = sub[key]
            prefix = f"blocks.{i}.{port_name}"
            if path[-1].endswith("_norm"):
                out[f"{prefix}.scale"] = sub["scale"].float().contiguous()
            else:
                out.update(leaves(prefix, path[-1], sub))
        if cfg.lora_adapters:
            out.update(_lora_rows(blk, i))
    out["final_norm.scale"] = t["final_norm"]["scale"].float().contiguous()
    out.update(leaves("lm_head", "lm_head", t["lm_head"]))
    _check_schema(out, cfg)
    return out


def _whole(cfg: TransformerConfig) -> TransformerConfig:
    """``cfg`` without its tensor-parallel strategy: the whole model."""
    return dataclasses.replace(cfg, int8_mesh=None)


def _shard_for(cfg: TransformerConfig, params: dict) -> dict[str, torch.Tensor]:
    """The rank of ``cfg.int8_mesh``'s shard of a whole state dict,
    checked against the sharded model's schema."""
    tp = cfg.int8_mesh
    out = shard_params(params, tp.rank, tp.tp_size, head_dim=cfg.head_dim)
    _check_schema(out, cfg)
    return out


def _lora_rows(blk: Mapping, i: int) -> dict[str, torch.Tensor]:
    """Block ``i``'s ``*_lora`` factor leaves under the port's names."""
    out = {}
    for port_name, path in _LORA_LEAVES.items():
        sub = blk
        for key in path:
            sub = sub[key]
        for leaf in ("lora_a", "lora_b"):
            out[f"blocks.{i}.{port_name}.{leaf}"] = sub[leaf].float().contiguous()
    return out


def adapter_from_jax(row, cfg: TransformerConfig, device=None) -> dict[str, torch.Tensor]:
    """One adapter's factor rows from the JAX package (``extract_adapter``:
    nested dicts of numpy arrays, ``block_i/...`` or stacked
    ``layers/block/...``, each leaf without the adapter axis) -> the
    name -> tensor rows :meth:`..adapters.bank.AdapterBank.register`
    takes, on ``device`` (``cuda`` unless the caller passes another)."""
    t = _unstack(_to_torch(dict(row), resolve_device(device)), cfg.n_layers)
    out = {}
    for i in range(cfg.n_layers):
        out.update(_lora_rows(t[f"block_{i}"], i))
    return out


def _check_schema(params: dict, cfg: TransformerConfig) -> None:
    want = TransformerLM(cfg).state_dict()
    if set(want) != set(params):
        missing = sorted(set(want) - set(params))
        extra = sorted(set(params) - set(want))
        raise ValueError(f"param tree mismatch: missing {missing}, unexpected {extra}")
    for name, ref in want.items():
        got = params[name]
        if tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype:
            raise ValueError(
                f"{name}: got {tuple(got.shape)} {got.dtype}, the config "
                f"needs {tuple(ref.shape)} {ref.dtype}"
            )


def init_quantized_lm(cfg: TransformerConfig, seed: int = 0,
                      device=None) -> dict[str, torch.Tensor]:
    """Random int8 serving weights for ``cfg`` built on ``device`` (``cuda``
    unless the caller passes another): every leaf drawn from one seeded
    ``torch.Generator`` as ``standard_normal * 0.02`` (the recipe of the JAX
    package's ``examples/serve_llm_int8.py`` synthetic checkpoint), each
    matmul kernel quantized the moment it is drawn, so the float model is
    never resident. A tensor-parallel ``cfg`` gets the rank's shard of the
    unsharded draw."""
    dev = resolve_device(device)
    if cfg.int8_mesh is not None:
        return _shard_for(cfg, init_quantized_lm(_whole(cfg), seed, dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = TransformerLM(cfg)  # meta: the schema only
    out: dict[str, torch.Tensor] = {}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, LoRADelta):  # zero factors, no draw
            out.update(_zero_lora(mod_name, mod, dev))
        elif isinstance(mod, Int8Linear):
            n, k = mod.qt.shape
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            qp = quantize_int8(w)
            del w
            out[f"{mod_name}.qt"] = qp.q.t().contiguous()
            out[f"{mod_name}.scale"] = qp.scale.reshape(1, -1)
        else:
            for p_name, p in mod.named_parameters(recurse=False):
                out[f"{mod_name}.{p_name}"] = (
                    torch.randn(p.shape, generator=gen, device=dev) * 0.02
                )
    return out


def _zero_lora(mod_name: str, mod: LoRADelta, dev) -> dict[str, torch.Tensor]:
    """A LoRA sibling's factors: zeros (row 0 is the base model, the rest
    wait for a bank row or ``adapters.lora.lora_init``)."""
    return {f"{mod_name}.{n}": torch.zeros(p.shape, dtype=torch.float32, device=dev)
            for n, p in mod.named_parameters()}


def _truncated_normal_(w: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    """flax's ``truncated_normal`` variance scaling: a normal truncated to
    two standard deviations, its scale divided by the truncated
    distribution's std (0.8796...) so the variance is ``std ** 2``."""
    s = std / 0.87962566103423978
    return torch.nn.init.trunc_normal_(w, 0.0, s, -2.0 * s, 2.0 * s, generator=gen)


def init_lm(cfg: TransformerConfig, seed: int = 0, device=None) -> dict[str, torch.Tensor]:
    """Random float training weights for ``cfg`` built on ``device``
    (``cuda`` unless the caller passes another), every leaf drawn from one
    seeded ``torch.Generator`` with the distributions of the flax
    initializers the JAX model uses: projections ``lecun_normal`` (a
    truncated normal of variance 1 / fan_in; o_proj's fan_in is H * D),
    the embedding normal with variance 1 / d_model, norm scales ones. The
    draws differ from JAX's (another generator); the distributions are
    the same. A tensor-parallel ``cfg`` gets the rank's shard of the
    unsharded draw."""
    if cfg.quantized:
        raise ValueError("init_lm builds float weights; use init_quantized_lm for int8")
    dev = resolve_device(device)
    if cfg.int8_mesh is not None:
        return _shard_for(cfg, init_lm(_whole(cfg), seed, dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = TransformerLM(cfg)  # meta: the schema only
    out: dict[str, torch.Tensor] = {}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, LoRADelta):  # zero factors, no draw
            out.update(_zero_lora(mod_name, mod, dev))
            continue
        for p_name, p in mod.named_parameters(recurse=False):
            w = torch.empty(p.shape, dtype=torch.float32, device=dev)
            if isinstance(mod, Dense):
                _truncated_normal_(w, math.sqrt(1.0 / p.shape[0]), gen)
            elif isinstance(mod, torch.nn.Embedding):
                w.normal_(0.0, math.sqrt(1.0 / cfg.d_model), generator=gen)
            else:  # RMSNorm scale
                w.fill_(1.0)
            out[f"{mod_name}.{p_name}"] = w
    return out


# port container name -> the flax auto-name prefix of its children
_FLAX_LISTS = {"convs": "Conv", "norms": "BatchNorm", "denses": "Dense"}


def _flax_path(module_path: list[str]) -> list[str]:
    """The port's module path (state-dict key parts) -> the flax one."""
    out, i = [], 0
    while i < len(module_path):
        part = module_path[i]
        if part == "layer_groups":
            out.append(f"layer_groups_{module_path[i + 1]}_{module_path[i + 2]}")
            i += 3
        elif part in _FLAX_LISTS:
            out.append(f"{_FLAX_LISTS[part]}_{module_path[i + 1]}")
            i += 2
        else:
            out.append(part)
            i += 1
    return out


def _module_state_dict(params, batch_stats, model: torch.nn.Module,
                       dev: torch.device) -> dict[str, torch.Tensor]:
    want = model.state_dict()
    out = {}
    for key, ref in want.items():
        *mods, leaf = key.split(".")
        path = _flax_path(mods)
        tree = batch_stats if leaf in ("mean", "var") else params
        if tree is None:
            raise ValueError(f"{key}: the JAX batch_stats collection is needed")
        sub = tree
        for name in path:
            sub = sub[name]
        x = np.asarray(sub["kernel" if leaf == "weight" else leaf], dtype=np.float32)
        if leaf == "weight" and x.ndim == 4:  # conv HWIO -> OIHW
            x = x.transpose(3, 2, 0, 1)
        elif leaf == "weight":  # dense (in, out) -> (out, in)
            x = x.T
        if tuple(x.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: got {tuple(x.shape)}, the model needs {tuple(ref.shape)}")
        out[key] = torch.tensor(np.ascontiguousarray(x), device=dev)
    return out


def init_params(model: torch.nn.Module, seed: int = 0, device=None) -> dict[str, torch.Tensor]:
    """Random weights for a ResNet or MLP of the port, as a state dict on
    ``device`` (``cuda`` unless the caller passes another), drawn from one
    seeded ``torch.Generator`` with the distributions of the flax
    initializers the JAX models use: conv and dense kernels
    ``lecun_normal`` (a truncated normal of variance 1 / fan_in, fan_in
    the kernel's input width times its window), biases zeros, BatchNorm
    scale ones, bias zeros, running mean zeros and variance ones. The
    draws differ from JAX's; the distributions are the same."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: dict[str, torch.Tensor] = {}
    for key, ref in model.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        w = torch.empty(ref.shape, dtype=torch.float32, device=dev)
        if leaf == "weight":
            _truncated_normal_(w, math.sqrt(1.0 / (ref[0].numel())), gen)
        elif leaf in ("scale", "var"):
            w.fill_(1.0)
        else:  # bias, mean
            w.zero_()
        out[key] = w
    return out
