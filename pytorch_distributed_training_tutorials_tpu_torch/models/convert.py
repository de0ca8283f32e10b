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
or tensors (a caller holding jax arrays converts them on its side, e.g.
``jax.tree_util.tree_map(np.asarray, params)``; the port never sees a jax
object) and returns a state dict for :class:`.transformer.TransformerLM`,
converting leaf by leaf through :func:`jax_leaf_to_port` — the one
per-leaf bridge, which the streaming loaders
(:func:`.transformer.load_quantized_lm`,
:func:`..parallel.hf_llama.load_hf_llama`) call on each leaf as it is
read, so a streamed load gives this function's bits.
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

import numpy as np
import torch

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
from pytorch_distributed_training_tutorials_tpu_torch.models.moe import MOE_RULES, MoEFFN
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    _QUANTIZED_KERNELS,
    Dense,
    LoRADelta,
    TransformerConfig,
    TransformerLM,
    _quantize_kernel,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import (
    Int8Linear,
    quantize_int8,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.auto import tree_leaves
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
# the top-level subtrees outside the blocks
_TOP = ("tok_emb", "final_norm", "lm_head")
# an MoE block's FFN leaves (``block_i/moe/...``), in the JAX layout
_MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


def jax_leaf_to_port(path, leaf: torch.Tensor, *, quantized: bool,
                     lora: bool = False) -> dict[str, torch.Tensor]:
    """The weight bridge for ONE leaf of a JAX ``TransformerLM`` param
    tree: its key path (``("block_3", "attn", "q_proj", "kernel")``, or
    stacked ``("layers", "block", ...)`` with a leading layer axis) and
    its values, a tensor the caller hands over on the target device ->
    the port's state-dict entries it makes (one a layer for a stacked
    leaf). A float ``kernel`` becomes, for ``quantized``, ``qt`` (N, K)
    K-contiguous and its ``scale`` (1, N) (quantized per layer, bitwise
    the JAX quantizer), else the float ``weight`` (K, N); an int8 ``q`` /
    ``scale`` pair (a ``quantize_lm_params`` tree) converts to the same
    layout and refuses a float model. Embedding, norm scales and, with
    ``lora``, the ``*_lora`` factors pass through as float32. A leaf that
    is not the model's gives nothing. :func:`from_jax_params` and every
    streaming loader (:func:`..models.transformer.load_quantized_lm`,
    :func:`..parallel.hf_llama.load_hf_llama`) convert through here, so a
    streamed load gives the whole-tree bridge's bits."""
    path = tuple(str(p) for p in path)
    if path[:2] == ("layers", "block"):
        out = {}
        for i in range(leaf.shape[0]):
            out.update(jax_leaf_to_port((f"block_{i}", *path[2:]), leaf[i].clone(),
                                        quantized=quantized, lora=lora))
        return out
    *parents, name = path
    if not parents:
        return {}
    if parents[0].startswith("block_"):
        prefix = ".".join(["blocks", parents[0][len("block_"):], *parents[1:]])
    elif parents[0] in _TOP and len(parents) == 1:
        prefix = parents[0]
    else:
        return {}
    owner = parents[-1]
    if owner.endswith("_lora"):
        return {f"{prefix}.{name}": leaf.float().contiguous()} if lora else {}
    if owner == "moe" and name in _MOE_LEAVES:
        if quantized:
            raise ValueError("quantized serving supports dense blocks only (no MoE)")
        return {f"{prefix}.{name}": leaf.float().contiguous()}
    if owner == "tok_emb" and name == "embedding":
        return {"tok_emb.weight": leaf.float().contiguous()}
    if owner.endswith("_norm") and name == "scale":
        return {f"{prefix}.scale": leaf.float().contiguous()}
    if owner not in _QUANTIZED_KERNELS or name not in ("kernel", "q", "scale"):
        return {}
    if name == "kernel" and not quantized:
        kern = leaf.float()
        if owner == "o_proj":  # (H, D, d_model): both leading axes contract
            w = kern.reshape(-1, kern.shape[-1])
        else:  # (in, out...) : the first axis contracts
            w = kern.reshape(kern.shape[0], -1)
        return {f"{prefix}.weight": w.contiguous()}
    if not quantized:
        raise ValueError(
            "a quantized param tree cannot load into a float "
            "TransformerConfig(quantized=False)"
        )
    if name == "kernel":
        part = _quantize_kernel(owner, leaf)
        return {f"{prefix}.qt": part["q"].t().contiguous(),
                f"{prefix}.scale": part["scale"].reshape(1, -1).float().contiguous()}
    if name == "q":
        return {f"{prefix}.qt": leaf.t().contiguous()}
    return {f"{prefix}.scale": leaf.reshape(1, -1).float().contiguous()}


def _owned_on(x, dev: torch.device) -> torch.Tensor:
    """``x`` (a tensor or array) as a new tensor on ``dev``: the bridge
    may hand it back as an entry, never the caller's own memory."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, copy=True)
    return torch.tensor(np.asarray(x), device=dev)


def from_jax_params(tree, cfg: TransformerConfig | torch.nn.Module, device=None, *,
                    batch_stats=None) -> dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of numpy arrays or tensors) -> the
    port's state dict on ``device`` (``cuda`` unless the caller passes
    another), leaf by leaf through :func:`jax_leaf_to_port`. For an int8
    ``cfg`` a float tree is quantized here, per layer, bitwise the JAX
    quantizer; for a float ``cfg`` the tree must be float and stays so.
    With a module in place of ``cfg``, the Conv/Dense leg (module
    docstring); ``batch_stats`` is the JAX ``batch_stats`` collection."""
    dev = resolve_device(device)
    if isinstance(cfg, torch.nn.Module):
        return _module_state_dict(tree, batch_stats, cfg, dev)
    if cfg.int8_mesh is not None:
        return _shard_for(cfg, from_jax_params(tree, _whole(cfg), dev))
    out = {}
    for path, leaf in tree_leaves(tree):
        out.update(jax_leaf_to_port(path, _owned_on(leaf, dev), quantized=cfg.quantized,
                                    lora=bool(cfg.lora_adapters)))
    return _check_schema(out, cfg)


def _whole(cfg: TransformerConfig) -> TransformerConfig:
    """``cfg`` without its tensor-parallel strategy: the whole model."""
    return dataclasses.replace(cfg, int8_mesh=None)


def _shard_for(cfg: TransformerConfig, params: dict) -> dict[str, torch.Tensor]:
    """The rank of ``cfg.int8_mesh``'s shard of a whole state dict — its
    tensor-parallel shard, then under expert parallelism its dim-0 block
    of the stacked experts (:data:`.moe.MOE_RULES`) — checked against the
    sharded model's schema."""
    tp = cfg.int8_mesh
    out = shard_params(params, tp.rank, tp.tp_size, head_dim=cfg.head_dim)
    if tp.ep_size > 1:
        out = shard_params(out, tp.ep_rank, tp.ep_size, head_dim=1, rules=MOE_RULES)
    return _check_schema(out, cfg)


def adapter_from_jax(row, cfg: TransformerConfig, device=None) -> dict[str, torch.Tensor]:
    """One adapter's factor rows from the JAX package (``extract_adapter``:
    nested dicts of numpy arrays, ``block_i/...`` or stacked
    ``layers/block/...``, each leaf without the adapter axis) -> the
    name -> tensor rows :meth:`..adapters.bank.AdapterBank.register`
    takes, on ``device`` (``cuda`` unless the caller passes another)."""
    dev = resolve_device(device)
    out = {}
    for path, leaf in tree_leaves(row):
        if str(path[-2]).endswith("_lora"):
            out.update(jax_leaf_to_port(path, _owned_on(leaf, dev), quantized=cfg.quantized,
                                        lora=True))
    return out


def _check_schema(params: dict, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """``params`` in the model's order, after checking it holds exactly
    the model's names, shapes and dtypes."""
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
    return {name: params[name] for name in want}


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
    truncated normal of variance 1 / fan_in; o_proj's fan_in is H * D;
    an MoE block's router d and its stacked experts' E * in, flax's fan_in
    of an (E, in, out) kernel), the embedding normal with variance 1 / d_model, norm scales ones. The
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
            elif isinstance(mod, MoEFFN):
                # flax's fan_in of a stacked (E, in, out) kernel is E * in
                _truncated_normal_(w, math.sqrt(p.shape[-1] / p.numel()), gen)
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
