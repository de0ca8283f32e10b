"""Training-side LoRA: init, trainable mask, extract, merge.

Port of the JAX package's ``adapters/lora.py`` over the port's parameter
names: a state dict (or a module) whose LoRA leaves live under ``*_lora``
modules (``blocks.0.attn.q_proj_lora.lora_a``). The serving side gathers
stacked factors per slot (:mod:`.bank`); this module is the
tenant-producing side of the lifecycle: build the model with
``TransformerConfig(lora_adapters=N, lora_rank=r)`` (every projection
grows a zero ``*_lora`` sibling; the base parameters and their names are
unchanged), random-init the A factors (:func:`lora_init`), train with the
optimizer masked to the factor leaves (:func:`lora_param_mask` as the
``mask`` of ``ops.fused_optim.fused_adamw``) and every batch tagged with
the tenant's ``adapter_ids`` (``Trainer(model_kwargs=...)``), then
:func:`extract_adapter` the trained row into an
:class:`.bank.AdapterBank` entry — or :func:`merge_adapter` it into a
base-layout state dict.

Why A random and B zero: ``dL/dA`` is proportional to B and ``dL/dB`` to
``x @ A``, so zero for both is a saddle. Filling A's tenant rows (row 0
stays zero) keeps the first forward EXACTLY the base model (B is still
zero) while B has a gradient from the first step.
"""

from __future__ import annotations

import math
import zlib
from collections.abc import Mapping

import torch

LORA_SUFFIX = "_lora"


def _named(params) -> dict[str, torch.Tensor]:
    """A state dict (name -> tensor) or a module's parameters by name."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def is_lora(name: str) -> bool:
    """True for a leaf under a ``*_lora`` module."""
    return any(part.endswith(LORA_SUFFIX) for part in name.split("."))


def lora_tree(params) -> dict[str, torch.Tensor]:
    """The factor leaves of ``params`` (a state dict or a module), by name
    — the bank's layout."""
    return {k: v for k, v in _named(params).items() if is_lora(k)}


def lora_param_mask(params) -> dict[str, bool]:
    """name -> bool over ``params``: True exactly on the leaves under a
    ``*_lora`` module — the trainable set. Pass it (or this function) as
    the ``mask`` of ``fused_adamw`` so a fine-tune updates only the
    factors; the base leaves stay bitwise untouched."""
    return {k: is_lora(k) for k in _named(params)}


def _leaf_seed(seed: int, name: str) -> int:
    """The generator seed of one leaf: ``seed`` and the leaf's crc32 (the
    JAX package folds the same hash of the leaf path into its key)."""
    return int(seed) * 2**31 + (zlib.crc32(name.encode()) & 0x7FFFFFFF)


def lora_init(params, seed: int = 0, stddev: float | None = None) -> dict[str, torch.Tensor]:
    """A new state dict: every ``lora_a`` leaf's tenant rows (``1..N-1``)
    drawn normal with std ``stddev`` (default ``1 / sqrt(d_in)``) from its
    own ``torch.Generator`` on the leaf's device, seeded from ``seed`` and
    the leaf name (:func:`_leaf_seed`); row 0 (the base adapter) and every
    ``lora_b`` stay zero, and every other leaf is the caller's tensor."""
    out = {}
    for name, leaf in _named(params).items():
        if not (is_lora(name) and name.endswith(".lora_a")):
            out[name] = leaf
            continue
        gen = torch.Generator(device=leaf.device).manual_seed(_leaf_seed(seed, name))
        std = stddev if stddev is not None else 1.0 / math.sqrt(leaf.shape[-2])
        rows = torch.randn(leaf.shape, generator=gen, device=leaf.device,
                           dtype=torch.float32) * std
        rows[0] = 0.0  # the adapter axis leads: row 0 is the base model
        out[name] = rows.to(leaf.dtype)
    return out


def extract_adapter(params, aid: int) -> dict[str, torch.Tensor]:
    """Adapter ``aid``'s factor rows (each leaf loses its adapter axis:
    (N, d, r) -> (d, r)), copied: the per-adapter entry
    :meth:`.bank.AdapterBank.register` takes."""
    return {k: v.detach()[aid].clone() for k, v in lora_tree(params).items()}


def merge_adapter(params, aid: int) -> dict[str, torch.Tensor]:
    """Fold adapter ``aid``'s delta into the base weights and drop the
    factor leaves: a state dict for the LoRA-free float model. Each hooked
    projection's ``weight`` (in, out) gains ``A[aid] @ B[aid]`` in float32.

    The merged forward matches the adapter-applied one to float tolerance,
    not bitwise: ``x @ (W + A B)`` reassociates the sums of ``x @ W + (x @
    A) @ B``. Float weights only (an int8 ``qt`` has no float to fold
    into)."""
    named = _named(params)
    out = {k: v for k, v in named.items() if not is_lora(k)}
    for name, a in named.items():
        if not (is_lora(name) and name.endswith(".lora_a")):
            continue
        mod = name[: -len(".lora_a")]
        target = mod[: -len(LORA_SUFFIX)] + ".weight"
        if target not in out:
            raise ValueError(f"merge_adapter folds into float weights: {target} not in params")
        b = named[mod + ".lora_b"]
        w = out[target]
        delta = a.detach()[aid].float() @ b.detach()[aid].float()
        out[target] = (w.detach().float() + delta.reshape(w.shape)).to(w.dtype)
    return out


def _check_mapping(mask, names) -> dict[str, bool]:
    if not isinstance(mask, Mapping):
        raise TypeError(f"a mask is a name -> bool mapping or a callable, got {type(mask)}")
    missing = [n for n in names if n not in mask]
    if missing:
        raise ValueError(f"the mask names no value for {missing[:4]}"
                         + (f" and {len(missing) - 4} more" if len(missing) > 4 else ""))
    return {n: bool(mask[n]) for n in names}


def resolve_mask(mask, params) -> dict[str, bool]:
    """``mask`` over the named ``params``: a name -> bool mapping that
    covers every name, or a callable that returns one from ``params``
    (e.g. :func:`lora_param_mask`)."""
    named = _named(params)
    return _check_mapping(mask(named) if callable(mask) else mask, named)
