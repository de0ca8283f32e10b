"""Stacked LoRA adapter bank: many tenants, one set of forwards.

Port of the JAX package's ``adapters/bank.py``. The whole bank is ONE set
of stacked factors — ``lora_a`` (n_adapters, d_in, rank) and ``lora_b``
(n_adapters, rank, d_out) for every hooked projection of every layer,
named as the LoRA model's parameters (``blocks.3.mlp.up_proj_lora.lora_a``)
— gathered per batch row by :func:`apply_lora` inside each forward.
``n_adapters`` and ``rank`` size the tensors; the adapter id is DATA (a
device vector), so tenants with different adapters share one batch, and
registering or evicting a tenant is a row write into the same tensors —
the weights' counterpart of the slot-indexed KV cache.

:class:`AdapterBank` pairs the factors with the host-side
:class:`.registry.AdapterRegistry` (name -> row, byte accounting,
explicit eviction). The bank OWNS the factor tensors; a serving engine
binds its LoRA model to them with no copy (``ServeEngine(adapter_bank=)``),
so a register or an evict is seen by the next forward. Rows are written
in place on the current stream: a chain already queued keeps its order,
and a host row goes up pinned and non-blocking (a copy from pageable
memory would synchronize the stream).
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch

from pytorch_distributed_training_tutorials_tpu_torch.adapters.registry import (
    AdapterRegistry,
)


def apply_lora(x, a, b, adapter_ids, dtype=None):
    """Per-row low-rank delta ``(x @ A[id]) @ B[id]``.

    ``x`` (B, S, d_in); ``a`` (N, d_in, r); ``b`` (N, r, d_out);
    ``adapter_ids`` an int or a 0-dim or (B,) int tensor on x's device.
    Each row's factors are gathered with ``index_select`` — the id is data,
    never a host branch — and the two products are ``torch.bmm``. Row 0
    and unregistered rows are zero, so their delta is an exact 0.0.
    ``dtype`` (flax's ``dtype=``): x and the gathered factors cast to it
    before the products."""
    if isinstance(adapter_ids, int):
        adapter_ids = torch.full((x.shape[0],), adapter_ids, dtype=torch.int32, device=x.device)
    elif adapter_ids.ndim == 0:
        adapter_ids = adapter_ids.expand(x.shape[0])
    ai = a.index_select(0, adapter_ids)  # (B, d_in, r)
    bi = b.index_select(0, adapter_ids)  # (B, r, d_out)
    if dtype is not None:
        x, ai, bi = x.to(dtype), ai.to(dtype), bi.to(dtype)
    return torch.bmm(torch.bmm(x, ai), bi)


class AdapterBank:
    """The tenant bank an engine serves from: stacked factors + registry.

    ``model`` is the BASE model (``cfg.lora_adapters == 0``, or a LoRA
    model of the same ``n_adapters`` and ``rank``); :attr:`model` is its
    LoRA twin (structure only, on the meta device), whose parameter names
    the factors take. The factors are float32 zeros on ``device`` (``cuda``
    unless the caller passes another): every tenant id resolves to the
    base model until registered."""

    def __init__(self, model, n_adapters: int, rank: int, byte_budget: int = 0,
                 device=None):
        from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
        from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
            TransformerLM,
        )

        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        cfg = model.cfg
        if cfg.lora_adapters and (cfg.lora_adapters, cfg.lora_rank) != (n_adapters, rank):
            raise ValueError(
                f"model already has LoRA config ({cfg.lora_adapters}, {cfg.lora_rank}) "
                f"!= ({n_adapters}, {rank})"
            )
        self.model = TransformerLM(dataclasses.replace(cfg, lora_adapters=n_adapters,
                                                       lora_rank=rank))
        self.n_adapters = int(n_adapters)
        self.rank = int(rank)
        self.device = resolve_device(device)
        self.registry = AdapterRegistry(n_adapters, byte_budget)
        # bumped whenever a register or an evict writes the factors
        self.version = 0
        self.factors: dict[str, torch.Tensor] = {
            name: torch.zeros(p.shape, dtype=torch.float32, device=self.device)
            for name, p in self.model.named_parameters() if ".lora_" in name
        }
        # per-adapter resident bytes, from shapes alone (no device fetch)
        self.adapter_nbytes = sum(
            math.prod(t.shape) * t.element_size() for t in self.factors.values()
        ) // self.n_adapters

    def _rows(self, factors: Mapping) -> dict[str, torch.Tensor]:
        """``factors`` checked against the bank (every name, each row's
        shape) and put on the bank's device: a CPU row pinned, then copied
        non-blocking."""
        if set(factors) != set(self.factors):
            missing = sorted(set(self.factors) - set(factors))
            extra = sorted(set(factors) - set(self.factors))
            raise ValueError(f"factor names differ: missing {missing[:3]}, unexpected {extra[:3]}")
        out = {}
        for name, row in factors.items():
            want = tuple(self.factors[name].shape[1:])
            row = torch.as_tensor(row)
            if tuple(row.shape) != want:
                raise ValueError(f"{name}: factor shape {tuple(row.shape)} != expected {want}")
            row = row.to(torch.float32)
            if row.device != self.device:
                if self.device.type == "cuda" and row.device.type == "cpu":
                    row = row.contiguous().pin_memory()
                row = row.to(self.device, non_blocking=True)
            out[name] = row
        return out

    def register(self, name: str, factors: Mapping) -> int:
        """Admit ``name`` with its per-adapter factors (name -> (d, r) or
        (r, d), :func:`.lora.extract_adapter`'s output) and write them into
        the row the registry grants, in place on the current stream.
        Raises ``RegistryFull`` / ``ValueError`` synchronously; a bad row
        rolls the grant back."""
        aid = self.registry.register(name, self.adapter_nbytes)
        try:
            rows = self._rows(factors)
        except (ValueError, TypeError):
            self.registry.evict(name)  # roll back the row grant
            raise
        for key, row in rows.items():
            self.factors[key][aid].copy_(row)
        self.version += 1
        return aid

    def evict(self, name: str) -> int:
        """Free ``name``'s row and zero its factors in place (requests
        that still carry the id decode as the base model)."""
        aid = self.registry.evict(name)
        for t in self.factors.values():
            t[aid].zero_()
        self.version += 1
        return aid

    def row_zeros(self) -> dict[str, torch.Tensor]:
        """A zeroed per-adapter factor set in :meth:`register`'s shapes,
        on the host: the template a synthetic tenant fills in."""
        return {k: torch.zeros(t.shape[1:], dtype=torch.float32) for k, t in self.factors.items()}

    def generation(self, aid: int) -> int:
        """Tenant incarnation of row ``aid``
        (:meth:`.registry.AdapterRegistry.generation`): the engine folds it
        into prefix-cache keys and re-checks it at refill, so a recycled
        row never serves or splices a previous tenant's state."""
        return self.registry.generation(int(aid))

    def check_id(self, aid: int) -> int:
        """Admission check of ``Request.adapter``: 0 (base) is always
        valid; any other id must be a live registered row."""
        aid = int(aid)
        if not 0 <= aid < self.n_adapters:
            raise ValueError(f"adapter id {aid} out of range [0, {self.n_adapters})")
        if not self.registry.is_live(aid):
            raise ValueError(f"adapter id {aid} is not registered")
        return aid

    def stats(self) -> dict:
        return {
            **self.registry.stats(),
            "lora_rank": self.rank,
            "adapter_nbytes": self.adapter_nbytes,
        }
