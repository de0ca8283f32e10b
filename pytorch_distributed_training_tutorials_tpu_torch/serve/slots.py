"""Slot-indexed decode state: the device side of continuous batching.

Port of the JAX package's ``serve/slots.py`` core. The engine serves
``n_slots`` concurrent requests out of ONE fixed-shape state whose batch
axis is the slot axis; a finished slot is refilled in place by a prefill
into that slot and a per-slot position reset.

- :func:`bucket_len` — prompt-length buckets (powers of two, floor 8,
  capped at the window);
- :func:`init_slot_state` — the zeroed :class:`SlotState`;
- :func:`write_slot` — reset one slot's counters after its prefill.
"""

from __future__ import annotations

import dataclasses

import torch

from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    KVCache,
    TransformerConfig,
)


def bucket_len(p_len: int, window: int, floor: int = 8) -> int:
    """Prefill length for a ``p_len``-token prompt: the next power of two
    >= ``p_len`` (>= ``floor``), capped at the serving window. Prompts are
    right-padded to the bucket; causal attention makes positions ``[0,
    p_len)`` independent of the padding, and the next-token logits are
    gathered at ``p_len - 1``, so bucketing never changes results."""
    if p_len < 1:
        raise ValueError("p_len must be >= 1")
    b = floor
    while b < p_len:
        b *= 2
    return min(b, window)


@dataclasses.dataclass
class SlotState:
    """The engine's device state, one row per slot:

    - ``cache`` — the :class:`..models.transformer.KVCache` over the whole
      window, with a per-slot position ``cache.index``;
    - ``last_tok`` (S,) int64 — each slot's most recent token, the next
      decode input;
    - ``remaining`` (S,) int64 — tokens still to generate; 0 = free or
      parked (the active mask is ``remaining > 0``);
    - ``generators`` — one ``torch.Generator`` per slot, reseeded from
      ``Request.seed`` at refill."""

    cache: KVCache
    last_tok: torch.Tensor
    remaining: torch.Tensor
    generators: list[torch.Generator]


def init_slot_state(cfg: TransformerConfig, n_slots: int, device) -> SlotState:
    """Zeroed state for ``n_slots`` concurrent requests of a model with
    config ``cfg`` on ``device``."""
    if n_slots < 1:
        raise ValueError("n_slots must be >= 1")
    return SlotState(
        cache=KVCache.zeros(cfg, n_slots, device=device),
        last_tok=torch.zeros((n_slots,), dtype=torch.int64, device=device),
        remaining=torch.zeros((n_slots,), dtype=torch.int64, device=device),
        generators=[torch.Generator(device=device) for _ in range(n_slots)],
    )


def write_slot(state: SlotState, slot: int, p_len: int, first: torch.Tensor,
               max_new: int) -> None:
    """Finish a refill of ``slot`` in place, after the prefill forward
    wrote its K/V (``TransformerLM(prefill=True, rows=slot)``): position
    ``p_len`` (the bucket padding beyond it is masked until this request's
    own decode writes overwrite it), the first sampled token, and the
    remaining budget (the first token is already accounted for). Device
    writes only — no host sync."""
    state.cache.index[slot] = p_len
    state.last_tok[slot] = first
    state.remaining[slot] = max_new - 1
