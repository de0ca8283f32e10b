"""Slot-indexed decode state: the device side of continuous batching.

Port of the JAX package's ``serve/slots.py`` core. The engine serves
``n_slots`` concurrent requests out of ONE fixed-shape state whose batch
axis is the slot axis; a finished slot is refilled in place by a prefill
into that slot and a per-slot position reset.

- :func:`bucket_len` — prompt-length buckets (powers of two, floor 8,
  capped at the window);
- :func:`init_slot_state` — the zeroed :class:`SlotState`;
- :func:`write_slot` — reset one slot's counters after its prefill;
- :func:`write_slot_paged` and :func:`park_slot_paged` — the paged twins
  (a :class:`..models.transformer.PagedKVCache`): copy a prefill's pages
  into the pool and install the slot's page table; sentinel a finished
  slot's table.
"""

from __future__ import annotations

import dataclasses

import torch

from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    KVCache,
    PagedKVCache,
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
      window (or, for ``cfg.kv_pages`` > 0, the
      :class:`..models.transformer.PagedKVCache` of the shared pools and
      per-slot page tables), with a per-slot position ``cache.index``;
    - ``last_tok`` (S,) int64 — each slot's most recent token, the next
      decode input;
    - ``remaining`` (S,) int64 — tokens still to generate; 0 = free or
      parked (the active mask is ``remaining > 0``);
    - ``generators`` — one ``torch.Generator`` per slot, reseeded from
      ``Request.seed`` at refill."""

    cache: KVCache | PagedKVCache
    last_tok: torch.Tensor
    remaining: torch.Tensor
    generators: list[torch.Generator]


def init_slot_state(cfg: TransformerConfig, n_slots: int, device) -> SlotState:
    """Zeroed state for ``n_slots`` concurrent requests of a model with
    config ``cfg`` on ``device``; a paged model (``cfg.kv_pages`` > 0) gets
    a :class:`..models.transformer.PagedKVCache` with every table entry
    the sentinel."""
    if n_slots < 1:
        raise ValueError("n_slots must be >= 1")
    if cfg.kv_pages:
        cache = PagedKVCache.zeros(cfg, n_slots, device=device)
    else:
        cache = KVCache.zeros(cfg, n_slots, device=device)
    return SlotState(
        cache=cache,
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


def write_slot_paged(state: SlotState, prefill_cache: KVCache, pages: list[int],
                     slot: int, p_len: int, first: torch.Tensor, max_new: int) -> None:
    """Paged refill of ``slot``, in place: copy a batch-1 prefilled
    :class:`..models.transformer.KVCache` (K/V, and scales for quantized
    storage) into the pool pages ``pages`` — each allocated page WHOLE,
    the encoded zeros past the prompt's bucket included, which wipes
    whatever a previous holder (or a parked slot's writes) left in a
    recycled page — install the slot's page table (``pages``, then the
    sentinel) and finish as :func:`write_slot` does. Device writes only (a
    host-to-device copy of the page ids), no host sync."""
    cache = state.cache
    n, ps = len(pages), cache.page_size
    row = pages + [cache.n_pages] * (cache.table.shape[1] - n)
    ids = torch.tensor(pages, dtype=torch.int64, device=cache.k.device)
    pairs = [(cache.k, prefill_cache.k), (cache.v, prefill_cache.v)]
    if cache.quant:
        pairs += [(cache.k_scale, prefill_cache.k_scale),
                  (cache.v_scale, prefill_cache.v_scale)]
    for pool, flat in pairs:
        src = flat[:, 0, : n * ps]  # (L, n * ps, ...)
        pool[:, ids] = src.reshape((src.shape[0], n, ps) + tuple(src.shape[2:]))
    cache.table[slot] = torch.tensor(row, dtype=torch.int32, device=cache.k.device)
    write_slot(state, slot, p_len, first, max_new)


def park_slot_paged(state: SlotState, slot: int) -> None:
    """Park ``slot`` of a paged state: its page table becomes all sentinel,
    so the writes it keeps making each decode step land in the sink page
    and never in pages that were released (and may already serve another
    request), and its budget drops to 0. Device writes only."""
    state.cache.table[slot] = state.cache.n_pages
    state.remaining[slot] = 0
