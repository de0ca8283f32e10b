"""Slot-indexed decode state: the device side of continuous batching.

Port of the JAX package's ``serve/slots.py`` core. The engine serves
``n_slots`` concurrent requests out of ONE fixed-shape state whose batch
axis is the slot axis; a finished slot is refilled in place by a prefill
into that slot and a per-slot position reset.

- :func:`bucket_len` — prompt-length buckets (powers of two, floor 8,
  capped at the window);
- :func:`init_slot_state` — the zeroed :class:`SlotState` (with the
  speculative draft history when asked);
- :func:`write_slot` — reset one slot's counters after its prefill;
- :func:`seed_history` — reset one slot's draft history to its prompt and
  first token;
- :func:`set_adapter` — one slot's LoRA bank row (engines with a bank);
- :func:`upload` — a host list (or a host tensor) to the device with no
  stream sync (pinned memory, a non-blocking copy);
- :func:`pack` and :func:`unpack` — tensors of any dtypes as one flat byte
  tensor and back (views): a swap-out's one host copy;
- :func:`write_slot_paged` and :func:`park_slot_paged` — the paged twins
  (a :class:`..models.transformer.PagedKVCache`): copy a prefill's pages
  into the pool and install the slot's page table; sentinel a finished
  slot's table;
- the prefix cache's and chunked prefill's surgery on batch-1 side caches
  (:class:`..models.transformer.KVCache` with a leading layer axis, plus
  the int8/int4 scale tensors): :func:`extract_segment` cuts a retained
  segment out of a prefilled cache, :func:`seed_cache` starts a side cache
  from one at a depth, :func:`zero_cache` starts one from nothing,
  :func:`copy_slot` copies a finished side cache into a slot,
  :func:`seed_cache_paged` gathers a paged donor's pages into a side
  cache, :func:`copy_page` copies one pool page (a shared boundary page's
  copy on write), and :func:`tree_nbytes` prices a segment from its shapes
  and dtypes.

Tensor parallel: a rank's state holds the rank's KV heads only (the
cache shapes come from ``tp_layout``), so every function here works on
the shard unchanged, and :func:`tree_nbytes` is the rank's own bytes —
the per-chip price the JAX package's ``tree_nbytes_sharded`` computes
from shard shapes.
"""

from __future__ import annotations

import dataclasses
import math

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
      ``Request.seed`` at refill;
    - ``hist`` (S, W + 1) int64 and ``hist_len`` (S,) int64 — speculative
      engines only (None otherwise): each slot's token history (prompt and
      every emitted token) over the window W, the draft table of
      :func:`..models.sampling.ngram_draft`, and its valid length. Column
      W is a trash column: a history write past the window lands there and
      is never read (PyTorch has no dropping scatter);
    - ``adapter_ids`` (S,) int32 — engines with an adapter bank only (None
      otherwise): each slot's LoRA bank row, the decode forwards'
      ``adapter_ids``, set at refill by :func:`set_adapter`."""

    cache: KVCache | PagedKVCache
    last_tok: torch.Tensor
    remaining: torch.Tensor
    generators: list[torch.Generator]
    hist: torch.Tensor | None = None
    hist_len: torch.Tensor | None = None
    adapter_ids: torch.Tensor | None = None


def init_slot_state(cfg: TransformerConfig, n_slots: int, device,
                    history: int = 0, adapters: bool = False) -> SlotState:
    """Zeroed state for ``n_slots`` concurrent requests of a model with
    config ``cfg`` on ``device``; a paged model (``cfg.kv_pages`` > 0) gets
    a :class:`..models.transformer.PagedKVCache` with every table entry
    the sentinel. ``history`` > 0 (a speculative engine: the window) adds
    the draft history ``hist`` / ``hist_len``; 0 leaves them None.
    ``adapters`` adds the per-slot ``adapter_ids`` (all 0, the base row)."""
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
        hist=(torch.zeros((n_slots, history + 1), dtype=torch.int64, device=device)
              if history else None),
        hist_len=(torch.zeros((n_slots,), dtype=torch.int64, device=device)
                  if history else None),
        adapter_ids=(torch.zeros((n_slots,), dtype=torch.int32, device=device)
                     if adapters else None),
    )


def set_adapter(state: SlotState, slot: int, aid: int) -> None:
    """``slot``'s adapter id, in place: a fill of the slot's view (a host
    number as a kernel argument), never item assignment, which on a card
    copies a host scalar and synchronizes the stream."""
    state.adapter_ids[slot].fill_(aid)


def upload(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` (a nested list of ints, or a host tensor) as a ``dtype``
    tensor on ``device``, with no host sync: on a card the host tensor is
    pinned and copied non-blocking, on the current stream (the caching host
    allocator keeps the pinned buffer until the copy has run). A plain copy
    from pageable memory would synchronize the stream, draining every chain
    queued ahead of it."""
    t = (values.to(dtype) if isinstance(values, torch.Tensor)
         else torch.tensor(values, dtype=dtype))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# a packed piece starts on this many bytes, so each unpacked view is
# aligned for its dtype
_PACK_ALIGN = 16


def pack(tensors: list[torch.Tensor]) -> torch.Tensor:
    """``tensors`` (any dtypes and shapes, on one device) as ONE flat
    uint8 tensor on that device: each one's bytes in order, each piece
    padded to 16 bytes. One device copy; :func:`unpack` inverts it."""
    pieces = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pieces.append(b)
        pad = -b.numel() % _PACK_ALIGN
        if pad:
            pieces.append(b.new_zeros(pad))
    return torch.cat(pieces)


def unpack(buf: torch.Tensor, like: list[tuple]) -> list[torch.Tensor]:
    """The tensors :func:`pack` put into ``buf``, as views of it: ``like``
    lists each one's ``(shape, dtype)`` in the packed order."""
    out, off = [], 0
    for shape, dtype in like:
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        out.append(buf[off:off + n].view(dtype).reshape(shape))
        off += n + (-n % _PACK_ALIGN)
    if off != buf.numel():
        raise ValueError(f"packed buffer holds {buf.numel()} bytes, the layout {off}")
    return out


def write_slot(state: SlotState, slot: int, p_len: int, first: torch.Tensor,
               max_new: int) -> None:
    """Finish a refill of ``slot`` in place, after the prefill forward
    wrote its K/V (``TransformerLM(prefill=True, rows=slot)``): position
    ``p_len`` (the bucket padding beyond it is masked until this request's
    own decode writes overwrite it), the first sampled token, and the
    remaining budget (the first token is already accounted for). Device
    writes only — no host sync: host numbers go in through ``fill_`` (a
    kernel argument), never by item assignment, which on a card copies a
    host scalar and synchronizes the stream."""
    state.cache.index[slot].fill_(p_len)
    state.last_tok[slot] = first
    state.remaining[slot].fill_(max_new - 1)


def write_slot_paged(state: SlotState, prefill_cache: KVCache, pages: list[int],
                     slot: int, p_len: int, first: torch.Tensor, max_new: int) -> None:
    """Paged refill of ``slot``, in place: copy a batch-1 prefilled
    :class:`..models.transformer.KVCache` (K/V, and scales for quantized
    storage) into the pool pages ``pages`` — each allocated page WHOLE,
    the encoded zeros past the prompt's bucket included, which wipes
    whatever a previous holder (or a parked slot's writes) left in a
    recycled page — install the slot's page table (``pages``, then the
    sentinel) and finish as :func:`write_slot` does. Device writes and
    non-blocking uploads of the page ids (:func:`upload`): no host sync."""
    cache = state.cache
    n, ps = len(pages), cache.page_size
    row = pages + [cache.n_pages] * (cache.table.shape[1] - n)
    ids = upload(pages, torch.int64, cache.k.device)
    pairs = [(cache.k, prefill_cache.k), (cache.v, prefill_cache.v)]
    if cache.quant:
        pairs += [(cache.k_scale, prefill_cache.k_scale),
                  (cache.v_scale, prefill_cache.v_scale)]
    for pool, flat in pairs:
        src = flat[:, 0, : n * ps]  # (L, n * ps, ...)
        pool[:, ids] = src.reshape((src.shape[0], n, ps) + tuple(src.shape[2:]))
    cache.table[slot] = upload(row, torch.int32, cache.k.device)
    write_slot(state, slot, p_len, first, max_new)


def seed_history(state: SlotState, tokens: torch.Tensor, p_len: int, slot: int,
                 first) -> None:
    """Reset ``slot``'s draft history to [prompt, first token] (the JAX
    engine's ``_seed_history``): ``tokens`` (1, n) holds the prompt in its
    first ``p_len`` columns (padding past them is masked by ``hist_len``),
    ``first`` (an int) lands at ``p_len``, and the valid length becomes
    ``p_len + 1``. Device writes only (fills: no host sync)."""
    state.hist[slot, : tokens.shape[1]] = tokens[0]
    state.hist[slot, p_len].fill_(first)
    state.hist_len[slot].fill_(p_len + 1)


def park_slot_paged(state: SlotState, slot: int) -> None:
    """Park ``slot`` of a paged state: its page table becomes all sentinel,
    so the writes it keeps making each decode step land in the sink page
    and never in pages that were released (and may already serve another
    request), and its budget drops to 0. Device writes only (fills: no
    host sync)."""
    state.cache.table[slot].fill_(state.cache.n_pages)
    state.remaining[slot].zero_()


def _leaves(cache) -> list:
    """The per-position tensors of a cache: K, V and, quantized, their
    scales (each with a leading layer axis)."""
    return [x for x in (cache.k, cache.v, cache.k_scale, cache.v_scale) if x is not None]


def extract_segment(cache: KVCache, seg_len: int, row: int = 0) -> KVCache:
    """Row ``row`` of a prefilled ``cache`` cut to its first ``seg_len``
    positions, as a batch-1 :class:`..models.transformer.KVCache` that owns
    its memory (a copy): the retained segment the prefix index keeps.
    ``seg_len`` is a ``bucket_len`` of the prefix, so segments come in the
    prefill buckets' sizes. Positions past the real prefix hold bucket
    padding; a consumer reuses only ``[0, depth)``, depth at most the real
    prefix, and overwrites or masks the rest (:mod:`.prefix`). The index
    is copied through and overwritten by :func:`seed_cache`."""
    k, v, *scales = (x[:, row:row + 1, :seg_len].clone() for x in _leaves(cache))
    return KVCache(k=k, v=v, index=cache.index[row:row + 1].clone(),
                   k_scale=scales[0] if scales else None,
                   v_scale=scales[1] if scales else None, quant=cache.quant)


def seed_cache(cache1: KVCache, segment: KVCache, depth: int) -> KVCache:
    """Start the batch-1 side cache ``cache1`` from a retained ``segment``
    at ``depth`` reused positions, in place: positions ``[0, seg_len)``
    from the segment, the rest zero, the index ``depth`` — the state a
    whole prefill of the first ``depth`` tokens would leave on ``[0,
    depth)``, so the suffix continuation (decode over the suffix from
    ``depth``) computes what the whole prefill would. Returns ``cache1``.
    Device writes only."""
    n = segment.k.shape[2]
    for dst, src in zip(_leaves(cache1), _leaves(segment)):
        dst[:, :, :n] = src
        dst[:, :, n:].zero_()
    cache1.index.fill_(depth)
    return cache1


def zero_cache(cache1: KVCache) -> KVCache:
    """Start the batch-1 side cache ``cache1`` from nothing, in place:
    every position zero and the index 0, so a chunked prefill's first chunk
    writes from position 0 as a whole prefill would. Returns ``cache1``."""
    for x in _leaves(cache1):
        x.zero_()
    cache1.index.zero_()
    return cache1


def copy_slot(state: SlotState, cache1: KVCache, slot: int) -> None:
    """Copy a finished batch-1 side cache (a splice's or a chunked
    prefill's) into ``slot``'s rows of the whole-slot cache — the whole
    window, so the slot holds exactly the side cache's state; the other
    slots' rows and positions do not move. :func:`write_slot` then sets
    the slot's counters. Device writes only."""
    for dst, src in zip(_leaves(state.cache), _leaves(cache1)):
        dst[:, slot] = src[:, 0]


def seed_cache_paged(cache1: KVCache, pool: PagedKVCache, pages: list[int],
                     depth: int) -> KVCache:
    """The paged twin of :func:`seed_cache`: copy the donor's pool pages
    ``pages`` (the ``ceil(depth / page_size)`` that cover ``[0, depth)``)
    into the batch-1 side cache ``cache1``, in place, the rest zero, the
    index ``depth``. A partly covered last page copies whole: its tail past
    ``depth`` is the donor's, overwritten or masked as a segment's stale
    tail is. Returns ``cache1``. No host sync."""
    n, ps = len(pages), pool.page_size
    ids = upload(pages, torch.int64, pool.k.device)
    for dst, src in zip(_leaves(cache1), _leaves(pool)):
        got = src[:, ids]  # (L, n, page_size, ...)
        dst[:, 0, : n * ps] = got.reshape((got.shape[0], n * ps) + tuple(got.shape[3:]))
        dst[:, 0, n * ps:].zero_()
    cache1.index.fill_(depth)
    return cache1


def copy_page(pool: PagedKVCache, src: int, dst: int) -> None:
    """Copy pool page ``src`` whole into page ``dst`` across every layer's
    K, V and scales: the copy on write of a paged splice's boundary page
    (the donor's page is shared only up to ``depth``). Device writes only."""
    for x in _leaves(pool):
        x[:, dst] = x[:, src]


def tree_nbytes(cache) -> int:
    """Bytes of a cache's tensors (K, V, scales and the index, or a page
    table), from shapes and dtypes alone — never a device fetch; the prefix
    index budgets segments with it."""
    tensors = [*_leaves(cache), cache.index, getattr(cache, "table", None)]
    return sum(math.prod(x.shape) * x.element_size() for x in tensors if x is not None)
