"""Continuous-batching serving engine: ``n_slots`` concurrent requests over
one slot-indexed KV cache, decoded in chains of ``tokens_per_launch``
steps.

Port of the core of the JAX package's ``serve/engine.py`` (Orca, OSDI
'22): requests at different depths decode together, each slot with its
own position and active mask (``remaining > 0``); a finished slot is
refilled in place by a bucketed prefill into that slot. Host syncs are
ONE per chain — a single ``.cpu()`` of the (n_slots, tokens_per_launch)
token block, or at ``pipeline_depth`` >= 2 on a card the wait on the
chain's event — plus one per prefill, splice or final chunk for the first
sampled token; ``n_host_syncs`` counts them. Every host-to-device input
(prompt tokens, page ids and tables) goes up through a pinned,
non-blocking copy (:func:`.slots.upload`): a copy from pageable memory
would synchronize the stream. Chains run eagerly (the JAX package
compiles each chain into one program; capturing it as a CUDA graph is
later work).

Greedy tokens equal :func:`..models.generate.generate`'s for the same
request, whatever else shares the batch (``models/transformer.py`` says
why the int8 forward is batch- and window-invariant). The model may be
int8 or float (``cfg.dtype``), and its ``cfg.attention_fn`` (the flash
forward kernel) runs every whole prefill.

Paged KV (``paged=True``, vLLM's PagedAttention, SOSP '23): decode reads
and writes one shared pool of ``pool_pages`` pages of ``page_size``
tokens per layer through per-slot page tables, so the slot count no
longer prices a whole window each. The host-side :class:`.pages.PagePool`
allocates ``pages_needed(p_len + max_new_tokens)`` pages at refill, never
mid-decode; a request that does not fit the free pages waits queued, and
one that could never fit the pool raises :class:`.pages.PoolExhausted` at
submit. Prefill runs the unpaged batch-1 forward into a flat cache and
copies its pages into the pool (:func:`.slots.write_slot_paged`); every
completion parks the slot (its table all sentinel) and returns its pages.
``paged_kernel`` reads the pool through the paged-attention kernel instead
of the gather. ``kv_bits`` (8 or 4) stores K/V as int8 or int4, paged or
not.

Prefix cache (``prefix_cache_bytes`` > 0, the radix index of
:mod:`.prefix`): every prefill retains its prompt's K/V as a segment (a
batch-1 cache cut to the prompt's bucket; paged, the ids of its pages,
held by refcount at no extra memory), and a request whose prompt shares
at least ``min_hit_depth`` leading tokens with one is SPLICED: a batch-1
side cache seeded from the segment at the matched depth, one suffix
continuation (decode over the uncached suffix from that depth), the
first token sampled at the last real suffix position and the side cache
copied into the slot (:meth:`ServeEngine._splice`). Paged, the donor's
whole pages are shared in place, the one partly shared boundary page is
copied on write, and the suffix writes straight into the slot's pages.
The donor segment is pinned until its request completes, so eviction
(LRU under the byte budget, and paged under pool pressure) never takes
a segment a slot decodes from.

Chunked prefill (``prefill_chunk`` > 0, a power of two >= 8): a prompt
whose uncached length exceeds the chunk streams in, one chunk a
:meth:`ServeEngine.step`, into a batch-1 side cache (zeroed, or seeded
from a prefix hit), so co-scheduled slots keep decoding; mid chunks make
no host sync (their tokens go up non-blocking), the final chunk samples
the first token and writes the slot. Paged, chunked prompts take fresh
pages (the JAX package's documented trade: no sharing for them).

Self-speculative decoding (``speculative_k`` > 0; Leviathan et al. 2023
verify, Saxena 2023 prompt-lookup draft, no second model): every chain
iteration drafts ``k`` tokens a slot by an n-gram match over the slot's
token history (``SlotState.hist``, on the device, seeded at every refill
kind in :meth:`ServeEngine._activate`), verifies ``[last_tok, draft]``
in ONE (n_slots, k+1) decode forward, accepts the longest matching
prefix plus a bonus token (:func:`..models.sampling.speculative_accept`)
and rewinds the rejected positions
(:func:`..models.transformer.rewind_cache_index`). The accepted length
is data: the chain returns an (n_slots, T, k+1) token block and (n_slots,
T) emit counts in one tensor, still ONE host sync a chain. Greedy
streams are token-identical to the plain engine's.

Pipelining (``pipeline_depth`` = 2): chain i+1 is queued on the stream
before chain i's tokens are fetched, so the host's round trip and
bookkeeping overlap the device's work. Dispatch queues the chain, then a
non-blocking copy of its token block into one of ``pipeline_depth``
pinned host buffers, and records a CUDA event; collect waits on the
oldest chain's event. Host bookkeeping runs one chain behind the device:
a slot that finished in chain i junk-decodes chain i+1 (its rows are
dropped by an identity check against the slot view taken at dispatch),
which is safe because chains, parks and refills share one stream, so the
extra chain runs before the park and before the next refill's writes.
A refill's first-token fetch still drains the stream. Depth 1 is the
serial loop.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
from pytorch_distributed_training_tutorials_tpu_torch.models.sampling import (
    ngram_draft,
    sample_logits,
    sample_logits_per_slot,
    speculative_accept,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    KVCache,
    PagedKVCache,
    TransformerLM,
    _kv_quant_mode,
    bind_params,
    rewind_cache_index,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.pages import (
    PagePool,
    PoolExhausted,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.prefix import (
    PrefixIndex,
    Segment,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.scheduler import (
    Completion,
    FifoScheduler,
    Request,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.slots import (
    bucket_len,
    copy_page,
    copy_slot,
    extract_segment,
    init_slot_state,
    park_slot_paged,
    seed_cache,
    seed_cache_paged,
    seed_history,
    tree_nbytes,
    upload,
    write_slot,
    write_slot_paged,
    zero_cache,
)

# how a refill reached its first token: a whole prefill, a splice, or a
# chunked prefill's final chunk without and with a prefix hit
_REFILL_KINDS = ("prefill", "splice", "chunked", "chunked_splice")


class _Active:
    """Host-side view of one occupied slot; ``ttft_s`` is
    submit-to-first-token wall time; ``pages`` (paged engines) the pool
    pages the slot holds, released when it parks; ``segment`` the prefix
    segment it was spliced from, released at completion."""

    __slots__ = ("request", "tokens", "remaining", "ttft_s", "pages", "segment")

    def __init__(self, request: Request, first_token: int, pages=None,
                 segment: Segment | None = None):
        self.request = request
        self.tokens = [first_token]
        self.remaining = request.max_new_tokens - 1
        self.ttft_s = 0.0
        self.pages: list[int] = list(pages or [])
        self.segment = segment


class _InFlight:
    """One dispatched, not yet collected decode chain: its token block (on
    the device, or the pinned host buffer its copy lands in), the CUDA
    event recorded after that copy (None: the block is fetched with
    ``.cpu()``), a shallow copy of the slot views at dispatch (a slot whose
    ``_Active`` changed since ignores the chain's rows) and the chain's
    number."""

    __slots__ = ("block", "event", "view", "chain_id")

    def __init__(self, block: torch.Tensor, event, view: list, chain_id: int):
        self.block = block
        self.event = event
        self.view = view
        self.chain_id = chain_id


class _PendingPrefill:
    """A chunked prefill in progress: the request, its slot, the batch-1
    side cache the chunks accumulate into, how many prompt tokens it holds
    (``done``, a spliced ``depth`` included), the pinned donor segment of a
    prefix hit, whether the prompt's own segment is inserted at the end
    (``grow``) and, paged, the fresh pages allocated for the slot. The
    slot's device budget stays 0 until the final chunk, so decode chains
    treat it as inactive."""

    __slots__ = ("request", "slot", "prompt", "cache1", "done", "depth",
                 "segment", "grow", "pages")

    def __init__(self, request: Request, slot: int, prompt: list[int]):
        self.request = request
        self.slot = slot
        self.prompt = prompt
        self.cache1: KVCache | None = None
        self.done = 0
        self.depth = 0
        self.segment: Segment | None = None
        self.grow = False
        self.pages: list[int] = []


def _variant(model: TransformerLM, **changes) -> TransformerLM:
    """``model`` under a config with ``changes``, holding the same weight
    tensors (no copy)."""
    out = TransformerLM(dataclasses.replace(model.cfg, **changes))
    bind_params(out, model.state_dict())
    return out


class ServeEngine:
    """Request-level LM serving over a slot-indexed KV cache.

    ``model`` is a :class:`..models.transformer.TransformerLM`, int8 or
    float; its ``cfg.max_seq_len`` is the window every slot gets. ``params``
    (a state dict from the weight bridge, or None when ``model`` already
    holds its weights) is bound into ``model`` on ``device`` (``cuda``
    unless the caller passes another); the engine only reads it.

    Drive it with :meth:`submit` + :meth:`step`, or :meth:`run_until_idle`.
    ``step()`` advances every chunked prefill by one chunk, does at most
    one refill per free slot (a prefill or a splice, each with one host
    sync for the first sampled token, or the start of a chunked prefill),
    then dispatches ONE ``tokens_per_launch``-step decode chain over all
    slots and collects the oldest in-flight chain with ONE host sync
    (``pipeline_depth`` 1: the chain just dispatched).

    ``kv_bits`` (None: the model's ``kv_cache_dtype``; 8: int8 codes + f32
    scales; 4: packed int4 + bf16 scales) sets the KV storage. ``paged``
    with ``page_size`` and ``pool_pages`` serves decode from a shared page
    pool (module docstring); ``paged_kernel`` reads it through the
    paged-attention kernel. ``prefix_cache_bytes`` (0: off) is the prefix
    index's byte budget and ``min_hit_depth`` the shortest match it
    splices; ``prefill_chunk`` (0: off, else a power of two >= 8) the
    chunk of a chunked prefill (module docstring). ``speculative_k`` (0:
    off) drafts that many tokens a verify step by ``spec_ngram``-gram
    lookup; ``pipeline_depth`` (1: serial) is how many chains may be in
    flight (module docstring)."""

    def __init__(
        self,
        model: TransformerLM,
        params,
        *,
        n_slots: int = 4,
        tokens_per_launch: int = 8,
        max_queue: int = 64,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        prefix_cache_bytes: int = 0,
        min_hit_depth: int = 1,
        prefill_chunk: int = 0,
        device=None,
        kv_bits: int | None = None,
        paged: bool = False,
        page_size: int = 0,
        pool_pages: int = 0,
        paged_kernel: bool = False,
        speculative_k: int = 0,
        spec_ngram: int = 3,
        pipeline_depth: int = 1,
    ):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if tokens_per_launch < 1:
            raise ValueError("tokens_per_launch must be >= 1")
        if speculative_k < 0:
            raise ValueError("speculative_k must be >= 0")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1 (1 = serial)")
        if paged:
            if page_size < 1 or pool_pages < 1:
                raise ValueError("paged=True needs page_size >= 1 and pool_pages >= 1")
        elif page_size or pool_pages:
            raise ValueError("page_size/pool_pages require paged=True")
        if kv_bits not in (None, 4, 8):
            raise ValueError(
                "kv_bits must be None (follow the model config), 8 (int8 + f32 "
                "scales), or 4 (packed nibbles + bf16 scales)"
            )
        if paged_kernel and not paged:
            raise ValueError(
                "paged_kernel=True requires paged=True (the kernel walks the "
                "page pool; whole-slot decode has no pages)"
            )
        if prefill_chunk and (prefill_chunk < 8 or prefill_chunk & (prefill_chunk - 1)):
            raise ValueError(
                "prefill_chunk must be 0 (off) or a power of two >= 8 (chunk "
                "lengths come from the power-of-two bucket set)"
            )
        if prefix_cache_bytes < 0:
            raise ValueError("prefix_cache_bytes must be >= 0 (0 = off)")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.device = resolve_device(device)
        if params is not None:
            bind_params(
                model, {k: v.to(self.device) for k, v in params.items()}
            )
        if kv_bits is not None:
            model = _variant(
                model, kv_cache_dtype="int4" if kv_bits == 4 else torch.int8
            )
        self._kv_bits = {None: 0, "int8": 8, "int4": 4}[
            _kv_quant_mode(model.cfg.kv_cache_dtype)
        ]
        self.model = model
        self.n_slots = n_slots
        self.tokens_per_launch = tokens_per_launch
        self.window = int(model.cfg.max_seq_len)
        self.scheduler = FifoScheduler(self.window, max_queue=max_queue)
        self._slots: list[_Active | None] = [None] * n_slots
        # paged: decode runs a twin of the model whose config names the
        # pool (its paged_kernel picks the read path); prefill keeps the
        # unpaged model and a flat batch-1 cache whose pages are copied in
        self._paged = bool(paged)
        self._paged_kernel = bool(paged_kernel)
        self._page_size = int(page_size)
        self._pool_pages = int(pool_pages)
        if self._paged:
            if self.window % self._page_size:
                raise ValueError(
                    f"page_size ({page_size}) must divide the window "
                    f"({self.window}) so slot page tables have one fixed length"
                )
            self._pool = PagePool(pool_pages, page_size)
            self._dec_model = _variant(
                model, kv_pages=self._pool_pages, kv_page_size=self._page_size,
                paged_kernel=self._paged_kernel,
            )
            self._prefill_cache = KVCache.zeros(model.cfg, 1, device=self.device)
        else:
            self._pool = None
            self._dec_model = model
        # speculation: 0 = off, and the state then has no history
        self._spec = speculative_k > 0
        self._spec_k = int(speculative_k)
        self._spec_ngram = int(spec_ngram)
        if self._spec and speculative_k + 1 > self.window:
            raise ValueError("speculative_k + 1 must fit the window")
        if self._spec and spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        self._state = init_slot_state(self._dec_model.cfg, n_slots, self.device,
                                      history=self.window if self._spec else 0)
        # pipelining: the chains in flight, and at depth >= 2 on a card one
        # pinned host buffer per chain in flight for its token block
        self._depth = int(pipeline_depth)
        self._inflight: collections.deque[_InFlight] = collections.deque()
        block = (n_slots, tokens_per_launch) + ((self._spec_k + 2,) if self._spec else ())
        self._ring = (
            [torch.empty(block, dtype=torch.int64, pin_memory=True)
             for _ in range(self._depth)]
            if self._depth > 1 and self.device.type == "cuda" else None
        )
        self._page_bytes = self._state.cache.page_bytes() if self._paged else 0
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._top_p = float(top_p)
        # prefix cache: 0 bytes = off. Paged engines hand the index an
        # eviction hook so a dropped segment's page references return to
        # the pool (the index stays handle-agnostic)
        self.prefix = (
            PrefixIndex(prefix_cache_bytes,
                        on_evict=self._release_segment_pages if self._paged else None)
            if prefix_cache_bytes > 0 else None
        )
        self._min_hit_depth = int(min_hit_depth)
        self._chunk = int(prefill_chunk)
        self._pending: dict[int, _PendingPrefill] = {}
        # batch-1 side caches, each reused: the unpaged splice's, and the
        # chunked prefill's (one at a time: while one is pending, only
        # prompts of one chunk pop)
        self._side = (
            KVCache.zeros(model.cfg, 1, device=self.device)
            if self.prefix is not None and not self._paged else None
        )
        self._chunk_side = (
            KVCache.zeros(model.cfg, 1, device=self.device) if self._chunk else None
        )
        # counters for receipts and the sync-budget checks
        self.refills = dict.fromkeys(_REFILL_KINDS, 0)
        self.n_chains = 0
        self.n_chunks = 0
        self.n_host_syncs = 0
        self.prefix_hit_tokens = 0
        self.generated_tokens = 0
        # speculation: verify forwards dispatched, verify steps whose tokens
        # an active slot consumed, and draft tokens accepted (the JAX
        # engine's counters)
        self.n_verify_forwards = 0
        self.spec_steps_consumed = 0
        self.spec_drafts_accepted = 0

    @property
    def n_prefills(self) -> int:
        """Refills that prefilled the whole prompt: whole prefills and
        chunked prefills without a prefix hit (the JAX engine's count)."""
        return self.refills["prefill"] + self.refills["chunked"]

    @property
    def n_splices(self) -> int:
        """Refills seeded from a prefix segment: whole splices and chunked
        prefills that began with a hit (the JAX engine's count)."""
        return self.refills["splice"] + self.refills["chunked_splice"]

    # ------------------------------------------------------------------
    # host-side driver
    # ------------------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Enqueue one request; returns its id. Raises
        :class:`..serve.scheduler.QueueFull` at capacity,
        :class:`..serve.scheduler.QueueClosed` after :meth:`close`,
        ``ValueError`` when the request can never fit the window, or (paged)
        :class:`.pages.PoolExhausted` when it needs more pages than the
        whole pool holds."""
        if self._paged:
            need = self._pool.pages_needed(
                len(request.prompt) + request.max_new_tokens
            )
            if need > self._pool.pool_pages:
                self._pool.shed()
                raise PoolExhausted(
                    f"request needs {need} pages but the pool holds "
                    f"{self._pool.pool_pages} ({self._pool.page_size} tokens "
                    "each) — shrink the request or grow the pool"
                )
        return self.scheduler.submit(request)

    @property
    def active_slots(self) -> int:
        return sum(a is not None for a in self._slots)

    @property
    def idle(self) -> bool:
        return (self.active_slots == 0 and not self._pending
                and len(self.scheduler) == 0 and not self._inflight)

    @torch.no_grad()
    def step(self) -> list[Completion]:
        """One scheduling round: advance each chunked prefill by one chunk,
        refill free slots from the queue, dispatch one decode chain over all
        slots, then collect the oldest in-flight chain and hand out its
        tokens while more than ``pipeline_depth - 1`` are in flight (all of
        them once no slot is active). Depth 1 collects the chain it just
        dispatched: the serial loop. Returns the requests that finished
        this round (possibly mid-chain — surplus chain tokens of a finished
        slot are discarded)."""
        done: list[Completion] = []
        # pending prefills advance BEFORE refill, so a chunked prefill
        # begun this round is not advanced twice
        for slot in list(self._pending):
            done.extend(self._advance_one(self._pending[slot]))
        for s in range(self.n_slots):
            if self._slots[s] is not None or s in self._pending:
                continue
            req = self._pop_request()
            if req is None:
                break
            done.extend(self._refill(s, req))
        if self.active_slots:
            self._dispatch()
        target = self._depth - 1 if self.active_slots else 0
        while len(self._inflight) > target:
            done.extend(self._collect_chain())
        return done

    def _dispatch(self) -> None:
        """Queue one decode chain (:meth:`_chain`, or :meth:`_spec_chain`)
        on the current stream; at depth >= 2 on a card, then a
        non-blocking copy of its token block into the next pinned ring
        buffer and an event after it. The chain joins the in-flight queue
        with the slot views of this moment."""
        chain_id = self.n_chains
        block = self._spec_chain() if self._spec else self._chain()
        self.n_chains += 1
        if self._spec:
            self.n_verify_forwards += self.tokens_per_launch
        event = None
        if self._ring is not None:
            host = self._ring[chain_id % self._depth]
            host.copy_(block, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            block = host
        self._inflight.append(_InFlight(block, event, list(self._slots), chain_id))

    def _collect_chain(self) -> list[Completion]:
        """Land the OLDEST in-flight chain's token block (its one counted
        host sync, :meth:`_land`) and hand it to the slot views taken at
        its dispatch."""
        fl = self._inflight.popleft()
        block = self._land(fl)
        if self._spec:
            return self._distribute_spec(block, fl.view)
        return self._distribute(block, fl.view)

    def _land(self, fl: _InFlight) -> torch.Tensor:
        """A chain's host sync, counted: the ``.cpu()`` of its block
        (:meth:`_fetch`), or the wait on its event when the block's copy
        to a pinned buffer was queued at dispatch. Host memory out."""
        if fl.event is None:
            return self._fetch(fl.block)
        self.n_host_syncs += 1
        fl.event.synchronize()
        return fl.block

    def _pop_request(self) -> Request | None:
        """Queue pop, chunk-aware when chunked prefill is on (with a
        chunked prefill pending only prompts of one chunk pop). A paged
        engine pops the first request whose whole prompt + budget fits the
        free pages (the rest stay queued); when none fits but requests
        wait, cold unpinned prefix segments are evicted one at a time
        (each returns its pages) and the pop retried."""
        fits = None
        if self._paged:
            pool = self._pool

            def fits(r):
                return pool.available >= pool.pages_needed(
                    len(r.prompt) + r.max_new_tokens)

        while True:
            req = self.scheduler.pop(chunk=self._chunk,
                                     pending_long=len(self._pending), fits=fits)
            if req is not None or fits is None:
                return req
            if (len(self.scheduler) == 0 or self.prefix is None
                    or not self.prefix.evict_coldest()):
                return None

    def page_stats(self) -> dict[str, int]:
        """Paged-KV counters (the JAX engine's keys): the pool's geometry,
        ``page_bytes`` (one page across every layer's K, V and scales),
        ``kv_bits`` (0 = exact storage), ``paged_kernel``,
        ``hbm_high_water_bytes`` (the high-water page count priced at
        ``page_bytes``) and the pool's ``pages_*`` counters. Host
        bookkeeping only."""
        if not self._paged:
            return {"paged": 0}
        return {
            "paged": 1,
            "page_size": self._page_size,
            "pool_pages": self._pool_pages,
            "page_bytes": self._page_bytes,
            "kv_bits": self._kv_bits,
            "paged_kernel": int(self._paged_kernel),
            "hbm_high_water_bytes": self._pool.high_water * self._page_bytes,
            **{f"pages_{k}": v for k, v in self._pool.stats().items()},
        }

    def prefix_stats(self) -> dict[str, int | float]:
        """Prefix-cache counters (the JAX engine's keys): the index's
        ``prefix_*`` stats (segments, used and evicted bytes, hits,
        misses), the hit rate over lookups, the reused-token total and the
        splice count. Host bookkeeping only."""
        if self.prefix is None:
            return {"prefix_cache": 0}
        looked = self.prefix.hits + self.prefix.misses
        return {
            "prefix_cache": 1,
            **{f"prefix_{k}": v for k, v in self.prefix.stats().items()},
            "prefix_hit_rate": self.prefix.hits / max(1, looked),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "n_splices": self.n_splices,
        }

    def spec_stats(self) -> dict[str, int | float]:
        """Speculation counters (the JAX engine's keys): ``k`` and the
        n-gram, verify forwards dispatched, verify steps an active slot
        consumed, drafts accepted; the mean accepted length per consumed
        step (1.0: drafting never helped) and the share of offered drafts
        accepted. Host bookkeeping only."""
        if not self._spec:
            return {"speculative": 0}
        steps = max(1, self.spec_steps_consumed)
        return {
            "speculative": 1,
            "spec_k": self._spec_k,
            "spec_ngram": self._spec_ngram,
            "n_verify_forwards": self.n_verify_forwards,
            "spec_steps_consumed": self.spec_steps_consumed,
            "spec_drafts_accepted": self.spec_drafts_accepted,
            "spec_mean_accepted_len": 1.0 + self.spec_drafts_accepted / steps,
            "spec_acceptance_rate": self.spec_drafts_accepted / (steps * self._spec_k),
        }

    def pipeline_stats(self) -> dict[str, int]:
        """Pipelining counters (the JAX engine's keys): the depth, the
        prefill chunk and the chunks run. Host bookkeeping only."""
        return {"pipeline_depth": self._depth, "prefill_chunk": self._chunk,
                "n_chunks": self.n_chunks}

    def run_until_idle(self, max_steps: int = 10_000) -> list[Completion]:
        """Drain queue + slots; returns completions in finish order."""
        out: list[Completion] = []
        for _ in range(max_steps):
            if self.idle:
                return out
            out.extend(self.step())
        raise RuntimeError(f"not idle after {max_steps} steps")

    @property
    def closed(self) -> bool:
        return self.scheduler.closed

    def close(self) -> None:
        """Stop admitting requests (later :meth:`submit` raises
        ``QueueClosed``); accepted work is unaffected. Idempotent."""
        self.scheduler.close()

    def drain(self, max_steps: int = 10_000) -> list[Completion]:
        """Graceful shutdown: :meth:`close`, then run every accepted
        request to completion."""
        self.close()
        return self.run_until_idle(max_steps)

    def _fetch(self, t: torch.Tensor) -> torch.Tensor:
        """The budgeted device->host copy: every host sync of the request
        loop goes through here and is counted."""
        self.n_host_syncs += 1
        return t.cpu()

    # ------------------------------------------------------------------
    # refill: whole prefill, splice, chunked prefill
    # ------------------------------------------------------------------

    def _lookup(self, prompt: list[int]):
        """``(hit, grow)`` for a prompt: the prefix index's longest match
        ``(depth, segment)`` or None, and whether the prompt's own segment
        is to be inserted (not resident yet). The port serves one adapter,
        so a prompt is its own key."""
        if self.prefix is None:
            return None, False
        return (self.prefix.lookup(prompt, self._min_hit_depth),
                tuple(prompt) not in self.prefix)

    @torch.no_grad()
    def _refill(self, slot: int, req: Request) -> list[Completion]:
        """Admit ``req`` into ``slot`` (:meth:`_admit`): a whole prefill or
        a splice, one host sync each for the first token, or the start of
        a chunked prefill (:meth:`_advance_one` runs its first chunk in
        this same step)."""
        prompt = [int(t) for t in req.prompt]
        admitted = self._admit(slot, req, prompt)
        if admitted is None:
            return self._advance_one(self._pending[slot])
        _, first, pages, segment, kind, depth = admitted
        self.refills[kind] += 1
        self.prefix_hit_tokens += depth
        return self._activate(slot, req, first, pages, segment)

    def _admit(self, slot: int, req: Request, prompt: list[int], first=None,
               all_chunks: bool = False):
        """The one admission choice of every refill: look ``prompt`` up in
        the prefix index; when its uncached length exceeds
        ``prefill_chunk``, start a chunked prefill (:meth:`_start_pending`)
        — registered pending and left to :meth:`step` (returns None), or
        with ``all_chunks`` run to its end here (:meth:`_mid_chunk` and
        :meth:`_final_chunk`); else, on a hit, pin the donor segment FIRST
        and splice (:meth:`_splice`), or prefill whole
        (:meth:`_whole_prefill`). A first token sampled here is fetched
        (one host sync); a given ``first`` (a (1,) device tensor) is used
        as it is, with no fetch. If anything raises, the donor is
        released, the slot parked (paged: its pages returned) and the
        error re-raised. Returns ``(logits, first, pages, segment, kind,
        depth)``: ``kind`` one of ``_REFILL_KINDS``, ``depth`` the reused
        prefix length."""
        hit, grow = self._lookup(prompt)
        depth = hit[0] if hit is not None else 0
        fetch = first is None
        if self._chunk and len(prompt) - depth > self._chunk:
            pend = self._start_pending(slot, req, prompt, hit, grow)
            if not all_chunks:
                self._pending[slot] = pend
                return None
            try:
                while len(prompt) - pend.done > self._chunk:
                    self._mid_chunk(pend)
                logits, first, pages = self._final_chunk(pend, first)
                if fetch:
                    first = int(self._fetch(first)[0])
            except Exception:
                self._abandon_pending(pend)
                self._park_failed(slot, [])
                raise
            kind = "chunked_splice" if pend.segment is not None else "chunked"
            return logits, first, pages, pend.segment, kind, depth
        segment, pages = None, None
        try:
            if hit is not None:
                segment = hit[1]
                self.prefix.acquire(segment)  # pin the donor FIRST
                logits, first, pages = self._splice(slot, req, prompt, depth, segment,
                                                    grow, first)
                kind = "splice"
            else:
                logits, first, pages = self._whole_prefill(slot, req, prompt, grow, first)
                kind = "prefill"
            if fetch:
                first = int(self._fetch(first)[0])
        except Exception:
            if segment is not None:
                self.prefix.release(segment)
            self._park_failed(slot, pages or [])
            raise
        return logits, first, pages, segment, kind, depth

    def _park_failed(self, slot: int, pages: list[int]) -> None:
        """A refill raised: park the slot (the device budget may already
        be set) and return the pages it still holds."""
        if self._paged:
            park_slot_paged(self._state, slot)
            self._pool.release_all(pages)
        else:
            self._state.remaining[slot].zero_()

    def _tokens(self, toks: list[int], bucket: int) -> torch.Tensor:
        """(1, bucket) int64 device tensor: ``toks`` right-padded with 0,
        uploaded with no host sync (:func:`.slots.upload`)."""
        return upload([toks + [0] * (bucket - len(toks))], torch.int64, self.device)

    def _whole_prefill(self, slot: int, req: Request, prompt: list[int],
                       grow: bool, first=None):
        """One forward over the bucket-padded prompt (``cfg.attention_fn``
        runs here); the first token is sampled from the logits at the last
        REAL prompt position with the slot's generator reseeded from
        ``req.seed`` (unless ``first``, a (1,) device tensor, is given) and
        the slot's counters reset. Unpaged, the forward writes the slot's
        K/V in place (:func:`.slots.write_slot`). Paged, it allocates the
        request's pages (``_pop_request`` checked that they are free),
        prefills the unpaged batch-1 flat cache, copies the allocated
        pages whole into the pool and installs the slot's table
        (:func:`.slots.write_slot_paged`); if that raises, the pages go
        back to the pool. With ``grow`` the prompt's segment is inserted
        into the prefix index. Returns ``(logits, first, pages)``,
        ``pages`` None unpaged. No host sync."""
        p_len = len(prompt)
        bucket = bucket_len(p_len, self.window)
        tokens = self._tokens(prompt, bucket)
        st = self._state
        if not self._paged:
            logits = self.model(tokens, st.cache, prefill=True, last_pos=p_len - 1,
                                rows=slot)
            if first is None:
                first = self._first_token(slot, req, logits)
            write_slot(st, slot, p_len, first[0], req.max_new_tokens)
            if grow:
                seg = extract_segment(st.cache, bucket, row=slot)
                self.prefix.insert(prompt, seg, tree_nbytes(seg))
            return logits, first, None
        pages = self._pool.alloc(self._pool.pages_needed(p_len + req.max_new_tokens))
        try:
            logits = self.model(tokens, self._prefill_cache, prefill=True,
                                last_pos=p_len - 1)
            if first is None:
                first = self._first_token(slot, req, logits)
            write_slot_paged(st, self._prefill_cache, pages, slot, p_len,
                             first[0], req.max_new_tokens)
        except Exception:
            self._pool.release_all(pages)
            raise
        if grow:
            self._insert_paged_segment(prompt, pages, p_len)
        return logits, first, pages

    def _splice(self, slot: int, req: Request, prompt: list[int], depth: int,
                segment: Segment, grow: bool, first=None):
        """Prefix-hit refill (the JAX engine's ``_splice_fn`` and
        ``_finish_prefill``): reuse ``segment``'s K/V on ``[0, depth)`` and
        run ONE suffix continuation — decode over the bucket-padded suffix
        from position ``depth`` — sampling the first token at the last
        real suffix token (``last_pos = p_len - 1 - depth``).

        Unpaged: the batch-1 side cache is seeded from the segment
        (:func:`.slots.seed_cache`), continued, then copied whole into the
        slot (:func:`.slots.copy_slot`); the other slots' rows and
        positions do not move. With ``grow`` the full prompt's segment is
        cut from the side cache and inserted.

        Paged: the donor's whole pages below ``depth`` are shared in place
        (a reference each); fresh pages cover the rest, and a partly shared
        boundary page is copied on write into the first fresh one
        (:func:`.slots.copy_page`). The suffix forward runs over a batch-1
        view of the live pool (the slot's new table, position ``depth``),
        so its K/V land straight in the slot's pages; it reads the pool
        through the decode model's read path (on a ``paged_kernel`` engine
        the paged-attention kernel, its query rows in row blocks). If that
        raises, the page references go back.
        Returns ``(logits, first, pages)``. No host sync."""
        p_len = len(prompt)
        suffix = prompt[depth:]
        tokens = self._tokens(suffix, bucket_len(len(suffix), self.window))
        last = p_len - 1 - depth
        st = self._state
        if not self._paged:
            cache1 = seed_cache(self._side, segment.handle, depth)
            logits = self.model(tokens, cache1, decode=True, last_pos=last)
            if first is None:
                first = self._first_token(slot, req, logits)
            copy_slot(st, cache1, slot)
            write_slot(st, slot, p_len, first[0], req.max_new_tokens)
            if grow:
                seg = extract_segment(cache1, bucket_len(p_len, self.window))
                self.prefix.insert(prompt, seg, tree_nbytes(seg))
            return logits, first, None
        pool, ps = self._pool, self._page_size
        n_alloc = pool.pages_needed(p_len + req.max_new_tokens)
        shared = depth // ps
        pages = pool.alloc(n_alloc - shared)  # before any retain: may raise
        pages[:0] = segment.handle[:shared]
        for pid in pages[:shared]:
            pool.retain(pid)
        cache = st.cache
        try:
            if depth % ps:
                copy_page(cache, int(segment.handle[shared]), pages[shared])
            row = pages + [cache.n_pages] * (cache.table.shape[1] - n_alloc)
            table = upload([row], torch.int32, self.device)
            view = PagedKVCache(
                k=cache.k, v=cache.v, table=table,
                index=torch.full((1,), depth, dtype=torch.int64, device=self.device),
                k_scale=cache.k_scale, v_scale=cache.v_scale, quant=cache.quant,
            )
            logits = self._dec_model(tokens, view, decode=True, last_pos=last)
            if first is None:
                first = self._first_token(slot, req, logits)
            cache.table[slot] = table[0]
            write_slot(st, slot, p_len, first[0], req.max_new_tokens)
        except Exception:
            pool.release_all(pages)
            raise
        if grow:
            self._insert_paged_segment(prompt, pages, p_len)
        return logits, first, pages

    def _start_pending(self, slot: int, req: Request, prompt: list[int], hit,
                       grow: bool) -> _PendingPrefill:
        """A chunked prefill's record and its batch-1 side cache (the
        engine's one chunk side cache): zeroed (:func:`.slots.zero_cache`),
        or on a prefix hit — the donor pinned first — seeded from its
        segment (:func:`.slots.seed_cache`) or, paged, from its pages
        (:func:`.slots.seed_cache_paged`). Paged, every page of the slot is
        allocated fresh now. If this raises, the donor and the pages are
        released and the error re-raised (the slot was free: nothing to
        park)."""
        pend = _PendingPrefill(req, slot, prompt)
        pend.grow = grow
        try:
            if self._paged:
                pend.pages = self._pool.alloc(
                    self._pool.pages_needed(len(prompt) + req.max_new_tokens))
            cache1 = self._chunk_side
            if hit is not None:
                pend.depth, pend.segment = hit
                self.prefix.acquire(pend.segment)
                if self._paged:
                    n_seg = self._pool.pages_needed(pend.depth)
                    pend.cache1 = seed_cache_paged(
                        cache1, self._state.cache, list(pend.segment.handle[:n_seg]),
                        pend.depth)
                else:
                    pend.cache1 = seed_cache(cache1, pend.segment.handle, pend.depth)
            else:
                pend.cache1 = zero_cache(cache1)
        except Exception:
            self._abandon_pending(pend)
            raise
        pend.done = pend.depth
        return pend

    @torch.no_grad()
    def _advance_one(self, pend: _PendingPrefill) -> list[Completion]:
        """One chunk of a pending prefill: a mid chunk (exactly
        ``prefill_chunk`` tokens, no host sync) or the final one
        (:meth:`_final_chunk`, one host sync for the first token), which
        admits the request. If the device work raises, the pending
        prefill is abandoned, the slot parked and the error re-raised."""
        try:
            self.n_chunks += 1
            if len(pend.prompt) - pend.done > self._chunk:
                self._mid_chunk(pend)
                return []
            _, first, pages = self._final_chunk(pend)
            first = int(self._fetch(first)[0])
        except Exception:
            self._abandon_pending(pend)
            self._park_failed(pend.slot, [])
            raise
        kind = "chunked_splice" if pend.segment is not None else "chunked"
        self.refills[kind] += 1
        self.prefix_hit_tokens += pend.depth
        segment = pend.segment
        pend.pages, pend.segment = [], None  # ownership moves to the slot
        del self._pending[pend.slot]
        return self._activate(pend.slot, pend.request, first, pages, segment)

    def _mid_chunk(self, pend: _PendingPrefill) -> None:
        """The next ``prefill_chunk`` prompt tokens into the side cache:
        the suffix continuation over one chunk, its logits unused."""
        toks = pend.prompt[pend.done:pend.done + self._chunk]
        self.model(self._tokens(toks, self._chunk), pend.cache1, decode=True, last_pos=0)
        pend.done += self._chunk

    def _final_chunk(self, pend: _PendingPrefill, first=None):
        """The rest of the prompt (at most one chunk, bucket-padded)
        through the same continuation, the first token sampled at its last
        real token, then the side cache written into the slot: copied
        (:func:`.slots.copy_slot`), or paged, its pages copied whole into
        the slot's fresh pages (:func:`.slots.write_slot_paged`). With
        ``grow`` the prompt's segment is inserted. Returns ``(logits,
        first, pages)``. No host sync."""
        req, slot, prompt = pend.request, pend.slot, pend.prompt
        p_len, rest = len(prompt), len(prompt) - pend.done
        tokens = self._tokens(prompt[pend.done:], bucket_len(rest, self.window))
        logits = self.model(tokens, pend.cache1, decode=True, last_pos=rest - 1)
        if first is None:
            first = self._first_token(slot, req, logits)
        st = self._state
        if self._paged:
            write_slot_paged(st, pend.cache1, pend.pages, slot, p_len, first[0],
                             req.max_new_tokens)
            if pend.grow:
                self._insert_paged_segment(prompt, pend.pages, p_len)
            return logits, first, pend.pages
        copy_slot(st, pend.cache1, slot)
        write_slot(st, slot, p_len, first[0], req.max_new_tokens)
        if pend.grow:
            seg = extract_segment(pend.cache1, bucket_len(p_len, self.window))
            self.prefix.insert(prompt, seg, tree_nbytes(seg))
        return logits, first, None

    def _abandon_pending(self, pend: _PendingPrefill) -> None:
        """Drop a chunked prefill: unpin its donor, return its pages, free
        its slot for the next refill."""
        if pend.segment is not None:
            self.prefix.release(pend.segment)
            pend.segment = None
        if pend.pages:
            self._pool.release_all(pend.pages)
            pend.pages = []
        self._pending.pop(pend.slot, None)

    def _insert_paged_segment(self, prompt: list[int], pages: list[int],
                              p_len: int) -> None:
        """Insert-on-prefill, paged: the segment is the tuple of page ids
        covering the prompt's positions, each given one more reference
        first (no device copy); a refused insert (already resident, or the
        budget full of pinned segments) returns them. Priced as pages x
        ``page_bytes``."""
        seg_ids = tuple(pages[: self._pool.pages_needed(p_len)])
        for pid in seg_ids:
            self._pool.retain(pid)
        if not self.prefix.insert(prompt, seg_ids, len(seg_ids) * self._page_bytes):
            self._pool.release_all(seg_ids)

    def _release_segment_pages(self, seg: Segment) -> None:
        """The prefix index's eviction hook (paged engines): a dropped
        segment returns its page references. Pinned segments are never
        evicted, so no slot decodes through these pages when they free."""
        self._pool.release_all(seg.handle)

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    @torch.no_grad()
    def teacher_forced_logits(self, prompt, tokens, rows: int = 1) -> torch.Tensor:
        """The serving path's logits on GIVEN tokens, to hold one read path
        against another: ``prompt`` is admitted into slot 0 as a request's
        would be, through :meth:`_admit` (spliced on a prefix hit, chunked
        when its uncached length exceeds ``prefill_chunk`` — every chunk at
        once — else prefilled whole; paged, with its pages) — then
        ``tokens[:-1]`` are fed to the decode model in place of sampled
        ones, ``rows`` a forward (1: one decode step at a time; k+1: the
        shape of a speculative verify forward whose drafts are all
        accepted). Row ``i`` of the (len(tokens), vocab) float32 result is
        the logits that chose ``tokens[i]``. Needs an idle engine; the
        slot, the donor segment and the pages are released afterwards. The
        request counters do not move; the prefix index sees the prompt's
        lookup (and insert) as a request's."""
        if not self.idle:
            raise RuntimeError("teacher_forced_logits needs an idle engine")
        if not tokens:
            raise ValueError("tokens must not be empty")
        if rows < 1:
            raise ValueError("rows must be >= 1")
        prompt = [int(t) for t in prompt]
        req = Request(prompt=prompt, max_new_tokens=len(tokens))
        first = upload([int(tokens[0])], torch.int64, self.device)
        logits, _, pages, segment, _, _ = self._admit(0, req, prompt, first,
                                                      all_chunks=True)
        act = _Active(req, int(tokens[0]), pages, segment)
        try:
            out = [logits[:1, -1]]
            feed = [int(t) for t in tokens[:-1]]
            for i in range(0, len(feed), rows):
                block = feed[i:i + rows]
                x = self._state.last_tok[:, None].repeat(1, len(block))
                x[0] = upload(block, torch.int64, self.device)
                out.append(self._dec_model(x, self._state.cache, decode=True)[0])
        finally:
            self._release(0, act)
        return torch.cat(out).float()

    def _first_token(self, slot: int, req: Request, logits) -> torch.Tensor:
        """Sample a refill's first token with the slot's generator reseeded
        from ``req.seed``; stays on the device."""
        gen = self._state.generators[slot]
        gen.manual_seed(req.seed)
        return sample_logits(
            logits[:, -1].float(), gen, self._temperature, self._top_k,
            self._top_p,
        )

    @torch.no_grad()
    def _chain(self) -> torch.Tensor:
        """``tokens_per_launch`` decode steps over every slot; returns the
        (n_slots, tokens_per_launch) token block, still on the device.
        Inactive slots re-emit their last token and keep stepping (their
        cache writes past the window, or through a parked slot's sentinel
        table, drop). No host sync."""
        st = self._state
        out = torch.empty(
            (self.n_slots, self.tokens_per_launch), dtype=torch.int64,
            device=self.device,
        )
        tok, remaining = st.last_tok, st.remaining
        for t in range(self.tokens_per_launch):
            active = remaining > 0
            logits = self._dec_model(tok[:, None], st.cache, decode=True)
            nxt = sample_logits_per_slot(
                logits[:, -1].float(), st.generators, self._temperature,
                self._top_k, self._top_p,
            )
            tok = torch.where(active, nxt, tok)
            remaining = remaining - active.to(remaining.dtype)
            out[:, t] = tok
        st.last_tok, st.remaining = tok, remaining
        return out

    @torch.no_grad()
    def _spec_chain(self) -> torch.Tensor:
        """The speculative chain (the JAX engine's ``_spec_chain_impl``):
        ``tokens_per_launch`` iterations over every slot of draft
        (:func:`..models.sampling.ngram_draft` over the slot's history),
        ONE (n_slots, k+1) verify forward of ``[last_tok, draft]`` through
        the decode model (each position conditions on the drafts before it,
        as sequential decode would), accept
        (:func:`..models.sampling.speculative_accept`), rewind the k -
        n_accept rejected positions
        (:func:`..models.transformer.rewind_cache_index`; their stale K/V is
        overwritten before any query reads it) and the history update
        (emitted tokens appended; columns past the count or the window go
        to the trash column). An inactive slot emits 0 tokens and keeps its
        history. Returns one (n_slots, T, k+2) int64 block on the device:
        ``[..., :k+1]`` the emitted tokens of each step, ``[..., k+1]`` how
        many of them are real. No host sync."""
        st = self._state
        k, win, dev = self._spec_k, self.window, self.device
        out = torch.empty((self.n_slots, self.tokens_per_launch, k + 2),
                          dtype=torch.int64, device=dev)
        rows = torch.arange(self.n_slots, device=dev)
        offs = torch.arange(k + 1, device=dev)
        tok, remaining, hist_len = st.last_tok, st.remaining, st.hist_len
        for t in range(self.tokens_per_launch):
            active = remaining > 0
            draft = ngram_draft(st.hist[:, :win], hist_len, k, self._spec_ngram)
            logits = self._dec_model(torch.cat([tok[:, None], draft], dim=1), st.cache,
                                     decode=True)
            emitted, n_acc = speculative_accept(
                logits.float(), draft, st.generators, self._temperature, self._top_k,
                self._top_p,
            )
            # the verify forward advanced every position by k+1; the slot
            # produced 1 + n_acc tokens, so the rest step back
            rewind_cache_index(st.cache, k - n_acc)
            n_emit = torch.where(active, n_acc + 1, 0)
            tok = torch.where(active, emitted[rows, n_acc], tok)
            cols = hist_len[:, None] + offs[None, :]
            cols = torch.where((offs[None, :] < n_emit[:, None]) & (cols < win), cols, win)
            st.hist[rows[:, None], cols] = emitted
            hist_len = torch.clamp(hist_len + n_emit, max=win)
            remaining = torch.clamp(remaining - n_emit, min=0)
            out[:, t, :k + 1] = emitted
            out[:, t, k + 1] = n_emit
        st.last_tok, st.remaining, st.hist_len = tok, remaining, hist_len
        return out

    def _release(self, slot: int, act: _Active) -> None:
        """A request left ``slot``. Its donor segment (a splice's) is
        unpinned. Paged engines park on EVERY completion — the slot keeps
        writing K/V each chain step, and through its live table those
        writes would land in pages handed back to the pool — and return
        its pages; others park only when budget remains."""
        if act.segment is not None:
            self.prefix.release(act.segment)
            act.segment = None
        if self._paged:
            park_slot_paged(self._state, slot)
            self._pool.release_all(act.pages)
            act.pages = []
        elif act.remaining > 0:
            self._state.remaining[slot].zero_()

    def _activate(self, slot: int, req: Request, first: int, pages=None,
                  segment: Segment | None = None) -> list[Completion]:
        """Admit a just-prefilled request into the decode phase; an EOS or
        ``max_new_tokens == 1`` first token completes it at once. Every
        refill kind (whole prefill, splice, chunked, chunked with a splice;
        paged or not) passes here, so this is where a speculative engine
        seeds the slot's draft history (:func:`.slots.seed_history`: the
        prompt, uploaded non-blocking, and the first token)."""
        self.generated_tokens += 1
        act = _Active(req, first, pages, segment)
        act.ttft_s = time.perf_counter() - req.submitted_s
        if req.max_new_tokens == 1 or first == req.eos_token:
            reason = "eos" if first == req.eos_token else "length"
            self._release(slot, act)
            return [self._complete(act, reason)]
        if self._spec:
            prompt = [int(t) for t in req.prompt]
            seed_history(self._state, upload([prompt], torch.int64, self.device),
                         len(prompt), slot, first)
        self._slots[slot] = act
        return []

    def _distribute(self, toks: torch.Tensor, view: list) -> list[Completion]:
        """Hand one fetched (S, T) chain block out to the slots of ``view``
        (the slot views at the chain's dispatch; a slot whose ``_Active``
        is no longer the live one — finished or refilled since — ignores
        the chain's rows); free every slot that finished (budget spent or
        EOS mid-chain) and park early-EOS slots whose device counter still
        shows budget."""
        done: list[Completion] = []
        rows = toks.tolist()
        for s, act in enumerate(view):
            if act is None or act is not self._slots[s]:
                continue
            reason = None
            for tok in rows[s][: act.remaining]:
                act.tokens.append(tok)
                act.remaining -= 1
                self.generated_tokens += 1
                if tok == act.request.eos_token:
                    reason = "eos"
                    break
            if reason is None and act.remaining == 0:
                reason = "length"
            if reason is not None:
                self._slots[s] = None
                self._release(s, act)
                done.append(self._complete(act, reason))
        return done

    def _distribute_spec(self, block: torch.Tensor, view: list) -> list[Completion]:
        """The speculative twin of :meth:`_distribute` (the JAX engine's
        ``_distribute_spec``) over one fetched (S, T, k+2) block: step t of
        slot s contributed ``block[s, t, k+1]`` real tokens (the accepted
        drafts and the bonus token); each counted step adds to
        ``spec_steps_consumed`` and its n - 1 accepted drafts to
        ``spec_drafts_accepted``. The host truncates at the request's
        budget as ``generate`` does (the device may have verified past it;
        those writes land in the slot's own window and the refill rewrites
        the slot). ``view`` as in :meth:`_distribute`."""
        done: list[Completion] = []
        k1 = self._spec_k + 1
        rows = block.tolist()
        for s, act in enumerate(view):
            if act is None or act is not self._slots[s]:
                continue
            reason = None
            for step in rows[s]:
                n = step[k1]
                if n == 0:  # the slot went inactive on the device
                    break
                self.spec_steps_consumed += 1
                self.spec_drafts_accepted += n - 1
                for tok in step[: min(n, act.remaining)]:
                    act.tokens.append(tok)
                    act.remaining -= 1
                    self.generated_tokens += 1
                    if tok == act.request.eos_token:
                        reason = "eos"
                        break
                if reason is not None or act.remaining == 0:
                    break
            if reason is None and act.remaining == 0:
                reason = "length"
            if reason is not None:
                self._slots[s] = None
                self._release(s, act)
                done.append(self._complete(act, reason))
        return done

    def _complete(self, act: _Active, reason: str) -> Completion:
        return Completion(
            request_id=act.request.request_id,
            prompt=[int(t) for t in act.request.prompt],
            tokens=act.tokens,
            finish_reason=reason,
            latency_s=time.perf_counter() - act.request.submitted_s,
            ttft_s=act.ttft_s,
        )
