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

Multi-tenant LoRA (``adapter_bank=``, an :class:`..adapters.bank.AdapterBank`):
the engine serves the bank's LoRA twin of the model, bound to the base
weights and to the bank's own factor tensors (no copy), so a register or
an evict on a live engine is seen by the next forward. Every slot carries
its request's adapter id (``SlotState.adapter_ids``) into the decode and
verify forwards, and every refill kind passes the request's id to its
forward, so tenants co-batch. ``Request.adapter`` is checked at submit
(an unregistered id raises) and its row's generation snapshotted; a
request whose tenant was evicted or replaced while it queued completes as
``"adapter_evicted"`` with no device work. Prefix keys are namespaced per
(adapter, generation) (:meth:`ServeEngine._prefix_key`), so tenants never
splice each other's segments, nor a recycled row its previous tenant's.
Id 0 is the base model, exactly. Without a bank the engine's state and
launches are those of the base engine.

Failure handling (the JAX engine's robustness layer) lives at the same
boundaries the scheduler does — between chains and at refill, never
inside a chain:

- deadlines (``Request.deadline_s``, or the engine's ``default_deadline_s``)
  and :meth:`ServeEngine.cancel` complete a request ``"deadline"`` /
  ``"cancelled"`` at the next boundary: an active slot at the sweep that
  opens every :meth:`ServeEngine.step` (its earned tokens kept, the slot
  released), a queued request or a pending chunked prefill at refill with
  no device work. At ``pipeline_depth`` 2 the boundary is the OBSERVED one,
  a chain behind the device; the in-flight chain's rows for a finished slot
  are dropped by the identity check;
- ``guard_nonfinite``: every chain step also writes a per-slot flag,
  ``isfinite`` over the slot's float logits row, into one more plane (or,
  speculative, one more column) of the chain's int64 block, so the flags
  land with the chain's one host sync and ride the same pinned ring at
  depth 2. A slot whose flag goes false completes ``"nonfinite"`` with the
  tokens before that step, and is released; co-scheduled slots decode on
  untouched. Guard off, the chain and its block are what they were;
- a refill that raises on the host (an injected ``ChaosError``, an
  out-of-memory error, a shape check) is isolated to its request: the
  donor is unpinned, the slot parked, its pages returned, a pending side
  cache abandoned, and the request completes ``"error"`` with no tokens
  while the engine keeps serving. A fault on the device (an illegal
  address) leaves the CUDA context unusable; no engine can isolate that;
- ``chaos=`` (:class:`..utils.chaos.ChaosConfig`) injects the faults those
  paths are tested with: NaN logits at one (slot, global decode step),
  decided on the host from the chain's number (no upload), a failing
  prefill, a stall before a chain's dispatch;
- ``flight=`` (:class:`..obs.flight.FlightRecorder`) stamps the request
  lifecycle, chains and faults at the same host boundaries; a stamp is a
  clock read and a deque append, never a sync.

Tensor-parallel serving (``strategy=``, a
:class:`..parallel.tensor_parallel.TensorParallel` over a ``model`` group
of ``tp`` processes; the JAX engine's ``strategy``): SPMD in PyTorch's
idiom. Every rank builds the same engine over the same whole weights,
which it cuts to its shard of the Megatron layout
(:func:`..parallel.tensor_parallel.shard_params`; the model's docstring
says which), receives the same submissions and runs the same
deterministic host loop; the forwards issue their collectives
explicitly (an ``all_reduce`` after each row-parallel projection, one
``all_gather`` of the logits), so every rank samples the same tokens from
the same bytes and rank 0's completions are the engine's output. The
slot state holds the rank's KV heads only (checked once at construction
against :data:`..parallel.tensor_parallel.SLOT_STATE_RULES`), so KV and
page bytes, the page price and the prefix budget are per rank.
:meth:`ServeEngine.tp_stats` and :meth:`ServeEngine.audit_decode` report
it. A host decision that reads the clock or the caller could differ
between ranks, and a rank that decides otherwise hangs its peers in a
collective (a rank that pops a request the others bounced prefills alone
and waits in its first ``all_reduce``). So rank 0 alone makes those
decisions — the sweep's deadline expiries and cancels, the refill
boundary's bounced requests, the chaos stall (it sleeps on rank 0 only;
the others wait in the next collective) — and, in each step where a
deadline is set (the engine's, or a live request's), a chaos stall is
configured or the engine is ``cancellable``, broadcasts its verdicts on
the step's live requests in ONE message over a CPU gloo group beside the
model group (:meth:`ServeEngine._decide`); the other ranks apply what they
receive, never their own clock. With none of these on, no broadcast is
issued. The decision groups of EVERY model group of the strategy's mesh
are made at the first engine's construction, in mesh order, on every
rank (``new_group`` is collective over the whole world), so a model group
may be smaller than the world — two TP engines on ``{"data": 2, "model":
2}`` — and every rank must construct its engines in the same order.
``tp`` 1 (or no strategy) is the replicated engine: the same state,
launches and syncs.

Disaggregation (``role=``, the JAX engine's prefill/decode roles;
DistServe, OSDI '24): a ``role="prefill"`` engine admits prompts and
prefills them (whole, spliced from its prefix cache, or chunked), but
instead of occupying a slot it cuts the finished batch-1 cache to the
prompt's bucket and completes the request ``"handoff"``, parking a
:class:`.scheduler.Handoff` (segment, first token, the request's
generator state) for :meth:`ServeEngine.take_handoff`; it makes no host
sync. A ``role="decode"`` engine admits work through
:meth:`ServeEngine.accept` only and rebuilds the monolithic post-prefill
slot from the segment — :func:`.slots.seed_cache` and
:func:`.slots.copy_slot` + :func:`.slots.write_slot`, or the paged write —
bitwise, since nothing is recomputed; the fetch of the first token is the
handoff's one sync, so its budget is chains + handoffs accepted. A
:class:`.router.FleetRouter` over such engines moves the handoffs. Under
tensor parallelism both role engines run over the same model group: rank
r's segment holds its own KV heads (about 1/tp of the unsharded bytes)
and moves rank-locally; the first token (sampled from the all-gathered
logits) and the generator state are the same on every rank.

SLO preemption (``priority_classes`` N > 0): a
:class:`.slo.PriorityScheduler` admits classes ``[0, N)`` and pops by
(class, arrival); at the chain boundary, when a strictly higher class
waits and no slot (or, paged, not enough of the pool) can take it, the
lowest-tier active request (:func:`.slo.choose_victim`) is SWAPPED OUT:
the in-flight chains are collected first (the host's view then equals
the device's), then ONE counted fetch brings its cache segment, last
token and (speculative) history to the host packed in one buffer, its
slot parks (paged: its pages return to the pool, its prefix donor is
released) and it requeues at its arrival position with a
:class:`.slo.SwapRecord`. When it pops again it is SWAPPED IN: the packed
buffer goes up through :func:`.slots.upload` (no fetch), the segment is
spliced back (fresh pages when paged) and its budget, generator state and
history restored verbatim, so it resumes token-exact. The budget is
chains + prefills + splices + swaps out. Under tensor parallelism every
rank submits the same requests in the same step order, so the waiting
classes, the slots, the free pages and the chaos chain count — hence
every preemption decision — are alike on every rank, with no broadcast;
each rank packs and fetches its own heads (its budget holds per rank),
and a swap-in's rank-local failure is agreed before it completes.

Contract sentry (``sentry=``, :class:`..obs.sentry.ContractSentry`): each
:meth:`ServeEngine.step` is one of its accounting rounds, every budgeted
fetch is declared to it (:meth:`ServeEngine._fetch`, the event wait of
:meth:`ServeEngine._land`) and each chain's inputs are walked for leaves
off the engine's device. Off, the engine makes the same syncs and
launches as without it. Under tensor parallelism each rank has its own.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time

import torch
import torch.distributed as dist

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
    TransformerConfig,
    TransformerLM,
    _kv_quant_mode,
    bind_params,
    rewind_cache_index,
    tp_layout,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import MODEL_AXIS
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    shard_params,
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
    Handoff,
    Request,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.slo import (
    PriorityScheduler,
    SwapRecord,
    choose_victim,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.slots import (
    bucket_len,
    copy_page,
    copy_slot,
    extract_segment,
    init_slot_state,
    pack,
    park_slot_paged,
    seed_cache,
    seed_cache_paged,
    seed_history,
    set_adapter,
    tree_nbytes,
    unpack,
    upload,
    write_slot,
    write_slot_paged,
    zero_cache,
)
from pytorch_distributed_training_tutorials_tpu_torch.utils import chaos as chaos_lib

_log = logging.getLogger(__name__)


def _cache_leaves(cache) -> dict[str, torch.Tensor]:
    """A slot cache's per-position leaves by name (``k``, ``v`` and,
    quantized, ``k_scale``, ``v_scale``) — the names the slot-state rules
    match."""
    return {name: getattr(cache, name) for name in ("k", "v", "k_scale", "v_scale")
            if getattr(cache, name) is not None}


# how a refill reached its first token: a whole prefill, a splice, or a
# chunked prefill's final chunk without and with a prefix hit
_REFILL_KINDS = ("prefill", "splice", "chunked", "chunked_splice")

# the verdicts rank 0 broadcasts under tensor parallelism, by code (0: none)
_VERDICTS = (None, "cancelled", "deadline")


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
    prefix hit, the prefix key the prompt's own segment is inserted under
    at the end (``grow``; None: not inserted) and, paged, the fresh pages
    allocated for the slot. The slot's device budget stays 0 until the
    final chunk, so decode chains treat it as inactive."""

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
        self.grow: list[int] | None = None
        self.pages: list[int] = []


# the decision groups of the current world: one CPU gloo group per model
# group (its global ranks), shared by every engine over that group
_DECISION_GROUPS: dict = {"world": None, "groups": {}}


def _model_groups(tp: TensorParallel) -> list[tuple[int, ...]]:
    """Every model group of ``tp``'s world, in mesh order: the rows of the
    mesh's ``model`` axis, or (``tp`` over a bare group) that group, which
    must then be the whole world."""
    mesh = tp.mesh
    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        ranks = tuple(dist.get_process_group_ranks(tp.group))
        if len(ranks) != dist.get_world_size():
            raise ValueError(
                f"a model group {list(ranks)} smaller than the world "
                f"({dist.get_world_size()} ranks) needs its mesh: pass "
                "TensorParallel(create_mesh({..., 'model': n})), so that every rank can "
                "make every model group's decision group")
        return [ranks]
    axis = mesh.mesh_dim_names.index(MODEL_AXIS)
    grid = mesh.mesh.movedim(axis, -1).reshape(-1, mesh.mesh.shape[axis])
    return [tuple(int(r) for r in row) for row in grid.tolist()]


def _decision_group(tp: TensorParallel):
    """A CPU gloo group over ``tp``'s model group, and the global rank of
    its rank 0: the channel of rank 0's host decisions. ``new_group`` is
    collective over the whole world, so the first call makes the groups of
    EVERY model group of the world, in mesh order, on every rank; later
    calls (another engine over any of them) reuse them. Every rank must
    therefore construct its engines in the same order."""
    world = dist.group.WORLD
    if _DECISION_GROUPS["world"] is not world:
        _DECISION_GROUPS.update(world=world, groups={})
    groups = _DECISION_GROUPS["groups"]
    for ranks in _model_groups(tp):
        if ranks not in groups:
            groups[ranks] = dist.new_group(list(ranks), backend="gloo")
    mine = tuple(dist.get_process_group_ranks(tp.group))
    return groups[mine], dist.get_global_rank(tp.group, 0)


def _base_cfg(cfg: TransformerConfig) -> TransformerConfig:
    return dataclasses.replace(cfg, lora_adapters=0, lora_rank=0, int8_mesh=None)


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
    flight; ``adapter_bank`` (None: off) serves LoRA tenants from an
    :class:`..adapters.bank.AdapterBank` built for ``model`` on the
    engine's device (module docstring).

    Failure handling (module docstring): ``default_deadline_s`` (None: no
    deadline) for requests without their own; ``guard_nonfinite`` the
    per-step finite flag and the slot quarantine; ``chaos`` a
    :class:`..utils.chaos.ChaosConfig`; ``flight`` a
    :class:`..obs.flight.FlightRecorder`. :meth:`cancel`,
    :meth:`fault_stats` and :meth:`flight_stats` go with them.

    ``strategy`` (None: replicated) a
    :class:`..parallel.tensor_parallel.TensorParallel`: with ``tp_size``
    > 1 the engine serves this rank's shard (module docstring) — ``model``
    and ``params`` the whole ones on every rank (or a model already built
    with ``cfg.int8_mesh`` set to the same strategy, holding its shard);
    :meth:`tp_stats` and :meth:`audit_decode` go with it. ``cancellable``
    (tensor parallel only; a replicated engine can always cancel):
    broadcast rank 0's verdicts every step, so :meth:`cancel` made on rank
    0 alone cancels on every rank.

    ``role`` (None: monolithic; ``"prefill"`` or ``"decode"``) splits the
    engine for a disaggregated fleet (module docstring; JAX ``:348-392``
    refuses the same options): a prefill engine takes no paged pool, no
    speculation and no pipelining, a decode engine no prefix cache and no
    chunked prefill. :meth:`take_handoff`, :meth:`accept` and :attr:`load`
    go with it. ``priority_classes`` (0: one FIFO class) turns on SLO
    preemption (module docstring), not beside a role. Both run under
    tensor parallelism (module docstring). ``sentry`` (None: off) a
    :class:`..obs.sentry.ContractSentry`; :meth:`sentry_stats` goes with
    it. Under tensor parallelism engines are constructed in the same
    order on every rank (their decision groups are made then)."""

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
        adapter_bank=None,
        default_deadline_s: float | None = None,
        guard_nonfinite: bool = False,
        chaos=None,
        flight=None,
        strategy: TensorParallel | None = None,
        cancellable: bool = False,
        role: str | None = None,
        priority_classes: int = 0,
        sentry=None,
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
        if default_deadline_s is not None and default_deadline_s <= 0:
            raise ValueError("default_deadline_s must be > 0 (None = no deadline)")
        if role not in (None, "prefill", "decode"):
            raise ValueError(f"role must be None (monolithic), 'prefill', or 'decode'; "
                             f"got {role!r}")
        if role == "prefill":
            for on, what in ((paged, "the paged pool"), (speculative_k, "speculation"),
                             (pipeline_depth != 1, "pipeline_depth")):
                if on:
                    raise ValueError(f"role='prefill' engines never decode: {what} belongs "
                                     "on the decode side")
        if role == "decode":
            for on, what in ((prefix_cache_bytes, "the prefix cache"),
                             (prefill_chunk, "prefill_chunk")):
                if on:
                    raise ValueError(f"role='decode' engines never prefill a prompt: {what} "
                                     "belongs on the prefill side")
        if priority_classes < 0:
            raise ValueError("priority_classes must be >= 0 (0 = single-class FIFO)")
        if priority_classes and role is not None:
            raise ValueError("priority_classes requires role=None: preemption swaps in "
                             "through the monolithic refill path; role-split fleets shape "
                             "traffic at the router")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.device = resolve_device(device)
        if strategy is None:
            strategy = model.cfg.int8_mesh
        elif model.cfg.int8_mesh not in (None, strategy):
            raise ValueError("strategy differs from the model's cfg.int8_mesh")
        # the sharded gate: tp 1 or no strategy is the replicated engine
        self._tp = strategy if strategy is not None and strategy.tp_size > 1 else None
        self._tp_audit = None
        if self._tp is not None:
            model, params = self._sharded(model, params, self._tp)
        if params is not None:
            bind_params(
                model, {k: v.to(self.device) for k, v in params.items()}
            )
        self._bank = adapter_bank
        if adapter_bank is not None:
            if _base_cfg(model.cfg) != _base_cfg(adapter_bank.model.cfg):
                raise ValueError("adapter_bank was built for a different model config")
            if adapter_bank.device != self.device:
                raise ValueError(f"adapter_bank lives on {adapter_bank.device}, the engine "
                                 f"on {self.device}")
            # the LoRA twin over the base weights and the bank's own
            # factor tensors: register/evict write what the forwards read
            # (tensor parallel: the rank's views of them)
            factors = adapter_bank.factors
            if self._tp is not None:
                factors = shard_params(factors, self._tp.rank, self._tp.tp_size,
                                       head_dim=model.cfg.head_dim, views=True)
            lora = TransformerLM(dataclasses.replace(adapter_bank.model.cfg,
                                                     int8_mesh=model.cfg.int8_mesh))
            bind_params(lora, {**model.state_dict(), **factors})
            model = lora
            self._merged_version = adapter_bank.version
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
        self._role = role
        self._slo = priority_classes > 0
        self._n_classes = int(priority_classes)
        self.scheduler = (
            PriorityScheduler(self.window, max_queue=max_queue, n_classes=self._n_classes)
            if self._slo else FifoScheduler(self.window, max_queue=max_queue))
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
                                      history=self.window if self._spec else 0,
                                      adapters=adapter_bank is not None)
        if self._tp is not None:
            self._check_shard_shapes()
        # pipelining: the chains in flight, and at depth >= 2 on a card one
        # pinned host buffer per chain in flight for its token block
        self._depth = int(pipeline_depth)
        self._inflight: collections.deque[_InFlight] = collections.deque()
        # failure handling: the guard widens the chain's block by the
        # flags (a plane, or speculative a column); the rest is host state
        self._deadline = default_deadline_s
        self._guard = bool(guard_nonfinite)
        self._chaos = chaos
        self._flight = flight
        # the contract sentry (None: off, and nothing below changes): one
        # accounting round a step, every budgeted fetch through _fetch
        self._sentry = sentry
        self._cancelled: set[int] = set()
        # tensor parallel: rank 0's verdicts of this step (None: each rank
        # decides itself — replicated, or no clock feature on) and their
        # gloo channel, made here (every model group's, in mesh order)
        self._cancellable = bool(cancellable)
        self._decided: dict[int, str] | None = None
        self._dgroup = self._dsrc = None
        if self._tp is not None:
            self._dgroup, self._dsrc = _decision_group(self._tp)
        self.n_decision_broadcasts = 0
        self.n_swap_agreements = 0
        self.n_deadline_expired = 0
        self.n_cancelled = 0
        self.nonfinite_quarantined = 0
        self.n_prefill_errors = 0
        if self._spec:
            block = (n_slots, tokens_per_launch, self._spec_k + 2 + self._guard)
        else:
            block = ((2,) if self._guard else ()) + (n_slots, tokens_per_launch)
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
        # roles and SLO: the batch-1 cache a handoff's segment is prefilled
        # into or spliced from, and a swap's segment gathered into or
        # spliced from
        self._xfer = (KVCache.zeros(model.cfg, 1, device=self.device)
                      if role is not None or self._slo else None)
        # disaggregation: handoffs emitted for the router to collect
        # (prefill role) and accepted, waiting for a slot (decode role)
        self._handoffs: dict[int, Handoff] = {}
        self._handoff_in: dict[int, Handoff] = {}
        self.n_handoffs_out = 0
        self.n_handoffs_in = 0
        # SLO preemption (only with priority_classes: an off engine has
        # none of these): parked requests by id, the chaos force-preempt's
        # one-shot latch, the counters
        if self._slo:
            self._swapped: dict[int, SwapRecord] = {}
            self._chaos_preempt_fired = False
            self.n_swaps_out = 0
            self.n_swaps_in = 0
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
        # adapters: refills served under a non-base adapter, and queued
        # requests completed as "adapter_evicted"
        self.adapter_requests = 0
        self.adapter_rejected = 0

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
        ``ValueError`` when the request can never fit the window, names
        an adapter this engine cannot serve (no bank, or an unregistered or
        out-of-range id) or a priority outside its classes, or (paged)
        :class:`.pages.PoolExhausted` when it needs more pages than the
        whole pool holds. Admission snapshots the adapter row's generation
        into ``request.adapter_gen``. A decode-role engine refuses it
        (``ValueError``; JAX ``:1762``): its work comes through
        :meth:`accept`."""
        if self._role == "decode":
            raise ValueError("role='decode' engines admit work via accept(request, handoff), "
                             "not submit(): a prompt with no finished prefill attached has "
                             "nothing to decode from")
        return self._enqueue(request)

    def _enqueue(self, request: Request) -> int:
        """The admission body of :meth:`submit` and :meth:`accept`: the
        adapter and page checks, the scheduler's enqueue, the recorder's
        stamp."""
        aid = int(request.adapter)
        if aid and self._bank is None:
            raise ValueError(f"request names adapter {aid} but the engine has no adapter "
                             "bank (pass ServeEngine(adapter_bank=...))")
        if self._bank is not None:
            self._bank.check_id(aid)
            request.adapter_gen = self._bank.generation(aid)
        if self._paged:
            need = self._pool.pages_needed(
                len(request.prompt) + request.max_new_tokens
            )
            if need > self._pool.pool_pages:
                self._pool.shed()
                if self._flight is not None:
                    self._flight.record("pool_shed", p_len=len(request.prompt),
                                        max_new=request.max_new_tokens, pages=need)
                raise PoolExhausted(
                    f"request needs {need} pages but the pool holds "
                    f"{self._pool.pool_pages} ({self._pool.page_size} tokens "
                    "each) — shrink the request or grow the pool"
                )
        rid = self.scheduler.submit(request)
        if self._flight is not None:
            # after admission: a rejected submit opens no span
            self._flight.request_submitted(rid, p_len=len(request.prompt),
                                           max_new=request.max_new_tokens, adapter=aid)
        return rid

    def accept(self, request: Request, handoff: Handoff) -> int:
        """Decode-role admission (JAX ``:1815``): enqueue ``request`` with
        its finished prefill attached; returns its id here. The segment is
        checked against this engine's cache first (:meth:`_validate_segment`:
        a segment of another storage, window or layer count raises
        ``ValueError`` now, not inside a forward), then admission runs as
        :meth:`submit`'s. The handoff's ``submitted_s`` replaces the
        scheduler's stamp, so latency and TTFT span the original submit."""
        if self._role != "decode":
            raise ValueError("accept() needs role='decode': monolithic and prefill-role "
                             "engines take work via submit()")
        self._validate_segment(handoff)
        rid = self._enqueue(request)
        if handoff.submitted_s:
            request.submitted_s = handoff.submitted_s
        self._handoff_in[rid] = handoff
        return rid

    def take_handoff(self, request_id: int) -> Handoff:
        """Pop the :class:`.scheduler.Handoff` this prefill-role engine
        emitted for ``request_id`` (JAX ``:1837``; the router calls it on
        the ``"handoff"`` completion). Its tensors leave with it."""
        if self._role != "prefill":
            raise ValueError("take_handoff() needs role='prefill': only prefill-role "
                             "engines emit handoffs")
        return self._handoffs.pop(request_id)

    def _validate_segment(self, handoff: Handoff) -> None:
        """A handoff's segment must be a batch-1 cache of this engine's
        storage (JAX ``:1850``): the same KV quantization, the same leaves
        with the same dtypes, layer count, KV heads and head width, and
        positions no more than this engine's window, covering the prompt."""
        seg, proto = handoff.segment, self._xfer
        if not isinstance(seg, KVCache) or seg.quant != proto.quant:
            raise ValueError("handoff segment does not match this engine's cache layout "
                             "(different model config or KV cache storage?)")
        got, want = _cache_leaves(seg), _cache_leaves(proto)
        if got.keys() != want.keys():
            raise ValueError(f"handoff segment leaves {sorted(got)} are not this engine's "
                             f"{sorted(want)}")
        for name, leaf in got.items():
            p = want[name]
            if (leaf.dtype != p.dtype or leaf.ndim != p.ndim
                    or leaf.shape[:2] != p.shape[:2] or leaf.shape[3:] != p.shape[3:]):
                raise ValueError(f"handoff segment leaf {name} {leaf.dtype}{tuple(leaf.shape)} "
                                 f"does not match this engine's {p.dtype}{tuple(p.shape)}")
            if not handoff.p_len <= leaf.shape[2] <= self.window:
                raise ValueError(f"handoff segment of {leaf.shape[2]} positions does not fit "
                                 f"this engine's window ({self.window}) or cover its prompt "
                                 f"({handoff.p_len})")

    @property
    def role(self) -> str | None:
        return self._role

    @property
    def load(self) -> int:
        """The host-visible backlog (JAX ``:1902``): active + pending +
        queued + accepted handoffs waiting for a slot — the router's
        least-loaded decode placement key. Host counting only."""
        return (self.active_slots + len(self._pending) + len(self.scheduler)
                + len(self._handoff_in))

    @property
    def active_slots(self) -> int:
        return sum(a is not None for a in self._slots)

    @property
    def idle(self) -> bool:
        return (self.active_slots == 0 and not self._pending
                and len(self.scheduler) == 0 and not self._inflight
                and not self._handoff_in)

    @torch.no_grad()
    def step(self) -> list[Completion]:
        """One scheduling round: sweep the active slots for cancels and
        expired deadlines (:meth:`_sweep`, at the observed chain boundary;
        under tensor parallelism rank 0's verdicts, :meth:`_decide`),
        advance each chunked prefill by one chunk, with SLO classes
        preempt for a waiting higher class (:meth:`_maybe_preempt`), refill
        free slots from the queue (a preempted request swaps back in), dispatch one decode chain over all slots, then collect
        the oldest in-flight chain and hand out its tokens while more than
        ``pipeline_depth - 1`` are in flight (all of them once no slot is
        active). Depth 1 collects the chain it just dispatched: the serial
        loop. Returns the requests that finished this round (possibly
        mid-chain — surplus chain tokens of a finished slot are
        discarded). A bank whose version moved since the last step (a
        register or an evict) is picked up first
        (:meth:`refresh_adapters`). With a sentry the round is one of its
        accounting windows (``begin_round`` / ``end_round``)."""
        if self._sentry is None:
            return self._step_impl()
        self._sentry.begin_round(f"step:{self.n_chains}")
        try:
            return self._step_impl()
        finally:
            self._sentry.end_round()

    def _step_impl(self) -> list[Completion]:
        if self._bank is not None and self._bank.version != self._merged_version:
            self.refresh_adapters()
        if self._tp is not None:
            self._decided = self._decide()
        done: list[Completion] = self._sweep()
        if self._flight is not None and done:
            self._flight.sweep(len(done))
        # pending prefills advance BEFORE refill, so a chunked prefill
        # begun this round is not advanced twice
        for slot in list(self._pending):
            done.extend(self._advance_one(self._pending[slot]))
        if self._slo:
            # before refill: a slot freed by a swap-out takes the waiting
            # higher class this very round
            done.extend(self._maybe_preempt())
        for s in range(self.n_slots):
            if self._slots[s] is not None or s in self._pending:
                continue
            req = self._pop_request()
            if req is None:
                break
            if self._flight is not None:
                self._flight.request_popped(req.request_id)
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
        with the slot views of this moment. The recorder's ``chain_start``
        and the chaos stall come first, then the sentry's walk of the
        chain's inputs (its parameters, buffers and slot cache)."""
        chain_id = self.n_chains
        if self._flight is not None:
            self._flight.chain_start(self.active_slots, self.n_slots, chain=chain_id)
        if self._chaos is not None and (self._tp is None or self._tp.rank == 0):
            # under tensor parallelism the stall is rank 0's host alone:
            # the others wait for it in the next collective
            chaos_lib.maybe_stall(self._chaos, chain_id, flight=self._flight)
        if self._sentry is not None:
            # the re-upload probe over the chain's inputs: a leaf off the
            # engine's device is copied up on every chain
            self._sentry.check_args(
                {"params": self._dec_model.state_dict(keep_vars=True),
                 "cache": _cache_leaves(self._state.cache)},
                label="decode_chain", device=self.device)
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
        before = self.generated_tokens
        if self._spec:
            done = self._distribute_spec(block, fl.view)
        else:
            done = self._distribute(block, fl.view)
        if self._flight is not None:
            self._flight.chain_end(tokens=self.generated_tokens - before,
                                   occupancy=self.active_slots, chain=fl.chain_id)
        return done

    def _land(self, fl: _InFlight) -> torch.Tensor:
        """A chain's host sync, counted: the ``.cpu()`` of its block
        (:meth:`_fetch`), or the wait on its event when the block's copy
        to a pinned buffer was queued at dispatch. Host memory out."""
        if fl.event is None:
            return self._fetch(fl.block)
        self.n_host_syncs += 1
        if self._sentry is not None:
            # an event wait escapes the sentry's probes: counted here
            self._sentry.budgeted_fetch()
            self._sentry.note_fetch()
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

    def refresh_adapters(self) -> None:
        """Take up the bank's current version. The engine's LoRA model
        holds the bank's factor tensors themselves, so a register or an
        evict is already what the next forward reads; this checks that
        binding (every factor parameter of the prefill and decode models
        at the bank tensor's address) and records the version. :meth:`step`
        calls it when the version moved."""
        if self._bank is None:
            raise ValueError("engine has no adapter bank")
        factors = self._bank.factors
        for model in {id(m): m for m in (self.model, self._dec_model)}.values():
            for name, p in model.named_parameters():
                # the bank's tensor itself, or (tensor parallel) a view of it
                if name in factors and (p.untyped_storage().data_ptr()
                                        != factors[name].untyped_storage().data_ptr()):
                    raise RuntimeError(f"{name} is no longer the bank's tensor")
        self._merged_version = self._bank.version
        if self._flight is not None:
            self._flight.record("adapter_refresh", version=self._merged_version)

    def adapter_stats(self) -> dict[str, int]:
        """Multi-tenancy counters (the JAX engine's keys): the bank's
        geometry and occupancy, refills served under a non-base adapter,
        queued requests completed as ``"adapter_evicted"``. Host
        bookkeeping only."""
        if self._bank is None:
            return {"adapters": 0}
        reg = self._bank.registry
        return {
            "adapters": 1,
            "n_adapters": self._bank.n_adapters,
            "lora_rank": self._bank.rank,
            "adapters_registered": len(reg),
            "adapter_requests": self.adapter_requests,
            "adapter_rejected": self.adapter_rejected,
            "adapter_bytes": reg.used_bytes,
        }

    def fault_stats(self) -> dict[str, int | float]:
        """Failure-handling counters (the JAX engine's keys): the configured
        deadline, guard and chaos, and how many requests each path
        completed. Host bookkeeping only."""
        return {
            "deadline_s": float(self._deadline or 0.0),
            "guard_nonfinite": int(self._guard),
            "chaos": int(self._chaos is not None),
            "deadline_expired": self.n_deadline_expired,
            "cancelled": self.n_cancelled,
            "nonfinite_quarantined": self.nonfinite_quarantined,
            "prefill_errors": self.n_prefill_errors,
        }

    def flight_stats(self) -> dict[str, int | float]:
        """The flight recorder's summary (event, span and dump counters,
        the histograms' percentiles), or ``{"flight": 0}`` without one.
        Host bookkeeping only."""
        if self._flight is None:
            return {"flight": 0}
        return self._flight.summary()

    def pipeline_stats(self) -> dict[str, int]:
        """Pipelining counters (the JAX engine's keys): the depth, the
        prefill chunk and the chunks run. Host bookkeeping only."""
        return {"pipeline_depth": self._depth, "prefill_chunk": self._chunk,
                "n_chunks": self.n_chunks}

    def role_stats(self) -> dict[str, int | str]:
        """Disaggregation fields (the JAX engine's keys): the role and the
        handoffs emitted and accepted; ``{"role": 0}`` when monolithic.
        Host bookkeeping only."""
        if self._role is None:
            return {"role": 0}
        return {"role": self._role, "handoffs_out": self.n_handoffs_out,
                "handoffs_in": self.n_handoffs_in}

    def slo_stats(self) -> dict[str, int]:
        """SLO-tier fields (the JAX engine's keys): the class count, the
        preemptions (swaps out), swaps in and requests parked now;
        ``{"priority_classes": 0}`` when off. Host bookkeeping only."""
        if not self._slo:
            return {"priority_classes": 0}
        return {"priority_classes": self._n_classes, "preemption": 1,
                "n_preemptions": self.n_swaps_out, "n_swaps_out": self.n_swaps_out,
                "n_swaps_in": self.n_swaps_in, "swapped_now": len(self._swapped)}

    def sentry_stats(self) -> dict[str, int | float]:
        """Contract-sentry fields (the JAX engine's keys): the sentry's
        ``summary()``, or ``{"sentry": 0}`` when off. A fleet sharing one
        sentry reports fleet-wide numbers; ``FleetRouter.stats()`` merges
        by sentry identity. Host bookkeeping only."""
        if self._sentry is None:
            return {"sentry": 0}
        return self._sentry.summary()

    _STATS_PARTS = ("prefix", "spec", "adapters", "fault", "flight", "pipeline", "pages",
                    "tp", "role", "sentry", "slo")

    def stats(self, *parts: str) -> dict[str, int | float]:
        """One dict over the per-subsystem stats (the JAX engine's parts
        this engine has): every part, or those named (``stats("fault",
        "flight")``). The key sets are disjoint. Host bookkeeping only."""
        chosen = parts or self._STATS_PARTS
        unknown = set(chosen) - set(self._STATS_PARTS)
        if unknown:
            raise ValueError(f"unknown stats parts {sorted(unknown)}; known: "
                             f"{list(self._STATS_PARTS)}")
        fns = {"prefix": self.prefix_stats, "spec": self.spec_stats,
               "adapters": self.adapter_stats, "fault": self.fault_stats,
               "flight": self.flight_stats, "pipeline": self.pipeline_stats,
               "pages": self.page_stats, "tp": self.tp_stats, "role": self.role_stats,
               "sentry": self.sentry_stats, "slo": self.slo_stats}
        out: dict[str, int | float] = {}
        for part in self._STATS_PARTS:
            if part in chosen:
                out.update(fns[part]())
        return out

    @staticmethod
    def _sharded(model: TransformerLM, params, tp: TensorParallel):
        """``(model, params)`` of this rank: a model built with
        ``cfg.int8_mesh`` already holds (or is given) its shard; a whole
        one's weights (``params``, or the model's own) are cut to the
        rank's (copies: the whole tree can go) and bound to its sharded
        twin."""
        if model.cfg.int8_mesh is not None:
            return model, params
        whole = params if params is not None else model.state_dict()
        cfg = dataclasses.replace(model.cfg, int8_mesh=tp)
        return TransformerLM(cfg), shard_params(whole, tp.rank, tp.tp_size,
                                                head_dim=cfg.head_dim)

    def _whole_cache(self) -> KVCache | PagedKVCache:
        """The slot cache as the unsharded engine would hold it, on the
        meta device (shapes and dtypes only)."""
        cfg = dataclasses.replace(self._dec_model.cfg, int8_mesh=None)
        if cfg.kv_pages:
            return PagedKVCache.zeros(cfg, self.n_slots, device="meta")
        return KVCache.zeros(cfg, self.n_slots, device="meta")

    def _check_shard_shapes(self) -> None:
        """The counterpart of the JAX engine's ``_pin``, once: every slot
        cache leaf this rank holds has the shard shape the slot-state
        rules give the whole one (KV heads split, unless the group size
        does not divide them; everything else whole)."""
        whole = _cache_leaves(self._whole_cache())
        want = self._tp.shard_shapes({k: v.shape for k, v in whole.items()})
        got = {k: tuple(v.shape) for k, v in _cache_leaves(self._state.cache).items()}
        if got != want:
            raise RuntimeError(f"slot state shapes {got} are not the shard shapes {want}")

    def tp_stats(self) -> dict[str, int | float | str | bool]:
        """Tensor-parallel fields (the JAX engine's keys): ``{"tp": 1}``
        replicated; else ``tp``, ``mesh_shape`` (``"model:N"``), the
        backend, ``tp_kv_bytes_per_chip`` (this rank's slot cache: K, V,
        scales, positions and tables) beside ``tp_kv_bytes_global`` (the
        unsharded engine's), and after :meth:`audit_decode`
        ``tp_collectives`` (the audited chain's total) and ``tp_hlo_ok``
        (its verdict; the JAX key, whose audit reads the compiled
        program). Host arithmetic only."""
        if self._tp is None:
            return {"tp": 1}
        out: dict[str, int | float | str | bool] = {
            "tp": self._tp.tp_size,
            "mesh_shape": ",".join(f"{k}:{v}" for k, v in self._tp.mesh_shape.items()),
            "tp_backend": self._tp.backend,
            "tp_kv_bytes_per_chip": tree_nbytes(self._state.cache),
            "tp_kv_bytes_global": tree_nbytes(self._whole_cache()),
            "tp_decision_broadcasts": self.n_decision_broadcasts,
        }
        if self._slo:
            out["tp_swap_agreements"] = self.n_swap_agreements
        if self._tp_audit is not None:
            out["tp_collectives"] = sum(self._tp_audit["collectives"].values())
            out["tp_hlo_ok"] = self._tp_audit["ok"]
        return out

    def expected_collectives(self, forwards: int = 1) -> dict[str, int]:
        """The collectives ``forwards`` decode forwards of this engine
        issue: an ``all_reduce`` after each split row-parallel projection
        (o_proj, down_proj; with an adapter bank one more for each one's
        LoRA delta) a layer, one ``all_gather`` of split logits."""
        lay = tp_layout(self._dec_model.cfg)
        rows = (lay.split_heads + lay.split_ff) * (1 + (self._bank is not None))
        return {"all_reduce": forwards * self._dec_model.cfg.n_layers * rows,
                "all_gather": forwards * int(lay.split_vocab)}

    @torch.no_grad()
    def audit_decode(self) -> dict:
        """Run one decode chain over the (idle) slots and count the
        collectives it issued (the counterpart of the JAX engine's
        ``audit_decode_hlo``): ``ok`` only at exactly
        :meth:`expected_collectives` for its ``tokens_per_launch`` forwards
        — an ``all_reduce`` after each row-parallel projection and one
        logits ``all_gather`` a forward; a stray collective (a K/V gather, a
        reshard) fails it. Every rank calls it at the same point (the chain
        issues collectives). Idle slots step as inactive ones always do (no
        token is kept; refills rewrite their state). No host sync beyond
        what the backend's collectives make."""
        if self._tp is None:
            raise ValueError("audit_decode needs a tensor-parallel engine (strategy with tp > 1)")
        if not self.idle:
            raise RuntimeError("audit_decode needs an idle engine")
        self._tp.reset_collectives()
        self._spec_chain() if self._spec else self._chain()
        got = dict(self._tp.collectives)
        want = self.expected_collectives(self.tokens_per_launch)
        problems = [f"{kind}: {got.get(kind, 0)} != {n}" for kind, n in want.items()
                    if got.get(kind, 0) != n]
        problems += [f"unexpected {kind}: {n}" for kind, n in got.items()
                     if kind not in want and n]
        self._tp_audit = {"collectives": got, "expected": want,
                          "forwards": self.tokens_per_launch, "problems": problems,
                          "ok": not problems}
        return self._tp_audit

    def run_until_idle(self, max_steps: int = 10_000) -> list[Completion]:
        """Drain queue + slots; returns completions in finish order."""
        out: list[Completion] = []
        for _ in range(max_steps):
            if self.idle:
                return out
            out.extend(self.step())
        raise RuntimeError(f"not idle after {max_steps} steps")

    def cancel(self, request_id: int) -> bool:
        """Cancel a request on the host. True when ``request_id`` is queued,
        pending a chunked prefill or decoding: it completes ``"cancelled"``
        at the next boundary (queued or pending: no tokens and no further
        device work — a preempted request keeps the tokens it earned;
        decoding: the tokens landed so far are kept and the slot released).
        False for an id that finished or was never submitted. No sync, no
        interrupt of a running chain.

        Under tensor parallelism the engine must be ``cancellable`` (else
        ``ValueError``) and the call is made on rank 0: its next step's
        broadcast carries the cancel to every rank. On another rank the
        call only reports whether the id is known and changes nothing."""
        known = (any(a is not None and a.request.request_id == request_id
                     for a in self._slots)
                 or any(p.request.request_id == request_id for p in self._pending.values())
                 or self.scheduler.has(request_id))
        if self._tp is not None:
            if not self._cancellable:
                raise ValueError("cancel() under tensor parallelism needs "
                                 "ServeEngine(cancellable=True): rank 0 decides, and its "
                                 "verdicts are broadcast each step")
            if self._tp.rank != 0:
                return known
        if known:
            self._cancelled.add(request_id)
        return known

    def _live_requests(self) -> list[Request]:
        """Every request the engine holds, in a fixed order (slots,
        pending prefills, the queue): the same list on every rank."""
        return ([a.request for a in self._slots if a is not None]
                + [p.request for p in self._pending.values()] + list(self.scheduler))

    def _decide(self) -> dict[int, str] | None:
        """Tensor parallel: this step's verdicts, rank 0's. When a deadline
        is set (the engine's, or a live request's), a chaos stall is
        configured or the engine is ``cancellable`` — a condition every
        rank evaluates alike — rank 0 judges each live request
        (``"cancelled"``, ``"deadline"`` or nothing, on its own clock and
        its own cancels) and broadcasts the codes in ONE message over the
        CPU gloo group (:func:`_decision_group`, made at construction);
        every rank returns ``{request_id: verdict}`` from
        it, applied by :meth:`_sweep` and :meth:`_bounced` this step. Else
        None: no broadcast, and the local checks (which then find nothing
        to do) stand."""
        live = self._live_requests()
        c = self._chaos
        if not (self._cancellable or self._deadline is not None
                or (c is not None and c.stalls)
                or any(r.deadline_s is not None for r in live)):
            return None
        codes = torch.zeros(max(1, len(live)), dtype=torch.int64)
        if self._tp.rank == 0:
            now = time.perf_counter()
            for i, r in enumerate(live):
                if r.request_id in self._cancelled:
                    codes[i] = 1
                elif self._expired(r, now):
                    codes[i] = 2
        dist.broadcast(codes, src=self._dsrc, group=self._dgroup)
        self.n_decision_broadcasts += 1
        return {r.request_id: _VERDICTS[code]
                for r, code in zip(live, codes.tolist()) if code}

    def _deadline_for(self, req: Request) -> float | None:
        return req.deadline_s if req.deadline_s is not None else self._deadline

    def _expired(self, req: Request, now: float | None = None) -> bool:
        dl = self._deadline_for(req)
        if dl is None:
            return False
        return (time.perf_counter() if now is None else now) - req.submitted_s > dl

    def _verdict(self, req: Request, now: float | None = None,
                 **fields) -> str | None:
        """``"cancelled"``, ``"deadline"`` or None for ``req`` at this
        boundary — rank 0's broadcast verdict under tensor parallelism,
        else this host's cancel set and clock — counted (and a deadline
        stamped on the recorder with ``fields``)."""
        if self._decided is not None:
            reason = self._decided.get(req.request_id)
        elif req.request_id in self._cancelled:
            reason = "cancelled"
        else:
            reason = "deadline" if self._expired(req, now) else None
        if reason == "cancelled":
            self._cancelled.discard(req.request_id)
            self.n_cancelled += 1
        elif reason == "deadline":
            self.n_deadline_expired += 1
            if self._flight is not None:
                self._flight.fault("deadline", rid=req.request_id, **fields)
        return reason

    def _sweep(self) -> list[Completion]:
        """The boundary check of the active slots: complete each one whose
        request was cancelled or whose deadline passed, keeping its tokens,
        and release its slot (:meth:`_release`). Host bookkeeping and the
        park; no sync."""
        done: list[Completion] = []
        if self._decided is not None:
            if not self._decided:
                return done
        elif not self._cancelled and self._deadline is None and not any(
                a is not None and a.request.deadline_s is not None for a in self._slots):
            return done
        now = time.perf_counter()
        for s, act in enumerate(self._slots):
            if act is None:
                continue
            reason = self._verdict(act.request, now, slot=s)
            if reason is None:
                continue
            self._slots[s] = None
            self._release(s, act)
            done.append(self._complete(act, reason))
        return done

    def _bounced(self, req: Request, slot: int | None = None,
                 rec: SwapRecord | None = None) -> Completion | None:
        """The refill boundary's check of a request that holds no slot yet
        (queued, or pending a chunked prefill): its completion when it was
        cancelled or its deadline passed, else None. A preempted request
        (``rec``) keeps the tokens it earned before the swap."""
        reason = self._verdict(req, **({} if slot is None else {"slot": slot}))
        return None if reason is None else self._bounce(req, rec, reason)

    def _bounce(self, req: Request, rec: SwapRecord | None, reason: str) -> Completion:
        """A boundary completion of a request that holds no slot: no tokens
        for one that never started, the earned tokens of a preempted one."""
        if rec is not None:
            return self._complete(rec.active, reason)
        return self._complete_unstarted(req, reason)

    # -- SLO preemption: swap out, swap in --------------------------------

    def _maybe_preempt(self) -> list[Completion]:
        """The preemption decision (JAX ``:2145``), at the chain boundary.
        Pressure: a strictly higher class waits and no slot can take it —
        every slot is occupied or pending, or (paged, JAX ``:2186-2194``)
        the pool cannot back the best waiter even with a free slot. Then
        the lowest-tier active slot (:func:`.slo.choose_victim`) is swapped
        out (:meth:`_swap_out`), after every in-flight chain is collected
        (each its own counted sync): at depth 2 the device runs a chain
        ahead of the host's view, and the swap must capture what the host
        has accounted for; a victim that finished in a collected chain is
        not swapped. The chaos ``preempt_at_chain`` forces its named slot
        through the same path, once."""
        done: list[Completion] = []
        c = self._chaos
        if (c is not None and c.preempts and not self._chaos_preempt_fired
                and self.n_chains >= c.preempt_at_chain):
            self._chaos_preempt_fired = True
            victim = int(c.preempt_slot)
            if victim >= self.n_slots or self._slots[victim] is None:
                return done
        else:
            wait = self.scheduler.peek_priority()
            if wait is None:
                return done
            pressure = not any(self._slots[s] is None and s not in self._pending
                               for s in range(self.n_slots))
            if not pressure and self._paged:
                head = self.scheduler.peek_request()
                if int(head.priority) == wait:
                    need = self._pool.pages_needed(len(head.prompt) + head.max_new_tokens)
                    pressure = self._pool.available < need
            if not pressure:
                return done
            victim = choose_victim(
                [(s, int(a.request.priority), a.request.request_id)
                 for s, a in enumerate(self._slots) if a is not None], wait)
            if victim is None:
                return done
        while self._inflight:
            done.extend(self._collect_chain())
        if self._slots[victim] is not None:
            self._swap_out(victim)
        return done

    def _swap_layout(self, seg_len: int) -> list[tuple]:
        """The (shape, dtype) of each tensor a swap packs, in order: the
        cache segment's leaves over ``seg_len`` positions, the last token
        and, speculative, the history and its length."""
        st = self._state
        like = [((x.shape[0], 1, seg_len) + tuple(x.shape[3:]), x.dtype)
                for x in _cache_leaves(self._xfer).values()]
        like.append(((1,), st.last_tok.dtype))
        if self._spec:
            like += [((1, st.hist.shape[1]), st.hist.dtype), ((1,), st.hist_len.dtype)]
        return like

    def _swap_out(self, slot: int) -> None:
        """Park ``slot``'s request on the host (JAX ``:2219``): its cache
        segment over ``[0, seg_len)`` (``seg_len`` the bucket of its next
        write position; paged, its pages gathered into the transfer cache
        first, :func:`.slots.seed_cache_paged`), last token and
        (speculative) history packed into one buffer (:func:`.slots.pack`)
        and fetched in ONE counted sync (:meth:`_fetch`); the generator's
        state is host bytes already. The slot is then released as a
        completion's is (parked; paged, its pages returned; its prefix
        donor released — the swap-in splices from the parked copy, never
        from the donor) and the request requeued at its arrival position
        with a :class:`.slo.SwapRecord`."""
        act = self._slots[slot]
        req = act.request
        position = len(req.prompt) + len(act.tokens) - 1
        seg_len = bucket_len(position, self.window)
        st = self._state
        if self._paged:
            cache1 = seed_cache_paged(self._xfer, st.cache, act.pages, position)
            leaves = [x[:, :, :seg_len] for x in _cache_leaves(cache1).values()]
        else:
            leaves = [x[:, slot:slot + 1, :seg_len] for x in _cache_leaves(st.cache).values()]
        leaves.append(st.last_tok[slot:slot + 1])
        if self._spec:
            leaves += [st.hist[slot:slot + 1], st.hist_len[slot:slot + 1]]
        gen_state = st.generators[slot].get_state()
        packed = self._fetch(pack(leaves))  # the swap's one counted sync
        self.n_swaps_out += 1
        self._slots[slot] = None
        self._release(slot, act)
        self._swapped[req.request_id] = SwapRecord(
            active=act, packed=packed, generator_state=gen_state, position=position,
            seg_len=seg_len, preempt_t=time.perf_counter())
        self.scheduler.requeue(req)
        if self._flight is not None:
            self._flight.preempted(req.request_id, slot=slot, position=position,
                                   tokens=len(act.tokens))

    def _swap_in(self, slot: int, req: Request, rec: SwapRecord) -> list[Completion]:
        """Resume a preempted request in ``slot`` (JAX ``:2276``): the
        packed buffer goes up in one pinned, non-blocking copy
        (:func:`.slots.upload`; no fetch), its segment is seeded into the
        transfer cache at the parked position and copied into the slot —
        paged, into freshly allocated pages (:func:`.slots.write_slot_paged`
        rewrites them whole) — and the request's live budget, last token,
        generator state and history are restored verbatim: it resumes
        token-exact. If this raises, the request completes ``"error"`` with
        the tokens it earned before the swap, the pages go back and the
        slot parks, as for a raising prefill. Under tensor parallelism each
        rank unpacks its own heads and a failure is rank-local: the ranks
        agree on the outcome first (:meth:`_agree`), so every rank
        completes the request ``"error"`` when any rank's swap-in raised."""
        act, st, pages = rec.active, self._state, []
        ok = True
        try:
            parts = unpack(upload(rec.packed, torch.uint8, self.device),
                           self._swap_layout(rec.seg_len))
            names = list(_cache_leaves(self._xfer))
            seg = KVCache(index=self._xfer.index, quant=self._xfer.quant,
                          **dict(zip(names, parts)))
            cache1 = seed_cache(self._xfer, seg, rec.position)
            last_tok = parts[len(names)][0]
            if self._paged:
                pages = self._pool.alloc(
                    self._pool.pages_needed(len(req.prompt) + req.max_new_tokens))
                write_slot_paged(st, cache1, pages, slot, rec.position, last_tok,
                                 act.remaining + 1)
            else:
                copy_slot(st, cache1, slot)
                write_slot(st, slot, rec.position, last_tok, act.remaining + 1)
            st.generators[slot].set_state(rec.generator_state)
            if self._spec:
                st.hist[slot] = parts[-2][0]
                st.hist_len[slot] = parts[-1][0]
            if self._bank is not None:
                set_adapter(st, slot, int(req.adapter))
        except Exception:
            _log.warning("request %d: swap-in into slot %d raised; completed 'error'",
                         req.request_id, slot, exc_info=True)
            ok = False
        if self._tp is not None:
            ok = self._agree(ok)
        if not ok:
            self._park_failed(slot, pages)
            self.n_prefill_errors += 1
            if self._flight is not None:
                self._flight.fault("swap_in_error", rid=req.request_id, slot=slot)
            return [self._complete(act, "error")]
        act.pages = pages
        self.n_swaps_in += 1
        self._slots[slot] = act
        if self._flight is not None:
            self._flight.resumed(req.request_id, slot=slot,
                                 wait_s=time.perf_counter() - rec.preempt_t)
        return []

    def _agree(self, ok: bool) -> bool:
        """Tensor parallel: the MIN of a rank-local ``ok`` over the model
        group (one all_reduce of an int64 over the CPU decision group,
        counted in ``n_swap_agreements``), so a rank-local failure is every
        rank's."""
        flag = torch.tensor([int(ok)], dtype=torch.int64)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self._dgroup)
        self.n_swap_agreements += 1
        return bool(flag[0])

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
        loop goes through here and is counted (the JAX engine's
        ``_sentry_fetch``: with a sentry, declared to it first, so a sync
        anywhere else in a round is what its accounting flags)."""
        self.n_host_syncs += 1
        if self._sentry is not None:
            self._sentry.budgeted_fetch()
        return t.cpu()

    # ------------------------------------------------------------------
    # refill: whole prefill, splice, chunked prefill
    # ------------------------------------------------------------------

    def _prefix_key(self, prompt: list[int], aid: int) -> list[int]:
        """The prefix-index key of a tenant's prompt: every token shifted
        by ``(generation * n_adapters + aid) * vocab_size``, so each tenant
        incarnation owns a disjoint key range — the same match depth
        within a tenant, no match across tenants, and none for a tenant
        that recycled an evicted tenant's row (the old segments go
        unreachable and age out of the budget). Id 0 keys are the raw
        prompt (row 0's generation is always 0). Host arithmetic only."""
        if aid == 0:
            return prompt
        ns = self._bank.generation(aid) * self._bank.n_adapters + aid
        shift = ns * int(self.model.cfg.vocab_size)
        return [t + shift for t in prompt]

    def _lookup(self, key: list[int]):
        """``(hit, grow)`` for a prefix key: the prefix index's longest
        match ``(depth, segment)`` or None, and the key to insert the
        prompt's own segment under (not resident yet) or None."""
        if self.prefix is None:
            return None, None
        return (self.prefix.lookup(key, self._min_hit_depth),
                None if tuple(key) in self.prefix else key)

    def _ids(self, req: Request) -> int | None:
        """The ``adapter_ids`` of a refill's forwards: the request's id
        with a bank, None (the base model's forward) without."""
        return None if self._bank is None else int(req.adapter)

    @torch.no_grad()
    def _refill(self, slot: int, req: Request) -> list[Completion]:
        """Admit ``req`` into ``slot`` (:meth:`_admit`): a whole prefill or
        a splice, one host sync each for the first token, or the start of
        a chunked prefill (:meth:`_advance_one` runs its first chunk in
        this same step). A request that was cancelled or whose deadline
        passed while it queued, or whose tenant is no longer the one it was
        admitted under (evicted, or its row handed to another), is
        completed here (``"cancelled"``, ``"deadline"``,
        ``"adapter_evicted"``) with no device work; the slot stays free. A
        refill that raises is isolated to its request (:meth:`_admit` has
        cleaned up): it completes ``"error"``. A preempted request swaps
        back in (:meth:`_swap_in`), a decode-role engine splices the
        request's handoff (:meth:`_accept_refill`) and a prefill-role one
        emits one (:meth:`_refill_handoff`)."""
        rec = self._swapped.pop(req.request_id, None) if self._slo else None
        bounced = self._bounced(req, rec=rec)
        if bounced is not None:
            return [bounced]
        aid = int(req.adapter)
        if aid and not (self._bank.registry.is_live(aid)
                        and self._bank.generation(aid) == req.adapter_gen):
            self.adapter_rejected += 1
            if self._flight is not None:
                self._flight.fault("adapter_evicted", rid=req.request_id, adapter=aid)
            return [self._bounce(req, rec, "adapter_evicted")]
        if aid:
            self.adapter_requests += 1
        if rec is not None:
            return self._swap_in(slot, req, rec)
        if self._role == "decode":
            return self._accept_refill(slot, req)
        prompt = [int(t) for t in req.prompt]
        if self._role == "prefill":
            return self._refill_handoff(slot, req, prompt)
        try:
            admitted = self._admit(slot, req, prompt)
        except Exception:
            return [self._prefill_error(req, slot)]
        if admitted is None:
            return self._advance_one(self._pending[slot])
        _, first, pages, segment, kind, depth = admitted
        self.refills[kind] += 1
        self.prefix_hit_tokens += depth
        return self._activate(slot, req, first, pages, segment, depth)

    def _prefill_error(self, req: Request, slot: int) -> Completion:
        """A refill raised and was cleaned up: log the traceback (called in
        the ``except`` block), count it and complete the request
        ``"error"`` with no tokens."""
        _log.warning("request %d: refill into slot %d raised; completed 'error'",
                     req.request_id, slot, exc_info=True)
        self.n_prefill_errors += 1
        if self._flight is not None:
            self._flight.fault("prefill_error", rid=req.request_id, slot=slot)
        return self._complete_unstarted(req, "error")

    # -- disaggregation: the prefill role's emits, the decode role's accept

    def _refill_handoff(self, slot: int, req: Request, prompt: list[int]) -> list[Completion]:
        """Prefill-role refill (JAX ``_refill_handoff``): the prompt's whole
        prefill (:meth:`_handoff_prefill`), its splice from a prefix hit
        (:meth:`_handoff_splice`) or the start of its chunked prefill (the
        final chunk emits, :meth:`_advance_one`), ending in a
        :class:`.scheduler.Handoff` instead of slot surgery — no host sync.
        The outgoing segment doubles as the prompt's prefix segment, and a
        splice's donor unpins as soon as the splice is queued. A refill
        that raises completes ``"error"`` (no slot state was written)."""
        hit, grow = self._lookup(self._prefix_key(prompt, int(req.adapter)))
        depth = hit[0] if hit is not None else 0
        segment = None
        try:
            if self._chaos is not None:
                chaos_lib.maybe_fail_prefill(self._chaos, req.request_id)
            if self._chunk and len(prompt) - depth > self._chunk:
                self._pending[slot] = self._start_pending(slot, req, prompt, hit, grow)
                return self._advance_one(self._pending[slot])
            if hit is not None:
                segment = hit[1]
                self.prefix.acquire(segment)  # pin the donor FIRST
                seg, first, gen_state = self._handoff_splice(slot, req, prompt, depth,
                                                             segment)
                kind = "splice"
            else:
                seg, first, gen_state = self._handoff_prefill(slot, req, prompt)
                kind = "prefill"
        except Exception:
            if segment is not None:
                self.prefix.release(segment)
            return [self._prefill_error(req, slot)]
        if segment is not None:
            self.prefix.release(segment)
        self.refills[kind] += 1
        self.prefix_hit_tokens += depth
        if grow is not None:
            self.prefix.insert(grow, seg, tree_nbytes(seg))
        return self._emit_handoff(req, seg, first, gen_state, len(prompt))

    def _handoff_first(self, slot: int, req: Request, logits):
        """A prefill-role refill's first token (:meth:`_first_token`, on
        the device) and the slot generator's state after its draw (host
        bytes: no sync)."""
        first = self._first_token(slot, req, logits)
        return first, self._state.generators[slot].get_state()

    def _handoff_prefill(self, slot: int, req: Request, prompt: list[int]):
        """Prefill-role miss (JAX ``_handoff_prefill_fn``, ``:1270``): the
        monolithic whole prefill's forward over the bucket-padded prompt
        into the batch-1 transfer cache, then that cache cut to the bucket
        (:func:`.slots.extract_segment`). Returns ``(segment, first,
        generator_state)``. No host sync."""
        p_len = len(prompt)
        bucket = bucket_len(p_len, self.window)
        logits = self.model(self._tokens(prompt, bucket), self._xfer, prefill=True,
                            last_pos=p_len - 1, adapter_ids=self._ids(req))
        first, gen_state = self._handoff_first(slot, req, logits)
        return extract_segment(self._xfer, bucket), first, gen_state

    def _handoff_splice(self, slot: int, req: Request, prompt: list[int], depth: int,
                        segment: Segment):
        """Prefill-role prefix hit (JAX ``_handoff_splice_fn``, ``:1299``):
        the monolithic splice's side cache seeded from the donor at
        ``depth`` and its one suffix continuation, then the side cache cut
        to the prompt's bucket. Returns ``(segment, first,
        generator_state)``. No host sync."""
        suffix = prompt[depth:]
        tokens = self._tokens(suffix, bucket_len(len(suffix), self.window))
        cache1 = seed_cache(self._side, segment.handle, depth)
        logits = self.model(tokens, cache1, decode=True, last_pos=len(prompt) - 1 - depth,
                            adapter_ids=self._ids(req))
        first, gen_state = self._handoff_first(slot, req, logits)
        return extract_segment(cache1, bucket_len(len(prompt), self.window)), first, gen_state

    def _handoff_final(self, pend: _PendingPrefill):
        """Prefill-role final chunk (JAX ``_handoff_final_fn``, ``:1315``):
        the monolithic final chunk's continuation over the accumulated side
        cache, then that cache cut to the prompt's bucket. Returns
        ``(segment, first, generator_state)``. No host sync."""
        req, prompt = pend.request, pend.prompt
        rest = len(prompt) - pend.done
        tokens = self._tokens(prompt[pend.done:], bucket_len(rest, self.window))
        logits = self.model(tokens, pend.cache1, decode=True, last_pos=rest - 1,
                            adapter_ids=self._ids(req))
        first, gen_state = self._handoff_first(pend.slot, req, logits)
        return (extract_segment(pend.cache1, bucket_len(len(prompt), self.window)), first,
                gen_state)

    def _emit_handoff(self, req: Request, seg: KVCache, first, gen_state,
                      p_len: int) -> list[Completion]:
        """Park a finished prefill for :meth:`take_handoff` and complete
        the request ``"handoff"`` (no tokens here). Host bookkeeping only."""
        self._handoffs[req.request_id] = Handoff(
            segment=seg, first=first, generator_state=gen_state, p_len=p_len,
            bucket=seg.k.shape[2], aid=int(req.adapter), submitted_s=req.submitted_s)
        self.n_handoffs_out += 1
        if self._flight is not None:
            self._flight.record("handoff_emit", rid=req.request_id, p_len=p_len)
        return [self._complete_unstarted(req, "handoff")]

    def _accept_refill(self, slot: int, req: Request) -> list[Completion]:
        """Decode-role refill (JAX ``_accept_fn`` ``:1350`` and
        ``_accept_paged_fn`` ``:1390``): rebuild the monolithic
        post-prefill slot from the request's handoff — the segment seeded
        into the batch-1 transfer cache at the prompt's length
        (:func:`.slots.seed_cache`: the bucket's K/V, zeros past it), copied
        into the slot (:func:`.slots.copy_slot` + :func:`.slots.write_slot`)
        or, paged, into fresh pages (:func:`.slots.write_slot_paged`) —
        bitwise, since nothing is recomputed; the slot generator takes the
        handoff's state. Then the handoff's one host sync: the fetch of the
        first token. A refill that raises is isolated as a prefill's is."""
        h = self._handoff_in.pop(req.request_id)
        st, pages = self._state, []
        try:
            if self._chaos is not None:
                chaos_lib.maybe_fail_prefill(self._chaos, req.request_id)
            if self._bank is not None:
                set_adapter(st, slot, h.aid)
            cache1 = seed_cache(self._xfer, h.segment, h.p_len)
            if self._paged:
                pages = self._pool.alloc(self._pool.pages_needed(h.p_len + req.max_new_tokens))
                write_slot_paged(st, cache1, pages, slot, h.p_len, h.first[0],
                                 req.max_new_tokens)
            else:
                copy_slot(st, cache1, slot)
                write_slot(st, slot, h.p_len, h.first[0], req.max_new_tokens)
            st.generators[slot].set_state(h.generator_state)
            self.n_handoffs_in += 1
            first = int(self._fetch(h.first)[0])
        except Exception:
            self._park_failed(slot, pages)
            return [self._prefill_error(req, slot)]
        return self._activate(slot, req, first, pages, kind="handoff")

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
        prefix length. With a bank, the slot's adapter id is set first and
        the prompt is looked up under its tenant's key. The chaos prefill
        failure fires after the lookup, before any allocation or device
        work of every kind."""
        if self._bank is not None:
            set_adapter(self._state, slot, int(req.adapter))
        hit, grow = self._lookup(self._prefix_key(prompt, int(req.adapter)))
        if self._chaos is not None:
            chaos_lib.maybe_fail_prefill(self._chaos, req.request_id)
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
                       grow: list[int] | None, first=None):
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
        back to the pool. With ``grow`` (a prefix key) the prompt's segment
        is inserted into the prefix index under it. Returns ``(logits,
        first, pages)``, ``pages`` None unpaged. No host sync."""
        p_len = len(prompt)
        bucket = bucket_len(p_len, self.window)
        tokens = self._tokens(prompt, bucket)
        st = self._state
        ids = self._ids(req)
        if not self._paged:
            logits = self.model(tokens, st.cache, prefill=True, last_pos=p_len - 1,
                                rows=slot, adapter_ids=ids)
            if first is None:
                first = self._first_token(slot, req, logits)
            write_slot(st, slot, p_len, first[0], req.max_new_tokens)
            if grow is not None:
                seg = extract_segment(st.cache, bucket, row=slot)
                self.prefix.insert(grow, seg, tree_nbytes(seg))
            return logits, first, None
        pages = self._pool.alloc(self._pool.pages_needed(p_len + req.max_new_tokens))
        try:
            logits = self.model(tokens, self._prefill_cache, prefill=True,
                                last_pos=p_len - 1, adapter_ids=ids)
            if first is None:
                first = self._first_token(slot, req, logits)
            write_slot_paged(st, self._prefill_cache, pages, slot, p_len,
                             first[0], req.max_new_tokens)
        except Exception:
            self._pool.release_all(pages)
            raise
        if grow is not None:
            self._insert_paged_segment(grow, pages, p_len)
        return logits, first, pages

    def _splice(self, slot: int, req: Request, prompt: list[int], depth: int,
                segment: Segment, grow: list[int] | None, first=None):
        """Prefix-hit refill (the JAX engine's ``_splice_fn`` and
        ``_finish_prefill``): reuse ``segment``'s K/V on ``[0, depth)`` and
        run ONE suffix continuation — decode over the bucket-padded suffix
        from position ``depth`` — sampling the first token at the last
        real suffix token (``last_pos = p_len - 1 - depth``).

        Unpaged: the batch-1 side cache is seeded from the segment
        (:func:`.slots.seed_cache`), continued, then copied whole into the
        slot (:func:`.slots.copy_slot`); the other slots' rows and
        positions do not move. With ``grow`` (a prefix key) the full
        prompt's segment is cut from the side cache and inserted under it.

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
        ids = self._ids(req)
        if not self._paged:
            cache1 = seed_cache(self._side, segment.handle, depth)
            logits = self.model(tokens, cache1, decode=True, last_pos=last, adapter_ids=ids)
            if first is None:
                first = self._first_token(slot, req, logits)
            copy_slot(st, cache1, slot)
            write_slot(st, slot, p_len, first[0], req.max_new_tokens)
            if grow is not None:
                seg = extract_segment(cache1, bucket_len(p_len, self.window))
                self.prefix.insert(grow, seg, tree_nbytes(seg))
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
                if self._flight is not None:
                    self._flight.record("page_cow", rid=req.request_id, slot=slot,
                                        src=int(segment.handle[shared]), dst=pages[shared],
                                        depth=depth)
            row = pages + [cache.n_pages] * (cache.table.shape[1] - n_alloc)
            table = upload([row], torch.int32, self.device)
            view = PagedKVCache(
                k=cache.k, v=cache.v, table=table,
                index=torch.full((1,), depth, dtype=torch.int64, device=self.device),
                k_scale=cache.k_scale, v_scale=cache.v_scale, quant=cache.quant,
            )
            logits = self._dec_model(tokens, view, decode=True, last_pos=last,
                                     adapter_ids=ids)
            if first is None:
                first = self._first_token(slot, req, logits)
            cache.table[slot] = table[0]
            write_slot(st, slot, p_len, first[0], req.max_new_tokens)
        except Exception:
            pool.release_all(pages)
            raise
        if grow is not None:
            self._insert_paged_segment(grow, pages, p_len)
        return logits, first, pages

    def _start_pending(self, slot: int, req: Request, prompt: list[int], hit,
                       grow: list[int] | None) -> _PendingPrefill:
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
        admits the request — on a prefill-role engine emits its handoff
        (:meth:`_handoff_final`, no sync). A request cancelled or past its deadline is
        completed first, with no tokens, and its prefill abandoned. If the
        device work raises, the pending prefill is abandoned, the slot
        parked and the request completed ``"error"``."""
        bounced = self._bounced(pend.request, pend.slot)
        if bounced is not None:
            self._abandon_pending(pend)
            return [bounced]
        try:
            if len(pend.prompt) - pend.done > self._chunk:
                self._mid_chunk(pend)
                self.n_chunks += 1
                if self._flight is not None:
                    self._flight.prefill_chunk(pend.request.request_id, pend.slot,
                                               done=pend.done, total=len(pend.prompt))
                return []
            if self._role == "prefill":
                seg, first, gen_state = self._handoff_final(pend)
            else:
                _, first, pages = self._final_chunk(pend)
            self.n_chunks += 1
            if self._role != "prefill":
                first = int(self._fetch(first)[0])
        except Exception:
            self._abandon_pending(pend)
            self._park_failed(pend.slot, [])
            return [self._prefill_error(pend.request, pend.slot)]
        kind = "chunked_splice" if pend.segment is not None else "chunked"
        self.refills[kind] += 1
        self.prefix_hit_tokens += pend.depth
        segment = pend.segment
        pend.pages, pend.segment = [], None  # ownership moves to the slot
        del self._pending[pend.slot]
        if self._role == "prefill":
            # the segment leaves in the handoff: the donor unpins now, and
            # the outgoing segment is the prompt's prefix segment
            if segment is not None:
                self.prefix.release(segment)
            if pend.grow is not None:
                self.prefix.insert(pend.grow, seg, tree_nbytes(seg))
            return self._emit_handoff(pend.request, seg, first, gen_state, len(pend.prompt))
        return self._activate(pend.slot, pend.request, first, pages, segment, pend.depth)

    def _mid_chunk(self, pend: _PendingPrefill) -> None:
        """The next ``prefill_chunk`` prompt tokens into the side cache:
        the suffix continuation over one chunk, its logits unused."""
        toks = pend.prompt[pend.done:pend.done + self._chunk]
        self.model(self._tokens(toks, self._chunk), pend.cache1, decode=True, last_pos=0,
                   adapter_ids=self._ids(pend.request))
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
        logits = self.model(tokens, pend.cache1, decode=True, last_pos=rest - 1,
                            adapter_ids=self._ids(req))
        if first is None:
            first = self._first_token(slot, req, logits)
        st = self._state
        if self._paged:
            write_slot_paged(st, pend.cache1, pend.pages, slot, p_len, first[0],
                             req.max_new_tokens)
            if pend.grow is not None:
                self._insert_paged_segment(pend.grow, pend.pages, p_len)
            return logits, first, pend.pages
        copy_slot(st, pend.cache1, slot)
        write_slot(st, slot, p_len, first[0], req.max_new_tokens)
        if pend.grow is not None:
            seg = extract_segment(pend.cache1, bucket_len(p_len, self.window))
            self.prefix.insert(pend.grow, seg, tree_nbytes(seg))
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

    def _insert_paged_segment(self, key: list[int], pages: list[int],
                              p_len: int) -> None:
        """Insert-on-prefill, paged: the segment is the tuple of page ids
        covering the prompt's ``p_len`` positions, each given one more
        reference first (no device copy), inserted under the prefix
        ``key``; a refused insert (already resident, or the budget full of
        pinned segments) returns them. Priced as pages x ``page_bytes``."""
        seg_ids = tuple(pages[: self._pool.pages_needed(p_len)])
        for pid in seg_ids:
            self._pool.retain(pid)
        if not self.prefix.insert(key, seg_ids, len(seg_ids) * self._page_bytes):
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
    def teacher_forced_logits(self, prompt, tokens, rows: int = 1,
                              adapter: int = 0) -> torch.Tensor:
        """The serving path's logits on GIVEN tokens, to hold one read path
        against another: ``prompt`` is admitted into slot 0 as a request's
        would be, through :meth:`_admit` (spliced on a prefix hit, chunked
        when its uncached length exceeds ``prefill_chunk`` — every chunk at
        once — else prefilled whole; paged, with its pages) — then
        ``tokens[:-1]`` are fed to the decode model in place of sampled
        ones, ``rows`` a forward (1: one decode step at a time; k+1: the
        shape of a speculative verify forward whose drafts are all
        accepted). Row ``i`` of the (len(tokens), vocab) float32 result is
        the logits that chose ``tokens[i]``. ``adapter``: the tenant whose
        factors the forwards apply (a registered id). Needs an idle engine;
        the slot, the donor segment and the pages are released afterwards.
        The request counters do not move; the prefix index sees the
        prompt's lookup (and insert) as a request's."""
        if not self.idle:
            raise RuntimeError("teacher_forced_logits needs an idle engine")
        if not tokens:
            raise ValueError("tokens must not be empty")
        if rows < 1:
            raise ValueError("rows must be >= 1")
        prompt = [int(t) for t in prompt]
        req = Request(prompt=prompt, max_new_tokens=len(tokens), adapter=int(adapter))
        if adapter and self._bank is None:
            raise ValueError("teacher_forced_logits: adapter given, but the engine has no bank")
        if self._bank is not None:
            self._bank.check_id(req.adapter)
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
                out.append(self._dec_model(x, self._state.cache, decode=True,
                                           adapter_ids=self._state.adapter_ids)[0])
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

    def _poison(self, logits: torch.Tensor, t: int) -> torch.Tensor:
        """The chaos NaN at chain step ``t``: the global decode step
        ``n_chains * tokens_per_launch + t`` (chain iterations, speculative
        or not) is a host number, so the injector decides on the host and
        fills the victim row only at its step — no upload."""
        if self._chaos is None or not self._chaos.poisons_logits:
            return logits
        c = self._chaos
        return chaos_lib.poison_logits(logits, self.n_chains * self.tokens_per_launch + t,
                                       c.nan_logit_slot, c.nan_logit_step)

    @torch.no_grad()
    def _chain(self) -> torch.Tensor:
        """``tokens_per_launch`` decode steps over every slot; returns the
        (n_slots, tokens_per_launch) token block, still on the device.
        Inactive slots re-emit their last token and keep stepping (their
        cache writes past the window, or through a parked slot's sentinel
        table, drop). With ``guard_nonfinite`` the block is (2, n_slots,
        tokens_per_launch): plane 0 the tokens, plane 1 each slot's flag
        that its float logits row was finite at that step. No host
        sync."""
        st = self._state
        out = torch.empty(
            ((2,) if self._guard else ()) + (self.n_slots, self.tokens_per_launch),
            dtype=torch.int64, device=self.device,
        )
        toks = out[0] if self._guard else out
        tok, remaining = st.last_tok, st.remaining
        for t in range(self.tokens_per_launch):
            active = remaining > 0
            logits = self._dec_model(tok[:, None], st.cache, decode=True,
                                     adapter_ids=st.adapter_ids)
            row = self._poison(logits[:, -1].float(), t)
            nxt = sample_logits_per_slot(
                row, st.generators, self._temperature, self._top_k, self._top_p,
            )
            tok = torch.where(active, nxt, tok)
            remaining = remaining - active.to(remaining.dtype)
            toks[:, t] = tok
            if self._guard:
                out[1, :, t] = torch.isfinite(row).all(-1)
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
        many of them are real; with ``guard_nonfinite`` one more column,
        ``[..., k+2]``, the flag that the step's (k+1, vocab) float verify
        logits were all finite. No host sync."""
        st = self._state
        k, win, dev = self._spec_k, self.window, self.device
        out = torch.empty((self.n_slots, self.tokens_per_launch, k + 2 + self._guard),
                          dtype=torch.int64, device=dev)
        rows = torch.arange(self.n_slots, device=dev)
        offs = torch.arange(k + 1, device=dev)
        tok, remaining, hist_len = st.last_tok, st.remaining, st.hist_len
        for t in range(self.tokens_per_launch):
            active = remaining > 0
            draft = ngram_draft(st.hist[:, :win], hist_len, k, self._spec_ngram)
            logits = self._dec_model(torch.cat([tok[:, None], draft], dim=1), st.cache,
                                     decode=True, adapter_ids=st.adapter_ids)
            lg = self._poison(logits.float(), t)
            emitted, n_acc = speculative_accept(
                lg, draft, st.generators, self._temperature, self._top_k, self._top_p,
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
            if self._guard:
                out[:, t, k + 2] = torch.isfinite(lg).flatten(1).all(-1)
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
                  segment: Segment | None = None, cached_len: int = 0,
                  kind: str | None = None) -> list[Completion]:
        """Admit a just-prefilled request into the decode phase; an EOS or
        ``max_new_tokens == 1`` first token completes it at once. Every
        refill kind (whole prefill, splice, chunked, chunked with a splice;
        paged or not) passes here, so this is where a speculative engine
        seeds the slot's draft history (:func:`.slots.seed_history`: the
        prompt, uploaded non-blocking, and the first token) and the
        recorder stamps the request's first token (``cached_len``: the
        reused prefix length; ``kind`` names an accepted handoff's)."""
        self.generated_tokens += 1
        act = _Active(req, first, pages, segment)
        act.ttft_s = time.perf_counter() - req.submitted_s
        if self._flight is not None:
            self._flight.request_prefilled(
                req.request_id, slot,
                kind=kind or ("splice" if segment is not None else "prefill"),
                cached_len=cached_len)
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

    def _quarantine(self, act: _Active, s: int, t: int) -> str:
        """Slot ``s``'s logits went non-finite at chain step ``t``: count it
        and stamp the fault (the recorder's dump names the slot)."""
        self.nonfinite_quarantined += 1
        if self._flight is not None:
            self._flight.fault("nonfinite", rid=act.request.request_id, slot=s, chain_step=t)
        return "nonfinite"

    def _distribute(self, block: torch.Tensor, view: list) -> list[Completion]:
        """Hand one fetched chain block out to the slots of ``view`` (the
        slot views at the chain's dispatch; a slot whose ``_Active`` is no
        longer the live one — finished or refilled since — ignores the
        chain's rows); free every slot that finished (budget spent, EOS
        mid-chain, or with the guard a false finite flag: the tokens from
        that step on are dropped and the request completes
        ``"nonfinite"``) and park early-finished slots whose device counter
        still shows budget."""
        done: list[Completion] = []
        if self._guard:
            rows, oks = block[0].tolist(), block[1].tolist()
        else:
            rows, oks = block.tolist(), None
        for s, act in enumerate(view):
            if act is None or act is not self._slots[s]:
                continue
            reason = None
            for t, tok in enumerate(rows[s][: act.remaining]):
                if oks is not None and not oks[s][t]:
                    reason = self._quarantine(act, s, t)
                    break
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
        the slot). ``view`` and the guard's quarantine as in
        :meth:`_distribute`, a verify step at a time (the flag is the
        block's last column)."""
        done: list[Completion] = []
        k1 = self._spec_k + 1
        rows = block.tolist()
        for s, act in enumerate(view):
            if act is None or act is not self._slots[s]:
                continue
            reason = None
            for t, step in enumerate(rows[s]):
                if self._guard and not step[k1 + 1]:
                    # a poisoned verify step drops all of its emissions
                    reason = self._quarantine(act, s, t)
                    break
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
        comp = Completion(
            request_id=act.request.request_id,
            prompt=[int(t) for t in act.request.prompt],
            tokens=act.tokens,
            finish_reason=reason,
            latency_s=time.perf_counter() - act.request.submitted_s,
            ttft_s=act.ttft_s,
        )
        if self._flight is not None:
            # the span records the Completion's own numbers
            self._flight.request_completed(comp.request_id, reason, tokens=len(comp.tokens),
                                           latency_s=comp.latency_s, ttft_s=comp.ttft_s)
        return comp

    def _complete_unstarted(self, req: Request, reason: str) -> Completion:
        """A completion with no tokens for a request stopped before its
        first token (cancelled, deadline, adapter evicted, prefill error,
        or a prefill-role engine's handoff). An accepted handoff the
        request still holds is dropped."""
        self._handoff_in.pop(req.request_id, None)
        comp = Completion(
            request_id=req.request_id, prompt=[int(t) for t in req.prompt], tokens=[],
            finish_reason=reason, latency_s=time.perf_counter() - req.submitted_s,
        )
        if self._flight is not None:
            self._flight.request_completed(req.request_id, reason, tokens=0,
                                           latency_s=comp.latency_s)
        return comp
