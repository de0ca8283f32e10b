"""Continuous-batching serving engine: ``n_slots`` concurrent requests over
one slot-indexed KV cache, decoded in chains of ``tokens_per_launch``
steps.

Port of the core of the JAX package's ``serve/engine.py`` (Orca, OSDI
'22): requests at different depths decode together, each slot with its
own position and active mask (``remaining > 0``); a finished slot is
refilled in place by a bucketed prefill into that slot. Host syncs are
ONE per chain — a single ``.cpu()`` of the (n_slots, tokens_per_launch)
token block — plus one per prefill for the first sampled token;
``n_host_syncs`` counts them. Chains run eagerly (the JAX package compiles
each chain into one program; capturing it as a CUDA graph is later work).

Greedy tokens equal :func:`..models.generate.generate`'s for the same
request, whatever else shares the batch (``models/transformer.py`` says
why the forward is batch- and window-invariant).

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
not. Host syncs stay one per chain plus one per prefill.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
from pytorch_distributed_training_tutorials_tpu_torch.models.sampling import (
    sample_logits,
    sample_logits_per_slot,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    KVCache,
    TransformerLM,
    _kv_quant_mode,
    bind_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.pages import (
    PagePool,
    PoolExhausted,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.scheduler import (
    Completion,
    FifoScheduler,
    Request,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.slots import (
    bucket_len,
    init_slot_state,
    park_slot_paged,
    write_slot,
    write_slot_paged,
)


class _Active:
    """Host-side view of one occupied slot; ``ttft_s`` is
    submit-to-first-token wall time; ``pages`` (paged engines) the pool
    pages the slot holds, released when it parks."""

    __slots__ = ("request", "tokens", "remaining", "ttft_s", "pages")

    def __init__(self, request: Request, first_token: int, pages=None):
        self.request = request
        self.tokens = [first_token]
        self.remaining = request.max_new_tokens - 1
        self.ttft_s = 0.0
        self.pages: list[int] = list(pages or [])


def _variant(model: TransformerLM, **changes) -> TransformerLM:
    """``model`` under a config with ``changes``, holding the same weight
    tensors (no copy)."""
    out = TransformerLM(dataclasses.replace(model.cfg, **changes))
    bind_params(out, model.state_dict())
    return out


class ServeEngine:
    """Request-level LM serving over a slot-indexed KV cache.

    ``model`` is a :class:`..models.transformer.TransformerLM`; its
    ``cfg.max_seq_len`` is the window every slot gets. ``params`` (a state
    dict from the weight bridge, or None when ``model`` already holds its
    weights) is bound into ``model`` on ``device`` (``cuda`` unless the
    caller passes another); the engine only reads it.

    Drive it with :meth:`submit` + :meth:`step`, or :meth:`run_until_idle`.
    ``step()`` does at most one prefill per free slot (each with one host
    sync for the first sampled token), then ONE ``tokens_per_launch``-step
    decode chain over all slots with ONE host sync.

    ``kv_bits`` (None: the model's ``kv_cache_dtype``; 8: int8 codes + f32
    scales; 4: packed int4 + bf16 scales) sets the KV storage. ``paged``
    with ``page_size`` and ``pool_pages`` serves decode from a shared page
    pool (module docstring); ``paged_kernel`` reads it through the
    paged-attention kernel."""

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
        device=None,
        kv_bits: int | None = None,
        paged: bool = False,
        page_size: int = 0,
        pool_pages: int = 0,
        paged_kernel: bool = False,
    ):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if tokens_per_launch < 1:
            raise ValueError("tokens_per_launch must be >= 1")
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
        self._state = init_slot_state(self._dec_model.cfg, n_slots, self.device)
        self._page_bytes = self._state.cache.page_bytes() if self._paged else 0
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._top_p = float(top_p)
        # counters for receipts and the sync-budget checks
        self.n_prefills = 0
        self.n_chains = 0
        self.n_host_syncs = 0
        self.generated_tokens = 0

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
        return self.active_slots == 0 and len(self.scheduler) == 0

    def step(self) -> list[Completion]:
        """One scheduling round: refill free slots from the queue (one
        prefill each), run one decode chain over all slots, hand out its
        tokens. Returns the requests that finished this round (possibly
        mid-chain — surplus chain tokens of a finished slot are
        discarded)."""
        done: list[Completion] = []
        for s in range(self.n_slots):
            if self._slots[s] is not None:
                continue
            req = self._pop_request()
            if req is None:
                break
            done.extend(self._refill(s, req))
        if self.active_slots:
            toks = self._fetch(self._chain())
            self.n_chains += 1
            done.extend(self._distribute(toks))
        return done

    def _pop_request(self) -> Request | None:
        """Queue pop; a paged engine pops the first request whose whole
        prompt + budget fits the free pages (the rest stay queued)."""
        if not self._paged:
            return self.scheduler.pop()
        pool = self._pool
        return self.scheduler.pop(fits=lambda r: pool.available >= pool.pages_needed(
            len(r.prompt) + r.max_new_tokens))

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
    # device work
    # ------------------------------------------------------------------

    @torch.no_grad()
    def teacher_forced_logits(self, prompt, tokens) -> torch.Tensor:
        """The serving path's logits on GIVEN tokens, to hold one read path
        against another: ``prompt`` is refilled into slot 0 as a request's
        would be (:meth:`_prefill`: bucket padding, the prefill and, paged,
        its pages allocated and copied in), then ``tokens[:-1]`` are fed to
        the decode model one step at a time in place of sampled ones. Row
        ``i`` of the (len(tokens), vocab) float32 result is the logits that
        chose ``tokens[i]``. Needs an idle engine; the slot is released
        afterwards and the request counters do not move."""
        if not self.idle:
            raise RuntimeError("teacher_forced_logits needs an idle engine")
        if not tokens:
            raise ValueError("tokens must not be empty")
        req = Request(prompt=list(prompt), max_new_tokens=len(tokens))
        first = torch.tensor([int(tokens[0])], dtype=torch.int64, device=self.device)
        logits, _, pages = self._prefill(0, req, first)
        rows = [logits[:1, -1]]
        tok = self._state.last_tok.clone()
        try:
            for t in tokens[:-1]:
                tok[0] = int(t)
                rows.append(
                    self._dec_model(tok[:, None], self._state.cache, decode=True)[:1, -1])
        finally:
            self._release(0, _Active(req, int(tokens[0]), pages))
        return torch.cat(rows).float()

    @torch.no_grad()
    def _refill(self, slot: int, req: Request) -> list[Completion]:
        """Prefill ``req`` into ``slot`` (:meth:`_prefill`) and admit it.
        One host sync, for the first token."""
        _, first, pages = self._prefill(slot, req)
        self.n_prefills += 1
        return self._activate(slot, req, int(self._fetch(first)[0]), pages)

    def _prefill(self, slot: int, req: Request, first=None):
        """One forward over the bucket-padded prompt; the first token is
        sampled from the logits at the last REAL prompt position with the
        slot's generator reseeded from ``req.seed`` (unless ``first``, a (1,)
        device tensor, is given) and the slot's counters reset. Unpaged, the
        forward writes the slot's K/V in place (:func:`.slots.write_slot`).
        Paged, it allocates the request's pages (``_pop_request`` checked
        that they are free), prefills the unpaged batch-1 flat cache, copies
        the allocated pages whole into the pool and installs the slot's
        table (:func:`.slots.write_slot_paged`); if that raises, the pages
        go back to the pool and the slot stays parked. Returns ``(logits,
        first, pages)``, ``pages`` None unpaged. No host sync."""
        prompt = [int(t) for t in req.prompt]
        p_len = len(prompt)
        bucket = bucket_len(p_len, self.window)
        tokens = torch.tensor(
            [prompt + [0] * (bucket - p_len)], dtype=torch.int64,
            device=self.device,
        )
        st = self._state
        if not self._paged:
            logits = self.model(
                tokens, st.cache, prefill=True, last_pos=p_len - 1, rows=slot
            )
            if first is None:
                first = self._first_token(slot, req, logits)
            write_slot(st, slot, p_len, first[0], req.max_new_tokens)
            return logits, first, None
        pages = self._pool.alloc(self._pool.pages_needed(p_len + req.max_new_tokens))
        try:
            logits = self.model(
                tokens, self._prefill_cache, prefill=True, last_pos=p_len - 1
            )
            if first is None:
                first = self._first_token(slot, req, logits)
            write_slot_paged(st, self._prefill_cache, pages, slot, p_len,
                             first[0], req.max_new_tokens)
        except Exception:
            park_slot_paged(st, slot)
            self._pool.release_all(pages)
            raise
        return logits, first, pages

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
        table, drop)."""
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

    def _park(self, slot: int) -> None:
        """Zero a slot's device-side budget (EOS before it ran out): later
        chains treat it as inactive. A device write, no sync."""
        self._state.remaining[slot] = 0

    def _release(self, slot: int, act: _Active) -> None:
        """A request left ``slot``. Paged engines park on EVERY completion
        — the slot keeps writing K/V each chain step, and through its live
        table those writes would land in pages handed back to the pool —
        and return its pages; others park only when budget remains."""
        if self._paged:
            park_slot_paged(self._state, slot)
            self._pool.release_all(act.pages)
            act.pages = []
        elif act.remaining > 0:
            self._park(slot)

    def _activate(self, slot: int, req: Request, first: int,
                  pages=None) -> list[Completion]:
        """Admit a just-prefilled request into the decode phase; an EOS or
        ``max_new_tokens == 1`` first token completes it at once."""
        self.generated_tokens += 1
        act = _Active(req, first, pages)
        act.ttft_s = time.perf_counter() - req.submitted_s
        if req.max_new_tokens == 1 or first == req.eos_token:
            reason = "eos" if first == req.eos_token else "length"
            self._release(slot, act)
            return [self._complete(act, reason)]
        self._slots[slot] = act
        return []

    def _distribute(self, toks: torch.Tensor) -> list[Completion]:
        """Hand one fetched (S, T) chain block out to the slots; free every
        slot that finished (budget spent or EOS mid-chain) and park
        early-EOS slots whose device counter still shows budget."""
        done: list[Completion] = []
        rows = toks.tolist()
        for s, act in enumerate(self._slots):
            if act is None:
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

    def _complete(self, act: _Active, reason: str) -> Completion:
        return Completion(
            request_id=act.request.request_id,
            prompt=[int(t) for t in act.request.prompt],
            tokens=act.tokens,
            finish_reason=reason,
            latency_s=time.perf_counter() - act.request.submitted_s,
            ttft_s=act.ttft_s,
        )
