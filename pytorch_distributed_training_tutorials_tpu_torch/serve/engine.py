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
"""

from __future__ import annotations

import time

import torch

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
from pytorch_distributed_training_tutorials_tpu_torch.models.sampling import (
    sample_logits,
    sample_logits_per_slot,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    TransformerLM,
    bind_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.scheduler import (
    Completion,
    FifoScheduler,
    Request,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.slots import (
    bucket_len,
    init_slot_state,
    write_slot,
)


class _Active:
    """Host-side view of one occupied slot; ``ttft_s`` is
    submit-to-first-token wall time."""

    __slots__ = ("request", "tokens", "remaining", "ttft_s")

    def __init__(self, request: Request, first_token: int):
        self.request = request
        self.tokens = [first_token]
        self.remaining = request.max_new_tokens - 1
        self.ttft_s = 0.0


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
    decode chain over all slots with ONE host sync."""

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
    ):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if tokens_per_launch < 1:
            raise ValueError("tokens_per_launch must be >= 1")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.device = resolve_device(device)
        if params is not None:
            bind_params(
                model, {k: v.to(self.device) for k, v in params.items()}
            )
        self.model = model
        self.n_slots = n_slots
        self.tokens_per_launch = tokens_per_launch
        self.window = int(model.cfg.max_seq_len)
        self.scheduler = FifoScheduler(self.window, max_queue=max_queue)
        self._slots: list[_Active | None] = [None] * n_slots
        self._state = init_slot_state(model.cfg, n_slots, self.device)
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
        :class:`..serve.scheduler.QueueClosed` after :meth:`close`, or
        ``ValueError`` when the request can never fit the window."""
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
            req = self.scheduler.pop()
            if req is None:
                break
            done.extend(self._refill(s, req))
        if self.active_slots:
            toks = self._fetch(self._chain())
            self.n_chains += 1
            done.extend(self._distribute(toks))
        return done

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
    def _refill(self, slot: int, req: Request) -> list[Completion]:
        """Prefill ``req`` into ``slot``: one forward over the bucket-padded
        prompt writes the slot's K/V in place, the first token is sampled
        from the logits at the last REAL prompt position with the slot's
        generator reseeded from ``req.seed``, and the slot's counters reset
        (:func:`.slots.write_slot`). One host sync, for the first token."""
        prompt = [int(t) for t in req.prompt]
        p_len = len(prompt)
        bucket = bucket_len(p_len, self.window)
        tokens = torch.tensor(
            [prompt + [0] * (bucket - p_len)], dtype=torch.int64,
            device=self.device,
        )
        st = self._state
        logits = self.model(
            tokens, st.cache, prefill=True, last_pos=p_len - 1, rows=slot
        )
        gen = st.generators[slot]
        gen.manual_seed(req.seed)
        first = sample_logits(
            logits[:, -1].float(), gen, self._temperature, self._top_k,
            self._top_p,
        )
        write_slot(st, slot, p_len, first[0], req.max_new_tokens)
        self.n_prefills += 1
        return self._activate(slot, req, int(self._fetch(first)[0]))

    @torch.no_grad()
    def _chain(self) -> torch.Tensor:
        """``tokens_per_launch`` decode steps over every slot; returns the
        (n_slots, tokens_per_launch) token block, still on the device.
        Inactive slots re-emit their last token and keep stepping (their
        cache writes past the window drop)."""
        st = self._state
        out = torch.empty(
            (self.n_slots, self.tokens_per_launch), dtype=torch.int64,
            device=self.device,
        )
        tok, remaining = st.last_tok, st.remaining
        for t in range(self.tokens_per_launch):
            active = remaining > 0
            logits = self.model(tok[:, None], st.cache, decode=True)
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

    def _activate(self, slot: int, req: Request, first: int) -> list[Completion]:
        """Admit a just-prefilled request into the decode phase; an EOS or
        ``max_new_tokens == 1`` first token completes it at once."""
        self.generated_tokens += 1
        act = _Active(req, first)
        act.ttft_s = time.perf_counter() - req.submitted_s
        if req.max_new_tokens == 1 or first == req.eos_token:
            reason = "eos" if first == req.eos_token else "length"
            if act.remaining > 0:
                self._park(slot)
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
                if act.remaining > 0:
                    self._park(s)
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
