"""Host-side request scheduling for the continuous-batching engine.

The port's own copy of the JAX package's ``serve/scheduler.py`` core
(pure Python there too): the FIFO discipline of Orca (OSDI '22) — requests
join in arrival order, the engine drains the queue into cache slots as
they free up, and a bounded queue gives callers backpressure instead of
unbounded memory growth. Admission is the one place length invariants are
checked, so the decode loop never sees a request that could write outside
its slot's window.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any


class QueueFull(Exception):
    """Raised by :meth:`FifoScheduler.submit` when the bounded queue is at
    capacity — the backpressure signal. Callers retry after draining
    (``ServeEngine.step``) or shed load; the engine never drops a request
    it has accepted."""


class QueueClosed(Exception):
    """Raised by :meth:`FifoScheduler.submit` after
    :meth:`~FifoScheduler.close`: admission stops; requests already queued
    or decoding run to completion (``ServeEngine.drain``)."""


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a 1-D sequence of int token ids; ``max_new_tokens``
    counts generated tokens including the one sampled from the prefill
    logits. ``seed`` founds the request's private generator — sampled draws
    depend only on (seed, draw index), never on which other requests share
    the decode batch. ``eos_token`` stops the request early when sampled
    (the stop token is included in the output); ``None`` always runs to
    ``max_new_tokens``."""

    prompt: Any
    max_new_tokens: int
    seed: int = 0
    eos_token: int | None = None
    # engine-assigned bookkeeping (not caller inputs)
    request_id: int = -1
    submitted_s: float = 0.0


@dataclasses.dataclass
class Completion:
    """A finished request: ``tokens`` are the generated ids (prompt
    excluded, stop token included when ``finish_reason == "eos"``);
    ``finish_reason`` is ``"length"`` or ``"eos"``; ``latency_s`` is
    submit-to-completion wall time and ``ttft_s`` submit-to-first-token."""

    request_id: int
    prompt: list[int]
    tokens: list[int]
    finish_reason: str
    latency_s: float
    ttft_s: float = 0.0


class FifoScheduler:
    """Bounded FIFO request queue with admission control.

    ``window`` is the engine's cache window (``cfg.max_seq_len``): a
    request whose prompt + budget cannot fit is rejected at submit time
    with ``ValueError``."""

    def __init__(self, window: int, max_queue: int = 64):
        if window < 1 or max_queue < 1:
            raise ValueError(
                f"window/max_queue must be >= 1, got {window}/{max_queue}"
            )
        self.window = window
        self.max_queue = max_queue
        self._queue: collections.deque[Request] = collections.deque()
        self._next_id = 0
        self.closed = False

    def __len__(self) -> int:
        return len(self._queue)

    def close(self) -> None:
        """Stop admitting: every later :meth:`submit` raises
        :class:`QueueClosed`. Queued requests stay queued. Idempotent."""
        self.closed = True

    def submit(self, request: Request) -> int:
        """Validate + enqueue; returns the assigned request id. Raises
        :class:`QueueClosed` after :meth:`close`, :class:`QueueFull`
        (backpressure) or ``ValueError`` (a request that can never be
        served at this window)."""
        if self.closed:
            raise QueueClosed(
                "scheduler is closed (draining); no new requests admitted"
            )
        p_len = len(request.prompt)
        if p_len < 1:
            raise ValueError("prompt must contain at least one token")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if p_len + request.max_new_tokens > self.window:
            raise ValueError(
                f"prompt ({p_len}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds the serving window "
                f"{self.window}"
            )
        if len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"queue at capacity ({self.max_queue}); drain with "
                "step() before submitting more"
            )
        request.request_id = self._next_id
        request.submitted_s = time.perf_counter()
        self._next_id += 1
        self._queue.append(request)
        return request.request_id

    def pop(self, chunk: int = 0, pending_long: int = 0,
            fits=None) -> Request | None:
        """Next request in arrival order, or None when idle.

        Chunk-aware admission: with ``chunk`` set (the engine's
        ``prefill_chunk``) and a long prompt already mid chunked prefill
        (``pending_long > 0``), only a request whose prompt fits one chunk
        pops — short requests slip around the long one into free slots
        instead of queueing a second multi-step prefill behind it.

        ``fits`` is an optional host predicate over a :class:`Request` (the
        paged engine passes "enough free pages"), applied on top of the
        chunk rule: the first request in arrival order that fits pops; one
        that does not stays queued in its place and pops once pages free
        up. The defaults are the plain FIFO pop."""
        if chunk and pending_long:
            for i, r in enumerate(self._queue):
                if len(r.prompt) <= chunk and (fits is None or fits(r)):
                    del self._queue[i]
                    return r
            return None
        if fits is None:
            return self._queue.popleft() if self._queue else None
        for i, r in enumerate(self._queue):
            if fits(r):
                del self._queue[i]
                return r
        return None
