"""SLO tiers: priority scheduling and the host side of KV-swap preemption.

The port's own copy of the JAX package's ``serve/slo.py`` (host-only
Python there too): the POLICY half of the engine's SLO preemption — which
request pops next, which active slot is preempted, and the host record a
swapped-out request waits in. The MECHANISM half (the counted swap-out
fetch, the swap-in splice) lives in :mod:`.engine` and :mod:`.slots`.

- :class:`PriorityScheduler` (JAX ``:44``) pops by (class, arrival): class
  0 is the highest tier, within a class strict arrival order, and the
  ``chunk=`` / ``pending_long=`` / ``fits=`` predicates apply unchanged (a
  high-class request that does not fit stays queued and a lower class may
  pop around it). With ``n_classes=1`` every pop is the first passing
  candidate in arrival order: the :class:`.scheduler.FifoScheduler`'s
  order.
- :func:`choose_victim` (JAX ``:133``): an active slot is preempted only
  for a STRICTLY higher waiting class; the numerically greatest active
  class loses first, and among equals the most recently admitted request
  (largest id), so the oldest work keeps its progress.
- :class:`SwapRecord` (JAX ``:155``): a preempted request's parked state —
  the engine's own active record and the host copy of the slot's cache
  segment and sampling state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

from pytorch_distributed_training_tutorials_tpu_torch.serve.scheduler import (
    FifoScheduler,
    Request,
)


class PriorityScheduler(FifoScheduler):
    """Bounded multi-class queue: pop by (priority class, arrival).

    ``n_classes`` fixes the admission range: ``Request.priority`` must lie
    in ``[0, n_classes)`` or :meth:`~.scheduler.FifoScheduler.submit`
    raises ``ValueError``. One arrival-ordered deque backs every class; a
    pop scans for the best (lowest) class passing the predicates, ties
    broken by arrival."""

    def __init__(self, window: int, max_queue: int = 64, n_classes: int = 2):
        if n_classes < 1:
            raise ValueError(f"n_classes must be >= 1, got {n_classes}")
        super().__init__(window, max_queue=max_queue)
        self.n_classes = n_classes

    def pop(self, chunk: int = 0, pending_long: int = 0,
            fits=None) -> Request | None:
        """The best (class, arrival) request passing the predicates, or
        None (JAX ``:65``). The predicates are the FIFO scheduler's: with
        ``chunk`` set and a long prompt mid chunked prefill only
        single-chunk prompts are eligible, and ``fits`` filters on top.
        The scan stops at the first eligible class-0 request."""
        best: tuple[int, int] | None = None  # (priority, deque index)
        for i, r in enumerate(self._queue):
            if chunk and pending_long and len(r.prompt) > chunk:
                continue
            if fits is not None and not fits(r):
                continue
            p = int(r.priority)
            if best is None or p < best[0]:
                best = (p, i)
                if p == 0:
                    break
        if best is None:
            return None
        req = self._queue[best[1]]
        del self._queue[best[1]]
        return req

    def requeue(self, request: Request) -> None:
        """Re-insert a PREEMPTED request at its arrival position (request
        ids are the admission counter; JAX ``:94``). Bypasses
        ``QueueFull`` and ``QueueClosed`` on purpose: the request was
        admitted once, and preemption never sheds accepted work."""
        idx = len(self._queue)
        for i, r in enumerate(self._queue):
            if r.request_id > request.request_id:
                idx = i
                break
        self._queue.insert(idx, request)

    def peek_priority(self) -> int | None:
        """The best (numerically smallest) waiting class, or None when
        empty (JAX ``:108``): the engine considers preemption only when it
        outranks an active slot's class."""
        if not self._queue:
            return None
        return min(int(r.priority) for r in self._queue)

    def peek_request(self) -> Request | None:
        """The request a predicate-free :meth:`pop` would return, left in
        the queue (JAX ``:116``): the paged engine reads its page need to
        decide whether the pool, not the slots, calls for a preemption."""
        best = None
        for r in self._queue:
            p = int(r.priority)
            if best is None or p < best[0]:
                best = (p, r)
                if p == 0:
                    break
        return None if best is None else best[1]


def choose_victim(active: Iterable[tuple[int, int, int]],
                  waiting_class: int) -> int | None:
    """The slot to preempt for a ``waiting_class`` request, or None (JAX
    ``:133``). ``active`` yields ``(slot, priority, request_id)`` for every
    occupied slot. Only a class strictly below the waiter's (numerically
    greater) is eligible; the greatest class loses first, ties toward the
    largest request id (the most recent admission)."""
    victim: tuple[int, int, int] | None = None
    for slot, prio, rid in active:
        if prio <= waiting_class:
            continue
        if victim is None or (prio, rid) > (victim[1], victim[2]):
            victim = (slot, prio, rid)
    return None if victim is None else victim[0]


@dataclasses.dataclass
class SwapRecord:
    """A preempted request's parked state (JAX ``:155``).

    ``active`` is the engine's own active record (request, tokens so far,
    tokens remaining), reinstated whole at resume. ``packed`` is the ONE
    host copy the swap-out fetched: the slot's cache segment over
    positions ``[0, seg_len)`` (``seg_len`` the power-of-two bucket of
    ``position``, the slot's next write position), its last token and,
    speculative, its draft history; :func:`.slots.unpack` cuts it back
    into tensors. ``generator_state`` is the slot's sampling generator's
    state at the swap (host bytes: reading it made no sync), so the
    resumed request draws what the undisturbed one would. ``preempt_t``
    stamps the swap for the flight recorder's preempted-wait histogram."""

    active: Any
    packed: Any
    generator_state: Any
    position: int
    seg_len: int
    preempt_t: float = 0.0
