"""Host-side page-pool allocator for the paged KV cache.

The port's own copy of the JAX package's ``serve/pages.py`` (pure Python
there too): the free-list half of the paged-attention design (vLLM, SOSP
'23). The device holds one ``(pool_pages, page_size, ...)`` K/V pool per
layer plus a per-slot page table (``models.transformer.PagedKVCache``);
this module decides which page ids a request owns and when they return
to the free list.

- **Allocation only at refill, never mid-decode.** The engine allocates
  ``pages_needed(p_len + max_new_tokens)`` pages before a request enters a
  slot, so a decode chain can never fail an allocation. Transient
  exhaustion keeps the request QUEUED (the scheduler's ``fits``
  predicate); only a request that could never fit the whole pool raises
  :class:`PoolExhausted` at submit — synchronous backpressure, like
  ``QueueFull``.
- **Refcounts** let a page have several holders (prefix sharing retains
  a donor's pages); a page returns to the free list when its last holder
  releases it.
- **Lowest-id-first reuse** (a heap) keeps the occupied region dense, so
  ``high_water * page_bytes`` is the most pool memory ever live at once.
"""

from __future__ import annotations

import heapq
from collections.abc import Iterable


class PoolExhausted(Exception):
    """Raised at ``ServeEngine.submit`` when a request needs more pages
    than the whole pool holds: it could never be scheduled. Transient
    pressure never raises; such requests wait queued for pages."""


class PagePool:
    """Fixed pool of ``pool_pages`` KV pages of ``page_size`` tokens.
    Pure host bookkeeping: the device pools live in the engine's slot
    state."""

    def __init__(self, pool_pages: int, page_size: int):
        if pool_pages < 1:
            raise ValueError("pool_pages must be >= 1")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.pool_pages = int(pool_pages)
        self.page_size = int(page_size)
        self._free: list[int] = list(range(self.pool_pages))
        heapq.heapify(self._free)
        self._refs: list[int] = [0] * self.pool_pages
        self.n_allocs = 0
        self.n_frees = 0
        self.n_shares = 0
        self.n_sheds = 0
        self.high_water = 0

    @property
    def available(self) -> int:
        """Pages on the free list."""
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Pages with at least one holder."""
        return self.pool_pages - len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` tokens (ceiling division)."""
        if n_tokens < 0:
            raise ValueError("n_tokens must be >= 0")
        return -(-n_tokens // self.page_size)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` free pages (each at refcount 1), lowest ids first;
        raises :class:`PoolExhausted` when fewer than ``n`` are free."""
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"(pool_pages={self.pool_pages})"
            )
        out = [heapq.heappop(self._free) for _ in range(n)]
        for pid in out:
            self._refs[pid] = 1
        self.n_allocs += n
        self.high_water = max(self.high_water, self.in_use)
        return out

    def retain(self, pid: int) -> None:
        """Add a holder to a live page."""
        if self._refs[pid] <= 0:
            raise ValueError(f"retain of free page {pid}")
        self._refs[pid] += 1
        self.n_shares += 1

    def release(self, pid: int) -> None:
        """Drop one holder; the page returns to the free list at zero."""
        if self._refs[pid] <= 0:
            raise ValueError(f"release of free page {pid}")
        self._refs[pid] -= 1
        if self._refs[pid] == 0:
            heapq.heappush(self._free, pid)
            self.n_frees += 1

    def release_all(self, pids: Iterable[int]) -> None:
        for pid in pids:
            self.release(pid)

    def refcount(self, pid: int) -> int:
        return self._refs[pid]

    def shed(self) -> None:
        """Count one admission-time :class:`PoolExhausted` rejection."""
        self.n_sheds += 1

    def stats(self) -> dict[str, int]:
        return {
            "allocs": self.n_allocs,
            "frees": self.n_frees,
            "shares": self.n_shares,
            "sheds": self.n_sheds,
            "in_use": self.in_use,
            "high_water": self.high_water,
        }

    def __repr__(self) -> str:
        return (
            f"PagePool(pages={self.pool_pages}, page_size={self.page_size}, "
            f"in_use={self.in_use}, high_water={self.high_water})"
        )
