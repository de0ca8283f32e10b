"""Host-side radix prefix index: token-id prefixes -> retained KV segments.

The port's own copy of the JAX package's ``serve/prefix.py`` (pure Python
there too). Real request streams share long prompt prefixes (system
prompts, few-shot headers, multi-turn history), and prefill is the one
place the continuous-batching engine re-does work per request. This index
is the host half of the fix, after vLLM's shared prefix blocks (SOSP
'23): whole prefilled cache SEGMENTS are retained on the device, and a
new request that shares a prefix is seeded from one (one copy into a
batch-1 side cache, or, paged, its pages shared in place) plus a forward
over only the uncached suffix (``ServeEngine._splice``).

Like :mod:`.scheduler`, this file imports no ``torch`` (a subprocess test
pins it): segment handles are OPAQUE to the index — it never inspects
them, it only keeps them alive. Byte sizes are computed by the caller
(``slots.tree_nbytes``) from shapes and dtypes, so accounting never
touches the device.

Correctness facts the index leans on (the suffix continuation of
``models/transformer.py``):

- K/V at position ``i`` depends only on tokens ``[0, i]``, so every
  segment whose key starts with the same ``d`` tokens carries IDENTICAL
  cache content on ``[0, d)`` — any segment in the matched trie subtree
  is a valid donor at the matched depth;
- segment content at positions ``>= d`` is stale for the new request but
  is overwritten by the suffix forward (stores precede attention reads)
  or masked by the per-slot validity row, so it is never read.

Hence the radix structure: one trie over token ids, each stored segment
terminal at its key, each node counting the segments in its subtree so
longest-prefix-match is a single walk (descend while a child exists —
every resident node has count >= 1 — then surface any segment below).
"""

from __future__ import annotations

import collections
from typing import Any, Iterator, Sequence


class Segment:
    """One retained prefix: ``key`` (token-id tuple) -> ``handle`` (opaque
    to the index: a batch-1 cache sliced to ``bucket_len(len(key))``
    positions, or a paged engine's tuple of page ids). ``refcount`` pins the segment against LRU eviction while
    slots it seeded are in flight (:meth:`PrefixIndex.acquire` /
    :meth:`~PrefixIndex.release`)."""

    __slots__ = ("key", "handle", "nbytes", "refcount")

    def __init__(self, key: tuple[int, ...], handle: Any, nbytes: int):
        self.key = key
        self.handle = handle
        self.nbytes = int(nbytes)
        self.refcount = 0

    def __repr__(self) -> str:  # debugging aid only
        return (f"Segment(len={len(self.key)}, nbytes={self.nbytes}, "
                f"refcount={self.refcount})")


class _Node:
    """One trie node. ``count`` = segments terminal at or below this node
    (nodes are pruned at 0, so every resident node has ``count >= 1``)."""

    __slots__ = ("children", "count", "segment")

    def __init__(self):
        self.children: dict[int, _Node] = {}
        self.count = 0
        self.segment: Segment | None = None


class PrefixIndex:
    """Radix/trie prefix index with LRU eviction under a byte budget.

    - :meth:`insert` — insert-on-prefill: retain a segment keyed by its
      full token prefix; evicts least-recently-used UNPINNED segments
      until the new one fits (refuses, returning ``False``, when pinned
      segments leave no room — never evicts under a live refcount).
    - :meth:`lookup` — longest-prefix-match at pop time: the deepest
      resident trie node reachable through ``query[: len(query) - 1]``
      (at least one suffix token must always run — its logits sample the
      request's first token), returning ``(depth, segment)`` for any
      segment in that subtree. Refreshes the segment's LRU position.
    - :meth:`acquire` / :meth:`release` — refcount pin while a slot
      decodes from a splice of the segment. The engine acquires before
      splicing and releases at completion/parking, so eviction can only
      happen BETWEEN chains (inserts happen only during slot refill),
      never under a slot mid-decode.

    The index is pure host bookkeeping: dropping a ``Segment`` simply
    drops the last Python reference to its device tensors; the caching
    allocator takes the memory back. ``evicted_bytes`` / ``hits`` / ``misses`` feed the
    serving receipt.
    """

    def __init__(self, byte_budget: int, on_evict=None):
        if byte_budget < 1:
            raise ValueError("byte_budget must be >= 1")
        self.byte_budget = int(byte_budget)
        # eviction hook, called with the Segment BEFORE its handle is
        # cleared — the paged engine uses it to release the segment's
        # page refcounts back to the pool; the index itself stays
        # torch-free and handle-agnostic
        self._on_evict = on_evict
        self._root = _Node()
        # key -> Segment, in LRU order (front = coldest)
        self._lru: collections.OrderedDict[tuple[int, ...], Segment] = (
            collections.OrderedDict()
        )
        self.used_bytes = 0
        self.evicted_bytes = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, key: Sequence[int]) -> bool:
        return tuple(key) in self._lru

    # ------------------------------------------------------------------
    # core operations
    # ------------------------------------------------------------------

    def insert(self, key: Sequence[int], handle: Any, nbytes: int) -> bool:
        """Retain ``handle`` under ``key``; returns whether it was stored.

        An existing identical key is refreshed (moved hot), NOT replaced —
        both trees carry the same cache content (K/V at position ``i``
        depends only on tokens ``[0, i]``), so the resident one wins and
        the caller's copy is dropped. Returns ``False`` without storing
        when ``nbytes`` exceeds the budget even after evicting every
        unpinned segment."""
        key = tuple(int(t) for t in key)
        if not key:
            raise ValueError("key must contain at least one token")
        if key in self._lru:
            self._lru.move_to_end(key)
            return False
        if not self._make_room(int(nbytes)):
            return False
        seg = Segment(key, handle, nbytes)
        node = self._root
        node.count += 1
        for tok in key:
            node = node.children.setdefault(tok, _Node())
            node.count += 1
        node.segment = seg
        self._lru[key] = seg
        self.used_bytes += seg.nbytes
        return True

    def lookup(
        self, query: Sequence[int], min_depth: int = 1
    ) -> tuple[int, Segment] | None:
        """Longest-prefix-match of ``query`` against the resident keys.

        Returns ``(depth, segment)`` — reuse the segment's cache content
        on ``[0, depth)`` — or ``None`` below ``min_depth``. ``depth`` is
        capped at ``len(query) - 1`` so at least one suffix token always
        prefills (its logits sample the first generated token). The
        returned segment's key shares the query's first ``depth`` tokens
        (it lies in the matched node's subtree) and is at least ``depth``
        long, so its cache covers every reused position."""
        node = self._root
        depth = 0
        for tok in query[: len(query) - 1]:
            child = node.children.get(int(tok))
            if child is None:
                break
            node = child
            depth += 1
        if depth < max(1, int(min_depth)):
            self.misses += 1
            return None
        seg = self._first_segment(node)
        self._lru.move_to_end(seg.key)
        self.hits += 1
        return depth, seg

    def acquire(self, segment: Segment) -> None:
        """Pin ``segment`` against eviction (a slot is decoding from its
        splice); also refreshes its LRU position."""
        segment.refcount += 1
        if segment.key in self._lru:
            self._lru.move_to_end(segment.key)

    def release(self, segment: Segment) -> None:
        """Drop one pin. A released-to-zero segment becomes evictable
        again (it is NOT removed — it stays hot for the next hit)."""
        if segment.refcount <= 0:
            raise ValueError("release() without matching acquire()")
        segment.refcount -= 1

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _make_room(self, nbytes: int) -> bool:
        """Evict cold unpinned segments until ``nbytes`` fits the budget;
        False when pinned segments make that impossible."""
        if nbytes > self.byte_budget:
            return False
        while self.used_bytes + nbytes > self.byte_budget:
            victim = next(
                (s for s in self._lru.values() if s.refcount == 0), None
            )
            if victim is None:
                return False
            self._evict(victim)
        return True

    def evict_coldest(self) -> bool:
        """Evict the coldest UNPINNED segment, if any; returns whether
        one was evicted. The paged engine calls this under page-pool
        pressure (a queued request needs pages and the pool is dry but
        cold segments still hold refcounts) — repeated calls terminate
        because every eviction removes a segment."""
        victim = next(
            (s for s in self._lru.values() if s.refcount == 0), None
        )
        if victim is None:
            return False
        self._evict(victim)
        return True

    def _evict(self, seg: Segment) -> None:
        if self._on_evict is not None:
            self._on_evict(seg)
        del self._lru[seg.key]
        node = self._root
        node.count -= 1
        path = []
        for tok in seg.key:
            path.append((node, tok))
            node = node.children[tok]
            node.count -= 1
        node.segment = None
        for parent, tok in reversed(path):
            if parent.children[tok].count == 0:
                del parent.children[tok]
        self.used_bytes -= seg.nbytes
        self.evicted_bytes += seg.nbytes
        seg.handle = None  # drop the device reference eagerly

    def _first_segment(self, node: _Node) -> Segment:
        """Any segment terminal at or below ``node`` (count >= 1
        guarantees one exists — nodes prune at 0)."""
        while node.segment is None:
            node = next(iter(node.children.values()))
        return node.segment

    # ------------------------------------------------------------------
    # introspection (receipts / tests)
    # ------------------------------------------------------------------

    def segments(self) -> Iterator[Segment]:
        """Resident segments, coldest first."""
        return iter(self._lru.values())

    def stats(self) -> dict[str, int]:
        return {
            "segments": len(self._lru),
            "used_bytes": self.used_bytes,
            "evicted_bytes": self.evicted_bytes,
            "hits": self.hits,
            "misses": self.misses,
        }
