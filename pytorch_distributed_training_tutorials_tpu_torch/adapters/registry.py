"""Host-side adapter registry: tenant name -> bank row, with a byte budget.

The port's own copy of the JAX package's ``adapters/registry.py`` (pure
Python there too; the port imports nothing of that package). The device
half of multi-tenant serving is the stacked LoRA factor bank
(:mod:`.bank`), gathered by an integer adapter id inside every forward;
this module is the HOST half — the mapping from tenant names to bank
rows, plus admission bookkeeping — and it imports nothing but the
standard library.

Contracts:

- Row 0 is RESERVED for the base model (zero factors by construction in
  ``models.transformer.LoRADelta``); tenants get rows ``[1, n_adapters)``.
- ``register`` is admission: a full bank or a blown byte budget raises
  :class:`RegistryFull` synchronously — callers get backpressure at
  registration time, never a mid-decode surprise (the same
  validate-at-submit posture as ``FifoScheduler.submit``).
- Eviction is EXPLICIT (``evict(name)``), never an LRU side effect: a
  tenant's weights disappearing because another registered would be a
  serving correctness bug, unlike a prefix segment (pure cache) aging out.
- Rows are REUSED (lowest-free-first), so a bare row id does not identify
  a tenant across evict/register cycles: every ``register`` bumps the
  row's GENERATION counter (``generation(aid)``), and anything keyed or
  captured per tenant — prefix-cache namespaces, queued requests — must
  carry ``(aid, generation)``, never the row id alone. Row 0 (base) is
  never reassigned, so its generation stays 0 forever.
- Byte accounting uses caller-supplied per-adapter sizes (the bank
  computes them from factor metadata — no device fetch).
"""

from __future__ import annotations


class RegistryFull(Exception):
    """No free bank row (or byte budget exceeded) — admission failure."""


class AdapterRegistry:
    """Name -> integer bank row, rows ``[1, n_adapters)`` (0 = base).

    ``byte_budget`` of 0 means unbounded (row count still bounds the
    bank); otherwise the sum of registered adapters' ``nbytes`` must stay
    under it — note the bank's device footprint is allocated up front
    (``n_adapters`` stacked rows), the budget models what the operator
    allows RESIDENT, mirroring ``PrefixIndex``'s accounting.
    """

    def __init__(self, n_adapters: int, byte_budget: int = 0):
        if n_adapters < 2:
            raise ValueError(
                "n_adapters must be >= 2 (row 0 is reserved for the base "
                f"model), got {n_adapters}"
            )
        self.n_adapters = int(n_adapters)
        self.byte_budget = int(byte_budget)
        self._ids: dict[str, int] = {}
        self._nbytes: dict[str, int] = {}
        self._free = list(range(1, self.n_adapters))
        # per-row tenant-incarnation counter: bumped every time a row is
        # (re)assigned, so (aid, generation) identifies one tenant's
        # factors forever even though rows recycle
        self._gen = [0] * self.n_adapters
        self.used_bytes = 0
        self.n_registered_total = 0
        self.n_evicted = 0

    def register(self, name: str, nbytes: int = 0) -> int:
        """Admit ``name`` and return its bank row (lowest free row).

        Raises :class:`RegistryFull` when every row ``[1, n_adapters)`` is
        taken or the byte budget would be exceeded, and ``ValueError`` on
        a duplicate name (re-registering a live tenant would silently
        retarget its in-flight requests)."""
        if name in self._ids:
            raise ValueError(f"adapter {name!r} already registered")
        if not self._free:
            raise RegistryFull(
                f"all {self.n_adapters - 1} adapter rows in use"
            )
        if self.byte_budget and self.used_bytes + nbytes > self.byte_budget:
            raise RegistryFull(
                f"byte budget exceeded: {self.used_bytes} + {nbytes} > "
                f"{self.byte_budget}"
            )
        aid = self._free.pop(0)
        self._ids[name] = aid
        self._nbytes[name] = int(nbytes)
        self._gen[aid] += 1  # new tenant incarnation of this row
        self.used_bytes += int(nbytes)
        self.n_registered_total += 1
        return aid

    def evict(self, name: str) -> int:
        """Free ``name``'s row and return it (for the bank to zero)."""
        aid = self._ids.pop(name)
        self.used_bytes -= self._nbytes.pop(name)
        self._free.append(aid)
        self._free.sort()  # keep lowest-row-first assignment deterministic
        self.n_evicted += 1
        return aid

    def lookup(self, name: str) -> int:
        return self._ids[name]

    def __contains__(self, name: str) -> bool:
        return name in self._ids

    def __len__(self) -> int:
        return len(self._ids)

    def registered_ids(self) -> frozenset[int]:
        """Live bank rows (excluding the always-valid base row 0)."""
        return frozenset(self._ids.values())

    def is_live(self, aid: int) -> bool:
        """Is ``aid`` servable? Row 0 always; others only while registered
        (the engine's ``Request.adapter`` admission check)."""
        return aid == 0 or aid in self._ids.values()

    def generation(self, aid: int) -> int:
        """Current tenant incarnation of row ``aid`` (0 for the base row
        and for never-assigned rows). The engine captures this at submit
        and re-checks it at refill: a mismatch means the row was handed
        to a DIFFERENT tenant (or the same name re-registered with new
        factors) while the request sat in the queue — serving it anyway
        would decode under the wrong weights."""
        return self._gen[aid]

    def stats(self) -> dict:
        return {
            "n_adapters": self.n_adapters,
            "registered": len(self._ids),
            "free_rows": len(self._free),
            "used_bytes": self.used_bytes,
            "byte_budget": self.byte_budget,
            "registered_total": self.n_registered_total,
            "evicted": self.n_evicted,
        }
