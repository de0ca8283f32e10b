"""Fleet resilience: a multi-replica router with replica health,
exactly-once re-dispatch and hedged stragglers. The port's own copy of the
JAX package's ``serve/router.py``: host-only Python (it imports
:mod:`.scheduler` and, inside the functions that use them,
:mod:`..utils.chaos` and :mod:`..obs.flight`), fronting ``ServeEngine``
replicas by duck typing, every decision deterministic given the injected
``clock``.

The engine hardens one replica (slot quarantine, deadlines, boundary
cancellation); the router is the layer above it, surviving a whole
replica dying, stalling or poisoning itself under live traffic:

- **Health states** (``healthy -> suspect -> dead -> draining``), driven
  by observed symptoms only: the heartbeat age at the chain boundary (a
  replica that is neither idle nor advancing its chain, prefill or token
  counters is stalled), consecutive fault-stat deltas (a replica
  quarantining slot after slot), and ``QueueFull`` streaks (overload).
  ``dead`` is a circuit breaker: the replica is not stepped and gets no
  traffic; after ``probe_after_s`` the next submission probes it
  (half-open), a clean completion closes the circuit and any fault
  re-opens it.
- **Exactly-once re-dispatch**: every accepted request gets a global id
  and a :class:`DispatchLedger` entry of each dispatch (replica, local id,
  kind) and the ONE delivered completion. When a replica dies, its queued
  requests re-route to live replicas (the same ``Request`` template and
  seed, so greedy streams equal a fault-free run's) and its in-flight ones
  complete ``"replica_dead"``. :meth:`DispatchLedger.verify` re-derives
  the invariant from the records.
- **Hedged stragglers**: a request whose only live dispatch sits on a
  ``suspect`` replica past ``hedge_after_s`` is duplicated onto a healthy
  one; the first completion wins and the loser is ``cancel()``ed at its
  engine's boundary.
- **Prefix-affinity routing**: requests hash (:func:`affinity_hash`,
  FNV-1a over the adapter id and the first ``affinity_depth`` prompt
  tokens, never the salted builtin ``hash()``) onto a replica ring, so
  each replica's prefix cache sees a coherent key population; admission
  walks the ring past unhealthy, full or adapter-less replicas, and only
  when no replica admits does the caller get the engine's synchronous
  exception.

Observability: each replica keeps its own
:class:`..obs.flight.FlightRecorder` (a shared ``t0`` makes their
timestamps comparable) and the router stamps its own with
``replica_health`` / ``redispatch`` / ``hedge`` / ``stall`` events;
:meth:`FleetRouter.fleet_snapshot` merges all of them into one
``graft-flightlog/v1`` dump and :meth:`FleetRouter.stats` merges the
replicas' ``stats()`` into one fleet receipt (counters sum, configuration
passes through, percentiles come from the merged histograms).

An N=1 router with hedging off is plumbing: global ids are the engine's
local ids and the completions are the engine's own objects.

Disaggregation: a fleet of ``role="prefill"`` and ``role="decode"``
engines (all-or-nothing, at least one of each) takes submissions on its
prefill replicas only; each ``"handoff"`` completion's
:class:`.scheduler.Handoff` (``take_handoff``) moves to the least-``load``
healthy decode replica (:meth:`FleetRouter._move_handoffs`, ``accept``),
recorded in the ledger as a ``"handoff"`` dispatch.

Tensor parallelism: over engines that serve a model group's shards
(``ServeEngine(strategy=)`` with tp > 1, all over one model group), the
router runs on every rank of the group over the rank's engines, and its
decisions must be identical on every rank — a rank that routes otherwise
hangs the group's next collective. Its only rank-local input is the
clock (health, probes and hedging read it). So when a clock feature is
on — hedging, or a finite heartbeat or probe delay — the router reads the
clock ONCE a round, at the top of :meth:`FleetRouter.step`, on the
group's rank 0 and broadcasts it over the engines' CPU decision group;
every rank decides on that value (a submission between rounds on the
last one). With none on, no broadcast is issued.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from pytorch_distributed_training_tutorials_tpu_torch.serve.scheduler import (
    Completion,
    QueueClosed,
    QueueFull,
    Request,
)

# Replica health vocabulary. "dead" doubles as the circuit-breaker open
# state; a dead replica being probed stays "dead" until the probe's
# clean completion closes the circuit.
HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
DRAINING = "draining"
HEALTH_STATES = (HEALTHY, SUSPECT, DEAD, DRAINING)

# The finish_reason the router synthesizes for requests that were
# in-flight on a replica when it died: their partial tokens died with
# the replica's device state, so re-running them would break the
# "tokens earned are kept" accounting — the caller resubmits.
REPLICA_DEAD = "replica_dead"

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def affinity_hash(prompt, adapter: int = 0, depth: int = 16) -> int:
    """Deterministic 64-bit FNV-1a over the adapter id + the first
    ``depth`` prompt tokens. Python's builtin ``hash()`` is salted per
    process (PYTHONHASHSEED), which would scatter a restarted router's
    affinity and cold every replica's prefix cache — this hash is stable
    across processes and platforms. The adapter id leads the stream so
    two tenants sharing a prompt family land on (usually) different
    replicas, matching the tenant-scoped prefix-cache keys."""
    h = _FNV_OFFSET
    for tok in (int(adapter), *(int(t) for t in prompt[:depth])):
        h ^= tok & _MASK64
        h = (h * _FNV_PRIME) & _MASK64
    # Avalanche finalizer (the Murmur3 fmix64 constants): raw FNV-1a's
    # low bits are weak — the multiply preserves bit 0, so ``h % 2``
    # would be nothing but the XOR of token parities and a two-replica
    # ring would split traffic by prompt parity, not prompt identity.
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _MASK64
    h ^= h >> 33
    return h


@dataclasses.dataclass
class LedgerEntry:
    """One accepted request's dispatch history. ``dispatches`` holds
    ``(replica, local_rid, kind, t)`` rows — kind is "dispatch" |
    "redispatch" | "hedge" | "probe" | "handoff" (a prefill-role
    replica's finished segment moved onto a decode replica);
    ``delivered`` is the finish_reason
    of the ONE completion handed to the caller (None while open);
    ``absorbed`` records completions the router swallowed (hedge losers,
    drain-path cancellations) as ``(replica, local_rid, reason)``."""

    gid: int
    dispatches: List[Tuple[int, int, str, float]] = dataclasses.field(
        default_factory=list
    )
    delivered: Optional[str] = None
    delivered_by: int = -1
    absorbed: List[Tuple[int, int, str]] = dataclasses.field(
        default_factory=list
    )


class DispatchLedger:
    """The exactly-once proof object. Every accepted request opens an
    entry; every engine submission, delivered completion, and swallowed
    completion is recorded; :meth:`verify` re-derives the invariant from
    the records alone — no accepted request lost, none completed twice,
    no completion from a dispatch the router never made."""

    def __init__(self) -> None:
        self.entries: Dict[int, LedgerEntry] = {}
        self.n_redispatched = 0
        self.n_hedged = 0
        self.n_absorbed = 0

    def accepted(self, gid: int) -> None:
        if gid in self.entries:
            raise ValueError(f"gid {gid} already in ledger")
        self.entries[gid] = LedgerEntry(gid=gid)

    def dispatched(self, gid: int, replica: int, local_rid: int,
                   kind: str, t: float) -> None:
        self.entries[gid].dispatches.append((replica, local_rid, kind, t))
        if kind == "redispatch":
            self.n_redispatched += 1
        elif kind == "hedge":
            self.n_hedged += 1

    def delivered(self, gid: int, replica: int, reason: str) -> None:
        entry = self.entries[gid]
        if entry.delivered is not None:
            raise ValueError(
                f"gid {gid} delivered twice ({entry.delivered!r} then "
                f"{reason!r}) — exactly-once violated at record time"
            )
        entry.delivered = reason
        entry.delivered_by = replica

    def absorbed(self, gid: int, replica: int, local_rid: int,
                 reason: str) -> None:
        self.entries[gid].absorbed.append((replica, local_rid, reason))
        self.n_absorbed += 1

    def open_ids(self) -> List[int]:
        return [g for g, e in self.entries.items() if e.delivered is None]

    def verify(self, final: bool = True) -> List[str]:
        """Return the list of exactly-once violations (empty = proof
        holds). With ``final=True`` (end of run) an undelivered entry is
        itself a violation — an accepted request was LOST."""
        problems: List[str] = []
        for gid, e in sorted(self.entries.items()):
            if not e.dispatches:
                problems.append(f"gid {gid}: accepted but never dispatched")
            if final and e.delivered is None:
                problems.append(f"gid {gid}: accepted but never completed")
            pairs = {(r, l) for r, l, _, _ in e.dispatches}
            for r, l, reason in e.absorbed:
                if (r, l) not in pairs:
                    problems.append(
                        f"gid {gid}: absorbed completion from undisp"
                        f"atched (replica={r}, local={l}, {reason!r})"
                    )
            if e.delivered is not None and e.delivered_by >= 0:
                if e.delivered != REPLICA_DEAD and not any(
                    r == e.delivered_by for r, _, _, _ in e.dispatches
                ):
                    problems.append(
                        f"gid {gid}: delivered by replica "
                        f"{e.delivered_by} which never held a dispatch"
                    )
        return problems


class _Replica:
    """Per-replica router-side bookkeeping (the engine itself holds no
    fleet state). ``local_gid`` maps the engine's local request ids to
    router gids — a dispatch is LIVE while its pair is present here."""

    __slots__ = (
        "index", "engine", "role", "state", "heartbeat", "last_sig",
        "last_faults", "fault_streak", "queue_full_streak",
        "dead_since", "dead_reason", "probing", "probe_gid",
        "stall_skips", "local_gid",
    )

    def __init__(self, index: int, engine: Any):
        self.index = index
        self.engine = engine
        # disaggregation role: None = monolithic,
        # "prefill" / "decode" = the role-specialized halves
        self.role = getattr(engine, "role", None)
        self.state = HEALTHY
        self.heartbeat: Optional[float] = None
        self.last_sig: Optional[tuple] = None
        self.last_faults = 0
        self.fault_streak = 0
        self.queue_full_streak = 0
        self.dead_since: Optional[float] = None
        self.dead_reason = ""
        self.probing = False
        self.probe_gid: Optional[int] = None
        self.stall_skips = 0
        self.local_gid: Dict[int, int] = {}

    def progress_signature(self) -> tuple:
        """Anything that moves when the replica does real work — chains,
        prefills, splices, chunks, tokens. Observed at the chain
        boundary (after ``step()``), so an unchanged signature on a
        non-idle replica means a stalled launch, not a quiet one."""
        e = self.engine
        return (
            getattr(e, "n_chains", 0), getattr(e, "n_prefills", 0),
            getattr(e, "n_splices", 0), getattr(e, "n_chunks", 0),
            getattr(e, "generated_tokens", 0),
        )

    def fault_total(self) -> int:
        """Self-inflicted faults only: nonfinite quarantines + prefill
        errors. Deadline expiries and cancellations are the CALLER's
        outcomes, not replica symptoms — counting them would let one
        impatient client kill a healthy replica."""
        fn = getattr(self.engine, "fault_stats", None)
        if fn is None:
            return 0
        fs = fn()
        return int(fs.get("nonfinite_quarantined", 0)) + int(
            fs.get("prefill_errors", 0)
        )


def _is_queued(engine: Any, local_rid: int) -> bool:
    """Queued-but-unstarted test, duck-typed: real engines expose
    ``scheduler.has``; the unit tests' fakes expose ``has_queued``."""
    sched = getattr(engine, "scheduler", None)
    if sched is not None and hasattr(sched, "has"):
        return bool(sched.has(local_rid))
    return bool(engine.has_queued(local_rid))


class FleetRouter:
    """The fleet front door. Pure host; engines are duck-typed
    against the ``ServeEngine`` surface (``submit`` / ``step`` /
    ``cancel`` / ``idle`` / counters / ``fault_stats`` / ``stats``).

    Parameters
    ----------
    engines: the N replicas. Replica index = position in this list.
    affinity_depth: prompt-prefix tokens feeding :func:`affinity_hash`.
    hedge_after_s: duplicate a request stuck on a SUSPECT replica after
        this many seconds (None = hedging off, the default). A dict maps
        SLO class -> threshold: interactive class 0 hedges
        aggressively while batch classes wait longer (a class missing
        from the map never hedges) — the per-request class comes from
        ``Request.priority``.
    class_deadline_s: per-SLO-class default deadline: a dict
        mapping ``Request.priority`` -> seconds, stamped onto a
        submission whose own ``deadline_s`` is None (an explicit
        per-request deadline always wins; classes missing from the map
        fall through to the engine's ``default_deadline_s``). Stamped
        BEFORE the re-dispatch template is frozen, so a request moved
        off a dead replica keeps its class deadline.
    suspect_after_s / dead_after_s: heartbeat ages (no observable
        progress while non-idle) that demote healthy -> suspect ->
        dead.
    fault_streak: consecutive faulty observations before a replica goes
        suspect (twice that: dead).
    queue_full_streak: consecutive ``QueueFull`` bounces before the
        replica is marked suspect (overload, not death — it recovers on
        its next observed progress).
    probe_after_s: circuit-breaker half-open delay — how long a dead
        replica rests before the next submission probes it.
    chaos: a :class:`..utils.chaos.FleetChaosConfig` for deterministic
        replica-level fault injection (kill at a chain count, stall for
        N scheduling rounds).
    flight: the ROUTER's own :class:`..obs.flight.FlightRecorder` for
        ``replica_health`` / ``redispatch`` / ``hedge`` / ``stall``
        events; replica engines carry their own recorders.
    clock: injectable monotonic clock (tests pin health/probe timing
        with a fake; defaults to ``time.perf_counter``). Over
        tensor-parallel engines only rank 0's reading counts (module
        docstring).
    """

    def __init__(self, engines: List[Any], *,
                 affinity_depth: int = 16,
                 hedge_after_s: Any = None,
                 class_deadline_s: Optional[Dict[int, float]] = None,
                 suspect_after_s: float = 1.0,
                 dead_after_s: float = 5.0,
                 fault_streak: int = 3,
                 queue_full_streak: int = 3,
                 probe_after_s: float = 1.0,
                 chaos: Any = None,
                 flight: Any = None,
                 clock: Optional[Callable[[], float]] = None):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        self._replicas = [_Replica(i, e) for i, e in enumerate(engines)]
        roles = [r.role for r in self._replicas]
        self._disagg = any(r is not None for r in roles)
        if self._disagg:
            # roles are all-or-nothing: a monolithic replica in a
            # disaggregated fleet would race the handoff path for the
            # same requests, and a fleet missing either role can never
            # complete one
            if any(r is None for r in roles):
                raise ValueError(
                    "mixed fleet: every engine must carry a role when "
                    f"any does (roles={roles})"
                )
            if "prefill" not in roles or "decode" not in roles:
                raise ValueError(
                    "disaggregated fleet needs at least one prefill "
                    f"AND one decode replica (roles={roles})"
                )
        self._affinity_depth = int(affinity_depth)
        if isinstance(hedge_after_s, dict):
            self._hedge_after_s = {
                int(k): float(v) for k, v in hedge_after_s.items()
            }
        else:
            self._hedge_after_s = hedge_after_s
        self._class_deadline_s = (
            {int(k): float(v) for k, v in class_deadline_s.items()}
            if class_deadline_s else None
        )
        self._suspect_after_s = float(suspect_after_s)
        self._dead_after_s = float(dead_after_s)
        self._fault_streak_limit = int(fault_streak)
        self._queue_full_limit = int(queue_full_streak)
        self._probe_after_s = float(probe_after_s)
        self._chaos = chaos
        self._flight = flight
        self._clock = clock if clock is not None else time.perf_counter
        # tensor parallel: the engines' decision group, and the clock
        # agreed on it once a round when a clock feature is on
        groups = {}
        for e in engines:
            g = getattr(e, "_dgroup", None)
            groups[id(g)] = (g, getattr(e, "_dsrc", None))
        if len(groups) > 1:
            raise ValueError("a FleetRouter's engines must all be replicated or all "
                             "tensor-parallel over one model group")
        self._dgroup, self._dsrc = next(iter(groups.values()))
        self._agree_clock = self._dgroup is not None and (
            hedge_after_s is not None
            or any(math.isfinite(x) for x in (self._suspect_after_s, self._dead_after_s,
                                              self._probe_after_s)))
        self.n_clock_broadcasts = 0
        if self._agree_clock:
            self._local_clock = self._clock
            self._round_now = self._agreed_now()
            self._clock = lambda: self._round_now
        self.ledger = DispatchLedger()
        self._next_gid = 0
        self._requests: Dict[int, Request] = {}
        # (replica, local_rid) cancellations the ROUTER issued (hedge
        # losers, drain moves): their "cancelled" completions are
        # absorbed, never delivered.
        self._router_cancelled: set = set()
        self._closed = False
        self.n_spillovers = 0
        self.n_probes = 0
        self.n_dead_completions = 0
        self.n_health_transitions = 0
        # disaggregation state: handoffs collected from
        # prefill replicas awaiting a decode replica, gids whose
        # handoff was already staged/placed (a hedged prefill's
        # duplicate emit is absorbed, never staged twice), and gids
        # cancelled while their handoff waits (delivered "cancelled"
        # at the next move round — the chain-boundary contract).
        self._pending_handoffs: List[Tuple[int, Any]] = []
        self._handoff_done: set = set()
        self._cancelled_gids: set = set()
        self.n_handoffs_moved = 0

    # -- introspection -----------------------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    def replica_states(self) -> List[str]:
        return [r.state for r in self._replicas]

    @property
    def idle(self) -> bool:
        """Nothing left that can change caller-visible state: every
        accepted request has its one delivered completion and no live
        replica still works on an UNdelivered one. A cancelled hedge
        loser grinding on a stalled replica does not hold the fleet
        non-idle — its eventual completion is absorbed, not delivered
        (dead replicas are resolved by the step loop, so their entries
        close without the engine going idle)."""
        if self.ledger.open_ids():
            return False
        return all(
            rep.state == DEAD or rep.engine.idle or all(
                self.ledger.entries[g].delivered is not None
                for g in rep.local_gid.values()
            )
            for rep in self._replicas
        )

    # -- admission ---------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Place one request on the fleet; returns its GLOBAL id.
        Routing is prefix-affine with failover (see module docstring);
        the request object passed in is never mutated — a pristine
        template is kept for re-dispatch/hedging and a fresh clone goes
        to each engine (engines stamp ``request_id``/``submitted_s`` on
        what they are given). Raises ``QueueFull`` / ``QueueClosed`` /
        ``ValueError`` only when NO replica admits — the engine's
        synchronous-admission contract, fleet-wide."""
        if self._closed:
            raise QueueClosed("fleet router is closed")
        template = dataclasses.replace(request)
        if (self._class_deadline_s is not None
                and template.deadline_s is None):
            # class-indexed deadline policy: stamped on the
            # TEMPLATE, so every dispatch clone — including re-dispatch
            # off a dead replica — carries the same class deadline; an
            # explicit per-request deadline_s always wins
            template.deadline_s = self._class_deadline_s.get(
                int(getattr(template, "priority", 0))
            )
        now = self._clock()
        probe = self._probe_candidate(now, role="prefill")
        order = ([probe] if probe is not None else []) + self._route_order(
            template
        )
        last_exc: Optional[Exception] = None
        for rep in order:
            try:
                local = rep.engine.submit(dataclasses.replace(template))
            except QueueFull as e:
                rep.queue_full_streak += 1
                self.n_spillovers += 1
                if (rep.queue_full_streak >= self._queue_full_limit
                        and rep.state == HEALTHY):
                    self._transition(rep, SUSPECT, "queue_full_streak", now)
                last_exc = e
                continue
            except (QueueClosed, ValueError) as e:
                last_exc = e
                continue
            rep.queue_full_streak = 0
            gid = self._next_gid
            self._next_gid += 1
            self._requests[gid] = template
            rep.local_gid[local] = gid
            self.ledger.accepted(gid)
            kind = "probe" if rep is probe else "dispatch"
            self.ledger.dispatched(gid, rep.index, local, kind, now)
            if rep is probe:
                rep.probing = True
                rep.probe_gid = gid
                self.n_probes += 1
                self._record("replica_health", replica=rep.index,
                             frm=DEAD, to="probing", reason="half_open")
            return gid
        if last_exc is not None:
            raise last_exc
        raise QueueFull("no routable replica")

    def _route_order(self, request: Request) -> List[_Replica]:
        """The affinity ring from the request's hash: healthy replicas
        in ring order, then suspect ones (still serving, just avoided).
        Dead and draining replicas take no new traffic. Disaggregated
        fleets restrict the ring to PREFILL replicas:
        submissions — and re-dispatches after a decode death, which
        re-run the prefill — always enter through the prefill side;
        decode replicas receive work only via :meth:`_move_handoffs`."""
        h = affinity_hash(
            request.prompt, adapter=int(getattr(request, "adapter", 0)),
            depth=self._affinity_depth,
        )
        n = len(self._replicas)
        ring = [self._replicas[(h + k) % n] for k in range(n)]
        if self._disagg:
            ring = [r for r in ring if r.role == "prefill"]
        return (
            [r for r in ring if r.state == HEALTHY]
            + [r for r in ring if r.state == SUSPECT]
        )

    def _probe_candidate(self, now: float,
                         role: Optional[str] = None) -> Optional[_Replica]:
        """First dead replica (of ``role``, when disaggregated) whose
        circuit-breaker rest expired and has no probe outstanding — the
        half-open state. The next submission (prefill/monolithic) or
        pending handoff (decode) becomes its probe; exactly-once
        machinery makes the gamble safe (a failed probe's request is
        re-dispatched like any other)."""
        for rep in self._replicas:
            if self._disagg and rep.role != role:
                continue
            if (rep.state == DEAD and not rep.probing
                    and rep.dead_since is not None
                    and now - rep.dead_since >= self._probe_after_s):
                return rep
        return None

    # -- the scheduling round ---------------------------------------------

    def step(self) -> List[Completion]:
        """One fleet round: step every live replica, observe symptoms,
        apply health transitions, resolve dead replicas' outstanding
        work (re-dispatch queued, synthesize ``replica_dead`` for
        in-flight), then hedge stragglers. Returns completions with
        GLOBAL ids, exactly one per accepted request ever. Over
        tensor-parallel engines with a clock feature on, the round's clock
        is rank 0's, read once here (module docstring)."""
        if self._agree_clock:
            self._round_now = self._agreed_now()
        out: List[Completion] = []
        for rep in self._replicas:
            now = self._clock()
            if self._chaos_killed(rep):
                # a chaos kill is PERMANENT: never step the engine (it
                # is actually fine — death is simulated at the router
                # boundary), and a half-open probe against it fails,
                # re-opening the circuit with a fresh timer.
                if rep.state != DEAD:
                    self._mark_dead(rep, "chaos_kill", now)
                elif rep.probing:
                    rep.probing = False
                    rep.probe_gid = None
                    rep.dead_since = now
                    self._record("replica_health", replica=rep.index,
                                 frm="probing", to=DEAD,
                                 reason="probe_failed:chaos_kill")
                continue
            if rep.state == DEAD and not rep.probing:
                continue
            if self._chaos_stalled(rep):
                rep.stall_skips += 1
                self._record("stall", replica=rep.index,
                             skipped_round=rep.stall_skips)
                self._observe(rep, now, stalled=True)
                continue
            try:
                comps = rep.engine.step()
            except Exception as e:  # engine blew up: circuit opens
                self._mark_dead(
                    rep, f"step_raised:{type(e).__name__}", now
                )
                continue
            out.extend(self._collect(rep, comps, self._clock()))
            self._observe(rep, self._clock())
        now = self._clock()
        out.extend(self._resolve_dead(now))
        if self._disagg:
            out.extend(self._move_handoffs(now))
        self._maybe_hedge(now)
        return out

    def _agreed_now(self) -> float:
        """Rank 0's clock, broadcast over the engines' decision group (one
        float64 over the CPU gloo group; counted in
        ``n_clock_broadcasts``)."""
        import torch
        import torch.distributed as dist

        now = torch.tensor([self._local_clock()], dtype=torch.float64)
        dist.broadcast(now, src=self._dsrc, group=self._dgroup)
        self.n_clock_broadcasts += 1
        return float(now[0])

    def run_until_idle(self, max_steps: int = 10_000) -> List[Completion]:
        out: List[Completion] = []
        for _ in range(max_steps):
            if self.idle and self._engines_drained():
                return out
            out.extend(self.step())
        raise RuntimeError(f"fleet not idle after {max_steps} steps")

    def _engines_drained(self) -> bool:
        """Caller-visible idleness is not the whole story: a pipelined
        engine can hold a dispatched-but-uncollected trailing bubble
        chain (counted in ``n_chains`` at dispatch) after its last
        delivery. Keep stepping until every HEALTHY replica's engine is
        itself idle, so the fleet fetch budget stays exactly the SUM of
        per-replica budgets and no launch is left in flight. Only
        healthy replicas are waited on: a suspect/dead/frozen replica
        may never drain (the hedged-straggler case — its leftover work
        is a cancelled loser whose eventual completion is absorbed),
        and blocking on it would hang the loop; chaos-killed/-stalled
        replicas are skipped by the step loop entirely."""
        return all(
            rep.state != HEALTHY
            or self._chaos_killed(rep)
            or self._chaos_stalled(rep)
            or bool(getattr(rep.engine, "idle", True))
            for rep in self._replicas
        )

    def cancel(self, gid: int) -> bool:
        """Caller-side cancellation by GLOBAL id: forwarded to every
        live dispatch (the first resulting "cancelled" completion is
        delivered, any other is deduplicated by the ledger)."""
        entry = self.ledger.entries.get(gid)
        if entry is None or entry.delivered is not None:
            return False
        if any(g == gid for g, _ in self._pending_handoffs):
            # cancelled between prefill and decode: no
            # engine holds it — the next _move_handoffs round delivers
            # "cancelled" (that round IS this request's chain boundary)
            self._cancelled_gids.add(gid)
            return True
        any_known = False
        for rep_i, local, _, _ in entry.dispatches:
            rep = self._replicas[rep_i]
            if local in rep.local_gid:
                try:
                    any_known = bool(rep.engine.cancel(local)) or any_known
                except Exception:
                    pass
        return any_known

    def close(self) -> None:
        """Fleet-wide admission stop (synchronous ``QueueClosed``
        backpressure on later submits); accepted work is unaffected."""
        self._closed = True
        for rep in self._replicas:
            # decode replicas must keep ADMITTING during a drain: their
            # intake is accepted work's handoffs, not new requests —
            # the router's own closed flag is the fleet admission stop
            if rep.state != DEAD and rep.role != "decode":
                try:
                    rep.engine.close()
                except Exception:
                    pass

    def drain(self, max_steps: int = 10_000) -> List[Completion]:
        """Graceful fleet shutdown: close, then run every accepted
        request to its one completion."""
        self.close()
        return self.run_until_idle(max_steps)

    # -- rolling drain -----------------------------------------------------

    def drain_replica(self, index: int) -> int:
        """Put one replica into rolling drain: no new traffic, its
        QUEUED requests move to healthy replicas in submit order (the
        local cancellation's completion is absorbed — the move is
        invisible to callers), in-flight requests finish normally.
        Returns how many requests moved. Pair with
        :meth:`undrain_replica` for a rolling restart."""
        rep = self._replicas[index]
        if rep.state == DEAD:
            raise ValueError(f"replica {index} is dead, not drainable")
        if rep.state != DRAINING:
            self._transition(rep, DRAINING, "drain_replica", self._clock())
        moved = 0
        # dict preserves insertion order == local submit order
        for local, gid in list(rep.local_gid.items()):
            if not _is_queued(rep.engine, local):
                continue
            target = self._place(
                self._requests[gid], gid, kind="redispatch",
                exclude={rep.index},
            )
            if target is None:
                continue  # fleet saturated: it finishes on the drainer
            rep.engine.cancel(local)
            self._router_cancelled.add((rep.index, local))
            self._record("redispatch", gid=gid, frm=rep.index,
                         to=target.index, reason="drain")
            moved += 1
        return moved

    def undrain_replica(self, index: int) -> None:
        """Return a drained replica to service (rolling restart done)."""
        rep = self._replicas[index]
        if rep.state != DRAINING:
            raise ValueError(
                f"replica {index} is {rep.state!r}, not draining"
            )
        rep.fault_streak = 0
        rep.queue_full_streak = 0
        rep.heartbeat = None
        rep.last_sig = None
        self._transition(rep, HEALTHY, "undrain_replica", self._clock())

    # -- completion collection --------------------------------------------

    def _collect(self, rep: _Replica, comps: List[Completion],
                 now: float) -> List[Completion]:
        delivered: List[Completion] = []
        for c in comps:
            gid = rep.local_gid.pop(c.request_id, None)
            if gid is None:
                continue  # not router-placed (or already resolved)
            if (rep.index, c.request_id) in self._router_cancelled:
                self._router_cancelled.discard((rep.index, c.request_id))
                self.ledger.absorbed(
                    gid, rep.index, c.request_id, c.finish_reason
                )
                continue
            if c.finish_reason == "handoff":
                # a prefill replica finished its half: the
                # completion is ABSORBED — the ledger entry stays open
                # (holding the fleet non-idle) until the decode side
                # delivers. The segment moves at this round's
                # _move_handoffs; a duplicate emit from a hedged
                # prefill is collected (the emitter's map must drain)
                # but dropped.
                self.ledger.absorbed(
                    gid, rep.index, c.request_id, "handoff"
                )
                handoff = rep.engine.take_handoff(c.request_id)
                if rep.probing and gid == rep.probe_gid:
                    self._resolve_probe(rep, "handoff", now)
                if (gid not in self._handoff_done
                        and self.ledger.entries[gid].delivered is None):
                    self._handoff_done.add(gid)
                    self._pending_handoffs.append((gid, handoff))
                continue
            entry = self.ledger.entries[gid]
            if entry.delivered is not None:
                # hedge race: the other replica already won
                self.ledger.absorbed(
                    gid, rep.index, c.request_id, c.finish_reason
                )
                continue
            # first completion wins; cancel any other live dispatch
            for rep_i, local, _, _ in entry.dispatches:
                if rep_i == rep.index and local == c.request_id:
                    continue
                loser = self._replicas[rep_i]
                if local in loser.local_gid:
                    try:
                        loser.engine.cancel(local)
                    except Exception:
                        pass
                    self._router_cancelled.add((rep_i, local))
            self.ledger.delivered(gid, rep.index, c.finish_reason)
            if rep.probing and gid == rep.probe_gid:
                self._resolve_probe(rep, c.finish_reason, now)
            if c.request_id == gid:
                delivered.append(c)  # N=1 parity: identical object
            else:
                delivered.append(dataclasses.replace(c, request_id=gid))
        return delivered

    def _resolve_probe(self, rep: _Replica, reason: str,
                       now: float) -> None:
        rep.probing = False
        rep.probe_gid = None
        # "handoff" is the prefill-role success outcome:
        # monolithic/decode replicas never emit it
        if reason in ("length", "eos", "handoff"):
            rep.fault_streak = 0
            rep.queue_full_streak = 0
            rep.heartbeat = now
            rep.last_faults = rep.fault_total()
            self._transition(rep, HEALTHY, "probe_ok", now)
        else:
            rep.dead_since = now  # circuit re-opens, timer restarts
            self._record("replica_health", replica=rep.index,
                         frm="probing", to=DEAD,
                         reason=f"probe_failed:{reason}")

    # -- health observation ------------------------------------------------

    def _observe(self, rep: _Replica, now: float,
                 stalled: bool = False) -> None:
        sig = rep.progress_signature()
        idle = bool(getattr(rep.engine, "idle", False))
        progressed = (not stalled) and (
            idle or rep.last_sig is None or sig != rep.last_sig
        )
        rep.last_sig = sig
        faults = rep.fault_total()
        if faults > rep.last_faults:
            rep.fault_streak += 1
        elif progressed:
            rep.fault_streak = 0
        rep.last_faults = faults
        if rep.heartbeat is None:
            rep.heartbeat = now
        if progressed:
            rep.heartbeat = now
            if rep.state == SUSPECT and rep.fault_streak == 0:
                self._transition(rep, HEALTHY, "progress", now)
        if rep.state not in (HEALTHY, SUSPECT):
            return
        if rep.fault_streak >= 2 * self._fault_streak_limit:
            self._mark_dead(rep, "fault_streak", now)
            return
        if (rep.fault_streak >= self._fault_streak_limit
                and rep.state == HEALTHY):
            self._transition(rep, SUSPECT, "fault_streak", now)
        age = now - rep.heartbeat
        if age > self._dead_after_s:
            self._mark_dead(rep, "heartbeat", now)
        elif age > self._suspect_after_s and rep.state == HEALTHY:
            self._transition(rep, SUSPECT, "heartbeat", now)

    def _transition(self, rep: _Replica, to: str, reason: str,
                    now: float) -> None:
        frm = rep.state
        if frm == to:
            return
        rep.state = to
        self.n_health_transitions += 1
        self._record("replica_health", replica=rep.index, frm=frm,
                     to=to, reason=reason)

    def _mark_dead(self, rep: _Replica, reason: str, now: float) -> None:
        rep.dead_since = now
        rep.dead_reason = reason
        rep.probing = False
        rep.probe_gid = None
        self._transition(rep, DEAD, reason, now)

    # -- dead-replica resolution ------------------------------------------

    def _resolve_dead(self, now: float) -> List[Completion]:
        """Exactly-once re-dispatch: move a dead replica's queued
        requests to live replicas (same template, same seed — token
        streams identical) and synthesize ``replica_dead`` completions
        for the in-flight ones. Every local id is also cancelled on the
        dead engine, so a later probe revival cannot replay work the
        router already resolved."""
        out: List[Completion] = []
        for rep in self._replicas:
            # a probing replica is half-open, not dead-dead: its probe
            # request must be left to complete (or fail) on it —
            # resolving it here would cancel the probe every round and
            # the circuit could never close.
            if rep.state != DEAD or rep.probing or not rep.local_gid:
                continue
            for local, gid in list(rep.local_gid.items()):
                try:
                    queued = _is_queued(rep.engine, local)
                except Exception:
                    queued = False
                try:
                    rep.engine.cancel(local)
                except Exception:
                    pass
                del rep.local_gid[local]
                self._router_cancelled.add((rep.index, local))
                if rep.role == "decode":
                    # the transferred segment died with the replica: a
                    # re-dispatch re-runs the PREFILL (the ring is the
                    # prefill subset), whose fresh handoff must be
                    # allowed to stage again
                    self._handoff_done.discard(gid)
                entry = self.ledger.entries[gid]
                if entry.delivered is not None:
                    continue  # hedge twin already completed it
                if queued and self._live_dispatches(entry):
                    continue  # hedge twin still running elsewhere
                target = None
                if queued:
                    target = self._place(
                        self._requests[gid], gid, kind="redispatch",
                        exclude={rep.index},
                    )
                if target is not None:
                    self._record("redispatch", gid=gid, frm=rep.index,
                                 to=target.index, reason="replica_dead")
                    continue
                if self._live_dispatches(entry):
                    continue  # a hedge twin will deliver
                template = self._requests[gid]
                self.ledger.delivered(gid, rep.index, REPLICA_DEAD)
                self.n_dead_completions += 1
                out.append(Completion(
                    request_id=gid, prompt=template.prompt, tokens=[],
                    finish_reason=REPLICA_DEAD, latency_s=0.0,
                ))
        return out

    def _live_dispatches(
        self, entry: LedgerEntry
    ) -> List[Tuple[int, int]]:
        return [
            (r, l) for r, l, _, _ in entry.dispatches
            if l in self._replicas[r].local_gid
            and self._replicas[r].local_gid[l] == entry.gid
        ]

    def _place(self, template: Request, gid: int, kind: str,
               exclude: set) -> Optional[_Replica]:
        """Re-dispatch/hedge placement: the affinity ring minus
        ``exclude``. Hedges go to HEALTHY replicas only (a hedge onto a
        suspect replica would just mint a second straggler);
        re-dispatches fall back to suspect replicas — a slow completion
        beats a synthesized loss. Returns the chosen replica, or None
        when the fleet has nowhere to put it."""
        now = self._clock()
        allow_suspect = kind == "redispatch"
        for rep in self._route_order(template):
            if rep.index in exclude:
                continue
            if rep.state != HEALTHY and not allow_suspect:
                continue
            try:
                local = rep.engine.submit(dataclasses.replace(template))
            except (QueueFull, QueueClosed, ValueError):
                continue
            rep.local_gid[local] = gid
            self.ledger.dispatched(gid, rep.index, local, kind, now)
            return rep
        return None

    # -- handoff movement ---------------------------------------

    def _move_handoffs(self, now: float) -> List[Completion]:
        """Move each pending handoff onto the least-``load`` HEALTHY
        decode replica via ``engine.accept`` — a ``"handoff"`` ledger
        dispatch, so exactly-once spans the transfer. A gid cancelled
        while its handoff waited delivers ``"cancelled"`` here (the
        handoff's chain boundary); a fleet with no admitting decode
        replica keeps the handoff pending — retried every round, and
        the open ledger entry keeps the fleet non-idle. A rested dead
        decode replica takes the first moved handoff as its half-open
        probe (delivery heals it, any fault re-opens the circuit)."""
        out: List[Completion] = []
        if not self._pending_handoffs:
            return out
        still: List[Tuple[int, Any]] = []
        probe = self._probe_candidate(now, role="decode")
        for gid, handoff in self._pending_handoffs:
            template = self._requests[gid]
            if gid in self._cancelled_gids:
                self._cancelled_gids.discard(gid)
                self._handoff_done.discard(gid)
                self.ledger.delivered(gid, -1, "cancelled")
                out.append(Completion(
                    request_id=gid, prompt=list(template.prompt),
                    tokens=[], finish_reason="cancelled", latency_s=0.0,
                ))
                continue
            targets = sorted(
                (r for r in self._replicas
                 if r.role == "decode" and r.state == HEALTHY),
                key=lambda r: int(getattr(r.engine, "load", 0)),
            )
            if probe is not None:
                targets.append(probe)  # last resort: the half-open gamble
            placed = False
            for rep in targets:
                try:
                    local = rep.engine.accept(
                        dataclasses.replace(template), handoff
                    )
                except (QueueFull, QueueClosed, ValueError):
                    continue
                rep.local_gid[local] = gid
                self.ledger.dispatched(
                    gid, rep.index, local, "handoff", now
                )
                self.n_handoffs_moved += 1
                self._record("handoff_move", gid=gid, to=rep.index)
                if rep is probe:
                    rep.probing = True
                    rep.probe_gid = gid
                    self.n_probes += 1
                    probe = None
                    self._record("replica_health", replica=rep.index,
                                 frm=DEAD, to="probing",
                                 reason="half_open")
                placed = True
                break
            if not placed:
                still.append((gid, handoff))
        self._pending_handoffs = still
        return out

    # -- hedging -----------------------------------------------------------

    def _hedge_threshold(self, gid: int) -> Optional[float]:
        """The hedge age for this request: the scalar config, or — when
        ``hedge_after_s`` is a class-indexed map — the
        request's SLO-class entry (None = that class never hedges)."""
        if not isinstance(self._hedge_after_s, dict):
            return self._hedge_after_s
        req = self._requests.get(gid)
        return self._hedge_after_s.get(
            int(getattr(req, "priority", 0)) if req is not None else 0
        )

    def _maybe_hedge(self, now: float) -> None:
        if self._hedge_after_s is None:
            return
        for gid in self.ledger.open_ids():
            if self._disagg and gid in self._handoff_done:
                # past the handoff: a hedge would re-run the PREFILL
                # (the ring is the prefill subset) whose duplicate emit
                # is dropped — pure waste. Prefill-side stragglers
                # (not yet handed off) still hedge normally.
                continue
            entry = self.ledger.entries[gid]
            live = self._live_dispatches(entry)
            if len(live) != 1:
                continue  # already hedged (or being resolved)
            rep_i, _local = live[0]
            rep = self._replicas[rep_i]
            if rep.state != SUSPECT:
                continue
            threshold = self._hedge_threshold(gid)
            if threshold is None:
                continue
            age = now - entry.dispatches[-1][3]
            if age < threshold:
                continue
            target = self._place(
                self._requests[gid], gid, kind="hedge",
                exclude={rep_i},
            )
            if target is not None:
                self._record("hedge", gid=gid, frm=rep_i,
                             to=target.index)

    # -- chaos -------------------------------------------------------------

    def _chaos_killed(self, rep: _Replica) -> bool:
        if self._chaos is None or not getattr(self._chaos, "kills", False):
            return False
        from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import replica_killed

        return replica_killed(
            self._chaos, rep.index, rep.progress_signature()[0]
        )

    def _chaos_stalled(self, rep: _Replica) -> bool:
        if self._chaos is None or not getattr(self._chaos, "stalls", False):
            return False
        from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import (
            replica_stall_pending,
        )

        return replica_stall_pending(
            self._chaos, rep.index, rep.progress_signature()[0],
            rep.stall_skips,
        )

    # -- observability / receipts -----------------------------------------

    def _record(self, kind: str, **fields: Any) -> None:
        if self._flight is not None:
            self._flight.record(kind, **fields)

    def router_stats(self) -> Dict[str, Any]:
        """The fleet part of the receipt. Config fields (``n_replicas``,
        ``hedge``, ``affinity``) tell fleet rounds from single-engine ones, so
        fleet and single-engine rounds never gate each other; the
        health/ledger counters are OUTCOMES and deliberately stay out of
        the fingerprint, mirroring the chaos precedent."""
        states = self.replica_states()
        roles = [r.role for r in self._replicas]
        if isinstance(self._hedge_after_s, dict):
            # class-indexed hedging: serialized as a stable
            # "class:seconds" string so the fingerprint stays hashable
            hedge: Any = ",".join(
                f"{k}:{v}" for k, v in sorted(self._hedge_after_s.items())
            )
        else:
            hedge = float(self._hedge_after_s or 0.0)
        return {
            "n_replicas": self.n_replicas,
            "hedge": hedge,
            "class_deadline_s": ",".join(
                f"{k}:{v}"
                for k, v in sorted((self._class_deadline_s or {}).items())
            ),
            "affinity": self._affinity_depth,
            # disaggregation geometry: config, fingerprinted
            # 0/0 = monolithic fleet
            "n_prefill_replicas": roles.count("prefill"),
            "n_decode_replicas": roles.count("decode"),
            "handoffs_moved": self.n_handoffs_moved,
            "replicas_dead": states.count(DEAD),
            "replicas_draining": states.count(DRAINING),
            "requests_accepted": len(self.ledger.entries),
            "redispatched": self.ledger.n_redispatched,
            "hedged": self.ledger.n_hedged,
            "absorbed": self.ledger.n_absorbed,
            "replica_dead_completions": self.n_dead_completions,
            "queue_spillovers": self.n_spillovers,
            "probes": self.n_probes,
            "health_transitions": self.n_health_transitions,
        }

    # Engine-stats keys that describe CONFIGURATION (identical across a
    # homogeneous fleet): the merge passes the first replica's value
    # through. Everything else numeric is a traffic counter and SUMS —
    # equality across replicas must not suppress the sum (two replicas
    # that each served 4 requests served 8).
    _CONFIG_STAT_KEYS = frozenset({
        "prefix_cache", "speculative", "spec_k", "spec_ngram",
        "adapters", "n_adapters", "lora_rank", "deadline_s",
        "guard_nonfinite", "chaos", "flight", "pipeline_depth",
        "prefill_chunk",
        # sharded serving: identical across a homogeneous
        # fleet (one mesh geometry, one compiled program set) — summing
        # tp sizes or and-ing audit booleans would both lie
        "tp", "mesh_shape", "tp_collectives", "tp_hlo_ok",
        # disaggregation: per-engine role is a string (the
        # first replica's passes through — a heterogeneous fleet's
        # geometry lives in router_stats' n_prefill/n_decode_replicas);
        # the handoff counters below it stay counters and SUM
        "role",
        # SLO tiers: class count and the preemption flag are
        # engine geometry (identical across a homogeneous fleet); the
        # swap counters stay counters and SUM
        "priority_classes", "preemption",
    })
    # Derived ratios: recomputed or dropped rather than summed.
    _RATIO_STAT_KEYS = frozenset({
        "prefix_hit_rate", "spec_mean_accepted_len",
        "spec_acceptance_rate",
    })

    def stats(self, *parts: str) -> Dict[str, Any]:
        """One merged fleet receipt over ``router_stats`` + every
        replica's ``stats(parts)``: config keys pass through, traffic
        counters SUM, derived ratios are dropped (a mean of means
        lies), and flight keys are recomputed from the bucket-wise
        MERGED histograms via :meth:`fleet_flight_summary` (summing a
        p95 across replicas would be meaningless)."""
        out = self.router_stats()
        per: List[dict] = []
        for rep in self._replicas:
            fn = getattr(rep.engine, "stats", None)
            if fn is not None:
                per.append(dict(fn(*parts)))
        flight = self.fleet_flight_summary()
        sentry = self.fleet_sentry_summary()
        merged: Dict[str, Any] = {}
        for d in per:
            for k, v in d.items():
                if k in self._RATIO_STAT_KEYS:
                    continue
                if flight is not None and k.startswith((
                    "flight", "ttft_", "e2e_", "queue_wait_",
                    "chain_util_", "chain_overlap_", "preempt_wait_",
                )):
                    continue  # superseded by the histogram merge
                if sentry is not None and k.startswith("sentry"):
                    # superseded by the identity-deduped sentry merge:
                    # a fleet typically shares ONE sentry, and summing
                    # the same counters once per replica would
                    # N-multiply every fleet-global count
                    continue
                if k not in merged:
                    merged[k] = v
                elif k not in self._CONFIG_STAT_KEYS and isinstance(
                    v, (int, float)
                ) and isinstance(merged[k], (int, float)):
                    merged[k] = merged[k] + v
        out.update(merged)
        if flight is not None:
            out.update(flight)
        if sentry is not None:
            out.update(sentry)
        return out

    def fleet_sentry_summary(self) -> Optional[Dict[str, Any]]:
        """Contract-sentry aggregate across the fleet, or
        None when no replica carries one. Sentries dedupe by IDENTITY:
        the normal deployment shares one sentry (one process, one
        fetch wrapper, one compile listener) across every
        replica, so its summary is already fleet-global; distinct
        sentries sum counters, and ``sentry_fetch_budget_ok`` is
        re-derived from the summed violations (and-ing per-replica
        booleans via addition would lie)."""
        seen: Dict[int, Any] = {}
        for rep in self._replicas:
            s = getattr(rep.engine, "_sentry", None)
            if s is not None and id(s) not in seen:
                seen[id(s)] = s
        if not seen:
            return None
        sentries = list(seen.values())
        out: Dict[str, Any] = dict(sentries[0].summary())
        for s in sentries[1:]:
            for k, v in s.summary().items():
                if k in out and isinstance(v, (int, float)) and isinstance(
                    out[k], (int, float)
                ):
                    out[k] = out[k] + v
                else:
                    out.setdefault(k, v)
        out["sentry"] = 1
        out["sentry_fetch_budget_ok"] = int(
            out.get("sentry_budget_violations", 0) == 0
        )
        return out

    def _tagged_snapshots(self) -> List[Tuple[Any, dict]]:
        tagged: List[Tuple[Any, dict]] = []
        if self._flight is not None:
            tagged.append(("router", self._flight.snapshot()))
        for rep in self._replicas:
            rec = getattr(rep.engine, "_flight", None)
            if rec is None:
                rec = getattr(rep.engine, "flight", None)
            if rec is not None and hasattr(rec, "snapshot"):
                tagged.append((rep.index, rec.snapshot()))
        return tagged

    def fleet_flight_summary(self) -> Optional[Dict[str, Any]]:
        """Receipt-grade flight aggregate across the fleet, or None when
        no recorder is attached anywhere. Percentiles come from the
        MERGED histograms — mergeability is why LogHistogram exists."""
        from pytorch_distributed_training_tutorials_tpu_torch.obs.flight import summarize_merged

        tagged = self._tagged_snapshots()
        if not tagged:
            return None
        return summarize_merged([snap for _, snap in tagged])

    def _gid_map(self) -> Dict[Tuple[Any, Any], int]:
        """(replica index, local request id) -> global id, re-derived
        from the ledger's dispatch records — the same rows
        :meth:`DispatchLedger.verify` proves exactly-once over. Hedged
        / re-dispatched gids map from EVERY replica that held them, so
        a journey shows both sides of a failover."""
        m: Dict[Tuple[Any, Any], int] = {}
        for gid, entry in self.ledger.entries.items():
            for replica, local, _kind, _t in entry.dispatches:
                m[(replica, local)] = gid
        return m

    def fleet_snapshot(self, reason: str = "fleet") -> Optional[dict]:
        """One merged ``graft-flightlog/v1`` snapshot over the router's
        and every replica's recorder: events tagged ``replica=i`` (the
        router's as ``replica="router"``), interleaved by timestamp —
        pass the same ``t0`` to every recorder or the interleaving is
        per-recorder-relative. ``scripts/flight_view.py`` renders it.

        Journey stitching: replica-local events and spans
        that carry a ``rid`` gain the request's GLOBAL ``gid`` (from
        the ledger's dispatch records), so one request's journey —
        submit -> prefill replica -> ``handoff_move`` -> decode-replica
        ``handoff_accept`` -> chains -> complete — is one
        ``gid=``-filtered slice of the merged timeline
        (``scripts/flight_view.py --journey GID`` renders it)."""
        from pytorch_distributed_training_tutorials_tpu_torch.obs.flight import merge_snapshots

        tagged = self._tagged_snapshots()
        if not tagged:
            return None
        snap = merge_snapshots(tagged, reason=reason)
        gid_map = self._gid_map()
        for ev in snap["events"]:
            if "gid" in ev:
                continue  # router events (handoff_move ...) name gids
            key = (ev.get("replica"), ev.get("rid"))
            if ev.get("rid") is not None and key in gid_map:
                ev["gid"] = gid_map[key]
        for span in snap["live_spans"] + snap["done_spans"]:
            key = (span.get("replica"), span.get("rid"))
            if "gid" not in span and key in gid_map:
                span["gid"] = gid_map[key]
        return snap

    def dump_fleet(self, path: str, reason: str = "fleet") -> Optional[dict]:
        """Append the merged fleet snapshot to ``path`` (JSONL)."""
        import json

        snap = self.fleet_snapshot(reason=reason)
        if snap is not None:
            with open(path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        return snap
