"""Serving flight recorder: request-lifecycle events, spans, fault dumps.
The port's own copy of the JAX package's ``obs/flight.py`` (standard
library only): the same event vocabulary, spans, histograms, summary keys
and the ``graft-flightlog/v1`` dump schema, so a dump from either package
validates and renders the same way.

The question it answers is "what was the engine doing when slot 3 went
nonfinite": the post-mortem the engine's quarantine, deadline and
isolation paths create and end-of-run counters cannot answer. Three
pieces, all host bookkeeping:

- **Event ring**: a bounded ``deque`` of typed, timestamped events
  (``EVENT_KINDS``) stamped at the boundaries the engine already touches
  (submit, refill, chain dispatch, sweep, completion). The ring forgets old
  events (``dropped`` counts them) but never blocks or grows.
- **Spans**: per-request lifecycle records (submit -> queue pop ->
  prefill or splice -> complete), kept apart from the ring so wraparound
  cannot corrupt a live request's span. Completed spans feed the
  histograms and roll into their own bounded deque.
- **Histograms**: :class:`.histogram.LogHistogram` streams for TTFT,
  end-to-end latency, queue wait, chain utilization and pipeline overlap.

Stamping an event costs a clock read and a deque append, never a device
sync, so an engine's host-sync budget is the same with a recorder as
without one.

Fault dumps: a fault-class event (nonfinite quarantine, deadline expiry,
prefill error, adapter eviction, a trainer skip or rollback) snapshots
the last events and the live spans as one schema'd JSON line, written to
``dump_path`` when one is set.
"""

from __future__ import annotations

import json
import time
from collections import Counter, deque
from typing import Any, Dict, List, Optional

from pytorch_distributed_training_tutorials_tpu_torch.obs.histogram import LogHistogram

FLIGHT_SCHEMA = "graft-flightlog/v1"

# The typed vocabulary; record() rejects anything else so a dump is
# machine-readable without a per-producer schema.
EVENT_KINDS = frozenset({
    "submit",            # request accepted by the scheduler
    "queue_pop",         # request left the queue for a slot
    "prefill",           # full prefill into a slot
    "splice",            # prefix-cache splice + suffix prefill
    "prefill_chunk",     # one mid-prompt chunk of a chunked prefill
    "chain_start",       # decode chain dispatched (occupancy recorded)
    "chain_end",         # chain's batched fetch landed (tokens recorded)
    "sweep",             # chain-boundary sweep completed requests
    "complete",          # request finished (any finish_reason)
    "fault",             # fault_stats-visible anomaly (slot-aware)
    "adapter_register",  # tenant row assigned
    "adapter_evict",     # tenant row freed
    "adapter_refresh",   # engine re-merged a moved bank version
    "step_skipped",      # trainer nonfinite skip (rides the batched fetch)
    "rollback",          # trainer loss-spike rollback fired
    "stall",             # injected launch stall (utils/chaos.py)
    "replica_health",    # fleet router health transition
    "redispatch",        # router moved a request off a dead/draining replica
    "hedge",             # router duplicated a straggler onto a second replica
    "pool_shed",         # paged KV: submit rejected, request > whole pool
    "page_cow",          # paged KV: copy-on-write split of a shared page
    "handoff_emit",      # prefill-role engine finished a transferable prefill
    "handoff_move",      # router moved a KV segment to a decode replica
    "handoff_accept",    # decode-role engine spliced a handoff into a slot
    "compile",           # contract sentry: one compilation
    "budget_violation",  # contract sentry: round fetches exceeded budget
    "reupload",          # contract sentry: host-numpy leaves in a dispatch
    "preempt",           # SLO: active slot swapped out to host
    "resume",            # SLO: preempted request re-spliced into a slot
})

# Faults trigger an auto-dump when a dump_path is configured. The two
# sentry violation kinds ride the same path — a budget or
# re-upload violation IS a fault-class post-mortem; plain "compile"
# events stay out (warmup compiles are normal; the sentry dumps a
# POST-STEADY recompile explicitly, so warmup never floods the log).
_AUTO_DUMP_KINDS = frozenset({
    "fault", "step_skipped", "rollback", "budget_violation", "reupload",
})


class FlightRecorder:
    """Bounded request-lifecycle recorder for ServeEngine / Trainer.

    Parameters
    ----------
    capacity: event-ring size (old events drop, counted in ``dropped``).
    dump_path: when set, fault-class events append one
        ``graft-flightlog/v1`` JSONL snapshot here automatically;
        :meth:`dump` can also be called explicitly (end-of-run).
    dump_events: how many trailing events a snapshot carries.
    max_done_spans: completed-span retention (histograms already hold
        the aggregate; the deque is for post-mortem context only).
    t0: epoch for the relative timestamps (a ``time.perf_counter()``
        reading). Defaults to construction time; a FLEET passes ONE
        shared ``t0`` to every replica's recorder (and the router's) so
        :func:`merge_snapshots` can interleave their events on a common
        timeline — recorders with private epochs merge fine but sort
        per-recorder-relative.
    """

    def __init__(self, capacity: int = 1024,
                 dump_path: Optional[str] = None,
                 dump_events: int = 64,
                 max_done_spans: int = 256,
                 t0: Optional[float] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.dump_path = dump_path
        self.dump_events = int(dump_events)
        self.max_done_spans = int(max_done_spans)
        self._t0 = time.perf_counter() if t0 is None else float(t0)
        self.reset()

    @property
    def t0(self) -> float:
        return self._t0

    # -- lifecycle ---------------------------------------------------------

    def reset(self) -> None:
        """Forget everything (events, spans, histograms, counters) but
        keep configuration and the epoch ``t0`` — the examples' warmup
        phase resets the recorder alongside the engine counters so the
        receipt reflects only the timed stream."""
        self.events: deque = deque(maxlen=self.capacity)
        self.n_events = 0
        self.n_dumps = 0
        self.n_faults = 0
        self.kind_counts: Counter = Counter()
        self.spans: Dict[Any, dict] = {}
        self.done_spans: deque = deque(maxlen=self.max_done_spans)
        self.hist = {
            "ttft": LogHistogram(),
            "e2e": LogHistogram(),
            "queue_wait": LogHistogram(),
            # utilization is a ratio in (0, 1]; finer floor, tight cap
            "chain_util": LogHistogram(min_value=1e-3, max_value=4.0),
            # pipeline overlap is a ratio too: fraction of a chain's
            # dispatch->fetch span during which a LATER chain was
            # already dispatched (0 = serial loop; -> 1 = the whole
            # host roundtrip is hidden). 0.0 lands in the underflow
            # bucket, so the count still reflects every chain.
            "chain_overlap": LogHistogram(min_value=1e-3, max_value=4.0),
            # swap-out -> swap-in wall time of preempted requests
            # — the price a lower SLO class pays so a
            # higher class can hold its TTFT
            "preempt_wait": LogHistogram(),
        }
        # dispatch stamps of chains whose fetch has not landed yet,
        # keyed by the engine's chain sequence number — pipelined
        # engines keep several open at once
        self._open_chains: Dict[Any, float] = {}

    @property
    def dropped(self) -> int:
        """Events stamped but no longer in the ring (wraparound)."""
        return self.n_events - len(self.events)

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # -- generic intake ----------------------------------------------------

    def record(self, kind: str, **fields: Any) -> dict:
        """Stamp one typed event. Unknown kinds raise — the dump format
        is only machine-readable if the vocabulary is closed."""
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown flight event kind {kind!r}; "
                f"known: {sorted(EVENT_KINDS)}"
            )
        event = {"t": round(self._now(), 6), "kind": kind, **fields}
        self.events.append(event)
        self.n_events += 1
        self.kind_counts[kind] += 1
        if kind in _AUTO_DUMP_KINDS:
            self.n_faults += 1
            if self.dump_path is not None:
                self.dump(reason=kind, trigger=event)
        return event

    # -- request lifecycle (ServeEngine hooks) -----------------------------

    def request_submitted(self, rid: Any, p_len: int = 0,
                          max_new: int = 0, adapter: int = 0) -> None:
        t = self._now()
        self.record("submit", rid=rid, p_len=p_len, max_new=max_new,
                    adapter=adapter)
        # spans live OUTSIDE the ring: wraparound never corrupts them
        self.spans[rid] = {
            "rid": rid, "submit_t": t, "p_len": p_len, "max_new": max_new,
            "adapter": adapter,
        }

    def request_popped(self, rid: Any) -> None:
        t = self._now()
        self.record("queue_pop", rid=rid)
        span = self.spans.get(rid)
        if span is not None:
            span["queue_pop_t"] = t
            self.hist["queue_wait"].record(t - span["submit_t"])

    def request_prefilled(self, rid: Any, slot: int,
                          kind: str = "prefill",
                          cached_len: int = 0) -> None:
        """``kind`` is "prefill", "splice" (the prefix-cache path) or
        "handoff" (a decode-role engine accepting a transferred segment
        — the role engines' path; ``prefill_t`` still stamps here, the moment the
        request's first token exists on THIS engine)."""
        t = self._now()
        if kind == "splice":
            self.record("splice", rid=rid, slot=slot, cached_len=cached_len)
        elif kind == "handoff":
            self.record("handoff_accept", rid=rid, slot=slot)
        else:
            self.record("prefill", rid=rid, slot=slot)
        span = self.spans.get(rid)
        if span is not None:
            span["prefill_t"] = t
            span["slot"] = slot
            span["path"] = kind
            if cached_len:
                span["cached_len"] = cached_len

    def prefill_chunk(self, rid: Any, slot: int, done: int = 0,
                      total: int = 0) -> None:
        """One mid-prompt chunk of a chunked prefill dispatched (async
        only — the request's ``prefill_t`` still stamps at the FINAL
        chunk, when its first token exists). ``done``/``total`` give the
        prompt progress for the timeline view."""
        self.record("prefill_chunk", rid=rid, slot=slot, done=done,
                    total=total)
        span = self.spans.get(rid)
        if span is not None:
            span["chunks"] = span.get("chunks", 0) + 1

    def request_completed(self, rid: Any, finish_reason: str,
                          tokens: int = 0,
                          latency_s: Optional[float] = None,
                          ttft_s: Optional[float] = None) -> None:
        """Close a span. ``latency_s``/``ttft_s`` are the engine's own
        Completion numbers when available — recording THOSE (not a
        re-derived clock delta) keeps the histogram percentiles
        sample-identical to the sort-based ones they replace."""
        t = self._now()
        self.record("complete", rid=rid, finish_reason=finish_reason,
                    tokens=tokens)
        span = self.spans.pop(rid, None)
        if span is None:
            span = {"rid": rid, "submit_t": None}
        span["complete_t"] = t
        span["finish_reason"] = finish_reason
        span["tokens"] = tokens
        e2e = latency_s
        if e2e is None and span.get("submit_t") is not None:
            e2e = t - span["submit_t"]
        if e2e is not None:
            span["e2e_s"] = round(e2e, 6)
            self.hist["e2e"].record(e2e)
        if ttft_s is None and span.get("submit_t") is not None \
                and span.get("prefill_t") is not None:
            ttft_s = span["prefill_t"] - span["submit_t"]
        if ttft_s is not None:
            span["ttft_s"] = round(ttft_s, 6)
            self.hist["ttft"].record(ttft_s)
            if e2e is not None and tokens > 1 and e2e > ttft_s:
                span["decode_tok_per_s"] = round(
                    (tokens - 1) / (e2e - ttft_s), 3
                )
        self.done_spans.append(span)

    # -- engine-wide events ------------------------------------------------

    def chain_start(self, occupancy: int, n_slots: int,
                    chain: Optional[int] = None) -> None:
        """``chain`` is the engine's chain sequence number; when given,
        the dispatch stamp opens the chain for the overlap histogram
        (and rides the event, so flight_view can pair start/end of
        overlapped chains without reordering the timeline)."""
        fields: dict = {"occupancy": occupancy, "n_slots": n_slots}
        if chain is not None:
            fields["chain"] = chain
        ev = self.record("chain_start", **fields)
        if chain is not None:
            self._open_chains[chain] = ev["t"]
        if n_slots:
            self.hist["chain_util"].record(occupancy / n_slots)

    def chain_end(self, tokens: int, occupancy: int,
                  chain: Optional[int] = None) -> None:
        fields: dict = {"tokens": tokens, "occupancy": occupancy}
        if chain is not None:
            fields["chain"] = chain
        ev = self.record("chain_end", **fields)
        if chain is None:
            return
        start = self._open_chains.pop(chain, None)
        if start is None:
            return
        span = ev["t"] - start
        # overlap = fraction of this chain's dispatch->fetch span during
        # which a LATER chain was already in flight — the pipelining
        # receipt, straight from the stamps the engine already makes
        later = [
            t0 for c, t0 in self._open_chains.items()
            if c > chain and t0 < ev["t"]
        ]
        overlap = 0.0
        if span > 0 and later:
            overlap = min(1.0, max(0.0, (ev["t"] - min(later)) / span))
        self.hist["chain_overlap"].record(overlap)

    def sweep(self, completed: int) -> None:
        self.record("sweep", completed=completed)

    def preempted(self, rid: Any, slot: int = 0, position: int = 0,
                  tokens: int = 0) -> None:
        """An SLO preemption swapped ``rid`` out of ``slot`` to host
       : ``position`` is the sequence position parked,
        ``tokens`` the generated tokens kept. Host-only like every
        stamp — the swap's device fetch is counted by the ENGINE
        (n_swaps_out), not here."""
        self.record("preempt", rid=rid, slot=slot, position=position,
                    tokens=tokens)

    def resumed(self, rid: Any, slot: int = 0,
                wait_s: float = 0.0) -> None:
        """A preempted request re-spliced into ``slot``; ``wait_s`` is
        the swap-out -> swap-in wall time, fed to the preempted-wait
        histogram."""
        self.record("resume", rid=rid, slot=slot,
                    wait_s=round(float(wait_s), 6))
        self.hist["preempt_wait"].record(wait_s)

    def fault(self, fault_kind: str, **fields: Any) -> None:
        """A fault_stats-visible anomaly (nonfinite / deadline /
        prefill_error / adapter_evicted ...). Auto-dumps when a
        ``dump_path`` is configured."""
        self.record("fault", fault_kind=fault_kind, **fields)

    # -- trainer hooks -----------------------------------------------------

    def step_skipped(self, step: int) -> None:
        """A Trainer nonfinite skip became host-visible. This fires from
        MetricsLogger's existing batched drain — never per step."""
        self.record("step_skipped", step=step)

    def rollback(self, step: int, loss: float) -> None:
        self.record("rollback", step=step, loss=float(loss))

    # -- snapshots ---------------------------------------------------------

    def snapshot(self, reason: str = "manual",
                 trigger: Optional[dict] = None) -> dict:
        """The ``graft-flightlog/v1`` dump object: trailing events, live
        spans, recent completed spans, histogram state, counters."""
        return {
            "schema": FLIGHT_SCHEMA,
            "reason": reason,
            "t": round(self._now(), 6),
            "trigger": trigger,
            "events": list(self.events)[-self.dump_events:],
            "live_spans": [dict(s) for s in self.spans.values()],
            "done_spans": [dict(s) for s in self.done_spans],
            "histograms": {k: h.to_dict() for k, h in self.hist.items()},
            "counts": dict(self.kind_counts),
            "n_events": self.n_events,
            "dropped": self.dropped,
        }

    def dump(self, reason: str = "manual",
             trigger: Optional[dict] = None) -> dict:
        """Append one snapshot line to ``dump_path`` (JSONL) and return
        it. With no path configured the snapshot is still built and
        returned (the selftest asserts on it in-process)."""
        snap = self.snapshot(reason=reason, trigger=trigger)
        self.n_dumps += 1
        if self.dump_path is not None:
            with open(self.dump_path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        return snap

    # -- receipt surface ---------------------------------------------------

    def summary(self) -> dict:
        """Flat receipt-ready aggregate: recorder counters + the four
        histogram summaries (``ttft_p95_s``-style keys)."""
        out = {
            "flight": 1,
            "flight_events": self.n_events,
            "flight_dropped": self.dropped,
            "flight_faults": self.n_faults,
            "flight_dumps": self.n_dumps,
            "flight_spans_live": len(self.spans),
            "flight_spans_done": len(self.done_spans),
        }
        out.update(self.hist["ttft"].summary(prefix="ttft_", unit="s"))
        out.update(self.hist["e2e"].summary(prefix="e2e_", unit="s"))
        out.update(
            self.hist["queue_wait"].summary(prefix="queue_wait_", unit="s")
        )
        out.update(self.hist["chain_util"].summary(prefix="chain_util_"))
        out.update(
            self.hist["chain_overlap"].summary(prefix="chain_overlap_")
        )
        out.update(
            self.hist["preempt_wait"].summary(prefix="preempt_wait_",
                                              unit="s")
        )
        return {
            k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in out.items()
        }


# -- fleet merge (serve/router.py) ---------------------------------------

def _merged_histograms(snaps: List[dict]) -> Dict[str, LogHistogram]:
    """Bucket-wise merge of every snapshot's histogram states, keyed by
    name. All recorders build the same geometry per name, so
    :meth:`..obs.histogram.LogHistogram.merge` applies directly — the
    merged counts are EXACTLY what one recorder observing all the
    traffic would hold; this is the mergeability LogHistogram was built
    for."""
    hists: Dict[str, LogHistogram] = {}
    for snap in snaps:
        for name, state in snap.get("histograms", {}).items():
            h = LogHistogram.from_dict(state)
            if name in hists:
                hists[name].merge(h)
            else:
                hists[name] = h
    return hists


def merge_snapshots(tagged: List[tuple], reason: str = "fleet") -> dict:
    """Merge N recorders' snapshots into ONE ``graft-flightlog/v1``
    snapshot: events and spans gain a ``replica`` tag (the caller's —
    an int index or "router"), events interleave by timestamp (pass one
    shared ``t0`` to every recorder for a common timeline), counts and
    totals sum, histograms merge bucket-wise. The result validates and
    renders exactly like a single-recorder dump, so
    ``scripts/flight_view.py`` needs no fleet mode — only the
    ``replica=`` field and health annotations."""
    events: List[dict] = []
    live: List[dict] = []
    done: List[dict] = []
    counts: Counter = Counter()
    n_events = 0
    dropped = 0
    t = 0.0
    for tag, snap in tagged:
        validate_flightlog(snap)
        for ev in snap["events"]:
            merged_ev = dict(ev)
            merged_ev.setdefault("replica", tag)
            events.append(merged_ev)
        for span in snap["live_spans"]:
            live.append({**span, "replica": tag})
        for span in snap["done_spans"]:
            done.append({**span, "replica": tag})
        counts.update(snap.get("counts", {}))
        n_events += snap.get("n_events", 0)
        dropped += snap.get("dropped", 0)
        t = max(t, snap.get("t", 0.0))
    events.sort(key=lambda e: e.get("t", 0.0))
    hists = _merged_histograms([snap for _, snap in tagged])
    return {
        "schema": FLIGHT_SCHEMA,
        "reason": reason,
        "t": t,
        "trigger": None,
        "events": events,
        "live_spans": live,
        "done_spans": done,
        "histograms": {k: h.to_dict() for k, h in hists.items()},
        "counts": dict(counts),
        "n_events": n_events,
        "dropped": dropped,
    }


def summarize_merged(snaps: List[dict]) -> dict:
    """The receipt-grade aggregate over N snapshots — same keys as
    :meth:`FlightRecorder.summary` so a fleet receipt drops into the
    slots a single-engine receipt used, but the percentile fields come
    from the MERGED histograms (averaging or summing per-replica p95s
    would be statistically meaningless)."""
    hists = _merged_histograms(snaps)
    out = {
        "flight": 1,
        "flight_events": sum(s.get("n_events", 0) for s in snaps),
        "flight_dropped": sum(s.get("dropped", 0) for s in snaps),
        "flight_faults": sum(
            s.get("counts", {}).get(k, 0)
            for s in snaps for k in _AUTO_DUMP_KINDS
        ),
        "flight_spans_live": sum(len(s["live_spans"]) for s in snaps),
        "flight_spans_done": sum(len(s["done_spans"]) for s in snaps),
    }
    prefixes = {
        "ttft": ("ttft_", "s"), "e2e": ("e2e_", "s"),
        "queue_wait": ("queue_wait_", "s"),
        "chain_util": ("chain_util_", None),
        "chain_overlap": ("chain_overlap_", None),
        "preempt_wait": ("preempt_wait_", "s"),
    }
    for name, (prefix, unit) in prefixes.items():
        h = hists.get(name)
        if h is None:
            continue
        if unit is None:
            out.update(h.summary(prefix=prefix))
        else:
            out.update(h.summary(prefix=prefix, unit=unit))
    return {
        k: (round(v, 6) if isinstance(v, float) else v)
        for k, v in out.items()
    }


# -- dump-file tooling (scripts/flight_view.py + tests) --------------------

def validate_flightlog(obj: dict) -> None:
    """Raise ValueError unless ``obj`` is a well-formed flight snapshot."""
    if not isinstance(obj, dict):
        raise ValueError("flightlog snapshot must be a dict")
    if obj.get("schema") != FLIGHT_SCHEMA:
        raise ValueError(
            f"schema mismatch: {obj.get('schema')!r} != {FLIGHT_SCHEMA!r}"
        )
    for key in ("reason", "t", "events", "live_spans", "done_spans",
                "histograms", "counts"):
        if key not in obj:
            raise ValueError(f"flightlog snapshot missing key {key!r}")
    for ev in obj["events"]:
        if ev.get("kind") not in EVENT_KINDS:
            raise ValueError(
                f"flightlog event has unknown kind {ev.get('kind')!r}"
            )


def load_flightlog(path: str) -> List[dict]:
    """Read + validate every snapshot line of a JSONL flight log."""
    snaps = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            validate_flightlog(obj)
            snaps.append(obj)
    return snaps
