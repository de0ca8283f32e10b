"""``python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.flight_view
PATH [--events N] [--snapshot I] [--journey GID]``: a ``graft-flightlog/v1``
dump as a human-readable timeline (port of the JAX package's
``scripts/flight_view.py``).

The flight recorder (:mod:`..obs.flight`) answers "what was the engine
doing when slot 3 went nonfinite", but its dumps are JSONL snapshots meant
for machines. This is the human half: point it at a recorder's
``dump_path`` file (the auto-dumps of a chaos run, a sentry's violations,
a fleet's merged snapshot) and it prints, per snapshot, a monotonic event
timeline (relative timestamps, one line per event, the trigger marked),
the live and completed request spans with their queue-wait / TTFT /
decode splits, and the histogram summaries. Host code only: a post-mortem
viewer runs on any machine the dump was copied to, no card needed.

    python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.flight_view flight.jsonl
    python -m ...scripts.flight_view flight.jsonl --events 200 --snapshot -1
    python -m ...scripts.flight_view fleet.jsonl --journey 7
"""

from __future__ import annotations

import argparse
import sys

from pytorch_distributed_training_tutorials_tpu_torch.obs.flight import load_flightlog
from pytorch_distributed_training_tutorials_tpu_torch.obs.histogram import LogHistogram


def _fmt_event(ev: dict, trigger: dict | None, note: str = "") -> str:
    t = ev.get("t", 0.0)
    kind = ev.get("kind", "?")
    rest = ", ".join(
        f"{k}={v}" for k, v in ev.items() if k not in ("t", "kind")
    )
    mark = " <-- trigger" if trigger is not None and ev == trigger else ""
    return f"  {t:>12.6f}s  {kind:<16s} {rest}{note}{mark}"


def _chain_annotations(events: list[dict]) -> dict[int, str]:
    """Pipelined engines interleave chain_start/chain_end lines (chain
    i+1 dispatches before chain i's fetch lands). The timeline stays in
    stamp order — the overlap is real, not a rendering artifact — and
    this pre-pass makes it legible: each chain_end is annotated with the
    LATER chains still in flight at that moment. Keyed by event object
    id (events are not hashable)."""
    open_chains: set = set()
    notes: dict[int, str] = {}
    for ev in events:
        c = ev.get("chain")
        if c is None:
            continue
        # fleet dumps (merge_snapshots) interleave chains from N
        # replicas whose counters collide — scope by the replica tag so
        # replica 1's chain 3 never reads as in flight over replica 0's
        rep = ev.get("replica")
        if ev.get("kind") == "chain_start":
            open_chains.add((rep, c))
        elif ev.get("kind") == "chain_end":
            open_chains.discard((rep, c))
            later = sorted(x for r, x in open_chains if r == rep and x > c)
            if later:
                notes[id(ev)] = " [in flight: chain " + ", ".join(
                    str(x) for x in later
                ) + "]"
    return notes


def _health_annotations(events: list[dict]) -> dict[int, str]:
    """A replica dying (or entering its drain) is the most load-bearing
    line on a fleet timeline: flag the router's terminal
    ``replica_health`` transitions inline so they stand out of the
    interleaved per-replica traffic without a separate fleet mode."""
    notes: dict[int, str] = {}
    for ev in events:
        if ev.get("kind") != "replica_health":
            continue
        to = ev.get("to")
        if to in ("dead", "draining"):
            notes[id(ev)] = f" [{to}]"
    return notes


def _pool_annotations(events: list[dict]) -> dict[int, str]:
    """Paged-KV pool pressure is rare and load-bearing on a timeline: a
    ``pool_shed`` is backpressure the caller felt (submit rejected — the
    request wanted more pages than the whole pool holds) and a
    ``page_cow`` is a shared prefix page being split on its first
    divergent write. Flag both inline, like the health transitions, so
    they stand out of the per-chain traffic."""
    notes: dict[int, str] = {}
    for ev in events:
        kind = ev.get("kind")
        if kind == "pool_shed":
            notes[id(ev)] = (
                f" [pool exhausted: wanted {ev.get('pages', '?')} pages]"
            )
        elif kind == "page_cow":
            notes[id(ev)] = (
                f" [shared page {ev.get('src', '?')} split -> "
                f"{ev.get('dst', '?')}]"
            )
    return notes


def _sentry_annotations(events: list[dict]) -> dict[int, str]:
    """Contract-sentry lines: a post-steady recompile (on the port, a
    native library loaded after the steady mark), an over-budget round and
    a re-upload are the contract breaks the sentry exists to announce —
    flag them inline like the health transitions. Warmup loads render
    unannotated (they are normal; the label/ms already ride the event
    fields)."""
    notes: dict[int, str] = {}
    for ev in events:
        kind = ev.get("kind")
        if kind == "compile" and ev.get("steady"):
            notes[id(ev)] = (
                f" [recompile: {ev.get('label', '?')} "
                f"{ev.get('ms', 0)} ms]"
            )
        elif kind == "budget_violation":
            notes[id(ev)] = (
                f" [fetch over budget: {ev.get('fetched', '?')} > "
                f"{ev.get('budgeted', '?')}]"
            )
        elif kind == "reupload":
            notes[id(ev)] = (
                f" [re-upload: {ev.get('bytes', '?')} B at "
                f"{ev.get('label', '?')}]"
            )
    return notes


def _slo_annotations(events: list[dict]) -> dict[int, str]:
    """SLO-tier preemption lines: a ``preempt`` is a
    lower-class slot's KV swapping out to host to make room for a
    higher-class waiter, and the matching ``resume`` is its swap-in
    re-splice. Both are rare and load-bearing on a mixed-class
    timeline — flag them inline like the health transitions, with the
    park position (how far decoding got) and the measured wait."""
    notes: dict[int, str] = {}
    for ev in events:
        kind = ev.get("kind")
        if kind == "preempt":
            notes[id(ev)] = (
                f" [preempted: slot {ev.get('slot', '?')} parked at "
                f"position {ev.get('position', '?')}]"
            )
        elif kind == "resume":
            notes[id(ev)] = (
                f" [resumed after {ev.get('wait_s', '?')}s swapped out]"
            )
    return notes


def _journey_filter(snap: dict, gid: int) -> dict:
    """Cut a merged fleet snapshot down to ONE request's cross-replica
    journey: events and spans the router's gid stitching
    tagged (``FleetRouter.fleet_snapshot``) — submit on the prefill
    replica, ``handoff_move`` on the router, ``handoff_accept`` +
    chains on the decode replica, complete. Histograms are fleet-wide
    aggregates and are dropped; counts re-derive from the kept events."""
    events = [ev for ev in snap.get("events", []) if ev.get("gid") == gid]
    live = [s for s in snap.get("live_spans", []) if s.get("gid") == gid]
    done = [s for s in snap.get("done_spans", []) if s.get("gid") == gid]
    counts: dict[str, int] = {}
    for ev in events:
        counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
    return {
        **snap,
        "reason": f"journey gid={gid} (of {snap.get('reason')!r})",
        "events": events,
        "live_spans": live,
        "done_spans": done,
        "histograms": {},
        "counts": counts,
        "n_events": len(events),
        "dropped": 0,
    }


def _fmt_span(span: dict) -> str:
    rid = span.get("rid", "?")
    # fleet dumps tag every span with its replica; local rids collide
    # across replicas, so the tag is what disambiguates "request 3"
    if "replica" in span:
        parts = [f"  replica {span['replica']} request {rid}:"]
    else:
        parts = [f"  request {rid}:"]
    submit = span.get("submit_t")
    if submit is not None:
        if "queue_pop_t" in span:
            parts.append(f"queue {span['queue_pop_t'] - submit:.4f}s")
        if "ttft_s" in span:
            parts.append(f"ttft {span['ttft_s']:.4f}s")
        elif "prefill_t" in span:
            parts.append(f"prefill at +{span['prefill_t'] - submit:.4f}s")
    if "e2e_s" in span:
        parts.append(f"e2e {span['e2e_s']:.4f}s")
    if "tokens" in span:
        parts.append(f"{span['tokens']} tokens")
    if "decode_tok_per_s" in span:
        parts.append(f"{span['decode_tok_per_s']} tok/s")
    if "slot" in span:
        parts.append(f"slot {span['slot']}")
    if "path" in span:
        parts.append(span["path"])
    if "finish_reason" in span:
        parts.append(f"-> {span['finish_reason']}")
    return " ".join(parts)


def render(snap: dict, index: int, max_events: int) -> None:
    print(
        f"=== snapshot {index}: reason={snap['reason']!r} "
        f"t={snap['t']:.3f}s  ({snap['n_events']} events total, "
        f"{snap.get('dropped', 0)} dropped from the ring) ==="
    )
    counts = snap.get("counts", {})
    if counts:
        line = ", ".join(
            f"{k}: {v}" for k, v in sorted(counts.items())
        )
        print(f"event counts: {line}")
    trigger = snap.get("trigger")
    notes = _chain_annotations(snap["events"])
    notes.update(_health_annotations(snap["events"]))
    notes.update(_pool_annotations(snap["events"]))
    notes.update(_sentry_annotations(snap["events"]))
    notes.update(_slo_annotations(snap["events"]))
    print(f"\nevents (last {min(max_events, len(snap['events']))}):")
    for ev in snap["events"][-max_events:]:
        print(_fmt_event(ev, trigger, notes.get(id(ev), "")))
    if snap.get("live_spans"):
        print("\nlive requests at dump time:")
        for span in snap["live_spans"]:
            print(_fmt_span(span))
    if snap.get("done_spans"):
        print("\ncompleted requests (most recent last):")
        for span in snap["done_spans"]:
            print(_fmt_span(span))
    hists = snap.get("histograms", {})
    if hists:
        print("\nlatency histograms:")
        for name, state in sorted(hists.items()):
            h = LogHistogram.from_dict(state)
            if h.n == 0:
                continue
            print(
                f"  {name:<12s} n={h.n:<6d} mean={h.mean:.4f} "
                f"p50={h.quantile(0.5):.4f} p95={h.quantile(0.95):.4f} "
                f"p99={h.quantile(0.99):.4f}"
            )
    print()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="render graft-flightlog/v1 dumps as timelines"
    )
    ap.add_argument("path", help="JSONL flight log (one snapshot/line)")
    ap.add_argument(
        "--events", type=int, default=64,
        help="max events to print per snapshot (default 64)",
    )
    ap.add_argument(
        "--snapshot", type=int, default=None,
        help="render only this snapshot index (negative = from the "
        "end); default renders all",
    )
    ap.add_argument(
        "--journey", type=int, default=None, metavar="GID",
        help="render only ONE request's cross-replica journey: keep "
        "events/spans the fleet merge tagged with this global id "
        "(FleetRouter.fleet_snapshot's gid stitching)",
    )
    args = ap.parse_args(argv)
    snaps = load_flightlog(args.path)
    if not snaps:
        print(f"{args.path}: no snapshots")
        return 1
    if args.snapshot is not None:
        start = args.snapshot % len(snaps)
        snaps = [snaps[args.snapshot]]
    else:
        start = 0
    if args.journey is not None:
        snaps = [_journey_filter(s, args.journey) for s in snaps]
        snaps = [s for s in snaps if s["events"] or s["done_spans"]
                 or s["live_spans"]]
        if not snaps:
            print(f"{args.path}: no events tagged gid={args.journey} "
                  "(was the dump written by FleetRouter.fleet_snapshot?)")
            return 1
    for i, snap in enumerate(snaps):
        render(snap, start + i, args.events)
    return 0


if __name__ == "__main__":
    sys.exit(main())
