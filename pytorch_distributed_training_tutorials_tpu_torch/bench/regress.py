"""Receipt-trajectory regression gate: compare rounds, fail on decay
(port of the JAX package's ``bench/regress.py``).

Load every receipt, key it by (kind, device, measurement config), order
each key's receipts by round (the ``_rNN`` filename convention), and exit
nonzero when the newest round's throughput or MFU falls more than
``--tolerance`` below the best earlier round, or its p95 latency rises
more than ``--tolerance`` above the lowest earlier one.

- HIGHER-IS-BETTER rate metrics are gated (the tok/s families, MFU, and
  the bench headline's ``value`` when its ``unit`` is a rate), and the
  LOWER-IS-BETTER p95 latencies (:data:`LATENCY_METRICS`); p50s and
  wall-clock fields stay informational;
- receipts compare only within an identical measurement config (the
  :data:`CONFIG_FIELDS` fingerprint) AND on the same device: the key
  carries the receipt's device — the port's stamp's ``backend``,
  ``device_name`` and ``nvidia_smi`` (a card's name and power limit),
  and ``"tpu"`` for a receipt of the JAX package (a ``jax_version``
  stamp) or a legacy one. The repo's root holds the JAX era's TPU
  receipts (``BENCH_r0*.json``, ``SERVING_r0*.json``, ...), whose
  fingerprints can equal a card receipt's: no TPU round ever gates, or is
  gated by, a card round;
- legacy (pre-schema) receipts participate: their kind comes from the
  filename prefix and their payload is validated by
  :func:`..obs.receipt.validate_receipt`'s legacy mode.

Run: ``python -m pytorch_distributed_training_tutorials_tpu_torch.bench.regress
[paths...] [--tolerance 0.05] [--json]``. No paths: every ``*.json`` at
the repo root. Host code: it reads files and touches no device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

from pytorch_distributed_training_tutorials_tpu_torch.obs.receipt import (
    load_receipt,
    validate_receipt,
)

# gated metrics: higher is better; "value" only when the unit is a rate
RATE_METRICS = (
    "tokens_per_s",
    "decode_tok_per_s",
    "server_tok_per_s",
    "tok_per_s",
    "mfu",
)

# gated metrics: LOWER is better. p95 tails come from the flight
# recorder's streaming histograms, whose bucket geometry sets their
# resolution; p50s stay informational
LATENCY_METRICS = (
    "server_p95_latency_s",
    "server_ttft_p95_s",
    "ttft_p95_s",
    "e2e_p95_s",
)

# payload fields that identify WHAT was measured — receipts compare only
# within an identical fingerprint. Outcomes of the traffic (acceptance
# rates, fault and swap counters, occupancy) stay out: they are results,
# not configuration
CONFIG_FIELDS = (
    "metric", "unit", "workload", "preset", "batch", "per_device_batch",
    "seq", "prompt_len", "new_tokens", "max_seq_len", "kv_cache_dtype",
    "tp", "scan_layers", "attn", "n_chips", "n_devices", "temperature",
    "flash_prefill", "prefix_overlap",
    # speculative decoding: k and the draft n-gram order
    "spec_k", "spec_ngram", "speculative",
    # multi-tenant LoRA: the bank's geometry
    "n_adapters", "lora_rank", "adapters",
    # robustness: fault injection, deadlines, the finite-logits guard
    "chaos", "deadline_s", "guard_nonfinite",
    # the flight recorder's bookkeeping in the request loop
    "flight",
    # request-loop pipelining and chunked prefill
    "pipeline_depth", "prefill_chunk",
    # the fleet router: replicas, hedging, affinity, offered load
    "n_replicas", "hedge", "affinity", "qps",
    # the paged KV cache's geometry
    "paged", "page_size", "pool_pages",
    # the paged-attention read path and the KV storage width
    "kv_bits", "paged_kernel",
    # sharded serving's mesh geometry at equal tp
    "mesh_shape",
    # prefill/decode roles and the fleet's role geometry
    "role", "n_prefill_replicas", "n_decode_replicas",
    # the contract sentry's instrumentation
    "sentry",
    # SLO tiers: the class count and preemption
    "priority_classes", "preemption",
)

_ROUND_RE = re.compile(r"_r(\d+)")


def _payload(obj: dict) -> dict:
    """The measurement dict: the JAX ``bench.py``'s min-of-N wrapper nests
    it under ``parsed`` (the checked-in ``BENCH_r0*.json`` shape);
    everything else is already flat."""
    parsed = obj.get("parsed")
    if isinstance(parsed, dict):
        return {**obj, **parsed}
    return obj


def _kind(obj: dict, path: str) -> str:
    """Schema'd receipts carry ``kind``; legacy ones are keyed by the
    filename family (``SERVING_r04_long.json`` -> ``serving``)."""
    if isinstance(obj.get("kind"), str):
        return obj["kind"]
    stem = os.path.basename(path)
    return stem.split("_")[0].split(".")[0].lower()


def _device(obj: dict) -> str:
    """What ran the measurement: ``backend:device_name|nvidia_smi`` from
    the port's stamp, ``"tpu"`` for a JAX-package or legacy receipt."""
    env = obj.get("env")
    if not isinstance(env, dict) or "jax_version" in env or "torch_version" not in env:
        return "tpu"
    return f"{env.get('backend')}:{env.get('device_name')}|{env.get('nvidia_smi')}"


def _round(path: str) -> int:
    """Round number from the ``_rNN`` filename convention; -1 when the
    file carries none (sorts before every numbered round)."""
    m = _ROUND_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else -1


def _metrics(payload: dict) -> dict[str, float]:
    out = {}
    for name in RATE_METRICS + LATENCY_METRICS:
        v = payload.get(name)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[name] = float(v)
    v, unit = payload.get("value"), payload.get("unit")
    if (isinstance(v, (int, float)) and not isinstance(v, bool)
            and isinstance(unit, str) and "/s" in unit):
        out[f"value[{unit}]"] = float(v)
    return out


def _lower_is_better(name: str) -> bool:
    return name in LATENCY_METRICS


def _config_key(payload: dict) -> tuple:
    return tuple((f, repr(payload[f])) for f in CONFIG_FIELDS if f in payload)


def collect(paths: list[str]) -> tuple[dict, list[str]]:
    """Load and validate receipts; group by (kind, device, config
    fingerprint).

    Returns ``(groups, skipped)``: ``groups`` maps the key to the
    round-ordered list of ``{path, round, metrics}`` records (files
    without any gated metric are dropped); ``skipped`` names files that
    failed validation, for the report."""
    groups: dict[tuple, list[dict]] = {}
    skipped: list[str] = []
    for path in paths:
        try:
            obj = load_receipt(path)
        except (OSError, json.JSONDecodeError):
            skipped.append(f"{path}: unreadable/not JSON")
            continue
        problems = validate_receipt(obj)
        if problems:
            skipped.append(f"{path}: {problems[0]}")
            continue
        payload = _payload(obj)
        metrics = _metrics(payload)
        if not metrics:
            continue  # a valid receipt with nothing this gate watches
        key = (_kind(obj, path), _device(obj), _config_key(payload))
        groups.setdefault(key, []).append(
            {"path": path, "round": _round(path), "metrics": metrics})
    for recs in groups.values():
        recs.sort(key=lambda r: (r["round"], r["path"]))
    return groups, skipped


def check(groups: dict, tolerance: float) -> list[dict]:
    """Regressions: for every key and metric with >= 2 rounds, the LATEST
    round must reach ``(1 - tolerance) *`` the best earlier round — or,
    for the lower-is-better latency tails, stay within ``(1 + tolerance)
    *`` the best (lowest) earlier round."""
    regressions = []
    for (kind, device, cfg), recs in groups.items():
        if len(recs) < 2:
            continue
        latest = recs[-1]
        for name, value in latest["metrics"].items():
            earlier = [r["metrics"][name] for r in recs[:-1] if name in r["metrics"]]
            if not earlier:
                continue
            if _lower_is_better(name):
                best = min(earlier)
                bad = value > best * (1.0 + tolerance)
                drop = value / best - 1.0 if best > 0 else 0.0
            else:
                best = max(earlier)
                bad = value < best * (1.0 - tolerance)
                drop = 1.0 - value / best
            if bad:
                regressions.append({
                    "kind": kind,
                    "device": device,
                    "config": dict(cfg),
                    "metric": name,
                    "direction": "lower" if _lower_is_better(name) else "higher",
                    "best_earlier": best,
                    "latest": value,
                    "latest_path": latest["path"],
                    "drop": drop,
                })
    return regressions


def _print_table(groups: dict, regressions: list[dict]) -> None:
    bad = {(r["kind"], r["device"], r["metric"], r["latest_path"]) for r in regressions}
    for (kind, device, cfg), recs in sorted(groups.items(), key=str):
        desc = " ".join(f"{k}={v}" for k, v in cfg) or "(no config fields)"
        print(f"{kind} [{device}]  {desc}")
        for name in sorted({n for r in recs for n in r["metrics"]}):
            traj = [(r["round"], r["metrics"][name], r["path"])
                    for r in recs if name in r["metrics"]]
            line = " -> ".join(f"r{rd:02d} {v:g}" if rd >= 0 else f"{v:g}" for rd, v, _ in traj)
            arrow = " (lower is better)" if _lower_is_better(name) else ""
            status = ""
            if len(traj) == 1:
                status = "  (single round)"
            elif (kind, device, name, traj[-1][2]) in bad:
                status = "  REGRESSION"
            print(f"  {name}{arrow}: {line}{status}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="fail when the newest receipt round regresses")
    ap.add_argument("paths", nargs="*",
                    help="receipt files or directories (default: repo root)")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="allowed fractional drop vs best earlier round")
    ap.add_argument("--json", action="store_true", help="machine-readable report on stdout")
    args = ap.parse_args(argv)
    if not 0.0 <= args.tolerance < 1.0:
        print("--tolerance must be in [0, 1)", file=sys.stderr)
        return 2

    paths: list[str] = []
    roots = args.paths or [
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
    for p in roots:
        if os.path.isdir(p):
            paths.extend(sorted(glob.glob(os.path.join(p, "*.json"))))
        else:
            paths.append(p)

    groups, skipped = collect(paths)
    regressions = check(groups, args.tolerance)
    if args.json:
        print(json.dumps({
            "tolerance": args.tolerance,
            "n_files": len(paths),
            "n_groups": len(groups),
            "skipped": skipped,
            "regressions": regressions,
        }, indent=2, sort_keys=True))
    else:
        _print_table(groups, regressions)
        for s in skipped:
            print(f"skipped {s}")
        for r in regressions:
            cmp = ">" if r["direction"] == "lower" else "<"
            print(f"REGRESSION {r['kind']}.{r['metric']} [{r['device']}]: "
                  f"{r['latest']:g} {cmp} best {r['best_earlier']:g} "
                  f"({100 * r['drop']:+.1f}%, tolerance {100 * args.tolerance:.1f}%) "
                  f"[{r['latest_path']}]")
        print(f"{len(groups)} trajectories, {len(regressions)} regressions")
    return 1 if regressions else 0


if __name__ == "__main__":
    sys.exit(main())
