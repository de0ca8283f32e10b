"""``python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.receipt_session
--round N [--dry-run] [--only a,b] [--keep-going]``: the runbook of the
serving example's receipt arms, in one command.

The twin of the JAX package's ``scripts/receipt_session.py``, re-targeted
at the port's example (:mod:`..examples.serve_llm_int8`) and its LM bench
(:mod:`..bench.lm_headline`). Fourteen arms in order: the fused-tail LM
headline, then the serving arms — base first, so it pays the checkpoint's
write and every later arm reuses it through the shared ``--ckpt-dir`` —
prefix, spec, adapters, deadline, flight, pipeline, fleet, paged (a
4096-token window), paged_int4 (``--kv-bits 4 --paged-kernel``), tp,
disagg and slo. Outputs are ``SERVING_rNN_<arm>.json`` /
``TRAIN_LLM_rNN_fused.json`` in ``--out-dir``, so ``bench.regress`` keys
the arms apart. Every ``--server`` arm runs with the contract sentry on
(the example's default).

Standard library only: building and printing the plan (``--dry-run``)
needs no card; running the arms does.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

PKG = "pytorch_distributed_training_tutorials_tpu_torch"

ARM_NAMES = (
    "fused_mfu",   # bench.lm_headline --fused: the logits-free tail
    "base",        # --server: continuous-batching p50/p95 + tok/s
    "prefix",      # --prefix-overlap 0.7: splice TTFT
    "spec",        # --spec-k 4: n-gram speculation
    "adapters",    # --adapters 8: tenants at fixed memory
    "deadline",    # --deadline-s 2
    "flight",      # --flight-log: histogram tails
    "pipeline",    # --pipeline-depth 2 --prefill-chunk 512
    "fleet",       # --replicas 2 --qps 8: aggregate tok/s + ledger_ok
    "paged",       # --paged at a 4096 window: hbm_high_water_bytes
    "paged_int4",  # --kv-bits 4 --paged-kernel
    "tp",          # --tp 4: head-sharded decode
    "disagg",      # --disaggregate 1p2d
    "slo",         # --slo --qps 8: priority classes
)


def build_session(round_no: int, ckpt_dir: str, out_dir: str) -> list[tuple[str, list[str]]]:
    """The ordered ``[(arm, argv), ...]`` plan (a pure function of its
    inputs)."""
    rr = f"r{round_no:02d}"
    py = sys.executable

    def out(name: str) -> str:
        return os.path.join(out_dir, name)

    serve = [py, "-m", f"{PKG}.examples.serve_llm_int8", "--preset", "1b",
             "--ckpt_dir", ckpt_dir]

    def srv(name: str, *extra: str) -> tuple[str, list[str]]:
        return name, [*serve, "--server", *extra, "--json", out(f"SERVING_{rr}_{name}.json")]

    return [
        ("fused_mfu", [py, "-m", f"{PKG}.bench.lm_headline", "--fused", "--json",
                       out(f"TRAIN_LLM_{rr}_fused.json")]),
        srv("base"),
        srv("prefix", "--prefix-overlap", "0.7"),
        srv("spec", "--spec-k", "4"),
        srv("adapters", "--adapters", "8", "--lora-rank", "8"),
        srv("deadline", "--deadline-s", "2"),
        srv("flight", "--flight-log", out(f"FLIGHT_{rr}.jsonl")),
        srv("pipeline", "--pipeline-depth", "2", "--prefill-chunk", "512"),
        srv("fleet", "--replicas", "2", "--qps", "8"),
        srv("paged", "--max_seq_len", "4096", "--paged"),
        srv("paged_int4", "--max_seq_len", "4096", "--paged", "--kv-bits", "4",
            "--paged-kernel"),
        srv("tp", "--tp", "4"),
        srv("disagg", "--disaggregate", "1p2d", "--qps", "8"),
        srv("slo", "--slo", "--qps", "8"),
    ]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="run the serving example's receipt arms in sequence")
    ap.add_argument("--round", type=int, required=True, dest="round_no",
                    help="receipt round number (names the output files)")
    ap.add_argument("--ckpt-dir", dest="ckpt_dir",
                    default=os.path.join(tempfile.gettempdir(), "llm_int8_1b"),
                    help="the serving checkpoint every arm shares (written once)")
    ap.add_argument("--out-dir", dest="out_dir",
                    default=os.path.join(tempfile.gettempdir(), "receipts"),
                    help="where the receipts and the flight log land (default: a "
                         "directory under the temporary directory)")
    ap.add_argument("--only", default=None,
                    help="comma-separated arm subset (names: %s)" % ",".join(ARM_NAMES))
    ap.add_argument("--dry-run", action="store_true",
                    help="print the plan without running anything")
    ap.add_argument("--keep-going", action="store_true",
                    help="continue past a failed arm (default: stop)")
    args = ap.parse_args(argv)

    plan = build_session(args.round_no, args.ckpt_dir, args.out_dir)
    if args.only:
        want = [s.strip() for s in args.only.split(",") if s.strip()]
        unknown = sorted(set(want) - set(ARM_NAMES))
        if unknown:
            ap.error(f"unknown arm(s): {', '.join(unknown)}")
        plan = [(n, cmd) for n, cmd in plan if n in want]
    for name, cmd in plan:
        print(f"[{name}] {' '.join(cmd)}")
    if args.dry_run:
        return 0

    os.makedirs(args.out_dir, exist_ok=True)
    failures = []
    for name, cmd in plan:
        print(f"\n=== arm {name} ===", flush=True)
        t0 = time.monotonic()
        rc = subprocess.run(cmd).returncode
        dt = time.monotonic() - t0
        if rc == 0:
            print(f"=== arm {name}: ok in {dt:.0f}s ===", flush=True)
            continue
        print(f"=== arm {name}: FAILED (rc={rc}, {dt:.0f}s) ===", flush=True)
        failures.append(name)
        if not args.keep_going:
            break
    if failures:
        print(f"\nfailed arms: {', '.join(failures)}")
        return 1
    print(f"\nall {len(plan)} arm(s) complete; receipts in {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
