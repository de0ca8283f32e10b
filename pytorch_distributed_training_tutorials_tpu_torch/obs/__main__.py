"""``python -m pytorch_distributed_training_tutorials_tpu_torch.obs --selftest
[--json PATH] [--device cpu]``: end-to-end smoke of the port's
observability layer on a tiny workload (port of the JAX package's
``obs/__main__.py``).

The JAX selftest's five pillars, on the port:

1. a few epochs of ``LinearRegressor`` (mse) through the ``Trainer`` with a
   JSONL-sinked :class:`.MetricsLogger` (``log_every=2``): epoch and step
   events recorded, the sink's lines equal to the ring buffer;
2. :class:`.MinOfN` over a chain of eager train steps on one batch, each
   chain closed by one sync;
3. a real :func:`..utils.profiling.trace` of that chain, classified by
   :class:`.StepReport`: device time captured, at most 10% of it
   unclassified, the categories summing to the total;
4. the flight recorder and its histograms, the JAX selftest's leg on the
   same samples (``random.Random(7)``): a sharded merge equal to the
   whole, three quantiles within one bucket of the sorted sample, one
   lifecycle and a fault dumped to disk, loaded back and validated, a
   histogram's JSON round trip;
5. an ``obs_selftest`` receipt through the schema'd envelope, validated
   before it is reported.

Prints exactly one JSON line (the receipt) and exits 0, or 1 when a check
failed. Runs on ``cuda`` unless ``--device`` names another device; with
no GPU and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import shutil
import sys
import tempfile

STEPS = 4  # the traced and timed chain's length
UNCLASSIFIED_LIMIT = 0.10


def histogram_leg(problems: list) -> "LogHistogram":  # noqa: F821
    """Pillar 4's histograms: a heavy-tailed sample sharded over two
    recorders and merged, and three quantiles against the sorted sample.
    Returns the whole-sample histogram."""
    from pytorch_distributed_training_tutorials_tpu_torch.obs import LogHistogram

    rng = random.Random(7)
    samples = [rng.lognormvariate(-3.0, 1.5) for _ in range(4000)]
    whole = LogHistogram()
    sharded = [LogHistogram(), LogHistogram()]
    for i, v in enumerate(samples):
        whole.record(v)
        sharded[i % 2].record(v)
    merged = sharded[0].merge(sharded[1])
    if merged.counts != whole.counts or merged.n != whole.n:
        problems.append("sharded histogram merge != whole-sample record")
    svals = sorted(samples)
    for q in (0.5, 0.95, 0.99):
        exact = svals[max(1, math.ceil(q * len(svals))) - 1]
        if abs(whole.quantile(q) - exact) > whole.rel_error_bound * exact:
            problems.append(f"histogram q={q} off by more than one bucket: "
                            f"{whole.quantile(q)} vs exact {exact}")
    return whole


def flight_leg(workdir: str, whole, problems: list) -> dict:
    """Pillar 4's recorder: one lifecycle and a fault dumped to disk,
    loaded back and validated; the histogram's JSON round trip. Returns
    the recorder's summary."""
    from pytorch_distributed_training_tutorials_tpu_torch.obs import (
        FlightRecorder,
        LogHistogram,
        load_flightlog,
        validate_flightlog,
    )

    flight_path = os.path.join(workdir, "flight.jsonl")
    rec = FlightRecorder(capacity=32, dump_path=flight_path)
    rec.request_submitted(0, p_len=4, max_new=8)
    rec.request_popped(0)
    rec.request_prefilled(0, slot=1)
    rec.chain_start(1, 2)
    rec.chain_end(tokens=8, occupancy=1)
    rec.fault("nonfinite", rid=0, slot=1, chain_step=3)
    rec.request_completed(0, "nonfinite", tokens=3)
    try:
        snaps = load_flightlog(flight_path)
        for snap in snaps:
            validate_flightlog(snap)
        if len(snaps) != 1:
            problems.append(f"{len(snaps)} flight dumps, expected 1")
        elif snaps[0]["trigger"].get("slot") != 1:
            problems.append("flight dump trigger lost the faulty slot")
        hist_rt = LogHistogram.from_dict(json.loads(json.dumps(whole.to_dict())))
        if hist_rt.counts != whole.counts or hist_rt.quantile(0.95) != whole.quantile(0.95):
            problems.append("histogram JSON round-trip changed state")
    except ValueError as e:
        problems.append(f"flight dump failed validation: {e}")
    fsum = rec.summary()
    if fsum["flight_spans_done"] != 1 or fsum["e2e_count"] != 1:
        problems.append(f"flight summary inconsistent: {fsum}")
    return fsum


def selftest(json_path: str | None = None, device=None) -> dict:
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.data import (
        ShardedLoader,
        synthetic_regression,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.models import LinearRegressor
    from pytorch_distributed_training_tutorials_tpu_torch.obs import (
        MetricsLogger,
        MinOfN,
        make_receipt,
        validate_receipt,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs.trace import StepReport
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, sgd
    from pytorch_distributed_training_tutorials_tpu_torch.utils import profiling

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    problems: list[str] = []
    workdir = tempfile.mkdtemp(prefix="obs-selftest-")
    try:
        # pillar 1: metrics through a quiet, JSONL-sinked logger
        jsonl_path = os.path.join(workdir, "metrics.jsonl")
        mesh = create_mesh(device=dev)
        loader = ShardedLoader(synthetic_regression(size=256, in_dim=8, out_dim=1), 8, mesh)
        metrics = MetricsLogger(jsonl_path=jsonl_path, quiet=True)
        trainer = Trainer(LinearRegressor(in_dim=8), loader, sgd(1e-2), loss="mse",
                          metrics=metrics, log_every=2)
        trainer.train(2)
        metrics.close()
        if not metrics.epoch_events():
            problems.append("no epoch events recorded")
        if not metrics.step_events():
            problems.append("no step events recorded")
        with open(jsonl_path) as f:
            jsonl_lines = [json.loads(line) for line in f if line.strip()]
        if jsonl_lines != list(metrics.events):
            problems.append(f"jsonl sink ({len(jsonl_lines)} lines) != ring buffer "
                            f"({len(metrics.events)} events)")

        # pillar 2: MinOfN over a chain of steps, each chain closed by a sync
        batch = next(iter(loader))

        def chain():
            state = trainer.state
            for _ in range(STEPS):
                state, m = trainer.train_step(state, batch)
            float(m["loss"])  # the chain's one sync
            return state

        timing = MinOfN(n=3).measure(chain)
        if timing.best_s <= 0:
            problems.append("MinOfN produced a non-positive sample")

        # pillar 3: a real trace of the chain, classified
        logdir = os.path.join(workdir, "trace")
        with profiling.trace(logdir, device=dev):
            chain()
        report = StepReport.from_trace(logdir, steps=STEPS)
        if report.total_us <= 0:
            problems.append("trace captured no device time")
        if report.unclassified_fraction > UNCLASSIFIED_LIMIT:
            problems.append(f"{100 * report.unclassified_fraction:.1f}% of device time "
                            f"unclassified (>{100 * UNCLASSIFIED_LIMIT:.0f}%)")
        if not math.isclose(sum(report.by_category.values()), report.total_us,
                            rel_tol=1e-9, abs_tol=1e-6):
            problems.append(f"categories sum to {sum(report.by_category.values())}, "
                            f"total {report.total_us}")

        # pillar 4: flight recorder + streaming histograms (host only)
        whole = histogram_leg(problems)
        fsum = flight_leg(workdir, whole, problems)

        # pillar 5: the schema'd receipt, validated before it is reported
        receipt = make_receipt("obs_selftest", {
            "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "last_epoch": metrics.last_epoch,
            "n_events": len(metrics.events),
            "host_fetches": metrics.host_fetches,
            "timing": timing.to_dict(),
            "step_report": report.to_dict(),
            "flight": fsum,
            "hist_rel_error_bound": whole.rel_error_bound,
            "problems": problems,
            "ok": not problems,
        }, mesh=mesh, device=dev)
        problems.extend(validate_receipt(receipt, kind="obs_selftest"))
        receipt["ok"] = not problems
        receipt["problems"] = problems
        if json_path:
            with open(json_path, "w") as f:
                json.dump(receipt, f, indent=2)
                f.write("\n")
        return receipt
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_training_tutorials_tpu_torch.obs")
    parser.add_argument("--selftest", action="store_true",
                        help="run the end-to-end observability smoke test")
    parser.add_argument("--json", default=None, help="also write the receipt to this path")
    parser.add_argument("--device", default=None,
                        help="device to run on (default cuda; 'cpu' for a CPU run)")
    args = parser.parse_args(argv)
    if not args.selftest:
        parser.print_help()
        return 2
    receipt = selftest(args.json, device=args.device)
    print(json.dumps(receipt))
    return 0 if receipt["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
