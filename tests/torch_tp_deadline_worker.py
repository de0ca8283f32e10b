"""Worker body for ``tests/test_torch_tp_deadlines.py``, run on every rank
of a world that
:func:`pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel.spawn_tp`
starts: a module-level function (the spawn start method pickles it by
name) in a module that imports torch and the port only, so the ranks start
without JAX. It serves one stream through a tensor-parallel engine in each
leg — no clock feature, deadlines under a chaos stall, a cancel made on
rank 0 only, a stall alone — and returns what the parent compares."""

from __future__ import annotations

import os

import torch

from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs.flight import FlightRecorder
from pytorch_distributed_training_tutorials_tpu_torch.obs.sentry import ContractSentry
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig


def _leg(tp, cfg, params, reqs, leg: dict) -> dict:
    """Serve ``reqs`` (prompt, max_new) on 2 slots, all submitted up front;
    ``leg`` holds engine options, per-request deadlines by index and, for
    the cancel leg, the request indices cancelled after the second step."""
    flight = FlightRecorder(capacity=512)
    engine = ServeEngine(TransformerLM(cfg), params, n_slots=2, tokens_per_launch=4,
                         device="cpu", strategy=tp, flight=flight, **leg.get("engine", {}))
    deadlines = leg.get("deadlines", {})
    ids = [engine.submit(Request(prompt=p, max_new_tokens=m, seed=i,
                                 deadline_s=deadlines.get(i)))
           for i, (p, m) in enumerate(reqs)]
    tp.reset_collectives()
    done, steps, known, recorded = [], 0, [], []
    while not engine.idle:
        done.extend(engine.step())
        steps += 1
        if steps == 2 and leg.get("cancel"):
            # every rank calls; rank 0's call is the one that cancels
            known = [engine.cancel(ids[i]) for i in leg["cancel"]]
            recorded = sorted(engine._cancelled)
    return {
        "completions": [(c.request_id, c.finish_reason, c.tokens) for c in done],
        "ids": ids, "steps": steps, "known": known,
        "broadcasts": engine.n_decision_broadcasts,
        "tp_stats": engine.tp_stats(), "fault_stats": engine.fault_stats(),
        "host_syncs": engine.n_host_syncs,
        "budget": engine.n_chains + engine.n_prefills + engine.n_splices,
        "collectives": dict(tp.collectives), "n_chains": engine.n_chains,
        "expected_collectives": engine.expected_collectives(
            engine.n_chains * engine.tokens_per_launch),
        "stall_events": sum(e["kind"] == "stall" for e in flight.events),
        "cancel_recorded": recorded, "cancelled_left": sorted(engine._cancelled),
    }


def deadline_cases(tp, workdir: str, reqs: list, legs: dict) -> dict:
    """Every leg of ``legs`` (name -> engine options and cancels) over the
    float weights in ``workdir/float.pt`` (config in ``workdir/cfg.pt``).
    A leg that refuses returns its error's text."""
    torch.set_num_threads(1)
    cfg = TransformerConfig(**torch.load(os.path.join(workdir, "cfg.pt")))
    params = torch.load(os.path.join(workdir, "float.pt"))
    out = {}
    for name, leg in legs.items():
        if "chaos" in leg:
            leg = {**leg, "engine": {**leg.get("engine", {}), "chaos": ChaosConfig(**leg["chaos"])}}
        out[name] = _leg(tp, cfg, params, reqs, leg)
    # what was refused under tensor parallelism before the roles, the SLO
    # tiers and the sentry were ported: each now constructs (its stats
    # parts, or the error's text)
    refused = {}
    for name, kw in (("role", dict(role="prefill")), ("role_decode", dict(role="decode")),
                     ("priority_classes", dict(priority_classes=2)),
                     ("sentry", dict(sentry=ContractSentry()))):
        try:
            eng = ServeEngine(TransformerLM(cfg), params, device="cpu", strategy=tp, **kw)
            refused[name] = eng.stats("tp", "role", "sentry", "slo")
        except Exception as e:  # noqa: BLE001 - the parent reports what raised
            refused[name] = repr(e)
    out["refused"] = refused
    # what a cancel() on a TP engine that is not cancellable does
    engine = ServeEngine(TransformerLM(cfg), params, n_slots=2, device="cpu", strategy=tp)
    rid = engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=2))
    try:
        engine.cancel(rid)
        out["not_cancellable"] = None
    except ValueError as e:
        out["not_cancellable"] = str(e)
    engine.run_until_idle()
    return out
