"""Worker bodies for ``tests/test_torch_tp_roles_slo.py`` (a gloo world of
2) and ``tests/test_torch_tp_world4.py`` (a world of 4), run on every rank
of a world that
:func:`pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel.spawn_tp`
starts: module-level functions (the spawn start method pickles them by
name) in a module that imports torch and the port only, so the ranks start
without JAX. They serve prefill/decode role pairs, SLO preemption and
routers over tensor-parallel engines, each rank with its own contract
sentry, and return what the parent compares."""

from __future__ import annotations

import dataclasses
import itertools
import os

import torch
import torch.distributed as dist

from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs.sentry import ContractSentry
from pytorch_distributed_training_tutorials_tpu_torch.serve import (
    FleetRouter,
    Request,
    ServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve.slots import tree_nbytes


def _load(workdir: str):
    torch.set_num_threads(1)
    cfg = TransformerConfig(**torch.load(os.path.join(workdir, "cfg.pt")))
    return cfg, torch.load(os.path.join(workdir, "float.pt"))


def _requests(specs):
    return [Request(prompt=list(p), max_new_tokens=m, seed=i) for i, (p, m) in enumerate(specs)]


def _sentry_row(sen: ContractSentry, *engines) -> dict:
    return {**sen.summary(), "host_syncs": sum(e.n_host_syncs for e in engines)}


def _role_pair(cfg, params, tp, templates: list) -> dict:
    """The JAX test's router-less drive over a TP prefill engine and a TP
    decode engine sharing this rank's sentry: prefill every template, move
    each handoff by hand (its segment's bytes and KV heads recorded), run
    the decode engine to idle. Beside it, a replicated prefill engine's
    segment bytes for the same templates."""
    sen = ContractSentry()
    pre = ServeEngine(TransformerLM(cfg), params, role="prefill", n_slots=2,
                      tokens_per_launch=8, device="cpu", strategy=tp, sentry=sen)
    dec = ServeEngine(TransformerLM(cfg), params, role="decode", n_slots=2,
                      tokens_per_launch=8, device="cpu", strategy=tp, sentry=sen)
    whole = ServeEngine(TransformerLM(cfg), params, role="prefill", n_slots=2,
                        tokens_per_launch=8, device="cpu")
    reqs = _requests(templates)
    with sen:
        rids = [pre.submit(dataclasses.replace(r)) for r in reqs]
        pre.run_until_idle()
        handoffs = [pre.take_handoff(r) for r in rids]
        aids = [dec.accept(dataclasses.replace(r), h) for r, h in zip(reqs, handoffs)]
        done = {c.request_id: c for c in dec.run_until_idle()}
    wids = [whole.submit(dataclasses.replace(r)) for r in reqs]
    whole.run_until_idle()
    return {
        "tokens": [done[a].tokens for a in aids],
        "reasons": [done[a].finish_reason for a in aids],
        "segment_bytes": [tree_nbytes(h.segment) for h in handoffs],
        "segment_kv_heads": [h.segment.k.shape[3] for h in handoffs],
        "whole_segment_bytes": [tree_nbytes(whole.take_handoff(w).segment) for w in wids],
        "prefill_host_syncs": pre.n_host_syncs, "prefill_chains": pre.n_chains,
        "decode_host_syncs": dec.n_host_syncs, "decode_chains": dec.n_chains,
        "handoffs_in": dec.n_handoffs_in, "sentry": _sentry_row(sen, pre, dec),
        "stats": {"prefill": pre.stats("role", "tp", "sentry"),
                  "decode": dec.stats("role", "tp", "sentry")},
    }


def _role_fleet(cfg, params, tp, templates: list) -> dict:
    """The role pair behind a ``FleetRouter`` (its default health timing:
    a clock feature on, so the round's clock is rank 0's)."""
    sen = ContractSentry()
    engines = [ServeEngine(TransformerLM(cfg), params, role=role, n_slots=2,
                           tokens_per_launch=8, device="cpu", strategy=tp, sentry=sen)
               for role in ("prefill", "decode")]
    fleet = FleetRouter(engines)
    with sen:
        gids = [fleet.submit(r) for r in _requests(templates)]
        done = {c.request_id: c for c in fleet.run_until_idle()}
    return {"tokens": [done[g].tokens for g in gids], "ledger": fleet.ledger.verify(),
            "handoffs_moved": fleet.router_stats()["handoffs_moved"],
            "clock_broadcasts": fleet.n_clock_broadcasts,
            "sentry": _sentry_row(sen, *engines),
            "fleet_sentry": fleet.stats()["sentry_fetched"]}


def _slo(cfg, params, tp, specs: list, high_after: int, fail_rank=None) -> dict:
    """SLO preemption on a one-slot ``priority_classes=2`` engine: the
    first spec's request (class 1) decodes, ``high_after`` steps later the
    second's (class 0) arrives and preempts it. Each swap-out's packed
    bytes and victim are recorded. ``fail_rank``: that rank's first
    swap-in raises (a rank-local failure)."""
    sen = ContractSentry()
    kw = dict(n_slots=1, tokens_per_launch=4, device="cpu", priority_classes=2)
    eng = ServeEngine(TransformerLM(cfg), params, strategy=tp, sentry=sen, **kw)
    swaps = []
    swap_out = eng._swap_out

    def recorded(slot):
        rid = eng._slots[slot].request.request_id
        swap_out(slot)
        swaps.append((rid, eng._swapped[rid].packed.numel()))

    eng._swap_out = recorded
    if fail_rank is not None and tp.rank == fail_rank:
        def boom(seg_len):
            raise RuntimeError("injected rank-local swap-in failure")

        eng._swap_layout = boom
    reqs = _requests(specs)
    done = []
    with sen:
        ids = [eng.submit(dataclasses.replace(reqs[0], priority=1))]
        for _ in range(high_after):
            done += eng.step()
        ids.append(eng.submit(dataclasses.replace(reqs[1], priority=0)))
        done += eng.run_until_idle()
    return {
        "completions": [(c.request_id, c.finish_reason, c.tokens) for c in done],
        "ids": ids, "swaps": swaps, "swaps_out": eng.n_swaps_out, "swaps_in": eng.n_swaps_in,
        "host_syncs": eng.n_host_syncs,
        "budget": eng.n_chains + eng.n_prefills + eng.n_splices + eng.n_swaps_out,
        "tp_stats": eng.tp_stats(), "sentry": _sentry_row(sen, eng),
        "prefill_errors": eng.n_prefill_errors,
    }


def _whole_swap_bytes(cfg, params, specs: list, high_after: int) -> list:
    """The replicated SLO engine's packed bytes a swap on the same stream."""
    eng = ServeEngine(TransformerLM(cfg), params, n_slots=1, tokens_per_launch=4,
                      device="cpu", priority_classes=2)
    swaps = []
    swap_out = eng._swap_out

    def recorded(slot):
        rid = eng._slots[slot].request.request_id
        swap_out(slot)
        swaps.append(eng._swapped[rid].packed.numel())

    eng._swap_out = recorded
    reqs = _requests(specs)
    eng.submit(dataclasses.replace(reqs[0], priority=1))
    for _ in range(high_after):
        eng.step()
    eng.submit(dataclasses.replace(reqs[1], priority=0))
    eng.run_until_idle()
    return swaps


def _router_clock(cfg, params, tp, specs: list, features: bool) -> dict:
    """A FleetRouter over two TP monolithic engines whose clocks disagree
    on purpose: rank 0's advances 10 ms a reading, every other rank's 50 s
    (alone it would mark every replica dead at ``dead_after_s`` 5). With a
    clock feature on (hedging at 0.5 s, heartbeats at 1 / 5 s) the round's
    clock is rank 0's; ``features`` False sets every threshold infinite and
    hedging off: no broadcast."""
    step = 0.01 if tp.rank == 0 else 50.0
    ticks = itertools.count()

    def clock():
        return next(ticks) * step

    engines = [ServeEngine(TransformerLM(cfg), params, n_slots=1, tokens_per_launch=4,
                           device="cpu", strategy=tp) for _ in range(2)]
    if features:
        kw = dict(hedge_after_s=0.5, suspect_after_s=1.0, dead_after_s=5.0, probe_after_s=1.0)
    else:
        inf = float("inf")
        kw = dict(suspect_after_s=inf, dead_after_s=inf, probe_after_s=inf)
    fleet = FleetRouter(engines, clock=clock, **kw)
    gids = [fleet.submit(r) for r in _requests(specs)]
    done, steps = [], 0
    while not (fleet.idle and fleet._engines_drained()):
        done += fleet.step()
        steps += 1
    return {
        "completions": [(c.request_id, c.finish_reason, c.tokens) for c in done],
        "gids": gids, "steps": steps, "states": fleet.replica_states(),
        "dispatches": {g: [(r, k) for r, _, k, _ in e.dispatches]
                       for g, e in fleet.ledger.entries.items()},
        "clock_broadcasts": fleet.n_clock_broadcasts,
        "transitions": fleet.n_health_transitions,
    }


def roles_slo_cases(tp, workdir: str, templates: list, slo_specs: list, high_after: int,
                    router_specs: list) -> dict:
    """Every case of the world-of-2 file on this rank."""
    cfg, params = _load(workdir)
    return {
        "roles": _role_pair(cfg, params, tp, templates),
        "fleet": _role_fleet(cfg, params, tp, templates),
        "slo": _slo(cfg, params, tp, slo_specs, high_after),
        "slo_whole_swap_bytes": _whole_swap_bytes(cfg, params, slo_specs, high_after),
        "slo_fail": _slo(cfg, params, tp, slo_specs, high_after, fail_rank=1),
        "router_clock": _router_clock(cfg, params, tp, router_specs, features=True),
        "router_no_clock": _router_clock(cfg, params, tp, router_specs, features=False),
    }


def world4_cases(_world_tp, workdir: str, specs: list, deadline_index: int) -> dict:
    """A ``{"data": 2, "model": 2}`` world: this rank's model group (ranks
    {0, 1} or {2, 3}) serves the requests of its data rank (every other
    spec) through a TP engine with a default deadline (a clock feature:
    one broadcast a step over the group's own decision group); request
    ``deadline_index`` of each group also carries a deadline that has
    passed when it is popped. A second engine over the same model group
    reuses the group's decision group."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        TensorParallel,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import engine as engine_mod

    cfg, params = _load(workdir)
    tp = TensorParallel(create_mesh({"data": 2, "model": 2}, device="cpu"))
    eng = ServeEngine(TransformerLM(cfg), params, n_slots=2, tokens_per_launch=4, device="cpu",
                      strategy=tp, default_deadline_s=600.0)
    again = ServeEngine(TransformerLM(cfg), params, n_slots=1, device="cpu", strategy=tp)
    mine = specs[tp.data_rank::2]
    ids = [eng.submit(Request(prompt=list(p), max_new_tokens=m, seed=i,
                              deadline_s=1e-6 if i == deadline_index else None))
           for i, (p, m) in enumerate(mine)]
    done, steps = [], 0
    while not eng.idle:
        done += eng.step()
        steps += 1
    return {
        "rank": dist.get_rank(), "data_rank": tp.data_rank, "model_rank": tp.rank,
        "completions": [(c.request_id, c.finish_reason, c.tokens) for c in done],
        "ids": ids, "steps": steps, "broadcasts": eng.n_decision_broadcasts,
        "group_ranks": dist.get_process_group_ranks(eng._dgroup), "src": eng._dsrc,
        "groups_made": sorted(engine_mod._DECISION_GROUPS["groups"]),
        "shared_group": again._dgroup is eng._dgroup,
        "host_syncs": eng.n_host_syncs,
        "budget": eng.n_chains + eng.n_prefills + eng.n_splices,
        "fault_stats": eng.fault_stats(),
    }
