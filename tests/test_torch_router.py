"""The port's copy of the fleet router (``serve/router.py``) against the JAX
package's, through the JAX router tests' own scenarios.

``tests/test_router.py`` drives the JAX ``FleetRouter`` with duck-typed
``FakeEngine`` replicas (token streams a pure function of prompt and seed)
and a ``FakeClock``. Each of its scenarios from
``test_affinity_hash_deterministic_and_tenant_aware`` to
``test_single_replica_router_is_transparent_plumbing`` runs here twice:
once as written, once with every name it takes from the JAX package —
``FleetRouter``, ``DispatchLedger``, ``affinity_hash``, the health states,
``Request``/``Completion``/``QueueFull``/``QueueClosed``, the flight
recorder and its merges, ``FleetChaosConfig`` and the chaos predicates —
bound to the port's, its fakes and helpers rebuilt over that binding
(``_rebind``; the JAX file is imported, not edited). Each run keeps every
router it built; the two runs' routers must agree exactly: every ledger
entry (dispatches with their fake-clock times, the delivered reason and
replica, the absorbed completions), the redispatch / hedge / absorb
counters, replica states, ``router_stats()``, ``stats()`` and every
completion the routers returned.

Then real engines: two port ``ServeEngine`` replicas over the toy int8 LM
of ``test_torch_serve_prefill.py``, one chaos-killed with in-flight and
queued work (the scenario of JAX ``tests/test_serve.py::test_fleet_router_
chaos_kill_redispatch_token_exact``), against the same fleet of JAX
engines: the same completions, ledger, states and router counters; the
ledger verifies; survivors equal the fault-free fleet; the killed engine's
chains froze at its kill; the fleet's host syncs are the sum of the
replicas' budgets. Last, the serving selftest's ``--chaos``, ``--flight``
and ``--router`` arms, in this process.
"""

import dataclasses
import types

import pytest
import torch

import test_router as jax_router_tests
from pytorch_distributed_training_tutorials_tpu.serve import (
    FleetRouter as JaxFleetRouter,
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
    affinity_hash as jax_affinity_hash,
)
from pytorch_distributed_training_tutorials_tpu.utils.chaos import (
    FleetChaosConfig as JaxFleetChaosConfig,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs import flight as tflight
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
from pytorch_distributed_training_tutorials_tpu_torch.serve import router as trouter
from pytorch_distributed_training_tutorials_tpu_torch.serve import scheduler as tsched
from pytorch_distributed_training_tutorials_tpu_torch.utils import chaos as tchaos
from helpers import requires_pallas_interpret

# the JAX file's scenarios (its lines 245-702): every test but the
# static-analysis pin of its own module
SCENARIOS = sorted(
    (name for name, fn in vars(jax_router_tests).items()
     if name.startswith("test_") and isinstance(fn, types.FunctionType)
     and 245 <= fn.__code__.co_firstlineno < 703),
    key=lambda n: getattr(jax_router_tests, n).__code__.co_firstlineno,
)
PORT_NAMES = {
    **{n: getattr(tflight, n) for n in ("FlightRecorder", "merge_snapshots",
                                        "summarize_merged", "validate_flightlog")},
    **{n: getattr(trouter, n) for n in ("DEAD", "DRAINING", "HEALTHY", "REPLICA_DEAD",
                                        "SUSPECT", "DispatchLedger", "FleetRouter",
                                        "affinity_hash")},
    **{n: getattr(tsched, n) for n in ("Completion", "QueueClosed", "QueueFull", "Request")},
    **{n: getattr(tchaos, n) for n in ("FleetChaosConfig", "replica_killed",
                                       "replica_stall_pending")},
}


def _recording(router_cls, log: list):
    """A subclass of ``router_cls`` that keeps each instance and every
    completion its rounds return."""

    class Recording(router_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.returned = []
            log.append(self)

        def step(self):
            out = super().step()
            self.returned.extend(out)
            return out

    return Recording


def _rebind(names: dict, log: list) -> dict:
    """The JAX test module's namespace with ``names`` bound in, its own
    functions and classes rebuilt over it (so the fakes raise the bound
    ``QueueFull`` and build the bound ``Completion``), and ``FleetRouter``
    recording into ``log``."""
    src = vars(jax_router_tests)
    g = dict(src)
    g.update(names)
    g["FleetRouter"] = _recording(g["FleetRouter"], log)

    def fn(f):
        new = types.FunctionType(f.__code__, g, f.__name__, f.__defaults__, f.__closure__)
        new.__kwdefaults__ = f.__kwdefaults__
        return new

    def member(v):
        if isinstance(v, types.FunctionType):
            return fn(v)
        if isinstance(v, property):
            return property(*(fn(x) if x is not None else None
                              for x in (v.fget, v.fset, v.fdel)))
        return v

    def ours(v):
        return getattr(v, "__module__", None) == jax_router_tests.__name__

    for name, v in src.items():
        if ours(v) and isinstance(v, types.FunctionType):
            g[name] = fn(v)
    for name, v in src.items():  # bases first: the file defines them first
        if ours(v) and isinstance(v, type):
            bases = tuple(g[b.__name__] if ours(b) else b for b in v.__bases__)
            body = {k: member(x) for k, x in vars(v).items()
                    if k not in ("__dict__", "__weakref__")}
            g[name] = type(v.__name__, bases, body)
    return g


def _record(routers: list) -> list:
    """What each router built in a scenario ended with."""
    out = []
    for r in routers:
        ledger = r.ledger
        out.append({
            "entries": {gid: dataclasses.astuple(e) for gid, e in ledger.entries.items()},
            "counts": (ledger.n_redispatched, ledger.n_hedged, ledger.n_absorbed),
            "verify": ledger.verify(final=False),
            "states": r.replica_states(),
            "router_stats": r.router_stats(),
            "stats": r.stats(),
            "returned": [dataclasses.astuple(c) for c in r.returned],
        })
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_router_scenario_matches_jax(name):
    assert len(SCENARIOS) == 19
    jax_log, port_log = [], []
    g_jax = _rebind({}, jax_log)
    g_port = _rebind(PORT_NAMES, port_log)
    assert g_port["FleetRouter"].__mro__[1] is trouter.FleetRouter
    g_jax[name]()
    g_port[name]()
    assert len(port_log) == len(jax_log)
    assert _record(port_log) == _record(jax_log)


@pytest.mark.parametrize("depth", [1, 4, 16])
def test_affinity_hash_equals_jax(depth):
    import numpy as np

    rng = np.random.Generator(np.random.PCG64(depth))
    for n in (1, 3, 17, 40):
        prompt = rng.integers(0, 50_000, n).tolist()
        for adapter in (0, 1, 7):
            assert trouter.affinity_hash(prompt, adapter, depth) == jax_affinity_hash(
                prompt, adapter, depth)


# -- real engines ---------------------------------------------------------

def _ledger_untimed(fr) -> dict:
    """The ledger's entries without the dispatch times (a real clock)."""
    return {gid: ([(r, local, kind) for r, local, kind, _ in e.dispatches], e.delivered,
                  e.delivered_by, e.absorbed)
            for gid, e in fr.ledger.entries.items()}


@requires_pallas_interpret
def test_real_engine_fleet_chaos_kill_matches_jax(monkeypatch):
    from test_torch_serve_prefill import Int8

    m = Int8()
    base = m.prompts[0][:6]
    reqs = [(base, 12)] * 3
    n_replicas = 2
    target = trouter.affinity_hash(base, adapter=0, depth=16) % n_replicas
    assert target == jax_affinity_hash(base, adapter=0, depth=16) % n_replicas

    def run(engine, router, make, chaos):
        engines = [engine() for _ in range(n_replicas)]
        fr = router(engines, chaos=chaos)
        gids = [fr.submit(make(prompt=p, max_new_tokens=n, seed=i))
                for i, (p, n) in enumerate(reqs)]
        done = {c.request_id: (c.tokens, c.finish_reason) for c in fr.run_until_idle()}
        return fr, engines, [done[g] for g in gids]

    def jax_engine():
        return JaxServeEngine(m.jmodel(), m.qtree, n_slots=1, tokens_per_launch=4, max_queue=8)

    def port_engine():
        return ServeEngine(m.model(), m.params, n_slots=1, tokens_per_launch=4, max_queue=8,
                           device="cpu")

    kill = dict(kill_replica=target, kill_at_chain=1)
    _, _, ok = run(port_engine, trouter.FleetRouter, Request, None)
    assert [r for _, r in ok] == ["length"] * 3
    jfr, jengines, want = run(jax_engine, JaxFleetRouter, JaxRequest,
                              JaxFleetChaosConfig(**kill))
    syncs = {"n": 0}
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: (syncs.__setitem__("n", syncs["n"] + 1),
                                            real(t, *a, **k))[1])
    fr, engines, got = run(port_engine, trouter.FleetRouter, Request,
                           tchaos.FleetChaosConfig(**kill))
    monkeypatch.undo()
    assert got == want
    assert _ledger_untimed(fr) == _ledger_untimed(jfr)
    assert fr.ledger.verify() == [] == jfr.ledger.verify()
    assert fr.replica_states() == jfr.replica_states()
    assert fr.replica_states()[target] == "dead"
    for key in ("redispatched", "replica_dead_completions", "requests_accepted", "absorbed"):
        assert fr.router_stats()[key] == jfr.router_stats()[key]
    reasons = [r for _, r in got]
    assert "replica_dead" in reasons and fr.ledger.n_redispatched >= 1
    for (toks, reason), (ok_toks, _) in zip(got, ok):
        if reason == "length":
            assert toks == ok_toks
    assert engines[target].n_chains <= 2
    assert [e.n_chains for e in engines] == [e.n_chains for e in jengines]
    assert syncs["n"] == sum(e.n_host_syncs for e in engines) == sum(
        e.n_chains + e.n_prefills + e.n_splices for e in engines)


def test_selftest_fault_flight_and_router_arms():
    """The selftest's ``--chaos``, ``--flight`` and ``--router`` arms on the
    CPU: every check holds, and the receipt carries ``fault_stats()`` and
    ``flight_stats()``."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve.__main__ import selftest

    receipt = selftest("cpu", chaos=True, flight=True, router=True)
    assert receipt["ok"], receipt["problems"]
    assert receipt["nonfinite_quarantined"] == receipt["deadline_expired"] == 1
    assert receipt["steps_skipped"] == 1 and receipt["chaos_flight_named_slot"]
    assert receipt["flight_span_full"] and receipt["flight_hist_vs_sort"]
    assert receipt["flight"] == 1 and receipt["router_fleet_exact"]
    assert receipt["router_replicas_dead"] == 1
