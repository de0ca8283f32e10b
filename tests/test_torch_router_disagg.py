"""The fleet router's disaggregation in the PyTorch port against the JAX
package's, through the disaggregation cases of ``tests/test_router.py``
(its lines 804-1000), and then on real port engines.

First the JAX file's scenarios as ``tests/test_torch_router.py`` runs the
others: each twice, as written and with the port's names bound in
(``_rebind``; the fakes ``FakePrefillEngine`` / ``FakeDecodeEngine`` are
rebuilt over the binding), the two runs' routers equal in every ledger
entry, counter, replica state, stats and returned completion.

Then the same cases on real engines: one ``role="prefill"`` and two
``role="decode"`` port ``ServeEngine`` s (one paged) over the JAX test
model of ``tests/test_handoff.py`` (``PRNGKey(0)``, converted through
``models/convert.py:from_jax_params``). Every request delivers exactly
once (the ledger verifies) with the monolithic engine's tokens — the JAX
monolithic engine's, greedy, and the port's own, sampled; a 1p2d fleet of
JAX engines moves the same handoffs to the same replicas (the ledgers
equal, times aside). The prefill replica makes no host sync, each decode
replica one a chain and one a handoff. A decode replica killed
mid-stream: its in-flight request completes ``"replica_dead"``, its queued
one re-enters through the prefill side and finishes on the survivor. A
request cancelled while its handoff waits is delivered ``"cancelled"``;
a drain keeps the decode replicas admitting.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_handoff as jax_handoff
import test_router as jax_router_tests
from pytorch_distributed_training_tutorials_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
)
from pytorch_distributed_training_tutorials_tpu.serve import (
    FleetRouter as JaxFleetRouter,
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve import (
    QueueClosed,
    Request,
    ServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve import router as trouter
from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import FleetChaosConfig
from test_torch_router import PORT_NAMES, _ledger_untimed, _rebind, _record

# the JAX file's disaggregation scenarios (its lines 804-1000)
SCENARIOS = sorted(
    (name for name, fn in vars(jax_router_tests).items()
     if name.startswith("test_") and isinstance(fn, types.FunctionType)
     and 804 <= fn.__code__.co_firstlineno <= 1000),
    key=lambda n: getattr(jax_router_tests, n).__code__.co_firstlineno,
)
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)
SPECS = [(4, 9), (9, 7), (13, 11), (6, 12), (11, 5), (3, 14)]


def _rebind_classes(names: dict, log: list) -> dict:
    """``_rebind``, with each rebuilt class's methods that call
    ``super()`` given a ``__class__`` cell of the rebuilt class (the
    disaggregation fakes subclass ``FakeEngine``)."""
    g = _rebind(names, log)
    for name, cls in list(g.items()):
        if not (isinstance(cls, type) and cls.__module__ == jax_router_tests.__name__):
            continue
        for attr, fn in list(vars(cls).items()):
            if isinstance(fn, types.FunctionType) and "__class__" in fn.__code__.co_freevars:
                cells = tuple(types.CellType(cls) if var == "__class__" else cell
                              for var, cell in zip(fn.__code__.co_freevars, fn.__closure__))
                new = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                                         fn.__defaults__, cells)
                new.__kwdefaults__ = fn.__kwdefaults__
                setattr(cls, attr, new)
    return g


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", SCENARIOS)
def test_disagg_scenario_matches_jax(name):
    assert len(SCENARIOS) == 7
    jax_log, port_log = [], []
    g_jax = _rebind_classes({}, jax_log)
    g_port = _rebind_classes(PORT_NAMES, port_log)
    assert g_port["FleetRouter"].__mro__[1] is trouter.FleetRouter
    g_jax[name]()
    g_port[name]()
    assert len(port_log) == len(jax_log)
    assert _record(port_log) == _record(jax_log)


# -- real engines ---------------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    jmodel = JaxLM(JaxConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = TransformerConfig(**CFG)
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return jmodel, params, cfg, port


def _reqs(make=Request):
    return [make(prompt=jax_handoff._prompt(9600 + i, p), max_new_tokens=m, seed=i)
            for i, (p, m) in enumerate(SPECS)]


def _port(toy, **kw):
    _, _, cfg, params = toy
    kw.setdefault("n_slots", 2)
    return ServeEngine(TransformerLM(cfg), params, tokens_per_launch=4, device="cpu", **kw)


def _fleet(toy, temperature=0.0, **router_kw):
    engines = [_port(toy, role="prefill", temperature=temperature),
               _port(toy, role="decode", temperature=temperature),
               _port(toy, role="decode", temperature=temperature, paged=True, page_size=8,
                     pool_pages=16)]
    return engines, trouter.FleetRouter(engines, **router_kw)


def _mono(eng, reqs):
    ids = [eng.submit(dataclasses.replace(r)) for r in reqs]
    done = {c.request_id: c.tokens for c in eng.run_until_idle()}
    return [done[i] for i in ids]


@pytest.fixture(scope="module")
def jax_tokens(toy):
    jmodel, params, _, _ = toy
    return _mono(JaxServeEngine(jmodel, params, n_slots=2, tokens_per_launch=4),
                 _reqs(JaxRequest))


def test_real_fleet_1p2d_matches_jax(toy, jax_tokens, monkeypatch):
    """The happy path on real engines: submissions land on the prefill
    replica only, every request delivers once with the JAX monolithic
    engine's greedy tokens, ``handoffs_moved`` is the request count; the
    same fleet of JAX engines moves the same handoffs to the same decode
    replicas. Host syncs: the prefill replica none, each decode replica
    its chains + handoffs in — a spy on ``Tensor.cpu`` sees their sum."""
    engines, fr = _fleet(toy)
    calls = {"n": 0}
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: (calls.__setitem__("n", calls["n"] + 1),
                                            real(t, *a, **k))[1])
    gids = [fr.submit(r) for r in _reqs()]
    done = {c.request_id: c for c in fr.run_until_idle()}
    monkeypatch.undo()
    assert [done[g].tokens for g in gids] == jax_tokens
    assert all(done[g].finish_reason == "length" for g in gids)
    assert fr.ledger.verify() == []
    st = fr.router_stats()
    assert (st["n_prefill_replicas"], st["n_decode_replicas"], st["handoffs_moved"]) == (1, 2, 6)
    pre, *decs = engines
    assert pre.n_host_syncs == 0 and pre.n_handoffs_out == 6 and pre.n_chains == 0
    assert sum(d.n_handoffs_in for d in decs) == 6 and all(d.n_handoffs_in for d in decs)
    for d in decs:
        assert d.n_host_syncs == d.n_chains + d.n_handoffs_in
    assert calls["n"] == sum(d.n_host_syncs for d in decs)
    assert decs[1].page_stats()["pages_in_use"] == 0

    jmodel, params, _, _ = toy
    jengines = [JaxServeEngine(jmodel, params, n_slots=2, tokens_per_launch=4, role=role,
                               **kw)
                for role, kw in (("prefill", {}), ("decode", {}),
                                 ("decode", dict(paged=True, page_size=8, pool_pages=16)))]
    jfr = JaxFleetRouter(jengines)
    jgids = [jfr.submit(r) for r in _reqs(JaxRequest)]
    jdone = {c.request_id: c for c in jfr.run_until_idle()}
    assert [jdone[g].tokens for g in jgids] == jax_tokens
    assert _ledger_untimed(fr) == _ledger_untimed(jfr)
    for key in ("handoffs_moved", "requests_accepted", "absorbed"):
        assert fr.router_stats()[key] == jfr.router_stats()[key]


def test_real_fleet_sampled_equals_monolithic(toy):
    """``temperature`` 0.8: each handoff carries its request's generator
    state, so the fleet's draws are the monolithic engine's."""
    _, fr = _fleet(toy, temperature=0.8)
    gids = [fr.submit(r) for r in _reqs()]
    done = {c.request_id: c.tokens for c in fr.run_until_idle()}
    assert [done[g] for g in gids] == _mono(_port(toy, temperature=0.8), _reqs())


def test_real_fleet_decode_death_reprefills_queued_exactly_once(toy, jax_tokens):
    """A decode replica killed at its first chain (one slot, so it holds
    one request in flight and others queued): the in-flight ones complete
    ``"replica_dead"``, the queued ones re-enter through the prefill
    replica (a fresh handoff each) and finish on the survivor with the
    monolithic tokens; the ledger verifies."""
    engines = [_port(toy, role="prefill", n_slots=4), _port(toy, role="decode", n_slots=1),
               _port(toy, role="decode", n_slots=1)]
    fr = trouter.FleetRouter(engines, chaos=FleetChaosConfig(kill_replica=1, kill_at_chain=1))
    gids = [fr.submit(r) for r in _reqs()]
    done = {c.request_id: c for c in fr.run_until_idle()}
    assert fr.ledger.verify() == []
    assert fr.replica_states()[1] == "dead"
    reasons = [done[g].finish_reason for g in gids]
    assert "replica_dead" in reasons
    for g, want in zip(gids, jax_tokens):
        if done[g].finish_reason == "length":
            assert done[g].tokens == want
    assert engines[0].n_handoffs_out > len(gids)  # re-prefilled handoffs
    assert engines[2].n_handoffs_in == reasons.count("length")


def test_real_fleet_cancel_between_phases(toy):
    """A request whose handoff waits because no decode replica admits it
    (a full queue) is delivered ``"cancelled"`` by the next move round,
    with no decode work, exactly once."""
    engines = [_port(toy, role="prefill", n_slots=4), _port(toy, role="decode", max_queue=1)]
    fr = trouter.FleetRouter(engines)
    gids = [fr.submit(r) for r in _reqs()[:3]]
    fr.step()  # three handoffs; the decode replica takes one
    waiting = [g for g, _ in fr._pending_handoffs]
    assert waiting and fr.cancel(waiting[-1])
    done = {c.request_id: c for c in fr.run_until_idle()}
    assert done[waiting[-1]].finish_reason == "cancelled" and done[waiting[-1]].tokens == []
    assert engines[1].n_handoffs_in == 2
    assert sorted(done) == sorted(gids) and fr.ledger.verify() == []


def test_real_fleet_drain_keeps_decode_admitting(toy, jax_tokens):
    """``close()`` stops fleet admission but not the decode replicas': the
    drain admits every accepted request's handoff and finishes it."""
    engines, fr = _fleet(toy)
    reqs = _reqs()[:3]
    gids = [fr.submit(r) for r in reqs]
    fr.close()
    with pytest.raises(QueueClosed):
        fr.submit(_reqs()[3])
    done = {c.request_id: c for c in fr.drain()}
    assert [done[g].tokens for g in gids] == jax_tokens[:3]
    assert not engines[1].closed and not engines[2].closed
    assert fr.ledger.verify() == []
