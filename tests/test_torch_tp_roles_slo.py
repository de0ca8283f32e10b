"""Prefill/decode roles, SLO preemption and the fleet router under
tensor-parallel serving in the PyTorch port, each rank with its own
contract sentry.

The JAX engine accepts ``role=`` and ``priority_classes`` beside a
``strategy`` in one process; the port's ranks each run the host loop. One
gloo world of 2 spawned ranks (``spawn_tp``, a hard join timeout; the rank
body in ``tests/torch_tp_roles_worker.py``, no JAX) over the toy float
model of the JAX ``tests/test_handoff.py`` (``PRNGKey(0)``, converted
through ``models/convert.py:from_jax_params``):

- roles: a TP prefill engine and a TP decode engine over the same model
  group, driven by hand on the templates of the JAX
  ``test_handoff_tp_sharded_segment`` and behind a ``FleetRouter``. Exact:
  greedy tokens equal the JAX replicated role pair's (that JAX test holds
  its sharded pair equal to the replicated one); a rank's segment holds
  its 2 of the 4 KV heads, its bytes half the unsharded segment's within
  1% (the index leaf is whole); the prefill side makes no host sync, the
  decode side chains + handoffs in;
- SLO: a one-slot ``priority_classes=2`` engine preempts a class-1
  request for a class-0 one. Exact: both requests' greedy tokens equal the
  JAX monolithic engine's; victims and swaps identical across ranks; a
  rank's swap bytes half the replicated engine's within 1%; host syncs
  chains + prefills + splices + swaps out a rank, and each rank's sentry
  balanced (fetched == budgeted == host syncs, no violation). A swap-in
  that raises on rank 1 only is agreed: both ranks complete the victim
  ``"error"`` with its earned tokens and serve on;
- the router: rank 0's clock advances 10 ms a reading, rank 1's 50 s (it
  alone would declare every replica dead); with hedging and heartbeats on
  both ranks route, deliver and keep health identically on rank 0's
  clock, one broadcast a round (and one at construction); with every clock
  feature off, no broadcast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_handoff as jax_handoff
import torch_tp_roles_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)
# the SLO stream: a class-1 request of 16 new tokens on the one slot, a
# class-0 one of 6 arriving after 2 steps
SLO_SPECS = [(6, 16), (5, 6)]
HIGH_AFTER = 2
ROUTER_SPECS = [(5, 8), (7, 6), (4, 9), (9, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(seed, specs):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [(rng.integers(0, CFG["vocab_size"], p).tolist(), m) for p, m in specs]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_roles_slo")
    jcfg = jt.TransformerConfig(**CFG)
    jmodel = jt.TransformerLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           TransformerConfig(**CFG), device="cpu")
    torch.save(CFG, workdir / "cfg.pt")
    torch.save(port, workdir / "float.pt")
    # the JAX test's templates (test_handoff_tp_sharded_segment)
    templates = jax_handoff._templates(9300, [(5, 8), (11, 6)])
    slo = _specs(9400, SLO_SPECS)
    router = _specs(9500, ROUTER_SPECS)
    ranks = spawn_tp(torch_tp_roles_worker.roles_slo_cases, 2,
                     (str(workdir), [(t.prompt, t.max_new_tokens) for t in templates], slo,
                      HIGH_AFTER, router),
                     backend="gloo", device="cpu", join_timeout_s=240)
    # the JAX replicated role pair, and the JAX monolithic engine
    pre = JaxServeEngine(jmodel, params, role="prefill", n_slots=2, tokens_per_launch=8)
    dec = JaxServeEngine(jmodel, params, role="decode", n_slots=2, tokens_per_launch=8)
    pair = [c.tokens for c in jax_handoff._drive_pair(pre, dec, templates)]
    mono = JaxServeEngine(jmodel, params, n_slots=1, tokens_per_launch=4)
    ids = [mono.submit(JaxRequest(prompt=p, max_new_tokens=m, seed=i))
           for i, (p, m) in enumerate(slo + router)]
    done = {c.request_id: c.tokens for c in mono.run_until_idle()}
    return {"ranks": ranks, "jax_pair": pair,
            "jax_slo": [done[i] for i in ids[:len(slo)]],
            "jax_router": [done[i] for i in ids[len(slo):]]}


# ------------------------------------------------------------------ roles

def test_tp_role_pair_matches_jax_replicated_pair(world):
    for rank in world["ranks"]:
        roles = rank["roles"]
        assert roles["tokens"] == world["jax_pair"]
        assert roles["reasons"] == ["length"] * len(world["jax_pair"])
        assert roles["stats"]["prefill"]["role"] == "prefill"
        assert roles["stats"]["decode"]["tp"] == 2
    assert world["ranks"][0]["roles"]["tokens"] == world["ranks"][1]["roles"]["tokens"]


def test_segment_is_the_ranks_heads(world):
    """A rank's segment holds its 2 of the 4 KV heads: half the unsharded
    segment's bytes within 1% (the index leaf stays whole)."""
    for rank in world["ranks"]:
        roles = rank["roles"]
        assert roles["segment_kv_heads"] == [2, 2]
        for got, whole in zip(roles["segment_bytes"], roles["whole_segment_bytes"]):
            assert abs(got / whole - 0.5) <= 0.01, (got, whole)


def test_role_budgets_and_sentry_per_rank(world):
    """The prefill side makes no host sync and launches no chain; the
    decode side's syncs are its chains + handoffs in; the rank's sentry,
    shared by both engines, balances."""
    for rank in world["ranks"]:
        roles = rank["roles"]
        assert roles["prefill_host_syncs"] == 0 and roles["prefill_chains"] == 0
        assert roles["decode_host_syncs"] == roles["decode_chains"] + roles["handoffs_in"]
        sen = roles["sentry"]
        assert sen["sentry_fetched"] == sen["sentry_budgeted"] == sen["host_syncs"]
        assert sen["sentry_budget_violations"] == 0 and sen["sentry_reuploads"] == 0


def test_role_fleet_behind_the_router(world):
    for rank in world["ranks"]:
        fleet = rank["fleet"]
        assert fleet["tokens"] == world["jax_pair"]
        assert fleet["ledger"] == [] and fleet["handoffs_moved"] == 2
        assert fleet["clock_broadcasts"] > 1
        sen = fleet["sentry"]
        assert sen["sentry_fetched"] == sen["sentry_budgeted"] == sen["host_syncs"]
        assert sen["sentry_budget_violations"] == 0
        assert fleet["fleet_sentry"] == sen["sentry_fetched"]  # one sentry, deduped
    r0, r1 = (r["fleet"] for r in world["ranks"])
    assert r0["clock_broadcasts"] == r1["clock_broadcasts"]


# -------------------------------------------------------------------- SLO

def _by_id(leg):
    return {rid: (reason, toks) for rid, reason, toks in leg["completions"]}


def test_tp_slo_preemption_matches_jax(world):
    """The class-1 request is swapped out for the class-0 one and back in;
    both finish with the JAX monolithic engine's greedy tokens, the
    class-0 request first."""
    for rank in world["ranks"]:
        slo = rank["slo"]
        assert slo["swaps_out"] == slo["swaps_in"] >= 1
        got = _by_id(slo)
        assert [got[i] for i in slo["ids"]] == [("length", t) for t in world["jax_slo"]]
        assert slo["completions"][0][0] == slo["ids"][1]


def test_tp_slo_victims_and_swaps_identical_across_ranks(world):
    r0, r1 = (r["slo"] for r in world["ranks"])
    assert r0["completions"] == r1["completions"]
    assert [rid for rid, _ in r0["swaps"]] == [rid for rid, _ in r1["swaps"]]
    assert [rid for rid, _ in r0["swaps"]] == [r0["ids"][0]] * r0["swaps_out"]
    # no swap-in failed, so no agreement was needed beyond one a swap-in
    assert r0["tp_stats"]["tp_swap_agreements"] == r0["swaps_in"]
    assert r0["tp_stats"]["tp_decision_broadcasts"] == 0  # no clock feature


def test_tp_slo_per_rank_budget_bytes_and_sentry(world):
    for rank in world["ranks"]:
        slo = rank["slo"]
        assert slo["host_syncs"] == slo["budget"]
        for (_, got), whole in zip(slo["swaps"], rank["slo_whole_swap_bytes"]):
            assert abs(got / whole - 0.5) <= 0.01, (got, whole)
        sen = slo["sentry"]
        assert sen["sentry_fetched"] == sen["sentry_budgeted"] == sen["host_syncs"]
        assert sen["sentry_budget_violations"] == 0 and sen["sentry_reuploads"] == 0


def test_rank_local_swap_in_failure_is_agreed(world):
    """Rank 1's swap-in raises; rank 0's succeeds. The MIN over the
    decision group fails it on both: the victim completes ``"error"`` with
    the tokens it earned before the swap on both ranks, the class-0
    request is served, and the engines stay in step."""
    r0, r1 = (r["slo_fail"] for r in world["ranks"])
    assert r0["completions"] == r1["completions"]
    got = _by_id(r0)
    lo, hi = r0["ids"]
    assert got[hi] == ("length", world["jax_slo"][1])
    reason, toks = got[lo]
    assert reason == "error" and 1 <= len(toks) < len(world["jax_slo"][0])
    assert toks == world["jax_slo"][0][:len(toks)]
    for r in (r0, r1):
        assert r["prefill_errors"] == 1 and r["swaps_in"] == 0
        assert r["tp_stats"]["tp_swap_agreements"] == 1


# ----------------------------------------------------------------- router

def test_router_decides_on_rank0s_clock(world):
    r0, r1 = (r["router_clock"] for r in world["ranks"])
    for key in ("completions", "states", "dispatches", "steps", "clock_broadcasts",
                "transitions"):
        assert r0[key] == r1[key], key
    assert r0["states"] == ["healthy", "healthy"] and r0["transitions"] == 0
    assert r0["clock_broadcasts"] == r0["steps"] + 1
    got = _by_id(r0)
    assert [got[g] for g in r0["gids"]] == [("length", t) for t in world["jax_router"]]


def test_router_without_clock_features_broadcasts_nothing(world):
    r0, r1 = (r["router_no_clock"] for r in world["ranks"])
    assert r0["clock_broadcasts"] == r1["clock_broadcasts"] == 0
    assert r0["completions"] == r1["completions"]
    got = _by_id(r0)
    assert [got[g] for g in r0["gids"]] == [("length", t) for t in world["jax_router"]]
