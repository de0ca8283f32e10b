"""Deadlines, cancel and chaos stalls under tensor-parallel serving in the
PyTorch port: rank 0 decides, every rank applies.

The JAX engine's tensor parallelism is one process, so its deadlines,
cancels and stalls need no agreement; the port's ranks each run the host
loop, and a rank that decided otherwise would hang its peers in a
collective. One gloo world of 2 spawned ranks (``spawn_tp`` with a hard
join timeout; the rank body in ``tests/torch_tp_deadline_worker.py``, no
JAX) serves one stream — four requests on 2 slots, chains of 4 — over the
toy float model of the JAX ``tests/test_tp_serve.py`` (``PRNGKey(0)``,
converted through ``models/convert.py:from_jax_params``) in four legs:

- ``off``: no clock feature. No broadcast; the tokens are the JAX
  engine's; host syncs the budget;
- ``deadline``: requests 1 (decoding) and 3 (queued) carry 1 s deadlines
  and chain 1 stalls 2 s on rank 0 only: both complete ``"deadline"`` on
  both ranks (1 with a prefix of its tokens, 3 with none), the others
  equal the ``off`` leg;
- ``cancel``: a ``cancellable`` engine; after step 2 every rank calls
  ``cancel`` on requests 0 (decoding) and 3 (queued) — rank 0's call
  records the cancel, the other's only reports the id known;
- ``stall``: a 0.5 s stall on rank 0 alone, tokens equal the ``off``
  leg's.

Every leg ends with identical completions (ids, reasons, tokens) on both
ranks; with a feature on, one broadcast a step, none with every feature
off; the counted model-group collectives equal across legs (the
broadcasts ride their own gloo group). ``role=``, ``priority_classes``
and ``sentry=`` construct under tensor parallelism (their streams are
``tests/test_torch_tp_roles_slo.py``'s), and a ``cancel`` on an engine
that is not ``cancellable`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_deadline_worker
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
SPECS = [(5, 24), (7, 24), (3, 20), (6, 10)]
LEGS = {
    "off": {},
    "deadline": {"deadlines": {1: 1.0, 3: 1.0}, "chaos": {"stall_chain": 1, "stall_s": 2.0}},
    "cancel": {"engine": {"cancellable": True}, "cancel": [0, 3]},
    "stall": {"chaos": {"stall_chain": 1, "stall_s": 0.5}},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_deadlines")
    jcfg = jt.TransformerConfig(**CFG)
    jmodel = jt.TransformerLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           TransformerConfig(**CFG), device="cpu")
    torch.save(CFG, workdir / "cfg.pt")
    torch.save(port, workdir / "float.pt")
    rng = np.random.Generator(np.random.PCG64(8200))
    reqs = [(rng.integers(0, CFG["vocab_size"], p).tolist(), m) for p, m in SPECS]
    ranks = spawn_tp(torch_tp_deadline_worker.deadline_cases, 2, (str(workdir), reqs, LEGS),
                     backend="gloo", device="cpu", join_timeout_s=180)
    jeng = JaxServeEngine(jmodel, params, n_slots=2, tokens_per_launch=4)
    ids = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=m, seed=i))
           for i, (p, m) in enumerate(reqs)]
    done = {c.request_id: c.tokens for c in jeng.run_until_idle()}
    return {"ranks": ranks, "jax": [done[i] for i in ids]}


def _by_id(leg):
    return {rid: (reason, toks) for rid, reason, toks in leg["completions"]}


@pytest.mark.parametrize("name", list(LEGS))
def test_ranks_agree_on_every_leg(world, name):
    """Both ranks complete the same requests, in the same order, with the
    same reasons and tokens, and count the same broadcasts and steps."""
    r0, r1 = (rank[name] for rank in world["ranks"])
    assert r0["completions"] == r1["completions"]
    assert len(r0["completions"]) == len(SPECS)
    assert (r0["steps"], r0["broadcasts"]) == (r1["steps"], r1["broadcasts"])
    for r in (r0, r1):
        assert r["tp_stats"]["tp_decision_broadcasts"] == r["broadcasts"]
        assert r["host_syncs"] == r["budget"]


def test_off_leg_broadcasts_nothing_and_matches_jax(world):
    for rank in world["ranks"]:
        off = rank["off"]
        assert off["broadcasts"] == 0
        got = _by_id(off)
        assert [got[i] for i in off["ids"]] == [("length", t) for t in world["jax"]]


def test_one_broadcast_a_step_with_a_feature_on(world):
    for rank in world["ranks"]:
        for name in ("deadline", "cancel", "stall"):
            assert rank[name]["broadcasts"] == rank[name]["steps"] > 0


def test_deadline_leg_rank0_decides(world):
    """The stall sleeps on rank 0 only; its clock expires both victims,
    and every rank completes them ``"deadline"``: the decoding one with a
    prefix of its tokens, the queued one with none."""
    full = world["jax"]
    for r, rank in enumerate(world["ranks"]):
        leg = rank["deadline"]
        got = _by_id(leg)
        ids = leg["ids"]
        assert got[ids[1]][0] == "deadline" and got[ids[3]] == ("deadline", [])
        toks = got[ids[1]][1]
        assert 1 <= len(toks) < len(full[1]) and toks == full[1][:len(toks)]
        assert got[ids[0]] == ("length", full[0]) and got[ids[2]] == ("length", full[2])
        assert leg["fault_stats"]["deadline_expired"] == 2
        assert leg["stall_events"] == (1 if r == 0 else 0)


def test_cancel_on_rank0_only(world):
    """Every rank calls ``cancel`` after step 2 and learns the ids are
    known; only rank 0 records them, its broadcast cancels both on both
    ranks, and nothing is left pending."""
    full = world["jax"]
    for r, rank in enumerate(world["ranks"]):
        leg = rank["cancel"]
        ids = leg["ids"]
        assert leg["known"] == [True, True]
        assert leg["cancel_recorded"] == ([ids[0], ids[3]] if r == 0 else [])
        assert leg["cancelled_left"] == []
        got = _by_id(leg)
        assert got[ids[3]] == ("cancelled", [])
        reason, toks = got[ids[0]]
        assert reason == "cancelled" and 1 <= len(toks) < len(full[0])
        assert toks == full[0][:len(toks)]
        assert leg["fault_stats"]["cancelled"] == 2


def test_stall_leg_serves_the_stream(world):
    for r, rank in enumerate(world["ranks"]):
        assert rank["stall"]["completions"] == rank["off"]["completions"]
        assert rank["stall"]["stall_events"] == (1 if r == 0 else 0)


def test_model_collectives_unchanged_by_the_broadcasts(world):
    """The model group's counted collectives of the same stream are
    equal with the broadcasts on and off: the decisions ride their own
    gloo group, and the decode forwards issue ``expected_collectives``."""
    for rank in world["ranks"]:
        assert rank["stall"]["collectives"] == rank["off"]["collectives"]
        assert rank["stall"]["n_chains"] == rank["off"]["n_chains"]


def test_what_stays_refused_under_tp(world):
    """``role=``, ``priority_classes`` and ``sentry=`` were refused under
    tensor parallelism until they were ported: each now constructs a TP
    engine with its stats part on; a ``cancel`` on an engine that is not
    ``cancellable`` still raises."""
    for rank in world["ranks"]:
        made = rank["refused"]
        assert all(isinstance(made[name], dict) for name in made), made
        assert made["role"]["role"] == "prefill" and made["role"]["tp"] == 2
        assert made["role_decode"]["role"] == "decode"
        assert made["priority_classes"]["priority_classes"] == 2
        assert made["priority_classes"]["tp_swap_agreements"] == 0
        assert made["sentry"]["sentry"] == 1
        assert "cancellable=True" in rank["not_cancellable"]
