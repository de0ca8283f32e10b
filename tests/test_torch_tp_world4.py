"""Two tensor-parallel serving engines in one world: the decision groups of
a model group smaller than the world.

``new_group`` is collective over the whole world, so the port's engine
makes the CPU gloo decision groups of EVERY model group of the strategy's
mesh at construction, in mesh order, on every rank. One gloo world of 4
spawned ranks (``spawn_tp``; the rank body in
``tests/torch_tp_roles_worker.py``, no JAX) on ``{"data": 2, "model":
2}``: ranks {0, 1} and {2, 3} each serve their data rank's requests
(every other spec) through a TP engine of the toy float model of the JAX
``tests/test_tp_serve.py`` (``PRNGKey(0)``, converted through
``models/convert.py:from_jax_params``) with a default deadline (a clock
feature), the last request of each group carrying a deadline already past
when it is popped. Exact: the ranks of a group complete the same requests
with the same reasons and tokens; greedy tokens equal the port's
unsharded engine's; one broadcast a step a group, over that group's own
decision group (both groups made on every rank, a second engine over the
same group reusing it); host syncs the budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_roles_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)
SPECS = [(5, 10), (7, 8), (3, 9), (6, 7), (4, 6), (8, 5)]
DEADLINE_INDEX = 2  # each group's last request: queued behind 2 slots


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_world4")
    jcfg = jt.TransformerConfig(**CFG)
    params = jt.TransformerLM(jcfg).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 4), jnp.int32))["params"]
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           TransformerConfig(**CFG), device="cpu")
    torch.save(CFG, workdir / "cfg.pt")
    torch.save(port, workdir / "float.pt")
    rng = np.random.Generator(np.random.PCG64(9600))
    specs = [(rng.integers(0, CFG["vocab_size"], p).tolist(), m) for p, m in SPECS]
    ranks = spawn_tp(torch_tp_roles_worker.world4_cases, 4,
                     (str(workdir), specs, DEADLINE_INDEX),
                     backend="gloo", device="cpu", join_timeout_s=240)
    whole = {}
    for data_rank in (0, 1):
        eng = ServeEngine(TransformerLM(TransformerConfig(**CFG)), port, n_slots=2,
                          tokens_per_launch=4, device="cpu")
        mine = specs[data_rank::2]
        ids = [eng.submit(Request(prompt=p, max_new_tokens=m, seed=i))
               for i, (p, m) in enumerate(mine)]
        done = {c.request_id: c.tokens for c in eng.run_until_idle()}
        whole[data_rank] = [done[i] for i in ids]
    return {"ranks": sorted(ranks, key=lambda r: r["rank"]), "whole": whole}


def _groups(world):
    by = {}
    for r in world["ranks"]:
        by.setdefault(r["data_rank"], []).append(r)
    return by


def test_both_groups_made_on_every_rank(world):
    for r in world["ranks"]:
        assert r["groups_made"] == [(0, 1), (2, 3)]
        assert r["group_ranks"] == ([0, 1] if r["rank"] < 2 else [2, 3])
        assert r["src"] == (0 if r["rank"] < 2 else 2)
        assert r["shared_group"]


def test_ranks_identical_inside_each_group(world):
    for data_rank, rows in _groups(world).items():
        assert [r["model_rank"] for r in rows] == [0, 1]
        assert rows[0]["completions"] == rows[1]["completions"], data_rank
        assert rows[0]["steps"] == rows[1]["steps"]


def test_tokens_equal_the_unsharded_engine(world):
    for data_rank, rows in _groups(world).items():
        for r in rows:
            got = {rid: (reason, toks) for rid, reason, toks in r["completions"]}
            ids, want = r["ids"], world["whole"][data_rank]
            for i, rid in enumerate(ids):
                if i == DEADLINE_INDEX:
                    assert got[rid] == ("deadline", [])
                else:
                    assert got[rid] == ("length", want[i])
            assert r["fault_stats"]["deadline_expired"] == 1


def test_one_broadcast_a_step_per_group(world):
    for r in world["ranks"]:
        assert r["broadcasts"] == r["steps"] > 0
        assert r["host_syncs"] == r["budget"]
