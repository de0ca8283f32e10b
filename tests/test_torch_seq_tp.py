"""Sequence x tensor parallelism in the PyTorch port — the ``tp_sp`` mode
of the JAX package's ``examples/train_llm_3d.py`` — in a gloo world of 4
(``{"seq": 2, "model": 2}``): ring attention over each rank's heads,
``TensorParallel(mesh, TP_RULES, seq_axis="seq")`` and ``batch_spec=("data",
"seq")``, three ``Trainer`` steps against the JAX single-device step.

Tolerances (``tests/test_torch_tp_train.py``'s, for the same reasons: the
shards and the sequence blocks sum the same float32 products in other
groupings): losses ``rtol 1e-5``; the unsharded parameters within ``2e-6``
for 99.9% of the elements and ``2 * lr * steps`` for all. The two seq
ranks of a model coordinate hold the same bytes; every rank the same
losses.
"""

import numpy as np
import pytest
import torch

import torch_sp_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerConfig, from_jax_params
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp
from test_torch_seq_parallel import SPEC, jax_steps, params_within
from test_torch_tp_train import unshard
from test_torch_train import batch_np, jax_float_tree, to_np

STEPS = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("seq_tp")
    jcfg = jt.TransformerConfig(**SPEC)
    tree = jax_float_tree(jcfg)
    cfg = TransformerConfig(**SPEC)
    whole = from_jax_params(to_np(tree), cfg, device="cpu")
    x, y = batch_np()
    torch.save({"spec": SPEC, "params": whole, "x": torch.tensor(x), "y": torch.tensor(y)},
               workdir / "seq_tp.pt")
    ranks = spawn_tp(torch_sp_worker.seq_tp_case, 4, (str(workdir), STEPS), backend="gloo",
                     device="cpu")
    return {"ranks": ranks, "cfg": cfg, "x": x, "jax": jax_steps(jcfg, tree, x, y, STEPS)}


def test_mesh_puts_the_model_axis_innermost(setup):
    for r in setup["ranks"]:
        assert (r["seq_rank"], r["model_rank"]) == divmod(r["rank"], 2)
        assert r["mesh_shape"] == {"seq": 2, "model": 2}


def test_tp_sp_trainer_steps_match_jax_single_device(setup):
    ranks = setup["ranks"]
    jlosses, jparams = setup["jax"]
    np.testing.assert_allclose(ranks[0]["losses"], jlosses, rtol=1e-5)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    want = from_jax_params(jparams, setup["cfg"], device="cpu")
    first = [r["params"] for r in ranks if r["seq_rank"] == 0]  # model ranks 0, 1
    params_within({n: unshard(first, n, w.shape) for n, w in want.items()}, want, STEPS)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"] and r["step"] == STEPS
        twin = next(o for o in ranks if o["model_rank"] == r["model_rank"])
        for n, p in r["params"].items():
            assert torch.equal(p, twin["params"][n]), n
        assert r["collectives"]["seq_all_reduce"] == STEPS
        # a hop a layer forward (the evaluation's too), its transpose back
        layers = SPEC["n_layers"]
        assert r["attention_collectives"] == {"ring_hop": layers * (STEPS + 1),
                                              "ring_hop_grad": layers * STEPS}
        assert np.isfinite(r["eval"]["loss"]) and r["eval"]["samples"] == setup["x"].size
