"""The single-program pipeline over ranks in the PyTorch port —
``PipelinedTransformerLM`` and ``PipelineParallel`` on
``create_mesh({"data": 1, "stage": 2}, stage_ranks=True)`` — in a gloo
world of 2, against the JAX package's ``PipelinedTransformerLM`` on a
``{"data": 1, "stage": 2}`` mesh of the CPU devices and its single-device
train step.

A toy LM (vocab 128, d_model 64, 4 layers — 2 a stage — 4 heads, S 32,
batch 4, float32) with weights drawn by numpy in the stacked
``layers/block`` layout the JAX pipeline reads. Tolerances and why:

- logits ``atol 2e-5`` against the JAX pipeline (its own test's bound
  against the unpipelined model, ``tests/test_gpipe.py``), and at M 1 and
  4 against M 2: the schedule reorders rows, not arithmetic;
- gradients ``rtol 1e-4, atol 1e-6`` elementwise (``tests/test_gpipe.py``'s
  bound): a stage's block leaves on its rank, the head and final norm
  whole on every stage, the embedding's whole on stage 0 and an exact 0
  on stage 1 until the strategy's stage sum, after which both hold stage
  0's bytes;
- three ``Trainer`` steps: losses ``rtol 1e-5``, parameters within
  ``2e-6`` for 99.9% of the elements and ``2 * lr * steps`` for all
  (``tests/test_torch_train.py``'s float32 bounds); the stages' losses
  and replicated leaves the same bytes.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_sp_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.parallel.pipeline_spmd import (
    PipelinedTransformerLM as JaxPipelined,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerConfig, from_jax_params
from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
    PipelinedTransformerLM,
    PipelineParallel,
    StageMesh,
    create_mesh,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.pipeline_spmd import (
    expected_messages,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp
from test_torch_seq_parallel import jax_steps, params_within
from test_torch_train import jax_float_tree, to_np

SPEC = dict(vocab_size=128, d_model=64, n_layers=4, n_heads=4, max_seq_len=32)
BATCH, SEQ, STEPS = 4, 32, 3
REPLICATED = ("tok_emb.weight", "final_norm.scale", "lm_head.weight")


def _batch():
    rng = np.random.Generator(np.random.PCG64(7))
    toks = rng.integers(0, SPEC["vocab_size"], (BATCH, SEQ + 1))
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def setup(tmp_path_factory, devices):
    workdir = tmp_path_factory.mktemp("pipeline")
    jcfg = jt.TransformerConfig(**SPEC, scan_layers=True)
    tree = jax_float_tree(jcfg)
    cfg = TransformerConfig(**SPEC)
    whole = from_jax_params(to_np(tree), cfg, device="cpu")
    x, y = _batch()
    torch.save({"spec": SPEC, "params": whole, "x": torch.tensor(x), "y": torch.tensor(y)},
               workdir / "pipeline.pt")
    ranks = spawn_tp(torch_sp_worker.pipeline_case, 2, (str(workdir), STEPS), backend="gloo",
                     device="cpu")
    pipe = JaxPipelined(jcfg, jax_mesh({"data": 1, "stage": 2}, devices=devices[:2]),
                        num_microbatches=2)
    xs, ys = jnp.asarray(x), jnp.asarray(y)

    def loss(params):
        logits = pipe.apply({"params": params}, xs)
        return optax.softmax_cross_entropy_with_integer_labels(logits, ys).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(tree)
    return {"ranks": ranks, "cfg": cfg,
            "logits": np.asarray(jax.jit(pipe.apply)({"params": tree}, xs)),
            "loss": float(jloss), "grads": from_jax_params(to_np(jgrads), cfg, device="cpu"),
            "jax": jax_steps(jcfg, tree, x, y, STEPS)}


def test_each_stage_holds_its_layers(setup):
    for r in setup["ranks"]:
        assert r["layers"] == [2 * r["stage"], 2 * r["stage"] + 1]
        blocks = {n.split(".")[1] for n in r["grads"]["grads"] if n.startswith("blocks.")}
        assert blocks == {str(i) for i in r["layers"]}


def test_logits_match_the_jax_pipeline_at_every_microbatch_count(setup):
    for r in setup["ranks"]:
        np.testing.assert_allclose(r["logits"][2].numpy(), setup["logits"], atol=2e-5, rtol=0)
        for m in (1, 4):
            np.testing.assert_allclose(r["logits"][m].numpy(), r["logits"][2].numpy(),
                                       atol=2e-5, rtol=0)
        assert torch.equal(r["logits"][2], setup["ranks"][0]["logits"][2])


def test_gradients_match_the_jax_pipeline(setup):
    want = setup["grads"]
    for r in setup["ranks"]:
        got = r["grads"]
        assert float(got["loss"]) == pytest.approx(setup["loss"], rel=1e-6)
        for n, g in got["grads"].items():
            if n == "tok_emb.weight" and r["stage"] == 1:
                assert not g.any()  # the hop's input: an exact 0 before the stage sum
                continue
            np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=n)
        # after the strategy's sync every stage holds stage 0's embedding
        # gradient, and the others untouched (a data axis of one)
        for n in REPLICATED:
            assert torch.equal(r["synced"][n], setup["ranks"][0]["grads"]["grads"][n]), n
        assert r["sync_collectives"] == {"stage_sum": 1}


def test_messages_follow_the_schedule(setup):
    for r in setup["ranks"]:
        assert r["messages"] == r["expected_messages"] == expected_messages(r["stage"], 2, 2)
    assert expected_messages(1, 3, 4) == {"send": 8, "recv": 8, "broadcast": 1}
    assert expected_messages(0, 1, 4) == {}


def test_pipeline_parallel_trainer_steps_match_jax_single_device(setup):
    jlosses, jparams = setup["jax"]
    want = from_jax_params(jparams, setup["cfg"], device="cpu")
    runs = [r["train"] for r in setup["ranks"]]
    np.testing.assert_allclose(runs[0]["losses"], jlosses, rtol=1e-5)
    assert runs[0]["losses"][-1] < runs[0]["losses"][0]
    got = {}
    for r in runs:
        got.update(r["params"])
        assert r["losses"] == runs[0]["losses"] and r["step"] == STEPS
        for n in REPLICATED:
            assert torch.equal(r["params"][n], runs[0]["params"][n]), n
        assert np.isfinite(r["eval"]["loss"]) and r["eval"] == runs[0]["eval"]
    assert set(got) == set(want)
    params_within(got, want, STEPS)


def test_bad_configs_are_refused(setup):
    want = ("not divisible by 2 pipeline stages", "dense blocks only",
            "batch 3 not divisible by 4 microbatches", "exceeds max_seq_len")
    for r in setup["ranks"]:
        assert all(w in got for w, got in zip(want, r["refusals"])), r["refusals"]


def test_mesh_layout_is_explicit():
    """The in-process StageMesh keeps its meaning; stage_ranks=True asks
    for a stage a rank (here a world of one: one stage); neither is
    guessed, and the two do not combine."""
    assert isinstance(create_mesh({"stage": 1}, device="cpu", stage_devices=["cpu"]), StageMesh)
    mesh = create_mesh({"data": 1, "stage": 1}, device="cpu", stage_ranks=True)
    assert mesh.mesh_dim_names == ("data", "stage")
    strategy = PipelineParallel(mesh)
    assert (strategy.num_devices, strategy.num_stages) == (1, 1)
    with pytest.raises(ValueError, match="stage_devices"):
        create_mesh({"stage": 2}, device="cpu")
    with pytest.raises(ValueError, match="stage_ranks=True puts one stage"):
        create_mesh({"stage": 1}, device="cpu", stage_ranks=True, stage_devices=["cpu"])
    with pytest.raises(ValueError, match="world of 1"):
        create_mesh({"stage": 2}, device="cpu", stage_ranks=True)
    for axis in ("seq", "model", "expert"):
        with pytest.raises(NotImplementedError, match=f"stage axis beside a {axis} axis"):
            create_mesh({"stage": 1, axis: 1}, device="cpu", stage_ranks=True)
    with pytest.raises(ValueError, match="dense blocks only"):
        PipelinedTransformerLM(TransformerConfig(**SPEC, moe_experts=2), mesh,
                               num_microbatches=1)
    one = PipelinedTransformerLM(TransformerConfig(**SPEC), mesh, num_microbatches=1)
    with pytest.raises(ValueError, match="beside a model of 1 microbatches"):
        PipelineParallel(mesh, num_microbatches=2).shard_state(types.SimpleNamespace(model=one))
