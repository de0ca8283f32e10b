"""Tensor-parallel training in the PyTorch port, in a gloo world of 2
(``{"model": 2}``), against the port's unsharded model and the JAX
package's single-device train step.

A toy LM (vocab 128, d_model 64, 2 layers, 4 heads, S 32, batch 2,
float32, dense attention, ``remat_policy="dots"``) with weights drawn by
numpy (``tests/test_torch_train.py``'s recipe) and bridged through
``models/convert.py:from_jax_params``; each rank takes its shard. The
oracle is the JAX single-device step: the Megatron split is "an
implementation detail, not a model change" (``tests/test_tensor_parallel.py:84``,
whose own DP x TP arm drifts on this jax build and is not used).

Tolerances and why: the shards sum the same float32 products in other
groupings (half-K partials summed by ``g``, dh summed over vocab shards),
so the TP forward's logits are held to the unsharded port model's at
``atol 2e-5`` and every gradient to ``2e-5`` of its largest entry
(``tests/test_torch_train.py``'s float32 bounds); five ``Trainer`` steps
hold the JAX losses at ``rtol 1e-5`` and the final parameters within
``2e-6`` for 99.9% of the elements and ``2 * lr * steps`` for all (an
element whose gradient nearly cancels can take AdamW's ~lr step the
other way). Every rank's losses and replicated leaves (embedding, norms)
are the same bytes; the collectives are counted exactly: per step ``g``
3 a layer (2 forward, 1 more when the block's recompute under remat
stops after the o_proj sum: the down_proj sum lies past the last tensor
its backward reads), ``f`` 2 a layer (+1 before the head of the
materialized-logits loss, with one logits ``all_gather``), and the fused
loss's ``lse_max``, ``lse_sum`` and ``dh``. A planted ``f`` before the
fused head (dh summed twice) must miss the gradients.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

import torch_tp_train_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.train import trainer as jtrainer
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    spawn_tp,
)
from pytorch_distributed_training_tutorials_tpu_torch.train import trainer as ttrainer
from helpers import requires_pallas_interpret
from test_torch_train import batch_np, jax_float_tree, to_np

pytestmark = requires_pallas_interpret

SPEC = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=32, remat=True,
            remat_policy="dots")
STEPS = 5
LOSSES = ("cross_entropy", "fused_cross_entropy")
REPLICATED = ("tok_emb.weight", "final_norm.scale", "blocks.0.attn_norm.scale",
              "blocks.1.mlp_norm.scale")


def per_step(loss: str, layers: int, head: bool = True) -> dict:
    """The collectives of one forward and backward of the TP model."""
    base = {"all_reduce": 0, "all_gather": 0, "g": 3 * layers, "f": 2 * layers}
    if loss == "cross_entropy":
        return {**base, "f": 2 * layers + 1, "all_gather": 1}
    return {**base, "lse_max": 1, "lse_sum": 1, "dh": 1}


def jax_train(jcfg, tree, x, y, loss: str, steps: int):
    """``steps`` JAX single-device train steps on one batch: the losses
    and the final parameters."""
    state = jtrainer.TrainState.create(apply_fn=jt.TransformerLM(jcfg).apply, params=tree,
                                       tx=optax.adamw(torch_tp_train_worker.LR,
                                                      weight_decay=0.01))
    step = jax.jit(jtrainer._train_step_fn(loss))
    losses = []
    for _ in range(steps):
        state, m = step(state, (jax.numpy.asarray(x), jax.numpy.asarray(y)))
        losses.append(float(m["loss"]))
    return losses, to_np(state.params)


def unshard(ranks, name, whole_shape):
    """A parameter's whole tensor from its rank shards (concatenated on
    the split dimension) or, replicated, rank 0's."""
    parts = [r[name] for r in ranks]
    if tuple(parts[0].shape) == tuple(whole_shape):
        return parts[0]
    d = next(i for i, (a, b) in enumerate(zip(parts[0].shape, whole_shape)) if a != b)
    return torch.cat(parts, dim=d)


def assert_trained_like_jax(ranks, key, jax_run, cfg, loss, steps):
    jlosses, jparams = jax_run
    runs = [r[key] for r in ranks]
    np.testing.assert_allclose(runs[0]["losses"], jlosses, rtol=1e-5)
    assert runs[0]["losses"][-1] < runs[0]["losses"][0]
    want = from_jax_params(jparams, cfg, device="cpu")
    diffs = []
    first = [r[key]["params"] for r in ranks if r.get("data_rank", 0) == 0]  # one of each model rank
    for name, ref in want.items():
        got = unshard(first, name, ref.shape)
        diffs.append((got - ref).abs().reshape(-1).numpy())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * torch_tp_train_worker.LR * steps, diffs.max()
    assert np.mean(diffs <= 2e-6) >= 0.999, np.sort(diffs)[-20:]
    for r in runs:
        assert r["losses"] == runs[0]["losses"] and r["step"] == steps
        for name in REPLICATED:
            assert torch.equal(r["params"][name], runs[0]["params"][name]), name
        assert np.isfinite(r["eval"]["loss"]) and r["eval"] == runs[0]["eval"]


def assert_grads_close(got: dict, ref: dict, rank: int, tol: float = 2e-5):
    for name, g in got.items():
        r = ref[name]
        if g.shape != r.shape:
            d = next(i for i, (a, b) in enumerate(zip(g.shape, r.shape)) if a != b)
            r = r.narrow(d, rank * g.shape[d], g.shape[d])
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= tol * scale, name


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_train")
    jcfg = jt.TransformerConfig(**SPEC)
    tree = jax_float_tree(jcfg)
    cfg = TransformerConfig(**SPEC)
    whole = from_jax_params(to_np(tree), cfg, device="cpu")
    x, y = batch_np()
    torch.save({"spec": SPEC, "params": whole, "x": torch.tensor(x), "y": torch.tensor(y)},
               workdir / "train.pt")
    ranks = spawn_tp(torch_tp_train_worker.train_case, 2, (str(workdir), STEPS),
                     backend="gloo", device="cpu")
    ref = TransformerLM(cfg)
    bind_params(ref, whole)
    tx, ty = torch.tensor(x), torch.tensor(y)
    grads = {loss: torch_tp_train_worker._grads(ref, loss, tx, ty) for loss in LOSSES}
    with torch.no_grad():
        logits = ref(tx)
    jax_runs = {loss: jax_train(jcfg, tree, x, y, loss, STEPS) for loss in LOSSES}
    return {"ranks": ranks, "cfg": cfg, "grads": grads, "logits": logits, "jax": jax_runs}


def test_tp_forward_gathers_the_unsharded_logits(setup):
    ranks = setup["ranks"]
    for r in ranks:
        np.testing.assert_allclose(r["logits"].numpy(), setup["logits"].numpy(), atol=2e-5,
                                   rtol=0)
        assert torch.equal(r["logits"], ranks[0]["logits"])
        # a forward alone: the row sums and the logits' gather (f is the
        # identity forward, counted in its backward)
        assert r["forward_collectives"] == {"all_reduce": 0, "all_gather": 1,
                                            "g": 2 * SPEC["n_layers"]}


@pytest.mark.parametrize("loss", LOSSES)
def test_tp_gradients_match_unsharded(setup, loss):
    ref = setup["grads"][loss]
    ranks = setup["ranks"]
    for r in ranks:
        got = r[loss]
        assert float(got["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-6)
        assert torch.equal(got["loss"], ranks[0][loss]["loss"])
        assert_grads_close(got["grads"], ref["grads"], r["rank"])
        for name in REPLICATED:
            assert torch.equal(got["grads"][name], ranks[0][loss]["grads"][name]), name
        assert got["collectives"] == per_step(loss, SPEC["n_layers"])


def test_planted_double_dh_sum_is_caught(setup):
    """An ``f`` in front of the fused head sums dh a second time: the loss
    is untouched, the gradients below the head double and fail the
    gradient bound by far."""
    ref = setup["grads"]["fused_cross_entropy"]
    for r in setup["ranks"]:
        got = r["planted_double_dh"]
        assert torch.equal(got["loss"], r["fused_cross_entropy"]["loss"])
        with pytest.raises(AssertionError):
            assert_grads_close(got["grads"], ref["grads"], r["rank"])
        emb, want = got["grads"]["tok_emb.weight"], ref["grads"]["tok_emb.weight"]
        assert float((emb - 2 * want).abs().max()) <= 2e-5 * 2 * float(want.abs().max())


def test_skip_flag_is_the_model_groups_min(setup):
    """NaN in one shard gradient of rank 1 only: both ranks skip (the
    flag's MIN over the model group), their state bitwise unchanged."""
    for r in setup["ranks"]:
        f = r["flag"]
        assert (f["skipped"], f["step"], f["count"], f["unchanged"]) == (1, 0, 0, True)
        assert f["collectives"] == {"all_reduce": 0, "all_gather": 0, "flag_min": 1}


@pytest.mark.parametrize("loss", LOSSES)
def test_trainer_steps_match_jax_single_device(setup, loss):
    """``Trainer(strategy=TensorParallel(create_mesh({"model": 2})))``:
    five steps from the bridged weights against the JAX single-device
    step, the collectives exact."""
    ranks = setup["ranks"]
    assert_trained_like_jax(ranks, f"train_{loss}", setup["jax"][loss], setup["cfg"], loss,
                            STEPS)
    want = {k: v * STEPS for k, v in per_step(loss, SPEC["n_layers"]).items()}
    for r in ranks:
        assert r[f"train_{loss}"]["collectives"] == want


def test_trainer_refuses_what_tp_training_does_not_take():
    """A strategy other than the model's own, and checkpoints of a
    tensor-parallel state; a KV head count the group does not divide."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        TensorParallel,
    )

    class Two(TensorParallel):  # a two-rank strategy without a group: layout only
        def __init__(self):
            super().__init__()
            self.tp_size, self.rank = 2, 0

    cfg = TransformerConfig(**{**SPEC, "n_kv_heads": 1}, int8_mesh=Two())
    with pytest.raises(NotImplementedError, match="KV heads must split"):
        TransformerLM(cfg, device="cpu")(torch.zeros((1, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="differs"):
        ttrainer._tp_model(TransformerLM(dataclasses.replace(cfg, n_kv_heads=None)), Two())
