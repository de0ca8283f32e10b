"""Expert parallelism in the PyTorch port — ``TensorParallel(mesh,
ep_rules())`` on ``{"expert": 2}`` — in a gloo world of 2, against the JAX
package's single-device MoE step (EP is a layout, not a model:
``tests/test_moe.py``'s ``test_ep_matches_single_device``).

A toy MoE LM (vocab 128, d_model 64, 2 layers, 4 heads, 4 experts, top-2,
capacity 1.25, S 32, batch 2, float32, ``aux_loss_weight`` 0.01) with
weights drawn by numpy and bridged; each rank keeps experts ``[2r, 2r +
2)``. Tolerances and why:

- one step's objective ``rtol 1e-6`` and each gradient within ``2e-5`` of
  its largest entry (``tests/test_torch_train.py``'s float32 bounds: the
  partial expert outputs are summed in another grouping); the router's
  gradient on both ranks — its combine path summed over the group by
  Megatron's ``f`` on the combine scales, its aux path counted once — and
  each rank's expert block against the single-device step's; the same
  step with the aux loss counted twice (what an ``f`` on the gates would
  do) misses the router's bound;
- the dropped (token, choice) pairs of every layer equal the single-device
  model's count (routing runs whole on every rank);
- three ``Trainer`` steps: losses ``rtol 1e-5``, parameters within ``2e-6``
  for 99.9% of the elements and ``2 * lr * steps`` for all (tighter than
  ``tests/test_moe.py:161``'s ``rtol 1e-3``).
"""

import numpy as np
import pytest
import torch

import torch_sp_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
    moe_dropped,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp
from test_torch_seq_parallel import grads_gap, jax_grads, jax_steps, params_within
from test_torch_train import batch_np, jax_float_tree, to_np

SPEC = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=32,
            moe_experts=4, moe_top_k=2)
STEPS = 3
EXPERTS = ("w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("moe_ep")
    jcfg = jt.TransformerConfig(**SPEC)
    tree = jax_float_tree(jcfg)
    cfg = TransformerConfig(**SPEC)
    whole = from_jax_params(to_np(tree), cfg, device="cpu")
    x, y = batch_np()
    torch.save({"spec": SPEC, "params": whole, "x": torch.tensor(x), "y": torch.tensor(y)},
               workdir / "moe_ep.pt")
    ranks = spawn_tp(torch_sp_worker.moe_ep_case, 2, (str(workdir), STEPS), backend="gloo",
                     device="cpu")
    single = TransformerLM(cfg)
    bind_params(single, whole)
    with torch.no_grad():
        single(torch.tensor(x))
    jloss, jgrads = jax_grads(jcfg, tree, x, y, torch_sp_worker.AUX)
    return {"ranks": ranks, "cfg": cfg, "whole": whole,
            "dropped": [int(d) for d in moe_dropped(single)],
            "loss": jloss, "grads": from_jax_params(jgrads, cfg, device="cpu"),
            "jax": jax_steps(jcfg, tree, x, y, STEPS, torch_sp_worker.AUX)}


def _rank_block(t: torch.Tensor, name: str, r: int) -> torch.Tensor:
    """Rank ``r``'s entries of a whole tensor: its half of the experts."""
    if name.rsplit(".", 1)[-1] in EXPERTS:
        return t[2 * r:2 * r + 2]
    return t


def test_each_rank_holds_half_the_experts(setup):
    for r in setup["ranks"]:
        assert (r["ep_size"], r["ep_rank"]) == (2, r["ep_rank"])
        for n, shape in r["shapes"].items():
            want = tuple(_rank_block(setup["whole"][n], n, r["ep_rank"]).shape)
            assert shape == want, n
        assert r["shapes"]["blocks.0.moe.w_gate"] == (2, 64, 256)
        assert r["shapes"]["blocks.0.moe.router"] == (64, 4)


def test_ep_step_gradients_match_jax_single_device(setup):
    for r in setup["ranks"]:
        got = r["step"]
        assert float(got["loss"]) == pytest.approx(setup["loss"], rel=1e-6)
        want = {n: _rank_block(w, n, r["ep_rank"]) for n, w in setup["grads"].items()}
        assert grads_gap(got["grads"], want) <= 2e-5
        # per layer: g forward, f on x and on the combine scales backward
        assert got["collectives"] == {"all_reduce": 0, "all_gather": 0,
                                      "g": SPEC["n_layers"], "f": 2 * SPEC["n_layers"]}
        routers = {n: w for n, w in want.items() if n.endswith("moe.router")}
        planted = r["planted_aux_twice"]["grads"]
        assert grads_gap(planted, routers) > 10 * 2e-5


def test_dropped_tokens_equal_single_device(setup):
    assert sum(setup["dropped"]) > 0  # capacity 1.25 at random routing drops some
    for r in setup["ranks"]:
        assert r["dropped"] == setup["dropped"]


def test_ep_trainer_steps_match_jax_single_device(setup):
    jlosses, jparams = setup["jax"]
    want = from_jax_params(jparams, setup["cfg"], device="cpu")
    runs = setup["ranks"]
    np.testing.assert_allclose(runs[0]["train"]["losses"], jlosses, rtol=1e-5)
    for r in runs:
        t = r["train"]
        assert t["losses"] == runs[0]["train"]["losses"] and t["step"] == STEPS
        params_within(t["params"], {n: _rank_block(w, n, r["ep_rank"]) for n, w in want.items()},
                      STEPS)
        for n, p in t["params"].items():
            if n.rsplit(".", 1)[-1] not in EXPERTS:
                assert torch.equal(p, runs[0]["train"]["params"][n]), n
        assert np.isfinite(t["eval"]["loss"])
