"""The port's ``HybridFSDP`` (``parallel/fsdp.py``): tensor-parallel rules
over ``model`` and FSDP over ``data``, in a gloo world of 4 (``{"data":
2, "model": 2}``, the model axis inner) on the CPU.

The toy LM of ``tests/test_torch_tp_train.py`` (vocab 128, d_model 64,
d_ff 256, 2 layers, 4 heads, S 32, float32, remat "dots"), weights drawn
by numpy and bridged through ``models/convert.py:from_jax_params``, at
``min_size`` 256:

- every leaf's placement, in flax's dimension order, equals the JAX
  ``HybridFSDP`` spec for the same path on a ``{"data": 2, "model": 2}``
  mesh; ``gate_proj``'s kernel (64, 256) is ``("data", "model")`` and the
  rank holds a (32, 128) block of it and of AdamW's first moment (the JAX
  ``test_hybrid_fsdp_tp_2d_sharding``, there at data 4: (16, 128));
- three ``Trainer`` steps against the JAX single-device step (the JAX
  DP x TP pin is ``xfail`` on this jax build, so the single-device step is
  the oracle, as for the TP tests): ``test_torch_tp_train``'s bounds —
  losses ``rtol 1e-5``, parameters within ``2e-6`` for 99.9% of the
  elements and ``2 * lr * steps`` for all, every rank's losses and
  replicated leaves the same bytes; each step gathers what it shards;
- ``chip_smoke.py``'s table of placements at its ``train_lm_hybrid_fsdp``
  config (the 760m widths, 2 layers, ``min_size`` 1024), which the card
  holds the port to, equals the JAX ``HybridFSDP`` spec there and the
  port's plan.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_strategy_worker
from pytorch_distributed_training_tutorials_tpu.models import TP_RULES as JTP_RULES
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.parallel.fsdp import HybridFSDP as JHybridFSDP
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.utils.tree import keystr
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.convert import _BLOCK_LEAVES
from pytorch_distributed_training_tutorials_tpu_torch.parallel.fsdp import TENSOR_ROUTE
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp
from helpers import requires_pallas_interpret
from test_torch_tp_train import SPEC, assert_trained_like_jax, jax_train
from test_torch_train import jax_float_tree, to_np

pytestmark = requires_pallas_interpret

STEPS, MIN_SIZE, BATCH = 3, 256, 4
REPO = Path(__file__).resolve().parents[1]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_hybrid_specs(jcfg, mesh, **kw) -> dict:
    """flax path -> (shape, spec) of every parameter under the JAX
    ``HybridFSDP(mesh, TP_RULES)``, from abstract shapes."""
    import jax
    import jax.numpy as jnp

    abstract = jax.eval_shape(jt.TransformerLM(jcfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 4), jnp.int32))
    shardings = JHybridFSDP(mesh, JTP_RULES, **kw).variable_shardings(abstract)
    specs = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, s, a: specs.__setitem__(keystr(kp), (tuple(a.shape), tuple(s.spec))),
        shardings["params"], abstract["params"])
    return specs


def flax_key(name: str) -> str:
    """A port parameter name -> its flax path."""
    parts = name.split(".")
    leaf = {"weight": "kernel", "scale": "scale"}[parts[-1]]
    if parts[0] == "blocks":
        return "/".join([f"block_{parts[1]}", *_BLOCK_LEAVES[".".join(parts[2:-1])], leaf])
    if parts[0] == "tok_emb":
        return "tok_emb/embedding"
    return f"{parts[0]}/{leaf}"


@pytest.fixture(scope="module")
def setup(devices, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("hybrid_fsdp")
    jcfg = jt.TransformerConfig(**SPEC)
    tree = jax_float_tree(jcfg)
    cfg = TransformerConfig(**SPEC)
    rng = np.random.Generator(np.random.PCG64(5))
    toks = rng.integers(0, SPEC["vocab_size"], (BATCH, SPEC["max_seq_len"] + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    chip = chip_smoke()
    chip_cfg = {k: v for k, v in chip.HYBRID_CFG.items() if k not in ("remat", "remat_policy")}
    torch.save({"spec": SPEC, "min_size": MIN_SIZE, "chip_cfg": chip_cfg,
                "params": from_jax_params(to_np(tree), cfg, device="cpu"),
                "x": torch.tensor(x), "y": torch.tensor(y)}, workdir / "hybrid.pt")
    ranks = spawn_tp(torch_strategy_worker.hybrid_case, 4, (str(workdir), STEPS),
                     backend="gloo", device="cpu")
    mesh = jax_mesh({"data": 2, "model": 2}, devices=devices[:4])
    return {"ranks": ranks, "cfg": cfg, "chip": chip,
            "specs": jax_hybrid_specs(jcfg, mesh, min_size=MIN_SIZE),
            "chip_specs": jax_hybrid_specs(jt.TransformerConfig(**chip_cfg), mesh),
            "jax": jax_train(jcfg, tree, x, y, "cross_entropy", STEPS)}


def test_every_leaf_is_placed_as_the_jax_hybrid_spec(setup):
    specs = setup["specs"]
    for r in setup["ranks"]:
        assert set(map(flax_key, r["plans"])) == set(specs)
        for name, plan in r["plans"].items():
            assert (plan.flax_shape, plan.spec) == specs[flax_key(name)], name
        assert r["route"] == TENSOR_ROUTE


def test_gate_proj_is_sharded_on_both_axes(setup):
    for r in setup["ranks"]:
        gate = r["plans"]["blocks.0.mlp.gate_proj.weight"]
        assert (gate.flax_shape, gate.spec, gate.dim) == ((64, 256), ("data", "model"), 0)
        assert r["gate_shard"] == r["gate_moment"] == (64 // 2, 256 // 2)
        assert any("blocks.0.mlp.gate_proj.weight: (64, 256) -> ('data', 'model')" == ln
                   for ln in r["audit"])
    assert [(r["data_rank"], r["rank"]) for r in setup["ranks"]] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


def test_variable_shardings_name_both_axes_and_spec_for_refuses(setup):
    from torch.distributed.tensor import Replicate, Shard

    for r in setup["ranks"]:
        vs = r["variable_shardings"]  # (data, model) placements in the port's dimensions
        assert vs["blocks.0.mlp.gate_proj.weight"] == (Shard(0), Shard(1))
        assert vs["blocks.0.mlp.down_proj.weight"] == (Shard(1), Shard(0))
        assert vs["blocks.0.attn.o_proj.weight"] == (Shard(1), Shard(0))
        assert vs["blocks.0.attn_norm.scale"] == (Replicate(), Replicate())
        assert "name" in r["spec_for"]


def test_trainer_steps_match_jax_single_device(setup):
    ranks = setup["ranks"]
    assert_trained_like_jax(ranks, "train", setup["jax"], setup["cfg"], "cross_entropy", STEPS)
    sharded = sum(p.dim is not None for p in ranks[0]["plans"].values())
    for r in ranks:
        c = r["fsdp_collectives"]
        # every sharded leaf gathered at least once a step and its
        # gradient reduce-scattered once a step (remat "dots" gathers the
        # recomputed blocks' weights again)
        assert c["reduce_scatter_tensor"] == sharded * STEPS
        assert c["all_gather_into_tensor"] >= sharded * STEPS
        assert c["data_all_reduce"] == STEPS


def test_chip_smoke_table_is_the_jax_hybrid_spec(setup):
    table, specs = setup["chip"].HYBRID_SPECS, setup["chip_specs"]
    assert set(map(flax_key, table)) == set(specs)
    for name, placement in table.items():
        assert placement == specs[flax_key(name)], name
    for r in setup["ranks"]:
        assert {n: (p.flax_shape, p.spec) for n, p in r["chip_plans"].items()} == table
