"""The port's ``FSDP`` (``parallel/fsdp.py``) against the JAX package's,
in a gloo world of 2 (``{"data": 2}``) on the CPU.

- ``shard_dim_for``: every case of the JAX ``test_shard_dim_prefers_largest_divisible``;
- placement: every parameter's sharded logical dimension — its dimension
  in flax's layout, where the JAX rule picks — equals the JAX ``FSDP``
  spec for the same flax path on a ``{"data": 2}`` mesh: an MLP whose
  middle kernel is (64, 64) (the tie goes to flax's dimension 0, the
  port's ``Linear`` dimension 1) and a ResNet-18 (HWIO convs, (3, 3, 64,
  64) ties), and the rank holds exactly that shard of the parameter and
  of AdamW's moments;
- numbers: 4 Adam steps of ``MLP(features=(64, 4))`` on the JAX test's
  batch against the JAX data-parallel step on the same global batch at
  ``rtol 1e-5`` (losses) and ``rtol 1e-5 / atol 1e-6`` (parameters), the
  JAX ``test_fsdp_numerics_match_data_parallel`` bounds (the global mean
  does not depend on the mesh width); the port's own ``DataParallel`` in
  the same world within the same bounds; a planted fault that drops the
  gradient's reduce-scatter (each rank keeps its own block) must miss;
- the collectives a step, the skip flag's agreement, ``Trainer(strategy=
  FSDP)`` converging and staying sharded, the audit lines and a
  checkpoint's round trip.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import torch_strategy_worker
from helpers import make_cls_dataset
from pytorch_distributed_training_tutorials_tpu.models import MLP as JMLP
from pytorch_distributed_training_tutorials_tpu.models import resnet as jr
from pytorch_distributed_training_tutorials_tpu.parallel import DataParallel as JDataParallel
from pytorch_distributed_training_tutorials_tpu.parallel.fsdp import FSDP as JFSDP
from pytorch_distributed_training_tutorials_tpu.parallel.fsdp import (
    shard_dim_for as jshard_dim_for,
)
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.train.trainer import (
    create_train_state,
    make_train_step,
)
from pytorch_distributed_training_tutorials_tpu.utils.tree import keystr
from pytorch_distributed_training_tutorials_tpu_torch.models import MLP, from_jax_params
from pytorch_distributed_training_tutorials_tpu_torch.models.convert import _flax_path
from pytorch_distributed_training_tutorials_tpu_torch.parallel import shard_dim_for
from pytorch_distributed_training_tutorials_tpu_torch.parallel.fsdp import STAGED_ROUTE, TENSOR_ROUTE
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp

STEPS = 4


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_specs(model, x, mesh, **kw) -> dict:
    """flax path -> (shape, spec as a tuple) of every parameter under the
    JAX ``FSDP``."""
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    shardings = JFSDP(mesh, **kw).variable_shardings(abstract)["params"]
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, s, a: out.__setitem__(keystr(kp), (tuple(a.shape), tuple(s.spec))),
        shardings, abstract["params"])
    return out


def flax_key(port_name: str) -> str:
    *mods, leaf = port_name.split(".")
    return "/".join([*_flax_path(mods), "kernel" if leaf == "weight" else leaf])


def jax_dp_run(x, y, params_mesh) -> tuple:
    model = JMLP(features=(64, 4))
    strategy = JDataParallel(params_mesh)
    state = create_train_state(model, optax.adam(1e-3), x, strategy=strategy, seed=0)
    start = to_np(state.params)
    step = make_train_step(loss="cross_entropy")
    losses = []
    for _ in range(STEPS):
        state, m = step(state, (strategy.shard_batch(x), strategy.shard_batch(y)))
        losses.append(float(m["loss"]))
    return start, losses, to_np(jax.device_get(state.params))


@pytest.fixture(scope="module")
def setup(devices, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("fsdp")
    mesh = jax_mesh({"data": 2}, devices=devices[:2])
    ds = make_cls_dataset(n=128, dim=16)
    x, y = ds.arrays[0][:32], ds.arrays[1][:32]
    start, losses, stepped = jax_dp_run(x, y, mesh)
    mlp3 = JMLP(features=(64, 64, 4))
    mlp3_params = to_np(mlp3.init(jax.random.PRNGKey(1), x)["params"])
    train = make_cls_dataset(n=512)
    torch.save({
        "x": torch.tensor(x), "y": torch.tensor(y),
        "mlp2": from_jax_params(start, MLP(features=(64, 4), in_dim=16), "cpu"),
        "mlp3": from_jax_params(mlp3_params, MLP(features=(64, 64, 4), in_dim=16), "cpu"),
        "train_x": torch.tensor(train.arrays[0]), "train_y": torch.tensor(train.arrays[1]),
    }, workdir / "fsdp.pt")
    ranks = spawn_tp(torch_strategy_worker.fsdp_case, 2, (str(workdir), STEPS),
                     backend="gloo", device="cpu")
    specs = {
        "mlp3": jax_specs(mlp3, x, mesh, min_size=64),
        "resnet18": jax_specs(jr.resnet18(num_classes=10, stem="cifar", num_filters=16),
                              np.zeros((1, 28, 28, 1), np.float32), mesh),
    }
    return {"ranks": ranks, "jax": (losses, stepped), "specs": specs}


@pytest.mark.parametrize("shape, world, min_size, want", [
    ((16, 64), 8, 1, 1),  # largest divisible dim wins
    ((64, 16), 8, 1, 0),
    ((64, 64), 8, 1, 0),  # tie -> earliest
    ((7, 9), 8, 1, None),  # nothing divides
    ((8,), 8, 1024, None),  # below min_size
    ((), 8, 1, None),  # scalar
])
def test_shard_dim_prefers_largest_divisible(shape, world, min_size, want):
    assert shard_dim_for(shape, world, min_size) == jshard_dim_for(shape, world, min_size) == want


def test_exclude_skips_claimed_dims():
    for shape, exclude in (((64, 256), (1,)), ((64, 4, 16), (1,)), ((32, 32), (0,))):
        assert shard_dim_for(shape, 2, 1, exclude) == jshard_dim_for(shape, 2, 1, exclude)


@pytest.mark.parametrize("model", ["mlp3", "resnet18"])
def test_every_leaf_is_placed_as_the_jax_spec(setup, model):
    jax_specs = setup["specs"][model]
    for r in setup["ranks"]:
        plans = r["plans"][model]
        assert set(map(flax_key, plans)) == set(jax_specs)
        for name, plan in plans.items():
            shape, spec = jax_specs[flax_key(name)]
            assert (plan.flax_shape, plan.spec) == (shape, spec), name
    # the (64, 64) tie: flax dimension 0 (in), the port's Linear dimension 1
    tie = setup["ranks"][0]["plans"]["mlp3"]["denses.1.weight"]
    assert (tie.spec, tie.dim) == (("data", None), 1)
    stem = setup["ranks"][0]["plans"]["resnet18"]["conv1.weight"]  # 144 < min_size 1024
    assert (stem.flax_shape, stem.spec, stem.dim) == ((3, 3, 1, 16), (), None)
    wide = setup["ranks"][0]["plans"]["resnet18"]["layer_groups.3.1.convs.1.weight"]
    assert (wide.flax_shape, wide.spec, wide.dim) == ((3, 3, 128, 128),
                                                      (None, None, "data", None), 1)


def test_parameters_and_moments_are_physically_a_shard(setup):
    for r in setup["ranks"]:
        run = r["fsdp"]
        assert run["shapes"] == {"denses.0.weight": (32, 16), "denses.0.bias": (32,),
                                 "denses.1.weight": (4, 32), "denses.1.bias": (4,)}
        assert sorted(run["moments"]) == sorted(run["shapes"].values())
        assert r["route"] == TENSOR_ROUTE and TENSOR_ROUTE != STAGED_ROUTE


def test_steps_match_jax_data_parallel(setup):
    jlosses, jparams = setup["jax"]
    want = from_jax_params(jparams, MLP(features=(64, 4), in_dim=16), "cpu")
    for r in setup["ranks"]:
        for arm in ("fsdp", "dp"):
            np.testing.assert_allclose(r[arm]["losses"], jlosses, rtol=1e-5)
            for name, ref in want.items():
                np.testing.assert_allclose(r[arm]["params"][name].numpy(), ref.numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=f"{arm} {name}")
        assert r["fsdp"]["losses"] == setup["ranks"][0]["fsdp"]["losses"]


def test_planted_dropped_reduce_scatter_is_caught(setup):
    _, jparams = setup["jax"]
    want = from_jax_params(jparams, MLP(features=(64, 4), in_dim=16), "cpu")
    got = setup["ranks"][0]["planted"]["params"]
    missed = [n for n, ref in want.items()
              if not np.allclose(got[n].numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)]
    assert set(missed) >= {"denses.0.weight", "denses.1.weight"}, missed


def test_collectives_a_step(setup):
    """3 sharded leaves: a gather each forward, a reduce-scatter each
    backward; one bucket of the replicated bias with the loss."""
    for r in setup["ranks"]:
        assert r["fsdp"]["collectives"] == {
            "all_gather_into_tensor": 3 * STEPS, "reduce_scatter_tensor": 3 * STEPS,
            "data_all_reduce": STEPS}


def test_skip_flag_agreed_over_the_data_group(setup):
    for r in setup["ranks"]:
        assert r["flag"] == {"skipped": 1, "step": 0, "unchanged": True, "flag_min": 1}


def test_trainer_with_fsdp_converges_and_stays_sharded(setup):
    for r in setup["ranks"]:
        t = r["trainer"]
        assert t["last"] < t["first"] * 0.5, t
        assert t["kernel_shard"] == (32, 16) and t["moment"] == (32, 16) and t["sharded"]
        # a sharded state's checkpoint saves and restores (it was refused)
        assert t["refusals"] == [] and t["restored"]


def test_audit_lines_and_variable_shardings(setup):
    from torch.distributed.tensor import Replicate, Shard

    r = setup["ranks"][0]
    assert "denses.0.weight: (16, 64) -> (None, 'data')" in r["audit"]
    assert "denses.1.bias: (4,) -> ()" in r["audit"]
    # the port's dimensions: Linear (out, in), so flax's (None, 'data') is Shard(0)
    assert r["variable_shardings"] == {"denses.0.weight": (Shard(0),), "denses.0.bias": (Shard(0),),
                                       "denses.1.weight": (Shard(1),), "denses.1.bias": (Replicate(),)}
