"""The port's ``ManualPipeline`` (``parallel/pipeline.py``) against the
JAX package's, on the CPU: the 03 lesson's split (SURVEY C14/C15).

The JAX pipeline runs its stages on two of the fake CPU devices
(``tests/test_pipeline.py``); the port's holds both stages on the one CPU
device, named twice (torch has one CPU device, so "stages on distinct
devices" shows only on a machine with two cards). Weights come from the
JAX ``init`` through ``models/convert.py:from_jax_params``; inputs are
drawn with numpy.

Tolerances and why: the toy model (two Dense layers) computes the same
float32 products in other orders, so its forward is held at ``rtol 1e-6``
plus ``1e-6`` of the largest output (a 64-term sum near 0 differs by an
ulp of the larger terms) and bitwise to the unsplit port model, and three
SGD or AdamW steps' losses and kernels at ``rtol 1e-5`` (the JAX test's
bounds against its unsplit twin). The ResNet-18 runs compute in float64 on both
sides (the JAX side under ``jax_enable_x64``, as ``tests/test_torch_resnet.py``
explains: float32 BatchNorm gradients of either framework are ~1% off
their own float64 values), so its losses, BatchNorm statistics (float64
on both sides) and eval logits agree to ``1e-6`` relative to their
largest entry or 1; the parameters stay float32 on both sides, and an
update's rounding to float32 can land an ulp apart (measured: half an ulp
of the largest entry, and the next step's loss then ~1e-8 off), so they
agree to 4 float32 ulps of their largest entry (``2 ** -22``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax._src.config import enable_x64

from pytorch_distributed_training_tutorials_tpu.models import ToyModel as JToyModel
from pytorch_distributed_training_tutorials_tpu.models import resnet as jr
from pytorch_distributed_training_tutorials_tpu.parallel.pipeline import (
    ManualPipeline as JManualPipeline,
)
from pytorch_distributed_training_tutorials_tpu.parallel.pipeline import (
    partition_variables as jpartition,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    ToyModel,
    from_jax_params,
    resnet18,
    resnet50,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.convert import _flax_path
from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import BatchNorm
from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
    ManualPipeline,
    StageMesh,
    create_mesh,
    partition_variables,
)
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import sgd

CPU2 = ["cpu", "cpu"]
RESNET_TOL = 1e-6
PARAM_TOL = 2.0 ** -22  # 4 float32 ulps of the largest entry


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _toy(in_dim=64, seed=0):
    """(JAX toy, its variables, the port's toy on the same weights)."""
    jm = JToyModel(in_dim=in_dim, hidden=10, out_dim=5)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, in_dim)))
    tm = ToyModel(in_dim=in_dim, hidden=10, out_dim=5)
    tm.load_state_dict(from_jax_params(to_np(v["params"]), tm, "cpu"))
    return jm, v, tm


def test_partition_variables_splits_like_jax_and_refuses_out_of_range():
    jm, v, tm = _toy(in_dim=8)
    jparts = jpartition(dict(v), jm.stage_partition, 2)
    parts = partition_variables(tm.state_dict(), tm.stage_partition, 2)
    for jp, p in zip(jparts, parts):
        assert {n.split(".")[0] for n in p} == set(jp["params"])
    assert set(parts[0]) == {"net1.weight", "net1.bias"}
    with pytest.raises(ValueError, match="out of range"):
        partition_variables(tm.state_dict(), lambda n: 5, 2)
    with pytest.raises(ValueError, match="out of range"):
        partition_variables(tm.state_dict(), lambda n: -1, 2)


def test_toy_forward_matches_jax_and_unsplit(devices):
    jm, v, tm = _toy()
    x = np.linspace(-1, 1, 2 * 64).astype(np.float32).reshape(2, 64)
    jpipe = JManualPipeline.from_linen(jm, x, devices=devices[:2])
    want = np.asarray(jpipe.forward(x))
    unsplit = tm(torch.tensor(x)).detach().numpy()
    pipe = ManualPipeline(tm, CPU2)
    got = pipe.forward(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(got, unsplit)
    assert pipe.placement_audit() == ["stage 0: 650 params on cpu",
                                      "stage 1: 55 params on cpu"]


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_toy_train_steps_match_jax(devices, opt):
    """Three steps: the losses and both stages' kernels (each stage its
    own optimizer state)."""
    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw

    jm, v, tm = _toy()
    rng = np.random.Generator(np.random.PCG64(0))
    x = rng.standard_normal((4, 64)).astype(np.float32)
    y = rng.standard_normal((4, 5)).astype(np.float32)
    jtx, ttx = ((optax.sgd(1e-3), sgd(1e-3)) if opt == "sgd"
                else (optax.adamw(1e-3), adamw(1e-3)))
    jpipe = JManualPipeline.from_linen(jm, x, devices=devices[:2], loss="mse", optimizer=jtx)
    pipe = ManualPipeline(tm, CPU2, loss="mse", optimizer=ttx)
    for _ in range(3):
        np.testing.assert_allclose(float(pipe.train_step(x, y)), float(jpipe.train_step(x, y)),
                                   rtol=1e-5)
    for s, net in ((0, "net1"), (1, "net2")):
        want = np.asarray(jpipe.stage_vars[s]["params"][net]["kernel"]).T
        np.testing.assert_allclose(getattr(tm, net).weight.detach().numpy(), want, rtol=1e-5)
    assert len(pipe.opt_states) == 2


def _resnet_pair(x, loss, lr):
    """A float64 JAX pipeline and the port's on the same weights."""
    jm = jr.resnet18(num_classes=10, stem="cifar", num_filters=8, dtype=jnp.float64)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = resnet18(num_classes=10, stem="cifar", num_filters=8, dtype=torch.float64)
    tm.load_state_dict(from_jax_params(to_np(v["params"]), tm, "cpu",
                                       batch_stats=to_np(v["batch_stats"])))
    for m in tm.modules():
        if isinstance(m, BatchNorm):
            m.mean, m.var = m.mean.double(), m.var.double()
    variables = jax.tree_util.tree_map(lambda a: a, dict(v))
    variables["batch_stats"] = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                                      v["batch_stats"])
    stage_vars = jpartition(variables, jm.stage_partition, 2)
    from pytorch_distributed_training_tutorials_tpu.parallel.pipeline import linen_stage_fn

    methods = [jm.stage0, jm.stage1]
    jpipe = JManualPipeline(
        [linen_stage_fn(jm, m) for m in methods], stage_vars, jax.devices()[:2], loss=loss,
        optimizer=optax.sgd(lr),
        eval_stage_fns=[linen_stage_fn(jm, m, train=False) for m in methods])
    return jm, jpipe, tm, ManualPipeline(tm, CPU2, loss=loss, optimizer=sgd(lr))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1.0))


def _assert_stages_match(jpipe, tm):
    for key, t in tm.state_dict().items():
        *mods, leaf = key.split(".")
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        sub = jpipe.stage_vars[tm.stage_partition(key)][coll]
        for name in _flax_path(mods):
            sub = sub[name]
        want = np.asarray(sub["kernel" if leaf == "weight" else leaf])
        if leaf == "weight":
            want = want.transpose(3, 2, 0, 1) if want.ndim == 4 else want.T
        tol = RESNET_TOL if leaf in ("mean", "var") else PARAM_TOL
        assert _rel(t.numpy(), want) <= tol, key


def test_resnet18_three_steps_then_eval_match_jax(devices):
    """The ResNet cut (stem and groups 0-1 on stage 0): three cross-entropy
    steps' losses, every parameter and BatchNorm statistic after them, and
    the eval-mode forward from the running statistics."""
    rng = np.random.Generator(np.random.PCG64(0))
    x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    with enable_x64(True):
        jm, jpipe, tm, pipe = _resnet_pair(x, "cross_entropy", 1e-2)
        counts = pipe.stage_param_counts()
        assert sum(counts) == sum(p.numel() for p in tm.parameters()) and min(counts) > 0
        x64 = x.astype(np.float64)
        for _ in range(3):
            want = float(jpipe.train_step(x64, y))
            assert abs(float(pipe.train_step(x64, torch.tensor(y))) - want) <= RESNET_TOL * max(
                abs(want), 1.0)
        _assert_stages_match(jpipe, tm)
        assert _rel(pipe.forward(x64).numpy(), jpipe.forward(x64)) <= RESNET_TOL


def test_mse_on_one_hot_like_the_reference_lesson(devices):
    """The reference trains its split ResNet with MSE on one-hot(1000)
    random labels (03.model_parallel.ipynb cell 26); here one-hot(10)."""
    rng = np.random.Generator(np.random.PCG64(1))
    x = rng.standard_normal((4, 16, 16, 3))
    y = np.eye(10)[rng.integers(0, 10, 4)]
    with enable_x64(True):
        _, jpipe, tm, pipe = _resnet_pair(x.astype(np.float32), "mse", 1e-3)
        want = float(jpipe.train_step(x, y))
        got = float(pipe.train_step(x, torch.tensor(y)))
        assert np.isfinite(got) and abs(got - want) <= RESNET_TOL * max(abs(want), 1.0)
        _assert_stages_match(jpipe, tm)


def test_resnet50_stage_counts_sum_to_the_lesson_pin():
    """The reference's cells 20/22: 25,557,032 parameters, split or not."""
    pipe = ManualPipeline(resnet50(num_classes=1000), ["meta", "meta"])
    counts = pipe.stage_param_counts()
    assert sum(counts) == 25_557_032 and min(counts) > 0
    assert [d.type for d in pipe.devices] == ["meta", "meta"]


def test_pipeline_refusals():
    _, _, tm = _toy(in_dim=8)
    with pytest.raises(ValueError, match="2 stages but only 1 devices"):
        ManualPipeline(tm, ["cpu"])
    with pytest.raises(ValueError, match="unknown loss"):
        ManualPipeline(tm, CPU2, loss="hinge")
    with pytest.raises(ValueError, match="optimizer"):
        ManualPipeline(tm, CPU2).train_step(np.zeros((1, 8), np.float32),
                                            np.zeros((1, 5), np.float32))
    with pytest.raises(ValueError, match="no stage cut"):
        ManualPipeline(torch.nn.Linear(2, 2), CPU2)


def test_mesh_takes_a_stage_axis_and_still_refuses_seq_and_expert():
    mesh = create_mesh({"data": 1, "stage": 2}, device="cpu", stage_devices=CPU2)
    assert isinstance(mesh, StageMesh)
    assert mesh.mesh_dim_names == ("data", "stage")
    assert (mesh.size("data"), mesh.size("stage"), mesh.size()) == (1, 2, 2)
    assert mesh.get_group("data") is None and mesh.get_local_rank("data") == 0
    assert create_mesh({"stage": 2}, device="cpu", stage_devices=CPU2).size("data") == 1
    with pytest.raises(ValueError, match="stage_devices"):
        create_mesh({"stage": 2}, device="cpu")  # never a silent repeat of one device
    with pytest.raises(ValueError, match="3 stage_devices"):
        create_mesh({"stage": 2}, device="cpu", stage_devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="needs a 'stage' axis"):
        create_mesh({"data": 1}, device="cpu", stage_devices=CPU2)
    with pytest.raises(NotImplementedError, match="stage axis beside a model axis"):
        create_mesh({"model": 1, "stage": 1}, device="cpu")
    # the seq and expert axes are meshes of their own since the sequence-
    # and expert-parallel slice (tests/test_torch_seq_parallel.py,
    # test_torch_moe_ep.py); what stays refused is a stage axis beside
    # them and an expert axis beside a model axis
    for axis in ("seq", "expert"):
        assert create_mesh({"data": 1, axis: 1}, device="cpu").mesh_dim_names == ("data", axis)
        with pytest.raises(NotImplementedError, match=f"stage axis beside a {axis} axis"):
            create_mesh({"data": 1, "stage": 1, axis: 1}, device="cpu", stage_devices=["cpu"])
    with pytest.raises(NotImplementedError, match="expert axis beside a model axis"):
        create_mesh({"data": 1, "expert": 1, "model": 1}, device="cpu")
