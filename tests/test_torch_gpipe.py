"""The port's ``GPipe`` (``parallel/pipeline.py``) against the JAX
package's, in process at data width 1: a ``{"data": 1, "stage": 2}`` mesh
on both sides (the port's two stages on the CPU, named twice).

ResNet-18, cifar stem, 8 filters, 8x8 images, 16 of them in 4
microbatches, MSE on one-hot targets, SGD: one step's loss, every
parameter and every BatchNorm statistic against the JAX ``GPipe``'s at
the JAX test's ``rtol 5e-4 / atol 5e-5`` (``tests/test_gpipe.py``), with
float64 compute on both sides (the JAX side under ``jax_enable_x64``:
float32 BatchNorm gradients of either framework are ~1% off their own
float64 values, ``tests/test_torch_resnet.py``). The statistics are each
microbatch's from the step's starting ones, averaged; a planted fault
that lets the port's in-place BatchNorm compound them must miss. The
schedule's calls are n*m stage forwards, n*m stage backwards and n
applies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax._src.config import enable_x64

from pytorch_distributed_training_tutorials_tpu.models import resnet as jr
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.parallel.pipeline import GPipe as JGPipe
from pytorch_distributed_training_tutorials_tpu.parallel.pipeline import (
    linen_stage_fn,
    partition_variables,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import from_jax_params, resnet18
from pytorch_distributed_training_tutorials_tpu_torch.models.convert import _flax_path
from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import BatchNorm
from pytorch_distributed_training_tutorials_tpu_torch.parallel import GPipe, create_mesh
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import sgd

NF, PX, N, M, LR = 8, 8, 16, 4, 0.05
RTOL, ATOL = 5e-4, 5e-5


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def images(n=N, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    x = rng.standard_normal((n, PX, PX, 3))
    y = np.eye(10)[rng.integers(0, 10, n)]
    return x, y


def jax_gpipe_run(mesh, m=M, seed=0) -> dict:
    """One float64 JAX GPipe step: the starting weights (params and
    statistics, numpy), then the loss and the stepped stage trees."""
    x, y = images()
    jm = jr.resnet18(num_classes=10, stem="cifar", num_filters=NF, dtype=jnp.float64)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x, jnp.float32))
    start = {"params": to_np(v["params"]), "batch_stats": to_np(v["batch_stats"])}
    variables = {"params": v["params"],
                 "batch_stats": jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                                       v["batch_stats"])}
    methods = [jm.stage0, jm.stage1]
    pipe = JGPipe([linen_stage_fn(jm, f) for f in methods],
                  partition_variables(variables, jm.stage_partition, 2), mesh,
                  num_microbatches=m, loss="mse", optimizer=optax.sgd(LR),
                  eval_stage_fns=[linen_stage_fn(jm, f, train=False) for f in methods])
    loss = float(pipe.train_step(jnp.asarray(x), jnp.asarray(y)))
    stepped = {"params": {}, "batch_stats": {}}
    for sv in pipe.stage_vars:
        for coll in stepped:
            stepped[coll].update(to_np(jax.device_get(sv[coll])))
    return {"start": start, "loss": loss, "stepped": stepped}


def port_model(start) -> torch.nn.Module:
    """The port's float64-compute ResNet-18 on the JAX starting weights."""
    tm = resnet18(num_classes=10, stem="cifar", num_filters=NF, dtype=torch.float64)
    tm.load_state_dict(from_jax_params(start["params"], tm, "cpu",
                                       batch_stats=start["batch_stats"]))
    for mod in tm.modules():
        if isinstance(mod, BatchNorm):
            mod.mean, mod.var = mod.mean.double(), mod.var.double()
    return tm


def jax_leaf(tree: dict, key: str) -> np.ndarray:
    """The stepped JAX leaf of a port state-dict ``key``, in the port's
    layout."""
    *mods, leaf = key.split(".")
    sub = tree["batch_stats" if leaf in ("mean", "var") else "params"]
    for name in _flax_path(mods):
        sub = sub[name]
    want = np.asarray(sub["kernel" if leaf == "weight" else leaf], np.float64)
    if leaf == "weight":
        want = want.transpose(3, 2, 0, 1) if want.ndim == 4 else want.T
    return want


def mismatches(state: dict, jax_run: dict, stats_only: bool = False) -> list[str]:
    """The state-dict keys outside ``rtol 5e-4 / atol 5e-5`` of the JAX
    step's."""
    bad = []
    for key, t in state.items():
        if stats_only and key.rsplit(".", 1)[-1] not in ("mean", "var"):
            continue
        want = jax_leaf(jax_run["stepped"], key)
        if not np.allclose(t.double().numpy(), want, rtol=RTOL, atol=ATOL):
            bad.append(key)
    return bad


@pytest.fixture(scope="module")
def jax_run(devices):
    with enable_x64(True):
        return jax_gpipe_run(jax_mesh({"data": 1, "stage": 2}, devices=devices[:2]))


def _pipe(start, m=M) -> GPipe:
    mesh = create_mesh({"data": 1, "stage": 2}, device="cpu", stage_devices=["cpu", "cpu"])
    return GPipe(port_model(start), mesh, num_microbatches=m, loss="mse", optimizer=sgd(LR))


def test_gpipe_step_matches_jax(jax_run):
    pipe = _pipe(jax_run["start"])
    x, y = images()
    loss = float(pipe.train_step(x, y))
    np.testing.assert_allclose(loss, jax_run["loss"], rtol=RTOL)
    state = pipe.model.state_dict()
    assert mismatches(state, jax_run) == []
    # the statistics moved (one momentum step from the start, not m)
    assert any(not torch.equal(state[k].double(), torch.tensor(jax_leaf(jax_run["start"], k)))
               for k in state if k.endswith(".mean"))
    assert pipe.dp_size == 1 and pipe.group is None


def test_planted_batchnorm_compounding_is_caught(jax_run):
    """Without the step-start restore the port's norms update their
    statistics once a microbatch (momentum compounded m times)."""
    pipe = _pipe(jax_run["start"])
    pipe._restore_stats = lambda stats, start: None
    x, y = images()
    pipe.train_step(x, y)
    bad = mismatches(pipe.model.state_dict(), jax_run, stats_only=True)
    assert len(bad) >= 10, bad


def test_microbatch_validation(jax_run):
    start = jax_run["start"]
    pipe = _pipe(start, m=3)
    x, y = images()
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        pipe.train_step(x, y)
    with pytest.raises(ValueError, match="num_microbatches"):
        _pipe(start, m=0)
    with pytest.raises(TypeError, match="StageMesh"):
        GPipe(port_model(start), ["cpu", "cpu"], num_microbatches=2)


@pytest.mark.parametrize("m", [2, 4])
def test_call_counts_scale_with_microbatches(jax_run, m):
    """The Python-driven schedule (the JAX ``test_gpipe_dispatch_count_
    scales_with_microbatches``): n*m stage forwards (the port runs the
    last stage's forward outside its backward), n*m stage backwards, n
    applies."""
    pipe = _pipe(jax_run["start"], m=m)
    counts = {"fwd": 0, "bwd": 0, "apply": 0}

    def wrap(fn, key):
        def inner(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return inner

    pipe._stage_forward = wrap(pipe._stage_forward, "fwd")
    pipe._stage_backward = wrap(pipe._stage_backward, "bwd")
    pipe._apply_stage = wrap(pipe._apply_stage, "apply")
    x, y = images()
    pipe.train_step(x, y)
    n = pipe.num_stages
    assert counts == {"fwd": n * m, "bwd": n * m, "apply": n}
