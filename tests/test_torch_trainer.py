"""The PyTorch port's ``Trainer`` against the JAX package's, on the CPU.

Both trainers start from the JAX trainer's initial weights (carried over
by ``from_jax_params``) and see the same batches (the loaders are held
index for index in ``tests/test_torch_data.py``). Cases:

- ``Linear(20, 1)``, SGD 1e-2, MSE on the 2048-sample regression set,
  batch 32, 2 epochs — the ``launch.train_ddp`` workload — in float32:
  every step's loss ``rtol 1e-5``, final params ``atol 1e-6`` (the same
  float32 operations; only summation orders differ);
- a small cifar-stem ResNet-18 (8 filters, 12x12x1 images) with SGD
  momentum 0.9 at lr 0.05 and BatchNorm statistics, over the
  device-resident loader for 3 epochs, then ``evaluate`` with wrap-padded
  rows masked. These run with float64 compute on float32 parameters on both sides (the
  JAX side under ``jax_enable_x64``, its batch statistics float64 from
  the start, as the port's are): in float32 XLA's CPU gradients of the
  first blocks differ from their own float64 values by ~1% of their
  largest entry (measured: conv1 0.0070 of 0.71), the port's by 1e-6,
  and momentum SGD amplifies that over a few steps (0.2 apart after 8
  steps at lr 0.05), so a float32 trajectory would test XLA's rounding,
  not the port. In float64 the trajectories agree: epoch losses ``rtol
  1e-6``, params and statistics ``atol 1e-6`` (measured 1.2e-7 after 12
  steps: float32 rounding of the updates). The float32 and bfloat16
  forward and one step's gradients are held in ``tests/test_torch_resnet.py``;
- ``grad_accum_steps=2`` over the streaming loader: one float32 step
  (its own docstring states the tolerances);
- ``save`` -> ``restore`` -> continue equals an uninterrupted run
  bitwise, with ``keep=2`` rotating (port only).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax._src.config import enable_x64

from pytorch_distributed_training_tutorials_tpu.data import datasets as jds
from pytorch_distributed_training_tutorials_tpu.data.loader import ShardedLoader as JaxLoader
from pytorch_distributed_training_tutorials_tpu.data.resident import (
    DeviceResidentLoader as JaxResident,
)
from pytorch_distributed_training_tutorials_tpu.models import LinearRegressor as JaxLinear
from pytorch_distributed_training_tutorials_tpu.models import resnet18 as jax_resnet18
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.train import Trainer as JaxTrainer
from pytorch_distributed_training_tutorials_tpu_torch.data import (
    ArrayDataset,
    DeviceResidentLoader,
    ShardedLoader,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    LinearRegressor,
    from_jax_params,
    resnet18,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import BatchNorm
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import LocalMesh
from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, adamw, sgd

CPU = LocalMesh(torch.device("cpu"))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Toy widths gain little from intra-op threads; two keep this file
    from crowding the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load_jax_state(trainer: Trainer, jstate) -> None:
    """The JAX trainer's params (and batch statistics) into the port's
    model, in place (the optimizer keeps its tensors)."""
    stats = to_np(jstate.batch_stats) if jstate.batch_stats is not None else None
    sd = from_jax_params(to_np(jstate.params), trainer.model, "cpu", batch_stats=stats)
    with torch.no_grad():
        for k, v in trainer.model.state_dict().items():
            v.copy_(sd[k])


def max_diff(trainer: Trainer, jstate) -> tuple[float, float]:
    """(params, batch statistics) max abs difference to a JAX state."""
    stats = to_np(jstate.batch_stats) if jstate.batch_stats is not None else None
    want = from_jax_params(to_np(jstate.params), trainer.model, "cpu", batch_stats=stats)
    got = trainer.model.state_dict()
    diff = {k: float((want[k].double() - got[k].double()).abs().max()) for k in want}
    stat = [v for k, v in diff.items() if k.endswith((".mean", ".var"))]
    par = [v for k, v in diff.items() if not k.endswith((".mean", ".var"))]
    return max(par), max(stat, default=0.0)


def test_linear_regressor_sgd_mse_matches_jax(devices):
    ds = jds.synthetic_regression(2048)
    jt = JaxTrainer(JaxLinear(), JaxLoader(ds, 32, jax_mesh({"data": 1})), optax.sgd(1e-2),
                    loss="mse", quiet=True)
    tt = Trainer(LinearRegressor(), ShardedLoader(ArrayDataset(ds.arrays), 32, CPU),
                 sgd(1e-2), loss="mse", quiet=True)
    load_jax_state(tt, jt.state)
    jt.train(2)
    tt.train(2)
    jl = [e["loss"] for e in jt.metrics.step_events()]
    tl = [e["loss"] for e in tt.metrics.step_events()]
    assert len(tl) == len(jl) == 128
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert max_diff(tt, jt.state)[0] <= 1e-6
    assert int(tt.state.step) == int(jt.state.step) == 128
    # one fetch per epoch: the batched drain of every step's loss
    assert tt.host_syncs == 2


# the small ResNet case: 8 filters, 12x12x1 uint8 images, batch 16
def _images(n=64, seed=1):
    return jds._synthetic_images(n, (12, 12, 1), 10, template_seed=101, noise_seed=seed, raw=True)


def _jax_f64_trainer(loader_cls, ds, **kw):
    jt = JaxTrainer(
        jax_resnet18(num_classes=10, stem="cifar", num_filters=8, dtype=jnp.float64),
        loader_cls(ds, 16, jax_mesh({"data": 1}),
                   transform=lambda x, y: (x.astype(jnp.float64) / 255.0, y)),
        optax.sgd(0.05, momentum=0.9), quiet=True, **kw)
    jt.state = jt.state.replace(batch_stats=jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64), jt.state.batch_stats))
    return jt


def _port_f64_trainer(loader_cls, ds, **kw):
    tt = Trainer(
        resnet18(num_classes=10, stem="cifar", num_filters=8, in_channels=1, dtype=torch.float64),
        loader_cls(ArrayDataset(ds.arrays), 16, CPU, transform=lambda x, y: (x.double() / 255, y)),
        sgd(0.05, momentum=0.9), quiet=True, **kw)
    for m in tt.model.modules():
        if isinstance(m, BatchNorm):
            m.mean, m.var = m.mean.double(), m.var.double()
    return tt


@pytest.fixture(scope="module")
def resident_runs():
    """3 epochs of the resident ResNet run on both sides, then evaluate on
    50 held-out rows (4 steps of 16: 14 rows of wrap padding)."""
    ds, held_out = _images(), _images(50, seed=2)
    with enable_x64(True):
        jt = _jax_f64_trainer(JaxResident, ds)
        tt = _port_f64_trainer(DeviceResidentLoader, ds)
        load_jax_state(tt, jt.state)
        jt.train(3)
        tt.train(3)
        transform_j = lambda x, y: (x.astype(jnp.float64) / 255.0, y)  # noqa: E731
        jev = jt.evaluate(JaxLoader(held_out, 16, jax_mesh({"data": 1}), transform=transform_j))
    tev = tt.evaluate(ShardedLoader(ArrayDataset(held_out.arrays), 16, CPU,
                                    transform=lambda x, y: (x.double() / 255, y)))
    return jt, tt, jev, tev


def test_resnet18_sgd_momentum_batch_stats_matches_jax(resident_runs):
    jt, tt, _, _ = resident_runs
    jl = [e["loss"] for e in jt.metrics.epoch_events()]
    tl = [e["loss"] for e in tt.metrics.epoch_events()]
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert tl[-1] < tl[0]
    params, stats = max_diff(tt, jt.state)
    assert params <= 1e-6 and stats <= 1e-6, (params, stats)
    assert int(tt.state.step) == 12


def test_evaluate_masks_wrap_padded_rows(resident_runs):
    _, _, jev, tev = resident_runs
    assert tev["samples"] == jev["samples"] == 50
    assert tev["accuracy"] == jev["accuracy"]
    np.testing.assert_allclose(tev["loss"], jev["loss"], rtol=1e-6)


def test_grad_accum_with_batch_stats_matches_jax():
    """One step of 16 rows as 2 strided microbatches of 8, in float32 (the
    JAX accumulation scan carries float32 sums, so it cannot run with
    float64 compute): the loss (the microbatches' mean) ``rtol 1e-5`` and
    the statistics (the mean of each microbatch's update from the step's
    statistics) ``atol 1e-5``, forward-only quantities; the params within
    ``lr * 0.01`` (one step moves them by lr times a gradient whose JAX
    float32 value is off by up to 1% of its largest entry, module
    docstring)."""
    ds = _images(16, seed=3)
    transform_j = lambda x, y: (x.astype(jnp.float32) / 255.0, y)  # noqa: E731
    jt = JaxTrainer(jax_resnet18(num_classes=10, stem="cifar", num_filters=8),
                    JaxLoader(ds, 16, jax_mesh({"data": 1}), transform=transform_j),
                    optax.sgd(0.05, momentum=0.9), quiet=True, grad_accum_steps=2)
    tt = Trainer(resnet18(num_classes=10, stem="cifar", num_filters=8, in_channels=1),
                 ShardedLoader(ArrayDataset(ds.arrays), 16, CPU,
                               transform=lambda x, y: (x.float() / 255, y)),
                 sgd(0.05, momentum=0.9), quiet=True, grad_accum_steps=2)
    load_jax_state(tt, jt.state)
    jt.train(1)
    tt.train(1)
    jl = [e["loss"] for e in jt.metrics.step_events()]
    tl = [e["loss"] for e in tt.metrics.step_events()]
    assert len(tl) == len(jl) == 1
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    params, stats = max_diff(tt, jt.state)
    assert stats <= 1e-5 and params <= 0.05 * 0.01, (params, stats)


def test_trainer_refusals():
    ds = _images(32)
    resident = DeviceResidentLoader(ArrayDataset(ds.arrays), 16, CPU)
    model = resnet18(num_classes=10, stem="cifar", num_filters=8, in_channels=1)
    with pytest.raises(ValueError, match="grad_accum_steps applies to the per-step path"):
        Trainer(model, resident, sgd(0.1), grad_accum_steps=2)
    # aux_loss_weight is taken since the MoE slice (tests/test_torch_moe.py);
    # the resident loader keeps refusing batch_spec, as the JAX one does
    Trainer(model, resident, sgd(0.1), aux_loss_weight=0.1)
    with pytest.raises(NotImplementedError, match="batch_specs"):
        DeviceResidentLoader(ArrayDataset(ds.arrays), 16, CPU, batch_spec=("data", "seq"))
    # the guardrails are ported (tests/test_torch_guardrails.py)
    Trainer(model, resident, sgd(0.1), skip_nonfinite=True, rollback_spike_factor=3.0)


def _small_trainer(ds, opt):
    transform = lambda x, y: (x.float() / 255, y)  # noqa: E731
    return Trainer(resnet18(num_classes=10, stem="cifar", num_filters=8, in_channels=1),
                   ShardedLoader(ArrayDataset(ds.arrays), 16, CPU, transform=transform),
                   opt, quiet=True, seed=4)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_save_restore_continue_equals_uninterrupted(opt, tmp_path):
    make_opt = {"sgd": lambda: sgd(0.05, momentum=0.9), "adamw": lambda: adamw(1e-3)}[opt]
    ds = _images(32)
    straight = _small_trainer(ds, make_opt())
    straight.train(3)

    first = _small_trainer(ds, make_opt())
    rot = tmp_path / "rot"
    for epoch in (1, 2):
        first.train(epoch)
        first.save(rot, keep=2)
        first.save(tmp_path / "single")
    first.train(3)
    first.save(rot, keep=2)  # a third save: the oldest child goes
    assert sorted(os.listdir(rot)) == ["ckpt-00000004", "ckpt-00000006"]

    resumed = _small_trainer(ds, make_opt())
    resumed.restore(tmp_path / "single")  # epoch 2, step 4
    assert (resumed.epoch, int(resumed.state.step)) == (2, 4)
    resumed.train(3)
    for a, b in zip(resumed.model.state_dict().values(), straight.model.state_dict().values()):
        assert torch.equal(a, b)
    # a rotation directory restores its newest child
    latest = _small_trainer(ds, make_opt())
    latest.restore(rot)
    assert (latest.epoch, int(latest.state.step)) == (3, 6)
    for a, b in zip(latest.model.state_dict().values(), straight.model.state_dict().values()):
        assert torch.equal(a, b)
    # a crash between the two renames of a single save leaves only .old
    os.rename(tmp_path / "single", tmp_path / "single.old")
    fallback = _small_trainer(ds, make_opt())
    fallback.restore(tmp_path / "single")
    assert fallback.epoch == 2


def test_headline_setup_on_cpu():
    """``bench.headline``'s workload built with ``device="cpu"`` at a toy
    size (the first 32 MNIST-surrogate images, 8 per device): the recipe
    (cifar-stem ResNet-18 computing in bfloat16 on float32 parameters,
    SGD 0.05 momentum 0.9, uint8 at rest in the resident loader), one
    epoch through ``time_epoch`` and a chain of two steps, losses finite."""
    from pytorch_distributed_training_tutorials_tpu_torch.bench import headline
    from pytorch_distributed_training_tutorials_tpu_torch.data import mnist

    full = mnist("train", raw=True)
    ds = ArrayDataset(tuple(a[:32] for a in full.arrays), synthetic=full.synthetic)
    setup = headline.make_headline_setup(8, quiet=True, device="cpu", dataset=ds)
    tx = setup.trainer.state.tx
    assert (tx.lr, tx.momentum) == (headline.LR, headline.MOMENTUM)
    assert setup.loader.global_batch == 8 and setup.dataset.arrays[0].dtype == np.uint8
    x, y = setup.batch
    assert x.dtype == torch.bfloat16 and x.shape == (8, 28, 28, 1) and y.shape == (8,)
    assert all(p.dtype == torch.float32 for p in setup.trainer.state.params)
    r = headline.time_epoch(setup)
    assert (r["epoch"], r["steps"], r["timer"]) == (0, 4, "host_clock")
    assert np.isfinite(r["mean_loss"]) and r["images_per_sec_per_device"] > 0
    losses = headline.make_step_chain(setup, 2)()
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
