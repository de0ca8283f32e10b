"""Data parallelism on ``torch.distributed``: gloo worlds of 2 processes
through the port's ``spawn``, on the CPU.

- The small ResNet-18 (8 filters, 12x12x1, SGD momentum 0.9 at lr 0.05,
  BatchNorm) over the device-resident loader, 8 rows a rank, 3 epochs,
  under the spawn contract and under the torchrun contract. Each rank
  trains on its own rows; afterwards both ranks' parameters and
  statistics are bitwise equal, and they match the JAX ``Trainer`` on a
  2-device CPU mesh (global batch 16) at ``atol 1e-6``, epoch losses
  ``rtol 1e-6``. As in ``tests/test_torch_trainer.py`` both sides compute
  in float64 (float32 parameters), because XLA's float32 gradients of
  this net are off by ~1% and momentum SGD amplifies that. Without the
  gradient all-reduce the ranks drift apart, and without the BatchNorm
  all-reduce each rank normalizes over 8 rows where JAX normalizes over
  16: either way the parameters leave the JAX trajectory by far more
  than the tolerance.
- ``max_restarts=1`` tears down and re-forks the gang after one rank
  dies.
- ``launch.train_ddp``'s per-process ``main`` (spawn contract) and
  ``launch.train_ddp_env``'s ``env_worker`` (torchrun contract), the
  reference's workload on 2 ranks: the epoch line of a world of 2.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax._src.config import enable_x64

import torch_ddp_worker
from pytorch_distributed_training_tutorials_tpu.data import datasets as jds
from pytorch_distributed_training_tutorials_tpu.data.resident import (
    DeviceResidentLoader as JaxResident,
)
from pytorch_distributed_training_tutorials_tpu.models import resnet18 as jax_resnet18
from pytorch_distributed_training_tutorials_tpu.ops.debug import (
    per_shard_shapes as jax_per_shard_shapes,
)
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.train import Trainer as JaxTrainer
from pytorch_distributed_training_tutorials_tpu_torch.launch import coordinator_for_spawn, spawn
from pytorch_distributed_training_tutorials_tpu_torch.launch import train_ddp, train_ddp_env
from pytorch_distributed_training_tutorials_tpu_torch.models import from_jax_params, resnet18

WORLD, PER_DEVICE, EPOCHS = 2, 8, 3


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer on a 2-device mesh in float64, and the files the
    workers start from: its initial weights and the images."""
    workdir = tmp_path_factory.mktemp("ddp")
    ds = jds._synthetic_images(64, (12, 12, 1), 10, template_seed=101, noise_seed=1, raw=True)
    np.savez(workdir / "data.npz", x=ds.arrays[0], y=ds.arrays[1])
    shell = resnet18(num_classes=10, stem="cifar", num_filters=8, in_channels=1)
    with enable_x64(True):
        jt = JaxTrainer(
            jax_resnet18(num_classes=10, stem="cifar", num_filters=8, dtype=jnp.float64),
            JaxResident(ds, PER_DEVICE, jax_mesh({"data": WORLD}),
                        transform=lambda x, y: (x.astype(jnp.float64) / 255.0, y)),
            optax.sgd(0.05, momentum=0.9), quiet=True)
        jt.state = jt.state.replace(batch_stats=jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64), jt.state.batch_stats))
        torch.save(from_jax_params(to_np(jt.state.params), shell, "cpu",
                                   batch_stats=to_np(jt.state.batch_stats)), workdir / "init.pt")
        jt.train(EPOCHS)
    want = from_jax_params(to_np(jt.state.params), shell, "cpu",
                           batch_stats=to_np(jt.state.batch_stats))
    return workdir, want, [e["loss"] for e in jt.metrics.epoch_events()]


@pytest.mark.parametrize("contract", ["spawn", "torchrun"])
def test_two_rank_gloo_world_matches_jax_mesh(contract, jax_run):
    workdir, want, jax_losses = jax_run
    for r in range(WORLD):
        (workdir / f"rank{r}.pt").unlink(missing_ok=True)
    coordinator = coordinator_for_spawn()
    spawn(torch_ddp_worker.resnet_worker, WORLD,
          args=(WORLD, coordinator if contract == "spawn" else None, str(workdir), EPOCHS,
                PER_DEVICE),
          coordinator=coordinator, env_contract=contract == "torchrun", join_timeout_s=240)
    out = [torch.load(workdir / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    # each rank trained on its own rows
    rows = [set(o["rows"].flatten().tolist()) for o in out]
    assert not rows[0] & rows[1] and len(rows[0] | rows[1]) == 64
    # the ranks agree bitwise, parameters and BatchNorm statistics
    for k, v in out[0]["state"].items():
        assert torch.equal(v, out[1]["state"][k]), k
    for k, v in out[0]["state"].items():
        diff = float((v.double() - want[k].double()).abs().max())
        assert diff <= 1e-6, (k, diff)
    np.testing.assert_allclose(out[0]["losses"], jax_losses, rtol=1e-6)
    assert out[0]["losses"] == out[1]["losses"]
    assert out[0]["host_syncs"] == EPOCHS
    # ops.debug: each rank's block, gathered over the world (or the mesh's
    # data axis), as the JAX per_shard_shapes lists a batch's shards on the
    # 2-device mesh
    ds = jds._synthetic_images(64, (12, 12, 1), 10, template_seed=101, noise_seed=1, raw=True)
    jx = next(iter(JaxResident(ds, PER_DEVICE, jax_mesh({"data": WORLD}))))[0]
    want_shards = [tuple(s) for s in jax_per_shard_shapes(jx)]
    for o in out:
        assert o["per_shard_shapes"] == o["per_shard_shapes_mesh"] == want_shards
    assert out[0]["describe_sharding"] == out[1]["describe_sharding"]
    assert out[0]["describe_sharding"].startswith(f"global {tuple(jx.shape)} torch.float64")


def test_max_restarts_reforks_after_a_crash(tmp_path):
    spawn(torch_ddp_worker.crash_once_worker, WORLD, args=(str(tmp_path),), env_contract=True,
          max_restarts=1, join_timeout_s=120)
    assert (tmp_path / "crashed").exists()
    assert [float((tmp_path / f"ok{r}").read_text()) for r in range(WORLD)] == [3.0, 3.0]


def test_spawn_without_restarts_raises(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1: exit 3"):
        spawn(torch_ddp_worker.crash_once_worker, WORLD, args=(str(tmp_path),),
              env_contract=True, join_timeout_s=120)


def test_train_ddp_clis_on_two_ranks(capfd):
    coordinator = coordinator_for_spawn()
    spawn(train_ddp.main, WORLD, args=(WORLD, 1, 32, coordinator, "mse", "cpu"),
          coordinator=coordinator, join_timeout_s=240)
    spawn(train_ddp_env.env_worker, WORLD, args=(1, 32, "cpu"), env_contract=True,
          join_timeout_s=240)
    out = capfd.readouterr().out
    # 2048 samples, 32 per device, 2 devices: 32 steps; one line per world
    assert out.count("[Chips: 2 Epoch: 0, Batch size: 32 | Steps 32]") == 2
