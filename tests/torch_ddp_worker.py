"""Worker bodies for ``tests/test_torch_launch.py``, run in processes that
:func:`pytorch_distributed_training_tutorials_tpu_torch.launch.spawn`
starts. Module-level functions (the spawn start method pickles them by
name) in a module that imports torch and the port only, so the children
start without JAX."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, DeviceResidentLoader
from pytorch_distributed_training_tutorials_tpu_torch.models import resnet18
from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import BatchNorm
from pytorch_distributed_training_tutorials_tpu_torch.ops.debug import (
    describe_sharding,
    per_shard_shapes,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel import distributed
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, sgd


def resnet_worker(rank: int, world: int, coordinator: str | None, workdir: str,
                  epochs: int, per_device_batch: int) -> None:
    """The small float64 ResNet-18 (``tests/test_torch_trainer.py``'s
    case) data parallel over ``world`` gloo processes, from the weights in
    ``workdir/init.pt`` and the images in ``workdir/data.npz``; writes its
    final state, losses and its first epoch's rows to
    ``workdir/rank{rank}.pt``. ``coordinator`` None: the torchrun
    contract (the environment names the world)."""
    torch.set_num_threads(1)
    if coordinator is None:
        distributed.init(device="cpu")
    else:
        distributed.init(coordinator, world, rank, device="cpu")
    assert dist.get_world_size() == world and dist.get_rank() == rank
    data = np.load(os.path.join(workdir, "data.npz"))
    loader = DeviceResidentLoader(ArrayDataset((data["x"], data["y"])), per_device_batch,
                                  create_mesh(device="cpu"),
                                  transform=lambda x, y: (x.double() / 255, y))
    model = resnet18(num_classes=10, stem="cifar", num_filters=8, in_channels=1,
                     dtype=torch.float64)
    trainer = Trainer(model, loader, sgd(0.05, momentum=0.9), quiet=True)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mean, m.var = m.mean.double(), m.var.double()
    init = torch.load(os.path.join(workdir, "init.pt"), weights_only=True)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(init[k])
    rows = loader.epoch_index_array(0)
    trainer.train(epochs)
    # the shape-print lesson over the world: each rank's block of a batch
    x = next(iter(loader))[0]
    torch.save({"state": model.state_dict(), "rows": rows,
                "losses": [e["loss"] for e in trainer.metrics.epoch_events()],
                "host_syncs": trainer.host_syncs,
                "per_shard_shapes": per_shard_shapes(x),
                "per_shard_shapes_mesh": per_shard_shapes(x, mesh=loader.mesh, axis="data"),
                "describe_sharding": describe_sharding(x)},
               os.path.join(workdir, f"rank{rank}.pt"))
    distributed.shutdown()


def crash_once_worker(rank: int, workdir: str) -> None:
    """Rank 1 dies on the first attempt (leaving a marker); on the next
    attempt the world forms and all-reduces."""
    marker = os.path.join(workdir, "crashed")
    if rank == 1 and not os.path.exists(marker):
        open(marker, "w").close()
        os._exit(3)
    distributed.init(device="cpu")
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    with open(os.path.join(workdir, f"ok{rank}"), "w") as f:
        f.write(str(float(t)))
    distributed.shutdown()


def guard_worker(rank: int, world: int, coordinator: str, workdir: str) -> None:
    """One guarded step of ``Linear(4, 1)`` data parallel over ``world``
    gloo processes, rank 1's rows NaN: the averaged gradients are NaN on
    every rank, so every rank skips. Writes the state before and after,
    the step and the skip flag to ``workdir/guard{rank}.pt``."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import LinearRegressor
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.train import TrainState, adamw
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import make_train_step

    torch.set_num_threads(1)
    distributed.init(coordinator, world, rank, device="cpu")
    dp = DataParallel(create_mesh(device="cpu"))
    model = LinearRegressor(in_dim=4)
    with torch.no_grad():
        model.denses[0].weight.copy_(torch.arange(4.0).reshape(1, 4) / 10)
        model.denses[0].bias.fill_(0.5)
    state = dp.shard_state(TrainState.create(model=model, tx=adamw(1e-2)))
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4) / 100
    if rank == 1:
        x[0, 0] = float("nan")
    step = make_train_step(loss="mse", skip_nonfinite=True)
    before = [t.clone() for t in (*state.params, *state.opt_state.mu, *state.opt_state.nu,
                                  state.opt_state.count, state.step)]
    _, m = step(state, (x, torch.ones(8, 1)))
    after = [*state.params, *state.opt_state.mu, *state.opt_state.nu, state.opt_state.count,
             state.step]
    torch.save({"before": before, "after": after, "skipped": int(m["skipped"])},
               os.path.join(workdir, f"guard{rank}.pt"))
    distributed.shutdown()
