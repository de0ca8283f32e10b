"""The PyTorch port's input pipeline against the JAX package's.

Index for index and byte for byte (no tolerance anywhere): the sampler's
order over (size, world, rank, epoch, shuffle, drop_last), world larger
than the dataset included; the MNIST and CIFAR-10 surrogates; the sharded
loader's batches and ``valid_mask`` on a JAX mesh of ``jax.devices()[:k]``
against each rank of a port world of k; the device-resident loader's
index matrix. A port world of k is stood in for by a mesh object that
answers ``size`` and ``get_local_rank`` as a ``DeviceMesh`` of k
processes would, so no process group is formed here
(``tests/test_torch_launch.py`` forms real ones).
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.data import datasets as jds
from pytorch_distributed_training_tutorials_tpu.data.loader import ShardedLoader as JaxLoader
from pytorch_distributed_training_tutorials_tpu.data.resident import (
    DeviceResidentLoader as JaxResident,
)
from pytorch_distributed_training_tutorials_tpu.data.sampler import (
    DistributedSampler as JaxSampler,
)
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu_torch.data import (
    ArrayDataset,
    DeviceResidentLoader,
    DistributedSampler,
    ShardedLoader,
    cifar10,
    mnist,
    random_dataset,
    synthetic_regression,
)
from pytorch_distributed_training_tutorials_tpu_torch.data import native
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import LocalMesh


class RankMesh:
    """Rank ``rank`` of a data mesh of ``world`` CPU processes: the read
    surface of a ``DeviceMesh`` the loaders use."""

    mesh_dim_names = ("data",)
    device_type = "cpu"

    def __init__(self, world: int, rank: int):
        self.world, self.rank = world, rank

    def size(self, mesh_dim=None) -> int:
        return self.world

    def get_local_rank(self, mesh_dim=None) -> int:
        return self.rank

    def get_group(self, mesh_dim=None):
        return None


def port_mesh(world: int, rank: int):
    return LocalMesh(torch.device("cpu")) if world == 1 else RankMesh(world, rank)


SAMPLER_CASES = [
    # (size, world, rank, epoch, shuffle, drop_last)
    (2048, 4, 0, 0, True, False),
    (2048, 4, 3, 5, True, False),
    (1000, 3, 1, 2, True, False),
    (1000, 3, 2, 2, True, True),
    (1001, 8, 7, 1, False, False),
    (1001, 8, 5, 0, False, True),
    (5, 8, 6, 3, True, False),  # world > size: the prefix repeats
    (3, 7, 6, 0, False, False),
    (17, 2, 1, 9, True, True),
]


@pytest.mark.parametrize("size,world,rank,epoch,shuffle,drop_last", SAMPLER_CASES)
def test_sampler_index_for_index(size, world, rank, epoch, shuffle, drop_last):
    kw = dict(shuffle=shuffle, seed=7, drop_last=drop_last)
    j, t = JaxSampler(size, world, rank, **kw), DistributedSampler(size, world, rank, **kw)
    j.set_epoch(epoch)
    t.set_epoch(epoch)
    assert len(t) == len(j)
    np.testing.assert_array_equal(t.local_indices(), j.local_indices())
    assert list(t) == list(j)


def test_sampler_refuses_bad_rank():
    with pytest.raises(ValueError, match="out of range"):
        DistributedSampler(10, 2, 2)


@pytest.mark.parametrize("name,split", [("mnist", "train"), ("mnist", "test"),
                                        ("cifar10", "test")])
def test_surrogates_byte_equal(name, split, tmp_path):
    port_fn, jax_fn = {"mnist": (mnist, jds.mnist), "cifar10": (cifar10, jds.cifar10)}[name]
    t = port_fn(split, data_dir=str(tmp_path), raw=True)
    j = jax_fn(split, data_dir=str(tmp_path), raw=True)
    assert t.synthetic and j.synthetic
    for a, b in zip(t.arrays, j.arrays):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_small_datasets_equal():
    for port_ds, jax_ds in ((synthetic_regression(300, seed=3), jds.synthetic_regression(300, seed=3)),
                            (random_dataset(8, 50, seed=1), jds.random_dataset(8, 50, seed=1))):
        for a, b in zip(port_ds.arrays, jax_ds.arrays):
            np.testing.assert_array_equal(a, b)
    imgs = jds._synthetic_images(40, (6, 6, 3), 10, 5, 6, raw=False)
    from pytorch_distributed_training_tutorials_tpu_torch.data.datasets import _synthetic_images

    for a, b in zip(_synthetic_images(40, (6, 6, 3), 10, 5, 6, raw=False).arrays, imgs.arrays):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_native_gather_rows():
    """The host gather (built from the JAX package's source into build/,
    or numpy where no compiler is found) is ``arr[rows]`` exactly."""
    rng = np.random.Generator(np.random.PCG64(0))
    arr = rng.integers(0, 255, (300, 5, 7), dtype=np.uint8)
    rows = rng.integers(-300, 300, 4000)
    np.testing.assert_array_equal(native.gather_rows(arr, rows), arr[rows])
    with pytest.raises(IndexError):
        native.gather_rows(arr, np.array([300]))
    # built into the repo's build/, never beside the JAX package's source
    assert native.SOURCE.parent not in (native.BUILD_DIR, *native.BUILD_DIR.parents)


def _dataset():
    """101 rows, indivisible on purpose: both wraps (to equal shards and
    to whole steps) pad."""
    rng = np.random.Generator(np.random.PCG64(4))
    x = rng.integers(0, 255, (101, 4, 4, 1), dtype=np.uint8)
    y = rng.integers(0, 10, 101).astype(np.int32)
    return x, y


@pytest.mark.parametrize("world,batch,shuffle", [(1, 16, True), (2, 12, True),
                                                 (4, 7, False), (3, 8, True)])
def test_sharded_loader_matches_jax(world, batch, shuffle, devices):
    x, y = _dataset()
    jl = JaxLoader(jds.ArrayDataset((x, y)), batch, jax_mesh({"data": world}), seed=3,
                   shuffle=shuffle)
    for epoch in (0, 2):
        jl.set_epoch(epoch)
        jbatches = [tuple(np.asarray(a) for a in b) for b in jl]
        for rank in range(world):
            tl = ShardedLoader(ArrayDataset((x, y)), batch, port_mesh(world, rank), seed=3,
                               shuffle=shuffle)
            assert (len(tl), tl.global_batch, tl.per_device_batch) == (
                len(jl), jl.global_batch, jl.per_device_batch)
            tl.set_epoch(epoch)
            tbatches = list(tl)
            assert len(tbatches) == len(jbatches)
            for step, (tb, jb) in enumerate(zip(tbatches, jbatches)):
                lo, hi = rank * batch, (rank + 1) * batch
                for a, b in zip(tb, jb):
                    np.testing.assert_array_equal(a.numpy(), b[lo:hi])
                np.testing.assert_array_equal(tl.valid_mask(step), jl.valid_mask(step))
                np.testing.assert_array_equal(tl.local_valid_mask(step),
                                              jl.valid_mask(step)[lo:hi])


def test_global_batch_mode_and_transform(devices):
    x, y = _dataset()
    jl = JaxLoader(jds.ArrayDataset((x, y)), 16, jax_mesh({"data": 2}), batch_mode="global")
    tl = ShardedLoader(ArrayDataset((x, y)), 16, port_mesh(2, 1), batch_mode="global",
                       transform=lambda a, b: (a.to(torch.bfloat16) / 255, b))
    assert (tl.per_device_batch, len(tl)) == (jl.per_device_batch, len(jl)) == (8, 7)
    xb, yb = next(iter(tl))
    assert xb.dtype == torch.bfloat16 and xb.shape == (8, 4, 4, 1)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedLoader(ArrayDataset((x, y)), 15, port_mesh(2, 0), batch_mode="global")
    # batch_spec shards dims past 0 since the sequence-parallel slice
    # (tests/test_torch_seq_parallel.py); its dim 0 must map to the
    # loader's axis, as in the JAX loader, and a spec of the data axis
    # alone is the default layout
    with pytest.raises(ValueError, match="batch_spec dim 0 must map"):
        ShardedLoader(ArrayDataset((x, y)), 16, port_mesh(2, 0), batch_spec=("seq", "data"))
    with pytest.raises(ValueError, match="batch_spec dim 0 must map"):
        JaxLoader(jds.ArrayDataset((x, y)), 16, jax_mesh({"data": 2}),
                  batch_spec=jax.sharding.PartitionSpec("seq"))
    plain = ShardedLoader(ArrayDataset((x, y)), 16, port_mesh(2, 1), shuffle=False)
    spec = ShardedLoader(ArrayDataset((x, y)), 16, port_mesh(2, 1), shuffle=False,
                         batch_spec=("data", "seq"))  # a mesh without a seq axis: dim 0 only
    for a, b in zip(next(iter(plain)), next(iter(spec))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_resident_index_matrix_matches_jax(world, devices):
    x, y = _dataset()
    jl = JaxResident(jds.ArrayDataset((x, y)), 8, jax_mesh({"data": world}), seed=5)
    for epoch in (0, 3):
        jidx = np.asarray(jl.epoch_index_array(epoch))  # (steps, global_batch)
        for rank in range(world):
            tl = DeviceResidentLoader(ArrayDataset((x, y)), 8, port_mesh(world, rank), seed=5)
            tidx = tl.epoch_index_array(epoch)
            assert tidx.shape == (len(jl), 8)
            np.testing.assert_array_equal(tidx.numpy(), jidx[:, rank * 8:(rank + 1) * 8])
            # the on-device gather yields the streaming loader's batches
            streaming = ShardedLoader(ArrayDataset((x, y)), 8, port_mesh(world, rank), seed=5)
            streaming.set_epoch(epoch)
            for rb, sb in zip(tl.batches(tidx), streaming):
                for a, b in zip(rb, sb):
                    assert torch.equal(a, b)


def test_data_parallel_strategy_interface():
    """The four-method interface: the data-axis width, every variable
    replicated, this rank's block of a global batch; no group (and no
    collective) without a process group."""
    from torch.distributed.tensor import Replicate

    from pytorch_distributed_training_tutorials_tpu_torch.models import LinearRegressor
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import DataParallel

    dp = DataParallel(port_mesh(4, 2))
    assert (dp.num_devices, dp.rank, dp.group) == (4, 2, None)
    x, y = np.arange(16 * 3).reshape(16, 3), np.arange(16)
    bx, by = dp.shard_batch((x, y))
    np.testing.assert_array_equal(bx.numpy(), x[8:12])
    np.testing.assert_array_equal(by.numpy(), y[8:12])
    with pytest.raises(ValueError, match="not divisible"):
        dp.shard_batch(np.arange(10))
    assert dp.variable_shardings(LinearRegressor()) == {
        "denses.0.weight": (Replicate(),), "denses.0.bias": (Replicate(),)}
    assert DataParallel(port_mesh(1, 0)).num_devices == 1
