"""The port's streaming input (``data/prefetch.py``, ``data/streaming.py``,
``data/datasets.py:synthetic_lm``) against the JAX package's, on the CPU.

- ``synthetic_lm`` is byte for byte the JAX package's for the same
  arguments (numpy only on both sides);
- ``prefetch_iterable``: order, the producer's exception re-raised in the
  consumer, an abandoned consumer stopping the producer; ``PrefetchLoader``
  yields its ``ShardedLoader``'s batches byte for byte;
- ``ChunkedStreamingLoader``: each rank's chunks are byte for byte its
  columns of the JAX loader's chunks (same sampler, epoch seed,
  replica-major order, the short tail chunk), at world 1 and 2;
- a chunked epoch's losses and parameters equal the port's per-step epoch
  bitwise (a small ResNet-18 with BatchNorm, SGD momentum: the chunking
  changes where bytes move, not which), and follow the JAX trainer's
  chunked epoch with float64 compute on both sides (an MLP, SGD): epoch
  losses ``rtol 1e-6`` and parameters ``atol 1e-6`` (float32 parameters,
  the same operations; only float32 rounding of the updates differs).
"""

import itertools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax._src.config import enable_x64

from pytorch_distributed_training_tutorials_tpu.data import ChunkedStreamingLoader as JaxChunked
from pytorch_distributed_training_tutorials_tpu.data import datasets as jds
from pytorch_distributed_training_tutorials_tpu.models import MLP as JaxMLP
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.train import Trainer as JaxTrainer
from pytorch_distributed_training_tutorials_tpu_torch.data import (
    ArrayDataset,
    ChunkedStreamingLoader,
    PrefetchLoader,
    ShardedLoader,
    prefetch_iterable,
    synthetic_lm,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import MLP, from_jax_params, resnet18
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import LocalMesh
from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, sgd
from test_torch_data import port_mesh

CPU = LocalMesh(torch.device("cpu"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ds(n=200, d=16, classes=4, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


@pytest.mark.parametrize("kw", [{}, dict(size=37, seq_len=9, vocab_size=11, seed=5,
                                         peakedness=1.5)])
def test_synthetic_lm_byte_equal_to_jax(kw):
    got, want = synthetic_lm(**kw), jds.synthetic_lm(**kw)
    assert len(got.arrays) == len(want.arrays) == 2
    for a, b in zip(got.arrays, want.arrays):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _prefetch_threads() -> int:
    return sum(t.name == "prefetch" and t.is_alive() for t in threading.enumerate())


def _threads_back_to(n: int, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _prefetch_threads() <= n:
            return True
        time.sleep(0.02)
    return False


def test_prefetch_iterable_order_error_and_close():
    before = _prefetch_threads()
    assert list(prefetch_iterable(iter(range(10)), depth=3)) == list(range(10))

    def broken():
        yield 1
        raise KeyError("producer fault")

    it = prefetch_iterable(broken(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer fault"):
        next(it)
    endless = prefetch_iterable(itertools.count(), depth=2)
    assert next(endless) == 0  # the producer now blocks on the full queue
    endless.close()
    assert _threads_back_to(before)
    with pytest.raises(ValueError, match="depth"):
        next(prefetch_iterable([], depth=0))


def test_prefetch_loader_yields_the_loaders_batches():
    x, y = _ds(100)
    tf = lambda a, b: (a * 2, b)  # noqa: E731
    plain = ShardedLoader(ArrayDataset((x, y)), 8, CPU, seed=3, transform=tf)
    ahead = PrefetchLoader(ShardedLoader(ArrayDataset((x, y)), 8, CPU, seed=3, transform=tf))
    assert len(ahead) == len(plain) == 13 and ahead.global_batch == 8
    for epoch in (0, 1):
        plain.set_epoch(epoch)
        ahead.set_epoch(epoch)
        pairs = list(zip(plain, ahead, strict=True))
        assert all(torch.equal(a, b) for p, q in pairs for a, b in zip(p, q))
    before = _prefetch_threads()
    it = iter(ahead)
    next(it)
    it.close()
    assert _threads_back_to(before)


@pytest.mark.parametrize("world", [1, 2])
def test_chunks_byte_equal_to_jax(world, devices):
    x, y = _ds()
    jl = JaxChunked(jds.ArrayDataset((x, y)), 4, jax_mesh({"data": world}), seed=3,
                    steps_per_chunk=3)
    jl.set_epoch(1)
    want = [jax.device_get(c) for c in jl.iter_chunks()]
    assert [c[0].shape[0] for c in want] == [3] * (len(want) - 1) + [want[-1][0].shape[0]]
    for rank in range(world):
        tl = ChunkedStreamingLoader(ArrayDataset((x, y)), 4, port_mesh(world, rank), seed=3,
                                    steps_per_chunk=3)
        tl.set_epoch(1)
        got = list(tl.iter_chunks())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                cols = np.ascontiguousarray(b[:, rank * 4:(rank + 1) * 4])
                assert a.numpy().tobytes() == cols.tobytes() and tuple(a.shape) == cols.shape
        # step i of a chunk is the per-step loader's batch
        steps = [s for c in got for s in (tl.chunk_step(c, i) for i in range(c[0].shape[0]))]
        tl.set_epoch(1)
        assert all(torch.equal(a, b) for s, p in zip(steps, tl, strict=True)
                   for a, b in zip(s, p))


def test_chunked_validates():
    x, y = _ds()
    with pytest.raises(ValueError, match="steps_per_chunk"):
        ChunkedStreamingLoader(ArrayDataset((x, y)), 4, CPU, steps_per_chunk=0)
    with pytest.raises(ValueError, match="prefetch"):
        ChunkedStreamingLoader(ArrayDataset((x, y)), 4, CPU, prefetch=0)
    with pytest.raises(NotImplementedError, match="batch_specs"):
        ChunkedStreamingLoader(ArrayDataset((x, y)), 4, CPU, batch_spec=("data", "seq"))


def _images(n=64, seed=1):
    return jds._synthetic_images(n, (12, 12, 1), 10, template_seed=101, noise_seed=seed, raw=True)


def test_chunked_epoch_bitwise_the_per_step_epoch():
    ds = ArrayDataset(_images().arrays)
    tf = lambda x, y: (x.float() / 255, y)  # noqa: E731

    def run(loader):
        t = Trainer(resnet18(num_classes=10, stem="cifar", num_filters=8, in_channels=1),
                    loader, sgd(0.05, momentum=0.9), quiet=True, seed=4)
        t.train(2)
        return t

    per_step = run(ShardedLoader(ds, 16, CPU, transform=tf))
    chunked = run(ChunkedStreamingLoader(ds, 16, CPU, transform=tf, steps_per_chunk=3))
    assert [e["loss"] for e in chunked.metrics.step_events()] == [
        e["loss"] for e in per_step.metrics.step_events()]
    for a, b in zip(chunked.model.state_dict().values(), per_step.model.state_dict().values()):
        assert torch.equal(a, b)
    assert int(chunked.state.step) == 8 and chunked.host_syncs == 2  # one fetch an epoch


def test_chunked_epoch_follows_jax_in_float64(devices):
    x, y = _ds(96)
    with enable_x64(True):
        jt = JaxTrainer(JaxMLP(features=(16, 4), dtype=jnp.float64),
                        JaxChunked(jds.ArrayDataset((x, y)), 8, jax_mesh({"data": 1}), seed=3,
                                   steps_per_chunk=5),
                        optax.sgd(0.05), quiet=True)
        tt = Trainer(MLP(features=(16, 4), in_dim=16, dtype=torch.float64),
                     ChunkedStreamingLoader(ArrayDataset((x, y)), 8, CPU, seed=3,
                                            steps_per_chunk=5),
                     sgd(0.05), quiet=True)
        params = jax.tree_util.tree_map(np.asarray, jt.state.params)
        with torch.no_grad():
            for k, v in from_jax_params(params, tt.model, "cpu").items():
                tt.model.state_dict()[k].copy_(v)
        jt.train(2)
        tt.train(2)
        want = jax.tree_util.tree_map(np.asarray, jt.state.params)
    jl = [e["loss"] for e in jt.metrics.epoch_events()]
    tl = [e["loss"] for e in tt.metrics.epoch_events()]
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    got = tt.model.state_dict()
    for k, v in from_jax_params(want, tt.model, "cpu").items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6)
    assert int(tt.state.step) == int(jt.state.step) == 24
