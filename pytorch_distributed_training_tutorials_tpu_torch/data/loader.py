"""Sharded loader: port of the JAX package's ``data/loader.py``.

The semantics stay the JAX loader's:

- ``--batch_size`` is per device: a step's global batch is
  ``per_device_batch * world`` (``batch_mode="global"`` divides instead);
- ``steps_per_epoch`` is the ceiling of the padded per-replica shard over
  the per-device batch (2048 samples, 32 per device, 4 devices: 16 steps);
- :meth:`ShardedLoader.set_epoch` reseeds the shuffle;
- the global batch is replica-major (rank r's rows are block r of dim 0),
  and :meth:`ShardedLoader.valid_mask` marks the wrap-padded rows in that
  order.

What changes is who holds a batch. One JAX process feeds every device of
the mesh from one array; in the DDP idiom each process holds its own
rank's rows, so iterating yields this rank's block — the global batch in
a world of one. ``batch_spec`` (the JAX ``PartitionSpec`` as a tuple of
axis names, e.g. ``("data", "seq")`` for sequence parallelism) cuts the
dimensions past 0 too: each rank gets its ``(B / d, S / n)`` block of the
tokens and of the targets (``synthetic_lm``'s are shifted already, so the
rank's targets are its own columns). Rows are gathered on the host
(:mod:`.native`), copied to the device, and ``transform`` (e.g.
``x.to(torch.bfloat16) / 255``) runs there.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_distributed_training_tutorials_tpu_torch.data.datasets import ArrayDataset
from pytorch_distributed_training_tutorials_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_rank,
    axis_size,
    mesh_device,
)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host sync: through pinned
    memory, copied asynchronously on the current stream (the caching host
    allocator keeps the pinned block until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class ShardedLoader:
    """Iterate this rank's rows of each global batch from a host dataset."""

    def __init__(self, dataset: ArrayDataset, batch_size: int, mesh, *, axis: str = DATA_AXIS,
                 batch_mode: str = "per_device", shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, batch_spec=None, transform=None):
        if batch_mode not in ("per_device", "global"):
            raise ValueError(f"unknown batch_mode {batch_mode!r}")
        self.dataset = dataset
        self.mesh = mesh
        self.axis = axis
        self.transform = transform
        self.device = mesh_device(mesh)
        self.world = axis_size(mesh, axis)
        self.rank = axis_rank(mesh, axis)
        if batch_mode == "global":
            if batch_size % self.world:
                raise ValueError(f"global batch {batch_size} not divisible by "
                                 f"{self.world} devices on axis {axis!r}")
            self.per_device_batch = batch_size // self.world
        else:
            self.per_device_batch = batch_size
        self.global_batch = self.per_device_batch * self.world
        self._cuts = self._spec_cuts(batch_spec)
        # one logical sampler enumerates every replica's shard (rank 0's
        # view of the flat order); each process then takes its own block
        self._sampler = DistributedSampler(len(dataset), self.world, 0, shuffle=shuffle,
                                           seed=seed, drop_last=drop_last)
        self.steps_per_epoch = -(-self._sampler.num_samples // self.per_device_batch)

    def _spec_cuts(self, batch_spec) -> list[tuple[int, int, int]]:
        """``batch_spec`` (one mesh axis name or None a dimension, e.g.
        ``("data", "seq")``) as the cuts of the dimensions past 0: ``(dim,
        width, this rank's block)`` for each dimension over an axis of
        the mesh wider than one. Dim 0 must map to the loader's axis (the
        steps and shards are its world's)."""
        if batch_spec is None:
            return []
        spec = tuple(batch_spec)
        dim0 = spec[0] if spec else None
        if self.world > 1 and dim0 != self.axis:
            raise ValueError(f"batch_spec dim 0 must map to the loader axis {self.axis!r} "
                             f"(got {dim0!r}): steps/shard math assumes it")
        return [(i, axis_size(self.mesh, a), axis_rank(self.mesh, a))
                for i, a in enumerate(spec) if i > 0 and a is not None
                and axis_size(self.mesh, a) > 1]

    def _cut(self, a: np.ndarray) -> np.ndarray:
        """This rank's block of ``a`` on every dimension ``batch_spec``
        shards past dim 0 (dimensions ``a`` lacks are skipped: a (B,)
        label array shares a (B, S) token array's spec)."""
        for dim, width, r in self._cuts:
            if dim >= a.ndim:
                continue
            if a.shape[dim] % width:
                raise ValueError(f"batch dim {dim} ({a.shape[dim]}) not divisible by the "
                                 f"{width} ranks batch_spec shards it over")
            n = a.shape[dim] // width
            a = a[(slice(None),) * dim + (slice(r * n, (r + 1) * n),)]
        return a

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shard permutation."""
        self._sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return self.steps_per_epoch

    def _apply_transform(self, batch):
        if self.transform is None:
            return batch
        if isinstance(batch, tuple):
            return self.transform(*batch)
        return self.transform(batch)

    def sample_batch(self):
        """A representative sample: full-length host views without a
        ``transform``; with one, a global batch's worth of rows on the
        device, transformed (the shapes and types training uses)."""
        arrays = self.dataset.arrays
        if self.transform is None:
            sample = tuple(a[:] for a in arrays)
            return sample if len(arrays) > 1 else sample[0]
        rows = min(len(self.dataset), self.global_batch)
        sample = tuple(to_device(a[:rows], self.device) for a in arrays)
        return self._apply_transform(sample if len(arrays) > 1 else sample[0])

    def valid_mask(self, step: int) -> np.ndarray:
        """(global_batch,) bool, replica-major like the batch rows: True for
        real samples, False for wrap-padding duplicates (the sampler's wrap
        to equal shards or the loader's wrap to whole steps)."""
        n = len(self.dataset)
        num_samples = self._sampler.num_samples
        lo = step * self.per_device_batch
        cols = np.arange(lo, lo + self.per_device_batch)
        ranks = np.arange(self.world)[:, None]
        real = (cols[None, :] < num_samples) & (cols[None, :] * self.world + ranks < n)
        return real.reshape(-1)

    def local_valid_mask(self, step: int) -> np.ndarray:
        """This rank's block of :meth:`valid_mask`."""
        pd = self.per_device_batch
        return self.valid_mask(step)[self.rank * pd:(self.rank + 1) * pd]

    def _epoch_index_matrix(self) -> np.ndarray:
        """(world, steps * per_device_batch) index matrix for this epoch."""
        flat = self._sampler._global_indices()
        shards = flat.reshape(self._sampler.num_samples, self.world).T
        need = self.steps_per_epoch * self.per_device_batch
        if shards.shape[1] < need:
            reps = -(-need // shards.shape[1])
            shards = np.tile(shards, (1, reps))[:, :need]
        return shards

    def host_batches(self):
        """This rank's rows of each step of the epoch, gathered on the host:
        one tuple of numpy arrays a step (what :meth:`__iter__` uploads)."""
        shards = self._epoch_index_matrix()
        for step in range(self.steps_per_epoch):
            lo = step * self.per_device_batch
            rows = self.dataset.gather(shards[self.rank, lo:lo + self.per_device_batch])
            yield tuple(self._cut(a) for a in rows) if self._cuts else rows

    def finish(self, batch: tuple[torch.Tensor, ...]):
        """A device batch as iteration yields it: unwrapped when the
        dataset has one array, then transformed."""
        return self._apply_transform(batch if len(batch) > 1 else batch[0])

    def __iter__(self):
        for arrays in self.host_batches():
            yield self.finish(tuple(to_device(a, self.device) for a in arrays))
