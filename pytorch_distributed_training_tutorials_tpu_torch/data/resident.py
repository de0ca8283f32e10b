"""Device-resident dataset: port of the JAX package's ``data/resident.py``.

The dataset is copied to the device once, at its stored type (uint8
MNIST: 47 MB). Each epoch the exact ``DistributedSampler`` order is
computed on the host and this rank's ``(steps, per_device_batch)`` block
of the index matrix is uploaded in one copy; each step's batch is then an
``index_select`` of the resident arrays by one row of it, plus the
``transform`` — all on the device, with no host sync in the epoch. The
JAX package runs that epoch as one compiled ``lax.scan``; the port runs
it as eager steps (the trainer's resident path).
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_distributed_training_tutorials_tpu_torch.data.datasets import ArrayDataset
from pytorch_distributed_training_tutorials_tpu_torch.data.loader import ShardedLoader, to_device


class DeviceResidentLoader(ShardedLoader):
    """A :class:`ShardedLoader` whose dataset lives in device memory.
    Iterating it yields the same batches as the parent, gathered on the
    device."""

    def __init__(self, dataset: ArrayDataset, batch_size: int, mesh, *, transform=None,
                 **kwargs):
        if kwargs.get("batch_spec") is not None:
            raise NotImplementedError(
                "DeviceResidentLoader shards batches over the data axis only; "
                "use ShardedLoader for custom batch_specs"
            )
        super().__init__(dataset, batch_size, mesh, transform=transform, **kwargs)
        # replicated residency: every process holds the whole dataset, so
        # the per-step gather is local
        self.device_arrays = tuple(to_device(a, self.device) for a in dataset.arrays)

    def _local_index(self) -> torch.Tensor:
        shards = self._epoch_index_matrix()  # (world, steps * bs)
        idx = shards.reshape(self.world, self.steps_per_epoch, self.per_device_batch)[self.rank]
        return to_device(idx.astype(np.int64), self.device)

    def epoch_index_array(self, epoch: int) -> torch.Tensor:
        """This rank's ``(steps, per_device_batch)`` block of the epoch's
        ``(steps, global_batch)`` index matrix (columns ``rank * bs`` to
        ``(rank + 1) * bs``; all of it in a world of one), on the device."""
        self.set_epoch(epoch)
        return self._local_index()

    def batches(self, idx: torch.Tensor):
        """The transformed batches of an uploaded index matrix, one per
        row, gathered on the device."""
        n_arrays = len(self.device_arrays)
        for rows in idx:
            batch = tuple(a.index_select(0, rows) for a in self.device_arrays)
            yield self._apply_transform(batch if n_arrays > 1 else batch[0])

    def __iter__(self):
        return self.batches(self._local_index())
