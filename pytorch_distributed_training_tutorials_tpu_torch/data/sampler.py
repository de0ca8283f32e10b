"""DistributedSampler-exact index sharding (an own copy of the JAX
package's ``data/sampler.py``, index for index).

- ``num_samples = ceil(len(ds) / world)`` (``floor`` with ``drop_last``
  when the dataset does not divide), ``total = num_samples * world``;
- shuffle: numpy ``PCG64(seed + epoch).permutation(len(ds))`` — not
  ``torch.randperm``, whose order differs — else ``arange``;
- padding: wrap around from the start, repeating the prefix as often as
  needed (a world larger than the dataset), or truncate with
  ``drop_last``;
- rank r takes ``indices[r::world]``: shards are disjoint and equal, so
  every rank runs the same number of steps (no collective deadlocks).
"""

from __future__ import annotations

import numpy as np


class DistributedSampler:
    """Per-rank disjoint, equal-length index shards with epoch reshuffle."""

    def __init__(self, dataset_size: int, num_replicas: int, rank: int, *,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_size % num_replicas:
            self.num_samples = dataset_size // num_replicas
        else:
            self.num_samples = -(-dataset_size // num_replicas)  # ceil
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shard permutation."""
        self.epoch = epoch

    def _global_indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.Generator(np.random.PCG64(self.seed + self.epoch))
            indices = rng.permutation(self.dataset_size)
        else:
            indices = np.arange(self.dataset_size)
        if not self.drop_last:
            pad = self.total_size - len(indices)
            if pad > 0:
                reps = -(-pad // len(indices))
                indices = np.concatenate([indices] + [indices] * reps)[: self.total_size]
        else:
            indices = indices[: self.total_size]
        return indices

    def local_indices(self) -> np.ndarray:
        """This rank's shard: the strided slice ``indices[rank::world]``."""
        return self._global_indices()[self.rank :: self.num_replicas]

    def __iter__(self):
        return iter(self.local_indices().tolist())

    def __len__(self) -> int:
        return self.num_samples
