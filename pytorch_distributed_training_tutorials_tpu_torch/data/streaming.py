"""Chunked streaming: one gather and one upload for many steps (port of
the JAX package's ``data/streaming.py``).

A dataset that does not live on the card streams from the host. Per step
that is one gather and one small upload each; :class:`ChunkedStreamingLoader`
gathers ``steps_per_chunk`` steps' rows of this rank at once and uploads
them as ONE ``(steps, per_device_batch, ...)`` tensor per array, the next
chunk prefetched in a background thread through pinned buffers on its own
stream (:mod:`.prefetch`), while the trainer runs the current chunk's
steps (``Trainer._run_epoch_chunked``). The card holds at most
``prefetch + 2`` chunks of input.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_distributed_training_tutorials_tpu_torch.data.datasets import ArrayDataset
from pytorch_distributed_training_tutorials_tpu_torch.data.loader import ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.data.native import gather_rows
from pytorch_distributed_training_tutorials_tpu_torch.data.prefetch import (
    Stager,
    prefetch_iterable,
)


class ChunkedStreamingLoader(ShardedLoader):
    """A :class:`ShardedLoader` that also serves whole multi-step chunks.

    Per-step iteration (``__iter__``) keeps the parent's semantics;
    :meth:`iter_chunks` yields each chunk as a tuple of raw device tensors
    of ``(steps, per_device_batch, ...)``, and :meth:`chunk_step` makes
    step ``i`` of a chunk into the batch ``__iter__`` would yield (the
    ``transform`` runs there, on the consumer's stream)."""

    def __init__(self, dataset: ArrayDataset, batch_size: int, mesh, *,
                 steps_per_chunk: int = 16, prefetch: int = 2, transform=None, **kwargs):
        if kwargs.get("batch_spec") is not None:
            raise NotImplementedError(
                "ChunkedStreamingLoader shards batches over the data axis "
                "only; use ShardedLoader for custom batch_specs"
            )
        if steps_per_chunk < 1:
            raise ValueError("steps_per_chunk must be >= 1")
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        super().__init__(dataset, batch_size, mesh, transform=transform, **kwargs)
        self.steps_per_chunk = steps_per_chunk
        self.prefetch = prefetch

    def _make_chunk(self, step_rows: np.ndarray) -> tuple[np.ndarray, ...]:
        """One chunk on the host: ``step_rows`` is this rank's (c,
        per_device_batch) block of dataset indices; one gather of its
        ``c * per_device_batch`` rows per array."""
        c, bs = step_rows.shape
        return tuple(gather_rows(a, step_rows.reshape(-1)).reshape(c, bs, *a.shape[1:])
                     for a in self.dataset.arrays)

    def host_chunks(self):
        """The epoch's chunks on the host, in step order (the last may be
        shorter). Rank r's rows of step s are columns ``r * bs`` to ``(r +
        1) * bs`` of the global (replica-major) batch: row s of its shard's
        ``(steps, bs)`` reshape."""
        rows = self._epoch_index_matrix()[self.rank].reshape(self.steps_per_epoch,
                                                              self.per_device_batch)
        for lo in range(0, self.steps_per_epoch, self.steps_per_chunk):
            yield self._make_chunk(rows[lo:lo + self.steps_per_chunk])

    def iter_chunks(self):
        """Yield the epoch as device chunks, each uploaded ahead of its
        use in the loader's thread."""
        stager = Stager(self.device, self.prefetch + 2)
        staged = prefetch_iterable((stager.put(c) for c in self.host_chunks()), self.prefetch)
        try:
            for tensors, event in staged:
                yield stager.take(tensors, event)
        finally:
            staged.close()

    def chunk_step(self, chunk: tuple[torch.Tensor, ...], i: int):
        """Step ``i`` of a device chunk, as ``__iter__`` yields it."""
        return self.finish(tuple(a[i] for a in chunk))
