"""Data parallelism on ``torch.distributed``: port of the JAX package's
``parallel/data_parallel.py`` with its four-method strategy interface
(``num_devices``, ``variable_shardings``, ``shard_state``,
``shard_batch``).

The JAX package replicates the parameters and shards the batch; XLA then
inserts the gradient all-reduce, and the all-reduce of every BatchNorm's
batch statistics (a flax ``BatchNorm`` over a batch sharded on ``data``
takes its mean over the global batch). In the port each process holds its
own rank's rows, so the strategy makes both explicit:

- :meth:`DataParallel.shard_state` broadcasts the parameters and buffers
  from rank 0 (DDP's construction-time broadcast), hands every module with
  a ``sync_group`` attribute (the port's ``BatchNorm``) the data group,
  and sets the state's ``grad_sync`` to :meth:`all_reduce_mean_`;
- the train step takes gradients with ``torch.autograd.grad``, which does
  not fire ``DistributedDataParallel``'s reducer hooks, and then calls
  ``grad_sync``: the gradients and the loss averaged over the data axis,
  in buckets (``parallel/collective.py``);
- BatchNorm sums ``x`` and ``x * x`` and the count through
  ``collective.all_reduce_sum``, whose backward all-reduces the gradient
  too.

A data axis of width 1 needs no collective, as XLA inserts none on a
one-device mesh: ``grad_sync`` is then ``None`` and BatchNorm keeps its
local statistics.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pytorch_distributed_training_tutorials_tpu_torch.parallel.collective import all_reduce_mean_
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_rank,
    axis_size,
    create_mesh,
    mesh_device,
)


class DataParallel:
    """Replicated parameters, the batch split on dim 0 over the data axis."""

    def __init__(self, mesh=None, axis: str = DATA_AXIS):
        self.mesh = mesh if mesh is not None else create_mesh()
        self.axis = axis

    @property
    def num_devices(self) -> int:
        # INTERFACE CONTRACT (all strategies): the DATA-axis width — how
        # many ways the batch's dim 0 is split — not the device count
        return axis_size(self.mesh, self.axis)

    @property
    def rank(self) -> int:
        return axis_rank(self.mesh, self.axis)

    @property
    def group(self):
        return self.mesh.get_group(self.axis) if self.num_devices > 1 else None

    def variable_shardings(self, model) -> dict:
        """Every parameter and buffer replicated, by state-dict name."""
        from torch.distributed.tensor import Replicate

        return {name: (Replicate(),) for name in model.state_dict()}

    def shard_state(self, state):
        """Make a train state data parallel: rank 0's parameters and
        buffers broadcast to every rank, BatchNorm synced over the data
        axis, and the gradients all-reduced each step (``grad_sync``)."""
        group = self.group
        if group is not None:
            src = dist.get_global_rank(group, 0)
            with torch.no_grad():
                for t in list(state.model.parameters()) + list(state.model.buffers()):
                    dist.broadcast(t, src, group=group)
        for module in state.model.modules():
            if hasattr(module, "sync_group"):
                module.sync_group = group
        state.grad_sync = self.all_reduce_mean_ if group is not None else None
        return state

    def shard_batch(self, batch):
        """This rank's rows of a global batch (its block of dim 0, the
        replica-major layout), on this process's device."""
        dev = mesh_device(self.mesh)
        w, r = self.num_devices, self.rank

        def take(a):
            a = torch.as_tensor(a)
            if a.shape[0] % w:
                raise ValueError(f"batch dim 0 ({a.shape[0]}) not divisible by {w} devices")
            n = a.shape[0] // w
            return a[r * n:(r + 1) * n].to(dev)

        if isinstance(batch, tuple):
            return tuple(take(a) for a in batch)
        return take(batch)

    def all_reduce_mean_(self, tensors: list[torch.Tensor]) -> None:
        """Average ``tensors`` over the data axis in place, in buckets
        (:func:`..parallel.collective.all_reduce_mean_`)."""
        if self.group is not None:
            all_reduce_mean_(tensors, self.group, self.num_devices)
