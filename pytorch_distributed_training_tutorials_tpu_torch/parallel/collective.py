"""The collectives of data parallelism, on ``torch.distributed``: the
differentiable sum that BatchNorm takes its statistics through, and the
bucketed in-place mean of the gradients. The model layer and the strategy
both import them from here."""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

# gradient bucket size of one all-reduce (DDP's default bucket_cap_mb)
BUCKET_BYTES = 25 * 1024 * 1024


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the incoming gradients over
    the group too (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor], group, world: int) -> None:
    """Average ``tensors`` over ``group`` (``world`` ranks) in place: one
    all-reduce per bucket of up to :data:`BUCKET_BYTES` of one dtype."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        bucket, nbytes = [], 0
        for t in group_tensors:
            bucket.append(t)
            nbytes += t.numel() * t.element_size()
            if nbytes >= BUCKET_BYTES:
                _reduce_bucket(bucket, group, world)
                bucket, nbytes = [], 0
        if bucket:
            _reduce_bucket(bucket, group, world)


def _reduce_bucket(bucket: list[torch.Tensor], group, world: int) -> None:
    flat = _flatten_dense_tensors(bucket)
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    for t, reduced in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
        t.copy_(reduced)
