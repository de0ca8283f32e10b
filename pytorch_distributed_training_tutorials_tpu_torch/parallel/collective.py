"""The collectives of the port's strategies, on ``torch.distributed``:
the differentiable sum that BatchNorm takes its statistics through, the
bucketed in-place mean of the gradients, and :class:`Messages` — the
counted point-to-point and all-to-all messages of the pipeline's stage
group and the sequence-parallel seq group.

One decision lives here, :func:`stages_through_host`: a CUDA tensor on a
gloo group (ranks that share one card: NCCL refuses a communicator whose
ranks share a device) goes through host memory. gloo sends no CUDA
tensor point to point, so :class:`Messages` copies it to the host and
back explicitly and counts each such message under ``"staged"``; FSDP
picks its collective route by the same test."""

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


def bucket_plan(tensors: list[torch.Tensor]) -> list[list[int]]:
    """The all-reduce buckets of :func:`all_reduce_mean_`: indices into
    ``tensors``, grouped by dtype in first-seen order, each bucket closed
    once it holds :data:`BUCKET_BYTES` or more."""
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    plan = []
    for indices in by_dtype.values():
        bucket, nbytes = [], 0
        for i in indices:
            bucket.append(i)
            nbytes += tensors[i].numel() * tensors[i].element_size()
            if nbytes >= BUCKET_BYTES:
                plan.append(bucket)
                bucket, nbytes = [], 0
        if bucket:
            plan.append(bucket)
    return plan


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor], group, world: int) -> None:
    """Average ``tensors`` over ``group`` (``world`` ranks) in place: one
    all-reduce per bucket of :func:`bucket_plan`."""
    for bucket in bucket_plan(tensors):
        _reduce_bucket([tensors[i] for i in bucket], group, world)


def _reduce_bucket(bucket: list[torch.Tensor], group, world: int) -> None:
    flat = _flatten_dense_tensors(bucket)
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    for t, reduced in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
        t.copy_(reduced)


def stages_through_host(group, device) -> bool:
    """True when a message on ``device`` over ``group`` goes through host
    memory: a CUDA tensor on a gloo group."""
    return torch.device(device).type == "cuda" and dist.get_backend(group) == "gloo"


class Messages:
    """The counted messages of one process group (None: a group of one,
    which sends nothing): point-to-point sends and receives, a paired
    exchange, and an all-to-all, each counted under its ``kind`` in
    :attr:`collectives`, and under ``"staged"`` too when it goes through
    host memory (:func:`stages_through_host`). Peers are ranks in the
    group. Every rank must issue the same messages in the same order."""

    def __init__(self, group):
        self.group = group
        self.collectives: dict[str, int] = {}

    def reset_collectives(self) -> None:
        self.collectives = {}

    def count(self, kind: str) -> None:
        self.collectives[kind] = self.collectives.get(kind, 0) + 1

    def _staged(self, kind: str, device) -> bool:
        """Count one message of ``kind`` on ``device``; True (and counted
        ``"staged"``) when it goes through host memory."""
        self.count(kind)
        staged = stages_through_host(self.group, device)
        if staged:
            self.count("staged")
        return staged

    def _wire(self, x: torch.Tensor, kind: str) -> tuple[torch.Tensor, bool]:
        """The bytes of ``x`` to put on the wire (detached, on the host when
        staged) and whether they were staged."""
        staged = self._staged(kind, x.device)
        return (x.detach().to("cpu") if staged else x.detach().contiguous()), staged

    def peer(self, rank: int) -> int:
        """The global rank of group rank ``rank``."""
        return dist.get_global_rank(self.group, rank)

    def send(self, x: torch.Tensor, peer: int, tag: int, kind: str = "send") -> None:
        buf, _ = self._wire(x, kind)
        dist.send(buf, self.peer(peer), group=self.group, tag=tag)

    def recv(self, shape, dtype, device, peer: int, tag: int, kind: str = "recv"
             ) -> torch.Tensor:
        staged = self._staged(kind, device)
        buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
        dist.recv(buf, self.peer(peer), group=self.group, tag=tag)
        return buf.to(device) if staged else buf

    def exchange(self, x: torch.Tensor, to: int, frm: int, kind: str) -> torch.Tensor:
        """``x`` sent to ``to`` and one of its shape received from ``frm``,
        in one ``batch_isend_irecv``."""
        buf, staged = self._wire(x, kind)
        out = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, self.peer(to), self.group),
               dist.P2POp(dist.irecv, out, self.peer(frm), self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out.to(x.device) if staged else out

    def all_to_all(self, x: torch.Tensor, kind: str = "all_to_all") -> torch.Tensor:
        """Block ``j`` of ``x``'s dim 0 (one equal block a rank) sent to rank
        ``j``; block ``j`` of the result received from rank ``j``."""
        buf, staged = self._wire(x, kind)
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=self.group)
        return out.to(x.device) if staged else out
