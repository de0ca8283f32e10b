"""Ulysses all-to-all sequence parallelism over the ``seq`` mesh axis.

Port of the JAX package's ``parallel/ulysses.py``: one ``all_to_all`` over
the seq group turns the rank's sequence block of Q/K/V, ``(B, S/n, H,
D)``, into the whole sequence of a head group, ``(B, S, H/n, D)``; the
inner attention runs there on whole sequences (any local kernel: the
dense causal attention by default, the port's flash op on the card), and
a second ``all_to_all`` turns the output back. Q, K and V travel stacked
in one message. Each exchange is an autograd function whose backward is
the inverse exchange of the gradient. On a gloo group a CUDA tensor is
staged through host memory explicitly (counted ``"staged"`` in the
shard's ``collectives``; :class:`.ring_attention.SeqShard`).

The ring (:mod:`.ring_attention`) and Ulysses are drop-ins for each other
through ``TransformerConfig.attention_fn`` and carry the same
``requires_seq_divisible`` and ``seq_shard`` attributes.
"""

from __future__ import annotations

import torch

from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import SEQ_AXIS
from pytorch_distributed_training_tutorials_tpu_torch.parallel.ring_attention import SeqShard


def _seq_to_heads(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """(L, B, S/n, H, D) -> (L, B, S, H/n, D): block ``j`` of the heads to
    rank ``j``, the sequence blocks concatenated in rank order."""
    n = shard.size
    lead, b, s, h, d = x.shape
    parts = x.reshape(lead, b, s, n, h // n, d).permute(3, 0, 1, 2, 4, 5).contiguous()
    got = shard.all_to_all(parts)  # (n, L, B, s, H/n, D): rank j's sequence block
    return got.permute(1, 2, 0, 3, 4, 5).reshape(lead, b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """(L, B, S, H/n, D) -> (L, B, S/n, H, D), the inverse exchange."""
    n = shard.size
    lead, b, s_all, hl, d = x.shape
    s = s_all // n
    parts = x.reshape(lead, b, n, s, hl, d).permute(2, 0, 1, 3, 4, 5).contiguous()
    got = shard.all_to_all(parts)  # (n, L, B, s, H/n, D): rank j's head group
    return got.permute(1, 2, 3, 0, 4, 5).reshape(lead, b, s, n * hl, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _seq_to_heads(x, shard)

    @staticmethod
    def backward(ctx, grad):
        return _heads_to_seq(grad, ctx.shard), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _heads_to_seq(x, shard)

    @staticmethod
    def backward(ctx, grad):
        return _seq_to_heads(grad, ctx.shard), None


def make_ulysses_attention(mesh, *, seq_axis: str = SEQ_AXIS, inner_attention=None):
    """A causal ``attention_fn(q, k, v) -> out`` over the rank's sequence
    block (``(B, S/n, H, D)`` each) through head redistribution.
    ``inner_attention`` is the whole-sequence attention run on the rank's
    ``H / n`` heads (default the float model's dense causal attention,
    :func:`..models.transformer.dense_causal_attention`). The rank's head
    count must divide by ``n``: each rank takes whole heads (ValueError
    otherwise). Rows and heads are the rank's already."""
    shard = SeqShard(mesh, seq_axis)
    n = shard.size
    if inner_attention is None:
        from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
            dense_causal_attention,
        )

        inner_attention = dense_causal_attention

    def ulysses_attention(qb: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
        h = qb.shape[2]
        if h % n:
            raise ValueError(f"Ulysses needs heads ({h} local) divisible by the "
                             f"{seq_axis!r} axis ({n})")
        if n == 1:
            return inner_attention(qb, kb, vb)
        q, k, v = _SeqToHeads.apply(torch.stack([qb, kb, vb]), shard).unbind(0)
        out = inner_attention(q, k, v)
        return _HeadsToSeq.apply(out[None], shard)[0]

    ulysses_attention.requires_seq_divisible = n
    ulysses_attention.seq_shard = shard
    return ulysses_attention
