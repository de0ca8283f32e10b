"""Ring attention: sequence (context) parallelism over the ``seq`` mesh axis.

Port of the JAX package's ``parallel/ring_attention.py``. Each rank holds
one sequence block of Q/K/V, ``(B, S/n, H, D)``; the K/V blocks travel
``n - 1`` hops around the seq group while each rank folds every block it
holds into its queries' attention state with the online-softmax update
(running max ``m``, normaliser ``l``, unnormalised accumulator ``o``), in
plain torch, as the JAX ring is plain jnp. Hop ``t`` folds the block that
started on rank ``(r - t) % n``: the rank's own block first, so every
query row sees its diagonal key before any other and its running max is
finite from the first fold on.

Memory: a hop folds its block in ``hop_block``-sized key sub-blocks, so
the live score tile is ``(S/n, hop_block)``; each hop and each sub-block
fold is a ``torch.utils.checkpoint`` region, so the backward re-derives
the scores instead of keeping one probability block a hop (the JAX
``jax.checkpoint`` on ``_ring_hop`` and its fold). The hop's send is
outside those regions: a recompute folds again but never sends again.

Communication: the hop is an autograd function (:class:`_RingShift`) —
forward, K and V (stacked, one message) sent to rank ``r + 1`` and
received from ``r - 1`` in one ``batch_isend_irecv``; backward, the
transpose: the gradient sent to ``r - 1`` and received from ``r + 1``.
Every rank issues the same hops in the same order, forward and backward.
gloo takes no CUDA tensor for a point-to-point send, so on a gloo group a
CUDA tensor is staged through host memory explicitly — counted under
``"staged"`` in :attr:`SeqShard.collectives` (:class:`.collective.Messages`),
never silently.

The returned ``attention_fn`` carries ``requires_seq_divisible = n`` (the
JAX attribute) and ``seq_shard`` (:class:`SeqShard`): the float train
forward of :class:`..models.transformer.TransformerLM` reads the rank's
global position offset from it (RoPE), and the serving paths, which hold
every token on every rank, prefill through the dense causal path instead.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from pytorch_distributed_training_tutorials_tpu_torch.parallel.collective import Messages
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import SEQ_AXIS


class SeqShard(Messages):
    """The seq group of a sequence-parallel attention: its ``size`` and
    this rank's coordinate ``rank`` (a mesh whose seq axis is one wide has
    no group), the messages it issued by kind (``collectives``, of
    :class:`.collective.Messages`), and the rank's global position
    offset."""

    def __init__(self, mesh, seq_axis: str = SEQ_AXIS):
        names = tuple(mesh.mesh_dim_names or ())
        if seq_axis not in names:
            raise ValueError(f"mesh has no {seq_axis!r} axis: {names}")
        self.size = mesh.size(names.index(seq_axis))
        self.rank = mesh.get_local_rank(seq_axis) if self.size > 1 else 0
        super().__init__(mesh.get_group(seq_axis) if self.size > 1 else None)

    def position_offset(self, s_local: int) -> int:
        """The global position of this rank's first token when every rank
        holds ``s_local`` consecutive positions."""
        return self.rank * s_local

    def shift(self, x: torch.Tensor, step: int, kind: str) -> torch.Tensor:
        """``x`` sent to rank ``r + step`` and the one of rank ``r - step``
        received, in one ``batch_isend_irecv``."""
        return self.exchange(x, (self.rank + step) % self.size,
                             (self.rank - step) % self.size, kind)


class _RingShift(torch.autograd.Function):
    """One ring hop: forward to ``r + 1``, the gradient back to ``r - 1``."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.shift(x, 1, "ring_hop")

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.shift(grad, -1, "ring_hop_grad"), None


def _fold_block(o, l, m, qb, kb, vb, q_pos, k_pos, scale: float):
    """Fold ONE key sub-block into the online-softmax state — the JAX
    ``_fold_block``: float32 scores, the causal mask on global positions,
    the running max, the rescale of ``l`` and ``o``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * scale
    causal = q_pos[:, None] >= k_pos[None, :]
    scores = torch.where(causal, scores, float("-inf"))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # m_new is finite from the first fold on (the diagonal block comes
    # first); corr = exp(-inf - finite) = 0 zeroes the empty state
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
    return o, l, m_new


def _remat(fn, *args):
    """``fn(*args)`` as a checkpoint region while autograd records."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _ring_hop(qb, k_t, v_t, o, l, m, q_pos, k_pos, scale: float, block: int):
    """One hop's fold of an incoming K/V block, in ``block``-sized key
    sub-blocks (a block that does not divide the hop's length folds it
    whole), each sub-fold its own checkpoint region."""
    s_blk = k_t.shape[1]
    block = min(block, s_blk)
    if s_blk % block:
        block = s_blk
    for j in range(0, s_blk, block):
        o, l, m = _remat(_fold_block, o, l, m, qb, k_t[:, j:j + block], v_t[:, j:j + block],
                         q_pos, k_pos[j:j + block], scale)
    return o, l, m


def make_ring_attention(mesh, *, seq_axis: str = SEQ_AXIS, hop_block: int = 512):
    """A causal ``attention_fn(q, k, v) -> out`` over the rank's sequence
    block (``(B, S/n, H, D)`` each, ``n`` the ``seq_axis`` width of
    ``mesh``): numerically the dense causal attention of the whole
    sequence, held as the JAX ring is in its tests. ``hop_block`` bounds
    the live score tile to ``(S/n, hop_block)``, forward and backward.
    Batch rows and heads are the rank's already (the JAX signature's
    ``data_axis`` and ``model_axis`` have nothing to name here)."""
    shard = SeqShard(mesh, seq_axis)
    n = shard.size

    def ring_attention(qb: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
        b, s_blk, h, d = qb.shape
        dev = qb.device
        steps = torch.arange(s_blk, device=dev)
        q_pos = shard.rank * s_blk + steps
        scale = 1.0 / math.sqrt(d)
        o = torch.zeros((b, h, s_blk, d), dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, s_blk), dtype=torch.float32, device=dev)
        m = torch.full((b, h, s_blk), float("-inf"), dtype=torch.float32, device=dev)
        k_t, v_t = kb, vb
        for t in range(n):
            # after t hops this rank holds the block that started on r - t
            k_pos = ((shard.rank - t) % n) * s_blk + steps
            o, l, m = _remat(_ring_hop, qb, k_t, v_t, o, l, m, q_pos, k_pos, scale, hop_block)
            if t < n - 1:
                k_t, v_t = _RingShift.apply(torch.stack([k_t, v_t]), shard).unbind(0)
        # causal: every query row saw at least its own diagonal block
        out = o / l[..., None]
        return out.transpose(1, 2).to(qb.dtype)

    ring_attention.requires_seq_divisible = n
    ring_attention.seq_shard = shard
    return ring_attention
