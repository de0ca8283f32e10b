"""Mixture-of-Experts FFN with expert parallelism over the ``expert`` axis.

Port of the JAX package's ``models/moe.py``: the GShard/Mixtral dense
dispatch — routing, capacity accounting, dispatch and combine are
static-shape einsums, top-k routing is k greedy argmax passes, and the
capacity order is the JAX one (every first choice queues before any
second choice, in sequence order within a row), so the same tokens are
dropped. Capacity is per (batch row, expert): ``C = ceil(S * k / E) *
capacity_factor``. ``group_size`` routes and counts capacity per token
group (a padded tail group's pad tokens take no slot).

The load-balancing loss has no flax ``"losses"`` collection to be sown
into: each :class:`MoEFFN` keeps the value of its last forward, with its
graph, as its ``aux_loss`` attribute, and :func:`moe_aux_loss` sums them
over a model — the one carrier the ``Trainer`` reads
(``aux_loss_weight``). ``dropped`` is the same forward's count of routed
(token, choice) pairs that found their expert full (a device tensor, read
without a sync only by the caller).

Expert parallelism (``cfg.int8_mesh`` a
:class:`..parallel.tensor_parallel.TensorParallel` whose ``expert``
strategy spans ``ep`` ranks): the rank holds experts ``[r * E / ep, (r +
1) * E / ep)`` (:data:`MOE_RULES`, dim 0). Tokens are replicated over the
expert axis, as in the JAX mesh ``{"data": d, "expert": ep}``: every rank
routes the whole rows — the gates, the capacity positions (a cumsum over
the sequence) and the dispatch and combine tensors are computed whole
before the experts are split — runs its experts on its slice of the
dispatch, and the partial outputs are summed over the group (Megatron's
``g``). The backward's two partial regions enter through Megatron's ``f``:
the expert input ``x`` and the picks' combine scales ``w / sum(w)`` (k, B,
S) each sum their gradient over the group, so the gates' gradient is whole
before it reaches the router. The aux loss reads the gates outside
those regions: its gradient is whole on every rank already and is not
summed (an ``f`` on the gates would count it ``ep`` times).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# Expert-parallel layout in the port's state-dict names: the stacked
# expert weights (E, ...) split on dim 0 over the expert group; the router
# is replicated (no rule). ``(pattern, dim, unit)`` as the tensor-parallel
# rules (parallel/tensor_parallel.py).
MOE_RULES = [
    (r"(^|\.)moe\.(w_gate|w_up|w_down)$", 0, None),
]


def _collective(ep, x: torch.Tensor, kind: str) -> torch.Tensor:
    """``f`` or ``g`` of the expert group while autograd records; without
    it, ``g`` is the in-place sum and ``f`` the identity."""
    if ep is None:
        return x
    if kind == "f":
        return ep.copy_to(x) if torch.is_grad_enabled() else x
    return ep.reduce_from(x) if torch.is_grad_enabled() else ep.all_reduce(x)


class MoEFFN(nn.Module):
    """Top-k routed SwiGLU experts, dense dispatch; (B, S, d_model) in and
    out. Parameters as the JAX module's: ``router`` (d, E) and the stacked
    ``w_gate`` / ``w_up`` (E_local, d, ff), ``w_down`` (E_local, ff, d),
    float32, cast to ``dtype`` at use (the router computes in float32).
    ``ep``: the expert group's strategy (None: every expert here).

    Memory: the dispatch and combine tensors are (B, S, E, C) float32 —
    quadratic in S; ``group_size`` makes them (B * S / gs, gs, E, C_g)."""

    def __init__(self, d_model: int, num_experts: int = 8, top_k: int = 2,
                 d_ff: int | None = None, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32, group_size: int | None = None,
                 ep=None, device=None):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.dtype, self.group_size = capacity_factor, dtype, group_size
        self.ep = ep if ep is not None and ep.tp_size > 1 else None
        n = self.ep.tp_size if self.ep is not None else 1
        if num_experts % n:
            raise ValueError(f"{num_experts} experts over an expert group of {n}")
        local = num_experts // n
        self.lo = (self.ep.rank if self.ep is not None else 0) * local
        ff = d_ff if d_ff is not None else 4 * d_model
        self.router = nn.Parameter(torch.empty((d_model, num_experts), device=device))
        self.w_gate = nn.Parameter(torch.empty((local, d_model, ff), device=device))
        self.w_up = nn.Parameter(torch.empty((local, d_model, ff), device=device))
        self.w_down = nn.Parameter(torch.empty((local, ff, d_model), device=device))
        self.aux_loss = None
        self.dropped = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group_size is not None:
            b0, s0, d0 = x.shape
            # a group of <= S tokens degenerates to one group (decode at S 1)
            gs = min(self.group_size, s0)
            pad = (-s0) % gs
            if pad:
                # a tail group is padded, never merged: its pad tokens are
                # masked out of routing (no capacity slot, no output)
                x = F.pad(x, (0, 0, 0, pad))
            sp = s0 + pad
            if gs < sp or pad:
                valid = (torch.arange(sp, device=x.device) < s0).float()[None].expand(b0, sp)
                out = self._moe(x.reshape(b0 * (sp // gs), gs, d0),
                                valid.reshape(b0 * (sp // gs), gs))
                return out.reshape(b0, sp, d0)[:, :s0]
        return self._moe(x)

    def _route(self, x: torch.Tensor, valid: torch.Tensor | None):
        """The JAX routing, line for line, on the whole rows: the gates (B,
        S, E) and their top-k picks, the aux loss, and for each pick its
        capacity slots (B, S, E, C) and combine scale ``w / sum(w)`` (B,
        S), stacked (k, B, S); the dispatch (B, S, E, C) and the dropped
        count."""
        b, s, _ = x.shape
        e, k = self.num_experts, self.top_k
        cap = max(int(-(-s * k // e) * self.capacity_factor), 1)
        gates = torch.softmax(torch.einsum("bsd,de->bse", x.float(), self.router), dim=-1)
        g, picks, weights = gates, [], []
        for _ in range(k):
            onehot = F.one_hot(torch.argmax(g, dim=-1), e).float()
            if valid is not None:
                onehot = onehot * valid[..., None]
            picks.append(onehot)
            weights.append((g * onehot).sum(-1))
            g = g * (1.0 - onehot)
        weight_sum = sum(weights) + 1e-9
        # Switch/GShard load balance: first-choice load times mean gate
        aux = e * (picks[0].mean(1) * gates.mean(1)).sum(-1).mean()
        dispatch = torch.zeros((b, s, e, cap), device=x.device)
        filled = torch.zeros((b, e), device=x.device)
        slots, kept = [], torch.zeros((), device=x.device)
        for onehot in picks:
            # first choices fill before second ones, in sequence order
            pos = filled[:, None, :] + torch.cumsum(onehot, dim=1) - onehot
            filled = filled + onehot.sum(1)
            keep = onehot * (pos < cap)
            # a position past the capacity is kept out by `keep`
            slot = F.one_hot(pos.long().clamp(max=cap - 1), cap) * keep[..., None]
            dispatch = dispatch + slot
            slots.append(slot)
            kept = kept + keep.sum()
        scales = torch.stack([w / weight_sum for w in weights])
        dropped = sum(p.sum() for p in picks) - kept
        return dispatch, slots, scales, aux, dropped

    def _moe(self, x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        dispatch, slots, scales, aux, dropped = self._route(x, valid)
        self.aux_loss, self.dropped = aux, dropped.detach().to(torch.int64)
        dt = self.dtype
        lo, hi = self.lo, self.lo + self.w_gate.shape[0]
        # the rank's experts: its slice of the whole dispatch; the input
        # and the combine scales enter the partial region through f
        xe = _collective(self.ep, x, "f").to(dt)
        scales = _collective(self.ep, scales, "f")
        xin = torch.einsum("bsec,bsd->becd", dispatch[:, :, lo:hi].to(dt), xe)
        h = F.silu(torch.einsum("becd,edf->becf", xin, self.w_gate.to(dt))) * torch.einsum(
            "becd,edf->becf", xin, self.w_up.to(dt))
        out = torch.einsum("becf,efd->becd", h, self.w_down.to(dt))
        combine = torch.zeros_like(slots[0][:, :, lo:hi])
        for slot, scale in zip(slots, scales):
            combine = combine + slot[:, :, lo:hi] * scale[:, :, None, None]
        y = torch.einsum("bsec,becd->bsd", combine.to(dt), out)
        return _collective(self.ep, y, "g").to(x.dtype)


def moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """The sum of every :class:`MoEFFN`'s load-balancing loss from its last
    forward (one a MoE layer): add ``aux_weight * moe_aux_loss(model)`` to
    the objective. 0 for a model without MoE layers."""
    terms = [m.aux_loss for m in model.modules() if isinstance(m, MoEFFN)
             and m.aux_loss is not None]
    if not terms:
        return torch.zeros(())
    return torch.stack(terms).sum()


def moe_dropped(model: nn.Module) -> list[torch.Tensor]:
    """Each MoE layer's dropped (token, choice) count from its last
    forward, in module order (device tensors, unfetched)."""
    return [m.dropped for m in model.modules() if isinstance(m, MoEFFN)]
