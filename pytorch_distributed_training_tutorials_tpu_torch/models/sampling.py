"""The sampling pipeline shared by ``generate`` and the serving engine.

Port of ``pytorch_distributed_training_tutorials_tpu/models/sampling.py``:

- :func:`greedy_token` — argmax with an explicit lowest-index tie-break;
- :func:`filter_logits` — top-k and nucleus (top-p) filters, the nucleus
  resolved over the top ``min(V, 1024)`` candidates (no full-vocabulary
  sort);
- :func:`sample_logits` — one decision for a batch sharing one
  ``torch.Generator`` (the ``generate`` contract);
- :func:`sample_logits_per_slot` — one ``torch.Generator`` per row, so a
  serving request's draws depend only on its own seed and draw index.

A draw is the Gumbel-max trick over the filtered logits: ``argmax(logits /
T + g)``, ``g = -log(-log(u))``, ``u`` uniform from the row's generator —
a categorical sample with no host sync. JAX's threefry streams cannot be
reproduced in PyTorch, so sampled tokens match the JAX package in
distribution, not draw for draw; greedy is exact.
"""

from __future__ import annotations

import torch

# Candidate budget for nucleus filtering when top_k is off (as in JAX).
_NUCLEUS_CANDIDATES = 1024


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next token over ``(..., V)`` logits: among the positions
    holding the row maximum, the smallest vocabulary index wins. int64."""
    v = logits.shape[-1]
    top = logits.amax(dim=-1, keepdim=True)
    idx = torch.arange(v, device=logits.device)
    tied = torch.where(logits == top, idx, torch.full_like(idx, v))
    return tied.amin(dim=-1)


def filter_logits(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """``top_k`` keeps the k highest logits (boundary ties kept), ``top_p``
    keeps the smallest set whose softmax mass reaches p (the first token
    always kept); disallowed tokens get -inf. k first, then p."""
    v = logits.shape[-1]
    vals = None
    if 0 < top_k < v:
        vals = torch.topk(logits, top_k, dim=-1).values  # descending
        kth = vals[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -torch.inf), logits)
    if top_p < 1.0:
        if vals is None:
            vals = torch.topk(logits, min(v, _NUCLEUS_CANDIDATES), dim=-1).values
        z = torch.logsumexp(logits, dim=-1, keepdim=True)
        probs = torch.exp(vals - z)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        cutoff = torch.where(keep, vals, torch.full_like(vals, torch.inf)).amin(
            dim=-1, keepdim=True
        )
        logits = torch.where(logits < cutoff, torch.full_like(logits, -torch.inf), logits)
    return logits


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None,
                  temperature: float, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """One next-token decision over ``(B, V)`` float32 logits: greedy when
    ``temperature == 0`` (generator untouched), else temperature, then the
    filters, then one draw for the whole batch from ``generator``."""
    if temperature <= 0:
        return greedy_token(logits)
    filt = filter_logits(logits / temperature, top_k, top_p)
    return (filt + _gumbel(filt.shape, generator, filt.device)).argmax(dim=-1)


def sample_logits_per_slot(logits: torch.Tensor, generators,
                           temperature: float, top_k: int = 0,
                           top_p: float = 1.0) -> torch.Tensor:
    """:func:`sample_logits` with one generator per row: ``logits`` (S, V),
    ``generators`` a sequence of S ``torch.Generator`` — row s draws only
    from generator s, so co-scheduling cannot change a request's draws."""
    if temperature <= 0:
        return greedy_token(logits)
    filt = filter_logits(logits / temperature, top_k, top_p)
    noise = torch.stack(
        [_gumbel(filt.shape[-1:], g, filt.device) for g in generators]
    )
    return (filt + noise).argmax(dim=-1)
