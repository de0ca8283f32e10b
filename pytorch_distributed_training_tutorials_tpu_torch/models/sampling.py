"""The sampling pipeline shared by ``generate`` and the serving engine.

Port of ``pytorch_distributed_training_tutorials_tpu/models/sampling.py``:

- :func:`greedy_token` — argmax with an explicit lowest-index tie-break;
- :func:`filter_logits` — top-k and nucleus (top-p) filters, the nucleus
  resolved over the top ``min(V, 1024)`` candidates (no full-vocabulary
  sort);
- :func:`sample_logits` — one decision for a batch sharing one
  ``torch.Generator`` (the ``generate`` contract);
- :func:`sample_logits_per_slot` — one ``torch.Generator`` per row, so a
  serving request's draws depend only on its own seed and draw index;
- :func:`ngram_draft` / :func:`speculative_accept` — the speculative
  pipeline (prompt-lookup drafting, Saxena 2023; Leviathan et al. 2023
  verify) shared by the serving engine's verify chain and
  ``generate(..., speculative_k=...)``: fixed shapes, the accepted length
  is data on the device, never a host branch.

A draw is the Gumbel-max trick over the filtered logits: ``argmax(logits /
T + g)``, ``g = -log(-log(u))``, ``u`` uniform from the row's generator —
a categorical sample with no host sync. JAX's threefry streams cannot be
reproduced in PyTorch, so sampled tokens match the JAX package in
distribution, not draw for draw; greedy is exact. The speculative accept
takes its draws apart from its arithmetic (:func:`accept_with_draws`), so
the arithmetic can be fed any stream's uniforms and Gumbel noise.
"""

from __future__ import annotations

import torch

# Candidate budget for nucleus filtering when top_k is off (as in JAX).
_NUCLEUS_CANDIDATES = 1024


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next token over ``(..., V)`` logits: among the positions
    holding the row maximum, the smallest vocabulary index wins. int64.

    A row holding a NaN has no position equal to its maximum (NaN); it
    gives ``V - 1``, a token the embedding can read, so a poisoned row
    never indexes out of range (a device-side assert on a card). A finite
    row's maximum is attained, so the fill value never wins there."""
    v = logits.shape[-1]
    top = logits.amax(dim=-1, keepdim=True)
    idx = torch.arange(v, device=logits.device)
    tied = torch.where(logits == top, idx, torch.full_like(idx, v - 1))
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


# ---------------------------------------------------------------------------
# speculative decoding: prompt-lookup draft + vectorized accept/reject
# ---------------------------------------------------------------------------

def ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, k: int,
                ngram: int) -> torch.Tensor:
    """Draft ``k`` tokens per row from the row's own token history —
    prompt-lookup decoding (Saxena 2023): no second model.

    ``hist``: (B, W) int token history per row (prompt and everything
    emitted so far, junk beyond ``hist_len``); ``hist_len``: (B,) count of
    valid tokens (the token at ``hist_len - 1`` is the next decode input).
    Fixed-shape gathers and compares on the device, no host sync.

    Each candidate end position ``i < hist_len - 1`` is scored by how many
    of the trailing ``ngram`` tokens it matches (compare + cumprod: the
    longest-suffix length); the longest match wins, ties to the most recent
    (one score, ``mlen * W + i``), and the ``k`` tokens following it are
    the draft. No match, or a continuation past the history: those
    positions fill with the row's last token. int64 (B, k)."""
    if k < 1:
        raise ValueError("k must be >= 1")
    if ngram < 1:
        raise ValueError("ngram must be >= 1")
    b, w = hist.shape
    dev = hist.device
    rows = torch.arange(b, device=dev)
    back = torch.arange(ngram, device=dev)  # tokens back from the end
    # suffix[r, t] = hist[r, L-1-t]: the trailing ngram, newest first
    suf_idx = hist_len[:, None] - 1 - back[None, :]
    suf = hist[rows[:, None], suf_idx.clamp(min=0)]
    # cand[r, i, t] = hist[r, i-t]: the ngram ending at candidate i
    idx = torch.arange(w, device=dev)[None, :, None] - back[None, None, :]
    cand = hist[rows[:, None, None], idx.clamp(min=0)]
    eq = (cand == suf[:, None, :]) & (idx >= 0) & (suf_idx[:, None, :] >= 0)
    mlen = torch.cumprod(eq.to(torch.int64), dim=-1).sum(-1)  # (B, W)
    pos = torch.arange(w, device=dev)[None, :]
    # a real prior occurrence with at least one continuation (this also
    # excludes the trivial self-match at L-1)
    valid = (mlen >= 1) & (pos < hist_len[:, None] - 1)
    score = torch.where(valid, mlen * w + pos, -1)
    best = score.argmax(dim=-1)  # scores are distinct per position
    has = score.amax(dim=-1) >= 0
    cont = best[:, None] + 1 + torch.arange(k, device=dev)[None, :]
    in_range = cont <= hist_len[:, None] - 1
    last = hist[rows, (hist_len - 1).clamp(min=0)]
    return torch.where(has[:, None] & in_range,
                       hist[rows[:, None], cont.clamp(max=w - 1)], last[:, None])


def accept_with_draws(logits: torch.Tensor, draft: torch.Tensor, u: torch.Tensor,
                      gumbel: torch.Tensor, temperature: float, top_k: int = 0,
                      top_p: float = 1.0):
    """The sampled arithmetic of :func:`speculative_accept` on given draws:
    ``u`` (B, k) uniforms, one a draft token, and ``gumbel`` (B, V) noise
    for the bonus draw (a categorical draw is the argmax of logits plus
    Gumbel noise, which is how the JAX package's ``categorical`` draws
    too). Draft i is accepted while ``u_i < p_i(draft_i)``; on the first
    rejection the bonus is drawn from ``p`` with the rejected token masked
    out (the residual of a point-mass proposal); all k accepted, from
    ``p_k``. Returns ``(emitted (B, k+1), n_accept (B,), residual (B,
    V))``, ``residual`` the log-probabilities the bonus was drawn from."""
    b, k1, v = logits.shape
    k = k1 - 1
    dev = logits.device
    rows = torch.arange(b, device=dev)
    logp = torch.log_softmax(filter_logits(logits / temperature, top_k, top_p), dim=-1)
    p_draft = torch.exp(torch.gather(logp[:, :k], 2, draft[..., None]))[..., 0]
    n_accept = torch.cumprod((u < p_draft).to(torch.int64), dim=-1).sum(-1)
    bonus_logits = logp[rows, n_accept]  # (B, V)
    d_rej = draft[rows, n_accept.clamp(max=k - 1)]
    rejected = (n_accept < k)[:, None]
    residual = torch.where(
        rejected & (torch.arange(v, device=dev)[None, :] == d_rej[:, None]),
        torch.full_like(bonus_logits, -torch.inf), bonus_logits)
    bonus = (residual + gumbel).argmax(dim=-1)
    emitted = torch.where(torch.arange(k1, device=dev)[None, :] < n_accept[:, None],
                          torch.cat([draft, draft[:, -1:]], dim=1), bonus[:, None])
    return emitted, n_accept, residual


def speculative_accept(logits: torch.Tensor, draft: torch.Tensor, generators,
                       temperature: float, top_k: int = 0, top_p: float = 1.0):
    """Vectorized accept/reject of a point-mass draft — the verify half of
    speculative decoding (Leviathan et al. 2023); the accepted length is
    data, never a host branch.

    ``logits``: (B, k+1, V) float32 verify logits (position i is the
    distribution of the token following input i of ``[last_tok, draft_0
    .. draft_{k-1}]``); ``draft``: (B, k) int; ``generators``: B
    ``torch.Generator``, one a row (untouched when greedy). Returns
    ``(emitted (B, k+1) int64, n_accept (B,) int64)``: the first
    ``n_accept`` columns are the accepted draft, column ``n_accept`` the
    bonus token, later columns padding — every call emits ``n_accept + 1``
    tokens.

    Greedy: accept while ``draft[i] == greedy_token(logits[i])`` (cumprod
    prefix); ``emitted`` is the greedy rollout, so speculation is exact by
    construction. ``temperature > 0``: row r's generator draws ``k``
    uniforms, then one Gumbel row of V (a request's draws depend only on
    its own generator), and :func:`accept_with_draws` decides."""
    if temperature <= 0:
        out = greedy_token(logits)  # (B, k+1)
        ok = draft == out[:, :-1]
        return out, torch.cumprod(ok.to(torch.int64), dim=-1).sum(-1)
    b, k1, v = logits.shape
    dev = logits.device
    draws = [(torch.rand((k1 - 1,), generator=g, device=dev), _gumbel((v,), g, dev))
             for g in generators]
    u = torch.stack([d[0] for d in draws])
    gumbel = torch.stack([d[1] for d in draws])
    emitted, n_accept, _ = accept_with_draws(logits, draft, u, gumbel, temperature,
                                             top_k, top_p)
    return emitted, n_accept
