"""Autoregressive generation with a KV cache.

Port of ``pytorch_distributed_training_tutorials_tpu/models/generate.py``:
the prompt is prefilled in ONE batched forward that writes the cache for
positions ``[0, P)``, then a decode loop appends one position per step —
or, with ``speculative_k``, drafts ``k`` tokens a row from the sequence so
far and verifies them in one (B, k+1) decode forward a step. PyTorch runs
it eagerly; the JAX package compiles the same loops as one program.
"""

from __future__ import annotations

import torch

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
from pytorch_distributed_training_tutorials_tpu_torch.models.sampling import (
    ngram_draft,
    sample_logits,
    speculative_accept,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    KVCache,
    TransformerLM,
    bind_params,
    rewind_cache_index,
)


@torch.no_grad()
def generate(
    model: TransformerLM,
    params,
    prompt,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: torch.Generator | None = None,
    device=None,
    speculative_k: int = 0,
    spec_ngram: int = 3,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` (B, P) ints.
    Returns int64 (B, P + max_new_tokens) on ``device`` (``cuda`` unless
    the caller passes another).

    ``params`` (a state dict from the weight bridge, or None when
    ``model`` already holds its weights) is bound into ``model``. Greedy
    when ``temperature == 0``; otherwise sampled at that temperature from
    ``generator`` (required), filtered by ``top_k`` / ``top_p`` after the
    temperature. The cache is sized to the request (:func:`_window_len`),
    not the model's maximum.

    ``speculative_k > 0`` decodes self-speculatively (:func:`_spec_decode`,
    the one-shot mirror of the serving engine's verify chain): greedy
    output is token-identical to ``speculative_k=0``, only the number of
    forwards changes; sampled output follows the same distribution from
    another draw stream."""
    dev = resolve_device(device)
    if params is not None:
        bind_params(model, params)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
    b, p_len = prompt.shape
    if p_len < 1:
        raise ValueError("prompt must contain at least one token")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    total = p_len + max_new_tokens
    cfg = model.cfg
    if total > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({p_len}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq_len {cfg.max_seq_len}"
        )
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    if speculative_k < 0:
        raise ValueError(f"speculative_k must be >= 0, got {speculative_k}")
    if speculative_k and spec_ngram < 1:
        raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")

    def sample(logits):
        return sample_logits(logits, generator, temperature, top_k, top_p)

    # speculative: one spare column past the sequence, where a step's
    # writes past the budget land (cut off at the end)
    tokens = torch.zeros((b, total + bool(speculative_k)), dtype=torch.int64, device=dev)
    tokens[:, :p_len] = prompt
    cache = KVCache.zeros(cfg, b, _window_len(cfg, total), device=dev)
    logits = model(prompt, cache, prefill=True)
    tokens[:, p_len] = sample(logits[:, -1].float())
    if speculative_k:
        gens = [generator] * b
        _spec_decode(model, cache, tokens, p_len, total, speculative_k, spec_ngram,
                     lambda lg, draft: speculative_accept(lg, draft, gens, temperature,
                                                          top_k, top_p))
        return tokens[:, :total].contiguous()
    for t in range(p_len, total - 1):
        logits = model(tokens[:, t : t + 1], cache, decode=True)
        tokens[:, t + 1] = sample(logits[:, -1].float())
    return tokens


def _spec_decode(model, cache, tokens, p_len: int, total: int, k: int, ngram: int,
                 accept) -> None:
    """The speculative loop of :func:`generate` (the JAX package's
    ``_compiled_spec_generate``), writing ``tokens`` in place: each step
    drafts ``k`` tokens a row from the tokens so far (the tokens array is
    the history, :func:`..sampling.ngram_draft` masks it at the row's count
    ``t``), verifies ``[last, draft]`` in one (B, k+1) decode forward,
    accepts (``accept``, :func:`..sampling.speculative_accept`), rewinds
    the rejected positions (:func:`..transformer.rewind_cache_index`) and
    writes the emitted block, columns past ``total`` into the spare column
    ``total``. Rows that reached ``total`` emit nothing while stragglers
    finish; an active row emits at least one token a step, so the loop
    ends. The loop's ``any(t < total)`` test is one host sync a step —
    fine here, as ``generate`` is not on the serving path (the engine's
    verify chain runs a fixed count of steps with no sync)."""
    b = tokens.shape[0]
    dev = tokens.device
    rows = torch.arange(b, device=dev)
    offs = torch.arange(k + 1, device=dev)
    t = torch.full((b,), p_len + 1, dtype=torch.int64, device=dev)
    while bool((t < total).any()):
        active = t < total
        last = tokens[rows, t - 1]
        draft = ngram_draft(tokens[:, :total], t, k, ngram)
        logits = model(torch.cat([last[:, None], draft], dim=1), cache, decode=True)
        emitted, n_acc = accept(logits.float(), draft)
        rewind_cache_index(cache, k - n_acc)
        n_emit = torch.where(active, n_acc + 1, 0)
        cols = t[:, None] + offs[None, :]
        cols = torch.where((offs[None, :] < n_emit[:, None]) & (cols < total), cols, total)
        tokens[rows[:, None], cols] = emitted
        t = torch.clamp(t + n_emit, max=total)


def _window_len(cfg, total: int) -> int:
    """Serve with a cache sized to the REQUEST, not the model maximum: the
    window is ``total`` rounded up to a multiple of 8, capped at
    ``cfg.max_seq_len`` (the JAX package's ``_window_model``)."""
    return min(cfg.max_seq_len, -(-total // 8) * 8)
