"""Autoregressive generation with a KV cache.

Port of ``pytorch_distributed_training_tutorials_tpu/models/generate.py``
(no speculation): the prompt is prefilled in ONE batched forward that
writes the cache for positions ``[0, P)``, then a decode loop appends one
position per step. PyTorch runs it eagerly; the JAX package compiles the
same loop as one program.
"""

from __future__ import annotations

import torch

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
from pytorch_distributed_training_tutorials_tpu_torch.models.sampling import sample_logits
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    KVCache,
    TransformerLM,
    bind_params,
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
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` (B, P) ints.
    Returns int64 (B, P + max_new_tokens) on ``device`` (``cuda`` unless
    the caller passes another).

    ``params`` (a state dict from the weight bridge, or None when
    ``model`` already holds its weights) is bound into ``model``. Greedy
    when ``temperature == 0``; otherwise sampled at that temperature from
    ``generator`` (required), filtered by ``top_k`` / ``top_p`` after the
    temperature. The cache is sized to the request (:func:`_window_len`),
    not the model's maximum."""
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

    def sample(logits):
        return sample_logits(logits, generator, temperature, top_k, top_p)

    tokens = torch.zeros((b, total), dtype=torch.int64, device=dev)
    tokens[:, :p_len] = prompt
    cache = KVCache.zeros(cfg, b, _window_len(cfg, total), device=dev)
    logits = model(prompt, cache, prefill=True)
    tokens[:, p_len] = sample(logits[:, -1].float())
    for t in range(p_len, total - 1):
        logits = model(tokens[:, t : t + 1], cache, decode=True)
        tokens[:, t + 1] = sample(logits[:, -1].float())
    return tokens


def _window_len(cfg, total: int) -> int:
    """Serve with a cache sized to the REQUEST, not the model maximum: the
    window is ``total`` rounded up to a multiple of 8, capped at
    ``cfg.max_seq_len`` (the JAX package's ``_window_model``)."""
    return min(cfg.max_seq_len, -(-total // 8) * 8)
