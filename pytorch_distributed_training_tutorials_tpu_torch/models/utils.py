"""Model utilities: parameter counting and the MFU numerator (own copies
of the JAX package's ``models/utils.py``)."""

from __future__ import annotations

import torch


def model_size(params) -> int:
    """Total parameter count: of a module's ``parameters()`` (buffers, the
    BatchNorm running statistics, excluded), or of a dict or list of
    tensors. ResNet-50 counts 25,557,032."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return sum(p.numel() for p in params)


def model_flops_per_token(n_params_nonembed: int, d_model: int,
                          n_layers: int, seq_len: int) -> float:
    """Training FLOPs per token, PaLM appendix-B convention: 6x the
    non-embedding params (forward 2x + backward 4x) plus ``12*L*d*S`` for
    the two attention products (QK^T and weights@V, forward and backward;
    no causal discount). Remat recompute does not count. Exclude
    ``tok_emb`` (a gather, not a matmul) from ``n_params_nonembed`` but
    keep ``lm_head`` (it is a matmul)."""
    return 6.0 * n_params_nonembed + 12.0 * n_layers * d_model * seq_len
