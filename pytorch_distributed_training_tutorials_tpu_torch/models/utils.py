"""Model utilities: the MFU numerator (an own copy of the JAX package's
``models/utils.py:model_flops_per_token``)."""

from __future__ import annotations


def model_flops_per_token(n_params_nonembed: int, d_model: int,
                          n_layers: int, seq_len: int) -> float:
    """Training FLOPs per token, PaLM appendix-B convention: 6x the
    non-embedding params (forward 2x + backward 4x) plus ``12*L*d*S`` for
    the two attention products (QK^T and weights@V, forward and backward;
    no causal discount). Remat recompute does not count. Exclude
    ``tok_emb`` (a gather, not a matmul) from ``n_params_nonembed`` but
    keep ``lm_head`` (it is a matmul)."""
    return 6.0 * n_params_nonembed + 12.0 * n_layers * d_model * seq_len
