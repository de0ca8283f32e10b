"""Decoder-only transformer LM, in PyTorch: the int8 serving forward and
the float forward (training, and serving in ``cfg.dtype``).

Port of ``pytorch_distributed_training_tutorials_tpu/models/transformer.py``:
RMSNorm, rotary positions (half-split), SwiGLU, GQA. Two weight kinds:

- ``quantized=True`` (int8 serving): causal prefill through
  ``cfg.attention_fn`` (e.g. the flash forward kernel) or, unset, the
  dense float64 :func:`causal_attention`; slot-indexed cached decode with
  per-row positions; the int8 projections of
  :class:`..ops.quant.Int8Linear`; all under ``torch.no_grad``;
- ``quantized=False`` (float): float32 parameters with flax's ``dtype=``
  semantics — each projection casts its input and its weight to
  ``cfg.dtype`` (float32 or bfloat16) at use, the embedding casts the
  looked-up rows, RMSNorm and rope compute in float32 and cast back, and
  attention is ``cfg.attention_fn`` (e.g. the flash kernels of
  :mod:`..ops.flash_attention`) or :func:`dense_causal_attention` with the
  JAX ``masked_attention`` contract. ``remat`` checkpoints each block
  (``torch.utils.checkpoint``); ``remat_policy="dots"`` saves the outputs
  of the projections' matmuls and recomputes the rest, the flash forward
  included; ``"dots_attn"`` also saves the flash op's outputs. The float
  model also serves: prefill and decode over a :class:`KVCache` or
  :class:`PagedKVCache` stored in ``cfg.dtype``, the
  cached decode under the same ``masked_attention`` contract (float32
  scores and softmax, weights cast to v's type).

Both kinds run the same :meth:`Attention.forward`. Decode takes S >= 1
tokens per row from the row's own position: S > 1 on a batch-1 cache is
the suffix continuation that prefix-cache splices and chunked prefill
run (``serve/engine.py``), as in the JAX package.

Parameter names and the (in, out) weight meaning follow the JAX package so
the weight bridge (:mod:`.convert`) maps one to one.

Where JAX keeps the KV cache in flax's mutable ``"cache"`` collection, the
port passes an explicit :class:`KVCache` into the forward; prefill and
decode write into it IN PLACE (the slot refill of the serving engine too).
A model with ``cfg.kv_pages`` > 0 decodes over a :class:`PagedKVCache`
instead: one page pool per layer shared by all rows, a per-row page table,
and two read paths (the gather, bitwise the unpaged decode, or the
paged-attention kernel). Either cache may store K/V quantized (int8 codes
with f32 scales, int4 nibbles with bf16 scales): writes store the encoded
K/V, decode attends over the decoded cache, and prefill attends over the
raw K/V, as in the JAX package.

Tensor-parallel serving (``cfg.int8_mesh``, a
:class:`..parallel.tensor_parallel.TensorParallel` of ``tp`` ranks): the
model holds the rank's shard of every projection in the Megatron layout
(:data:`TP_RULES`, :data:`INT8_TP_RULES`; :func:`tp_layout` gives the
shard's widths) — q/k/v split over heads, gate/up over d_ff, the lm_head
over the vocabulary (column layers), o_proj and down_proj over their
input (row layers, whose partials one ``all_reduce`` sums), the
embedding and norms whole. Attention runs the rank's ``n_heads / tp``
query heads against its KV heads, which the caches store and nothing
else; a KV head count the group size does not divide keeps every KV
head on every rank (the JAX package's shape-aware drop), and each rank
reads the ones its query heads use. The logits end with one
``all_gather`` over the vocabulary, so every rank holds the same bytes
and samples the same token. A dimension the group size does not divide
(heads, d_ff or vocabulary) stays whole, with no collective. The float
model takes the same layout (``torch.mm`` on its shards) and trains on
it: with autograd recording, Megatron's ``f`` (identity forward, the
input gradient's ``all_reduce`` backward) enters each split column region
— q/k/v, gate/up, and the vocab-split head of the materialized-logits
loss — and ``g`` (``all_reduce`` forward, identity backward) replaces the
row layers' in-place sum, whose summed-in output autograd may have
saved; the head's logits are gathered with a gradient (the rank's
slice), or, for the logits-free loss, the hidden states go to
:func:`..ops.fused_loss.fused_cross_entropy_tp` with no ``f`` (it sums dh
itself). Under remat a block's recompute issues its o_proj's ``g`` again
(it stops after the down_proj matmul, the last tensor the block's
backward reads): 3 sums a layer a step.

Mixture of experts (``cfg.moe_experts`` > 0): every block's FFN is a
routed :class:`..models.moe.MoEFFN` (``blocks.i.moe``; the JAX
``block_i/moe``), float weights only; under expert parallelism (the
strategy's ``expert`` group) a block holds its rank's experts.

Sequence parallelism: an ``attention_fn`` with a ``seq_shard`` (ring or
Ulysses attention, :mod:`..parallel.ring_attention`,
:mod:`..parallel.ulysses`) makes the float train forward take the rank's
block of the sequence, its rotary positions from the block's global
offset. The serving paths hold every token on every rank: their prefill
runs the dense causal attention in place of such an ``attention_fn``, at
any prompt length.

Batch- and window-invariance. The serving engine's tokens must equal
``generate()``'s for the same request, though the engine decodes
``n_slots`` rows over the model's whole window and ``generate()`` one
request over a window sized to it, and prefills a bucket-padded prompt.
The int8 matmul is exact per row whatever the batch; the reductions whose
length or batch differ between the two — the attention scores, softmax
and context sums, and the RMSNorm statistics — run in float64 and round
once to float32, so their float32 results do not depend on how the
backend orders the sum.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from collections.abc import Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from pytorch_distributed_training_tutorials_tpu_torch.adapters.bank import apply_lora
from pytorch_distributed_training_tutorials_tpu_torch.models.moe import MOE_RULES, MoEFFN
from pytorch_distributed_training_tutorials_tpu_torch.ops import flash_attention as _flash
from pytorch_distributed_training_tutorials_tpu_torch.ops.paged_attention import (
    paged_attention,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import (
    _RCP127,
    Int8Linear,
    dequantize_kv_int4,
    quantize_int8,
    quantize_kv_int4,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    shard_params,
    shard_tensor,
    split_dim,
)

# what the int8 serving model refuses, and the slice that brings it in
_SERVING_LATER = {
    "remat": "no later slice: remat is a training option and int8 weights "
             "are not trained",
    "remat_policy": "no later slice: remat is a training option and int8 "
                    "weights are not trained",
}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
_REMAT_POLICIES = (None, "dots", "dots_attn")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's ``TransformerConfig`` fields that the port runs
    or refuses. Unsupported values raise ``NotImplementedError`` at
    construction, naming the slice that brings them in. ``quantized=True``
    serves int8 weights in float32, prefilling through ``attention_fn``
    when it is set; ``quantized=False`` trains and serves float32
    parameters computing in ``dtype`` (float32 or bfloat16), with
    ``attention_fn``, ``remat`` and ``remat_policy`` (None, "dots" or
    "dots_attn"). The JAX ``scan_layers`` layout needs no field: the port
    holds one module per layer and the weight bridge reads the layout from
    the tree.

    ``lora_adapters`` N > 0 with ``lora_rank`` r >= 1 gives every q/k/v/o
    and gate/up/down projection a :class:`LoRADelta` sibling (``*_lora``)
    holding N stacked rank-r factor pairs, gathered per batch row by the
    forward's ``adapter_ids``; row 0 is the base model (zero factors).

    ``int8_mesh`` (the JAX knob of tensor-parallel int8 serving): None (one
    process holds every weight), or the
    :class:`..parallel.tensor_parallel.TensorParallel` strategy — or a
    process group or a mesh with a ``model`` axis, taken as one — whose
    rank's shard the model holds (module docstring). The port's float
    model takes the same knob, to serve and to train (the JAX package
    shards a float model through the engine's or the Trainer's strategy
    and GSPMD instead; the port's ``ServeEngine`` and ``Trainer`` set it
    from theirs).

    KV storage: ``kv_cache_dtype`` None (float32 for int8 weights,
    ``dtype`` for float weights), ``torch.float32``, ``torch.bfloat16``,
    ``torch.int8`` (codes + f32 scales) or ``"int4"`` (packed nibbles +
    bf16 scales), for :class:`KVCache` and :class:`PagedKVCache` alike.
    ``kv_pages`` > 0 makes decode read and write a :class:`PagedKVCache`
    of that many pages of ``kv_page_size`` tokens; ``paged_kernel``
    selects its read path (the paged-attention kernel, or the gather).

    ``moe_experts`` > 0 (with ``moe_top_k``, ``moe_capacity_factor``,
    ``moe_group_size``, the JAX fields) gives every block a routed
    mixture-of-experts FFN; int8 weights and LoRA refuse it (ValueError,
    as in the JAX model)."""

    vocab_size: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int | None = None  # default 4 * d_model
    n_kv_heads: int | None = None  # GQA: K/V heads; None = n_heads
    max_seq_len: int = 512
    dtype: torch.dtype = torch.float32
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    remat: bool = False
    remat_policy: str | None = None
    attention_fn: Callable | None = None
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_group_size: int | None = None
    quantized: bool = False
    kv_cache_dtype: object = None
    kv_pages: int = 0
    kv_page_size: int = 0
    paged_kernel: bool = False
    int8_mesh: object = None
    lora_adapters: int = 0
    lora_rank: int = 0

    def __post_init__(self):
        if self.int8_mesh is not None and not isinstance(self.int8_mesh, TensorParallel):
            object.__setattr__(self, "int8_mesh", _as_strategy(self.int8_mesh))
        if self.moe_experts and self.quantized:
            raise ValueError("quantized serving supports dense blocks only (no MoE)")
        if self.moe_experts and self.lora_adapters:
            raise ValueError("LoRA adapters support dense blocks only (no MoE)")
        if self.quantized:
            for name, later in _SERVING_LATER.items():
                value = getattr(self, name)
                if value not in (None, 0, False):
                    raise NotImplementedError(
                        f"TransformerConfig.{name}={value!r} is not supported "
                        f"with quantized=True in the PyTorch port ({later})"
                    )
            if self.dtype != torch.float32:
                raise NotImplementedError(
                    f"TransformerConfig.dtype={self.dtype} is not supported "
                    "with quantized=True in the PyTorch port; int8 serving "
                    "computes in float32"
                )
        elif self.dtype not in _FLOAT_DTYPES:
            raise NotImplementedError(
                f"TransformerConfig.dtype={self.dtype} is not supported by "
                "the PyTorch port; the float path computes in float32 or "
                "bfloat16"
            )
        _kv_dtype(self.kv_cache_dtype)  # raises on an unknown storage type
        if self.kv_pages < 0:
            raise ValueError(f"kv_pages must be >= 0, got {self.kv_pages}")
        if self.kv_pages and (self.kv_page_size < 1
                              or self.max_seq_len % self.kv_page_size):
            raise ValueError(
                f"kv_pages={self.kv_pages} needs a kv_page_size >= 1 that "
                f"divides max_seq_len {self.max_seq_len}, got {self.kv_page_size}"
            )
        if self.paged_kernel and not self.kv_pages:
            raise ValueError(
                "paged_kernel=True needs kv_pages > 0: the kernel walks the page pool"
            )
        if (bool(self.lora_adapters) != bool(self.lora_rank)
                or (self.lora_adapters and (self.lora_adapters < 2 or self.lora_rank < 1))):
            raise ValueError(
                f"lora_adapters={self.lora_adapters}, lora_rank={self.lora_rank}: "
                "LoRA needs lora_adapters >= 2 (row 0 is the base model) and "
                "lora_rank >= 1, or lora_adapters 0 (off)"
            )
        if self.remat_policy not in _REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} (None, 'dots', "
                "or 'dots_attn')"
            )
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads "
                f"{self.n_heads}"
            )
        if self.n_heads % self.kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads "
                f"{self.kv_heads}"
            )
        tp_layout(self)  # raises on a head layout the group cannot serve

    @property
    def ff_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads


def _as_strategy(value) -> TensorParallel:
    """``int8_mesh``'s value as a strategy: a process group or a mesh with
    a ``model`` axis becomes a :class:`TensorParallel` over it; anything
    else raises ``TypeError``."""
    import torch.distributed as dist

    if isinstance(value, dist.ProcessGroup) or hasattr(value, "mesh_dim_names"):
        return TensorParallel(value)
    raise TypeError(
        f"TransformerConfig.int8_mesh takes a TensorParallel strategy, a process group or "
        f"a mesh with a 'model' axis (or None), got {type(value).__name__}"
    )


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """One rank's widths of a tensor-parallel model (:func:`tp_layout`):
    ``tp`` the strategy (None: no group), ``size`` its width; the rank's
    query ``heads``, the ``kv_heads`` its caches store, ``kv_read`` the
    slice of those its query heads read (None: all of them), ``ff`` and
    ``vocab``; which of the attention heads, the KV heads, d_ff and the
    vocabulary are split (a dimension the width does not divide is
    whole)."""

    tp: TensorParallel | None
    size: int
    heads: int
    kv_heads: int
    kv_read: slice | None
    ff: int
    vocab: int
    split_heads: bool
    split_kv: bool
    split_ff: bool
    split_vocab: bool


def tp_layout(cfg: "TransformerConfig") -> TPLayout:
    """The rank's shard widths of ``cfg`` under ``cfg.int8_mesh`` (every
    width whole without one). KV heads split with the query heads when
    the width divides them; else every rank stores all of them and reads
    the one (or the run) that its query heads group onto — which needs
    one of ``n_heads / tp`` and ``n_heads / n_kv_heads`` to divide the
    other (it does whenever all three are powers of two)."""
    tp = cfg.int8_mesh
    n = 1 if tp is None else tp.tp_size
    h, kv, ff, vocab = cfg.n_heads, cfg.kv_heads, cfg.ff_dim, cfg.vocab_size
    split_heads = n > 1 and h % n == 0
    split_kv = split_heads and kv % n == 0
    heads = h // n if split_heads else h
    kv_read = None
    if split_heads and not split_kv:
        grp = h // kv
        if grp % heads:
            raise NotImplementedError(
                f"n_heads {h} over tp={n} with n_kv_heads {kv}: a rank's {heads} query "
                f"heads do not fall inside one group of {grp}"
            )
        lo = tp.rank * heads // grp
        kv_read = slice(lo, lo + 1)
    return TPLayout(
        tp=tp if n > 1 else None, size=n, heads=heads,
        kv_heads=kv // n if split_kv else kv, kv_read=kv_read,
        ff=ff // n if n > 1 and ff % n == 0 else ff,
        vocab=vocab // n if n > 1 and vocab % n == 0 else vocab,
        split_heads=split_heads, split_kv=split_kv,
        split_ff=n > 1 and ff % n == 0, split_vocab=n > 1 and vocab % n == 0,
    )


_KV_DTYPES = (None, torch.float32, torch.bfloat16, torch.int8, "int4")


def _kv_dtype(dtype):
    """A ``kv_cache_dtype`` value, checked: None, ``torch.float32``,
    ``torch.bfloat16``, ``torch.int8`` or the string ``"int4"``."""
    if not any(dtype is t or dtype == t for t in _KV_DTYPES):
        raise ValueError(f"unknown kv_cache_dtype {dtype!r} (one of {_KV_DTYPES})")
    return dtype


def _kv_quant_mode(dtype) -> str | None:
    """Storage-quantization family of a ``kv_cache_dtype``: "int8"
    (per-token-per-head absmax, f32 scales), "int4" (packed nibbles, bf16
    scales) or None (exact storage)."""
    dtype = _kv_dtype(dtype)
    if isinstance(dtype, str):
        return "int4"
    return "int8" if dtype == torch.int8 else None


def _kv_storage(dtype, d: int, exact: torch.dtype = torch.float32):
    """``(storage dtype, stored head dim, scale dtype or None)`` of a
    ``kv_cache_dtype`` at head dim ``d``: int4 packs two values per uint8
    byte (``d // 2`` stored) and keeps bf16 scales, so a token-head costs
    exactly half its int8 twin; exact storage follows the serving compute
    type ``exact`` unless set."""
    quant = _kv_quant_mode(dtype)
    if quant == "int8":
        return torch.int8, d, torch.float32
    if quant == "int4":
        if d % 2:
            raise ValueError(f"int4 KV needs an even head_dim, got {d}")
        return torch.uint8, d // 2, torch.bfloat16
    dtype = _kv_dtype(dtype)
    return (exact if dtype is None else dtype), d, None


def _cache_storage(cfg: TransformerConfig):
    """:func:`_kv_storage` of a model: unset exact storage is float32 for
    int8 weights (they compute in float32) and ``cfg.dtype`` for float
    weights (the JAX cache stores K/V in the projections' type)."""
    exact = torch.float32 if cfg.quantized else cfg.dtype
    return _kv_storage(cfg.kv_cache_dtype, cfg.head_dim, exact)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V ``(..., D)`` -> int8 codes and one f32 scale per token and head
    (absmax over D). The scale is ``max(absmax, 1e-8) * float32(1/127)``:
    what the JAX engine stores, whose quantizer runs inside a jit where XLA
    folds ``/ 127.0`` into that multiply. Inverse: :func:`_dequantize_kv`."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=-1), 1e-8) * _RCP127
    q = torch.round(x32 / scale[..., None]).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _encode_kv(x: torch.Tensor, quant: str | None):
    """Storage-encode one K/V chunk: ``(stored, scale)``, scale None for
    exact storage. The one dispatch of every write site."""
    if quant == "int8":
        return _quantize_kv(x)
    if quant == "int4":
        return quantize_kv_int4(x)
    return x, None


def _decode_kv(stored: torch.Tensor, scale, quant: str | None, dtype):
    """Inverse of :func:`_encode_kv` for the dense read paths; exact
    storage is returned as stored."""
    if quant == "int8":
        return _dequantize_kv(stored, scale, dtype)
    if quant == "int4":
        return dequantize_kv_int4(stored, scale, dtype)
    return stored


def _check_storage(cache, cfg: TransformerConfig) -> None:
    store, d_store, _ = _cache_storage(cfg)
    if cache.k.dtype != store or cache.k.shape[-1] != d_store:
        raise ValueError(
            f"the cache stores {cache.k.dtype} x {cache.k.shape[-1]}, the model's "
            f"kv_cache_dtype={cfg.kv_cache_dtype!r} wants {store} x {d_store}"
        )


@dataclasses.dataclass
class KVCache:
    """The decode cache, passed into :meth:`TransformerLM.forward` and
    written there in place.

    ``k``/``v``: (L, B, W + 1, kv_heads, D_store) in the storage type of
    ``cfg.kv_cache_dtype`` (kv_heads: the rank's, :func:`tp_layout`) —
    W = the attention window. Position W is a
    write sink: a decode write at a position >= W (a parked slot that keeps
    stepping, or any row past its window) lands there and is never read,
    so such writes are DROPPED, not clamped onto the last real entry and
    not an index error. ``index``: (B,) int64 — each row's next write
    position (the JAX package's per-slot ``cache_index``).
    ``k_scale``/``v_scale``: (L, B, W + 1, kv_heads) for quantized storage
    (``quant`` "int8" or "int4"), else None."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    quant: str | None = None

    @classmethod
    def zeros(cls, cfg: TransformerConfig, batch: int, window: int | None = None,
              device=None) -> "KVCache":
        w = cfg.max_seq_len if window is None else window
        store, d_store, scale_dtype = _cache_storage(cfg)
        lead = (cfg.n_layers, batch, w + 1, tp_layout(cfg).kv_heads)
        return cls(
            k=torch.zeros(lead + (d_store,), dtype=store, device=device),
            v=torch.zeros(lead + (d_store,), dtype=store, device=device),
            index=torch.zeros((batch,), dtype=torch.int64, device=device),
            **_scales(lead, scale_dtype, device),
            quant=_kv_quant_mode(cfg.kv_cache_dtype),
        )

    @property
    def window(self) -> int:
        return self.k.shape[2] - 1


def _scales(shape, dtype, device) -> dict:
    if dtype is None:
        return {}
    return {"k_scale": torch.zeros(shape, dtype=dtype, device=device),
            "v_scale": torch.zeros(shape, dtype=dtype, device=device)}


@dataclasses.dataclass
class PagedKVCache:
    """The paged decode cache (``cfg.kv_pages`` > 0): K/V live in ONE pool
    per layer shared by every row, and only the page table and the
    position carry a batch axis.

    - ``k``/``v``: (L, N + 1, page_size, kv_heads, D_store) — N =
      ``cfg.kv_pages`` pool pages, in the storage type of
      ``cfg.kv_cache_dtype``; ``k_scale``/``v_scale``: (L, N + 1,
      page_size, kv_heads) for quantized storage. Page N is the write
      sink: writes through a sentinel table entry or past the table land
      there, so they drop, and it is never read by the kernel path nor
      counted in :meth:`page_bytes`. (The gather path reads it for
      sentinel entries; those positions are masked, so what it holds
      contributes an exact zero.)
    - ``table``: (B, P) int32, P = max_seq_len // page_size, the
      sentinel N where a row holds no page;
    - ``index``: (B,) int64, each row's next write position."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    index: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    quant: str | None = None

    @classmethod
    def zeros(cls, cfg: TransformerConfig, batch: int, device=None) -> "PagedKVCache":
        n, ps = cfg.kv_pages, cfg.kv_page_size
        if n < 1:
            raise ValueError(f"a paged cache needs kv_pages >= 1, got {n}")
        store, d_store, scale_dtype = _cache_storage(cfg)
        lead = (cfg.n_layers, n + 1, ps, tp_layout(cfg).kv_heads)
        return cls(
            k=torch.zeros(lead + (d_store,), dtype=store, device=device),
            v=torch.zeros(lead + (d_store,), dtype=store, device=device),
            table=torch.full((batch, cfg.max_seq_len // ps), n, dtype=torch.int32,
                             device=device),
            index=torch.zeros((batch,), dtype=torch.int64, device=device),
            **_scales(lead, scale_dtype, device),
            quant=_kv_quant_mode(cfg.kv_cache_dtype),
        )

    @property
    def n_pages(self) -> int:
        return self.k.shape[1] - 1

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def window(self) -> int:
        return self.table.shape[1] * self.page_size

    def page_bytes(self) -> int:
        """Bytes one pool page holds across every layer's K, V and scales
        (the sink excluded)."""
        return sum(x[:, 0].numel() * x.element_size()
                   for x in (self.k, self.v, self.k_scale, self.v_scale) if x is not None)


def rewind_cache_index(cache: KVCache | PagedKVCache, steps) -> KVCache | PagedKVCache:
    """Roll the cache's per-row positions back by ``steps`` ((B,) or a
    scalar), in place; returns ``cache``. The speculative verify's rewind
    (``serve/engine.py``, ``models/generate.py`` ``speculative_k``): a (B,
    k+1) verify forward advances every position by k+1, but only ``1 +
    n_accept`` of those K/V rows are real, so the positions step back by
    ``k - n_accept``.

    Only the positions move; the rejected rows stay as stale K/V. That is
    safe: the next decode writes k+1 fresh positions from the rewound
    position, covering every stale one (they sit at ``[new_pos, old_pos)``
    and ``new_pos + k >= old_pos - 1``) before any query can attend to it,
    and the validity mask bounds each query's reads at its own position
    meanwhile. The port's positions are per row from the start
    (``KVCache.index``, (B,)), so the JAX package's ``widen_cache_index``
    (scalar counters to per-row vectors) has no counterpart here."""
    cache.index -= steps
    return cache


class RMSNorm(nn.Module):
    """Root-mean-square norm (no mean subtraction).

    Serving (``train=False``): statistics in float64, rounded once to
    float32 (the module docstring's invariance), frozen scale. Training
    (``train=True``): the JAX package's arithmetic — float32 statistics,
    ``y * scale`` in float32, cast back to x's dtype — and a trainable
    scale."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None,
                 train: bool = False):
        super().__init__()
        self.eps = eps
        self.train_mode = train
        self.scale = nn.Parameter(
            torch.ones(dim, device=device), requires_grad=train
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.train_mode:
            x32 = x.float()
            y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + self.eps)
            return (y * self.scale).to(x.dtype)
        x64 = x.double()
        inv = torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + self.eps)
        return (x64 * inv).float() * self.scale


def apply_rope(x: torch.Tensor, theta: float, offset=0) -> torch.Tensor:
    """Rotary position embedding over the last axis (half-split: the first
    and second halves of head_dim are the pair). ``x``: (B, S, H, D).
    ``offset`` is a scalar (every row at the same positions) or a (B,)
    tensor (each row at its own depth — slot-indexed decode). Computes in
    float32 and casts back to x's dtype."""
    seq_len, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    steps = torch.arange(seq_len, dtype=torch.float32, device=x.device)
    if isinstance(offset, torch.Tensor):
        pos = offset.to(torch.float32)[..., None] + steps
    else:
        # a host scalar is added on the device, never uploaded (an upload
        # from pageable memory synchronizes the stream)
        pos = steps + float(offset)
    angles = pos[..., :, None] * freqs  # (S, half) or (B, S, half)
    if pos.ndim == 1:
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
    else:
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _weights(scores, v, acc):
    """Softmax weights of the context product: float64 kept whole (the
    int8 path); float32 cast to v's type first (the JAX
    ``masked_attention`` contract of the float path)."""
    weights = torch.softmax(scores, dim=-1)
    return weights if acc == torch.float64 else weights.to(v.dtype).to(acc)


def _live_values(v, mask):
    """``v`` (B, K, H|KV, D) with 0 at every key position that ``mask``
    (broadcastable to (B, H|1, Q, K)) kills for every query: such a key's
    weight is 0, but its value may be a previous tenant's stale NaN, and
    ``0 * NaN`` is NaN. Finite values give the same context either way."""
    m = mask.reshape((1,) * (4 - mask.ndim) + tuple(mask.shape))
    live = m.any(dim=2).transpose(1, 2)[..., None]  # (B|1, K, H|1, 1)
    return torch.where(live, v, 0.0)  # a host scalar: no fill launched


def masked_attention(q, k, v, mask, acc: torch.dtype = torch.float64):
    """Scaled-dot-product attention with an explicit boolean ``mask``
    broadcastable to the (B, H, Q, K) scores: q (B, Q, H, D), k/v (B, K, H,
    D). Scores, softmax and context in ``acc``: float64 for int8 weights
    (module docstring), float32 for float weights (with the weights cast
    to v's type, :func:`_weights`); output in q's dtype. A key that the
    mask kills for every query adds nothing (:func:`_live_values`)."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc))
    scores = scores / math.sqrt(d)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    ctx = torch.einsum("bhqk,bkhd->bqhd", _weights(scores, v, acc),
                       _live_values(v, mask).to(acc))
    return ctx.to(q.dtype)


def grouped_masked_attention(q, k, v, mask, acc: torch.dtype = torch.float64):
    """GQA attention over an UN-expanded K/V: q (B, Q, H, D) against k/v
    (B, L, KV, D), H a multiple of KV — the group axis folds into the
    einsums, so the cache is read at its stored size. ``mask``
    broadcastable to (B, 1, Q, L); ``acc`` as :func:`masked_attention`.
    Falls through to :func:`masked_attention` when H == KV."""
    b, qlen, h, d = q.shape
    kvh = k.shape[2]
    if kvh == h:
        return masked_attention(q, k, v, mask, acc)
    grp = h // kvh
    q5 = q.to(acc).reshape(b, qlen, kvh, grp, d)
    scores = torch.einsum("bqcgd,blcd->bcgql", q5, k.to(acc)) / math.sqrt(d)
    scores = torch.where(
        mask[:, :, None], scores, torch.full_like(scores, -1e30)
    )
    out = torch.einsum("bcgql,blcd->bqcgd", _weights(scores, v, acc),
                       _live_values(v, mask).to(acc))
    return out.to(q.dtype).reshape(b, qlen, h, d)


def _expand_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Repeat grouped K/V heads up to the query head count (GQA -> MHA
    view); identity when the counts already match."""
    reps = n_heads // kv.shape[2]
    return kv if reps == 1 else kv.repeat_interleave(reps, dim=2)


def causal_attention(q, k, v):
    """Dense causal softmax attention; (B, S, H, D) in and out."""
    s = q.shape[1]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    return masked_attention(q, k, v, mask[None, None])


def dense_causal_attention(q, k, v):
    """Dense causal attention of the float (training) path, the JAX
    ``masked_attention`` contract: float32 scores and softmax, the weights
    cast to v's dtype, float32 context accumulation, the output in q's
    dtype. (B, S, H, D) in and out."""
    s, d = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(d)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
    return ctx.to(q.dtype)


class Dense(nn.Module):
    """Float projection with flax's ``dtype=`` semantics: input and float32
    weight cast to ``dtype`` at use, one 2-D matmul. Contracts the last
    ``n_in`` axes of ``x`` into ``features`` (``nn.Dense``,
    ``nn.DenseGeneral`` for q/k/v and o_proj). ``weight`` is (K, N): the
    JAX kernel flattened to (in, out). No bias. ``shard_kind`` "row" (with
    ``strategy``): the layer holds the rank's rows and its output is the
    group's sum (one ``all_reduce``: in place without autograd, Megatron's
    ``g`` with it, :func:`_row_sum`); "column": its columns, no
    collective."""

    def __init__(self, in_features, features, n_in: int = 1,
                 dtype: torch.dtype = torch.float32, device=None,
                 shard_kind: str | None = None, strategy: TensorParallel | None = None):
        super().__init__()
        feats = tuple(features) if isinstance(features, (tuple, list)) else (features,)
        ins = tuple(in_features) if isinstance(in_features, (tuple, list)) else (in_features,)
        self.in_features = ins
        self.features = feats
        self.n_in = n_in
        self.dtype = dtype
        self.shard_kind = shard_kind
        self.strategy = strategy
        self.weight = nn.Parameter(
            torch.empty((math.prod(ins), math.prod(feats)), device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[: x.ndim - self.n_in]
        w = self.weight  # read once: under FSDP each read is a gather
        x2 = x.reshape(-1, w.shape[0]).to(self.dtype)
        out = torch.mm(x2, w.to(self.dtype))
        if self.shard_kind == "row":
            out = _row_sum(self.strategy, out)
        return out.reshape(*lead, *self.features)


def _row_sum(tp: TensorParallel, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel output summed over the group: with autograd
    recording (training), Megatron's ``g`` into a new tensor — the
    in-place sum would change a tensor the backward may read; without
    (serving, evaluation), the in-place ``all_reduce``."""
    return tp.reduce_from(x) if torch.is_grad_enabled() else tp.all_reduce(x)


def _enter_columns(lay: "TPLayout", split: bool, x: torch.Tensor) -> torch.Tensor:
    """Megatron's ``f`` before a split column region while autograd
    records (identity forward, the input gradient summed backward); ``x``
    itself otherwise."""
    return lay.tp.copy_to(x) if split and torch.is_grad_enabled() else x


def _projection(cfg: TransformerConfig, in_features, features, n_in=1,
                device=None, kind: str | None = None) -> nn.Module:
    """A projection of ``cfg``'s kind; ``kind`` ("column" or "row") makes
    it the rank's shard of a tensor-parallel layer (widths the shard's)."""
    tp = tp_layout(cfg).tp if kind else None
    kind = kind if tp is not None else None
    if cfg.quantized:
        return Int8Linear(in_features, features, n_in=n_in, device=device,
                          shard_kind=kind, strategy=tp)
    return Dense(in_features, features, n_in=n_in, dtype=cfg.dtype, device=device,
                 shard_kind=kind, strategy=tp)


def _tp_sum(lay: TPLayout, split: bool, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel LoRA delta summed over the group (its own
    ``all_reduce``); ``x`` itself when ``split`` is off."""
    return _row_sum(lay.tp, x) if split else x


def _store_decode_kv(buf, val, pos, window: int) -> None:
    """Write ``val`` (B, S, ...) into one layer's cache ``buf`` (B, W + 1,
    ...) at positions ``pos[r] + [0, S)`` per row, in place. Positions >=
    ``window`` go to the sink row W (:class:`KVCache`): dropped. No host
    sync — the drop is an index choice, not a branch."""
    b, s = val.shape[0], val.shape[1]
    cols = pos[:, None] + torch.arange(s, device=pos.device)
    cols = torch.where(cols < window, cols, torch.full_like(cols, window))
    rows = torch.arange(b, device=pos.device)[:, None].expand(b, s)
    buf[rows, cols] = val.to(buf.dtype)


def _store_paged_kv(pool, table, val, pos) -> None:
    """Paged twin of :func:`_store_decode_kv`: write row r's token s of
    ``val`` (B, S, ...) into one layer's ``pool`` (N + 1, page_size, ...)
    at the page and offset that the row's ``table`` (B, P) maps position
    ``pos[r] + s`` to, in place. A position past the table, or one whose
    table entry is the sentinel N (a parked or unbacked row), lands in the
    sink page N: dropped. No host sync."""
    n_pages, page_size = pool.shape[0] - 1, pool.shape[1]
    p_cap = table.shape[1]
    cols = pos[:, None] + torch.arange(val.shape[1], device=pos.device)
    p_idx = cols // page_size
    ids = torch.gather(table, 1, p_idx.clamp(max=p_cap - 1)).to(torch.int64)
    ids = torch.where(p_idx < p_cap, ids, n_pages)
    pool[ids, cols % page_size] = val.to(pool.dtype)


def _gather_pages(pool, table) -> torch.Tensor:
    """Each row's logical window out of one layer's page ``pool``: (B, P *
    page_size, ...) — the array the unpaged decode reads, which is why the
    gather path is bitwise the unpaged decode. Sentinel entries read the
    sink page, at positions the validity mask excludes."""
    out = pool[table.to(torch.int64)]
    b, p = table.shape
    return out.reshape((b, p * pool.shape[1]) + tuple(pool.shape[2:]))


def _validity(pos, s: int, window: int) -> torch.Tensor:
    """(B, S, W): query s of row b (at position pos[b] + s) attends the
    cache positions t <= pos[b] + s."""
    qpos = pos[:, None] + torch.arange(s, device=pos.device)
    return torch.arange(window, device=pos.device) <= qpos[..., None]


class LoRADelta(nn.Module):
    """The stacked multi-tenant LoRA delta of ONE base projection (the JAX
    package's ``LoRADelta``): ``lora_a`` (N, d_in, r) and ``lora_b`` (N, r,
    d_out), float32 parameters, zero until a bank row or a fine-tune fills
    them. The forward returns each batch row's ``(x @ A[id]) @ B[id]``
    (:func:`..adapters.bank.apply_lora`) computed in ``cfg.dtype``, the
    factors gathered by a device id vector — never a host branch on the
    id. Row 0 is the base model: its factors stay zero, so its delta is an
    exact 0.0."""

    def __init__(self, cfg: TransformerConfig, d_in: int, d_out: int, device=None):
        super().__init__()
        n, r = cfg.lora_adapters, cfg.lora_rank
        self.dtype = cfg.dtype
        self.lora_a = nn.Parameter(torch.zeros((n, d_in, r), device=device),
                                   requires_grad=not cfg.quantized)
        self.lora_b = nn.Parameter(torch.zeros((n, r, d_out), device=device),
                                   requires_grad=not cfg.quantized)

    def forward(self, x: torch.Tensor, adapter_ids: torch.Tensor) -> torch.Tensor:
        return apply_lora(x, self.lora_a, self.lora_b, adapter_ids, dtype=self.dtype)


def _lora(cfg: TransformerConfig, d_in: int, d_out: int, device=None) -> LoRADelta | None:
    return LoRADelta(cfg, d_in, d_out, device=device) if cfg.lora_adapters else None


def _adapter_ids(adapter_ids, batch: int, device) -> torch.Tensor:
    """A forward's ``adapter_ids`` as a (B,) int32 device vector: None is
    the base row 0, a host int one row for every batch row (a fill, no
    upload), a 0-dim or (B,) tensor taken as it is."""
    if adapter_ids is None or isinstance(adapter_ids, int):
        return torch.full((batch,), int(adapter_ids or 0), dtype=torch.int32, device=device)
    ids = adapter_ids.to(device=device, dtype=torch.int32)
    return ids.expand(batch) if ids.ndim == 0 else ids


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        # tensor parallel: the rank's heads (Megatron: q/k/v column, o row)
        self.lay = lay = tp_layout(cfg)
        h, kv, d = lay.heads, lay.kv_heads, cfg.head_dim
        col = "column" if lay.split_heads else None
        kv_col = "column" if lay.split_kv else None
        self.q_proj = _projection(cfg, cfg.d_model, (h, d), device=device, kind=col)
        self.k_proj = _projection(cfg, cfg.d_model, (kv, d), device=device, kind=kv_col)
        self.v_proj = _projection(cfg, cfg.d_model, (kv, d), device=device, kind=kv_col)
        self.o_proj = _projection(cfg, (h, d), cfg.d_model, n_in=2, device=device,
                                  kind="row" if lay.split_heads else None)
        # LoRA siblings (None when off: the module tree is the base one)
        self.q_proj_lora = _lora(cfg, cfg.d_model, h * d, device)
        self.k_proj_lora = _lora(cfg, cfg.d_model, kv * d, device)
        self.v_proj_lora = _lora(cfg, cfg.d_model, kv * d, device)
        self.o_proj_lora = _lora(cfg, h * d, cfg.d_model, device)

    def forward(self, x, cache: KVCache | None = None, layer: int = 0, *,
                prefill: bool = False, decode: bool = False, rows=None,
                adapter_ids=None, rope_offset=None):
        """``rope_offset`` (the float train forward only, an int): the
        global position of ``x``'s first token — the rank's sequence block
        under sequence parallelism; None on the serving paths, which shard
        no tokens over ``seq``."""
        cfg = self.cfg
        x = _enter_columns(self.lay, self.lay.split_heads, x)
        q_raw = self.q_proj(x)
        k_raw = self.k_proj(x)  # GQA: only kv_heads projected and cached
        v = self.v_proj(x)
        if cfg.lora_adapters:
            # per-row deltas on the raw projections (row 0: an exact 0.0)
            q_raw = q_raw + self.q_proj_lora(x, adapter_ids).reshape(q_raw.shape)
            k_raw = k_raw + self.k_proj_lora(x, adapter_ids).reshape(k_raw.shape)
            v = v + self.v_proj_lora(x, adapter_ids).reshape(v.shape)
        s = x.shape[1]
        acc = torch.float64 if cfg.quantized else torch.float32
        if decode:
            # incremental decoding: S tokens per row written (storage-
            # encoded) at the row's own positions pos + [0, S), attention
            # over the decoded cache window with each query masking
            # positions beyond its own. S > 1 from a nonzero position is
            # the suffix continuation of a splice or a prefill chunk: the
            # same rows of K/V as a whole prefill, the same unmasked terms
            pos = cache.index
            quant = cache.quant
            q = apply_rope(q_raw, cfg.rope_theta, offset=pos)
            k = apply_rope(k_raw, cfg.rope_theta, offset=pos)
            k_q, k_s = _encode_kv(k, quant)
            v_q, v_s = _encode_kv(v, quant)
            if cfg.kv_pages:
                out = self._paged_decode(q, (k_q, v_q, k_s, v_s), cache, layer)
            else:
                window = cache.window
                writes = [(cache.k, k_q), (cache.v, v_q)]
                if quant:
                    writes += [(cache.k_scale, k_s), (cache.v_scale, v_s)]
                for buf, val in writes:
                    _store_decode_kv(buf[layer], val, pos, window)
                k_read = _decode_kv(
                    cache.k[layer, :, :window],
                    cache.k_scale[layer, :, :window] if quant else None,
                    quant, k.dtype,
                )
                v_read = _decode_kv(
                    cache.v[layer, :, :window],
                    cache.v_scale[layer, :, :window] if quant else None,
                    quant, v.dtype,
                )
                out = grouped_masked_attention(
                    q, self._kv(k_read), self._kv(v_read),
                    _validity(pos, s, window)[:, None], acc
                )
        else:
            off = 0 if rope_offset is None else rope_offset
            q = apply_rope(q_raw, cfg.rope_theta, offset=off)
            k = apply_rope(k_raw, cfg.rope_theta, offset=off)
            if prefill:
                # batched prefill: the causal forward over the RAW K/V, and
                # the cache of `rows` (all, or one slot) gets the encoded
                # K/V [0, S) with [S, W] zeroed — the state a fresh cache
                # would have
                sel = slice(None) if rows is None else rows
                k_q, k_s = _encode_kv(k, cache.quant)
                v_q, v_s = _encode_kv(v, cache.quant)
                writes = [(cache.k, k_q), (cache.v, v_q)]
                if cache.quant:
                    writes += [(cache.k_scale, k_s), (cache.v_scale, v_s)]
                for buf, val in writes:
                    bl = buf[layer]
                    bl[sel, :s] = (val if rows is None else val[0]).to(bl.dtype)
                    bl[sel, s:].zero_()
            h = self.lay.heads
            # int8 weights without an attention_fn attend in float64, the
            # float model under the masked_attention contract; decode keeps
            # the dense cached path whatever attention_fn is (as in JAX)
            dense = causal_attention if cfg.quantized else dense_causal_attention
            attn = cfg.attention_fn or dense
            if rope_offset is None and getattr(attn, "requires_seq_divisible", 0):
                # a sequence-parallel attention_fn (ring, Ulysses) takes a
                # rank's sequence block; serving holds every token on every
                # rank, so its prefill runs the dense causal path at any
                # prompt length (the JAX fallback for a length the seq axis
                # does not divide, taken at every length here)
                attn = dense
            # GQA: attention_fns keep their (B, S, H, D) contract — K/V
            # repeat up to the query head count here (repeat_interleave:
            # contiguous, so a flash kernel takes them at their own strides)
            out = attn(q, _expand_kv(self._kv(k), h), _expand_kv(self._kv(v), h))
        y = self.o_proj(out)
        if cfg.lora_adapters:
            # the o_proj delta reads the flattened attention context (the
            # rank's heads: a partial, summed like the projection's)
            flat = out.reshape(out.shape[0], out.shape[1], -1)
            y = y + _tp_sum(self.lay, self.lay.split_heads, self.o_proj_lora(flat, adapter_ids))
        return y

    def _kv(self, t: torch.Tensor) -> torch.Tensor:
        """The stored KV heads (axis 2) this rank's query heads read: all
        of them, or under tensor parallelism with KV heads kept whole the
        group its heads fall in (:func:`tp_layout`)."""
        sel = self.lay.kv_read
        return t if sel is None else t[:, :, sel]

    def _paged_decode(self, q, encoded, cache: PagedKVCache, layer: int):
        """The paged decode of one layer: the encoded K/V (and scales)
        land in the shared pools through the page table, then one of two
        read paths, chosen by ``cfg.paged_kernel`` (a config bool):

        - gather (the reference): materialize each row's window and run
          the unpaged decode's attention over it — bitwise the unpaged
          decode;
        - kernel: :func:`..ops.paged_attention.paged_attention` walks the
          table page by page; no dense window exists."""
        pos, tbl, quant = cache.index, cache.table, cache.quant
        k_q, v_q, k_s, v_s = encoded
        writes = [(cache.k, k_q), (cache.v, v_q)]
        if quant:
            writes += [(cache.k_scale, k_s), (cache.v_scale, v_s)]
        for pool, val in writes:
            _store_paged_kv(pool[layer], tbl, val, pos)
        if self.cfg.paged_kernel:
            n = cache.n_pages  # the kernel never sees the sink page
            return paged_attention(
                q, self._kv(cache.k[layer, :n]), self._kv(cache.v[layer, :n]), tbl, pos,
                k_scale=self._kv(cache.k_scale[layer, :n]) if quant else None,
                v_scale=self._kv(cache.v_scale[layer, :n]) if quant else None,
                quant=quant,
            )
        reads = []
        for pool, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
            reads.append(self._kv(_decode_kv(
                _gather_pages(pool[layer], tbl),
                _gather_pages(scale[layer], tbl) if quant else None,
                quant, q.dtype,
            )))
        valid = _validity(pos, q.shape[1], cache.window)
        acc = torch.float64 if self.cfg.quantized else torch.float32
        return grouped_masked_attention(q, *reads, valid[:, None], acc)


class SwiGLU(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        # tensor parallel: gate/up column over d_ff, down row (Megatron MLP)
        self.lay = lay = tp_layout(cfg)
        col, row = ("column", "row") if lay.split_ff else (None, None)
        self.gate_proj = _projection(cfg, cfg.d_model, lay.ff, device=device, kind=col)
        self.up_proj = _projection(cfg, cfg.d_model, lay.ff, device=device, kind=col)
        self.down_proj = _projection(cfg, lay.ff, cfg.d_model, device=device, kind=row)
        self.gate_proj_lora = _lora(cfg, cfg.d_model, lay.ff, device)
        self.up_proj_lora = _lora(cfg, cfg.d_model, lay.ff, device)
        self.down_proj_lora = _lora(cfg, lay.ff, cfg.d_model, device)

    def forward(self, x, adapter_ids=None):
        x = _enter_columns(self.lay, self.lay.split_ff, x)
        if self.gate_proj_lora is None:
            return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        gate = self.gate_proj(x) + self.gate_proj_lora(x, adapter_ids)
        up = self.up_proj(x) + self.up_proj_lora(x, adapter_ids)
        hidden = F.silu(gate) * up
        delta = _tp_sum(self.lay, self.lay.split_ff, self.down_proj_lora(hidden, adapter_ids))
        return self.down_proj(hidden) + delta


class Block(nn.Module):
    """Attention and the FFN, each behind its RMSNorm and a residual. The
    FFN is :class:`SwiGLU`, or with ``cfg.moe_experts`` > 0 a routed
    :class:`..models.moe.MoEFFN` (``moe``; its experts the rank's block
    under expert parallelism)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        train = not cfg.quantized
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device, train=train)
        self.attn = Attention(cfg, device=device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device, train=train)
        if cfg.moe_experts > 0:
            self.moe = MoEFFN(cfg.d_model, cfg.moe_experts, cfg.moe_top_k, cfg.ff_dim,
                              cfg.moe_capacity_factor, cfg.dtype, cfg.moe_group_size,
                              ep=None if cfg.int8_mesh is None else cfg.int8_mesh.expert,
                              device=device)
        else:
            self.mlp = SwiGLU(cfg, device=device)

    def forward(self, x, cache=None, layer=0, *, prefill=False, decode=False,
                rows=None, adapter_ids=None, rope_offset=None):
        x = x + self.attn(
            self.attn_norm(x), cache, layer, prefill=prefill, decode=decode,
            rows=rows, adapter_ids=adapter_ids, rope_offset=rope_offset,
        )
        if hasattr(self, "moe"):
            return x + self.moe(self.mlp_norm(x))
        return x + self.mlp(self.mlp_norm(x), adapter_ids)


def _check_tp_training(cfg: TransformerConfig, lay: TPLayout) -> None:
    """What tensor-parallel training refuses: query heads split over KV
    heads kept whole (every rank holds every K/V projection, whose
    gradient would be a partial a replicated leaf must sum), and LoRA
    factors (a column layer's ``lora_a`` is replicated with a partial
    gradient too)."""
    if lay.split_heads and not lay.split_kv:
        raise NotImplementedError(
            f"tensor-parallel training with n_kv_heads {cfg.kv_heads} over tp={lay.size}: "
            "the KV heads must split with the query heads")
    if cfg.lora_adapters:
        raise NotImplementedError("tensor-parallel training of LoRA factors is not "
                                  "supported by the PyTorch port")


class TransformerLM(nn.Module):
    """Causal LM: tokens (B, S) int -> logits (B, S', vocab).

    Built on the ``meta`` device by default — structure only; the weights
    come from :func:`..models.convert.from_jax_params`,
    :func:`..models.convert.init_quantized_lm` or
    :func:`..models.convert.init_lm` and are bound with :func:`bind_params`
    (``ServeEngine`` and ``generate`` do it for serving).

    A float model (``quantized=False``) runs the plain mode with
    gradients, each block under ``torch.utils.checkpoint`` when
    ``cfg.remat``, and the cache modes in ``cfg.dtype`` (the caller turns
    gradients off: ``ServeEngine`` and ``generate`` do). An int8 model
    runs without gradients in every mode.

    Modes: plain (full causal forward, every position's logits);
    ``prefill=True`` (the causal forward that also writes ``cache`` rows
    ``rows`` — all, or the one slot an int names — and sets their index to
    S); ``decode=True`` (S tokens per cache row at the row's own position,
    written into ``cache``, index += S). Prefill, and decode with
    ``last_pos``, return only the logits at ``last_pos`` (scalar or (B,)),
    default the last position.

    ``adapter_ids`` (a model with ``cfg.lora_adapters``; every mode): each
    batch row's LoRA bank row — None (row 0, the base model), a host int
    for every row, or a 0-dim or (B,) int tensor on the model's device."""

    def __init__(self, cfg: TransformerConfig, device="meta"):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.n_layers)
        )
        self.final_norm = RMSNorm(
            cfg.d_model, cfg.norm_eps, device=device, train=not cfg.quantized
        )
        # tensor parallel: the vocabulary split (column), gathered at the end
        self.lay = tp_layout(cfg)
        self.lm_head = _projection(cfg, cfg.d_model, self.lay.vocab, device=device,
                                   kind="column" if self.lay.split_vocab else None)

    def forward(self, tokens, cache: KVCache | None = None, *,
                prefill: bool = False, decode: bool = False, last_pos=None,
                rows=None, return_hidden: bool = False, adapter_ids=None):
        if adapter_ids is not None and not self.cfg.lora_adapters:
            raise ValueError(
                "adapter_ids passed but cfg.lora_adapters == 0; build with "
                "TransformerConfig(lora_adapters=N, lora_rank=r)"
            )
        ids = (_adapter_ids(adapter_ids, tokens.shape[0], tokens.device)
               if self.cfg.lora_adapters else None)
        serving = cache is not None or prefill or decode or last_pos is not None
        if self.cfg.quantized or serving:
            if return_hidden:
                raise NotImplementedError(
                    "return_hidden is the float train path's (the fused loss)")
            with torch.no_grad():
                return self._serve(tokens, cache, prefill=prefill, decode=decode,
                                   last_pos=last_pos, rows=rows, adapter_ids=ids)
        if self.lay.tp is not None and torch.is_grad_enabled():
            _check_tp_training(self.cfg, self.lay)
        return self._train_forward(tokens, return_hidden, ids)

    def _train_forward(self, tokens, return_hidden: bool = False, adapter_ids=None):
        """The float forward: embedding rows cast to ``cfg.dtype``, the
        blocks (checkpointed under ``cfg.remat``), final norm, lm_head;
        logits (B, S, vocab) in ``cfg.dtype``. ``return_hidden=True`` stops
        at the final norm and returns the hidden states (B, S, d_model):
        the fused loss's seam (``train.trainer`` ``loss="fused_cross_entropy"``
        streams them against ``lm_head.weight`` blockwise, so the logits
        never exist). The lm_head parameter stays; its gradient comes
        through the fused loss. A tensor-parallel model runs the rank's
        shard (module docstring) and returns the whole logits, gathered,
        or the (replicated) hidden states."""
        cfg = self.cfg
        # sequence parallelism: the tokens are the rank's block of the
        # sequence, at global positions from the attention's offset
        sp = getattr(cfg.attention_fn, "seq_shard", None)
        s = tokens.shape[1] * (1 if sp is None else sp.size)
        if s > cfg.max_seq_len:
            raise ValueError(f"sequence length {s} exceeds max_seq_len {cfg.max_seq_len}")
        offset = 0 if sp is None else sp.position_offset(tokens.shape[1])
        x = self.tok_emb(tokens).to(cfg.dtype)
        for block in self.blocks:
            if cfg.remat:
                x = checkpoint(
                    block, x, adapter_ids=adapter_ids, rope_offset=offset,
                    use_reentrant=False, context_fn=_remat_context(cfg.remat_policy),
                )
            else:
                x = block(x, adapter_ids=adapter_ids, rope_offset=offset)
        x = self.final_norm(x)
        if return_hidden:
            return x
        split = self.lay.split_vocab
        logits = self.lm_head(_enter_columns(self.lay, split, x))
        return self.lay.tp.gather_from(logits) if split else logits

    def _serve(self, tokens, cache: KVCache | None = None, *,
               prefill: bool = False, decode: bool = False, last_pos=None,
               rows=None, adapter_ids=None):
        cfg = self.cfg
        if prefill and decode:
            raise ValueError("decode and prefill are exclusive")
        if (prefill or decode) and cache is None:
            raise ValueError("prefill/decode need a KVCache")
        if cache is not None:
            # paged caches serve decode only: prefill goes through a flat
            # batch-1 KVCache, then its pages are copied into the pool
            paged = decode and cfg.kv_pages
            want = PagedKVCache if paged else KVCache
            if not isinstance(cache, want):
                raise ValueError(
                    f"{'decode' if decode else 'prefill'} with kv_pages="
                    f"{cfg.kv_pages} takes a {want.__name__}, got "
                    f"{type(cache).__name__}"
                )
            _check_storage(cache, cfg)
        b, s = tokens.shape
        if s > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {s} exceeds max_seq_len {cfg.max_seq_len}"
            )
        if prefill and s > cache.window:
            raise ValueError(f"prompt of {s} exceeds the cache window {cache.window}")
        x = self.tok_emb(tokens)
        if not cfg.quantized:
            x = x.to(cfg.dtype)
        for i, block in enumerate(self.blocks):
            x = block(x, cache, i, prefill=prefill, decode=decode, rows=rows,
                      adapter_ids=adapter_ids)
        if prefill:
            # a fill: item assignment of a host number syncs the stream
            cache.index[slice(None) if rows is None else rows].fill_(s)
        elif decode:
            cache.index += s
        if prefill or (decode and last_pos is not None):
            if last_pos is None:
                x = x[:, -1:]
            elif isinstance(last_pos, torch.Tensor):
                lp = last_pos.to(x.device).expand(b)
                x = x[torch.arange(b, device=x.device), lp][:, None]
            else:  # a host int: a slice, no upload
                x = x[:, int(last_pos):int(last_pos) + 1]
        logits = self.lm_head(self.final_norm(x))
        if self.lay.split_vocab:
            # the vocab-split head's one collective: every rank the same bytes
            logits = self.lay.tp.all_gather(logits, dim=-1)
        return logits


# matmuls without batch dims: what remat_policy="dots" saves (the JAX
# package's dots_with_no_batch_dims_saveable); Dense runs one aten.mm
_DOTS_SAVEABLE = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
# "dots_attn" also saves both outputs of the flash op (O and its lse)
_DOTS_ATTN_SAVEABLE = _DOTS_SAVEABLE | {_flash._flash_op._opoverload}


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS_SAVEABLE:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_attn_policy(ctx, op, *args, **kwargs):
    if op in _DOTS_ATTN_SAVEABLE:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(policy: str | None):
    """``context_fn`` of a block's checkpoint: None recomputes everything
    (the default contexts); "dots" saves the projections' matmuls and
    recomputes the rest, the flash forward included; "dots_attn" also
    keeps the ``tpu_torch::flash_attention`` op's outputs, so the flash
    forward runs once a layer a step (the JAX docstring's intent: the JAX
    policy tags the attention output, not the ``custom_vjp`` residuals the
    backward reads, and its forward runs twice either way)."""
    if policy is None:
        return noop_context_fn
    fn = _dots_attn_policy if policy == "dots_attn" else _dots_policy
    return functools.partial(create_selective_checkpoint_contexts, fn)


def bind_params(model: TransformerLM, params: Mapping[str, torch.Tensor]) -> None:
    """Bind a state dict (from the weight bridge) into ``model``: the
    module then holds the caller's tensors themselves (no copy)."""
    model.load_state_dict(dict(params), strict=True, assign=True)


# Megatron tensor-parallel layout over the model group, in the port's
# state-dict names and shapes (the JAX package's TP_RULES / INT8_TP_RULES,
# whose PartitionSpecs name the same axes of the (in, out) kernels):
# (pattern, split dim, unit). Column layers — q/k/v (whole heads: the
# output flattens (heads, head_dim)), gate/up, the lm_head — split their
# output; row layers — o_proj (whole heads of its input) and down_proj —
# their input, whose partials one all_reduce sums; embedding and norms
# replicate (no rule). A float weight is (K, N); an int8 one is qt (N, K)
# with its scale (1, N), which splits with a column layer's output and
# replicates for a row layer (each rank's partial is already scaled).
TP_RULES = [
    (r"(^|\.)(q_proj|k_proj|v_proj)\.weight$", 1, "head"),
    (r"(^|\.)o_proj\.weight$", 0, "head"),
    (r"(^|\.)(gate_proj|up_proj|lm_head)\.weight$", 1, None),
    (r"(^|\.)down_proj\.weight$", 0, None),
]
INT8_TP_RULES = [
    (r"(^|\.)(q_proj|k_proj|v_proj)\.qt$", 0, "head"),
    (r"(^|\.)(q_proj|k_proj|v_proj)\.scale$", 1, "head"),
    (r"(^|\.)(gate_proj|up_proj|lm_head)\.qt$", 0, None),
    (r"(^|\.)(gate_proj|up_proj|lm_head)\.scale$", 1, None),
    (r"(^|\.)o_proj\.qt$", 1, "head"),
    (r"(^|\.)down_proj\.qt$", 1, None),
]
# a LoRA sibling shards like its base projection: lora_b (N, r, d_out)
# on a column layer's output, lora_a (N, d_in, r) on a row layer's input
LORA_TP_RULES = [
    (r"(^|\.)(q_proj|k_proj|v_proj)_lora\.lora_b$", 2, "head"),
    (r"(^|\.)(gate_proj|up_proj)_lora\.lora_b$", 2, None),
    (r"(^|\.)o_proj_lora\.lora_a$", 1, "head"),
    (r"(^|\.)down_proj_lora\.lora_a$", 1, None),
]
SERVING_TP_RULES = TP_RULES + INT8_TP_RULES + LORA_TP_RULES


def ep_rules() -> list:
    """Tensor- and expert-parallel rules of an MoE transformer (the JAX
    package's ``ep_rules``): :data:`..models.moe.MOE_RULES` (the stacked
    experts on dim 0 over the expert group) and :data:`TP_RULES`. A
    :class:`..parallel.tensor_parallel.TensorParallel` given them on a
    mesh with an ``expert`` axis shards the experts (dp x ep)."""
    return MOE_RULES + TP_RULES


def int8_param_sharding(name: str, shape, cfg: TransformerConfig) -> int | None:
    """The dimension of one int8 serving leaf (a state-dict ``name`` and
    its global ``shape``) that ``cfg.int8_mesh`` splits per
    :data:`INT8_TP_RULES`, or None (replicated; float leaves always)."""
    lay = tp_layout(cfg)
    return split_dim(name, tuple(shape), INT8_TP_RULES, lay.size, {"head": cfg.head_dim})


def place_int8_lm_params(params, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """The rank's shard of an int8 serving state dict (global shapes, from
    the weight bridge) per :data:`INT8_TP_RULES` over ``cfg.int8_mesh``:
    what a model built from ``cfg`` binds."""
    lay = tp_layout(cfg)
    rank = 0 if lay.tp is None else lay.tp.rank
    return shard_params(params, rank, lay.size, head_dim=cfg.head_dim, rules=INT8_TP_RULES)


# the matmul weights int8 serving replaces (embeddings + norms stay float)
_QUANTIZED_KERNELS = frozenset(
    {
        "q_proj", "k_proj", "v_proj", "o_proj",
        "gate_proj", "up_proj", "down_proj", "lm_head",
    }
)


def quantize_lm_params(params):
    """Float JAX-layout params (nested dicts of tensors) -> the
    ``quantized=True`` layout: every matmul ``kernel`` becomes ``{'q':
    int8 (in, out), 'scale': (1, out)}`` (DenseGeneral kernels flattened
    2-D), norms/embeddings untouched. Both layer layouts: unrolled
    (``block_i/...``) and stacked (``layers/block/...``, quantized per
    layer). Bitwise the JAX package's ``quantize_lm_params`` on the same
    values; runs on whatever device the tensors are on."""

    def walk(tree, stacked=False):
        out = {}
        for name, sub in tree.items():
            if name in _QUANTIZED_KERNELS and isinstance(sub, Mapping) and "kernel" in sub:
                out[name] = {
                    **_quantize_kernel(name, sub["kernel"], stacked=stacked),
                    **{k: v for k, v in sub.items() if k != "kernel"},
                }
            elif isinstance(sub, Mapping):
                out[name] = walk(sub, stacked=stacked or name == "layers")
            else:
                out[name] = sub
        return out

    return walk(dict(params))


def _quantize_kernel(name: str, kernel: torch.Tensor, stacked: bool = False) -> dict:
    """One matmul kernel -> {'q', 'scale'}: ``o_proj`` ((H, D, d_model))
    flattens its leading axes into the contraction; everything else
    contracts its first axis. ``stacked``: a leading (n_layers,) axis,
    quantized per layer."""
    kern = torch.as_tensor(kernel)
    if stacked:
        if kern.ndim < 3:
            raise ValueError(f"{name}: stacked kernel rank {kern.ndim} < 3")
        parts = [_quantize_kernel(name, kern[i]) for i in range(kern.shape[0])]
        return {
            "q": torch.stack([p["q"] for p in parts]),
            "scale": torch.stack([p["scale"] for p in parts]),
        }
    if kern.ndim < 2:
        raise ValueError(f"{name}: kernel rank {kern.ndim} < 2")
    if name == "o_proj":
        k2 = kern.reshape(-1, kern.shape[-1])  # (H*D, d_model)
    else:
        k2 = kern.reshape(kern.shape[0], -1)  # (in, out...)
    qp = quantize_int8(k2)
    return {"q": qp.q, "scale": qp.scale.reshape(1, -1)}


def stack_quantized_lm_params(params):
    """An unrolled JAX-layout tree (``block_0`` .. ``block_{L-1}``, nested
    dicts of tensors or arrays, float or quantized) -> the stacked layout
    (``layers/block/...``, a leading layer axis on every leaf), as the JAX
    package's ``stack_quantized_lm_params`` stacks it. The port's model
    keeps one module a layer, so it serves either layout through the
    weight bridge; this writes stacked trees (a ``scan_layers``
    checkpoint)."""
    blocks, rest = {}, {}
    for name, sub in dict(params).items():
        if name.startswith("block_"):
            blocks[int(name[len("block_"):])] = sub
        else:
            rest[name] = sub
    if not blocks:
        raise ValueError(
            "no block_<i> subtrees found — already stacked, or not a "
            "TransformerLM serving tree"
        )
    n = len(blocks)
    if sorted(blocks) != list(range(n)):
        raise ValueError(f"non-contiguous block indices: {sorted(blocks)}")

    def stack(trees):
        if isinstance(trees[0], Mapping):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack([torch.as_tensor(t) for t in trees])

    rest["layers"] = {"block": stack([blocks[i] for i in range(n)])}
    return rest


def _head_dim_of(path: tuple, shape) -> int:
    """The head width a JAX attention kernel carries: q/k/v (d, H, D),
    o_proj (H, D, d), a leading layer axis when stacked; 1 elsewhere."""
    owner = path[-2] if len(path) >= 2 else ""
    if owner in ("q_proj", "k_proj", "v_proj"):
        return shape[-1]
    if owner == "o_proj":
        return shape[-2]
    return 1


def load_quantized_lm(path, mesh=None, *, device=None) -> dict[str, torch.Tensor]:
    """Stream a float JAX-layout :class:`TransformerLM` checkpoint (written
    by :func:`..parallel.auto.save_checkpoint`) into the state dict that
    ``TransformerLM(replace(cfg, quantized=True))`` binds, on ``device``
    (``cuda`` unless the caller passes another), one leaf at a time.

    The ``from_pretrained(..., load_in_8bit=True)`` loop (reference
    ``03.model_parallel.ipynb`` cell 2, SURVEY C13): each leaf is read
    alone (:func:`..parallel.auto.restore_leaf`), placed, converted
    through the one weight bridge (:func:`..models.convert.jax_leaf_to_port`:
    every matmul kernel quantized, norms and embedding float) and freed
    before the next read, so the float model is resident neither on the
    host nor on the card, and the result is bitwise
    ``from_jax_params(tree, quantized cfg)``. Unrolled (``block_i/...``)
    and stacked (``layers/block/...``, quantized per layer) checkpoints
    alike; a checkpoint of some top-level subtrees gives their entries
    only (the caller merges them).

    ``mesh`` (a :class:`..parallel.tensor_parallel.TensorParallel`, or a
    process group or a mesh with a ``model`` axis, as ``int8_mesh`` takes
    it): each rank keeps only its shard per :data:`INT8_TP_RULES` (a
    LoRA factor as its projection), cut from the whole quantized leaf —
    a row layer's scales are the whole column's, so a block quantized on
    its own would take other codes. Serve it with ``replace(cfg,
    quantized=True, int8_mesh=mesh)``. The JAX ``materialize`` has no
    counterpart: the entries are on the device already."""
    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.models.convert import (
        jax_leaf_to_port,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.auto import (
        checkpoint_leaf_metadata,
        restore_leaf,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.hf_llama import (
        SafetensorsFile,
    )

    dev = resolve_device(device)
    tp = None if mesh is None else (mesh if isinstance(mesh, TensorParallel)
                                    else _as_strategy(mesh))
    f = SafetensorsFile(path)
    out: dict[str, torch.Tensor] = {}
    for kp, meta in checkpoint_leaf_metadata(path):
        leaf = restore_leaf(path, kp, dev, file=f)
        units = {"head": _head_dim_of(kp, meta.shape)}
        for name, t in jax_leaf_to_port(kp, leaf, quantized=True, lora=True).items():
            if tp is not None:
                dim = split_dim(name, tuple(t.shape), SERVING_TP_RULES, tp.tp_size, units)
                t = shard_tensor(t, dim, tp.rank, tp.tp_size)
            out[name] = t
        del leaf  # free the float leaf before the next read
    return out
