"""Decoder-only transformer LM: the serving forward, in PyTorch.

Port of ``pytorch_distributed_training_tutorials_tpu/models/transformer.py``
for int8 serving: RMSNorm, rotary positions (half-split), dense causal
prefill, slot-indexed cached decode with per-row positions, SwiGLU, and the
int8 projections of :class:`..ops.quant.Int8Linear`. Parameter names and
the (in, out) weight meaning follow the JAX package so the weight bridge
(:mod:`.convert`) maps one to one.

Where JAX keeps the KV cache in flax's mutable ``"cache"`` collection, the
port passes an explicit :class:`KVCache` into the forward; prefill and
decode write into it IN PLACE (the slot refill of the serving engine too).

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
import math
from collections.abc import Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import (
    Int8Linear,
    quantize_int8,
)

# config field -> the later slice of the port that brings it in
_LATER_SLICES = {
    "kv_cache_dtype": "quantized KV cache (int8/int4), with paged KV serving",
    "kv_pages": "paged KV serving with the paged-attention kernel",
    "kv_page_size": "paged KV serving with the paged-attention kernel",
    "paged_kernel": "paged KV serving with the paged-attention kernel",
    "lora_adapters": "the multi-tenant LoRA bank",
    "lora_rank": "the multi-tenant LoRA bank",
    "moe_experts": "mixture-of-experts blocks",
    "attention_fn": "flash prefill and sequence-parallel attention",
    "int8_mesh": "tensor-parallel int8 serving",
    "remat": "the LM train step",
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's ``TransformerConfig`` fields that this slice
    serves or refuses. Unsupported values raise ``NotImplementedError`` at
    construction, naming the slice that brings them in; so does
    ``quantized=False`` (this slice serves int8 weights only). The JAX
    ``scan_layers`` layout needs no field: the port holds one module per
    layer and the weight bridge reads the layout from the tree."""

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
    attention_fn: Callable | None = None
    moe_experts: int = 0
    quantized: bool = False
    kv_cache_dtype: object = None
    kv_pages: int = 0
    kv_page_size: int = 0
    paged_kernel: bool = False
    int8_mesh: object = None
    lora_adapters: int = 0
    lora_rank: int = 0

    def __post_init__(self):
        for name, later in _LATER_SLICES.items():
            value = getattr(self, name)
            if value not in (None, 0, False):
                raise NotImplementedError(
                    f"TransformerConfig.{name}={value!r} is not supported by "
                    f"the PyTorch port yet; it arrives with {later}"
                )
        if not self.quantized:
            raise NotImplementedError(
                "TransformerConfig(quantized=False) is not supported by the "
                "PyTorch port yet; float weights arrive with the LM train "
                "step (this slice serves int8 weights)"
            )
        if self.dtype != torch.float32:
            raise NotImplementedError(
                f"TransformerConfig.dtype={self.dtype} is not supported by "
                "the PyTorch port yet; this slice computes in float32"
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

    @property
    def ff_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads


@dataclasses.dataclass
class KVCache:
    """The decode cache, passed into :meth:`TransformerLM.forward` and
    written there in place.

    ``k``/``v``: (L, B, W + 1, kv_heads, head_dim) float32 — W = the
    attention window. Position W is a write sink: a decode write at a
    position >= W (a parked slot that keeps stepping, or any row past its
    window) lands there and is never read, so such writes are DROPPED, not
    clamped onto the last real entry and not an index error. ``index``:
    (B,) int64 — each row's next write position (the JAX package's
    per-slot ``cache_index``)."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor

    @classmethod
    def zeros(cls, cfg: TransformerConfig, batch: int, window: int | None = None,
              device=None) -> "KVCache":
        w = cfg.max_seq_len if window is None else window
        shape = (cfg.n_layers, batch, w + 1, cfg.kv_heads, cfg.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=torch.float32, device=device),
            v=torch.zeros(shape, dtype=torch.float32, device=device),
            index=torch.zeros((batch,), dtype=torch.int64, device=device),
        )

    @property
    def window(self) -> int:
        return self.k.shape[2] - 1


class RMSNorm(nn.Module):
    """Root-mean-square norm (no mean subtraction); statistics in float64,
    rounded once to float32 (the module docstring's invariance)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, device=device), requires_grad=False
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x64 = x.double()
        inv = torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + self.eps)
        return (x64 * inv).float() * self.scale


def apply_rope(x: torch.Tensor, theta: float, offset=0) -> torch.Tensor:
    """Rotary position embedding over the last axis (half-split: the first
    and second halves of head_dim are the pair). ``x``: (B, S, H, D).
    ``offset`` is a scalar (every row at the same positions) or a (B,)
    tensor (each row at its own depth — slot-indexed decode)."""
    seq_len, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    off = torch.as_tensor(offset, device=x.device).to(torch.float32)
    pos = off[..., None] + torch.arange(
        seq_len, dtype=torch.float32, device=x.device
    )
    angles = pos[..., :, None] * freqs  # (S, half) or (B, S, half)
    if off.ndim == 0:
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
    else:
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def masked_attention(q, k, v, mask):
    """Scaled-dot-product attention with an explicit boolean ``mask``
    broadcastable to the (B, H, Q, K) scores: q (B, Q, H, D), k/v (B, K, H,
    D). Scores, softmax and context in float64 (module docstring), output
    in q's dtype."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double())
    scores = scores / math.sqrt(d)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    weights = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", weights, v.double())
    return ctx.to(q.dtype)


def grouped_masked_attention(q, k, v, mask):
    """GQA attention over an UN-expanded K/V: q (B, Q, H, D) against k/v
    (B, L, KV, D), H a multiple of KV — the group axis folds into the
    einsums, so the cache is read at its stored size. ``mask``
    broadcastable to (B, 1, Q, L). Falls through to
    :func:`masked_attention` when H == KV."""
    b, qlen, h, d = q.shape
    kvh = k.shape[2]
    if kvh == h:
        return masked_attention(q, k, v, mask)
    grp = h // kvh
    q5 = q.double().reshape(b, qlen, kvh, grp, d)
    scores = torch.einsum("bqcgd,blcd->bcgql", q5, k.double()) / math.sqrt(d)
    scores = torch.where(
        mask[:, :, None], scores, torch.full_like(scores, -1e30)
    )
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bcgql,blcd->bqcgd", weights, v.double())
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


def _store_decode_kv(buf, val, pos, window: int) -> None:
    """Write ``val`` (B, S, ...) into one layer's cache ``buf`` (B, W + 1,
    ...) at positions ``pos[r] + [0, S)`` per row, in place. Positions >=
    ``window`` go to the sink row W (:class:`KVCache`): dropped. No host
    sync — the drop is an index choice, not a branch."""
    b, s = val.shape[0], val.shape[1]
    cols = pos[:, None] + torch.arange(s, device=pos.device)
    cols = torch.where(cols < window, cols, torch.full_like(cols, window))
    rows = torch.arange(b, device=pos.device)[:, None].expand(b, s)
    buf[rows, cols] = val


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, kv, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        self.q_proj = Int8Linear(cfg.d_model, (h, d), device=device)
        self.k_proj = Int8Linear(cfg.d_model, (kv, d), device=device)
        self.v_proj = Int8Linear(cfg.d_model, (kv, d), device=device)
        self.o_proj = Int8Linear((h, d), cfg.d_model, n_in=2, device=device)

    def forward(self, x, cache: KVCache | None = None, layer: int = 0, *,
                prefill: bool = False, decode: bool = False, rows=None):
        cfg = self.cfg
        q_raw = self.q_proj(x)
        k_raw = self.k_proj(x)  # GQA: only kv_heads projected and cached
        v = self.v_proj(x)
        s = x.shape[1]
        if decode:
            # incremental decoding: S tokens per row written at the row's
            # own positions pos + [0, S), attention over the cache window
            # with each query masking positions beyond its own
            pos = cache.index
            window = cache.window
            q = apply_rope(q_raw, cfg.rope_theta, offset=pos)
            k = apply_rope(k_raw, cfg.rope_theta, offset=pos)
            _store_decode_kv(cache.k[layer], k, pos, window)
            _store_decode_kv(cache.v[layer], v, pos, window)
            qpos = pos[:, None] + torch.arange(s, device=x.device)  # (B, S)
            valid = (
                torch.arange(window, device=x.device) <= qpos[..., None]
            )  # (B, S, W): per-row depths
            out = grouped_masked_attention(
                q, cache.k[layer, :, :window], cache.v[layer, :, :window],
                valid[:, None],
            )
        else:
            q = apply_rope(q_raw, cfg.rope_theta)
            k = apply_rope(k_raw, cfg.rope_theta)
            if prefill:
                # batched prefill: the causal forward, and the cache of
                # `rows` (all, or one slot) gets K/V [0, S) with [S, W]
                # zeroed — the state a fresh cache would have
                sel = slice(None) if rows is None else rows
                kl, vl = cache.k[layer], cache.v[layer]
                kl[sel, :s] = k if rows is None else k[0]
                vl[sel, :s] = v if rows is None else v[0]
                kl[sel, s:] = 0
                vl[sel, s:] = 0
            h = cfg.n_heads
            out = causal_attention(q, _expand_kv(k, h), _expand_kv(v, h))
        return self.o_proj(out)


class SwiGLU(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.gate_proj = Int8Linear(cfg.d_model, cfg.ff_dim, device=device)
        self.up_proj = Int8Linear(cfg.d_model, cfg.ff_dim, device=device)
        self.down_proj = Int8Linear(cfg.ff_dim, cfg.d_model, device=device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.attn = Attention(cfg, device=device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.mlp = SwiGLU(cfg, device=device)

    def forward(self, x, cache=None, layer=0, *, prefill=False, decode=False,
                rows=None):
        x = x + self.attn(
            self.attn_norm(x), cache, layer, prefill=prefill, decode=decode,
            rows=rows,
        )
        return x + self.mlp(self.mlp_norm(x))


class TransformerLM(nn.Module):
    """Causal LM: tokens (B, S) int -> logits (B, S', vocab).

    Built on the ``meta`` device by default — structure only; the weights
    come from :func:`..models.convert.from_jax_params` or
    :func:`..models.convert.init_quantized_lm` and are bound with
    :func:`bind_params` (``ServeEngine`` and ``generate`` do it).

    Modes: plain (full causal forward, every position's logits);
    ``prefill=True`` (the causal forward that also writes ``cache`` rows
    ``rows`` — all, or the one slot an int names — and sets their index to
    S); ``decode=True`` (S tokens per cache row at the row's own position,
    written into ``cache``, index += S). Prefill, and decode with
    ``last_pos``, return only the logits at ``last_pos`` (scalar or (B,)),
    default the last position."""

    def __init__(self, cfg: TransformerConfig, device="meta"):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.n_layers)
        )
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.lm_head = Int8Linear(cfg.d_model, cfg.vocab_size, device=device)

    @torch.no_grad()
    def forward(self, tokens, cache: KVCache | None = None, *,
                prefill: bool = False, decode: bool = False, last_pos=None,
                rows=None):
        cfg = self.cfg
        if prefill and decode:
            raise ValueError("decode and prefill are exclusive")
        if (prefill or decode) and cache is None:
            raise ValueError("prefill/decode need a KVCache")
        b, s = tokens.shape
        if s > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {s} exceeds max_seq_len {cfg.max_seq_len}"
            )
        if prefill and s > cache.window:
            raise ValueError(f"prompt of {s} exceeds the cache window {cache.window}")
        x = self.tok_emb(tokens)
        for i, block in enumerate(self.blocks):
            x = block(x, cache, i, prefill=prefill, decode=decode, rows=rows)
        if prefill:
            cache.index[slice(None) if rows is None else rows] = s
        elif decode:
            cache.index += s
        if prefill or (decode and last_pos is not None):
            if last_pos is None:
                x = x[:, -1:]
            else:
                lp = torch.as_tensor(last_pos, device=x.device).expand(b)
                x = x[torch.arange(b, device=x.device), lp][:, None]
        return self.lm_head(self.final_norm(x))


def bind_params(model: TransformerLM, params: Mapping[str, torch.Tensor]) -> None:
    """Bind a state dict (from the weight bridge) into ``model``: the
    module then holds the caller's tensors themselves (no copy)."""
    model.load_state_dict(dict(params), strict=True, assign=True)


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
