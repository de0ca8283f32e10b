"""Causal flash attention: softmax attention without the (S, S) scores.

Port of ``pytorch_distributed_training_tutorials_tpu/ops/flash_attention.py``.
Three kernels, each with a plain PyTorch version beside it that follows
its arithmetic:

- :func:`flash_fwd` — the online-softmax forward, O and the per-row f32
  logsumexp (the port of the TPU ``_fwd_kernel``: ``fwd_sm90_kernel`` of
  ``csrc/flash_attention_sm90.cu`` or ``fwd_kernel`` of
  ``csrc/flash_attention.cu``, see below); plain:
  :func:`flash_fwd_reference`;
- :func:`flash_dq` — dq accumulated over key blocks (``_dq_kernel``);
  plain: :func:`flash_dq_reference`;
- :func:`flash_dkv` — dk and dv accumulated over query blocks
  (``_dkv_kernel``); plain: :func:`flash_dkv_reference`.

:func:`flash_attention` ties them into a ``torch.autograd.Function`` (the
JAX ``custom_vjp``): the forward saves q, k, v, O and the logsumexp, and
the backward computes ``delta = rowsum(dO * O)`` in plain torch, then
launches dq and dk/dv. It is a drop-in ``attention_fn`` for
:class:`..models.transformer.TransformerConfig`: (B, S, H, D) in and out,
causal, as ``causal_attention``. Serving calls it too, under
``torch.no_grad()``: every whole prefill of a model with this
``attention_fn`` (int8 weights: f32 operands, the ``fwd_kernel`` route;
bf16 float weights: the sm90 route) runs one forward launch a layer at
B = 1 and the bucket-padded S, GQA K/V expanded by ``repeat_interleave``
(contiguous, so the operands keep the strides the sm90 route takes);
splices and chunks run the dense cached decode instead.

Each wrapper runs the plain version on a CPU tensor and launches its
kernel on a CUDA tensor (bf16 or f32, head dim a multiple of 8 up to 128,
last axis contiguous), on the current stream; it raises on anything else
and when a launch fails, and never falls back. ``flash_attention.launches``
counts kernel launches; CPU calls add none.

Each kernel has two routes on the card, chosen by :func:`_sm90_route`
before the launch: a bf16 call whose operands (q, k, v, and dO in the
backward) have 16-byte aligned bases and B, S, H strides that are positive
multiples of 16 bytes (what a TMA map takes) runs
``csrc/flash_attention_sm90.cu`` (TMA, mbarrier ring, wgmma; 128 query
rows, or 128 keys for dk/dv, a block): ``fwd_sm90_kernel``,
``dq_sm90_kernel``, ``dkv_sm90_kernel``; every other call (f32,
misaligned views) runs ``flash_attention.cu``'s ``fwd_kernel``,
``dq_kernel``, ``dkv_kernel``. Both routes compute the same function;
``flash_attention.routes`` counts the launches of each route by kernel,
and ``route="sm80"`` asks for the old kernel by name. A failed sm90 build
or launch raises. :func:`kernel_error` (from :mod:`._check`, shared with
the fused loss) is the check that holds a kernel's output to its plain
version's.

Numerics, as in the TPU kernels: scores, softmax and every accumulator in
f32 (f64 for f64 inputs, which only the plain versions take); ``p`` is cast
to v's type before P·V, ``ds`` to k's type before dS·K, and in the dk/dv
pass ``p`` to dO's type and ``ds`` to q's type. ``block_q``/``block_k`` set
the plain versions' blocks (clamped to the 8-aligned sequence length as
the JAX package clamps them off the TPU); the CUDA kernels tile by 64
or 128 whatever they are, and the plain versions do not pad S.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import _build
from pytorch_distributed_training_tutorials_tpu_torch.ops._check import (  # noqa: F401
    KERNEL_TOLERANCE,
    kernel_error,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _block_sizes(s: int, block_q: int, block_k: int) -> tuple[int, int]:
    """Blocks clamped to the 8-aligned sequence length (the JAX package's
    ``_block_sizes`` off the TPU, where no 128-lane rounding applies)."""
    s8 = -(-max(8, s) // 8) * 8
    return min(block_q, s8), min(block_k, s8)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _heads(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, S, D) in ``dt``."""
    return x.permute(0, 2, 1, 3).to(dt)


def _guard(lse: torch.Tensor) -> torch.Tensor:
    """The -inf shift guard of the TPU kernels: a row with lse = -inf
    (every key masked) shifts by 0."""
    return torch.where(lse == float("-inf"), torch.zeros_like(lse), lse)


def _causal(q0: int, q1: int, k0: int, k1: int, device) -> torch.Tensor:
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    return qpos >= kpos


def flash_fwd_reference(q, k, v, block_q: int = 512, block_k: int = 512):
    """Plain version of the forward kernel: online softmax over key
    blocks of ``block_k``. Returns (O (B, S, H, D) in q's type, lse (B, H,
    S) f32)."""
    b, s, h, d = q.shape
    acc_t = _acc_dtype(q)
    scale = 1.0 / d ** 0.5
    _, bk = _block_sizes(s, block_q, block_k)
    qf, kf, vf = _heads(q, acc_t), _heads(k, acc_t), _heads(v, acc_t)
    neg_inf = torch.tensor(float("-inf"), dtype=acc_t, device=q.device)
    m = torch.full((b, h, s, 1), float("-inf"), dtype=acc_t, device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=acc_t, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=acc_t, device=q.device)
    for k0 in range(0, s, bk):
        k1 = min(k0 + bk, s)
        sc = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        sc = torch.where(_causal(0, s, k0, k1, q.device), sc, neg_inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        shift = _guard(m_new)
        p = torch.exp(sc - shift)
        corr = torch.exp(m - shift)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).to(acc_t) @ vf[:, :, k0:k1]
        m = m_new
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc / safe_l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = torch.where(m == float("-inf"), m, m + torch.log(safe_l))
    return o, lse[..., 0]


def flash_dq_reference(q, k, v, do, lse, delta, block_q: int = 512,
                       block_k: int = 512):
    """Plain version of the dq kernel: ``dq = sum over key blocks of
    (ds . k) * scale``, ds = p * (dp - delta) cast to k's type."""
    b, s, h, d = q.shape
    acc_t = _acc_dtype(q)
    scale = 1.0 / d ** 0.5
    _, bk = _block_sizes(s, block_q, block_k)
    qf, kf, vf, dof = (_heads(x, acc_t) for x in (q, k, v, do))
    lse_g = _guard(lse.to(acc_t))[..., None]
    dlt = delta.to(acc_t)[..., None]
    acc = torch.zeros((b, h, s, d), dtype=acc_t, device=q.device)
    for k0 in range(0, s, bk):
        k1 = min(k0 + bk, s)
        sc = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        p = torch.exp(sc - lse_g)
        p = torch.where(_causal(0, s, k0, k1, q.device), p, torch.zeros_like(p))
        dp = dof @ vf[:, :, k0:k1].transpose(-1, -2)
        ds = p * (dp - dlt)
        acc = acc + (ds.to(k.dtype).to(acc_t) @ kf[:, :, k0:k1]) * scale
    return acc.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_dkv_reference(q, k, v, do, lse, delta, block_q: int = 512,
                        block_k: int = 512):
    """Plain version of the dk/dv kernel: ``dv = sum over query blocks of
    p^T . dO`` (p cast to dO's type) and ``dk = sum of (ds^T . q) * scale``
    (ds cast to q's type)."""
    b, s, h, d = q.shape
    acc_t = _acc_dtype(q)
    scale = 1.0 / d ** 0.5
    bq, _ = _block_sizes(s, block_q, block_k)
    qf, kf, vf, dof = (_heads(x, acc_t) for x in (q, k, v, do))
    lse_g = _guard(lse.to(acc_t))[..., None]
    dlt = delta.to(acc_t)[..., None]
    dk = torch.zeros((b, h, s, d), dtype=acc_t, device=q.device)
    dv = torch.zeros((b, h, s, d), dtype=acc_t, device=q.device)
    for q0 in range(0, s, bq):
        q1 = min(q0 + bq, s)
        sc = (qf[:, :, q0:q1] @ kf.transpose(-1, -2)) * scale  # (.., bq, S)
        p = torch.exp(sc - lse_g[:, :, q0:q1])
        p = torch.where(_causal(q0, q1, 0, s, q.device), p, torch.zeros_like(p))
        dv = dv + p.to(do.dtype).to(acc_t).transpose(-1, -2) @ dof[:, :, q0:q1]
        dp = dof[:, :, q0:q1] @ vf.transpose(-1, -2)
        ds = p * (dp - dlt[:, :, q0:q1])
        dk = dk + (ds.to(q.dtype).to(acc_t).transpose(-1, -2) @ qf[:, :, q0:q1]) * scale
    out = lambda x, like: x.to(like.dtype).permute(0, 2, 1, 3).contiguous()  # noqa: E731
    return out(dk, k), out(dv, v)


def _check_shapes(q, *others) -> None:
    if q.ndim != 4:
        raise ValueError(f"flash attention takes (B, S, H, D) tensors, got {tuple(q.shape)}")
    for x in others:
        if tuple(x.shape) != tuple(q.shape):
            raise ValueError(
                f"flash attention operands differ in shape: {tuple(q.shape)} vs "
                f"{tuple(x.shape)} (expand GQA K/V heads first)"
            )


def _route(q: torch.Tensor, *tensors) -> bool:
    """True to launch a kernel (CUDA), False to run the plain version
    (CPU); raises on any other device or on operands it cannot take."""
    devices = {x.device for x in (q, *tensors)}
    if len(devices) != 1:
        raise ValueError(f"flash attention operands on different devices: {devices}")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, got {q.device}")
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take bfloat16 or float32, got {q.dtype}")
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"flash attention kernels take a head dim that is a multiple of 8 up to 128, got {d}")
    for x in (q, *tensors):
        if x.ndim == 4:
            if x.dtype != q.dtype:
                raise TypeError(f"flash attention operands differ in dtype: {q.dtype} vs {x.dtype}")
            if x.stride(-1) != 1:
                raise ValueError("flash attention kernels take tensors whose last axis is contiguous")
        elif x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("lse and delta must be contiguous float32 (B, H, S)")
    return True


def _layout(x: torch.Tensor) -> _build.Layout:
    return _build.Layout(x.stride(0), x.stride(1), x.stride(2))


def _launch(name: str, sm90: bool, q: torch.Tensor, ptrs, layouts) -> None:
    """One launch of kernel ``name`` (fwd, dq or dkv) on the current stream:
    ``flash_{name}_sm90_launch`` of ``flash_attention_sm90.cu`` when
    ``sm90``, else ``flash_{name}_launch`` of ``flash_attention.cu``;
    counted in ``flash_attention.launches`` and ``.routes``."""
    b, s, h, d = q.shape
    fn_name = f"flash_{name}_sm90_launch" if sm90 else f"flash_{name}_launch"
    lib = _build.library("flash_attention_sm90" if sm90 else "flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, fn_name)(
            *(x.data_ptr() for x in ptrs), *(_layout(x) for x in layouts),
            b, s, h, d, _DTYPE_CODES[q.dtype], ctypes.c_float(1.0 / d ** 0.5),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"flash_{name} kernel launch failed ({fn_name}): CUDA error {rc}")
    flash_attention.launches[name] += 1
    flash_attention.routes[name]["sm90" if sm90 else "sm80"] += 1


def _sm90_route(dtype: torch.dtype, d: int, ptrs, strides) -> bool:
    """True when a CUDA call goes to the sm90 kernel: bf16, D a multiple of
    8 from 8 to 128 (padded to 64, 96 or 128), every operand's base
    (``ptrs``) 16-byte aligned and every B, S, H element stride
    (``strides``) positive and a whole multiple of 16 bytes — what a TMA
    map of each takes. False sends it to ``flash_attention.cu``'s
    kernel."""
    return (dtype == torch.bfloat16 and d % 8 == 0 and 8 <= d <= 128
            and all(p % 16 == 0 for p in ptrs)
            and all(st > 0 and (2 * st) % 16 == 0 for st in strides))


def _use_sm90(q, k, v, route: str | None, *more) -> bool:
    """Whether a CUDA call launches the sm90 kernel: by :func:`_sm90_route`
    over q, k, v and ``more`` (the backward's dO) when ``route`` is None;
    ``route="sm80"`` asks for ``flash_attention.cu``'s kernel whatever the
    operands (the card check times both on one input)."""
    if route not in (None, "sm80"):
        raise ValueError(f"route must be None or 'sm80', got {route!r}")
    xs = (q, k, v, *more)
    return route is None and _sm90_route(
        q.dtype, q.shape[-1], [x.data_ptr() for x in xs],
        [st for x in xs for st in x.stride()[:3]])


def flash_fwd(q, k, v, block_q: int = 512, block_k: int = 512, *,
              route: str | None = None):
    """Causal attention forward: (O (B, S, H, D) in q's type, lse (B, H,
    S) f32). A CPU tensor runs :func:`flash_fwd_reference`; a CUDA tensor
    launches the sm90 kernel where :func:`_sm90_route` takes it, else
    ``fwd_kernel``; ``route``: see :func:`_use_sm90`."""
    _check_shapes(q, k, v)
    if not _route(q, k, v):
        return flash_fwd_reference(q, k, v, block_q, block_k)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("fwd", _use_sm90(q, k, v, route), q, (q, k, v, o, lse), (q, k, v, o))
    return o, lse


def flash_dq(q, k, v, do, lse, delta, block_q: int = 512, block_k: int = 512, *,
             route: str | None = None):
    """dq from the saved lse and ``delta = rowsum(dO * O)`` (both (B, H,
    S) f32). A CPU tensor runs :func:`flash_dq_reference`; a CUDA tensor
    launches ``dq_sm90_kernel`` where :func:`_sm90_route` takes q, k, v
    and dO, else ``dq_kernel``; ``route``: see :func:`_use_sm90`."""
    _check_shapes(q, k, v, do)
    if not _route(q, k, v, do, lse, delta):
        return flash_dq_reference(q, k, v, do, lse, delta, block_q, block_k)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("dq", _use_sm90(q, k, v, route, do), q, (q, k, v, do, lse, delta, dq),
            (q, k, v, do, dq))
    return dq


def flash_dkv(q, k, v, do, lse, delta, block_q: int = 512, block_k: int = 512, *,
              route: str | None = None):
    """(dk, dv) from the saved lse and delta. A CPU tensor runs
    :func:`flash_dkv_reference`; a CUDA tensor launches
    ``dkv_sm90_kernel`` where :func:`_sm90_route` takes q, k, v and dO,
    else ``dkv_kernel``; ``route``: see :func:`_use_sm90`."""
    _check_shapes(q, k, v, do)
    if not _route(q, k, v, do, lse, delta):
        return flash_dkv_reference(q, k, v, do, lse, delta, block_q, block_k)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("dkv", _use_sm90(q, k, v, route, do), q, (q, k, v, do, lse, delta, dk, dv),
            (q, k, v, do, dk, dv))
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k):
        o, lse = flash_fwd(q, k, v, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blocks = (block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum
            do = do.contiguous()
        acc_t = _acc_dtype(q)
        # delta_i = rowsum(dO_i * O_i): O(S) elementwise work outside the
        # kernels, as in the JAX package
        delta = (do.to(acc_t) * o.to(acc_t)).sum(-1).transpose(1, 2).contiguous()
        dq = flash_dq(q, k, v, do, lse, delta, *ctx.blocks)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, *ctx.blocks)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, block_q: int = 512, block_k: int = 512):
    """Causal flash attention; (B, S, H, D) in and out, differentiable in
    q, k and v. Use as ``TransformerConfig(attention_fn=flash_attention)``
    or through :func:`make_flash_attention`."""
    return _FlashAttention.apply(q, k, v, block_q, block_k)


# kernel launches on the card by kernel (CPU calls add none)
flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
# launches by kernel and route: "sm90" (flash_attention_sm90.cu) or "sm80"
# (flash_attention.cu's mma.sync kernels)
flash_attention.routes = {k: {"sm90": 0, "sm80": 0} for k in ("fwd", "dq", "dkv")}


def make_flash_attention(block_q: int = 512, block_k: int = 512):
    """Fix the plain versions' block sizes; returns an ``attention_fn(q,
    k, v)`` for :class:`..models.transformer.TransformerConfig`."""

    def attention_fn(q, k, v):
        return flash_attention(q, k, v, block_q, block_k)

    return attention_fn
