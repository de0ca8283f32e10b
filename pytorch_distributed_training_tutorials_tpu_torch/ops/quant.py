"""Int8 weight quantization and the int8 matmul kernel.

Port of ``pytorch_distributed_training_tutorials_tpu/ops/quant.py``:

- :func:`quantize_int8` — per-channel symmetric absmax/127 weight
  quantization into an :class:`Int8Param`;
- :func:`pack_int4`, :func:`unpack_int4`, :func:`quantize_kv_int4` and
  :func:`dequantize_kv_int4` — int4 KV storage (half-split nibbles, bf16
  scales), bitwise the JAX package's;
- :func:`int8_matmul` — ``x @ (q * scale)`` with dynamic per-(row,
  K-tile) activation quantization. On a CUDA tensor it launches a
  hand-written Hopper kernel (a port of the TPU kernel
  ``_int8_matmul_kernel``): ``csrc/int8_matmul_sm90.cu`` (s8 wgmma, TMA
  weight ring, split K folded in tile order by the last block) where
  :func:`_sm90_route` takes the operands (K a multiple of 16, 16-byte
  aligned bases), else ``csrc/int8_matmul.cu`` (v1); ``route="v1"`` asks
  for the latter by name and ``int8_matmul.routes`` counts both. On a CPU
  tensor it runs :func:`int8_matmul_reference`, the plain PyTorch version
  of the same arithmetic; :func:`int8_matmul_split_reference` states the
  sm90 kernel's split-K order. There is no fallback between the two: a
  CUDA tensor goes through a kernel or the call raises;
- :func:`int8_matmul_tp` — the tensor-parallel ``x @ (q * scale)`` (the
  JAX package's ``int8_matmul_tp``): the Megatron column split (the rank's
  kernel call on its N shard) or row split (its kernel call on its K
  shard, then an ``all_reduce`` of the partials) over a
  :class:`..parallel.tensor_parallel.TensorParallel` group; on the card
  each shard's call is the kernel above. :func:`int8_matmul_tp_reference`
  states its arithmetic in one process;
- :class:`Int8Linear` — the serving layer over an int8 weight (both of the
  JAX package's ``Int8Dense`` and ``Int8DenseGeneral``: each flattens its
  kernel to a 2-D ``q`` with per-column scales), holding the whole weight
  or, with ``shard_kind``, the rank's shard of a tensor-parallel one.

Numerics follow the reference kernel as XLA executes it (the tests hold
the port bitwise to JAX's ``int8_matmul``): the activation scale is
``max(absmax, 1e-8) * float32(1/127)`` — XLA folds the reference's
``/ 127.0`` into a multiply by the rounded reciprocal — and each K tile is
folded in as one fused multiply-add ``acc = fma(part, sx, acc)``, the
contraction XLA makes. Weight scales, computed eagerly by
``quantize_int8``, keep the true division.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
from torch import nn

from pytorch_distributed_training_tutorials_tpu_torch.ops import _build
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
)

# float32(1 / 127): the constant XLA multiplies by in place of `/ 127.0`
_RCP127 = float.fromhex("0x1.020408p-7")
# float32(1 / 7): the same fold of the int4 KV quantizer's `/ 7.0`
_RCP7 = float.fromhex("0x1.24924ap-3")


@dataclasses.dataclass
class Int8Param:
    """Per-channel symmetric int8 weight: ``w ~= q * scale``.

    ``q``: int8 (K, N) — any strides (the serving layer keeps it
    K-contiguous, a transposed view of an (N, K) tensor, which is the
    layout the CUDA kernel takes). ``scale``: float32, broadcastable to
    ``q`` (1 everywhere except the channel axis)."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self) -> torch.Tensor:
        return self.q.float() * self.scale


def quantize_int8(w: torch.Tensor, channel_axis: int = -1) -> Int8Param:
    """absmax/127 per-channel symmetric quantization; ``channel_axis`` is
    the output-feature axis that keeps its own scale (-1 for a (in, out)
    kernel). Bitwise the JAX package's ``quantize_int8``."""
    w = w.float()
    axis = channel_axis % w.ndim
    reduce_dims = [a for a in range(w.ndim) if a != axis]
    absmax = w.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return Int8Param(q=q, scale=scale)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (any int dtype, range [-8, 7]) two per byte along
    the last axis, the HALF-SPLIT layout: uint8 byte ``j`` holds element
    ``j`` in its low nibble and element ``j + D/2`` in its high nibble.
    The last axis must be even; returns ``(..., D // 2)`` uint8. Bitwise
    the JAX package's ``pack_int4``. Inverse: :func:`unpack_int4`."""
    d = q.shape[-1]
    if d % 2:
        raise ValueError(f"pack_int4 needs an even last axis, got {d}")
    u = q.to(torch.uint8) & 0xF  # the two's-complement nibble
    return u[..., : d // 2] | (u[..., d // 2:] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 ``(..., D/2)`` -> int8 ``(...,
    D)``; each nibble sign-extends by ``n >= 8 -> n - 16``."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    return torch.cat([torch.where(n >= 8, n - 16, n) for n in (lo, hi)], dim=-1)


def quantize_kv_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize K/V ``(..., D)`` to packed int4 (:func:`pack_int4`) with a
    bfloat16 scale per token and head: ``absmax * float32(1/7)`` rounded to
    bf16, the form the JAX engine stores (its quantizer runs inside a jit,
    where XLA turns ``/ 7.0`` into that multiply). Codes divide by the
    ROUNDED scale and clip to [-7, 7], so dequantization with the stored
    scale is exact. A bf16 scale makes an int4 token-head cost exactly half
    its int8 twin: ``D/2 + 2`` bytes against ``D + 4``."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1)
    scale = (torch.clamp_min(absmax, 1e-8) * _RCP7).to(torch.bfloat16)
    q = torch.clamp(torch.round(x32 / scale.float()[..., None]), -7, 7)
    return pack_int4(q.to(torch.int8)), scale


def dequantize_kv_int4(packed: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Packed int4 codes and bf16 scales -> ``dtype``: ``code * scale`` in
    float32, then cast. The paged-attention kernel runs the same nibble
    math on each page tile."""
    return (unpack_int4(packed).float() * scale.float()[..., None]).to(dtype)


def block_k_for(k: int) -> int:
    """The K-tile width the TPU kernel uses (at its default ``block_k`` of
    512) for a K-long contraction: ``min(512, max(128, K))`` rounded up to
    a multiple of 128. The tile is the activation-quantization group, so
    it changes results, not just speed."""
    bk = min(512, max(128, k))
    return -(-bk // 128) * 128


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, b, c)``: the product of a tile's integer dot (< 2^24)
    and a float32 scale is exact in float64, so one float64 add and one
    rounding to float32 give the fused result (a double rounding can differ
    from it only when the float64 sum is inexact and lands on a float32
    rounding midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def int8_matmul_reference(x: torch.Tensor, w: Int8Param) -> torch.Tensor:
    """Plain PyTorch statement of the kernel's arithmetic, on any device:
    per-(row, K-tile) activation quantization over :func:`block_k_for`
    tiles, an exact integer dot per tile, float32 accumulation in tile
    order, then the per-column weight scale.

    Each tile's dot runs as a float32 matmul of integer values: a tile sum
    is at most 512 * 127 * 127 < 2^24, so it is exact whatever the
    summation order (and under TF32 too, whose 10-bit mantissa holds every
    int8 value)."""
    x = x.float()
    m, k = x.shape
    n = w.q.shape[1]
    bk = block_k_for(k)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for lo in range(0, k, bk):
        hi = min(lo + bk, k)
        xt = x[:, lo:hi]  # zero padding to bk changes neither absmax nor dot
        sx = torch.clamp_min(xt.abs().amax(dim=1, keepdim=True), 1e-8) * _RCP127
        xq = torch.clamp(torch.round(xt / sx), -127, 127)
        part = xq @ w.q[lo:hi].float()
        acc = _fma(part, sx, acc)
    return acc * w.scale.reshape(1, -1).float()


def int8_matmul_split_reference(x: torch.Tensor, w: Int8Param,
                                tiles_per_split: int) -> torch.Tensor:
    """Plain statement of the sm90 kernel's split-K order, on any device:
    the K tiles cut into runs of ``tiles_per_split``, each tile's exact
    integer dot and its activation scale kept apart (what a split's block
    writes to scratch), then every tile folded in tile order, ``acc =
    fma(part_t, sx_t, acc)``, and the column scale applied — the same
    fold as :func:`int8_matmul_reference`, so bitwise equal to it."""
    if tiles_per_split < 1:
        raise ValueError(f"tiles_per_split must be >= 1, got {tiles_per_split}")
    x = x.float()
    m, k = x.shape
    bk = block_k_for(k)
    n_k = -(-k // bk)
    parts, scales = [], []
    for t0 in range(0, n_k, tiles_per_split):  # one split's tiles
        for t in range(t0, min(t0 + tiles_per_split, n_k)):
            xt = x[:, t * bk:min(t * bk + bk, k)]
            sx = torch.clamp_min(xt.abs().amax(dim=1, keepdim=True), 1e-8) * _RCP127
            xq = torch.clamp(torch.round(xt / sx), -127, 127)
            parts.append(xq @ w.q[t * bk:t * bk + xt.shape[1]].float())
            scales.append(sx)
    acc = torch.zeros((m, w.q.shape[1]), dtype=torch.float32, device=x.device)
    for part, sx in zip(parts, scales):  # the last block's fold, in tile order
        acc = _fma(part, sx, acc)
    return acc * w.scale.reshape(1, -1).float()


_SLAB = 64  # output columns per block of the sm90 kernel
_FUSED_MAX_M = 64  # at or below, the sm90 kernel quantizes x inside the GEMM


def _sm90_route(k: int, x_ptr: int, q_ptr: int) -> bool:
    """True when a CUDA call goes to the sm90 kernel: K a multiple of 16
    (qt's row stride in whole 16 bytes, as a TMA map takes it) and x and
    qt 16-byte aligned. Every 1b / 1b-gqa projection qualifies; the
    tests' K 200 and 201 go to ``csrc/int8_matmul.cu``."""
    return k % 16 == 0 and x_ptr % 16 == 0 and q_ptr % 16 == 0


def _sm90_plan(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(tiles per split, splits) of the sm90 kernel: the K tiles split
    across blocks until the grid of (64-column slabs x 64-row tiles x
    splits) comes near one block per SM — (4, 2048, 2048) on 132 SMs: 32
    slabs x 4 splits of 1 tile; (4, 8192, 2048): 32 x 4 of 4 tiles;
    (4, 2048, 8192) and wider, and M 512 and up: no split."""
    n_k = -(-k // block_k_for(k))
    slabs = -(-n // _SLAB)
    row_tiles = 1 if m <= _FUSED_MAX_M else -(-m // _SLAB)
    splits = max(1, min(n_k, sms // (slabs * row_tiles)))
    tps = -(-n_k // splits)
    return tps, -(-n_k // tps)


_SMS: dict = {}  # device index -> its SM count, read once


def _sm_count(device) -> int:
    idx = torch.device(device).index
    count = _SMS.get(idx)
    if count is None:
        count = _SMS[idx] = torch.cuda.get_device_properties(device).multi_processor_count
    return count


def _launch(sm90: bool, x: torch.Tensor, w: Int8Param, out: torch.Tensor) -> None:
    """One call on the current stream: ``int8_matmul_sm90_launch`` (one
    launch at M <= 64, a quantize pre-pass and the GEMM above) when
    ``sm90``, else ``int8_matmul_launch`` (v1: a quantize pass and the
    GEMM); counted in ``int8_matmul.launches`` and ``.routes``."""
    m, k = x.shape
    n = w.q.shape[1]
    bk = block_k_for(k)
    n_k = -(-k // bk)
    dev = x.device
    null = ctypes.c_void_p(0)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if sm90:
            tps, splits = _sm90_plan(m, k, n, _sm_count(dev))
            fused = m <= _FUSED_MAX_M
            slabs = -(-n // _SLAB)
            row_tiles = 1 if fused else -(-m // _SLAB)
            keep = []  # scratch alive until the launch is queued

            def scratch(shape, dtype, needed):
                if not needed:
                    return null
                keep.append(torch.empty(shape, dtype=dtype, device=dev))
                return keep[-1].data_ptr()

            rc = _build.library("int8_matmul_sm90").int8_matmul_sm90_launch(
                x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
                scratch((m, n_k * bk), torch.int8, not fused),
                scratch((n_k, m), torch.float32, not fused),
                scratch((slabs, n_k, m, _SLAB), torch.float32, splits > 1),
                scratch((slabs, n_k, m), torch.float32, splits > 1 and fused),
                _build.tickets(dev, slabs * row_tiles, "int8_matmul").data_ptr(),
                m, n, k, bk, tps, splits, stream,
            )
        else:
            xq = torch.empty((m, n_k * bk), dtype=torch.int8, device=dev)
            sx = torch.empty((m, n_k), dtype=torch.float32, device=dev)
            rc = _build.library("int8_matmul").int8_matmul_launch(
                x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(),
                out.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                m, n, k, bk, stream,
            )
    route = "sm90" if sm90 else "v1"
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed ({route}): CUDA error {rc}")
    int8_matmul.launches += 1
    int8_matmul.routes[route] += 1


def _on_card(x: torch.Tensor) -> bool:
    """True to launch a kernel (CUDA), False to run the plain version (CPU);
    raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cpu or cuda, got {x.device}")
    return True


def _check_cuda_args(x: torch.Tensor, w: Int8Param) -> None:
    if not (w.q.device == x.device == w.scale.device):
        raise ValueError(
            f"int8_matmul operands on different devices: x {x.device}, "
            f"q {w.q.device}, scale {w.scale.device}"
        )
    if x.dtype != torch.float32:
        raise TypeError(f"int8_matmul kernel takes float32 x, got {x.dtype}")
    if w.q.dtype != torch.int8:
        raise TypeError(f"int8_matmul kernel takes int8 q, got {w.q.dtype}")
    if w.scale.dtype != torch.float32:
        raise TypeError(
            f"int8_matmul kernel takes float32 scale, got {w.scale.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("int8_matmul kernel takes a contiguous (M, K) x")
    if not w.q.t().is_contiguous():
        raise ValueError(
            "int8_matmul kernel takes q (K, N) K-contiguous — a transposed "
            "view of an (N, K) contiguous tensor (Int8Linear stores it so)"
        )
    if not w.scale.is_contiguous():
        raise ValueError("int8_matmul kernel takes a contiguous scale")
    if x.numel() >= 2**31 or w.q.numel() >= 2**31:
        raise ValueError("int8_matmul kernel indexes with 32-bit sizes")


def int8_matmul(x: torch.Tensor, w: Int8Param, *, route: str | None = None) -> torch.Tensor:
    """``x @ (q * scale)`` with dynamic per-(row, K-tile) int8 activation
    quantization. ``x``: (M, K) float; ``w.q``: (K, N) int8 with
    per-column ``w.scale`` (1, N) or (N,). Returns (M, N) float32.

    A CPU ``x`` runs :func:`int8_matmul_reference`. A CUDA ``x`` launches
    a kernel (built at first use) on the current stream —
    ``csrc/int8_matmul_sm90.cu`` where :func:`_sm90_route` takes the
    operands, else ``csrc/int8_matmul.cu``; ``route="v1"`` asks for the
    latter whatever the operands — and adds one to
    ``int8_matmul.launches``; it raises on operands the kernels do not
    take and when the launch fails."""
    if route not in (None, "v1"):
        raise ValueError(f"route must be None or 'v1', got {route!r}")
    m, k = x.shape
    kq, n = w.q.shape
    if k != kq:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} vs q {tuple(w.q.shape)}")
    if tuple(w.scale.shape) not in ((1, n), (n,)):
        raise ValueError(
            f"int8_matmul needs per-output-column scales of size {n} "
            f"(quantize with channel_axis=-1); got scale shape "
            f"{tuple(w.scale.shape)}"
        )
    if not _on_card(x):
        return int8_matmul_reference(x, w)
    _check_cuda_args(x, w)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    sm90 = route is None and _sm90_route(k, x.data_ptr(), w.q.data_ptr())
    _launch(sm90, x, w, out)
    return out


int8_matmul.launches = 0  # calls that launched a kernel (CPU calls add none)
# of those, by route: "sm90" (int8_matmul_sm90.cu) or "v1" (int8_matmul.cu)
int8_matmul.routes = {"sm90": 0, "v1": 0}


_SHARD_KINDS = ("column", "row")


def int8_matmul_shard(x: torch.Tensor, w: Int8Param, tp: TensorParallel, kind: str) -> torch.Tensor:
    """One rank's part of a tensor-parallel int8 matmul on operands it
    already holds sharded: ``kind="column"``, ``x`` (M, K) whole and ``w``
    the rank's (K, N/tp) column block — its (M, N/tp) output block;
    ``kind="row"``, ``x`` the rank's (M, K/tp) feature block and ``w`` its
    (K/tp, N) row block with the full per-column scales — the partial,
    summed over the group in place (one ``all_reduce``). The kernel call
    is :func:`int8_matmul` (the sm90 kernel on a card, the plain version
    on the CPU); each call that launches one adds one to
    ``int8_matmul_tp.launches``."""
    if kind not in _SHARD_KINDS:
        raise ValueError(f"kind must be 'column' or 'row', got {kind!r}")
    launched = int8_matmul.launches
    out = int8_matmul(x, w)
    int8_matmul_tp.launches += int8_matmul.launches - launched
    if kind == "row":
        tp.all_reduce(out)
    return out


def int8_matmul_tp(x: torch.Tensor, w: Int8Param, strategy_or_group, *, kind: str,
                   axis: str = "model") -> torch.Tensor:
    """Tensor-parallel ``x @ (q * scale)`` over the ``model`` group, from
    GLOBAL operands (the JAX package's ``int8_matmul_tp``: the kernel
    stated per shard, the split made explicit rather than propagated).

    - ``kind="column"``: the rank multiplies the whole ``x`` by its block
      of N/tp columns of ``q`` and their scales, and returns that (M,
      N/tp) block of the output. Activation quantization sees the
      unsharded call's (row, K-tile) groups: the block is bitwise the
      unsharded call's columns;
    - ``kind="row"``: the rank multiplies its block of K/tp features of
      ``x`` by its K/tp rows of ``q`` (scales replicated) and the partials
      are summed over the group (one ``all_reduce``): the (M, N) result,
      the same on every rank. Activations quantize per (row, LOCAL
      K-tile), a regrouping of the unsharded tiles (the same ones when
      K/tp is a multiple of 512, as at 1b with tp 2), and the sum runs in
      the reduction's order: :func:`int8_matmul_tp_reference` states it.

    ``strategy_or_group``: a :class:`TensorParallel`, a process group, or a
    mesh with a ``model`` axis. The row split's slices of ``x`` and ``q``
    are copied dense for the kernel here; a served model holds its shards
    dense from load (:class:`Int8Linear` with ``shard_kind``)."""
    if isinstance(strategy_or_group, TensorParallel):
        tp = strategy_or_group
    else:
        names = getattr(strategy_or_group, "mesh_dim_names", None)
        if names is not None:
            if axis not in names:
                raise ValueError(f"mesh has no {axis!r} axis: {tuple(names)}")
            strategy_or_group = strategy_or_group.get_group(axis)
        tp = TensorParallel(strategy_or_group)
    n_shards, r = tp.tp_size, tp.rank
    m, k = x.shape
    n = w.q.shape[1]
    scale = w.scale.reshape(1, n)
    if kind == "column":
        if n % n_shards:
            raise ValueError(f"column split needs N ({n}) % {n_shards} == 0")
        nl = n // n_shards
        cols = slice(r * nl, (r + 1) * nl)
        qt = w.q.t()[cols]  # rows of (N, K): a dense block when q is K-contiguous
        shard = Int8Param(q=qt.contiguous().t(), scale=scale[:, cols].contiguous())
        return int8_matmul_shard(x, shard, tp, "column")
    if kind == "row":
        if k % n_shards:
            raise ValueError(f"row split needs K ({k}) % {n_shards} == 0")
        kl = k // n_shards
        feats = slice(r * kl, (r + 1) * kl)
        shard = Int8Param(q=w.q[feats].t().contiguous().t(), scale=scale)
        return int8_matmul_shard(x[:, feats].contiguous(), shard, tp, "row")
    raise ValueError(f"kind must be 'column' or 'row', got {kind!r}")


int8_matmul_tp.launches = 0  # shard calls that launched a kernel (CPU calls add none)


def int8_matmul_tp_reference(x: torch.Tensor, w: Int8Param, tp: int, kind: str) -> torch.Tensor:
    """Plain statement of :func:`int8_matmul_tp` over all ``tp`` shards in
    one process, with no group: column, every shard's
    :func:`int8_matmul_reference` on its N block, concatenated — bitwise
    the unsharded reference (a column's arithmetic does not see the
    others); row, every shard's reference on its K block, summed in rank
    order (a 2-wide reduction sums the same two terms; wider ones may sum
    in another order, within float32 rounding). Returns the full (M, N)
    result."""
    m, k = x.shape
    n = w.q.shape[1]
    scale = w.scale.reshape(1, n)
    if kind == "column":
        nl = n // tp
        return torch.cat([
            int8_matmul_reference(x, Int8Param(q=w.q[:, i * nl:(i + 1) * nl],
                                               scale=scale[:, i * nl:(i + 1) * nl]))
            for i in range(tp)], dim=1)
    if kind == "row":
        kl = k // tp
        out = None
        for i in range(tp):
            part = int8_matmul_reference(x[:, i * kl:(i + 1) * kl],
                                         Int8Param(q=w.q[i * kl:(i + 1) * kl], scale=scale))
            out = part if out is None else out + part
        return out
    raise ValueError(f"kind must be 'column' or 'row', got {kind!r}")


class Int8Linear(nn.Module):
    """Serving layer over an int8 weight: contracts the last ``n_in`` axes
    of ``x`` (``K`` = their product) into ``features`` (``N`` = their
    product) through :func:`int8_matmul`.

    One module for both of the JAX package's ``Int8Dense`` (``n_in=1``,
    one feature axis) and ``Int8DenseGeneral`` (q/k/v: ``d_model -> (H,
    D)``; o_proj: ``(H, D) -> d_model``, ``n_in=2``). Buffers: ``qt`` (N,
    K) int8 — the (K, N) ``q`` stored transposed, K-contiguous, the layout
    the kernel reads (the weight bridge converts once at load) — and
    ``scale`` (1, N) float32. No bias: the transformer's projections have
    none.

    ``shard_kind`` ("column" or "row", with ``strategy`` a
    :class:`..parallel.tensor_parallel.TensorParallel`; the JAX layers'
    ``shard_kind``): the layer holds the rank's shard — ``in_features`` /
    ``features`` are then the SHARD's — and runs
    :func:`int8_matmul_shard`: a column layer's output is its block of
    the features, a row layer's the group's sum (one ``all_reduce``)."""

    def __init__(self, in_features, features, n_in: int = 1, device=None,
                 shard_kind: str | None = None, strategy: TensorParallel | None = None):
        super().__init__()
        if shard_kind is not None and (shard_kind not in _SHARD_KINDS or strategy is None):
            raise ValueError(f"shard_kind {shard_kind!r} needs 'column' or 'row' and a "
                             "TensorParallel strategy")
        feats = tuple(features) if isinstance(features, (tuple, list)) else (features,)
        ins = tuple(in_features) if isinstance(in_features, (tuple, list)) else (in_features,)
        self.features = feats
        self.n_in = n_in
        self.shard_kind = shard_kind
        self.strategy = strategy
        k, n = math.prod(ins), math.prod(feats)
        self.register_buffer(
            "qt", torch.zeros((n, k), dtype=torch.int8, device=device)
        )
        self.register_buffer(
            "scale", torch.ones((1, n), dtype=torch.float32, device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[: x.ndim - self.n_in]
        x2 = x.reshape(-1, self.qt.shape[1]).contiguous()
        w = Int8Param(q=self.qt.t(), scale=self.scale)
        if self.shard_kind is None:
            out = int8_matmul(x2, w)
        else:
            out = int8_matmul_shard(x2, w, self.strategy, self.shard_kind)
        return out.reshape(*lead, *self.features)
