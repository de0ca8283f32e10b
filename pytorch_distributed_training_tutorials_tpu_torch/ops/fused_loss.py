"""Blockwise softmax cross entropy: the LM loss without the logits.

Port of ``pytorch_distributed_training_tutorials_tpu/ops/fused_loss.py``.
Three kernels, each with a plain PyTorch version beside it that follows its
arithmetic:

- :func:`fused_ce_fwd` — per row the logsumexp and the target logit, f32,
  from an online logsumexp over vocab blocks of ``h @ W`` (the port of
  the TPU ``_fwd_kernel``); plain: :func:`fused_ce_fwd_reference`;
- :func:`fused_ce_dh` — ``dh = sum over vocab blocks of dS . W^T``
  (``_dh_kernel``); plain: :func:`fused_ce_dh_reference`;
- :func:`fused_ce_dw` — ``dW = sum over row blocks of h^T . dS``
  (``_dw_kernel``); plain: :func:`fused_ce_dw_reference`;

with ``dS = g * (softmax(h @ W) - onehot(y))`` recomputed from the saved
logsumexp. :func:`fused_cross_entropy` ties them into a
``torch.autograd.Function`` (the JAX ``custom_vjp``): the forward saves h,
W, y and the lse, the backward launches dh, then dW, and returns no
gradient for the targets. The (N, V) logits never exist.

Each wrapper runs the plain version on a CPU tensor and launches its
kernel on a CUDA tensor (h and W contiguous, both bf16 or both f32), on
the current stream; it raises on anything else and when a launch fails,
and never falls back. ``fused_cross_entropy.launches`` counts kernel
launches; CPU calls add none.

Each kernel has two routes on the card, chosen by :func:`_sm90_route`
before the launch: a bf16 call with 16-byte aligned h and W and D, V
multiples of 8 (what TMA takes) runs ``csrc/fused_loss_sm90.cu`` (TMA,
mbarrier ring, wgmma; the forward on 128 rows a block, dS kept on chip
for 1024 vocab columns of 64 rows in dh and 512 rows of 128 columns in
dW); every other call runs ``fused_loss.cu``'s ``fwd_kernel``,
``dh_kernel`` and ``dw_kernel`` (mma.sync; f32, and bf16 with D or V not
a multiple of 8 or misaligned operands). Both compute the same function;
``fused_cross_entropy.routes`` counts the launches of each route. A
failed sm90 build or launch raises. :func:`kernel_error` (from
:mod:`._check`, shared with flash attention) holds a kernel's output to
its plain version's.

Numerics, as in the TPU kernels: scores, softmax and every accumulator in
f32 (f64 for f64 inputs, which only the plain versions take), the scores
from operands in the input type; columns past V are masked (the plain
versions cut the last block at V), a target out of ``[0, V)`` hits
nothing, so its loss is the lse; the -inf shift is guarded; ``dS`` is cast
to W's type before ``dS . W^T`` (dh written in h's type) and to h's type
before ``h^T . dS`` (dW written in W's type). ``block_n``/``block_v`` set
the plain versions' blocks, clamped as the JAX package's ``_clamp_block``
clamps them off the TPU; the CUDA kernels tile by 64 rows x 128 columns
whatever they are and split the vocab over blocks to fill the card (the
forward's per-split logsumexps and dh's per-split f32 partials are
combined here, in a few elementwise ops).
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import _build
from pytorch_distributed_training_tutorials_tpu_torch.ops._check import (  # noqa: F401
    KERNEL_TOLERANCE,
    kernel_error,
)

DEFAULT_BLOCK_N = 512
DEFAULT_BLOCK_V = 512

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' tiles (csrc/fused_loss.cu kBM, kBV)
_TILE_ROWS, _TILE_COLS = 64, 128


def _clamp_block(b: int, dim: int) -> int:
    """A block clamped to the 8-aligned dim (the JAX ``_clamp_block`` off
    the TPU, where no 128-lane rounding applies)."""
    d8 = -(-max(8, dim) // 8) * 8
    return d8 if b >= d8 else b


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _guard(lse: torch.Tensor) -> torch.Tensor:
    """The -inf shift guard: a row with lse = -inf shifts by 0."""
    return torch.where(lse == float("-inf"), torch.zeros_like(lse), lse)


def _dlogits(s, y, lse, g, c0: int) -> torch.Tensor:
    """The dS block of both backward passes: ``g * (exp(s - lse) -
    onehot(y))`` for the columns ``c0 + [0, s.shape[1])``."""
    col = c0 + torch.arange(s.shape[1], device=s.device)
    p = torch.exp(s - _guard(lse)[:, None])
    hit = (col[None, :] == y[:, None]).to(s.dtype)
    return (p - hit) * g[:, None]


def fused_ce_fwd_reference(h, w, y, block_n: int = DEFAULT_BLOCK_N,
                           block_v: int = DEFAULT_BLOCK_V):
    """Plain version of the forward kernel: an online logsumexp over vocab
    blocks of ``block_v``. ``h`` (N, D), ``w`` (D, V), ``y`` (N,) int.
    Returns (lse, target logit), both (N,) f32 (f64 for f64 inputs). Rows
    are independent, so ``block_n`` does not change the result."""
    n, v = h.shape[0], w.shape[1]
    acc_t = _acc_dtype(h)
    bv = _clamp_block(block_v, v)
    hf = h.to(acc_t)
    m = torch.full((n,), float("-inf"), dtype=acc_t, device=h.device)
    l = torch.zeros((n,), dtype=acc_t, device=h.device)
    tgt = torch.zeros((n,), dtype=acc_t, device=h.device)
    for c0 in range(0, v, bv):
        s = hf @ w[:, c0:c0 + bv].to(acc_t)  # (N, <= bv): the block cut at V
        col = c0 + torch.arange(s.shape[1], device=h.device)
        m_new = torch.maximum(m, s.amax(-1))
        shift = _guard(m_new)
        l = l * torch.exp(m - shift) + torch.exp(s - shift[:, None]).sum(-1)
        m = m_new
        tgt = tgt + torch.where(col[None, :] == y[:, None], s, torch.zeros_like(s)).sum(-1)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(m == float("-inf"), m, m + torch.log(safe_l))
    return lse, tgt


def fused_ce_dh_reference(h, w, y, lse, g, block_n: int = DEFAULT_BLOCK_N,
                          block_v: int = DEFAULT_BLOCK_V):
    """Plain version of the dh kernel: ``dh = sum over vocab blocks of
    dS (cast to W's type) . W^T``, in h's type."""
    v = w.shape[1]
    acc_t = _acc_dtype(h)
    bv = _clamp_block(block_v, v)
    hf = h.to(acc_t)
    lse_a, g_a = lse.to(acc_t), g.to(acc_t)
    acc = torch.zeros(h.shape, dtype=acc_t, device=h.device)
    for c0 in range(0, v, bv):
        wb = w[:, c0:c0 + bv].to(acc_t)
        ds = _dlogits(hf @ wb, y, lse_a, g_a, c0)
        acc = acc + ds.to(w.dtype).to(acc_t) @ wb.T
    return acc.to(h.dtype)


def fused_ce_dw_reference(h, w, y, lse, g, block_n: int = DEFAULT_BLOCK_N,
                          block_v: int = DEFAULT_BLOCK_V):
    """Plain version of the dW kernel: ``dW = sum over row blocks of h^T .
    dS (cast to h's type)``, in W's type. Columns are independent, so
    ``block_v`` does not change the result."""
    n = h.shape[0]
    acc_t = _acc_dtype(h)
    bn = _clamp_block(block_n, n)
    wf = w.to(acc_t)
    lse_a, g_a = lse.to(acc_t), g.to(acc_t)
    acc = torch.zeros(w.shape, dtype=acc_t, device=w.device)
    for r0 in range(0, n, bn):
        hb = h[r0:r0 + bn].to(acc_t)
        ds = _dlogits(hb @ wf, y[r0:r0 + bn], lse_a[r0:r0 + bn], g_a[r0:r0 + bn], 0)
        acc = acc + hb.T @ ds.to(h.dtype).to(acc_t)
    return acc.to(w.dtype)


def _route(h, w, y, *rows) -> bool:
    """True to launch a kernel (CUDA), False to run the plain version
    (CPU); raises on any other device or on operands it cannot take."""
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(
            f"fused cross entropy takes h (N, D) and W (D, V), got "
            f"{tuple(h.shape)} and {tuple(w.shape)}")
    if y.shape != (h.shape[0],):
        raise ValueError(f"targets {tuple(y.shape)} do not match h {tuple(h.shape)}")
    devices = {x.device for x in (h, w, y, *rows)}
    if len(devices) != 1:
        raise ValueError(f"fused cross entropy operands on different devices: {devices}")
    if h.device.type == "cpu":
        return False
    if h.device.type != "cuda":
        raise ValueError(f"fused cross entropy runs on cpu or cuda, got {h.device}")
    if h.dtype not in _DTYPE_CODES or w.dtype != h.dtype:
        raise TypeError(
            f"fused cross entropy kernels take h and W both bfloat16 or both "
            f"float32, got {h.dtype} and {w.dtype}")
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused cross entropy kernels take contiguous h and W")
    if y.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"targets must be int64 or int32, got {y.dtype}")
    for x in rows:
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("lse and the cotangent must be contiguous float32 (N,)")
    return True


def _splits(n: int, v: int, device: torch.device) -> tuple[int, int]:
    """(splits, 128-column tiles per split) of the vocab: enough 64-row x
    split blocks for two per SM, no split empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_rb, n_vt = -(-n // _TILE_ROWS), -(-v // _TILE_COLS)
    want = max(1, min(n_vt, -(-2 * sms // n_rb)))
    per = -(-n_vt // want)
    return -(-n_vt // per), per


# the sm90 kernels' work units (csrc/fused_loss_sm90.cu): the forward
# takes 128-column score tiles on 128-row blocks; dh keeps dS for kDhGroup
# x kBV vocab columns per 64-row block, dW for kDwGroup x 128 rows per
# 128-column block; both pass over D in 128 columns
_SM90_FWD_ROWS = 128
_SM90_DH_ROWS = _TILE_ROWS
_SM90_DH_GROUP = 8 * _TILE_COLS
_SM90_DW_GROUP = 4 * 128
_SM90_D_PASS = 128


def _sm90_route(dtype: torch.dtype, d: int, v: int, h_ptr: int, w_ptr: int) -> bool:
    """True when a CUDA call goes to the sm90 kernels: bf16, h and
    W based on 16-byte boundaries, rows of h and W (D, V elements) whole
    multiples of 16 bytes — what a TMA map of each takes. False sends it to
    ``fused_loss.cu``'s kernels."""
    return (dtype == torch.bfloat16 and h_ptr % 16 == 0 and w_ptr % 16 == 0
            and (2 * d) % 16 == 0 and (2 * v) % 16 == 0)


def _fwd_plan(n: int, d: int, v: int, sms: int) -> dict:
    """The sm90 forward's grid: 128-row blocks x vocab splits, a split a
    run of 128-column score tiles. One block per SM (192 KB of shared
    memory), so the splits are the SMs over the row tiles, rounded down (one
    wave where the rows allow it: 32 x 4 = 128 blocks at N 4096, V 32768 on
    132 SMs), at most one per tile."""
    n_rt = -(-n // _SM90_FWD_ROWS)
    n_vt = -(-v // _TILE_COLS)
    want = max(1, min(n_vt, sms // n_rt))
    per = -(-n_vt // want)
    splits = -(-n_vt // per)
    return {"row_tiles": n_rt, "splits": splits, "tiles_per_split": per,
            "tiles": n_vt, "d_chunks": -(-d // 64), "waves": n_rt * splits / sms}


def _fwd_blocks(n: int, v: int, plan: dict):
    """Each forward block's rows [r0, r1) and its split's score tiles'
    vocab columns [c0, c1), cut at N and V, in the order the kernel walks
    them."""
    for rt in range(plan["row_tiles"]):
        for split in range(plan["splits"]):
            t0 = split * plan["tiles_per_split"]
            t1 = min(plan["tiles"], t0 + plan["tiles_per_split"])
            yield ((rt * _SM90_FWD_ROWS, min(n, (rt + 1) * _SM90_FWD_ROWS)),
                   [(t * _TILE_COLS, min(v, (t + 1) * _TILE_COLS)) for t in range(t0, t1)])


def _dh_plan(n: int, d: int, v: int, sms: int) -> dict:
    """The sm90 dh kernel's grid: 64-row blocks x vocab splits, a split a
    run of 1024-column groups. One block per SM (224 KB of shared memory),
    so the splits are the SMs over the row tiles, rounded down (one wave
    where the rows allow it), at most one per group."""
    n_rt = -(-n // _SM90_DH_ROWS)
    n_groups = -(-v // _SM90_DH_GROUP)
    want = max(1, min(n_groups, sms // n_rt))
    per = -(-n_groups // want)
    splits = -(-n_groups // per)
    return {"row_tiles": n_rt, "splits": splits, "groups_per_split": per,
            "groups": n_groups, "d_passes": -(-d // _SM90_D_PASS),
            "waves": n_rt * splits / sms}


def _dh_blocks(n: int, v: int, plan: dict):
    """Each dh block's rows [r0, r1) and its groups' vocab columns [c0, c1),
    cut at N and V, in the order the kernel walks them."""
    for rt in range(plan["row_tiles"]):
        for split in range(plan["splits"]):
            g0 = split * plan["groups_per_split"]
            g1 = min(plan["groups"], g0 + plan["groups_per_split"])
            yield ((rt * _SM90_DH_ROWS, min(n, (rt + 1) * _SM90_DH_ROWS)),
                   [(g * _SM90_DH_GROUP, min(v, (g + 1) * _SM90_DH_GROUP))
                    for g in range(g0, g1)])


def _dw_plan(n: int, d: int, v: int, sms: int) -> dict:
    """The sm90 dW kernel's grid: one block per 128 vocab columns, each
    walking every 512-row group; ``columns`` and ``row_groups`` cut at V
    and N."""
    blocks = -(-v // _TILE_COLS)
    return {"columns": [(c, min(v, c + _TILE_COLS)) for c in range(0, v, _TILE_COLS)],
            "row_groups": [(r, min(n, r + _SM90_DW_GROUP))
                           for r in range(0, n, _SM90_DW_GROUP)],
            "d_passes": -(-d // _SM90_D_PASS), "waves": blocks / sms}


def _launch(name: str, fn_name: str, device, *args, lib_name: str = "fused_loss",
            route: str | None = None) -> None:
    lib = _build.library(lib_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_ce_{name} kernel launch failed ({fn_name}): CUDA error {rc}")
    fused_cross_entropy.launches[name] += 1
    if route is not None:
        fused_cross_entropy.routes[name][route] += 1


def fused_ce_fwd(h, w, y, block_n: int = DEFAULT_BLOCK_N,
                 block_v: int = DEFAULT_BLOCK_V, *, route: str | None = None):
    """(lse, target logit) per row, (N,) f32. A CPU tensor runs
    :func:`fused_ce_fwd_reference`; a CUDA tensor launches the sm90
    forward where :func:`_sm90_route` takes it, else ``fwd_kernel``, over
    the vocab splits, and combines their logsumexps; ``route``: see
    :func:`_use_sm90`."""
    if not _route(h, w, y):
        return fused_ce_fwd_reference(h, w, y, block_n, block_v)
    (n, d), v = h.shape, w.shape[1]
    y64 = y.long().contiguous()
    sm90 = _use_sm90(h, w, route)
    if sm90:
        sms = torch.cuda.get_device_properties(h.device).multi_processor_count
        plan = _fwd_plan(n, d, v, sms)
        nsplit, per = plan["splits"], plan["tiles_per_split"]
    else:
        nsplit, per = _splits(n, v, h.device)
    part_lse = torch.empty((nsplit, n), dtype=torch.float32, device=h.device)
    part_tgt = torch.empty((nsplit, n), dtype=torch.float32, device=h.device)
    ptrs = (h.data_ptr(), w.data_ptr(), y64.data_ptr(), part_lse.data_ptr(),
            part_tgt.data_ptr())
    if sm90:
        _launch("fwd", "fused_ce_fwd_sm90_launch", h.device, *ptrs, n, d, v, nsplit, per,
                lib_name="fused_loss_sm90", route="sm90")
    else:
        _launch("fwd", "fused_ce_fwd_launch", h.device, *ptrs, n, d, v, nsplit, per,
                _DTYPE_CODES[h.dtype], route="sm80")
    # one split's columns hold the target (the others add 0); the lse of
    # the splits' lse (exact for one split), with the -inf guard of an
    # all-masked row
    mx = part_lse.amax(0)
    shift = _guard(mx)
    lse = shift + torch.log(torch.exp(part_lse - shift).sum(0))
    return torch.where(mx == float("-inf"), mx, lse), part_tgt.sum(0)


def _use_sm90(h, w, route: str | None) -> bool:
    """Whether a CUDA call launches the sm90 kernel: by
    :func:`_sm90_route` when ``route`` is None; ``route="sm80"`` asks for
    ``fused_loss.cu``'s kernel whatever the shape (the card check times
    both on one input)."""
    if route not in (None, "sm80"):
        raise ValueError(f"route must be None or 'sm80', got {route!r}")
    d, v = w.shape
    return route is None and _sm90_route(h.dtype, d, v, h.data_ptr(), w.data_ptr())


def fused_ce_dh(h, w, y, lse, g, block_n: int = DEFAULT_BLOCK_N,
                block_v: int = DEFAULT_BLOCK_V, *, route: str | None = None):
    """dh (N, D) in h's type from the saved lse and the loss's cotangent
    ``g`` (both (N,) f32). A CPU tensor runs :func:`fused_ce_dh_reference`;
    a CUDA tensor launches the sm90 dh kernel where :func:`_sm90_route`
    takes it, else ``dh_kernel`` (vocab splits summed here); ``route``:
    see :func:`_use_sm90`."""
    if not _route(h, w, y, lse, g):
        return fused_ce_dh_reference(h, w, y, lse, g, block_n, block_v)
    (n, d), v = h.shape, w.shape[1]
    y64 = y.long().contiguous()
    sm90 = _use_sm90(h, w, route)
    if sm90:
        sms = torch.cuda.get_device_properties(h.device).multi_processor_count
        plan = _dh_plan(n, d, v, sms)
        part = torch.empty((plan["splits"], n, d), dtype=torch.float32, device=h.device)
        _launch("dh", "fused_ce_dh_sm90_launch", h.device, h.data_ptr(), w.data_ptr(),
                y64.data_ptr(), lse.data_ptr(), g.data_ptr(), part.data_ptr(),
                n, d, v, plan["splits"], plan["groups_per_split"],
                lib_name="fused_loss_sm90", route="sm90")
    else:
        nsplit, per = _splits(n, v, h.device)
        part = torch.empty((nsplit, n, d), dtype=torch.float32, device=h.device)
        _launch("dh", "fused_ce_dh_launch", h.device, h.data_ptr(), w.data_ptr(),
                y64.data_ptr(), lse.data_ptr(), g.data_ptr(), part.data_ptr(),
                n, d, v, nsplit, per, _DTYPE_CODES[h.dtype], route="sm80")
    return part.sum(0).to(h.dtype)


def fused_ce_dw(h, w, y, lse, g, block_n: int = DEFAULT_BLOCK_N,
                block_v: int = DEFAULT_BLOCK_V, *, route: str | None = None):
    """dW (D, V) in W's type from the saved lse and the cotangent. A CPU
    tensor runs :func:`fused_ce_dw_reference`; a CUDA tensor launches the
    sm90 dW kernel where :func:`_sm90_route` takes it, else ``dw_kernel``;
    ``route``: see :func:`_use_sm90`."""
    if not _route(h, w, y, lse, g):
        return fused_ce_dw_reference(h, w, y, lse, g, block_n, block_v)
    (n, d), v = h.shape, w.shape[1]
    sm90 = _use_sm90(h, w, route)
    # f32 accumulator between row groups (512 rows sm90, 256 otherwise):
    # one group needs none
    group = _SM90_DW_GROUP if sm90 else 4 * _TILE_ROWS
    part = torch.empty((d, v) if n > group else (0,), dtype=torch.float32, device=h.device)
    dw = torch.empty((d, v), dtype=w.dtype, device=w.device)
    y64 = y.long().contiguous()
    if sm90:
        _launch("dw", "fused_ce_dw_sm90_launch", h.device, h.data_ptr(), w.data_ptr(),
                y64.data_ptr(), lse.data_ptr(), g.data_ptr(), part.data_ptr(),
                dw.data_ptr(), n, d, v, lib_name="fused_loss_sm90", route="sm90")
    else:
        _launch("dw", "fused_ce_dw_launch", h.device, h.data_ptr(), w.data_ptr(),
                y64.data_ptr(), lse.data_ptr(), g.data_ptr(),
                part.data_ptr(), dw.data_ptr(), n, d, v, _DTYPE_CODES[h.dtype],
                route="sm80")
    return dw


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, w, y, block_n, block_v):
        lse, tgt = fused_ce_fwd(h2, w, y, block_n, block_v)
        ctx.save_for_backward(h2, w, y, lse)
        ctx.blocks = (block_n, block_v)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        h2, w, y, lse = ctx.saved_tensors
        g = g.to(lse.dtype).contiguous()
        dh = fused_ce_dh(h2, w, y, lse, g, *ctx.blocks)
        dw = fused_ce_dw(h2, w, y, lse, g, *ctx.blocks)
        return dh, dw, None, None, None


def fused_cross_entropy(hidden, lm_head, targets, *, block_n: int = DEFAULT_BLOCK_N,
                        block_v: int = DEFAULT_BLOCK_V):
    """Per-token softmax cross entropy of ``hidden @ lm_head`` against
    integer ``targets``, logits-free; differentiable in ``hidden`` and
    ``lm_head``. ``hidden`` (..., D), ``lm_head`` (D, V) (the JAX kernel
    layout), ``targets`` (...) int with ``hidden``'s leading shape. Returns
    f32 (f64 for f64 inputs) losses of ``targets.shape``: the contract of
    ``optax.softmax_cross_entropy_with_integer_labels(hidden @ lm_head,
    targets)``."""
    d = hidden.shape[-1]
    if tuple(hidden.shape[:-1]) != tuple(targets.shape):
        raise ValueError(
            f"hidden {tuple(hidden.shape)} / targets {tuple(targets.shape)} "
            "mismatch: hidden must be targets.shape + (d_model,)")
    loss = _FusedCE.apply(hidden.reshape(-1, d), lm_head, targets.reshape(-1),
                          block_n, block_v)
    return loss.reshape(targets.shape)


# kernel launches on the card by kernel (CPU calls add none)
fused_cross_entropy.launches = {"fwd": 0, "dh": 0, "dw": 0}
# launches by route: "sm90" (fused_loss_sm90.cu) or "sm80" (fused_loss.cu's
# mma.sync kernels)
fused_cross_entropy.routes = {k: {"sm90": 0, "sm80": 0} for k in ("fwd", "dh", "dw")}


def fused_cross_entropy_reference(hidden, lm_head, targets):
    """The materialized-logits statement of the same function (tests, and
    the library yardstick's arithmetic): the lm_head product with f32
    accumulation, then the standard logsumexp cross entropy."""
    acc_t = _acc_dtype(hidden)
    logits = hidden.to(acc_t) @ lm_head.to(acc_t)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - tgt
