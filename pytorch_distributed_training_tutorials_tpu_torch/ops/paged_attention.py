"""Paged decode attention: walk the page table, never gather the window.

Port of ``pytorch_distributed_training_tutorials_tpu/ops/paged_attention.py``
(vLLM's PagedAttention, SOSP '23, fused the FlashAttention way). The K/V of
every request live in one shared ``(n_pages, page_size, kv_heads, D)``
pool per layer; a per-row page table maps logical page ``p`` of row ``b``
to pool page ``table[b, p]``. :func:`paged_attention` reads the pool
through the table one ``(page_size, D)`` tile at a time and folds each tile
into an online softmax, so no dense ``(B, W, ...)`` window exists.

- On a CUDA tensor it launches a hand-written Hopper kernel (a port of the
  TPU kernel ``kernel`` of the JAX ``paged_attention``) and adds one to
  ``paged_attention.launches``; it raises on operands the kernels do not
  take and when the launch fails, and never falls back. Two routes, chosen
  by :func:`_sm90_route` before the launch: pools whose stored rows are
  whole 16-byte pieces, 16-byte aligned, run ``csrc/paged_attention_sm90.cu``
  (the pages split across blocks, TMA tile loads into an mbarrier ring, a
  last-block merge in split order; :func:`_sm90_plan`); every other call
  runs ``csrc/paged_attention.cu`` (one block per row and KV head, v1).
  ``paged_attention.routes`` counts the launches of each route, and
  ``route="v1"`` asks for the old kernel by name. Either kernel holds a
  (KV head)'s S x group query rows in shared memory, so a call whose S
  rows need more launches in row blocks of as many query rows as fit
  (:func:`_rows_per_launch`), block j's first row at ``pos + s_j``: a
  suffix prefill over a prefix (S up to a bucket) runs on the kernel too.
- On a CPU tensor it runs :func:`paged_attention_plain`, the plain PyTorch
  version of the kernel's arithmetic: a loop over logical pages with a
  vectorised update per page, f32 scores times ``1/sqrt(D)``, validity
  ``t <= pos + r // grp``, the shift guard, the probabilities cast to the V
  tile's type before the PV product, and ``acc / (l == 0 ? 1 : l)``, so a
  parked row (its table all sentinel) gives exact zeros. With
  ``pages_per_split`` it states the sm90 kernel's split and merge.
- :func:`paged_attention_reference` is the gather oracle: whole pages
  gathered dense (sentinel pages read as zeros), dequantized, and the
  grouped masked attention of the model, in float32.

Quantized pools dequantize inside the kernel per page tile: int8 codes
times f32 scales, or packed int4 nibbles (:func:`..ops.quant.unpack_int4`'s
half-split layout) times bf16 scales, each cast to ``q``'s type. Exact
pools (f32, bf16) are read as stored. The sentinel page id is ``n_pages``
(out of range); the kernel skips every page at or beyond it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import _build
from pytorch_distributed_training_tutorials_tpu_torch.ops._check import (
    KERNEL_TOLERANCE,
    kernel_error,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import (
    dequantize_kv_int4,
)

__all__ = [
    "KERNEL_TOLERANCE",
    "kernel_error",
    "paged_attention",
    "paged_attention_plain",
    "paged_attention_reference",
    "tolerance_type",
]

_QUANT_MODES = (None, "int8", "int4")
# the kernel's type codes: q (and the output), and the pools' storage
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STORE_CODES = {torch.float32: 0, torch.bfloat16: 1, "int8": 2, "int4": 3}
# pool and scale types of each quantized storage
_QUANT_TYPES = {"int8": (torch.int8, torch.float32), "int4": (torch.uint8, torch.bfloat16)}
_MAX_SHARED = 232448  # bytes of shared memory one H100 block may use


def _check(q, k_pool, v_pool, table, pos, k_scale, v_scale, quant) -> int:
    """The JAX function's argument checks (and the shapes it implies);
    returns the GQA group size."""
    if quant not in _QUANT_MODES:
        raise ValueError(f"quant must be one of {_QUANT_MODES}, got {quant!r}")
    if (quant is not None) != (k_scale is not None and v_scale is not None):
        raise ValueError("k_scale/v_scale are required exactly when quant is set")
    if q.ndim != 4 or k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged attention takes q (B, S, H, D) and two equal pools (N, "
            f"page_size, KV, D_store); got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}"
        )
    b, s, h, d = q.shape
    n_pages, page_size, kv = k_pool.shape[:3]
    if h % kv:
        raise ValueError(f"n_heads {h} must be a multiple of kv_heads {kv}")
    d_store = d // 2 if quant == "int4" else d
    if k_pool.shape[3] != d_store:
        raise ValueError(
            f"pool head_dim {k_pool.shape[3]} != expected {d_store} "
            f"(quant={quant!r}, q head_dim {d})"
        )
    if table.ndim != 2 or table.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(
            f"table must be (B, P) and pos (B,) for B={b}; got "
            f"{tuple(table.shape)} and {tuple(pos.shape)}"
        )
    if quant and not (tuple(k_scale.shape) == tuple(v_scale.shape)
                      == (n_pages, page_size, kv)):
        raise ValueError(
            f"scales must be (N, page_size, KV) = {(n_pages, page_size, kv)}; "
            f"got {tuple(k_scale.shape)} and {tuple(v_scale.shape)}"
        )
    return h // kv


def tolerance_type(q, v_pool, quant) -> torch.dtype:
    """The type whose :data:`KERNEL_TOLERANCE` holds the kernel to its
    plain version: bfloat16 where the probabilities round to bf16 before
    the PV product (a bf16 V tile: a bf16 pool, or bf16 q over a quantized
    one) — both sides round p from f32 values that differ in the last bits
    — else q's type."""
    v_type = q.dtype if quant else v_pool.dtype
    return torch.bfloat16 if v_type == torch.bfloat16 else q.dtype


def _dequant_tile(pool, scale, ids, quant, dtype) -> torch.Tensor:
    """Pool pages ``ids`` (B,) as the kernel's (B, KV, page_size, D) f32
    tile: quantized storage dequantized to ``dtype`` first."""
    t = pool[ids]
    if quant == "int8":
        t = (t.float() * scale[ids].float()[..., None]).to(dtype)
    elif quant == "int4":
        t = dequantize_kv_int4(t, scale[ids], dtype)
    return t.float().permute(0, 2, 1, 3)


def paged_attention_plain(q, k_pool, v_pool, table, pos, *, k_scale=None,
                          v_scale=None, quant=None, pages_per_split=None) -> torch.Tensor:
    """Plain PyTorch statement of the kernel's arithmetic, on any device:
    the (m, l, acc) recurrence over logical pages, vectorised over rows
    and heads within a page (module docstring). Returns (B, S, H, D) in
    ``q``'s type.

    ``pages_per_split`` (default None: one recurrence over every page)
    states the sm90 kernel's order: the logical pages cut into splits of
    that many, a fresh recurrence per split giving a record (m_j, l_j,
    acc_j), then the records merged in split order: M = max_j m_j, w_j =
    exp(m_j - M) (the shift 0 where M is -inf), L = sum_j l_j w_j, A =
    sum_j acc_j w_j, out = A / (L == 0 ? 1 : L)."""
    grp = _check(q, k_pool, v_pool, table, pos, k_scale, v_scale, quant)
    b, s, h, d = q.shape
    kv = k_pool.shape[2]
    sg = s * grp
    # row r = s_row * grp + g of kv head c is query s_row of head c * grp + g
    qg = q.float().reshape(b, s, kv, grp, d).permute(0, 2, 1, 3, 4).reshape(b, kv, sg, d)
    n_p = table.shape[1]
    if pages_per_split is None:
        m, l, acc = _recurrence(qg, k_pool, v_pool, table, pos, k_scale, v_scale, quant,
                                q.dtype, grp, 0, n_p)
        out = acc / torch.where(l == 0.0, 1.0, l)
    else:
        if pages_per_split < 1:
            raise ValueError(f"pages_per_split must be >= 1, got {pages_per_split}")
        recs = [_recurrence(qg, k_pool, v_pool, table, pos, k_scale, v_scale, quant,
                            q.dtype, grp, lo, min(lo + pages_per_split, n_p))
                for lo in range(0, max(n_p, 1), pages_per_split)]
        m_all = torch.stack([r[0] for r in recs])
        top = m_all.amax(dim=0)
        shift = torch.where(top == -math.inf, 0.0, top)
        l = torch.zeros_like(recs[0][1])
        a = torch.zeros_like(recs[0][2])
        for m_j, l_j, acc_j in recs:
            w = torch.where(m_j == -math.inf, 0.0, torch.exp(m_j - shift))
            l = l + l_j * w
            a = a + acc_j * w
        out = a / torch.where(l == 0.0, 1.0, l)
    out = out.reshape(b, kv, s, grp, d).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, h, d).to(q.dtype)


def _recurrence(qg, k_pool, v_pool, table, pos, k_scale, v_scale, quant, q_dtype,
                grp, p_lo, p_hi):
    """The (m, l, acc) recurrence of :func:`paged_attention_plain` over
    logical pages [p_lo, p_hi), from m = -inf, l = 0, acc = 0; qg is the
    (B, KV, S * grp, D) f32 query."""
    b, kv, sg, d = qg.shape
    n_pages, page_size = k_pool.shape[:2]
    s = sg // grp
    # compute types follow the kernel: quantized pools dequantize to q's
    # type; the probabilities round to the V tile's type before PV
    k_dtype = q_dtype if quant else k_pool.dtype
    v_dtype = q_dtype if quant else v_pool.dtype
    sm_scale = 1.0 / d ** 0.5
    dev = qg.device
    acc = torch.zeros((b, kv, sg, d), dtype=torch.float32, device=dev)
    m = torch.full((b, kv, sg, 1), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, sg, 1), dtype=torch.float32, device=dev)
    depth = pos.to(torch.int64)
    srow = torch.arange(sg, device=dev) // grp
    offs = torch.arange(page_size, device=dev)
    for p in range(p_lo, p_hi):
        pid = table[:, p].to(torch.int64)
        live = (pid < n_pages) & (pid >= 0) & (p * page_size <= depth + (s - 1))
        ids = pid.clamp(0, n_pages - 1)
        kb = _dequant_tile(k_pool, k_scale, ids, quant, k_dtype)
        vb = _dequant_tile(v_pool, v_scale, ids, quant, v_dtype)
        scores = torch.einsum("bcrd,bctd->bcrt", qg, kb) * sm_scale
        valid = (p * page_size + offs) <= (depth[:, None, None] + srow[None, :, None])
        scores = torch.where(valid[:, None], scores, -math.inf)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        shift = torch.where(m_new == -math.inf, 0.0, m_new)
        pexp = torch.exp(scores - shift)
        corr = torch.exp(m - shift)
        l_new = l * corr + pexp.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bcrt,bctd->bcrd", pexp.to(v_dtype).float(), vb)
        upd = live[:, None, None, None]
        acc = torch.where(upd, acc * corr + pv, acc)
        l = torch.where(upd, l_new, l)
        m = torch.where(upd, m_new, m)
    return m, l, acc


def paged_attention_reference(q, k_pool, v_pool, table, pos, *, k_scale=None,
                              v_scale=None, quant=None) -> torch.Tensor:
    """The gather oracle, the JAX ``paged_attention_reference`` in float32:
    gather whole pages dense (sentinel pages read as zeros), dequantize,
    then grouped masked attention with validity ``t <= pos + s``."""
    grp = _check(q, k_pool, v_pool, table, pos, k_scale, v_scale, quant)
    b, s, h, d = q.shape
    n_pages, page_size, kv = k_pool.shape[:3]
    w = table.shape[1] * page_size
    ids = table.to(torch.int64)
    fill = (ids < 0) | (ids >= n_pages)

    def gather(pool):
        out = pool[ids.clamp(0, n_pages - 1)]
        mask = fill.reshape(fill.shape + (1,) * (out.ndim - 2))
        out = torch.where(mask, torch.zeros((), dtype=out.dtype, device=out.device), out)
        return out.reshape((b, w) + tuple(pool.shape[2:]))

    if quant == "int8":
        k = (gather(k_pool).float() * gather(k_scale)[..., None]).to(q.dtype)
        v = (gather(v_pool).float() * gather(v_scale)[..., None]).to(q.dtype)
    elif quant == "int4":
        k = dequantize_kv_int4(gather(k_pool), gather(k_scale), q.dtype)
        v = dequantize_kv_int4(gather(v_pool), gather(v_scale), q.dtype)
    else:
        k, v = gather(k_pool), gather(v_pool)
    qpos = pos.to(torch.int64)[:, None] + torch.arange(s, device=q.device)
    valid = torch.arange(w, device=q.device) <= qpos[..., None]  # (B, S, W)
    q5 = q.float().reshape(b, s, kv, grp, d)
    scores = torch.einsum("bqcgd,blcd->bcgql", q5, k.float()) / math.sqrt(d)
    scores = torch.where(valid[:, None, None], scores, -1e30)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bcgql,blcd->bqcgd", weights.float(), v.float())
    return out.to(q.dtype).reshape(b, s, h, d)


def _shared_bytes(sg: int, page_size: int, d: int) -> int:
    """The kernel's dynamic shared memory: q and acc (sg x D), the K tile
    (page_size x (D + 1)), the V tile (page_size x D), the scores (sg x
    page_size) and m, l, corr per row, all f32."""
    return 4 * (2 * sg * d + page_size * (2 * d + 1) + sg * page_size + 3 * sg)


def _sm90_plan(b: int, kv: int, p: int) -> tuple[int, int, int]:
    """(pages per split, splits, ring stages) of the sm90 kernel for a (B,
    P) table and KV heads: from the table's width alone, never from pos
    (the grid stays fixed and no host sync is needed). One page a split up
    to 2048 (row, head, page) triples — the paged stream's (4, 4, 64) gives
    1024 blocks, its 34 live pages x 4 heads 136 working ones on 132 SMs
    — more pages a split beyond, so the grid stays near 2048 blocks."""
    pps = max(1, -(-b * kv * p // 2048))
    return pps, max(1, -(-p // pps)), min(2, pps)


def _row_bytes(quant, pool, d: int) -> int:
    """Bytes of one stored (token, head) row of a pool."""
    return d // 2 if quant == "int4" else d * pool.element_size()


def _sm90_shared_bytes(sg: int, page_size: int, d: int, row_bytes: int, stages: int,
                       splits: int) -> int:
    """The sm90 kernel's dynamic shared memory (its ``Layout``): per stage
    the K and V tiles (each rounded up to 128 bytes) and their f32 scales;
    64 bytes of mbarriers (3 a stage) and a flag; q, the scores, four warps' partial
    accumulators, m, l, the correction and L per row; the merge's weights
    and products per row and split; 128 bytes of alignment."""
    tile = -(-page_size * row_bytes // 128) * 128
    stage = -(-(2 * tile + 8 * page_size) // 128) * 128
    return 128 + stages * stage + 64 + 4 * sg * (5 * d + page_size + 4 + 2 * splits)


def _rows_per_launch(sm90: bool, q, k_pool, quant, grp: int, p: int) -> int:
    """The most query rows (each ``grp`` kernel rows) one launch of the
    route takes within the card's shared memory: q's S when they all fit,
    0 when not even one does. Both routes' bytes grow linearly in the
    rows."""
    b, s, h, d = q.shape
    page_size = k_pool.shape[1]
    if sm90:
        row = _row_bytes(quant, k_pool, d)
        pps, splits, stages = _sm90_plan(b, k_pool.shape[2], p)

        def smem(n):
            return _sm90_shared_bytes(n * grp, page_size, d, row, stages, splits)
    else:
        def smem(n):
            return _shared_bytes(n * grp, page_size, d)
    return max(0, min(s, (_MAX_SHARED - smem(0)) // (smem(1) - smem(0))))


def _sm90_route(q, k_pool, v_pool, quant, grp: int, p: int) -> bool:
    """True when a CUDA call goes to the sm90 kernel: every stored K/V row a
    whole number of 16-byte pieces (D % 4 for f32, D % 8 for bf16, D % 16
    for int8, D % 32 for int4), both pools 16-byte aligned, pages of at
    most 256 positions (what a TMA box of one (page, head) tile takes), and
    the kernel's shared memory within the card's for one query row (more
    rows launch in row blocks, :func:`_rows_per_launch`). False sends it
    to ``csrc/paged_attention.cu``."""
    d = q.shape[3]
    page_size = k_pool.shape[1]
    row = _row_bytes(quant, k_pool, d)
    return (row % 16 == 0 and d % 4 == 0 and page_size <= 256
            and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0
            and _rows_per_launch(True, q[:, :1], k_pool, quant, grp, p) == 1)


def _route(q, k_pool, v_pool, table, pos, k_scale, v_scale, quant, grp) -> bool:
    """True to launch a kernel (CUDA), False to run the plain version
    (CPU); raises on any other device or on operands no kernel takes."""
    tensors = [q, k_pool, v_pool, table, pos] + ([k_scale, v_scale] if quant else [])
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"paged attention operands on different devices: {devices}")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cpu or cuda, got {q.device}")
    b, s, h, d = q.shape
    if q.dtype not in _Q_CODES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16 q, got {q.dtype}")
    if d % 2 or not 2 <= d <= 128:
        raise ValueError(f"paged attention kernel takes an even head dim up to 128, got {d}")
    if quant:
        pool_t, scale_t = _QUANT_TYPES[quant]
        if k_pool.dtype != pool_t or v_pool.dtype != pool_t:
            raise TypeError(f"{quant} pools must be {pool_t}, got {k_pool.dtype}/{v_pool.dtype}")
        if k_scale.dtype != scale_t or v_scale.dtype != scale_t:
            raise TypeError(f"{quant} scales must be {scale_t}, got {k_scale.dtype}/{v_scale.dtype}")
    elif k_pool.dtype not in _Q_CODES or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            "exact pools must both be float32 or both bfloat16, got "
            f"{k_pool.dtype}/{v_pool.dtype}"
        )
    if table.dtype != torch.int32:
        raise TypeError(f"paged attention kernel takes an int32 table, got {table.dtype}")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"paged attention kernel takes int32 or int64 pos, got {pos.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged attention kernel takes contiguous operands")
    if max(x.numel() for x in tensors) >= 2**31:
        raise ValueError("paged attention kernel indexes pages with 32-bit ids")
    return True


def _check_v1_shared(q, k_pool, grp) -> None:
    """Raise when the v1 kernel's shared memory for ONE query row (its
    ``grp`` kernel rows) exceeds the card's."""
    d = q.shape[3]
    smem = _shared_bytes(grp, k_pool.shape[1], d)
    if smem > _MAX_SHARED:
        raise ValueError(
            f"paged attention kernel needs {smem} bytes of shared memory for "
            f"one query row of {grp} heads a KV head and pages of "
            f"{k_pool.shape[1]} at D={d} (> {_MAX_SHARED})"
        )


def _launch(sm90: bool, q, k_pool, v_pool, table, pos, k_scale, v_scale, quant, grp,
            out) -> None:
    """One launch on the current stream: ``paged_attention_sm90_launch``
    when ``sm90``, else ``paged_attention_launch`` (v1); counted in
    ``paged_attention.launches`` and ``.routes``."""
    b, s, h, d = q.shape
    n_pages, page_size, kv = k_pool.shape[:3]
    p = table.shape[1]
    null = ctypes.c_void_p(0)
    scales = (k_scale.data_ptr() if quant else null, v_scale.data_ptr() if quant else null)
    common = (b, s, h, kv, d, page_size, p, n_pages, _Q_CODES[q.dtype],
              _STORE_CODES[quant or k_pool.dtype], int(pos.dtype == torch.int64),
              ctypes.c_float(1.0 / d ** 0.5))
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
        if sm90:
            pps, splits, stages = _sm90_plan(b, kv, p)
            rec_ml = torch.empty((b, kv, splits, s * grp, 2), dtype=torch.float32,
                                 device=q.device)
            rec_acc = torch.empty((b, kv, splits, s * grp, d), dtype=torch.float32,
                                  device=q.device)
            tickets = _build.tickets(q.device, b * kv, "paged_attention")
            rc = _build.library("paged_attention_sm90").paged_attention_sm90_launch(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
                table.data_ptr(), pos.data_ptr(), out.data_ptr(), rec_ml.data_ptr(),
                rec_acc.data_ptr(), tickets.data_ptr(), *common, pps, splits, stages, stream,
            )
        else:
            rc = _build.library("paged_attention").paged_attention_launch(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
                table.data_ptr(), pos.data_ptr(), out.data_ptr(), *common,
                _shared_bytes(s * grp, page_size, d), stream,
            )
    route = "sm90" if sm90 else "v1"
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed ({route}): CUDA error {rc}")
    paged_attention.launches += 1
    paged_attention.routes[route] += 1


def paged_attention(q, k_pool, v_pool, table, pos, *, k_scale=None,
                    v_scale=None, quant=None, route: str | None = None) -> torch.Tensor:
    """Paged decode attention straight off the page pools.

    ``q``: (B, S, H, D) queries (rope applied; S >= 1, query row s sits at
    position ``pos + s``). ``k_pool``/``v_pool``: (N, page_size, KV, D)
    shared pools — (.., D // 2) packed uint8 when ``quant == "int4"``.
    ``table``: (B, P) page ids, the sentinel ``N`` past each row's pages.
    ``pos``: (B,) per-row cache depth. ``k_scale``/``v_scale``: (N,
    page_size, KV) scales, required exactly when ``quant`` is "int8" (f32)
    or "int4" (bf16). Returns (B, S, H, D) in ``q``'s type.

    A CPU ``q`` runs :func:`paged_attention_plain`. A CUDA ``q`` launches
    a kernel (built at first use) on the current stream, reading ``table``
    and ``pos`` on the card (no host sync): ``csrc/paged_attention_sm90.cu``
    where :func:`_sm90_route` takes the operands, else
    ``csrc/paged_attention.cu``; ``route="v1"`` asks for the latter
    whatever the operands. Query rows past what one launch's shared memory
    holds launch in row blocks (:func:`_rows_per_launch`), block j with
    ``pos + s_j``; each launch adds one to ``paged_attention.launches``."""
    grp = _check(q, k_pool, v_pool, table, pos, k_scale, v_scale, quant)
    if route not in (None, "v1"):
        raise ValueError(f"route must be None or 'v1', got {route!r}")
    if not _route(q, k_pool, v_pool, table, pos, k_scale, v_scale, quant, grp):
        return paged_attention_plain(q, k_pool, v_pool, table, pos,
                                     k_scale=k_scale, v_scale=v_scale, quant=quant)
    sm90 = route is None and _sm90_route(q, k_pool, v_pool, quant, grp, table.shape[1])
    if not sm90:
        _check_v1_shared(q, k_pool, grp)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    s = q.shape[1]
    rows = _rows_per_launch(sm90, q, k_pool, quant, grp, table.shape[1])
    if rows == s:
        _launch(sm90, q, k_pool, v_pool, table, pos, k_scale, v_scale, quant, grp, out)
        return out
    for s0 in range(0, s, rows):
        qb = q[:, s0:s0 + rows].contiguous()
        ob = torch.empty_like(qb)
        _launch(sm90, qb, k_pool, v_pool, table, pos + s0, k_scale, v_scale, quant, grp, ob)
        out[:, s0:s0 + rows] = ob
    return out


paged_attention.launches = 0  # kernel launches (CPU calls add none)
# of those, by route: "sm90" (paged_attention_sm90.cu) or "v1" (paged_attention.cu)
paged_attention.routes = {"sm90": 0, "v1": 0}
