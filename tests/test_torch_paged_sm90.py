"""Paged attention's routes: the sm90 kernel
(``csrc/paged_attention_sm90.cu``: the pages split across blocks, TMA tile
loads into an mbarrier ring, the last block of each (row, KV head) merging
the splits' records in split order) and ``csrc/paged_attention.cu`` (v1).

On the CPU these tests cover what surrounds the kernels: ``_sm90_route``'s
choice on the 1b-gqa main shape and on each case it refuses (a stored row
that is not whole 16-byte pieces, a misaligned pool, pages past a TMA box,
one query row needing more shared memory than the card has), with the
launch recorded and not run; the row blocks of a call whose S rows need
more than one launch; that ``route="v1"`` reaches the old library; that CPU calls count no
launch; the split plan (``_sm90_plan``: from the table's width only); and
the plain statement of the kernel's split and merge
(``paged_attention_plain(..., pages_per_split=n)``) for several n, with
sentinel tails, a parked row and an S 4 chunk, held against the JAX
package's ``paged_attention`` in interpret mode and against the unsplit
plain version, at the tolerances of ``tests/test_torch_paged_attention.py``
(f32 2e-5 + 1e-5 relative: the same sums in another order; bf16 3e-2 +
1e-2: both round p and the output to bf16).

The ``requires_cuda`` tests hold the sm90 kernel to its plain version on
the card at the case shapes of ``tests/test_torch_cuda.py``'s paged tests
(and the paged stream's), under ``KERNEL_TOLERANCE`` for
``tolerance_type``, parked rows exactly 0, two calls bitwise equal, the
routes counted, and the v1 route for what the sm90 kernel refuses. Whether
a card is present is decided inside each test. Only the JAX parity tests
import jax, inside the test; on a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m requires_cuda \\
        tests/test_torch_paged_sm90.py
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import _build
from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as pa


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _operands(b, s, h, kv, d, ps, p_cap, store, q_dtype=torch.float32, pool_off=0):
    """Zero operands of one shape (nothing is computed from them): a pool
    of p_cap pages a row, stored as ``store``; ``pool_off`` elements into
    a fresh buffer."""
    n_pages = b * p_cap
    q = torch.zeros((b, s, h, d), dtype=q_dtype)
    kw = {}
    if store == "int8":
        dt, d_store = torch.int8, d
        kw = dict(k_scale=torch.ones((n_pages, ps, kv)), v_scale=torch.ones((n_pages, ps, kv)),
                  quant="int8")
    elif store == "int4":
        dt, d_store = torch.uint8, d // 2
        kw = dict(k_scale=torch.ones((n_pages, ps, kv), dtype=torch.bfloat16),
                  v_scale=torch.ones((n_pages, ps, kv), dtype=torch.bfloat16), quant="int4")
    else:
        dt, d_store = store, d
    shape = (n_pages, ps, kv, d_store)
    numel = n_pages * ps * kv * d_store
    k, v = (torch.zeros(numel + pool_off, dtype=dt)[pool_off:].view(shape) for _ in range(2))
    table = torch.arange(n_pages, dtype=torch.int32).view(b, p_cap)
    pos = torch.full((b,), p_cap * ps - s, dtype=torch.int64)
    return q, k, v, table, pos, kw


@pytest.fixture
def recorded(monkeypatch):
    """``paged_attention`` with CPU tensors taken as if on the card: each
    launch is recorded as its route and not run."""
    calls = []
    monkeypatch.setattr(pa, "_route", lambda *args: True)
    monkeypatch.setattr(pa, "_launch", lambda sm90, *args: calls.append("sm90" if sm90 else "v1"))
    return calls


ROUTE_CASES = {
    # name: (b, s, h, kv, d, ps, p_cap, store, q dtype, pool offset, route)
    "1b-gqa f32": (4, 1, 16, 4, 128, 64, 64, torch.float32, torch.float32, 0, "sm90"),
    "1b-gqa bf16 q": (4, 1, 16, 4, 128, 64, 64, "int8", torch.bfloat16, 0, "sm90"),
    "1b bf16 pool": (4, 1, 16, 16, 128, 64, 8, torch.bfloat16, torch.float32, 0, "sm90"),
    "int8": (4, 1, 16, 4, 128, 64, 8, "int8", torch.float32, 0, "sm90"),
    "int4": (4, 1, 16, 4, 128, 64, 8, "int4", torch.float32, 0, "sm90"),
    "S 4 chunk": (2, 4, 16, 4, 128, 64, 4, "int4", torch.float32, 0, "sm90"),
    "bf16 D 32 pages of 8": (3, 2, 8, 2, 32, 8, 4, torch.bfloat16, torch.bfloat16, 0, "sm90"),
    "int8 D 32": (3, 3, 8, 2, 32, 16, 3, "int8", torch.bfloat16, 0, "sm90"),
    # refused: a stored row not a whole number of 16-byte pieces
    "int4 D 18": (2, 1, 4, 4, 18, 8, 3, "int4", torch.float32, 0, "v1"),
    "int4 D 16": (2, 1, 4, 4, 16, 8, 3, "int4", torch.float32, 0, "v1"),
    "int8 D 24": (2, 1, 4, 4, 24, 8, 3, "int8", torch.float32, 0, "v1"),
    "bf16 D 36": (2, 1, 4, 4, 36, 8, 3, torch.bfloat16, torch.float32, 0, "v1"),
    "f32 D 18": (2, 1, 4, 4, 18, 8, 3, torch.float32, torch.float32, 0, "v1"),
    # refused: the pools' base 8 bytes past an aligned one
    "misaligned pool": (4, 1, 16, 4, 128, 64, 8, torch.float32, torch.float32, 2, "v1"),
    # refused: pages longer than a TMA box (256 positions)
    "pages of 512": (1, 1, 4, 4, 16, 512, 2, torch.float32, torch.float32, 0, "v1"),
    # 64 kernel rows a KV head need more shared memory than a block has:
    # row blocks of 14 query rows (56 kernel rows), two launches
    "S 64 x grp 4": (1, 16, 16, 4, 128, 64, 4, torch.float32, torch.float32, 0, "sm90"),
}
# launches of a case that its shared memory splits into row blocks
ROUTE_LAUNCHES = {"S 64 x grp 4": 2}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route(recorded, case):
    b, s, h, kv, d, ps, p_cap, store, q_dtype, off, want = ROUTE_CASES[case]
    q, k, v, table, pos, kw = _operands(b, s, h, kv, d, ps, p_cap, store, q_dtype, off)
    grp = h // kv
    assert pa._sm90_route(q, k, v, kw.get("quant"), grp, p_cap) is (want == "sm90")
    out = pa.paged_attention(q, k, v, table, pos, **kw)
    assert recorded == [want] * ROUTE_LAUNCHES.get(case, 1)
    assert out.shape == q.shape and out.dtype == q.dtype


def test_route_v1_by_name(recorded):
    args = _operands(4, 1, 16, 4, 128, 64, 64, torch.float32)
    q, k, v, table, pos, kw = args
    pa.paged_attention(q, k, v, table, pos, route="v1")
    pa.paged_attention(q, k, v, table, pos)
    assert recorded == ["v1", "sm90"]
    with pytest.raises(ValueError, match="route must be"):
        pa.paged_attention(q, k, v, table, pos, route="sm80")


def test_v1_route_still_checks_its_shared_memory(recorded):
    """What neither kernel takes raises before any launch: 512 query heads
    on one KV head, whose single query row (512 kernel rows) fits neither
    kernel's shared memory."""
    q, k, v, table, pos, kw = _operands(1, 1, 512, 1, 128, 64, 2, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        pa.paged_attention(q, k, v, table, pos)
    assert recorded == []


@pytest.mark.parametrize("sm90", [True, False], ids=["sm90", "v1"])
def test_row_blocks_offset_pos_and_fill_the_output(monkeypatch, sm90):
    """A call of more query rows than one launch takes (a suffix prefill,
    S 256 at the 1b-gqa width) launches row blocks of at most
    ``_rows_per_launch`` rows, block j's queries at ``pos + s_j``; with each
    launch standing in as the plain version, the pieces put together equal
    one plain call over all S rows, exactly."""
    q, k, v, table, pos, kw = _operands(1, 256, 16, 4, 128, 64, 64, torch.float32)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(q.shape, generator=gen)
    k, v = (torch.randn(k.shape, generator=gen) for _ in range(2))
    pos = torch.tensor([96])
    launches = []

    def launch(route_sm90, qb, k_pool, v_pool, tbl, pb, ks, vs, quant, grp, out):
        launches.append((route_sm90, qb.shape[1], int(pb[0])))
        out.copy_(pa.paged_attention_plain(qb, k_pool, v_pool, tbl, pb))

    monkeypatch.setattr(pa, "_route", lambda *args: True)
    monkeypatch.setattr(pa, "_launch", launch)
    got = pa.paged_attention(q, k, v, table, pos, route=None if sm90 else "v1")
    rows = 12 if sm90 else 32
    assert pa._rows_per_launch(sm90, q, k, None, 4, table.shape[1]) == rows
    assert launches == [(sm90, min(rows, 256 - s0), 96 + s0) for s0 in range(0, 256, rows)]
    assert torch.equal(got, pa.paged_attention_plain(q, k, v, table, pos))


@pytest.mark.parametrize("sm90,lib,entry", [
    (True, "paged_attention_sm90", "paged_attention_sm90_launch"),
    (False, "paged_attention", "paged_attention_launch"),
])
def test_each_route_reaches_its_library(monkeypatch, sm90, lib, entry):
    """``_launch`` asks ``_build`` for the route's library and calls its
    entry point, registered under that library; the CUDA device and stream
    and the counters are stubbed."""
    import contextlib

    reached = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: reached.append((name, len(args))) or 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "library", lambda name: reached.append(name) or Lib())
    monkeypatch.setattr(_build, "tickets",
                        lambda device, n, owner: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(pa.paged_attention, "launches", 0)
    monkeypatch.setattr(pa.paged_attention, "routes", {"sm90": 0, "v1": 0})
    q, k, v, table, pos, kw = _operands(4, 1, 16, 4, 128, 64, 8, "int8")
    pa._launch(sm90, q, k, v, table, pos, kw["k_scale"], kw["v_scale"], "int8", 4,
               torch.empty_like(q))
    n_args = len(_build._LIBRARIES[lib]["entry"][entry][0])
    assert reached == [lib, (entry, n_args)]
    assert pa.paged_attention.launches == 1
    assert pa.paged_attention.routes == {"sm90": int(sm90), "v1": int(not sm90)}


def test_cpu_calls_count_no_launch():
    launches, routes = pa.paged_attention.launches, dict(pa.paged_attention.routes)
    q, k, v, table, pos, kw = _operands(2, 1, 4, 2, 16, 8, 3, torch.float32)
    pa.paged_attention(q, k, v, table, pos)
    assert pa.paged_attention.launches == launches and pa.paged_attention.routes == routes


@pytest.mark.parametrize("b,kv,p,want", [
    (4, 4, 64, (1, 64, 1)),  # the paged stream: 1024 blocks, 136 working
    (4, 16, 8, (1, 8, 1)),
    (4, 4, 512, (4, 128, 2)),  # a 32k window: 4 pages a split, a 2-stage ring
    (64, 8, 64, (16, 4, 2)),
    (3, 2, 0, (1, 1, 1)),  # an empty table still has one split to write zeros
])
def test_sm90_plan(b, kv, p, want):
    pps, splits, stages = pa._sm90_plan(b, kv, p)
    assert (pps, splits, stages) == want
    assert splits * pps >= p and (splits - 1) * pps < max(p, 1)


# ---------------------------------------------------------------------------
# the split and merge, against the JAX kernel and the unsplit plain version

SPLIT_CASES = ["ragged_base", "gqa", "chunk_s4", "int8", "int4", "int8_gqa_chunk",
               "int4_gqa_chunk", "bf16_page16_gqa", "bf16_int8"]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_plain_matches_jax_kernel_and_unsplit(case):
    """For one to all pages a split, the split-and-merge plain version
    against the JAX kernel (interpret mode) and the unsplit plain version;
    each split count reaches sentinel tails (the cases' ragged depths)."""
    from helpers import pallas_interpret_available
    from test_torch_paged_attention import CASES, TOL, _both, _np32, _setup

    from pytorch_distributed_training_tutorials_tpu.ops.paged_attention import (
        paged_attention as j_paged_attention,
    )

    if not pallas_interpret_available():
        pytest.skip("this jax has no Pallas interpret mode")
    seed, b, s, h, kv, d, ps, p_cap, n_pages, quant, dt = CASES[case]
    q, k, v, table, pos, kw = _setup(seed, b, s, h, kv, d, ps, p_cap, n_pages, quant)
    (jx, jkw), (tx, tkw) = _both((q, k, v, table, pos), kw, dt)
    want = _np32(j_paged_attention(*jx, **jkw))
    unsplit = _np32(pa.paged_attention_plain(*tx, **tkw))
    for n in range(1, p_cap + 1):
        got = pa.paged_attention_plain(*tx, **tkw, pages_per_split=n)
        assert got.dtype == tx[0].dtype and got.shape == (b, s, h, d)
        np.testing.assert_allclose(_np32(got), want, **TOL[dt])
        np.testing.assert_allclose(_np32(got), unsplit, **TOL[dt])


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_split_plain_parked_row_is_exactly_zero(quant):
    """A parked row (all sentinel) merges only empty records: exact zeros;
    one split of every page equals the unsplit version bitwise."""
    from test_torch_paged_attention import _both, _np32, _setup

    q, k, v, table, pos, kw = _setup(3, 3, 1, 4, 4, 16, 8, 3, 12, quant)
    table[1] = 12
    _, (tx, tkw) = _both((q, k, v, table, pos), kw)
    unsplit = pa.paged_attention_plain(*tx, **tkw)
    for n in (1, 2):
        got = _np32(pa.paged_attention_plain(*tx, **tkw, pages_per_split=n))
        assert np.all(np.isfinite(got))
        np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))
        np.testing.assert_allclose(got, _np32(unsplit), atol=2e-5, rtol=1e-5)
    assert torch.equal(pa.paged_attention_plain(*tx, **tkw, pages_per_split=3), unsplit)
    with pytest.raises(ValueError, match="pages_per_split"):
        pa.paged_attention_plain(*tx, **tkw, pages_per_split=0)


# ---------------------------------------------------------------------------
# on the card

# (B, S, H, KV, D, page_size, P, storage, q dtype, parked rows, depths or
# None): tests/test_torch_cuda.py's paged cases the sm90 kernel takes, and
# the paged stream's shape (64 pages a row, depths 32, 496, 1516, 32)
CARD_CASES = [
    (4, 1, 16, 4, 128, 64, 8, torch.float32, torch.float32, (), None),
    (4, 1, 16, 16, 128, 64, 8, torch.bfloat16, torch.float32, (2,), None),
    (4, 1, 16, 4, 128, 64, 8, "int8", torch.float32, (1,), None),
    (4, 1, 16, 4, 128, 64, 8, "int4", torch.float32, (), None),
    (2, 4, 16, 4, 128, 64, 4, "int4", torch.float32, (), None),
    (3, 2, 8, 2, 32, 8, 4, torch.bfloat16, torch.bfloat16, (), None),
    (3, 3, 8, 2, 32, 16, 3, "int8", torch.bfloat16, (0,), None),
    (4, 1, 16, 4, 128, 64, 64, torch.float32, torch.float32, (), (32, 496, 1516, 32)),
    (4, 1, 16, 4, 128, 64, 64, "int4", torch.bfloat16, (3,), (32, 496, 1516, 32)),
    (4, 1, 16, 4, 128, 64, 512, "int8", torch.float32, (), (0, 5000, 20000, 32700)),
]


def _card_inputs(b, s, h, kv, d, ps, p_cap, store, q_dtype, parked, depths, seed):
    """Card operands: ragged depths (``depths``, or spread over the window),
    distinct shuffled pages, sentinel tails, ``parked`` rows all sentinel."""
    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
        _quantize_kv,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import quantize_kv_int4

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if depths is None:
        pos = torch.linspace(0, p_cap * ps - s, b).round().to(torch.int64).cuda()
    else:
        pos = torch.tensor(depths, dtype=torch.int64, device="cuda")
    live = [-(-(int(p) + s) // ps) for p in pos]
    n_pages = sum(live) + 3
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(q_dtype)
    kf, vf = (torch.randn((n_pages, ps, kv, d), generator=gen, device="cuda") for _ in range(2))
    kw = {}
    if store == "int8":
        (k, ks), (v, vs) = _quantize_kv(kf), _quantize_kv(vf)
        kw = dict(k_scale=ks, v_scale=vs, quant="int8")
    elif store == "int4":
        (k, ks), (v, vs) = quantize_kv_int4(kf), quantize_kv_int4(vf)
        kw = dict(k_scale=ks, v_scale=vs, quant="int4")
    else:
        k, v = kf.to(store), vf.to(store)
    perm = torch.randperm(n_pages, generator=gen, device="cuda").tolist()
    table = torch.full((b, p_cap), n_pages, dtype=torch.int32)
    for i, n in enumerate(live):
        table[i, :n] = torch.tensor([perm.pop() for _ in range(n)], dtype=torch.int32)
    for r in parked:
        table[r] = n_pages
    return q, k, v, table.cuda(), pos, kw


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_sm90_kernel_matches_plain_version(case):
    """The sm90 kernel against the plain version on the same operands, each
    element within ``KERNEL_TOLERANCE`` of ``tolerance_type``; parked rows
    exactly 0; a second call bitwise equal (the tickets reset themselves);
    one sm90 route counted per call."""
    _need_cuda()
    b, s, h, kv, d, ps, p_cap, store, q_dtype, parked, depths = CARD_CASES[case]
    q, k, v, table, pos, kw = _card_inputs(b, s, h, kv, d, ps, p_cap, store, q_dtype, parked,
                                           depths, seed=case + 7)
    before = dict(pa.paged_attention.routes)
    got = pa.paged_attention(q, k, v, table, pos, **kw)
    again = pa.paged_attention(q, k, v, table, pos, **kw)
    assert pa.paged_attention.routes == {"sm90": before["sm90"] + 2, "v1": before["v1"]}
    pps = pa._sm90_plan(b, kv, p_cap)[0]
    want = pa.paged_attention_plain(q, k, v, table, pos, **kw, pages_per_split=pps)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    err = pa.kernel_error(got, want, pa.tolerance_type(q, v, kw.get("quant")))
    assert err["worst_ratio"] <= 1.0, err
    unsplit = pa.paged_attention_plain(q, k, v, table, pos, **kw)
    err = pa.kernel_error(got, unsplit, pa.tolerance_type(q, v, kw.get("quant")))
    assert err["worst_ratio"] <= 1.0, err
    for r in parked:
        assert not got[r].any()
    assert torch.equal(got, again)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("store", [torch.float32, "int8"], ids=["f32", "int8"])
def test_sm90_row_blocks_match_plain_version_at_a_splice(store):
    """A paged splice's suffix forward at the 1b-gqa width (one row, S 256
    query rows from depth 96): the sm90 kernel in row blocks against the
    plain version over all rows at once, within ``KERNEL_TOLERANCE``; every
    block on the sm90 route."""
    _need_cuda()
    q, k, v, table, pos, kw = _card_inputs(1, 256, 16, 4, 128, 64, 64, store, torch.float32,
                                           (), (96,), seed=11)
    rows = pa._rows_per_launch(True, q, k, kw.get("quant"), 4, 64)
    assert 1 <= rows < 256
    before = dict(pa.paged_attention.routes)
    got = pa.paged_attention(q, k, v, table, pos, **kw)
    assert pa.paged_attention.routes == {"sm90": before["sm90"] + -(-256 // rows),
                                         "v1": before["v1"]}
    want = pa.paged_attention_plain(q, k, v, table, pos, **kw)
    torch.cuda.synchronize()
    err = pa.kernel_error(got, want, pa.tolerance_type(q, v, kw.get("quant")))
    assert err["worst_ratio"] <= 1.0, err


@pytest.mark.requires_cuda
def test_sm90_and_v1_agree_at_the_stream_shape():
    _need_cuda()
    q, k, v, table, pos, kw = _card_inputs(*CARD_CASES[7], seed=3)
    before = dict(pa.paged_attention.routes)
    new = pa.paged_attention(q, k, v, table, pos, **kw)
    old = pa.paged_attention(q, k, v, table, pos, **kw, route="v1")
    assert pa.paged_attention.routes == {"sm90": before["sm90"] + 1, "v1": before["v1"] + 1}
    torch.cuda.synchronize()
    err = pa.kernel_error(new, old, torch.float32)
    assert err["worst_ratio"] <= 1.0, err


@pytest.mark.requires_cuda
def test_refused_calls_keep_the_v1_route():
    """int4 at D 18 (a 9-byte stored row) goes to the v1 kernel, still right."""
    _need_cuda()
    q, k, v, table, pos, kw = _card_inputs(2, 1, 4, 4, 18, 8, 3, "int4", torch.float32, (),
                                           None, seed=1)
    before = dict(pa.paged_attention.routes)
    got = pa.paged_attention(q, k, v, table, pos, **kw)
    assert pa.paged_attention.routes == {"sm90": before["sm90"], "v1": before["v1"] + 1}
    want = pa.paged_attention_plain(q, k, v, table, pos, **kw)
    torch.cuda.synchronize()
    assert pa.kernel_error(got, want, torch.float32)["worst_ratio"] <= 1.0
