"""The int8 matmul's routes: the sm90 kernel (``csrc/int8_matmul_sm90.cu``:
s8 wgmma, a TMA ring of weight tiles, the K tiles split across blocks and
folded in tile order by the last block) and ``csrc/int8_matmul.cu`` (v1).

On the CPU these tests cover what surrounds the kernels: the route each
call takes (the launch itself recorded, not run) on the 1b shapes, on K
not a multiple of 16 and on misaligned bases, and when the old kernel is
asked for by name; the library and entry point each route reaches; that
CPU calls count no launch; the sm90 grid plan (``_sm90_plan``); and the
plain statement of the split-K fold (``int8_matmul_split_reference``:
exact int32 tile sums kept apart per split, then one ordered FMA fold)
held **bitwise** to the JAX package's ``int8_matmul`` Pallas kernel in
interpret mode, at M 1, 4 and 48 and K 512, 2048 and 8192 (narrow N), as
``tests/test_torch_quant.py`` holds the unsplit plain version.

The ``requires_cuda`` tests hold the sm90 kernel bitwise to
``int8_matmul_reference`` on the card at decode and prefill M, check that
two calls are bitwise equal (the split tickets reset themselves), that the
two routes agree bitwise, and count the routes. Whether a card is present
is decided inside each test. Only the JAX parity tests import jax, inside
the test; on a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m requires_cuda \\
        tests/test_torch_int8_sm90.py
"""

import contextlib

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import _build
from pytorch_distributed_training_tutorials_tpu_torch.ops import quant as tq


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _np(shape, seed, scale=1.0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _weight(k, n, seed, device="cpu"):
    """An int8 weight in the layout the kernels take: q (K, N) as a
    K-contiguous view of an (N, K) tensor."""
    qp = tq.quantize_int8(torch.from_numpy(_np((k, n), seed, 0.02)).to(device))
    return tq.Int8Param(q=qp.q.t().contiguous().t(), scale=qp.scale)


# ---------------------------------------------------------------------------
# the route


@pytest.fixture
def recorded(monkeypatch):
    """``int8_matmul`` with CPU tensors taken as if on the card: each launch
    is recorded as its route and not run."""
    calls = []
    monkeypatch.setattr(tq, "_on_card", lambda x: True)
    monkeypatch.setattr(tq, "_launch", lambda sm90, x, w, out: calls.append(
        "sm90" if sm90 else "v1"))
    return calls


def _offset_x(m, k, floats):
    """An (M, K) f32 x ``floats`` elements into a fresh buffer: contiguous,
    its base 4 * floats bytes past an aligned one."""
    buf = torch.zeros(m * k + floats, dtype=torch.float32)
    return buf[floats:].view(m, k)


@pytest.mark.parametrize("m,k,n,x_off,want", [
    (4, 2048, 2048, 0, "sm90"),  # the 1b decode projections
    (4, 2048, 8192, 0, "sm90"),
    (4, 8192, 2048, 0, "sm90"),
    (4, 2048, 32000, 0, "sm90"),  # the lm_head
    (512, 2048, 2048, 0, "sm90"),  # a prefill bucket
    (3, 64, 40, 0, "sm90"),
    (3, 200, 130, 0, "v1"),  # K not a multiple of 16: TMA cannot address qt's rows
    (5, 201, 67, 0, "v1"),
    (4, 1000, 64, 0, "v1"),
    (4, 2048, 2048, 1, "v1"),  # x's base 4 bytes past an aligned one
    (4, 2048, 2048, 2, "v1"),
    (4, 2048, 2048, 4, "sm90"),  # 16 bytes past: aligned again
])
def test_route(recorded, m, k, n, x_off, want):
    x = _offset_x(m, k, x_off)
    out = tq.int8_matmul(x, _weight(k, n, seed=1))
    assert recorded == [want]
    assert out.shape == (m, n) and out.dtype == torch.float32


def test_route_refuses_a_misaligned_weight(recorded):
    """qt one byte into a buffer: K-contiguous rows of K 2048, its base off
    16 bytes."""
    k, n = 2048, 64
    buf = torch.zeros(n * k + 16, dtype=torch.int8)
    qt = buf[1:1 + n * k].view(n, k)
    w = tq.Int8Param(q=qt.t(), scale=torch.ones((1, n)))
    tq.int8_matmul(torch.zeros((4, k)), w)
    assert recorded == ["v1"]


def test_route_v1_by_name(recorded):
    w = _weight(2048, 2048, seed=2)
    tq.int8_matmul(torch.zeros((4, 2048)), w, route="v1")
    tq.int8_matmul(torch.zeros((4, 2048)), w)
    assert recorded == ["v1", "sm90"]
    with pytest.raises(ValueError, match="route must be"):
        tq.int8_matmul(torch.zeros((4, 2048)), w, route="sm80")


@pytest.mark.parametrize("sm90,lib,entry", [
    (True, "int8_matmul_sm90", "int8_matmul_sm90_launch"),
    (False, "int8_matmul", "int8_matmul_launch"),
])
def test_each_route_reaches_its_library(monkeypatch, sm90, lib, entry):
    """``_launch`` asks ``_build`` for the route's library and calls its entry
    point; both libraries are registered with that entry and -fmad=false
    (bitwise their plain version). The CUDA device and stream are stubbed,
    and so are the counters."""
    reached = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: reached.append(name) or 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "library", lambda name: reached.append(name) or Lib())
    monkeypatch.setattr(_build, "tickets",
                        lambda device, n, owner: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(tq, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(tq.int8_matmul, "launches", 0)
    monkeypatch.setattr(tq.int8_matmul, "routes", {"sm90": 0, "v1": 0})
    tq._launch(sm90, torch.zeros((4, 2048)), _weight(2048, 2048, seed=3),
               torch.empty((4, 2048)))
    assert reached == [lib, entry]
    assert entry in _build._LIBRARIES[lib]["entry"]
    assert "-fmad=false" in _build._LIBRARIES[lib]["flags"]
    assert tq.int8_matmul.launches == 1
    assert tq.int8_matmul.routes == {"sm90": int(sm90), "v1": int(not sm90)}


def test_cpu_calls_count_no_launch():
    launches, routes = tq.int8_matmul.launches, dict(tq.int8_matmul.routes)
    got = tq.int8_matmul(torch.from_numpy(_np((4, 2048), 4)), _weight(2048, 64, seed=5))
    assert got.shape == (4, 64)
    assert tq.int8_matmul.launches == launches and tq.int8_matmul.routes == routes


# ---------------------------------------------------------------------------
# the grid plan


@pytest.mark.parametrize("m,k,n,want", [
    (4, 2048, 2048, (1, 4)),  # 32 slabs x 4 splits of one tile: 128 blocks
    (4, 8192, 2048, (4, 4)),  # 32 x 4 of four tiles
    (4, 2048, 8192, (4, 1)),  # 128 slabs: no split
    (4, 2048, 32000, (4, 1)),
    (64, 2048, 2048, (1, 4)),  # fused up to M 64
    (128, 2048, 2048, (2, 2)),  # 2 row tiles x 32 slabs x 2
    (512, 2048, 2048, (4, 1)),
    (2048, 8192, 2048, (16, 1)),
    (3, 64, 40, (1, 1)),
])
def test_sm90_plan(m, k, n, want):
    tps, splits = tq._sm90_plan(m, k, n, 132)
    assert (tps, splits) == want
    n_k = -(-k // tq.block_k_for(k))
    assert splits * tps >= n_k and (splits - 1) * tps < n_k  # no empty split


# ---------------------------------------------------------------------------
# the split-K fold against the JAX kernel


SPLIT_CASES = [
    (m, k, n) for m in (1, 4, 48) for k, n in ((512, 256), (2048, 128))
] + [(1, 8192, 64), (4, 8192, 64), (48, 8192, 64), (5, 1000, 130)]


@pytest.mark.parametrize("m,k,n", SPLIT_CASES)
def test_split_fold_bitwise_vs_jax_kernel(m, k, n):
    """Every split of the K tiles (one tile a split up to all in one) gives
    bitwise the JAX Pallas kernel's result: the tile sums are exact
    integers and the fold runs in tile order whatever the split."""
    import jax.numpy as jnp

    from pytorch_distributed_training_tutorials_tpu.ops import quant as jq
    from helpers import pallas_interpret_available

    if not pallas_interpret_available():
        pytest.skip("this jax has no Pallas interpret mode")
    x = _np((m, k), seed=6)
    jp = jq.quantize_int8(_np((k, n), seed=7, scale=0.02))
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jp))
    tp = tq.Int8Param(q=torch.tensor(np.asarray(jp.q)), scale=torch.tensor(np.asarray(jp.scale)))
    n_k = -(-k // tq.block_k_for(k))
    for tps in sorted({1, 2, 3, n_k}):
        got = tq.int8_matmul_split_reference(torch.from_numpy(x), tp, tps)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tq.int8_matmul_reference(torch.from_numpy(x), tp).numpy(), want)


def test_split_reference_refuses_an_empty_split():
    with pytest.raises(ValueError, match="tiles_per_split"):
        tq.int8_matmul_split_reference(torch.zeros((1, 512)), _weight(512, 8, seed=8), 0)


# ---------------------------------------------------------------------------
# on the card

# (M, K, N): decode at the 1b shapes, the fused limit, prefill buckets, a
# partial last K step (K 2064: 16 past the fourth tile), K under one tile
CARD_CASES = [
    (1, 2048, 2048), (4, 2048, 2048), (4, 8192, 2048), (4, 2048, 8192),
    (4, 2048, 32000), (16, 2048, 2048), (64, 8192, 2048), (65, 2048, 2048),
    (128, 8192, 2048), (512, 2048, 2048), (2048, 2048, 8192), (4, 2064, 200),
    (3, 64, 40), (200, 2064, 70),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,k,n", CARD_CASES)
def test_sm90_kernel_bitwise_plain_version(m, k, n):
    """The sm90 kernel against int8_matmul_reference on the card, bitwise;
    a second call bitwise equal to the first; one sm90 route counted per
    call."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(m * 31 + k + n)
    x = torch.randn((m, k), generator=gen, device="cuda")
    qp = tq.quantize_int8(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
    w = tq.Int8Param(q=qp.q.t().contiguous().t(), scale=qp.scale)
    before = dict(tq.int8_matmul.routes)
    got = tq.int8_matmul(x, w)
    again = tq.int8_matmul(x, w)
    assert tq.int8_matmul.routes["sm90"] == before["sm90"] + 2
    assert tq.int8_matmul.routes["v1"] == before["v1"]
    want = tq.int8_matmul_reference(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(got, again)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (512, 2048, 2048)])
def test_sm90_and_v1_agree_bitwise(m, k, n):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((m, k), generator=gen, device="cuda")
    qp = tq.quantize_int8(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
    w = tq.Int8Param(q=qp.q.t().contiguous().t(), scale=qp.scale)
    before = dict(tq.int8_matmul.routes)
    new, old = tq.int8_matmul(x, w), tq.int8_matmul(x, w, route="v1")
    assert tq.int8_matmul.routes == {"sm90": before["sm90"] + 1, "v1": before["v1"] + 1}
    torch.cuda.synchronize()
    assert torch.equal(new, old)


@pytest.mark.requires_cuda
def test_unaligned_calls_keep_the_v1_route():
    _need_cuda()
    x = torch.randn((3, 200), device="cuda")
    qp = tq.quantize_int8(torch.randn((200, 130), device="cuda") * 0.02)
    w = tq.Int8Param(q=qp.q.t().contiguous().t(), scale=qp.scale)
    before = dict(tq.int8_matmul.routes)
    got = tq.int8_matmul(x, w)
    assert tq.int8_matmul.routes == {"sm90": before["sm90"], "v1": before["v1"] + 1}
    assert torch.equal(got, tq.int8_matmul_reference(x, w))
