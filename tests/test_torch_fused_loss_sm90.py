"""The fused cross entropy's routes: the sm90 kernels
(``csrc/fused_loss_sm90.cu``: TMA, wgmma; forward, dh and dW) and
``fused_loss.cu``'s.

On the CPU these tests cover the pure functions around the kernels: the
route decision (:func:`_sm90_route`) and the grids of the sm90 forward, dh
and dW kernels (every row tile and vocab tile covered exactly once, ragged
tails included). The ``requires_cuda`` tests hold the sm90 kernels to their plain
versions on the card under ``KERNEL_TOLERANCE[bfloat16]``, count their
routes, check that two calls are bitwise equal and that the calls the sm90
kernels do not take still go to the old ones. Whether a card is present is
decided inside each test. This file imports no jax; on a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m requires_cuda \\
        tests/test_torch_fused_loss_sm90.py tests/test_torch_cuda.py -k fused
"""

import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import fused_loss as fl
from test_torch_cuda import FUSED_CE_CASES

MAIN = (4096, 1536, 32768)  # the loss of the 760m train step


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


# ---------------------------------------------------------------------------
# the route


@pytest.mark.parametrize("dtype,d,v,h_off,w_off,want", [
    (torch.bfloat16, 1536, 32768, 0, 0, True),   # the main shape
    (torch.bfloat16, 256, 1000, 0, 0, True),
    (torch.float32, 1536, 32768, 0, 0, False),   # f32: the old kernels
    (torch.bfloat16, 1536, 50, 0, 0, False),     # V * 2 not a multiple of 16
    (torch.bfloat16, 20, 32768, 0, 0, False),    # D * 2 not a multiple of 16
    (torch.bfloat16, 1536, 32001, 0, 0, False),  # an odd vocab
    (torch.bfloat16, 1536, 32768, 2, 0, False),  # h 2 bytes past a 16-byte boundary
    (torch.bfloat16, 1536, 32768, 0, 8, False),  # W 8 bytes past one
])
def test_sm90_route(dtype, d, v, h_off, w_off, want):
    base = 1 << 20
    assert fl._sm90_route(dtype, d, v, base + h_off, base + w_off) is want


def test_sm90_route_refuses_a_view_two_bytes_past_an_aligned_base():
    """A contiguous view one bf16 element into an aligned buffer."""
    buf = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    h = buf[1:1 + 4 * 64].view(4, 64)
    assert h.is_contiguous() and h.data_ptr() % 16 == 2
    w = torch.zeros((64, 128), dtype=torch.bfloat16)
    assert fl._sm90_route(h.dtype, 64, 128, buf.data_ptr(), w.data_ptr())
    assert not fl._sm90_route(h.dtype, 64, 128, h.data_ptr(), w.data_ptr())


@pytest.mark.parametrize("dtype,route,want", [
    (torch.bfloat16, None, True),
    (torch.bfloat16, "sm80", False),  # the old kernel asked for by name
    (torch.float32, None, False),
    (torch.bfloat16, "sm90", ValueError),
])
def test_use_sm90(dtype, route, want):
    h = torch.zeros((4, 64), dtype=dtype)
    w = torch.zeros((64, 128), dtype=dtype)
    if want is ValueError:
        with pytest.raises(ValueError, match="route"):
            fl._use_sm90(h, w, route)
    else:
        assert fl._use_sm90(h, w, route) is want


def test_cpu_calls_count_no_route():
    """The CPU path runs the plain versions and counts no launch of either
    route."""
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((16, 32), generator=gen).bfloat16()
    w = torch.randn((32, 40), generator=gen).bfloat16()
    y = torch.randint(0, 40, (16,), generator=gen)
    g = torch.full((16,), 1 / 16)
    before = {k: dict(r) for k, r in fl.fused_cross_entropy.routes.items()}
    lse, _ = fl.fused_ce_fwd(h, w, y)
    dh = fl.fused_ce_dh(h, w, y, lse, g)
    dw = fl.fused_ce_dw(h, w, y, lse, g)
    assert fl.fused_cross_entropy.routes == before
    assert torch.equal(dh, fl.fused_ce_dh_reference(h, w, y, lse, g))
    assert torch.equal(dw, fl.fused_ce_dw_reference(h, w, y, lse, g))


# ---------------------------------------------------------------------------
# the grids

PLAN_SHAPES = [
    (*MAIN, 132),
    (300, 256, 1000, 132),    # ragged rows and vocab
    (128, 1536, 4096, 132),   # few row tiles: many splits
    (1100, 1536, 5000, 132),  # tails in both dh and dW groups
    (1000, 1536, 32000, 132),
    (20000, 64, 1032, 132),   # more row tiles than SMs: one split
    (70, 24, 56, 8),
    (64, 8, 8, 1),
]


def _partition(ranges, total, step=None):
    """The ranges, in order, tile [0, total) with no gap and no overlap;
    each but the last is ``step`` long when given."""
    at = 0
    for i, (a, b) in enumerate(ranges):
        assert a == at and b > a, ranges
        if step is not None and i < len(ranges) - 1:
            assert b - a == step
        at = b
    assert at == total


@pytest.mark.parametrize("n,d,v,sms", PLAN_SHAPES)
def test_fwd_plan_covers_every_tile_once(n, d, v, sms):
    plan = fl._fwd_plan(n, d, v, sms)
    blocks = list(fl._fwd_blocks(n, v, plan))
    assert len(blocks) == plan["row_tiles"] * plan["splits"]
    assert plan["splits"] <= 65535
    by_rows = {}
    for rows, tiles in blocks:
        assert tiles, "an empty split"
        by_rows.setdefault(rows, []).extend(tiles)
    _partition(sorted(by_rows), n, fl._SM90_FWD_ROWS)
    for tiles in by_rows.values():
        _partition(tiles, v, fl._TILE_COLS)
    # one block per SM: one wave where the row tiles allow it
    if plan["row_tiles"] <= sms:
        assert plan["waves"] <= 1.0
    else:
        assert plan["splits"] == 1
    assert plan["d_chunks"] * 64 >= d > (plan["d_chunks"] - 1) * 64


def test_fwd_plan_at_the_main_shape():
    """32 row tiles x 4 splits of 64 score tiles: 128 blocks, one wave on
    132 SMs."""
    plan = fl._fwd_plan(*MAIN, 132)
    assert (plan["row_tiles"], plan["splits"], plan["tiles_per_split"]) == (32, 4, 64)
    assert plan["waves"] == 128 / 132


@pytest.mark.parametrize("n,d,v,sms", PLAN_SHAPES)
def test_dh_plan_covers_every_tile_once(n, d, v, sms):
    plan = fl._dh_plan(n, d, v, sms)
    blocks = list(fl._dh_blocks(n, v, plan))
    assert len(blocks) == plan["row_tiles"] * plan["splits"]
    assert plan["splits"] <= 65535
    by_rows = {}
    for rows, groups in blocks:
        assert groups, "an empty split"
        for c0, c1 in groups:
            assert c1 - c0 <= fl._SM90_DH_GROUP
        by_rows.setdefault(rows, []).extend(groups)
    _partition(sorted(by_rows), n, fl._SM90_DH_ROWS)
    for groups in by_rows.values():
        _partition(groups, v, fl._SM90_DH_GROUP)
    # one block per SM: one wave where the row tiles allow it
    if plan["row_tiles"] <= sms:
        assert plan["waves"] <= 1.0
    else:
        assert plan["splits"] == 1
    assert plan["d_passes"] * fl._SM90_D_PASS >= d > (plan["d_passes"] - 1) * fl._SM90_D_PASS


def test_dh_plan_at_the_main_shape():
    plan = fl._dh_plan(*MAIN, 132)
    assert (plan["row_tiles"], plan["splits"], plan["groups_per_split"]) == (64, 2, 16)


@pytest.mark.parametrize("n,d,v,sms", PLAN_SHAPES)
def test_dw_plan_covers_every_tile_once(n, d, v, sms):
    plan = fl._dw_plan(n, d, v, sms)
    _partition(plan["columns"], v, fl._TILE_COLS)
    _partition(plan["row_groups"], n, fl._SM90_DW_GROUP)
    assert plan["waves"] == len(plan["columns"]) / sms
    assert plan["d_passes"] * fl._SM90_D_PASS >= d


def test_dw_plan_at_the_main_shape():
    plan = fl._dw_plan(*MAIN, 132)
    assert len(plan["columns"]) == 256 and len(plan["row_groups"]) == 8


# ---------------------------------------------------------------------------
# on the card

SM90_CASES = [
    # (N, D, V, a target out of range)
    (300, 256, 1000, True),
    (128, 1536, 4096, False),
    (1100, 1536, 5000, False),  # several dh and dW groups, tails in both
    (200, 200, 1000, True),     # D not a multiple of 64: a partial last box
    (64, 40, 1000, True),       # D < 64: one box, mostly past D
]


def _operands(n, d, v, oor, dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(n + d + v)
    h = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((d, v), generator=gen, device="cuda") * d ** -0.5).to(dtype)
    y = torch.randint(0, v, (n,), generator=gen, device="cuda")
    if oor:
        y[1] = v + 3  # hits nothing
    g = torch.rand((n,), generator=gen, device="cuda") / n
    lse, _ = fl.fused_ce_fwd(h, w, y)
    return h, w, y, lse, g


def _routes():
    return {k: dict(r) for k, r in fl.fused_cross_entropy.routes.items()}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,d,v,oor", SM90_CASES)
def test_sm90_kernels_match_plain_versions(n, d, v, oor):
    """dh and dW through the sm90 kernels, each held element by element to
    its plain version under KERNEL_TOLERANCE[bfloat16]; one sm90 launch
    counted per call; a second call bitwise equal."""
    _need_cuda()
    h, w, y, lse, g = _operands(n, d, v, oor)
    before = _routes()
    dh = fl.fused_ce_dh(h, w, y, lse, g)
    dw = fl.fused_ce_dw(h, w, y, lse, g)
    got = _routes()
    assert got["dh"] == {"sm90": before["dh"]["sm90"] + 1, "sm80": before["dh"]["sm80"]}
    assert got["dw"] == {"sm90": before["dw"]["sm90"] + 1, "sm80": before["dw"]["sm80"]}
    for name, out, ref in (("dh", dh, fl.fused_ce_dh_reference(h, w, y, lse, g, 64, 128)),
                           ("dw", dw, fl.fused_ce_dw_reference(h, w, y, lse, g, 64, 128))):
        assert out.dtype == ref.dtype and out.shape == ref.shape, name
        err = fl.kernel_error(out, ref)
        assert err["worst_ratio"] <= 1.0, (name, err)
    assert torch.equal(dh, fl.fused_ce_dh(h, w, y, lse, g))
    assert torch.equal(dw, fl.fused_ce_dw(h, w, y, lse, g))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,d,v,oor", SM90_CASES)
def test_sm90_forward_matches_plain_version(n, d, v, oor):
    """lse and the target logit through the sm90 forward, each held element
    by element to the plain version under KERNEL_TOLERANCE[float32]; one
    sm90 launch counted per call; a second call bitwise equal; a target out
    of range hits nothing."""
    _need_cuda()
    h, w, y, _, _ = _operands(n, d, v, oor)
    before = _routes()
    lse, tgt = fl.fused_ce_fwd(h, w, y)
    got = _routes()
    assert got["fwd"] == {"sm90": before["fwd"]["sm90"] + 1, "sm80": before["fwd"]["sm80"]}
    for name, out, ref in zip(("lse", "tgt"), (lse, tgt),
                              fl.fused_ce_fwd_reference(h, w, y, 64, 128)):
        assert out.dtype == ref.dtype and out.shape == ref.shape, name
        err = fl.kernel_error(out, ref)
        assert err["worst_ratio"] <= 1.0, (name, err)
    lse2, tgt2 = fl.fused_ce_fwd(h, w, y)
    assert torch.equal(lse, lse2) and torch.equal(tgt, tgt2)
    if oor:
        assert float(tgt[1]) == 0.0


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "n,d,v,dtype,oor",
    [c for c in FUSED_CE_CASES if c[3] != torch.bfloat16 or c[1] % 8 or c[2] % 8])
def test_old_cases_keep_the_old_route(n, d, v, dtype, oor):
    """f32, and bf16 with D or V not a multiple of 8, still launch
    fused_loss.cu's kernels: forward, dh and dW."""
    _need_cuda()
    h, w, y, lse, g = _operands(n, d, v, oor, dtype)
    before = _routes()
    fl.fused_ce_fwd(h, w, y)
    fl.fused_ce_dh(h, w, y, lse, g)
    fl.fused_ce_dw(h, w, y, lse, g)
    got = _routes()
    for k in ("fwd", "dh", "dw"):
        assert got[k] == {"sm90": before[k]["sm90"], "sm80": before[k]["sm80"] + 1}


@pytest.mark.requires_cuda
def test_sm90_route_on_a_misaligned_view_takes_the_old_kernels():
    """A bf16 h two bytes past an aligned base: the old forward and dh
    kernels, the same function."""
    _need_cuda()
    n, d, v = 128, 256, 1000
    _, w, y, lse, g = _operands(n, d, v, False)
    buf = torch.randn((n * d + 8,), device="cuda").bfloat16()
    h = buf[1:1 + n * d].view(n, d)
    before = _routes()
    lse1, tgt1 = fl.fused_ce_fwd(h, w, y)
    dh = fl.fused_ce_dh(h, w, y, lse, g)
    for k in ("fwd", "dh"):
        assert fl.fused_cross_entropy.routes[k]["sm80"] == before[k]["sm80"] + 1
    err = fl.kernel_error(dh, fl.fused_ce_dh_reference(h, w, y, lse, g, 64, 128))
    assert err["worst_ratio"] <= 1.0, err
    for out, ref in zip((lse1, tgt1), fl.fused_ce_fwd_reference(h, w, y, 64, 128)):
        assert fl.kernel_error(out, ref)["worst_ratio"] <= 1.0
