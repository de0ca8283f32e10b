"""The flash-attention forward's routes: the sm90 kernel
(``csrc/flash_attention_sm90.cu``: TMA, wgmma) and ``flash_attention.cu``'s
``fwd_kernel``.

On the CPU these tests cover the pure function around the kernel: the
route decision (:func:`_sm90_route`, :func:`_use_sm90`) on the main shape,
on a (B, H, S, D) storage seen as (B, S, H, D), on misaligned views and on
head dims outside what the kernel instantiates. The ``requires_cuda`` tests
hold the sm90 forward to its plain version on the card under
``KERNEL_TOLERANCE[bfloat16]`` (O) and ``[float32]`` (lse), count its
routes, check that two calls are bitwise equal and that the calls it does
not take still go to the old kernel. Whether a card is present is decided
inside each test. This file imports no jax; on a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m requires_cuda \\
        tests/test_torch_flash_sm90.py
"""

import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import flash_attention as fa

MAIN = (2, 2048, 16, 96)  # (B, S, H, D) of the 760m train step


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _strides(b, s, h, d, heads_major=False):
    """(B, S, H) element strides of a contiguous (B, S, H, D) tensor, or of
    a (B, H, S, D) storage seen as (B, S, H, D)."""
    return (h * s * d, d, s * d) if heads_major else (s * h * d, h * d, d)


# ---------------------------------------------------------------------------
# the route


@pytest.mark.parametrize("dtype,d,ptr_off,heads_major,pad,want", [
    (torch.bfloat16, 96, 0, False, 0, True),    # the main shape
    (torch.bfloat16, 64, 0, False, 0, True),
    (torch.bfloat16, 128, 0, False, 0, True),
    (torch.bfloat16, 8, 0, False, 0, True),     # the narrowest head the kernel takes
    (torch.bfloat16, 40, 0, False, 0, True),    # padded to 64
    (torch.bfloat16, 96, 0, True, 0, True),     # (B, H, S, D) storage
    (torch.float32, 96, 0, False, 0, False),    # f32: the old kernel
    (torch.bfloat16, 96, 2, False, 0, False),   # a base 2 bytes past a 16-byte boundary
    (torch.bfloat16, 96, 0, False, 4, False),   # rows of D + 4: strides not 16-byte multiples
    (torch.bfloat16, 136, 0, False, 0, False),  # D past 128
    (torch.bfloat16, 20, 0, False, 0, False),   # D not a multiple of 8
])
def test_sm90_route(dtype, d, ptr_off, heads_major, pad, want):
    b, s, h, _ = MAIN
    base = 1 << 20
    ptrs = [base + ptr_off, base + (1 << 24), base + (2 << 24)]
    strides = _strides(b, s, h, d + pad, heads_major) * 3
    assert fa._sm90_route(dtype, d, ptrs, strides) is want


def test_sm90_route_refuses_a_zero_stride():
    """An operand expanded over heads (stride 0) is no TMA map: the old
    kernel."""
    b, s, h, d = MAIN
    st = _strides(b, s, h, d)
    assert not fa._sm90_route(torch.bfloat16, d, [0, 0, 0], [st[0], st[1], 0] * 3)


def _operands(shape, dtype=torch.bfloat16, heads_major=False):
    b, s, h, d = shape
    gen = torch.Generator().manual_seed(b + s + h + d)
    if heads_major:
        return [torch.randn((b, h, s, d), generator=gen).to(dtype).transpose(1, 2)
                for _ in range(3)]
    return [torch.randn((b, s, h, d), generator=gen).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype,heads_major,route,want", [
    (torch.bfloat16, False, None, True),
    (torch.bfloat16, True, None, True),     # the strided card case
    (torch.bfloat16, False, "sm80", False),  # the old kernel asked for by name
    (torch.float32, False, None, False),
    (torch.bfloat16, False, "sm90", ValueError),
])
def test_use_sm90(dtype, heads_major, route, want):
    q, k, v = _operands((1, 16, 2, 32), dtype, heads_major)
    if want is ValueError:
        with pytest.raises(ValueError, match="route"):
            fa._use_sm90(q, k, v, route)
    else:
        assert fa._use_sm90(q, k, v, route) is want


def test_use_sm90_refuses_a_view_two_bytes_past_an_aligned_base():
    """q one bf16 element into an aligned buffer: every stride fits, the
    base does not."""
    b, s, h, d = 1, 16, 2, 32
    buf = torch.zeros(b * s * h * d + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    q = buf[1:1 + b * s * h * d].view(b, s, h, d)
    assert q.data_ptr() % 16 == 2
    _, k, v = _operands((b, s, h, d))
    assert fa._use_sm90(buf[:b * s * h * d].view(b, s, h, d), k, v, None)
    assert not fa._use_sm90(q, k, v, None)


def test_cpu_calls_count_no_route():
    """The CPU path runs the plain version and counts no launch of either
    route."""
    q, k, v = _operands((1, 40, 2, 32))
    before = {n: dict(r) for n, r in fa.flash_attention.routes.items()}
    launches = dict(fa.flash_attention.launches)
    o, lse = fa.flash_fwd(q, k, v)
    assert fa.flash_attention.routes == before
    assert fa.flash_attention.launches == launches
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)


# ---------------------------------------------------------------------------
# on the card

SM90_CASES = [
    # (B, S, H, D, (B, H, S, D) storage seen as (B, S, H, D))
    (2, 2048, 16, 96, False),  # the 760m train step
    (2, 2048, 16, 64, False),
    (2, 2048, 16, 128, False),
    (2, 1000, 16, 96, True),   # ragged S, strided
    (2, 8, 16, 96, False),     # one tile, mostly past S
    (1, 300, 3, 40, False),    # D padded to 64, ragged S
]


def _card_operands(b, s, h, d, heads_major, dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(b + s + h + d)
    if heads_major:
        return [torch.randn((b, h, s, d), generator=gen, device="cuda",
                            dtype=dtype).transpose(1, 2) for _ in range(3)]
    return [torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=dtype)
            for _ in range(3)]


def _routes():
    return dict(fa.flash_attention.routes["fwd"])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s,h,d,heads_major", SM90_CASES)
def test_sm90_forward_matches_plain_version(b, s, h, d, heads_major):
    """O and lse through the sm90 kernel, each held element by element to
    the plain version (O under KERNEL_TOLERANCE[bfloat16], lse under
    [float32]); one sm90 launch counted per call; a second call bitwise
    equal."""
    _need_cuda()
    q, k, v = _card_operands(b, s, h, d, heads_major)
    before = _routes()
    o, lse = fa.flash_fwd(q, k, v)
    assert _routes() == {"sm90": before["sm90"] + 1, "sm80": before["sm80"]}
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, 64, 64)
    for name, got, ref in (("O", o, o_ref), ("lse", lse, lse_ref)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        err = fa.kernel_error(got, ref)
        assert err["worst_ratio"] <= 1.0, (name, err)
    o2, lse2 = fa.flash_fwd(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.requires_cuda
def test_sm90_and_old_kernel_agree_at_the_main_shape():
    """The old kernel, asked for by name, on the same input: the same
    function within the bf16 bound."""
    _need_cuda()
    q, k, v = _card_operands(*MAIN, False)
    before = _routes()
    o, lse = fa.flash_fwd(q, k, v)
    o1, lse1 = fa.flash_fwd(q, k, v, route="sm80")
    assert _routes() == {"sm90": before["sm90"] + 1, "sm80": before["sm80"] + 1}
    assert fa.kernel_error(o, o1)["worst_ratio"] <= 1.0
    assert fa.kernel_error(lse, lse1)["worst_ratio"] <= 1.0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["f32", "misaligned", "padded_rows"])
def test_old_cases_keep_the_old_route(case):
    """f32, a bf16 q 2 bytes past an aligned base and bf16 rows whose
    strides are not 16-byte multiples still launch fwd_kernel, and agree
    with the plain version."""
    _need_cuda()
    b, s, h, d = 1, 150, 2, 96
    if case == "f32":
        q, k, v = _card_operands(b, s, h, d, False, torch.float32)
    elif case == "misaligned":
        _, k, v = _card_operands(b, s, h, d, False)
        buf = torch.randn((b * s * h * d + 8,), device="cuda").bfloat16()
        q = buf[1:1 + b * s * h * d].view(b, s, h, d)
    else:
        q, k, v = (torch.randn((b, s, h, d + 4), device="cuda").bfloat16()[..., :d]
                   for _ in range(3))
    before = _routes()
    o, lse = fa.flash_fwd(q, k, v)
    assert _routes() == {"sm90": before["sm90"], "sm80": before["sm80"] + 1}
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, 64, 64)
    assert fa.kernel_error(o, o_ref)["worst_ratio"] <= 1.0
    assert fa.kernel_error(lse, lse_ref)["worst_ratio"] <= 1.0
