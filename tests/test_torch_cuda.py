"""Tests of the PyTorch port that need the card (marked ``requires_cuda``).

They skip where ``torch.cuda.is_available()`` is false (decided inside
each test, never at import). This file imports no jax, so it also runs on
a GPU machine without jax — there, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` imports jax).
"""

import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import quant

pytestmark = pytest.mark.requires_cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize(
    "m,k,n",
    [(4, 2048, 2048), (3, 200, 130), (5, 201, 67), (64, 2048, 32000), (1, 64, 40)],
)
def test_kernel_matches_plain_version(m, k, n):
    """The hand-written kernel against its plain version on the card,
    bitwise, and one launch counted per call."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(m * 7 + k)
    x = torch.randn((m, k), generator=gen, device="cuda")
    qp = quant.quantize_int8(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
    w = quant.Int8Param(q=qp.q.t().contiguous().t(), scale=qp.scale)
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, w)
    assert quant.int8_matmul.launches == before + 1
    assert torch.equal(got, quant.int8_matmul_reference(x, w))


def test_kernel_refuses_row_major_weight():
    _need_cuda()
    x = torch.randn((2, 64), device="cuda")
    qp = quant.quantize_int8(torch.randn((64, 32), device="cuda"))
    with pytest.raises(ValueError, match="K-contiguous"):
        quant.int8_matmul(x, qp)


def test_serve_selftest_on_cuda():
    """The toy serving stream on the card: token-exact against generate,
    sync budget held, every projection through the kernel."""
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.serve.__main__ import selftest

    before = quant.int8_matmul.launches
    receipt = selftest("cuda")
    assert receipt["ok"], receipt["problems"]
    assert quant.int8_matmul.launches > before


FLASH_CASES = [
    # (B, S, H, D, dtype, row padding of the storage: 0 = contiguous)
    (2, 256, 4, 96, torch.bfloat16, 0),
    (1, 200, 2, 32, torch.float32, 0),  # ragged against the 64-row tiles
    (1, 8, 2, 128, torch.bfloat16, 0),
    (2, 130, 3, 24, torch.float32, 0),  # D not a multiple of 16
    (2, 130, 3, 24, torch.bfloat16, 0),  # bf16 head dim padded to 32
    (1, 150, 2, 96, torch.bfloat16, 4),  # strides not 16-byte multiples
]


@pytest.mark.parametrize("b,s,h,d,dtype,pad", FLASH_CASES)
def test_flash_kernels_match_plain_versions(b, s, h, d, dtype, pad):
    """The forward, dq and dk/dv kernels against their plain versions on
    the same inputs; one launch counted per call. Each output is held
    element by element to ``fa.KERNEL_TOLERANCE`` (bf16 runs on the tensor
    cores, f32 through the same kernels on the CUDA cores)."""
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v, do = (torch.randn((b, s, h, d + pad), generator=gen, device="cuda",
                               dtype=dtype)[..., :d] for _ in range(4))
    before = dict(fa.flash_attention.launches)
    o, lse = fa.flash_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
    assert fa.flash_attention.launches == {n: before[n] + 1 for n in before}
    want = [*fa.flash_fwd_reference(q, k, v, 64, 64),
            fa.flash_dq_reference(q, k, v, do, lse, delta, 64, 64),
            *fa.flash_dkv_reference(q, k, v, do, lse, delta, 64, 64)]
    for name, got, ref in zip(("O", "lse", "dq", "dk", "dv"), (o, lse, dq, dk, dv), want):
        err = fa.kernel_error(got, ref)
        assert err["worst_ratio"] <= 1.0, (name, err)


def test_flash_kernels_refuse_what_they_do_not_take():
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.ops import flash_attention as fa

    x = torch.randn((1, 16, 2, 20), device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_fwd(x, x, x)
    h = torch.randn((1, 16, 2, 16), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_fwd(h, h, h)


def test_flash_attention_trains_through_the_kernels():
    """A toy float LM step on the card: flash launches counted, remat
    "dots" recomputes the forward, loss finite."""
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.bench import lm_headline
    from pytorch_distributed_training_tutorials_tpu_torch.ops import flash_attention as fa

    before = dict(fa.flash_attention.launches)
    r = lm_headline.measure(lm_headline.parse(
        ["--preset", "smoke", "--seq", "128", "--steps", "2", "--reps", "1"]))
    steps = r["steps_run"]
    got = {n: fa.flash_attention.launches[n] - before[n] for n in before}
    assert got == {"fwd": 4 * steps, "dq": 2 * steps, "dkv": 2 * steps}
    assert r["all_losses_finite"]
