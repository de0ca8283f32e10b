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
