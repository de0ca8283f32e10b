"""The PyTorch port's int8 quantization and int8 matmul against the JAX
package's.

Inputs come from numpy with a fixed seed and go, as the same values, to
both packages. The JAX ``int8_matmul`` runs its Pallas kernel in interpret
mode here (it picks the mode itself off a TPU), as ``tests/test_quant.py``
runs it.

Tolerances and why:

- ``quantize_int8``: bitwise. Both compute absmax / 127 with a true
  division (JAX quantizes weights eagerly, op by op) and round half to
  even.
- ``int8_matmul`` against JAX's ``int8_matmul``: bitwise. Each tile's dot
  is an exact integer; the port follows the kernel's arithmetic as XLA
  executes it — the activation scale is a multiply by float32(1/127) (XLA
  folds the kernel's ``/ 127.0`` into it) and each tile is folded in by
  one fused multiply-add (XLA contracts ``acc + part * sx``).
- ``int8_matmul`` against JAX's ``int8_matmul_reference`` run eagerly:
  within a few float32 ulps per K tile, not bitwise. That function divides
  by 127 and rounds the product before the add, so the JAX kernel and the
  JAX reference differ from each other by the same amount (asserted below
  too). A one-ulp change of an activation scale could move one int8 code
  by a step; none does on these seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.ops import quant as jq
from pytorch_distributed_training_tutorials_tpu_torch.ops import quant as tq
from helpers import requires_pallas_interpret


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Toy widths gain nothing from intra-op threads; one thread keeps
    this file from competing for cores with the suite's other workers
    (the port's results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed, scale=1.0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize(
    "shape,channel_axis",
    [((256, 128), -1), ((300, 200), -1), ((64, 32), 0), ((4, 8, 96), -1)],
)
def test_quantize_int8_bitwise(shape, channel_axis):
    w = _np(shape, seed=1, scale=0.05)
    jp = jq.quantize_int8(w, channel_axis=channel_axis)
    tp = tq.quantize_int8(torch.from_numpy(w), channel_axis=channel_axis)
    assert tp.q.dtype == torch.int8
    np.testing.assert_array_equal(tp.q.numpy(), np.asarray(jp.q))
    np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))
    np.testing.assert_array_equal(
        tp.dequantize().numpy(), np.asarray(jp.dequantize())
    )


MATMUL_CASES = [
    (48, 256, 128),   # one tile, M not a multiple of 8
    (7, 200, 130),    # ragged M/N/K: K pads to a 256 tile
    (5, 2048, 300),   # four 512 tiles, ragged N
    (3, 64, 40),      # K < 128: a 128 tile
    (33, 1000, 257),  # ragged tail tile (1000 = 512 + 488)
]


@requires_pallas_interpret
@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_int8_matmul_bitwise_vs_jax_kernel(m, k, n):
    x = _np((m, k), seed=2)
    jp = jq.quantize_int8(_np((k, n), seed=3, scale=0.02))
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jp))
    tp = tq.Int8Param(
        q=torch.tensor(np.asarray(jp.q)),
        scale=torch.tensor(np.asarray(jp.scale)),
    )
    got = tq.int8_matmul(torch.from_numpy(x), tp)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the plain version is what a CPU call runs
    np.testing.assert_array_equal(
        tq.int8_matmul_reference(torch.from_numpy(x), tp).numpy(), want
    )
    # the kernel's layout: q as a K-contiguous view of an (N, K) tensor
    tpt = tq.Int8Param(q=tp.q.t().contiguous().t(), scale=tp.scale)
    np.testing.assert_array_equal(
        tq.int8_matmul(torch.from_numpy(x), tpt).numpy(), want
    )


@requires_pallas_interpret
@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_int8_matmul_vs_jax_eager_reference(m, k, n):
    x = _np((m, k), seed=4)
    jp = jq.quantize_int8(_np((k, n), seed=5, scale=0.02))
    ref = np.asarray(jq.int8_matmul_reference(jnp.asarray(x), jp))
    kern = np.asarray(jq.int8_matmul(jnp.asarray(x), jp))
    tp = tq.Int8Param(
        q=torch.tensor(np.asarray(jp.q)),
        scale=torch.tensor(np.asarray(jp.scale)),
    )
    got = tq.int8_matmul(torch.from_numpy(x), tp).numpy()
    n_tiles = -(-k // tq.block_k_for(k))
    tol = 4 * n_tiles * np.finfo(np.float32).eps * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol
    assert np.abs(kern - ref).max() <= tol


@pytest.mark.parametrize("k", [1, 64, 127, 128, 129, 200, 384, 511, 512, 513, 2048, 8192])
def test_block_k_matches_jax_rule(k):
    bk = min(512, max(128, k))
    assert tq.block_k_for(k) == -(-bk // 128) * 128


def test_bad_scale_shape_raises():
    """Per-row scales (channel_axis=0) are not per-output-column: both
    packages refuse them."""
    w = _np((64, 32), seed=6)
    x = _np((4, 64), seed=7)
    jp = jq.quantize_int8(w, channel_axis=0)
    with pytest.raises(ValueError, match="per-output-column"):
        jq.int8_matmul(jnp.asarray(x), jp)
    tp = tq.quantize_int8(torch.from_numpy(w), channel_axis=0)
    with pytest.raises(ValueError, match="per-output-column"):
        tq.int8_matmul(torch.from_numpy(x), tp)


def test_kernel_operand_checks():
    """What the CUDA kernel does not take is refused before a launch (the
    checks are device-independent, so the CPU can run them)."""
    x = torch.from_numpy(_np((4, 64), seed=8))
    qp = tq.quantize_int8(torch.from_numpy(_np((64, 32), seed=9)))
    good = tq.Int8Param(q=qp.q.t().contiguous().t(), scale=qp.scale)
    tq._check_cuda_args(x, good)
    with pytest.raises(ValueError, match="K-contiguous"):
        tq._check_cuda_args(x, qp)  # row-major (K, N)
    with pytest.raises(ValueError, match="contiguous"):
        tq._check_cuda_args(torch.from_numpy(_np((64, 4), seed=8)).t(), good)
    with pytest.raises(TypeError, match="float32 x"):
        tq._check_cuda_args(x.double(), good)
    with pytest.raises(TypeError, match="int8 q"):
        tq._check_cuda_args(x, tq.Int8Param(q=good.q.float(), scale=good.scale))


def test_int8_linear_flattens_like_dense_general():
    """Int8Linear over (H, D) features and over an (H, D) input equals the
    2-D matmul on the flattened shapes."""
    x = torch.from_numpy(_np((2, 3, 64), seed=10))
    lin = tq.Int8Linear(64, (4, 16))
    qp = tq.quantize_int8(torch.from_numpy(_np((64, 64), seed=11, scale=0.05)))
    lin.qt.copy_(qp.q.t())
    lin.scale.copy_(qp.scale)
    y = lin(x)
    assert y.shape == (2, 3, 4, 16)
    flat = tq.int8_matmul(x.reshape(6, 64), qp).reshape(2, 3, 4, 16)
    assert torch.equal(y, flat)
    o = tq.Int8Linear((4, 16), 64, n_in=2)
    o.qt.copy_(qp.q.t())
    o.scale.copy_(qp.scale)
    assert o(y).shape == (2, 3, 64)
