"""The port's flash attention (plain versions, on the CPU) against the JAX
package's Pallas flash attention in interpret mode.

Inputs are drawn with numpy from a seed; both packages get the same
values. Tolerances, those of ``tests/test_flash_attention.py``: float32 O
at ``2e-5`` and dq/dk/dv at ``5e-5`` (atol and rtol; the same online
softmax, summed in another order), bfloat16 at ``0.05`` (bf16 rounds the
casts of p and ds, ulp 2^-8, in both); the logsumexp at ``2e-5``. The
backward written by hand is also held to the true gradient by
``torch.autograd.gradcheck`` in float64.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import flash_attention as tf
from helpers import requires_pallas_interpret

jf = importlib.import_module("pytorch_distributed_training_tutorials_tpu.ops.flash_attention")

pytestmark = requires_pallas_interpret

SHAPES = [
    # (B, S, H, D, block_q, block_k)
    (2, 256, 4, 64, 128, 128),  # multi-block, block-divisible
    (1, 200, 2, 32, 128, 128),  # ragged: the last block is short
    (1, 100, 2, 16, 512, 512),  # one block clamped to the padded length
    (1, 128, 2, 96, 64, 128),  # the 760m head dim, unequal blocks
    (1, 192, 2, 32, 64, 128),  # unequal blocks, ragged against block_k
]
IDS = ["multiblock", "ragged", "padded", "d96-unequal", "unequal"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, d, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4)]


def _run_both(shape, dtype):
    b, s, h, d, bq, bk = shape
    q, k, v, g = _inputs(b, s, h, d)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv, jg = (jnp.asarray(x, jd) for x in (q, k, v, g))

    def loss(q_, k_, v_):
        return jnp.sum((jf.flash_attention(q_, k_, v_, bq, bk) * jg).astype(jnp.float32))

    jo = jf.flash_attention(jq, jk, jv, bq, bk)
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    _, res = jf._flash_fwd(jq, jk, jv, bq, bk, True)
    jlse = np.asarray(res[4])[:, 0, :s].reshape(b, h, s)

    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_(True) for x in (q, k, v))
    to = tf.flash_attention(tq, tk, tv, bq, bk)
    (to.float() * torch.tensor(g).to(td).float()).sum().backward()
    _, tlse = tf.flash_fwd(tq.detach(), tk.detach(), tv.detach(), bq, bk)
    want = [jo, *jgrads]
    got = [to.detach(), tq.grad, tk.grad, tv.grad]
    return [np.asarray(w, np.float32) for w in want], [x.float().numpy() for x in got], jlse, tlse


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_forward_grads_and_lse_match_jax(shape):
    want, got, jlse, tlse = _run_both(shape, "f32")
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=2e-5, err_msg="O")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-5, err_msg=name)
    assert tlse.dtype == torch.float32 and tlse.shape == jlse.shape
    np.testing.assert_allclose(tlse.numpy(), jlse, atol=2e-5, rtol=2e-5, err_msg="lse")


@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[3:4], ids=[IDS[0], IDS[1], IDS[3]])
def test_bf16_forward_and_grads_match_jax(shape):
    want, got, jlse, tlse = _run_both(shape, "bf16")
    for name, a, b in zip(("O", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=0.05, rtol=0.05, err_msg=name)
    np.testing.assert_allclose(tlse.numpy(), jlse, atol=2e-5, rtol=2e-5, err_msg="lse")


def test_gradcheck_float64():
    """The hand-written backward (the plain dq and dk/dv) against the true
    gradient of the plain forward, in float64 at a tiny size with two
    blocks."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 12, 2, 8), generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tf.flash_attention(a, b, c, 8, 8), (q, k, v)
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_passes_opcheck(dtype):
    """``tpu_torch::flash_attention`` is a well-formed ``torch.library``
    op on CPU tensors (its schema, autograd registration, fake-tensor
    shapes and AOT dispatch, ``torch.library.opcheck``), and
    ``flash_attention`` returns its first output: O, with the lse the
    op's second, equal to the plain forward's."""
    q, k, v, _ = (torch.tensor(x, dtype=dtype).requires_grad_() for x in _inputs(1, 40, 2, 16))
    result = torch.library.opcheck(tf._flash_op, (q, k, v, 16, 16))
    assert set(result.values()) == {"SUCCESS"}, result
    o, lse = torch.ops.tpu_torch.flash_attention(q, k, v, 16, 16)
    want_o, want_lse = tf.flash_fwd_reference(q.detach(), k.detach(), v.detach(), 16, 16)
    assert torch.equal(o.detach(), want_o) and torch.equal(lse, want_lse)
    assert torch.equal(tf.flash_attention(q, k, v, 16, 16).detach(), want_o)


def test_matches_dense_causal_attention():
    """The plain forward equals the model's dense causal attention (the
    ``masked_attention`` contract) at float32 rounding."""
    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
        dense_causal_attention,
    )

    q, k, v = (torch.tensor(x) for x in _inputs(2, 72, 3, 24, seed=4)[:3])
    torch.testing.assert_close(tf.flash_attention(q, k, v, 32, 16),
                               dense_causal_attention(q, k, v), atol=2e-6, rtol=2e-5)


def test_cpu_calls_count_no_launch_and_other_devices_raise():
    before = dict(tf.flash_attention.launches)
    q, k, v, g = (torch.tensor(x, requires_grad=True) for x in _inputs(1, 16, 2, 8))
    (tf.flash_attention(q, k, v) * g).sum().backward()
    assert tf.flash_attention.launches == before
    meta = torch.empty((1, 16, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tf.flash_fwd(meta, meta, meta)
    with pytest.raises(ValueError, match="different devices"):
        tf.flash_fwd(q.detach(), k.detach(), meta)
    with pytest.raises(ValueError, match="expand GQA"):
        tf.flash_fwd(q.detach(), k.detach()[:, :, :1], v.detach())


# The bound that holds each kernel output to its plain version on the card
# (``KERNEL_TOLERANCE``), tried on the CPU at the 760m train step's length
# and head dim: outputs that differ from the plain version the way a right
# kernel does pass it, outputs of a kernel with a planted fault fail it in
# every output. Right: the plain versions with other blocks (the kernels
# tile by 64 keys and 64 queries, dk/dv by 32 queries; in the forward p
# is then taken against another running max and rounds differently).
# Faults: a key block skipped by the late
# query rows, one 32 x 64 tile of the dk/dv walk skipped, a scale 1% off.
BOUND_SHAPE = (1, 2048, 1, 96)
BOUND_CASES = ["tiles64", "tiles128x32", "skip_kblock", "skip_qtile", "scale_1pct"]
FAULTS = {"skip_kblock", "skip_qtile", "scale_1pct"}


def _plain_outputs(q, k, v, do, bq, bk):
    o, lse = tf.flash_fwd_reference(q, k, v, bq, bk)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = tf.flash_dq_reference(q, k, v, do, lse, delta, bq, bk)
    dk, dv = tf.flash_dkv_reference(q, k, v, do, lse, delta, bq, bk)
    return {"O": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def _dense_outputs(q, k, v, do, keep, scale_mul=1.0):
    """Attention in float64 over the (S, S) mask ``keep``, its gradients by
    autograd, each output rounded once to the input type."""
    qd, kd, vd = (x.double().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    s = (qd @ kd.transpose(-1, -2)) * (scale_mul / q.shape[-1] ** 0.5)
    s = s.masked_fill(~keep, float("-inf"))
    o = torch.softmax(s, -1) @ vd
    o.backward(do.double().transpose(1, 2))
    out = lambda x: x.detach().transpose(1, 2).to(q.dtype)  # noqa: E731
    return {"O": out(o), "lse": torch.logsumexp(s, -1).detach().float(),
            "dq": out(qd.grad), "dk": out(kd.grad), "dv": out(vd.grad)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", BOUND_CASES)
def test_kernel_bound_passes_right_outputs_and_fails_planted_faults(case, dtype):
    b, s, h, d = BOUND_SHAPE
    q, k, v, do = (torch.tensor(x).to(dtype) for x in _inputs(b, s, h, d, seed=7))
    ref = _plain_outputs(q, k, v, do, 1024, 1024)  # the chip check's plain blocks
    keep = torch.ones((s, s), dtype=torch.bool).tril()
    if case == "tiles64":
        got = _plain_outputs(q, k, v, do, 64, 64)
    elif case == "tiles128x32":
        got = _plain_outputs(q, k, v, do, 128, 32)
    elif case == "scale_1pct":
        got = _dense_outputs(q, k, v, do, keep, 1.01)
    else:
        if case == "skip_kblock":
            keep[s // 2:, 64:128] = False
        elif case == "skip_qtile":
            keep[s // 2:s // 2 + 32, :64] = False
        got = _dense_outputs(q, k, v, do, keep)
    ratios = {n: tf.kernel_error(got[n], ref[n])["worst_ratio"] for n in ref}
    if case in FAULTS:
        assert min(ratios.values()) > 1.0, ratios
    else:
        assert max(ratios.values()) <= 0.6, ratios
