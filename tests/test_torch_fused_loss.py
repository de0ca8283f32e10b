"""The port's fused cross entropy (plain versions, on the CPU) against the
JAX package's Pallas fused cross entropy in interpret mode.

Inputs are drawn with numpy from a seed; both packages get the same
values. Tolerances, those of ``tests/test_fused_loss.py``: float32 losses
at ``2e-5`` (atol and rtol; the same online logsumexp, summed in another
order), float32 dh and dW at ``atol 5e-6, rtol 5e-5``; bfloat16 losses,
dh and dW at ``0.05`` (bf16 rounds the operands and the casts of dS, ulp
2^-8, in both). The backward written by hand is also held to the true
gradient by ``torch.autograd.gradcheck`` in float64, and the bound that
holds each kernel to its plain version on the card is tried against
planted faults.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import fused_loss as tfl
from pytorch_distributed_training_tutorials_tpu_torch.ops._check import kernel_error
from helpers import requires_pallas_interpret

jfl = importlib.import_module("pytorch_distributed_training_tutorials_tpu.ops.fused_loss")

pytestmark = requires_pallas_interpret

SHAPES = [
    # (N, D, V, block_n, block_v)
    (48, 32, 64, 16, 16),  # multi-block, block-divisible
    (37, 24, 50, 16, 16),  # ragged rows and vocab tail
    (20, 16, 40, 512, 512),  # one block clamped to the padded sizes
    (33, 40, 130, 16, 32),  # unequal blocks, ragged against both
]
IDS = ["multiblock", "ragged", "clamped", "unequal"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, d, v, seed=0, oor=False):
    rng = np.random.Generator(np.random.PCG64(seed))
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * d ** -0.5).astype(np.float32)
    y = rng.integers(0, v, (n,)).astype(np.int32)
    if oor:
        y[1] = v + 3  # hits nothing: its loss is the lse
    gr = rng.standard_normal((n,)).astype(np.float32)
    return h, w, y, gr


def _run_both(shape, dtype, oor=False):
    n, d, v, bn, bv = shape
    h, w, y, gr = _inputs(n, d, v, oor=oor)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jh, jw, jy = jnp.asarray(h, jd), jnp.asarray(w, jd), jnp.asarray(y)

    def jloss(h_, w_):
        out = jfl.fused_cross_entropy(h_, w_, jy, block_n=bn, block_v=bv, interpret=True)
        return jnp.sum(out * jnp.asarray(gr)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jh, jw)
    th = torch.tensor(h).to(td).requires_grad_(True)
    tw = torch.tensor(w).to(td).requires_grad_(True)
    tout = tfl.fused_cross_entropy(th, tw, torch.tensor(y), block_n=bn, block_v=bv)
    (tout * torch.tensor(gr)).sum().backward()
    assert tout.dtype == torch.float32 and th.grad.dtype == td and tw.grad.dtype == td
    want = [np.asarray(x, np.float32) for x in (jout, *jgrads)]
    got = [x.detach().float().numpy() for x in (tout, th.grad, tw.grad)]
    return want, got


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_losses_dh_dw_match_jax(shape):
    want, got = _run_both(shape, "f32")
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=2e-5, err_msg="loss")
    for name, a, b in zip(("dh", "dw"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=5e-6, rtol=5e-5, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES[1:3], ids=IDS[1:3])
def test_bf16_losses_dh_dw_match_jax(shape):
    want, got = _run_both(shape, "bf16")
    for name, a, b in zip(("loss", "dh", "dw"), got, want):
        np.testing.assert_allclose(a, b, atol=0.05, rtol=0.05, err_msg=name)


def test_target_out_of_range_hits_nothing():
    """A target out of [0, V) scores no column: its loss is the lse, its
    dS has no -1, in both packages."""
    want, got = _run_both(SHAPES[1], "f32", oor=True)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=5e-6, rtol=5e-5)
    n, d, v, bn, bv = SHAPES[1]
    h, w, y, _ = _inputs(n, d, v, oor=True)
    lse, tgt = tfl.fused_ce_fwd_reference(torch.tensor(h), torch.tensor(w), torch.tensor(y), bn, bv)
    assert float(tgt[1]) == 0.0
    assert float(lse[1]) == pytest.approx(float(torch.logsumexp(torch.tensor(h[1] @ w), 0)),
                                          rel=1e-6)


def test_reference_matches_jax_reference():
    n, d, v, _, _ = SHAPES[1]
    h, w, y, _ = _inputs(n, d, v, seed=3)
    want = np.asarray(jfl.fused_cross_entropy_reference(jnp.asarray(h), jnp.asarray(w),
                                                        jnp.asarray(y)))
    got = tfl.fused_cross_entropy_reference(torch.tensor(h), torch.tensor(w), torch.tensor(y))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    fused = tfl.fused_cross_entropy(torch.tensor(h), torch.tensor(w), torch.tensor(y),
                                    block_n=16, block_v=16)
    np.testing.assert_allclose(fused.numpy(), want, atol=2e-5, rtol=2e-5)


def test_gradcheck_float64():
    h, w, y, _ = _inputs(11, 8, 20, seed=5, oor=True)
    th = torch.tensor(h, dtype=torch.float64, requires_grad=True)
    tw = torch.tensor(w, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: tfl.fused_cross_entropy(a, b, torch.tensor(y), block_n=8, block_v=8),
        (th, tw))


def test_leading_shape_and_cpu_calls_count_no_launch():
    before = dict(tfl.fused_cross_entropy.launches)
    h, w, y, _ = _inputs(12, 8, 20)
    out = tfl.fused_cross_entropy(torch.tensor(h).reshape(3, 4, 8), torch.tensor(w),
                                  torch.tensor(y).reshape(3, 4))
    assert out.shape == (3, 4)
    assert tfl.fused_cross_entropy.launches == before
    with pytest.raises(ValueError, match="mismatch"):
        tfl.fused_cross_entropy(torch.tensor(h), torch.tensor(w), torch.tensor(y)[:5])
    meta = torch.empty((12, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfl.fused_ce_fwd(meta, torch.empty((8, 20), device="meta"),
                         torch.empty((12,), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        tfl.fused_ce_fwd(torch.tensor(h), torch.empty((8, 20), device="meta"), torch.tensor(y))


# The bound that holds each kernel output to its plain version on the card
# (``_check.KERNEL_TOLERANCE``), tried on the CPU at the 760m hidden width
# with a vocab tail against the kernels' 128-column tiles: outputs that
# differ from the plain version the way a right kernel does pass it;
# outputs of a kernel with a planted fault fail it in every output the
# fault reaches. Right: the plain versions with the kernels' tiles (64
# rows, 128 columns) and the function in float64 over the whole logits.
# Faults: a vocab block skipped by the late rows; the vocab tail padded to
# a tile multiple without its -inf mask (padded columns score 0); every
# target hit one column off. A bf16 dh or dW row is held at 2^-5 of its
# rms, which the target column's -W[:, y] term dominates, so the tail's
# ~1% shift of the softmax part shows only in the (f32) lse there.
BOUND_SHAPE = (512, 1536, 4000)
BOUND_CASES = ["tiles", "dense64", "skip_vblock", "tail_unmasked", "target_shift"]
REACHES = {
    "skip_vblock": {torch.bfloat16: ("lse", "tgt", "dh", "dw"),
                    torch.float32: ("lse", "tgt", "dh", "dw")},
    "tail_unmasked": {torch.bfloat16: ("lse",), torch.float32: ("lse", "dh", "dw")},
    "target_shift": {torch.bfloat16: ("tgt", "dh", "dw"),
                     torch.float32: ("tgt", "dh", "dw")},
}


def _plain_outputs(h, w, y, g, bn, bv):
    lse, tgt = tfl.fused_ce_fwd_reference(h, w, y, bn, bv)
    return {"lse": lse, "tgt": tgt, "dh": tfl.fused_ce_dh_reference(h, w, y, lse, g, bn, bv),
            "dw": tfl.fused_ce_dw_reference(h, w, y, lse, g, bn, bv)}


def _dense_outputs(h, w, y, g, keep=None, pad=0, shift=0):
    """The function in float64 over the whole logits, the casts of dS to
    W's and h's types kept, each output rounded once: columns out of
    ``keep`` are skipped (no score, no target hit), ``pad`` zero columns
    score 0, ``shift`` moves every target."""
    hd, wd = h.double(), w.double()
    s = hd @ wd
    if keep is None:
        keep = torch.ones(s.shape, dtype=torch.bool)
    if pad:
        s = torch.cat([s, torch.zeros((s.shape[0], pad), dtype=s.dtype)], 1)
        keep = torch.cat([keep, torch.ones((s.shape[0], pad), dtype=torch.bool)], 1)
    onehot = torch.nn.functional.one_hot(y + shift, s.shape[1]).double() * keep
    tgt = (s * onehot).sum(-1)
    s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1)
    ds = ((torch.exp(s - lse[:, None]) - onehot) * g.double()[:, None])[:, :w.shape[1]]
    dh = ds.to(w.dtype).double() @ wd.T
    dw = hd.T @ ds.to(h.dtype).double()
    return {"lse": lse.float(), "tgt": tgt.float(), "dh": dh.to(h.dtype), "dw": dw.to(w.dtype)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", BOUND_CASES)
def test_kernel_bound_passes_right_outputs_and_fails_planted_faults(case, dtype):
    n, d, v = BOUND_SHAPE
    rng = np.random.Generator(np.random.PCG64(7))
    h = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32).to(dtype)
    w = torch.tensor(rng.standard_normal((d, v)) * d ** -0.5, dtype=torch.float32).to(dtype)
    y = torch.tensor(rng.integers(0, v - 1, (n,)))
    y[-8:] = 130  # late rows whose targets lie in the skipped block
    g = torch.full((n,), 1.0 / n)
    ref = _plain_outputs(h, w, y, g, 512, 512)  # the chip check's plain blocks
    if case == "tiles":
        got = _plain_outputs(h, w, y, g, 64, 128)
    elif case == "dense64":
        got = _dense_outputs(h, w, y, g)
    elif case == "skip_vblock":
        keep = torch.ones((n, v), dtype=torch.bool)
        keep[n // 2:, 128:256] = False
        got = _dense_outputs(h, w, y, g, keep=keep)
    elif case == "tail_unmasked":
        got = _dense_outputs(h, w, y, g, pad=-v % 128)
    else:
        got = _dense_outputs(h, w, y, g, shift=1)
    ratios = {k: kernel_error(got[k], ref[k])["worst_ratio"] for k in ref}
    if case in REACHES:
        reached = REACHES[case][dtype]
        assert min(ratios[k] for k in reached) > 1.0, ratios
    else:
        assert max(ratios.values()) <= 0.6, ratios
