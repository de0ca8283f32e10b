"""The PyTorch port's paged attention and KV quantization against the JAX
package's.

Inputs come from numpy with a fixed seed and go, as the same values, to
both packages. The JAX ``paged_attention`` runs its Pallas kernel in
interpret mode here (it picks the mode itself off a TPU), as
``tests/test_paged_attention.py`` runs it.

- The port's plain ``paged_attention`` (what its wrapper runs for a CPU
  tensor) against the JAX kernel and against both packages' gather
  oracles, at ``tests/test_paged_attention.py``'s tolerances: f32 2e-5
  absolute + 1e-5 relative (sums in other orders); bf16 3e-2 + 1e-2 (both
  round p and the output to bf16 from f32 values that differ in the last
  bits). Cases: ragged depths, GQA, an S 4 chunk (the causal staircase),
  int8 and int4 pools, f32 and bf16, and a parked row (all sentinel),
  which must come out as exact zeros.
- The int4 helpers: pack, unpack and quantize bitwise the JAX package's,
  dequantize equal to it.
- The KV quantizers hold to what the JAX engine STORES, which runs them
  inside a jit: there XLA turns ``/ 127.0`` (int8) and ``/ 7.0`` (int4)
  into multiplies by the float32 reciprocals, and the int8 scale then
  differs from the eager function's in the last bit for some inputs. The
  port matches the jitted form bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.ops.paged_attention import (
    paged_attention as j_paged_attention,
    paged_attention_reference as j_paged_reference,
)
from pytorch_distributed_training_tutorials_tpu.ops import quant as jq
from pytorch_distributed_training_tutorials_tpu_torch.models import transformer as tt
from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as tpa
from pytorch_distributed_training_tutorials_tpu_torch.ops import quant as tq
from helpers import requires_pallas_interpret


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Toy widths gain nothing from intra-op threads; one thread keeps
    this file from competing for cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed, b, s, h, kv, d, page_size, p_cap, n_pages, quant=None):
    """numpy inputs with RAGGED depths and sentinel tails (the JAX test's
    recipe): row i holds ceil((pos[i] + s) / page_size) distinct live
    pages, the sentinel n_pages beyond. Quantized pools come from the JAX
    package's quantizers. Returns numpy q, k, v, table, pos and kwargs."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = np.linspace(0, p_cap * page_size - s - 1, b).astype(np.int32)
    kf = rng.standard_normal((n_pages, page_size, kv, d)).astype(np.float32)
    vf = rng.standard_normal((n_pages, page_size, kv, d)).astype(np.float32)
    table = np.full((b, p_cap), n_pages, np.int32)
    free = list(rng.permutation(n_pages))
    for i in range(b):
        for p in range(min(-(-(int(pos[i]) + s) // page_size), p_cap)):
            table[i, p] = free.pop()
    kw = {}
    if quant == "int8":
        (k, ks), (v, vs) = jt._quantize_kv(kf), jt._quantize_kv(vf)
        kw = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs), quant="int8")
    elif quant == "int4":
        (k, ks), (v, vs) = jq.quantize_kv_int4(kf), jq.quantize_kv_int4(vf)
        kw = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs), quant="int4")
    else:
        k, v = kf, vf
    return q, np.asarray(k), np.asarray(v), table, pos, kw


def _torch(x):
    if isinstance(x, str):
        return x
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _both(args, kw, dtype="f32"):
    """(JAX operands, port operands) from one numpy set; ``bf16`` casts q
    and exact pools to bfloat16 in both."""
    q, k, v, table, pos = args
    jx = [jnp.asarray(a) for a in (q, k, v, table, pos)]
    if dtype == "bf16":
        jx[0] = jx[0].astype(jnp.bfloat16)
        if not kw:
            jx[1], jx[2] = jx[1].astype(jnp.bfloat16), jx[2].astype(jnp.bfloat16)
    jkw = {n: jnp.asarray(a) if not isinstance(a, str) else a for n, a in kw.items()}
    tx = [_torch(np.asarray(a, np.float32)).to(torch.bfloat16)
          if a.dtype == jnp.bfloat16 else _torch(np.asarray(a)) for a in jx]
    tkw = {n: _torch(a) for n, a in jkw.items()}
    return (jx, jkw), (tx, tkw)


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


CASES = {
    # name: (seed, b, s, h, kv, d, page_size, p_cap, n_pages, quant, dtype)
    "ragged_base": (0, 4, 1, 4, 4, 16, 8, 4, 24, None, "f32"),
    "gqa": (1, 3, 1, 8, 2, 16, 8, 3, 16, None, "f32"),
    "chunk_s4": (2, 2, 4, 4, 4, 16, 8, 4, 16, None, "f32"),
    "int8": (4, 3, 1, 4, 2, 16, 8, 3, 16, "int8", "f32"),
    "int4": (4, 3, 1, 4, 2, 16, 8, 3, 16, "int4", "f32"),
    "int8_gqa_chunk": (8, 2, 3, 8, 2, 32, 8, 4, 16, "int8", "f32"),
    "int4_gqa_chunk": (8, 2, 3, 8, 2, 32, 8, 4, 16, "int4", "f32"),
    "bf16_page16_gqa": (7, 3, 2, 8, 2, 32, 16, 3, 16, None, "bf16"),
    "bf16_int8": (9, 3, 1, 8, 2, 32, 8, 3, 16, "int8", "bf16"),
}
TOL = {"f32": dict(atol=2e-5, rtol=1e-5), "bf16": dict(atol=3e-2, rtol=1e-2)}


@requires_pallas_interpret
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_kernel_and_references(case):
    """The port's plain version against the JAX kernel (interpret mode)
    and both gather oracles; the port's oracle against JAX's."""
    seed, b, s, h, kv, d, ps, p_cap, n_pages, quant, dt = CASES[case]
    q, k, v, table, pos, kw = _setup(seed, b, s, h, kv, d, ps, p_cap, n_pages, quant)
    (jx, jkw), (tx, tkw) = _both((q, k, v, table, pos), kw, dt)
    got = tpa.paged_attention(*tx, **tkw)  # CPU tensors: the plain version
    assert got.dtype == tx[0].dtype and got.shape == (b, s, h, d)
    j_kernel = j_paged_attention(*jx, **jkw)
    j_ref = j_paged_reference(*jx, **jkw)
    t_ref = tpa.paged_attention_reference(*tx, **tkw)
    tol = TOL[dt]
    np.testing.assert_allclose(_np32(got), _np32(j_kernel), **tol)
    np.testing.assert_allclose(_np32(got), _np32(j_ref), **tol)
    np.testing.assert_allclose(_np32(got), _np32(t_ref), **tol)
    np.testing.assert_allclose(_np32(t_ref), _np32(j_ref), **tol)
    assert tpa.paged_attention.launches == 0


@requires_pallas_interpret
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_parked_row_gives_exact_zeros(quant):
    """A row whose table is all sentinel (a parked slot) has l == 0: the
    safe divide gives exact zeros, never NaN, in both packages; the other
    rows are unaffected."""
    q, k, v, table, pos, kw = _setup(3, 3, 1, 4, 4, 16, 8, 3, 12, quant)
    table[1] = 12
    (jx, jkw), (tx, tkw) = _both((q, k, v, table, pos), kw)
    got = _np32(tpa.paged_attention(*tx, **tkw))
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))
    want = _np32(j_paged_attention(*jx, **jkw))
    np.testing.assert_array_equal(want[1], got[1])
    np.testing.assert_allclose(got, want, **TOL["f32"])


def test_pos_may_be_int64_and_past_the_window():
    """The port's cache positions are int64; a parked row keeps stepping
    past its window. Neither changes what the live rows see."""
    q, k, v, table, pos, _ = _setup(5, 2, 1, 4, 4, 16, 8, 3, 12)
    tx = [torch.from_numpy(a) for a in (q, k, v, table, pos)]
    base = tpa.paged_attention(*tx)
    pos64 = tx[4].to(torch.int64)
    np.testing.assert_array_equal(tpa.paged_attention(*tx[:4], pos64).numpy(), base.numpy())
    tbl = tx[3].clone()
    tbl[1] = 12
    far = pos64.clone()
    far[1] = 10_000
    out = tpa.paged_attention(*tx[:3], tbl, far)
    np.testing.assert_array_equal(out[0].numpy(), base[0].numpy())
    assert not out[1].any()


def test_argument_checks():
    q, k, v, table, pos, kw = _setup(6, 2, 1, 4, 2, 16, 8, 2, 8, "int8")
    tx = [torch.from_numpy(np.array(a)) for a in (q, k, v, table, pos)]
    ks, vs = (torch.from_numpy(np.array(kw[n])) for n in ("k_scale", "v_scale"))
    with pytest.raises(ValueError, match="quant must be"):
        tpa.paged_attention(*tx, k_scale=ks, v_scale=vs, quant="int2")
    with pytest.raises(ValueError, match="required exactly"):
        tpa.paged_attention(*tx, quant="int8")
    with pytest.raises(ValueError, match="required exactly"):
        tpa.paged_attention(*tx, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(*tx, k_scale=ks, v_scale=vs, quant="int4")
    with pytest.raises(ValueError, match="multiple of kv_heads"):
        tpa.paged_attention(tx[0][:, :, :3], *tx[1:], k_scale=ks, v_scale=vs, quant="int8")


# ---------------------------------------------------------------- int4


def test_pack_unpack_bitwise_jax():
    """pack -> unpack is the identity over [-8, 7]; both bitwise JAX's."""
    rng = np.random.default_rng(11)
    q = rng.integers(-8, 8, (5, 7, 3, 16)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape == (5, 7, 3, 8)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(
        tq.unpack_int4(packed).numpy(), np.asarray(jq.unpack_int4(jnp.asarray(packed.numpy()))))
    with pytest.raises(ValueError):
        tq.pack_int4(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize("seed", [13, 14])
def test_quantize_kv_int4_bitwise_jitted_jax(seed):
    """Codes and bf16 scales bitwise what the jitted JAX quantizer stores
    (which here equal the eager function's too); dequantize equals JAX's
    exactly, and is exactly code * scale."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, 9, 2, 16))
         * rng.uniform(1e-3, 10.0, (6, 9, 2, 1))).astype(np.float32)
    packed, scale = tq.quantize_kv_int4(torch.from_numpy(x))
    jp, js = jax.jit(jq.quantize_kv_int4)(jnp.asarray(x))
    ep, es = jq.quantize_kv_int4(jnp.asarray(x))
    assert packed.dtype == torch.uint8 and scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(scale.float().numpy(), np.asarray(js, np.float32))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ep))
    np.testing.assert_array_equal(scale.float().numpy(), np.asarray(es, np.float32))
    deq = tq.dequantize_kv_int4(packed, scale, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jq.dequantize_kv_int4(jp, js, jnp.float32)))
    np.testing.assert_array_equal(
        deq.numpy(), tq.unpack_int4(packed).float().numpy() * scale.float().numpy()[..., None])


def test_quantize_kv_int4_clips_saturated_values():
    x = torch.tensor([[7.0, -7.0, 0.5, -0.5] * 4])
    q = tq.unpack_int4(tq.quantize_kv_int4(x)[0])
    assert int(q.max()) <= 7 and int(q.min()) >= -7
    assert int(q[0, 0]) == 7 and int(q[0, 1]) == -7


def test_quantize_kv_int8_bitwise_jitted_jax():
    """The int8 KV scale is absmax * float32(1/127) — the jitted JAX
    quantizer's — and differs from the eager division on some inputs,
    which this draw includes; codes bitwise too."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 50, 4, 16))
         * rng.uniform(0.01, 10.0, (64, 50, 4, 1))).astype(np.float32)
    q, s = tt._quantize_kv(torch.from_numpy(x))
    jqv, js = jax.jit(jt._quantize_kv)(jnp.asarray(x))
    _, es = jt._quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s.numpy() != np.asarray(es)).any()  # the eager form is not what is stored
    deq = tt._dequantize_kv(q, s, torch.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jt._dequantize_kv(jqv, js, jnp.float32)))


@pytest.mark.parametrize("dtype,want", [
    (None, (torch.float32, 16, None)),
    (torch.bfloat16, (torch.bfloat16, 16, None)),
    (torch.int8, (torch.int8, 16, torch.float32)),
    ("int4", (torch.uint8, 8, torch.bfloat16)),
])
def test_kv_storage(dtype, want):
    """Storage of each ``kv_cache_dtype``: int4 packs D/2 bytes with bf16
    scales (half of int8's D + 4 f32-scale bytes per token-head)."""
    assert tt._kv_storage(dtype, 16) == want
    assert tt._kv_quant_mode(dtype) == {torch.int8: "int8", "int4": "int4"}.get(dtype)


@pytest.mark.parametrize("dtype", ["int2", "int8", torch.float16])
def test_kv_cache_dtype_refused(dtype):
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tt.TransformerConfig(kv_cache_dtype=dtype)
