"""The flash-attention backward's routes: the sm90 kernels
(``csrc/flash_attention_sm90.cu``: ``dq_sm90_kernel`` and
``dkv_sm90_kernel``, TMA and wgmma) and ``flash_attention.cu``'s
``dq_kernel`` and ``dkv_kernel``.

On the CPU these tests cover what surrounds the kernels: the route each of
``flash_dq`` and ``flash_dkv`` takes (the launch itself recorded, not run)
on the main shape, on a (B, H, S, D) storage seen as (B, S, H, D), on f32,
on a dO view 2 bytes past an aligned base, at an odd S and when the old
kernel is asked for by name; that CPU calls count no launch; and the plain
versions at the sm90 kernels' tiles (dq walks 64-key tiles, dk/dv 64-query
tiles) against the JAX package's Pallas flash attention gradients in
interpret mode, with the tolerances of ``tests/test_flash_attention.py``:
float32 at ``5e-5`` (atol and rtol; the same sums in another order),
bfloat16 at ``0.05`` (both round p and ds to bf16, ulp 2^-8).

The ``requires_cuda`` tests hold the sm90 dq and dk/dv to their plain
versions on the card under ``KERNEL_TOLERANCE[bfloat16]`` at every shape of
``SM90_CASES``, check that two calls are bitwise equal, count the routes,
hold the sm90 and old kernels to each other at the main shape, and check
that the calls the sm90 kernels do not take still go to the old ones.
Whether a card is present is decided inside each test. Only the JAX
parity tests import jax, inside the test; on a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m requires_cuda \\
        tests/test_torch_flash_bwd_sm90.py
"""

import importlib

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import flash_attention as fa
from test_torch_flash_sm90 import MAIN, SM90_CASES, _card_operands

KINDS = ("dq", "dkv")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _call(kind, q, k, v, do, lse, delta, **kw):
    fn = fa.flash_dq if kind == "dq" else fa.flash_dkv
    return fn(q, k, v, do, lse, delta, **kw)


# ---------------------------------------------------------------------------
# the route


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers with CPU tensors taken as if on the card: each launch
    is recorded as (kernel, route) and not run."""
    calls = []
    monkeypatch.setattr(fa, "_route", lambda *tensors: True)
    monkeypatch.setattr(fa, "_launch", lambda name, sm90, q, ptrs, layouts: calls.append(
        (name, "sm90" if sm90 else "sm80")))
    return calls


def _bwd_operands(b, s, h, d, dtype=torch.bfloat16, heads_major=False):
    """q, k, v, dO and the f32 lse and delta, uninitialized (nothing is
    computed from them)."""
    if heads_major:
        xs = [torch.empty((b, h, s, d), dtype=dtype).transpose(1, 2) for _ in range(4)]
    else:
        xs = [torch.empty((b, s, h, d), dtype=dtype) for _ in range(4)]
    rows = [torch.empty((b, h, s), dtype=torch.float32) for _ in range(2)]
    return (*xs, *rows)


def _misaligned_do(b, s, h, d):
    """dO one bf16 element into an aligned buffer: every stride fits, the
    base does not."""
    buf = torch.zeros(b * s * h * d + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    do = buf[1:1 + b * s * h * d].view(b, s, h, d)
    assert do.data_ptr() % 16 == 2
    return do


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case,want", [
    ("main", "sm90"),          # the 760m train step, bf16
    ("heads_major", "sm90"),   # (B, H, S, D) storage seen as (B, S, H, D)
    ("odd_s", "sm90"),         # lse and delta are loaded by threads: any S
    ("d128", "sm90"),          # the widest head the kernels instantiate
    ("f32", "sm80"),
    ("do_misaligned", "sm80"),
    ("sm80_by_name", "sm80"),
])
def test_backward_route(recorded, kind, case, want):
    b, s, h, d = MAIN
    if case == "odd_s":
        s = 999
    elif case == "d128":
        d = 128
    ops = list(_bwd_operands(b, s, h, d, torch.float32 if case == "f32" else torch.bfloat16,
                             heads_major=case == "heads_major"))
    if case == "do_misaligned":
        ops[3] = _misaligned_do(b, s, h, d)
    _call(kind, *ops, route="sm80" if case == "sm80_by_name" else None)
    assert recorded == [(kind, want)]


@pytest.mark.parametrize("kind", KINDS)
def test_backward_route_refuses_another_name(recorded, kind):
    with pytest.raises(ValueError, match="route"):
        _call(kind, *_bwd_operands(1, 16, 2, 32), route="sm90")
    assert recorded == []


def test_backward_route_reads_do():
    """dO takes part in the decision: a dO whose strides a TMA map cannot
    take sends the call to the old kernel even where q, k and v fit."""
    b, s, h, d = 1, 16, 2, 32
    q, k, v, do, _, _ = _bwd_operands(b, s, h, d)
    assert fa._use_sm90(q, k, v, None, do)
    padded = torch.empty((b, s, h, d + 4), dtype=torch.bfloat16)[..., :d]
    assert fa._use_sm90(q, k, v, None)
    assert not fa._use_sm90(q, k, v, None, padded)


def _toy(b, s, h, d, dtype, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [torch.tensor(rng.standard_normal((b, s, h, d)).astype(np.float32)).to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_calls_count_no_launch_and_no_route(kind):
    """The CPU path runs the plain version and counts no launch of either
    route."""
    q, k, v, do = _toy(1, 40, 2, 32, torch.bfloat16)
    o, lse = fa.flash_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    routes = {n: dict(r) for n, r in fa.flash_attention.routes.items()}
    launches = dict(fa.flash_attention.launches)
    got = _call(kind, q, k, v, do, lse, delta)
    assert fa.flash_attention.routes == routes
    assert fa.flash_attention.launches == launches
    ref = (fa.flash_dq_reference if kind == "dq" else fa.flash_dkv_reference)(
        q, k, v, do, lse, delta)
    for a, r in zip(got if kind == "dkv" else (got,), ref if kind == "dkv" else (ref,)):
        assert torch.equal(a, r)


# ---------------------------------------------------------------------------
# the plain versions at the sm90 kernels' tiles against the JAX package

PARITY = [
    # (B, S, H, D, dtype)
    (1, 256, 2, 96, "f32"),   # the 760m head dim, two 128-row blocks
    (1, 256, 2, 96, "bf16"),
    (2, 200, 2, 40, "f32"),   # ragged S, D padded to 64 by the kernels
    (2, 200, 2, 40, "bf16"),
]


@pytest.fixture(scope="module")
def jax_flash():
    helpers = importlib.import_module("helpers")
    if not helpers.pallas_interpret_available():
        pytest.skip("Pallas Mosaic-interpret mode unavailable on this host")
    return importlib.import_module("pytorch_distributed_training_tutorials_tpu.ops.flash_attention")


@pytest.mark.parametrize("b,s,h,d,dt", PARITY)
def test_backward_at_kernel_tiles_matches_jax(jax_flash, b, s, h, d, dt):
    """dq through 64-key tiles and dk/dv through 64-query tiles (the sm90
    kernels' walks; 128-row blocks) against jax.grad of the JAX package's
    flash attention with (128, 64) blocks, dO the cotangent."""
    import jax
    import jax.numpy as jnp

    jd, td = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    q, k, v, do = _toy(b, s, h, d, td, seed=s + d)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jd) for x in (q, k, v, do))

    def loss(q_, k_, v_):
        return jnp.sum((jax_flash.flash_attention(q_, k_, v_, 128, 64) * jdo).astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    o, lse = fa.flash_fwd_reference(q, k, v, 128, 64)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_dq_reference(q, k, v, do, lse, delta, 128, 64)
    dk, dv = fa.flash_dkv_reference(q, k, v, do, lse, delta, 64, 128)
    tol = 5e-5 if dt == "f32" else 0.05
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32),
                                   atol=tol, rtol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# on the card


def _routes(kind):
    return dict(fa.flash_attention.routes[kind])


def _card_backward(b, s, h, d, heads_major, dtype=torch.bfloat16):
    q, k, v = _card_operands(b, s, h, d, heads_major, dtype)
    gen = torch.Generator(device="cuda").manual_seed(7 * s + d)
    if heads_major:
        do = torch.randn((b, h, s, d), generator=gen, device="cuda", dtype=dtype).transpose(1, 2)
    else:
        do = torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=dtype)
    o, lse = fa.flash_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _outputs(kind, got):
    return dict(zip(("dk", "dv"), got)) if kind == "dkv" else {"dq": got}


def _plain(kind, *ops):
    ref = (fa.flash_dq_reference if kind == "dq" else fa.flash_dkv_reference)(*ops, 64, 64)
    return _outputs(kind, ref)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,s,h,d,heads_major", SM90_CASES)
def test_sm90_backward_matches_plain_version(kind, b, s, h, d, heads_major):
    """dq, dk and dv through the sm90 kernels, each held element by element
    to the plain version under KERNEL_TOLERANCE[bfloat16]; one sm90 launch
    counted per call; a second call bitwise equal."""
    _need_cuda()
    ops = _card_backward(b, s, h, d, heads_major)
    before = _routes(kind)
    got = _outputs(kind, _call(kind, *ops))
    assert _routes(kind) == {"sm90": before["sm90"] + 1, "sm80": before["sm80"]}
    ref = _plain(kind, *ops)
    for name in got:
        assert got[name].dtype == ref[name].dtype and got[name].shape == ref[name].shape
        err = fa.kernel_error(got[name], ref[name])
        assert err["worst_ratio"] <= 1.0, (name, err)
    again = _outputs(kind, _call(kind, *ops))
    assert all(torch.equal(got[n], again[n]) for n in got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", KINDS)
def test_sm90_backward_at_an_odd_s(kind):
    """S 999: lse and delta rows that no 16-byte copy could take, on the
    sm90 route."""
    _need_cuda()
    ops = _card_backward(1, 999, 2, 96, False)
    before = _routes(kind)
    got = _outputs(kind, _call(kind, *ops))
    assert _routes(kind)["sm90"] == before["sm90"] + 1
    ref = _plain(kind, *ops)
    for name in got:
        assert fa.kernel_error(got[name], ref[name])["worst_ratio"] <= 1.0, name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", KINDS)
def test_sm90_and_old_backward_agree_at_the_main_shape(kind):
    """The old kernel, asked for by name, on the same input: the same
    function within the bf16 bound."""
    _need_cuda()
    ops = _card_backward(*MAIN, False)
    before = _routes(kind)
    new = _outputs(kind, _call(kind, *ops))
    old = _outputs(kind, _call(kind, *ops, route="sm80"))
    assert _routes(kind) == {"sm90": before["sm90"] + 1, "sm80": before["sm80"] + 1}
    for name in new:
        assert fa.kernel_error(new[name], old[name])["worst_ratio"] <= 1.0, name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", ["f32", "do_misaligned", "padded_rows"])
def test_old_backward_cases_keep_the_old_route(kind, case):
    """f32, a bf16 dO 2 bytes past an aligned base and bf16 rows whose
    strides are not 16-byte multiples still launch the old kernels, and
    agree with the plain version."""
    _need_cuda()
    b, s, h, d = 1, 150, 2, 96
    if case == "padded_rows":
        q, k, v, do = (torch.randn((b, s, h, d + 4), device="cuda").bfloat16()[..., :d]
                       for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        ops = (q, k, v, do, lse, delta)
    else:
        ops = list(_card_backward(b, s, h, d, False,
                                  torch.float32 if case == "f32" else torch.bfloat16))
        if case == "do_misaligned":
            buf = torch.randn((b * s * h * d + 8,), device="cuda").bfloat16()
            ops[3] = buf[1:1 + b * s * h * d].view(b, s, h, d)
    before = _routes(kind)
    got = _outputs(kind, _call(kind, *ops))
    assert _routes(kind) == {"sm90": before["sm90"], "sm80": before["sm80"] + 1}
    ref = _plain(kind, *ops)
    for name in got:
        assert fa.kernel_error(got[name], ref[name])["worst_ratio"] <= 1.0, name
