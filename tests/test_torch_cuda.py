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


FUSED_CE_CASES = [
    # (N, D, V, dtype, a target out of range)
    (300, 256, 1000, torch.bfloat16, True),  # ragged rows and vocab tail
    (128, 1536, 4096, torch.bfloat16, False),  # the 760m hidden width
    (200, 96, 520, torch.float32, True),  # f32 through the same kernels
    (70, 20, 50, torch.bfloat16, True),  # D, V not multiples of 8: element loads
    (600, 64, 300, torch.float32, False),  # several 256-row dW groups
]


@pytest.mark.parametrize("n,d,v,dtype,oor", FUSED_CE_CASES)
def test_fused_loss_kernels_match_plain_versions(n, d, v, dtype, oor):
    """The forward, dh and dW kernels against their plain versions on the
    same inputs; one launch counted per call. Each output is held element
    by element to ``fl.KERNEL_TOLERANCE`` (bf16 on the tensor cores,
    f32 through the same kernels on the CUDA cores)."""
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.ops import fused_loss as fl

    gen = torch.Generator(device="cuda").manual_seed(n + d + v)
    h = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((d, v), generator=gen, device="cuda") * d ** -0.5).to(dtype)
    y = torch.randint(0, v, (n,), generator=gen, device="cuda")
    if oor:
        y[1] = v + 3  # hits nothing: its loss is the lse
    g = torch.rand((n,), generator=gen, device="cuda") / n
    before = dict(fl.fused_cross_entropy.launches)
    lse, tgt = fl.fused_ce_fwd(h, w, y)
    dh = fl.fused_ce_dh(h, w, y, lse, g)
    dw = fl.fused_ce_dw(h, w, y, lse, g)
    assert fl.fused_cross_entropy.launches == {k: before[k] + 1 for k in before}
    want = [*fl.fused_ce_fwd_reference(h, w, y, 64, 128),
            fl.fused_ce_dh_reference(h, w, y, lse, g, 64, 128),
            fl.fused_ce_dw_reference(h, w, y, lse, g, 64, 128)]
    for name, got, ref in zip(("lse", "tgt", "dh", "dw"), (lse, tgt, dh, dw), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        err = fl.kernel_error(got, ref)
        assert err["worst_ratio"] <= 1.0, (name, err)
    if oor:
        assert float(tgt[1]) == 0.0


def test_fused_loss_kernels_refuse_what_they_do_not_take():
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.ops import fused_loss as fl

    h = torch.randn((8, 16), device="cuda", dtype=torch.float16)
    y = torch.zeros((8,), dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError, match="bfloat16 or both"):
        fl.fused_ce_fwd(h, torch.randn((16, 32), device="cuda", dtype=torch.float16), y)
    w = torch.randn((32, 16), device="cuda").t()
    with pytest.raises(ValueError, match="contiguous"):
        fl.fused_ce_fwd(torch.randn((8, 16), device="cuda"), w, y)


def _adamw_leaves(shapes, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    leaves = []
    for s in shapes:
        if s == "misaligned":  # a contiguous view 4 bytes past an aligned base
            leaves.append(torch.randn((1001,), generator=gen, device="cuda")[1:])
        else:
            leaves.append(torch.randn(s, generator=gen, device="cuda"))
    return leaves


@pytest.mark.parametrize("shapes,launches", [
    ([(1000, 37), (13,), (1536, 1536), (3,), (2, 2, 2), "misaligned"], 1),
    ([(7,)] * 600, 2),  # more leaves than one launch takes
])
def test_fused_adamw_kernel_is_bitwise_its_plain_version(shapes, launches):
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw

    params = _adamw_leaves(shapes, 1)
    plain_params = [p.clone() for p in params]
    tx, plain = fused_adamw(3e-4, weight_decay=0.01), adamw(3e-4, weight_decay=0.01)
    state, plain_state = tx.init(params), plain.init(plain_params)
    before = fused_adamw.launches
    for step in range(3):
        grads = [g * 10.0 ** (step - 2) for g in _adamw_leaves(shapes, 10 + step)]
        tx.update_(params, grads, state)
        plain.update_(plain_params, grads, plain_state)
        for a, b in zip(params + state.mu + state.nu,
                        plain_params + plain_state.mu + plain_state.nu):
            assert torch.equal(a, b)
    assert fused_adamw.launches == before + 3 * launches


def test_fused_adamw_refuses_other_types():
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw

    p = [torch.zeros((4,), device="cuda", dtype=torch.bfloat16)]
    tx = fused_adamw(1e-3)
    with pytest.raises(TypeError, match="float32"):
        tx.update_(p, [torch.zeros_like(p[0])], tx.init(p))


def test_fused_tail_trains_through_the_kernels():
    """A toy float LM step on the card with the fused tail: one forward,
    dh and dW launch and one AdamW launch per step, loss finite."""
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.bench import lm_headline

    r = lm_headline.measure(lm_headline.parse(
        ["--preset", "smoke", "--seq", "128", "--steps", "2", "--reps", "1", "--fused"]))
    steps = r["steps_run"]
    assert r["fused_loss_launches"] == {"fwd": steps, "dh": steps, "dw": steps}
    assert r["fused_adamw_launches"] == steps
    assert r["flash_launches"] == {"fwd": 4 * steps, "dq": 2 * steps, "dkv": 2 * steps}
    assert r["all_losses_finite"]


def _paged_inputs(b, s, h, kv, d, page_size, p_cap, store, q_dtype, seed, parked=()):
    """Paged-attention operands on the card: ragged depths (row 0 at depth
    0, the last at the window's end), distinct shuffled pages, sentinel
    tails, ``parked`` rows all sentinel; pools stored as ``store``."""
    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
        _quantize_kv,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import quantize_kv_int4

    gen = torch.Generator(device="cuda").manual_seed(seed)
    window = p_cap * page_size
    pos = torch.linspace(0, window - s, b).round().to(torch.int64).cuda()
    live = [-(-(int(p) + s) // page_size) for p in pos]
    n_pages = sum(live) + 3
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(q_dtype)
    kf, vf = (torch.randn((n_pages, page_size, kv, d), generator=gen, device="cuda")
              for _ in range(2))
    kw = {}
    if store == "int8":
        (k, ks), (v, vs) = _quantize_kv(kf), _quantize_kv(vf)
        kw = dict(k_scale=ks, v_scale=vs, quant="int8")
    elif store == "int4":
        (k, ks), (v, vs) = quantize_kv_int4(kf), quantize_kv_int4(vf)
        kw = dict(k_scale=ks, v_scale=vs, quant="int4")
    else:
        k, v = kf.to(store), vf.to(store)
    perm = torch.randperm(n_pages, generator=gen, device="cuda").tolist()
    table = torch.full((b, p_cap), n_pages, dtype=torch.int32)
    for i, n in enumerate(live):
        table[i, :n] = torch.tensor([perm.pop() for _ in range(n)], dtype=torch.int32)
    for r in parked:
        table[r] = n_pages
    return q, k, v, table.cuda(), pos, kw


PAGED_CASES = [
    # (B, S, H, KV, D, page_size, P, pool storage, q dtype, parked rows)
    (4, 1, 16, 4, 128, 64, 8, torch.float32, torch.float32, ()),  # the 1b-gqa decode
    (4, 1, 16, 16, 128, 64, 8, torch.bfloat16, torch.float32, (2,)),  # 1b MHA, bf16 pool
    (4, 1, 16, 4, 128, 64, 8, "int8", torch.float32, (1,)),
    (4, 1, 16, 4, 128, 64, 8, "int4", torch.float32, ()),
    (2, 4, 16, 4, 128, 64, 4, "int4", torch.float32, ()),  # an S 4 chunk: the staircase
    (3, 2, 8, 2, 32, 8, 4, torch.bfloat16, torch.bfloat16, ()),  # the JAX sweep's bf16 case
    (3, 3, 8, 2, 32, 16, 3, "int8", torch.bfloat16, (0,)),
    (2, 1, 4, 4, 18, 8, 3, "int4", torch.float32, ()),  # D not a multiple of 4
]


@pytest.mark.parametrize("b,s,h,kv,d,ps,p_cap,store,q_dtype,parked", PAGED_CASES)
def test_paged_attention_kernel_matches_plain_version(b, s, h, kv, d, ps, p_cap, store,
                                                      q_dtype, parked):
    """The paged-attention kernel against its plain version on the same
    operands (each element within ``pa.KERNEL_TOLERANCE`` of
    ``pa.tolerance_type``: bf16 where p rounds to bf16, else q's type),
    a parked row exactly 0, one launch counted per call, and the gather
    oracle close as well."""
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as pa

    q, k, v, table, pos, kw = _paged_inputs(b, s, h, kv, d, ps, p_cap, store, q_dtype,
                                            seed=b * 100 + d + s, parked=parked)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, table, pos, **kw)
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_plain(q, k, v, table, pos, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    err = pa.kernel_error(got, want, pa.tolerance_type(q, v, kw.get("quant")))
    assert err["worst_ratio"] <= 1.0, err
    for r in parked:
        assert not got[r].any()
    ref = pa.paged_attention_reference(q, k, v, table, pos, **kw)
    live = [r for r in range(b) if r not in parked]
    tol = 2e-5 if pa.tolerance_type(q, v, kw.get("quant")) == torch.float32 else 3e-2
    assert float((got[live].float() - ref[live].float()).abs().max()) <= tol


def test_paged_attention_kernel_refuses_what_it_does_not_take():
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as pa

    q, k, v, table, pos, _ = _paged_inputs(2, 1, 4, 4, 136, 8, 2, torch.float32,
                                           torch.float32, seed=1)
    with pytest.raises(ValueError, match="even head dim up to 128"):
        pa.paged_attention(q, k, v, table, pos)
    q, k, v, table, pos, _ = _paged_inputs(2, 1, 4, 4, 15, 8, 2, torch.float32,
                                           torch.float32, seed=1)
    with pytest.raises(ValueError, match="even head dim up to 128"):
        pa.paged_attention(q, k, v, table, pos)
    q, k, v, table, pos, _ = _paged_inputs(2, 1, 4, 4, 16, 8, 2, torch.float32,
                                           torch.float32, seed=1)
    with pytest.raises(TypeError, match="int32 table"):
        pa.paged_attention(q, k, v, table.long(), pos)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pa.paged_attention(q.half(), k, v, table, pos)
    with pytest.raises(ValueError, match="different devices"):
        pa.paged_attention(q, k, v, table.cpu(), pos)


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_paged_serve_selftest_on_cuda(kv_bits):
    """The toy paged stream on the card through the kernel: token-exact to
    the whole-slot engine, sync budget held, no page leaked."""
    _need_cuda()
    from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as pa
    from pytorch_distributed_training_tutorials_tpu_torch.serve.__main__ import selftest

    before = pa.paged_attention.launches
    receipt = selftest("cuda", paged=True, paged_kernel=True, kv_bits=kv_bits)
    assert receipt["ok"], receipt["problems"]
    assert pa.paged_attention.launches > before
