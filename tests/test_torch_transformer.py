"""The PyTorch port's int8 TransformerLM against the JAX package's.

A toy quantized LM (vocab 128, d_model 64, 2 layers, 4 heads, window 64),
MHA and GQA (``n_kv_heads=2``), in both JAX parameter layouts (unrolled
``block_i`` and stacked ``layers/block``). Float weights are drawn with
numpy from a seed; both packages get the same values.

Tolerances and why:

- ``quantize_lm_params`` and the weight bridge: bitwise (same quantizer
  arithmetic, a pure relayout).
- logits (prefill at ``last_pos``, 8 slot-indexed decode steps): ``atol
  1e-4`` on logits of order 1. The two packages sum the float32 einsums
  and reductions in different orders (the port's attention and RMSNorm
  statistics run in float64) and their ``cos``/``sin``/``pow`` differ in
  the last ulp; the int8 activation quantization can turn such an ulp
  into one int8 step of one activation.
- greedy tokens of ``generate``: equal; the smallest top-1/top-2 logit
  margin seen is reported on failure.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.models.generate import generate as jax_generate
from pytorch_distributed_training_tutorials_tpu.serve.slots import (
    init_slot_state as jax_init_slot_state,
    write_slot as jax_write_slot,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    KVCache,
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
    generate,
    init_lm,
    init_quantized_lm,
    quantize_lm_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
)
from helpers import requires_pallas_interpret

pytestmark = requires_pallas_interpret

TOY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=64)
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Toy widths gain nothing from intra-op threads; one thread keeps
    this file from competing for cores with the suite's other workers
    (the port's results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_float_tree(cfg, seed=0):
    """Float JAX params for ``cfg`` drawn with numpy: kernels and the
    embedding N(0, 0.15^2), norm scales 1 + N(0, 0.1^2). A stacked
    (``scan_layers``) tree stacks the unrolled draws, so both layouts hold
    the same weights."""
    if cfg.scan_layers:
        flat = jax_float_tree(dataclasses.replace(cfg, scan_layers=False), seed)
        return jt.stack_quantized_lm_params(flat)
    shapes = jax.eval_shape(
        jt.TransformerLM(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4), jnp.int32),
    )["params"]
    rng = np.random.Generator(np.random.PCG64(seed))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if str(path[-1].key) == "scale":
            return (1.0 + 0.1 * x).astype(np.float32)
        return (0.15 * x).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Pair:
    """One variant's JAX model + quantized tree and the port's model."""

    def __init__(self, variant, stacked=False):
        kw = {**TOY, **VARIANTS[variant]}
        self.jcfg = jt.TransformerConfig(**kw, scan_layers=stacked)
        self.float_tree = jax_float_tree(self.jcfg)
        self.qtree = jt.quantize_lm_params(self.float_tree)
        self.jmodel = jt.TransformerLM(dataclasses.replace(self.jcfg, quantized=True))
        self.cfg = TransformerConfig(**kw, quantized=True)
        self.params = from_jax_params(to_np(self.float_tree), self.cfg, device="cpu")
        self.model = TransformerLM(self.cfg)
        bind_params(self.model, self.params)
        jm = self.jmodel
        self.jprefill = jax.jit(
            lambda v, t, lp: jm.apply(v, t, prefill=True, last_pos=lp, mutable=["cache"])
        )
        self.jdecode = jax.jit(
            lambda v, t: jm.apply(v, t, decode=True, mutable=["cache"])
        )


@pytest.fixture(scope="module", params=[
    ("mha", False), ("gqa", False), ("mha", True), ("gqa", True),
], ids=["mha", "gqa", "mha-stacked", "gqa-stacked"])
def pair(request):
    return Pair(*request.param)


def _walk(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _walk(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(
                a[k].numpy(), np.asarray(b[k]), err_msg=f"{path}/{k}"
            )


def test_quantize_lm_params_bitwise(pair):
    def to_t(tree):
        return {
            k: to_t(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()
        }

    _walk(quantize_lm_params(to_t(to_np(pair.float_tree))), to_np(pair.qtree))


def test_bridge_layouts_give_same_weights():
    """Float and quantized trees, unrolled and stacked: one set of port
    weights."""
    base = Pair("gqa")
    stacked = Pair("gqa", stacked=True)
    ref = base.params
    for tree in (base.qtree, stacked.float_tree, stacked.qtree):
        got = from_jax_params(to_np(tree), base.cfg, device="cpu")
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    assert ref["blocks.0.attn.q_proj.qt"].shape == (64, 64)  # (N, K)
    assert ref["blocks.0.attn.k_proj.qt"].shape == (32, 64)  # GQA: 2 heads
    assert ref["blocks.0.attn.q_proj.qt"].is_contiguous()


def _prompts(seed, lengths, vocab=TOY["vocab_size"]):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(0, vocab, p).tolist() for p in lengths]


def test_prefill_logits_at_last_pos(pair):
    """Right-padded batched prefill, logits gathered at each row's last
    real position."""
    lengths = [5, 12]
    prompts = _prompts(1, lengths)
    s = 16
    toks = np.array([p + [0] * (s - len(p)) for p in prompts], np.int32)
    last = np.array(lengths) - 1
    jl, _ = pair.jprefill(
        {"params": pair.qtree}, jnp.asarray(toks), jnp.asarray(last)
    )
    cache = KVCache.zeros(pair.cfg, 2, device="cpu")
    tl = pair.model(
        torch.tensor(toks, dtype=torch.int64), cache, prefill=True,
        last_pos=torch.tensor(last),
    )
    assert tl.shape == (2, 1, TOY["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert cache.index.tolist() == [s, s]


def test_slot_decode_steps_per_row_positions(pair):
    """Two slots prefilled at different depths, then 8 slot-indexed decode
    steps (teacher-forced tokens) against the JAX decode path."""
    lengths = [3, 9]
    prompts = _prompts(2, lengths)
    jstate = jax_init_slot_state(pair.jmodel, pair.qtree, 2)
    jcache = jstate["cache"]
    cache = KVCache.zeros(pair.cfg, 2, device="cpu")
    for r, p in enumerate(prompts):
        padded = p + [0] * (16 - len(p))
        _, upd = pair.jprefill(
            {"params": pair.qtree}, jnp.asarray([padded], jnp.int32),
            jnp.asarray(len(p) - 1),
        )
        jcache = jax_write_slot(
            jcache, upd["cache"], r, len(p), pair.jcfg.scan_layers
        )
        pair.model(
            torch.tensor([padded]), cache, prefill=True, last_pos=len(p) - 1,
            rows=r,
        )
        cache.index[r] = len(p)
    feed = np.random.Generator(np.random.PCG64(3)).integers(
        0, TOY["vocab_size"], (8, 2)
    )
    for step, toks in enumerate(feed):
        jl, upd = pair.jdecode(
            {"params": pair.qtree, "cache": jcache},
            jnp.asarray(toks[:, None], jnp.int32),
        )
        jcache = upd["cache"]
        tl = pair.model(torch.tensor(toks[:, None]), cache, decode=True)
        np.testing.assert_allclose(
            tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL,
            err_msg=f"decode step {step}",
        )
    assert cache.index.tolist() == [3 + 8, 9 + 8]


def test_generate_greedy_matches_jax(pair):
    prompts = np.array(_prompts(4, [6, 6]))
    new = 8
    want = np.asarray(jax_generate(pair.jmodel, pair.qtree, jnp.asarray(prompts), new))
    got = generate(pair.model, None, prompts, new, device="cpu").numpy()
    # smallest top-1/top-2 margin along the port's own greedy rollout
    cache = KVCache.zeros(pair.cfg, 2, device="cpu")
    lg = [pair.model(torch.tensor(prompts), cache, prefill=True)]
    for t in range(6, 6 + new - 1):
        lg.append(pair.model(torch.tensor(got[:, t : t + 1]), cache, decode=True))
    top2 = torch.cat(lg, dim=1).topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    np.testing.assert_array_equal(
        got, want, err_msg=f"smallest top-1/top-2 margin {margin:.3g}"
    )


def test_decode_write_past_window_dropped():
    """A row at position >= the window writes into the sink: the window
    is untouched and nothing raises; the other row writes normally."""
    p = Pair("mha")
    cache = KVCache.zeros(p.cfg, 2, device="cpu")
    w = cache.window
    cache.k.normal_()
    cache.v.normal_()
    before_k = cache.k[:, :, :w].clone()
    cache.index.copy_(torch.tensor([w, 5]))
    p.model(torch.tensor([[1], [2]]), cache, decode=True)
    assert torch.equal(cache.k[:, 0, :w], before_k[:, 0])
    assert not torch.equal(cache.k[:, 1, 5], before_k[:, 1, 5])
    others = [i for i in range(w) if i != 5]
    assert torch.equal(cache.k[:, 1, others], before_k[:, 1, others])
    assert cache.index.tolist() == [w + 1, 6]
    cache.index[0] = w + 7  # a parked row keeps stepping
    p.model(torch.tensor([[1], [2]]), cache, decode=True)
    assert torch.equal(cache.k[:, 0, :w], before_k[:, 0])


@pytest.mark.parametrize(
    "field,value",
    [
        ("kv_cache_dtype", "int8"),
        ("kv_pages", 4),
        ("paged_kernel", True),
        ("lora_adapters", 2),
        ("lora_rank", 4),
        ("moe_experts", 4),
        ("attention_fn", lambda q, k, v: q),
        ("int8_mesh", object()),
        ("remat", True),
        ("dtype", torch.bfloat16),
        ("quantized", False),
    ],
)
def test_unsupported_config_fields_raise(field, value):
    if field in ("kv_cache_dtype", "kv_pages", "paged_kernel"):
        # supported since the paged-serving slice; these values are misuse
        # (a dtype name for torch.int8, pages without a page size, the
        # paged kernel without pages) and raise ValueError naming the field
        with pytest.raises(ValueError, match=field):
            TransformerConfig(**{**TOY, "quantized": True, field: value})
        return
    if field == "quantized":
        # float weights train since the LM train-step slice and serve since
        # the prefill slice: prefill fills a cache stored in cfg.dtype;
        # what a float model still refuses is the fused loss's hidden
        # states on a serving call
        model = TransformerLM(TransformerConfig(**{**TOY, field: value}), device="cpu")
        cache = KVCache.zeros(model.cfg, 1, device="cpu")
        assert cache.k.dtype == model.cfg.dtype
        with torch.no_grad():
            model(torch.zeros((1, 4), dtype=torch.int64), cache, prefill=True)
        assert cache.index.tolist() == [4]
        with pytest.raises(NotImplementedError, match="float"):
            model(torch.zeros((1, 4), dtype=torch.int64), cache, prefill=True,
                  return_hidden=True)
        return
    if field in ("lora_adapters", "lora_rank"):
        # supported since the LoRA-bank slice: both together build the
        # *_lora siblings (zero factors, so every id is the base model);
        # one without the other is misuse and raises ValueError naming it
        with pytest.raises(ValueError, match=field):
            TransformerConfig(**{**TOY, "quantized": True, field: value})
        cfg = TransformerConfig(**{**TOY, "quantized": True, "lora_adapters": 2,
                                   "lora_rank": 4})
        base_cfg = TransformerConfig(**{**TOY, "quantized": True})
        params = init_quantized_lm(cfg, seed=0, device="cpu")
        base_params = init_quantized_lm(base_cfg, seed=0, device="cpu")
        assert {k: v for k, v in params.items() if "_lora." not in k}.keys() == base_params.keys()
        for k, v in base_params.items():
            assert torch.equal(params[k], v), k  # the factors draw nothing
        model, base = TransformerLM(cfg), TransformerLM(base_cfg)
        bind_params(model, params)
        bind_params(base, base_params)
        toks = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
        caches = [KVCache.zeros(c, 2, device="cpu") for c in (cfg, base_cfg)]
        got = model(toks, caches[0], prefill=True, adapter_ids=torch.tensor([0, 1]))
        assert torch.equal(got, base(toks, caches[1], prefill=True))
        return
    if field == "int8_mesh":
        # supported since the tensor-parallel serving slice: a strategy (or
        # a process group / a mesh with a model axis, taken as one) is
        # accepted; any other value is misuse and raises TypeError naming
        # the field. A strategy of one rank shards nothing: the model is the
        # unsharded one, value for value
        with pytest.raises(TypeError, match=field):
            TransformerConfig(**{**TOY, "quantized": True, field: value})
        strat = TensorParallel()
        cfg = TransformerConfig(**{**TOY, "quantized": True, field: strat})
        assert cfg.int8_mesh is strat
        base_cfg = TransformerConfig(**{**TOY, "quantized": True})
        params = init_quantized_lm(cfg, seed=0, device="cpu")
        model, base = TransformerLM(cfg), TransformerLM(base_cfg)
        bind_params(model, params)
        bind_params(base, init_quantized_lm(base_cfg, seed=0, device="cpu"))
        toks = torch.tensor([[1, 2, 3, 4]])
        caches = [KVCache.zeros(c, 1, device="cpu") for c in (cfg, base_cfg)]
        assert torch.equal(model(toks, caches[0], prefill=True),
                           base(toks, caches[1], prefill=True))
        return
    if field == "moe_experts":
        # supported since the MoE slice (tests/test_torch_moe.py) on float
        # weights; int8 serving refuses MoE blocks as the JAX model does
        with pytest.raises(ValueError, match="dense blocks only"):
            TransformerConfig(**{**TOY, "quantized": True, field: value})
        cfg = TransformerConfig(**{**TOY, field: value})
        model = TransformerLM(cfg)
        bind_params(model, init_lm(cfg, seed=0, device="cpu"))
        cache = KVCache.zeros(cfg, 1, device="cpu")
        with torch.no_grad():
            model(torch.zeros((1, 4), dtype=torch.int64), cache, prefill=True)
        assert cache.index.tolist() == [4] and model.blocks[0].moe.aux_loss is not None
        return
    if field == "attention_fn":
        # int8 prefill runs cfg.attention_fn since the prefill slice (the
        # flash forward); decode keeps the dense cached path
        calls = []

        def spy(q, k, v):
            calls.append(tuple(q.shape))
            return v

        cfg = TransformerConfig(**{**TOY, "quantized": True, field: spy})
        params = init_quantized_lm(cfg, seed=0, device="cpu")
        model = TransformerLM(cfg)
        bind_params(model, params)
        cache = KVCache.zeros(cfg, 1, device="cpu")
        model(torch.zeros((1, 4), dtype=torch.int64), cache, prefill=True)
        model(torch.zeros((1, 1), dtype=torch.int64), cache, decode=True)
        assert calls == [(1, 4, cfg.n_heads, cfg.head_dim)] * cfg.n_layers
        return
    with pytest.raises(NotImplementedError, match=field):
        TransformerConfig(**{**TOY, "quantized": True, field: value})
