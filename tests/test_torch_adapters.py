"""The PyTorch port's multi-tenant LoRA (``adapters/``, ``LoRADelta``, the
masked fused AdamW, ``Trainer(model_kwargs=)``) against the JAX package's.

Toy LoRA models (vocab 64, d_model 32, 2 layers, 4 heads, 3 adapter rows
of rank 4) whose weights and factors are drawn with numpy from a seed;
both packages get the same values through ``models/convert.py``.

Tolerances and why:

- the registry, the bank's bookkeeping, ``lora_param_mask``'s leaf set,
  ``extract_adapter`` and ``adapter_from_jax``: exact (host arithmetic
  and copies);
- ``apply_lora`` and the LoRA model's logits, float32: ``atol 2e-5`` on
  values of order 1 (the same float32 products summed in other orders,
  XLA against oneDNN); bfloat16 ``atol 3e-2`` (a bf16 rounding is 2^-8 of
  a value); int8 weights ``atol 1e-4`` (the port's attention and norm
  sums in float64, as ``test_torch_transformer.py`` states);
- ``merge_adapter``: ``atol 1e-6`` (one float32 product ``A @ B`` of
  rank 4 added to a weight of order 0.2);
- ``fused_adamw(mask=)`` over 5 steps: the base leaves bitwise unchanged
  on both sides, the factors within the existing AdamW bound of
  ``test_torch_fused_optim.py`` (``rtol 2.5e-7, atol 1e-7``);
- the Trainer fine-tune, 5 steps: losses ``rtol 1e-5``, base leaves
  bitwise unchanged, factors within ``2e-6`` for 99.9% of the elements
  and ``2 * lr * 5`` for all (``test_torch_train.py`` says why: an
  element whose gradient nearly cancels can step the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.adapters import bank as jbank
from pytorch_distributed_training_tutorials_tpu.adapters import lora as jlora
from pytorch_distributed_training_tutorials_tpu.adapters import registry as jregistry
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.ops.fused_optim import (
    fused_adamw as jax_fused_adamw,
)
from pytorch_distributed_training_tutorials_tpu.train import trainer as jtrainer
from pytorch_distributed_training_tutorials_tpu_torch.adapters import (
    AdapterBank,
    AdapterRegistry,
    RegistryFull,
    apply_lora,
    extract_adapter,
    lora_init,
    lora_param_mask,
    lora_tree,
    merge_adapter,
)
from pytorch_distributed_training_tutorials_tpu_torch.data.datasets import ArrayDataset
from pytorch_distributed_training_tutorials_tpu_torch.data.loader import ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
    init_lm,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.convert import adapter_from_jax
from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import LocalMesh
from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import Trainer
from helpers import requires_pallas_interpret

TOY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)
N, R = 3, 4
CPU = LocalMesh(torch.device("cpu"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _is_lora_path(path) -> bool:
    return any(str(getattr(k, "key", k)).endswith("_lora") for k in path)


def jax_lora_tree(scan=False, seed=0, factor_scale=0.3):
    """A JAX LoRA param tree drawn with numpy: weights N(0, 0.2^2), norm
    scales 1 + N(0, 0.1^2), the embedding N(0, 1), every factor row but
    row 0 N(0, factor_scale^2) (row 0, the base model, zero). A stacked
    tree stacks the unrolled draws."""
    jcfg = jt.TransformerConfig(**TOY, lora_adapters=N, lora_rank=R)
    if scan:
        flat = jax_lora_tree(False, seed, factor_scale)
        return jt.stack_quantized_lm_params(flat)
    shapes = jax.eval_shape(jt.TransformerLM(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))["params"]
    rng = np.random.Generator(np.random.PCG64(seed))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        last = str(path[-1].key)
        if last == "scale":
            return (1.0 + 0.1 * x).astype(np.float32)
        if last == "embedding":
            return x
        if _is_lora_path(path):
            x = (factor_scale * x).astype(np.float32)
            x[0] = 0.0
            return x
        return (0.2 * x).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def configs(quantized=False, scan=False, dtype="f32"):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg = jt.TransformerConfig(**TOY, lora_adapters=N, lora_rank=R, scan_layers=scan,
                                quantized=quantized, dtype=jdt)
    cfg = TransformerConfig(**TOY, lora_adapters=N, lora_rank=R, quantized=quantized,
                            dtype=tdt)
    return jcfg, cfg


# ------------------------------------------------------------------ registry

def _script(registry_cls, full_cls):
    """One scripted register / evict / lookup sequence; the answers."""
    reg = registry_cls(4, byte_budget=300)
    out = []
    for name, nbytes in (("a", 100), ("b", 100), ("c", 200), ("c", 100)):
        try:
            out.append(("register", name, reg.register(name, nbytes)))
        except full_cls as e:
            out.append(("full", name, str(e)))
    out.append(("evict", "a", reg.evict("a")))
    out.append(("register", "d", reg.register("d", 50)))
    try:
        reg.register("d", 1)
    except ValueError as e:
        out.append(("duplicate", str(e)))
    out.append(("evict", "b", reg.evict("b")))
    out.append(("register", "e", reg.register("e", 10)))
    out.append(("lookup", {n: reg.lookup(n) for n in ("c", "d", "e")}))
    out.append(("live", [reg.is_live(i) for i in range(4)]))
    out.append(("generation", [reg.generation(i) for i in range(4)]))
    out.append(("ids", sorted(reg.registered_ids()), len(reg), "d" in reg, "a" in reg))
    out.append(("stats", reg.stats()))
    return out


def test_registry_answers_match_jax():
    """The port's own registry copy answers a scripted sequence exactly
    as the JAX package's: rows lowest free first, generations, the byte
    budget's refusals, the stats."""
    got = _script(AdapterRegistry, RegistryFull)
    want = _script(jregistry.AdapterRegistry, jregistry.RegistryFull)
    assert got == want
    assert ("full", "c", "byte budget exceeded: 200 + 200 > 300") in got
    with pytest.raises(ValueError, match="n_adapters must be >= 2"):
        AdapterRegistry(1)


# ---------------------------------------------------------------- apply_lora

@pytest.mark.parametrize("ids,dtype", [
    ([2, 0, 1], "f32"), (1, "f32"), ([1, 2, 2], "bf16")],
    ids=["vector", "scalar", "bf16"])
def test_apply_lora_matches_jax(ids, dtype):
    rng = np.random.Generator(np.random.PCG64(3))
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    a = rng.standard_normal((N, 16, R)).astype(np.float32)
    b = rng.standard_normal((N, R, 24)).astype(np.float32)
    a[0], b[0] = 0.0, 0.0
    jdt, tdt = (None, None) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jbank.apply_lora(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(ids), dtype=jdt), np.float32)
    tids = ids if isinstance(ids, int) else torch.tensor(ids, dtype=torch.int32)
    got = apply_lora(torch.tensor(x), torch.tensor(a), torch.tensor(b), tids, dtype=tdt)
    atol = 2e-5 if dtype == "f32" else 3e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    if not isinstance(ids, int) and 0 in ids:
        assert not got[ids.index(0)].any()  # row 0: an exact 0.0


# ------------------------------------------------------------ the LoRA model

@pytest.mark.parametrize("quantized,scan,dtype", [
    (False, False, "f32"), (False, True, "f32"), (True, False, "f32"), (True, True, "f32"),
    (False, False, "bf16")],
    ids=["float", "float-stacked", "int8", "int8-stacked", "bf16"])
def test_lora_model_logits_match_jax(quantized, scan, dtype):
    """``LoRADelta`` on every hooked projection: the port's forward with
    per-row ids against the JAX model's apply, float and int8 weights
    (the int8 deltas in float32), unrolled and stacked trees."""
    jcfg, cfg = configs(quantized, scan, dtype)
    tree = jax_lora_tree(scan)
    if quantized:
        tree = jt.quantize_lm_params(tree)
    toks = np.random.Generator(np.random.PCG64(4)).integers(0, 64, (3, 9))
    ids = np.array([1, 0, 2])
    want = np.asarray(jt.TransformerLM(jcfg).apply(
        {"params": tree}, jnp.asarray(toks), adapter_ids=jnp.asarray(ids)), np.float32)
    model = TransformerLM(cfg)
    bind_params(model, from_jax_params(_np(tree), cfg, device="cpu"))
    with torch.no_grad():
        got = model(torch.tensor(toks), adapter_ids=torch.tensor(ids)).float().numpy()
    atol = {"f32": 1e-4 if quantized else 2e-5, "bf16": 3e-2 * np.abs(want).max()}[dtype]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    # the tenants' logits differ from the base row's: the deltas are live
    with torch.no_grad():
        base = model(torch.tensor(toks), adapter_ids=0).float().numpy()
    assert np.abs(got[0] - base[0]).max() > 0.1 * np.abs(base).max()
    if dtype == "f32":
        np.testing.assert_array_equal(got[1], base[1])  # row 0 adds an exact 0.0


def test_lora_param_mask_leaf_set_matches_jax():
    """The trainable set over the port's names is the JAX mask's: each
    JAX leaf is tagged with its own index, carried across by the weight
    bridge, and the leaves the JAX mask marks True are exactly the port
    names ``lora_param_mask`` marks True."""
    jcfg, cfg = configs()
    tree = jax_lora_tree()
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(leaves)])
    port = from_jax_params(tagged, cfg, device="cpu")
    jmask = jax.tree_util.tree_leaves(jlora.lora_param_mask(tree))
    want = {i for i, m in enumerate(jmask) if m}
    mask = lora_param_mask(port)
    got = {int(port[n].reshape(-1)[0]) for n, m in mask.items() if m}
    assert got == want and len(got) == 7 * 2 * TOY["n_layers"]
    assert set(lora_tree(port)) == {n for n, m in mask.items() if m}
    assert lora_param_mask(TransformerLM(cfg)) == mask  # a module gives the same


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_extract_and_merge_adapter_match_jax(scan):
    """``extract_adapter``: the JAX row through ``adapter_from_jax`` is
    the port's extract of the converted tree, exactly. ``merge_adapter``:
    every folded weight within ``1e-6`` of the JAX merge's kernel, no
    factor left, and the merged base model's logits within float
    tolerance of the adapter-applied ones."""
    jcfg, cfg = configs(scan=scan)
    tree = jax_lora_tree(scan)
    port = from_jax_params(_np(tree), cfg, device="cpu")
    for aid in (0, 2):
        row = adapter_from_jax(_np(jlora.extract_adapter(tree, aid)), cfg, device="cpu")
        got = extract_adapter(port, aid)
        assert set(got) == set(row)
        for k in row:
            assert torch.equal(got[k], row[k]), k
    base_cfg = TransformerConfig(**TOY)
    want = from_jax_params(_np(jlora.merge_adapter(tree, 2)), base_cfg, device="cpu")
    merged = merge_adapter(port, 2)
    assert set(merged) == set(want)
    for k in want:
        torch.testing.assert_close(merged[k], want[k], atol=1e-6, rtol=0)
    # id 0 folds an exact zero: the base leaves bitwise
    for k, v in merge_adapter(port, 0).items():
        assert torch.equal(v, port[k]), k
    lora_model, base_model = TransformerLM(cfg), TransformerLM(base_cfg)
    bind_params(lora_model, port)
    bind_params(base_model, merged)
    toks = torch.tensor([[3, 9, 27, 17, 51]])
    with torch.no_grad():
        torch.testing.assert_close(base_model(toks), lora_model(toks, adapter_ids=2),
                                   atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="float weights"):
        merge_adapter({k: v for k, v in port.items() if not k.endswith("q_proj.weight")}, 1)


def test_lora_init_rows_and_zero_b_is_base():
    """A rows (1..N-1) drawn with std 1/sqrt(d_in) from a generator per
    leaf (seeded, repeatable, different leaf to leaf), row 0 and every B
    zero, the base leaves the caller's tensors; with B zero every id's
    forward is the base model's, bitwise (the JAX test's pin)."""
    _, cfg = configs()
    params = init_lm(cfg, seed=0, device="cpu")
    init = lora_init(params, seed=2)
    again = lora_init(params, seed=2)
    other = lora_init(params, seed=3)
    a_names = [k for k in init if k.endswith(".lora_a")]
    assert len(a_names) == 7 * TOY["n_layers"]
    for k, v in init.items():
        if k.endswith(".lora_a"):
            assert not v[0].any() and v[1:].all()
            assert torch.equal(v, again[k]) and not torch.equal(v, other[k])
            std = 1.0 / v.shape[-2] ** 0.5
            assert abs(float(v[1:].std()) - std) < 0.25 * std, k
        elif k.endswith(".lora_b"):
            assert not v.any()
        else:
            assert v is params[k]
    assert not torch.equal(init[a_names[0]][1], init[a_names[1]][1, :, :])
    model, base = TransformerLM(cfg), TransformerLM(TransformerConfig(**TOY))
    bind_params(model, init)
    bind_params(base, merge_adapter(init, 0))
    toks = torch.tensor([[1, 2, 3]])
    with torch.no_grad():
        want = base(toks)
        for aid in range(N):
            assert torch.equal(model(toks, adapter_ids=aid), want)


# ---------------------------------------------------------------------- bank

def _rows_np(jb, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    return jax.tree_util.tree_map(
        lambda leaf: (rng.standard_normal(leaf.shape) * 0.3).astype(np.float32),
        _np(jb.row_zeros()))


def test_bank_lifecycle_matches_jax():
    """register / evict / row reuse / generations / version / stats /
    admission checks on both banks, and the port bank's factors equal the
    JAX bank's factor tree (converted) after every step; a bad row rolls
    the grant back on both."""
    _, cfg = configs()
    jb = jbank.AdapterBank(jt.TransformerLM(jt.TransformerConfig(**TOY)), N, R)
    tb = AdapterBank(TransformerLM(TransformerConfig(**TOY)), N, R, device="cpu")
    assert tb.adapter_nbytes == jb.adapter_nbytes
    assert set(tb.row_zeros()) == set(tb.factors)

    def same_factors():
        base = jt.TransformerLM(jt.TransformerConfig(**TOY)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 1), jnp.int32))["params"]
        want = from_jax_params(_np(jb.merge_params(base)),
                               TransformerConfig(**TOY, lora_adapters=N, lora_rank=R),
                               device="cpu")
        for k, v in tb.factors.items():
            assert torch.equal(v, want[k]), k

    script = [("register", "a", 1), ("register", "b", 2), ("evict", "a", None),
              ("register", "c", 3)]
    for op, name, seed in script:
        if op == "register":
            row = _rows_np(jb, seed)
            assert tb.register(name, adapter_from_jax(row, cfg, device="cpu")) == \
                jb.register(name, row)
        else:
            assert tb.evict(name) == jb.evict(name)
        assert tb.version == jb.version
        same_factors()
    assert [tb.generation(i) for i in range(N)] == [jb.generation(i) for i in range(N)]
    assert tb.stats() == jb.stats()
    for aid in (0, 1, 2):
        assert tb.check_id(aid) == jb.check_id(aid)
    bad = adapter_from_jax(_rows_np(jb, 9), cfg, device="cpu")
    key = next(iter(bad))
    bad[key] = bad[key][:-1]
    tb.evict("b")
    with pytest.raises(ValueError, match="factor shape"):
        tb.register("d", bad)
    assert "d" not in tb.registry and len(tb.registry) == 1
    for aid, msg in ((2, "not registered"), (N, "out of range")):
        with pytest.raises(ValueError, match=msg):
            tb.check_id(aid)


# ------------------------------------------------------- masked fused AdamW

@pytest.fixture(scope="module")
def masked_adamw_run():
    """5 steps of the JAX ``fused_adamw(mask=lora_param_mask,
    interpret=True)`` on a LoRA tree and numpy gradients: (start tree,
    gradients, final params)."""
    tree = jax_lora_tree()
    jtx = jax_fused_adamw(1e-2, weight_decay=0.01, mask=jlora.lora_param_mask(tree),
                          interpret=True)
    jparams = jax.tree_util.tree_map(jnp.array, tree)
    jstate = jtx.init(jparams)
    rng = np.random.Generator(np.random.PCG64(8))
    grads = []
    for _ in range(5):
        grads.append(jax.tree_util.tree_map(
            lambda leaf: rng.standard_normal(leaf.shape).astype(np.float32), tree))
        updates, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads[-1]), jstate,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
    return tree, grads, _np(jparams)


@requires_pallas_interpret
@pytest.mark.parametrize("mask_kind", ["callable", "mapping"])
def test_masked_fused_adamw_matches_jax(masked_adamw_run, mask_kind):
    """5 steps of ``fused_adamw(mask=)`` (its plain route on the CPU)
    against the JAX ``fused_adamw(mask=..., interpret=True)`` on the same
    LoRA params and numpy gradients, the mask a callable or a mapping:
    base leaves bitwise their start on both sides, factors within the
    AdamW bound, moments only for the factor leaves."""
    _, cfg = configs()
    tree, grads, jparams = masked_adamw_run
    named = {k: v.clone() for k, v in from_jax_params(_np(tree), cfg, device="cpu").items()}
    start = {k: v.clone() for k, v in named.items()}
    mask = lora_param_mask if mask_kind == "callable" else lora_param_mask(named)
    tx = fused_adamw(1e-2, weight_decay=0.01, mask=mask)
    state = tx.init(named)
    assert len(state.mu) == len(lora_tree(named))
    for g in grads:
        tx.update_(named, from_jax_params(g, cfg, device="cpu"), state)
    want = from_jax_params(jparams, cfg, device="cpu")
    for k, v in named.items():
        if "_lora." in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=2.5e-7, atol=1e-7,
                                       err_msg=k)
            assert not torch.equal(v, start[k]) or not start[k].any()
        else:
            assert torch.equal(v, start[k]) and torch.equal(want[k], start[k]), k


# -------------------------------------------------------- Trainer fine-tune

@requires_pallas_interpret
@pytest.mark.parametrize("loss", ["cross_entropy", "fused_cross_entropy"])
def test_trainer_finetune_matches_jax(loss):
    """A tenant fine-tune: the port's ``Trainer(model_kwargs={"adapter_ids":
    1})`` with ``fused_adamw(mask=lora_param_mask)`` for 5 steps against
    the JAX ``make_train_step(model_kwargs=...)`` with the JAX masked fused
    AdamW, from the same weights and batch: per-step losses, the base
    leaves bitwise unchanged (frozen: no gradient), the factors, and a
    falling loss."""
    jcfg, cfg = configs()
    tree = _np(jlora.lora_init(jax_lora_tree(factor_scale=0.0), jax.random.PRNGKey(2)))
    toks = np.random.Generator(np.random.PCG64(6)).integers(0, 64, (4, 17))
    x, y = toks[:, :-1], toks[:, 1:]
    lr, steps = 1e-2, 5
    jstate = jtrainer.TrainState.create(
        apply_fn=jt.TransformerLM(jcfg).apply, params=jax.tree_util.tree_map(jnp.array, tree),
        tx=jax_fused_adamw(lr, weight_decay=0.01, mask=jlora.lora_param_mask(tree)))
    jstep = jtrainer.make_train_step(loss=loss, model_kwargs={"adapter_ids": 1})
    jlosses = []
    for _ in range(steps):
        jstate, m = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        jlosses.append(float(m["loss"]))
    loader = ShardedLoader(ArrayDataset((x, y)), 4, CPU, shuffle=False)
    trainer = Trainer(TransformerLM(cfg), loader, fused_adamw(lr, weight_decay=0.01,
                                                              mask=lora_param_mask),
                      loss=loss, model_kwargs={"adapter_ids": 1}, quiet=True)
    start = from_jax_params(tree, cfg, device="cpu")
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            p.copy_(start[name])
            assert p.requires_grad == ("_lora." in name)
    trainer.train(steps)
    losses = [e["loss"] for e in trainer.metrics.step_events()]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    want = from_jax_params(_np(jstate.params), cfg, device="cpu")
    for name, p in trainer.model.named_parameters():
        if "_lora." not in name:
            assert torch.equal(p, start[name]) and torch.equal(want[name], start[name]), name
            continue
        err = (p.detach() - want[name]).abs()
        assert float(err.max()) <= 2 * lr * steps, name
        assert float((err <= 2e-6).float().mean()) >= 0.999, name
    assert trainer.evaluate()["loss"] < losses[0]  # evaluation runs under the tenant too
