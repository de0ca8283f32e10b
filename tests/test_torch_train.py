"""The PyTorch port's LM train step against the JAX package's.

A toy float LM (vocab 128, d_model 64, 2 layers, 4 heads of 16, S 32),
MHA and GQA (``n_kv_heads=2``), both JAX parameter layouts (unrolled
``block_i`` and stacked ``layers/block``), dense attention and the flash
attention function (the JAX kernel in interpret mode; the port's plain
versions). Weights, tokens and targets are drawn with numpy from a seed;
both packages get the same values.

Tolerances and why:

- float32 logits ``atol 2e-5`` and gradients ``2e-5`` relative to each
  gradient's largest entry: the two packages sum the same float32 products
  in different orders (XLA vs oneDNN, the flash blocks);
- bfloat16 logits ``atol 0.05`` and gradients ``0.05`` relative: a bf16
  ulp is 2^-8 of the value and the two frameworks round the casts of the
  flax ``dtype=`` semantics at different places (the JAX flash test's own
  bf16 tolerance is 0.05);
- 5 train steps (float32): losses ``rtol 1e-5``; final params within
  ``2e-6`` for 99.9% of the elements and within ``2 * lr * 5`` for all
  (3 fused steps — the fused loss and fused AdamW against the JAX fused
  step — the same, with ``2 * lr * 3``).
  AdamW's first steps move every parameter by about ``lr`` = 3e-4
  whatever the gradient's size, so an element whose gradient nearly
  cancels (a few ulps of float32 summation order then decide its sign)
  can step the other way: measured, one element of 8192 in an embedding
  row, off by 5.6e-5;
- ``adamw`` alone against optax over 20 steps: ``atol 1e-7`` (the same
  float32 operations in the same order; only the float32 ``pow`` of the
  bias correction, and the port's multiply by its reciprocal where optax
  divides, may round differently).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.ops.flash_attention import (
    make_flash_attention as jax_make_flash,
)
from pytorch_distributed_training_tutorials_tpu.ops.fused_optim import (
    fused_adamw as jax_fused_adamw,
)
from pytorch_distributed_training_tutorials_tpu.train import trainer as jtrainer
from pytorch_distributed_training_tutorials_tpu_torch.bench import lm_headline
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
    init_lm,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs import validate_receipt
from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
    make_flash_attention,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
from pytorch_distributed_training_tutorials_tpu_torch.train import trainer as ttrainer
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw
from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig
from helpers import requires_pallas_interpret

pytestmark = requires_pallas_interpret

TOY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=32)
SEQ, BATCH = 32, 2
BLOCKS = (16, 16)  # several flash blocks over S = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Toy widths gain nothing from intra-op threads; one thread keeps
    this file from competing for cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_float_tree(jcfg, seed=0):
    """Float JAX params drawn with numpy: kernels N(0, 0.15^2), the
    embedding N(0, 1), norm scales 1 + N(0, 0.1^2). A stacked tree stacks
    the unrolled draws, so both layouts hold the same weights."""
    if jcfg.scan_layers:
        flat = jax_float_tree(dataclasses.replace(jcfg, scan_layers=False), seed)
        return jt.stack_quantized_lm_params(flat)
    shapes = jax.eval_shape(
        jt.TransformerLM(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4), jnp.int32),
    )["params"]
    rng = np.random.Generator(np.random.PCG64(seed))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        name = str(path[-2].key) if len(path) > 1 else ""
        if str(path[-1].key) == "scale":
            return (1.0 + 0.1 * x).astype(np.float32)
        if name == "tok_emb":
            return x
        return (0.15 * x).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batch_np(seed=1, vocab=TOY["vocab_size"]):
    rng = np.random.Generator(np.random.PCG64(seed))
    toks = rng.integers(0, vocab, (BATCH, SEQ + 1))
    return toks[:, :-1], toks[:, 1:]


def configs(dtype="f32", attn="dense", gqa=False, stacked=False, **kw):
    """The matching (JAX config, port config)."""
    extra = {"n_kv_heads": 2} if gqa else {}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jfn = jax_make_flash(*BLOCKS) if attn == "flash" else None
    tfn = make_flash_attention(*BLOCKS) if attn == "flash" else None
    jcfg = jt.TransformerConfig(**TOY, **extra, dtype=jdt, scan_layers=stacked,
                                attention_fn=jfn)
    cfg = TransformerConfig(**TOY, **extra, dtype=tdt, attention_fn=tfn, **kw)
    return jcfg, cfg


def port_model(cfg, tree):
    model = TransformerLM(cfg)
    bind_params(model, from_jax_params(to_np(tree), cfg, device="cpu"))
    return model


def jax_loss(jcfg):
    model = jt.TransformerLM(jcfg)

    def loss(params, x, y):
        logits = model.apply({"params": params}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    return loss


def port_grads(model, x, y):
    loss = ttrainer._compute_loss("cross_entropy", model(torch.tensor(x)), torch.tensor(y))
    names = [n for n, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss, dict(zip(names, grads))


def assert_grads_close(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].float()
        err = float((g.float() - w).abs().max())
        bound = rel * float(w.abs().max()) + 1e-12
        assert err <= bound, f"{name}: max abs err {err} > {bound}"


VARIANTS = [
    ("f32", "dense", False, False),
    ("f32", "flash", False, False),
    ("f32", "dense", True, False),
    ("f32", "flash", True, True),
    ("f32", "dense", False, True),
    ("bf16", "dense", False, False),
    ("bf16", "flash", True, False),
]


@pytest.mark.parametrize(
    "dtype,attn,gqa,stacked", VARIANTS,
    ids=["-".join([d, a] + (["gqa"] if g else []) + (["stacked"] if s else []))
         for d, a, g, s in VARIANTS],
)
def test_logits_and_grads_match_jax(dtype, attn, gqa, stacked):
    jcfg, cfg = configs(dtype, attn, gqa, stacked)
    tree = jax_float_tree(jcfg)
    x, y = batch_np()
    want_logits = np.asarray(
        jt.TransformerLM(jcfg).apply({"params": tree}, jnp.asarray(x, jnp.int32)),
        np.float32,
    )
    jloss, jgrad = jax.value_and_grad(jax_loss(jcfg))(tree, jnp.asarray(x), jnp.asarray(y))
    want_grads = from_jax_params(
        to_np(jax.tree_util.tree_map(lambda g: g.astype(jnp.float32), jgrad)),
        cfg, device="cpu",
    )
    model = port_model(cfg, tree)
    logits = model(torch.tensor(x))
    assert logits.dtype == cfg.dtype
    atol, rel = (2e-5, 2e-5) if dtype == "f32" else (0.05, 0.05)
    np.testing.assert_allclose(logits.detach().float().numpy(), want_logits, atol=atol, rtol=0)
    loss, grads = port_grads(model, x, y)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=rel)
    assert_grads_close(grads, want_grads, rel)


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("policy", [None, "dots", "dots_attn"])
def test_remat_gradients_equal_no_remat(attn, policy):
    jcfg, cfg = configs("f32", attn)
    tree = jax_float_tree(jcfg)
    x, y = batch_np()
    _, want = port_grads(port_model(cfg, tree), x, y)
    rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    _, got = port_grads(port_model(rcfg, tree), x, y)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


@pytest.mark.parametrize("policy", [None, "dots", "dots_attn"])
def test_remat_recomputes_flash_forward(monkeypatch, policy):
    """Under remat the flash forward runs again in the backward, "dots"
    included (the JAX ``_remat_policy`` docstring): two forwards per layer
    per step, one dq and one dk/dv — the 48/24/24 launches of a 760m step.
    "dots_attn" keeps the flash op's outputs (O and lse): one forward per
    layer per step — 24/24/24 at 760m."""
    from pytorch_distributed_training_tutorials_tpu_torch.ops import flash_attention as fa

    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        ref = f"flash_{name}_reference"
        monkeypatch.setattr(fa, ref, counting(name, getattr(fa, ref)))
    jcfg, cfg = configs("f32", "flash")
    model = port_model(dataclasses.replace(cfg, remat=True, remat_policy=policy),
                       jax_float_tree(jcfg))
    port_grads(model, *batch_np())
    n = TOY["n_layers"]
    fwd = n if policy == "dots_attn" else 2 * n
    assert calls == {"fwd": fwd, "dq": n, "dkv": n}


def _jax_flash_kernels(jaxpr, out):
    """Flash ``pallas_call``s in a JAX program by kind: the forward takes
    q, k, v; dq returns one output, dk/dv two."""
    from jax.extend import core as jcore

    for e in jaxpr.eqns:
        if e.primitive.name == "pallas_call":
            kind = "fwd" if len(e.invars) <= 3 else ("dq" if len(e.outvars) == 1 else "dkv")
            out[kind] = out.get(kind, 0) + 1
            continue
        for v in e.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                if isinstance(sub, jcore.ClosedJaxpr):
                    _jax_flash_kernels(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _jax_flash_kernels(sub, out)
    return out


@pytest.mark.parametrize("remat,policy", [(False, None), (True, None), (True, "dots"),
                                          (True, "dots_attn")],
                         ids=["no-remat", "none", "dots", "dots_attn"])
def test_jax_dots_attn_reruns_the_flash_forward(remat, policy):
    """A finding about the reference, pinned: the JAX ``"dots_attn"``
    policy saves its ``checkpoint_name``-tagged attention output, not the
    ``custom_vjp`` residuals (O and lse) the flash backward reads, so the
    forward runs twice a layer under every remat policy — the kernels of
    ``jax.grad`` of the toy model: no remat 2 / 2 / 2, any policy 4 / 2 /
    2. The port keeps the flash op's outputs under "dots_attn"
    (``test_remat_recomputes_flash_forward``: n / n / n)."""
    jcfg, _ = configs("f32", "flash")
    jcfg = dataclasses.replace(jcfg, remat=remat, remat_policy=policy)
    model, tree = jt.TransformerLM(jcfg), jax_float_tree(jcfg)
    x = jnp.asarray(batch_np()[0], jnp.int32)
    jaxpr = jax.make_jaxpr(jax.grad(
        lambda p: model.apply({"params": p}, x).astype(jnp.float32).sum()))(tree)
    n = TOY["n_layers"]
    assert _jax_flash_kernels(jaxpr.jaxpr, {}) == {"fwd": 2 * n if remat else n, "dq": n,
                                                    "dkv": n}


def _jax_state_and_step(jcfg, tree):
    model = jt.TransformerLM(jcfg)
    state = jtrainer.TrainState.create(
        apply_fn=model.apply, params=tree, tx=optax.adamw(3e-4, weight_decay=0.01)
    )
    return state, jax.jit(jtrainer._train_step_fn("cross_entropy"))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_five_train_steps_match_jax(attn):
    jcfg, cfg = configs("f32", attn)
    tree = jax_float_tree(jcfg)
    x, y = batch_np()
    jstate, jstep = _jax_state_and_step(jcfg, tree)
    model = port_model(cfg, tree)
    state = ttrainer.TrainState.create(model=model, tx=adamw(3e-4, weight_decay=0.01))
    step = ttrainer._train_step_fn("cross_entropy")
    jbatch = (jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32))
    tbatch = (torch.tensor(x), torch.tensor(y))
    for i in range(5):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"step {i}")
    assert int(state.step) == int(jstate.step) == 5
    want = from_jax_params(to_np(jstate.params), cfg, device="cpu")
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - want[name].numpy()).ravel()
        for name, p in model.named_parameters()
    ])
    # see the module docstring: an element whose gradient nearly cancels
    # can take AdamW's ~lr step the other way
    assert diffs.max() <= 2 * 3e-4 * 5, diffs.max()
    assert np.mean(diffs <= 2e-6) >= 0.999, np.sort(diffs)[-20:]


def test_adamw_matches_optax():
    rng = np.random.Generator(np.random.PCG64(5))
    shapes = [(7, 5), (13,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0 ** rng.integers(-6, 2)
              for s in shapes] for _ in range(20)]
    tx = optax.adamw(3e-4, weight_decay=0.01)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.tensor(p) for p in params]
    opt = adamw(3e-4, weight_decay=0.01)
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update_(tp, [torch.tensor(x) for x in g], ts)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)
    for a, b in zip(ts.mu, js[0].mu):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_compute_loss_mse_and_one_hot_match_jax():
    rng = np.random.Generator(np.random.PCG64(7))
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    one_hot = np.eye(11, dtype=np.float32)[labels]
    target = rng.standard_normal((3, 5, 11)).astype(np.float32)
    tl = torch.tensor(logits)
    for loss, tgt in (("cross_entropy", one_hot), ("cross_entropy", labels), ("mse", target)):
        want = float(jtrainer._compute_loss(loss, jnp.asarray(logits), jnp.asarray(tgt)))
        got = float(ttrainer._compute_loss(loss, tl, torch.tensor(tgt)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=loss)
    with pytest.raises(ValueError, match="unknown loss"):
        ttrainer._compute_loss("hinge", tl, torch.tensor(labels))


def test_train_step_refuses_later_slice_options():
    # aux_loss_weight is taken since the MoE slice (tests/test_torch_moe.py);
    # what the step refuses is a gradient accumulation below one step
    assert callable(ttrainer.make_train_step(aux_loss_weight=0.1))
    with pytest.raises(ValueError, match="grad_accum_steps must be >= 1"):
        ttrainer.make_train_step(grad_accum_steps=0)
    # the DDP slice brought gradient accumulation and BatchNorm statistics,
    # the guardrails slice the skip-step guard and chaos (test_torch_guardrails.py),
    # the LoRA slice model_kwargs and fused_adamw(mask=) (test_torch_adapters.py)
    assert callable(ttrainer.make_train_step(grad_accum_steps=2, has_batch_stats=True))
    assert callable(ttrainer.make_train_step(grad_accum_steps=2, skip_nonfinite=True,
                                             chaos=ChaosConfig(nan_grad_step=0)))
    assert callable(ttrainer.make_train_step(model_kwargs={"adapter_ids": 1}))
    assert fused_adamw(3e-4, mask={"lm_head": True}).mask == {"lm_head": True}


def test_train_step_forwards_model_kwargs():
    """``model_kwargs`` reach every forward of the step: a LoRA model's
    loss under ``adapter_ids`` 1 is the forward's with that id, and the
    step's update moves only what the masked optimizer trains."""
    from pytorch_distributed_training_tutorials_tpu_torch.adapters import lora_param_mask

    _, cfg = configs("f32", "dense", lora_adapters=2, lora_rank=2)
    model = TransformerLM(cfg)
    params = init_lm(cfg, seed=0, device="cpu")
    for name, t in params.items():
        if "_lora." in name:
            t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(1)) * 0.3)
    bind_params(model, params)
    x, y = (torch.tensor(a) for a in batch_np())
    with torch.no_grad():
        want = float(ttrainer._compute_loss("cross_entropy", model(x, adapter_ids=1), y))
        base = float(ttrainer._compute_loss("cross_entropy", model(x), y))
    assert want != base
    state = ttrainer.TrainState.create(
        model=model, tx=fused_adamw(1e-2, mask=lora_param_mask))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = ttrainer.make_train_step(model_kwargs={"adapter_ids": 1})
    state, metrics = step(state, (x, y))
    assert float(metrics["loss"]) == want
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]) != ("_lora." in name), name


def test_init_lm_distributions():
    cfg = TransformerConfig(vocab_size=512, d_model=128, n_layers=1, n_heads=4,
                            d_ff=256, quantized=False)
    params = init_lm(cfg, seed=3, device="cpu")
    assert set(params) == set(TransformerLM(cfg).state_dict())
    assert torch.equal(init_lm(cfg, seed=3, device="cpu")["lm_head.weight"],
                       params["lm_head.weight"])
    w = params["blocks.0.attn.o_proj.weight"]  # fan_in = H * D = 128
    assert abs(float(w.std()) - (1 / 128) ** 0.5) < 0.1 * (1 / 128) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 128) ** 0.5 / 0.87962566103423978 + 1e-6
    emb = params["tok_emb.weight"]
    assert abs(float(emb.std()) - (1 / 128) ** 0.5) < 0.05 * (1 / 128) ** 0.5
    assert torch.equal(params["blocks.0.mlp_norm.scale"], torch.ones(128))


def test_config_refusals():
    # "dots_attn" is accepted since the flash op is a torch.library op
    # (test_remat_recomputes_flash_forward holds its launches)
    assert TransformerConfig(quantized=False, remat=True,
                             remat_policy="dots_attn").remat_policy == "dots_attn"
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TransformerConfig(quantized=False, remat_policy="everything")
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        TransformerConfig(quantized=False, dtype=torch.float16)
    # int8 weights are not trained: remat stays refused with quantized=True,
    # while attention_fn (flash prefill) is taken since the prefill slice
    with pytest.raises(NotImplementedError, match="remat"):
        TransformerConfig(quantized=True, remat=True)
    assert TransformerConfig(quantized=True,
                             attention_fn=make_flash_attention()).attention_fn is not None


def test_bench_cpu_smoke_prints_one_json_line(capsys):
    lm_headline.main(["--device", "cpu", "--preset", "smoke", "--seq", "64",
                      "--batch", "2", "--steps", "2", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    # the graft-receipt/v1 envelope: the payload flat beside schema, kind, env
    assert validate_receipt(r, kind="lm_headline") == []
    assert r["env"]["backend"] == "cpu" and r["env"]["nvidia_smi"] is None
    assert r["env"]["torch_version"] == torch.__version__
    res = r
    for key in ("preset", "n_params", "step_ms", "tokens_per_s", "mfu",
                "model_tflops_per_step", "peak_memory_bytes", "losses_first_chain",
                "flash_launches", "steps_run", "block_note", "attn"):
        assert key in res, key
    assert res["device"] == "cpu" and res["mfu"] is None
    assert res["steps_run"] == 4 and res["all_losses_finite"]
    assert res["flash_launches"] == {"fwd": 0, "dq": 0, "dkv": 0}  # CPU: plain versions


def test_bench_refuses_cpu_unless_asked_and_fused():
    """Without a GPU the bench raises unless ``--device cpu`` is given;
    ``--fused`` runs now (see the smoke below), ``--scan`` still raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_headline.main(["--preset", "smoke", "--steps", "1", "--reps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_headline.main(["--preset", "smoke", "--steps", "1", "--reps", "1", "--fused"])
    with pytest.raises(NotImplementedError, match="--scan"):
        lm_headline.main(["--device", "cpu", "--preset", "smoke", "--scan"])


def test_bench_fused_cpu_smoke_prints_both_arms(capsys):
    lm_headline.main(["--device", "cpu", "--preset", "smoke", "--seq", "64",
                      "--batch", "2", "--steps", "2", "--reps", "1", "--fused"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert validate_receipt(r, kind="lm_headline") == []
    assert r["env"]["nvidia_smi"] is None
    assert set(r) - {"schema", "kind", "env"} == {"baseline", "fused"}
    base, fused = r["baseline"], r["fused"]
    assert (base["loss"], base["optimizer"]) == ("cross_entropy", "adamw")
    assert (fused["loss"], fused["optimizer"]) == ("fused_cross_entropy", "fused_adamw")
    for arm in (base, fused):
        assert arm["steps_run"] == 4 and arm["all_losses_finite"]
        # CPU: the plain versions, no kernel launched
        assert arm["fused_loss_launches"] == {"fwd": 0, "dh": 0, "dw": 0}
        assert arm["fused_adamw_launches"] == 0
    # the same weights and batch: the first losses agree to a bf16 ulp
    # (the baseline's loss is a bf16 value, the fused loss f32)
    assert abs(fused["losses_first_chain"][0] - base["losses_first_chain"][0]) <= 2.0 ** -5
    assert fused["losses_first_chain"][-1] < fused["losses_first_chain"][0]


def _jax_fused_state_and_step(jcfg, tree):
    model = jt.TransformerLM(jcfg)
    state = jtrainer.TrainState.create(
        apply_fn=model.apply, params=tree,
        tx=jax_fused_adamw(3e-4, weight_decay=0.01, interpret=True),
    )
    return state, jax.jit(jtrainer._train_step_fn("fused_cross_entropy"))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_fused_train_steps_match_jax(attn):
    """Three train steps with the fused loss and fused AdamW against the
    JAX package's fused step (Pallas kernels in interpret mode) on the same
    weights: the losses and the parameters, at the tolerances of
    ``test_five_train_steps_match_jax``."""
    jcfg, cfg = configs("f32", attn)
    tree = jax_float_tree(jcfg)
    x, y = batch_np()
    jstate, jstep = _jax_fused_state_and_step(jcfg, tree)
    model = port_model(cfg, tree)
    state = ttrainer.TrainState.create(model=model, tx=fused_adamw(3e-4, weight_decay=0.01))
    step = ttrainer._train_step_fn("fused_cross_entropy")
    jbatch = (jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32))
    tbatch = (torch.tensor(x), torch.tensor(y))
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        assert m["loss"].dtype == torch.float32
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"step {i}")
    assert int(state.step) == int(jstate.step) == 3
    want = from_jax_params(to_np(jstate.params), cfg, device="cpu")
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - want[name].numpy()).ravel()
        for name, p in model.named_parameters()
    ])
    assert diffs.max() <= 2 * 3e-4 * 3, diffs.max()
    assert np.mean(diffs <= 2e-6) >= 0.999, np.sort(diffs)[-20:]


def test_fused_loss_equals_cross_entropy_through_the_model():
    """``return_hidden`` and the fused loss give the logits path's loss and
    gradients (f32, the same weights): the logits-free seam is exact up to
    summation order."""
    jcfg, cfg = configs("f32", "dense")
    tree = jax_float_tree(jcfg)
    x, y = batch_np()
    batch = (torch.tensor(x), torch.tensor(y))
    out = {}
    for loss in ("cross_entropy", "fused_cross_entropy"):
        model = port_model(cfg, tree)
        value = ttrainer._make_loss_fn(loss)(model, batch)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(value, [p for _, p in model.named_parameters()])
        out[loss] = (float(value.detach()), dict(zip(names, grads)))
    np.testing.assert_allclose(out["fused_cross_entropy"][0], out["cross_entropy"][0], rtol=1e-6)
    assert_grads_close(out["fused_cross_entropy"][1], out["cross_entropy"][1], 2e-5)
    hidden = port_model(cfg, tree)(batch[0], return_hidden=True)
    assert hidden.shape == (BATCH, SEQ, TOY["d_model"])
