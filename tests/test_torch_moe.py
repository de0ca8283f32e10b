"""The PyTorch port's mixture-of-experts FFN, its transformer blocks and
``Trainer(aux_loss_weight=)`` against the JAX package's ``models/moe.py``,
in process on the CPU.

Weights and inputs are drawn with numpy (or by the JAX initializer) and
bridged through ``models/convert.py``. Tolerances and why:

- ``MoEFFN`` outputs ``atol 1e-5`` against JAX (the same float32 einsums
  in another order; a token routed differently would be off by a whole
  expert's output, far outside) and ``atol 1e-4`` against the per-token
  loop of ``tests/test_moe.py:24`` (its own bound);
- the kept (token, expert) pairs under capacity pressure equal, exactly,
  a plain statement of the capacity order (first choices before second,
  in sequence order), and the outputs match JAX there too: the same
  tokens are dropped;
- the load-balancing loss ``rtol 1e-6`` against the JAX sown value;
- grouped against ungrouped dispatch with capacity headroom ``1e-5``
  (``tests/test_moe.py``'s bound), odd lengths padded;
- the MoE transformer's logits ``atol 2e-5`` and gradients ``2e-5`` of
  their largest entry, three AdamW steps with ``aux_loss_weight`` 0.01:
  losses ``rtol 1e-5``, parameters within ``2e-6`` for 99.9% of the
  elements and ``2 * lr * steps`` for all (``tests/test_torch_train.py``'s
  float32 bounds; ``tests/test_moe.py:161`` allows ``rtol 1e-3`` for its
  expert-parallel pair);
- greedy decoding of a grouped MoE model (decode at S 1): tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.models import moe as jmoe
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.models.generate import generate as jax_generate
from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    MOE_RULES,
    TP_RULES,
    MoEFFN,
    TransformerConfig,
    TransformerLM,
    bind_params,
    ep_rules,
    from_jax_params,
    generate,
    moe_aux_loss,
    moe_dropped,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.convert import jax_leaf_to_port
from pytorch_distributed_training_tutorials_tpu_torch.parallel import create_mesh
from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer
from pytorch_distributed_training_tutorials_tpu_torch.train import trainer as ttrainer
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw
from test_moe import _naive_moe
from test_torch_seq_parallel import grads_gap, jax_grads, jax_steps, params_within
from test_torch_train import jax_float_tree, to_np

SPEC = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=32,
            moe_experts=4, moe_top_k=2)
AUX, STEPS = 0.01, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.Generator(np.random.PCG64(seed)).standard_normal(shape).astype(np.float32)


def _pair(x, **kw):
    """A JAX ``MoEFFN`` initialized on ``x`` and the port's on its weights."""
    jm = jmoe.MoEFFN(**kw)
    params = to_np(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tm = MoEFFN(x.shape[-1], kw["num_experts"], kw["top_k"], kw.get("d_ff"),
                kw.get("capacity_factor", 1.25), group_size=kw.get("group_size"))
    tm.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    return jm, params, tm


def _jax_out(jm, params, x):
    out, updates = jax.jit(lambda p, a: jm.apply({"params": p}, a, mutable=["losses"]))(
        params, jnp.asarray(x))
    return np.asarray(out), float(updates["losses"]["moe_aux_loss"][0])


def test_moeffn_matches_jax_and_the_per_token_loop():
    x = _x((2, 8, 16), 0)
    jm, params, tm = _pair(x, num_experts=4, top_k=2, d_ff=32, capacity_factor=8.0)
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, _jax_out(jm, params, x)[0], atol=1e-5)
    np.testing.assert_allclose(got, _naive_moe(x, params, top_k=2, num_experts=4), atol=1e-4)
    assert int(tm.dropped) == 0


def _kept_reference(x, router, e, k, cap):
    """(B, S, E) bool: which routed (token, expert) pairs find a slot —
    every row's first choices queue in sequence order, then its second
    choices behind them."""
    logits = x @ router
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    order = np.argsort(-gates, axis=-1, kind="stable")[..., :k]
    kept = np.zeros(gates.shape, bool)
    for b in range(x.shape[0]):
        filled = np.zeros(e, int)
        for choice in range(k):
            for s in range(x.shape[1]):
                ex = order[b, s, choice]
                if filled[ex] < cap:
                    kept[b, s, ex] = True
                filled[ex] += 1
    return kept


def test_capacity_drops_the_same_tokens_as_jax():
    x = _x((2, 16, 16), 1)
    e, k, f = 4, 2, 0.5
    jm, params, tm = _pair(x, num_experts=e, top_k=k, d_ff=32, capacity_factor=f)
    cap = int(-(-16 * k // e) * f)
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
        dispatch = tm._route(torch.tensor(x), None)[0]
    np.testing.assert_allclose(got, _jax_out(jm, params, x)[0], atol=1e-5)
    kept = _kept_reference(x, params["router"], e, k, cap)
    np.testing.assert_array_equal(dispatch.sum(-1).numpy() > 0, kept)
    assert int(tm.dropped) == 2 * 16 * k - kept.sum() > 0
    assert np.isfinite(got).all()


def test_aux_loss_equals_the_jax_sown_value():
    x = _x((2, 8, 16), 2)
    jm, params, tm = _pair(x, num_experts=4, top_k=1)
    with torch.no_grad():
        tm(torch.tensor(x))
    assert float(tm.aux_loss) == pytest.approx(_jax_out(jm, params, x)[1], rel=1e-6)
    assert float(tm.aux_loss) >= 1.0 - 1e-6  # 1.0 is a perfectly balanced load


@pytest.mark.parametrize("s", [64, 60])
def test_grouped_dispatch_matches_ungrouped_with_odd_lengths_padded(s):
    x = _x((2, s, 16), 3)
    jm, params, grouped = _pair(x, num_experts=4, top_k=2, capacity_factor=4.0, group_size=16)
    whole = MoEFFN(16, 4, 2, capacity_factor=4.0)
    whole.load_state_dict(grouped.state_dict())
    with torch.no_grad():
        got = grouped(torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), whole(torch.tensor(x)).numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _jax_out(jm, params, x)[0], atol=1e-5)


def test_moe_transformer_matches_jax():
    """The stacked (``scan_layers``) layout: logits, and the objective
    with the aux loss and its gradients."""
    jcfg = jt.TransformerConfig(**SPEC, scan_layers=True)
    tree = jax_float_tree(jcfg)
    cfg = TransformerConfig(**SPEC)
    model = TransformerLM(cfg)
    bind_params(model, from_jax_params(to_np(tree), cfg, device="cpu"))
    assert tuple(model.blocks[1].moe.w_down.shape) == (4, 256, 64)
    x, y = _tokens()
    jlogits = jax.jit(jt.TransformerLM(jcfg).apply)({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.tensor(x)).numpy(), np.asarray(jlogits),
                                   atol=2e-5)
    jloss, jgrads = jax_grads(jcfg, tree, x, y, AUX)
    value = _objective(model, x, y)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(value, list(model.parameters()))))
    assert float(value.detach()) == pytest.approx(jloss, rel=1e-6)
    assert grads_gap(grads, from_jax_params(jgrads, cfg, device="cpu")) <= 2e-5


def test_moe_bridge_reads_both_layouts():
    """The unrolled (``block_i/moe/...``) and stacked (``layers/block/moe``)
    trees of the same draws bridge to the same bytes, router and experts
    float32 in the JAX layout."""
    jcfg = jt.TransformerConfig(**SPEC)
    cfg = TransformerConfig(**SPEC)
    flat = from_jax_params(to_np(jax_float_tree(jcfg)), cfg, device="cpu")
    stacked = from_jax_params(to_np(jt.stack_quantized_lm_params(jax_float_tree(jcfg))), cfg,
                              device="cpu")
    assert flat.keys() == stacked.keys()
    for n, t in flat.items():
        assert torch.equal(t, stacked[n]), n
    assert flat["blocks.0.moe.router"].shape == (64, 4)
    assert flat["blocks.0.moe.w_gate"].dtype == torch.float32


def _objective(model, x, y):
    return ttrainer._make_loss_fn("cross_entropy", aux_loss_weight=AUX)(
        model, (torch.tensor(x), torch.tensor(y)))


def _tokens(b=2, s=32, seed=1):
    rng = np.random.Generator(np.random.PCG64(seed))
    toks = rng.integers(0, SPEC["vocab_size"], (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


def test_trainer_with_aux_loss_matches_jax():
    """``Trainer(aux_loss_weight=0.01)``: three steps against the JAX
    step that adds its sown losses; the MoE layers' dropped counts
    are those of the step's forward."""
    jcfg = jt.TransformerConfig(**SPEC)
    tree = jax_float_tree(jcfg)
    cfg = TransformerConfig(**SPEC)
    whole = from_jax_params(to_np(tree), cfg, device="cpu")
    x, y = _tokens()
    loader = ShardedLoader(ArrayDataset((x, y)), 2, create_mesh(device="cpu"), shuffle=False)
    trainer = Trainer(TransformerLM(cfg), loader, adamw(3e-4, weight_decay=0.01),
                      aux_loss_weight=AUX, quiet=True)
    with torch.no_grad():
        for n, p in trainer.model.named_parameters():
            p.copy_(whole[n])
    trainer.train(STEPS)
    jlosses, jparams = jax_steps(jcfg, tree, x, y, STEPS, aux_loss_weight=AUX)
    losses = [e["loss"] for e in trainer.metrics.step_events()]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = {n: p.detach() for n, p in trainer.model.named_parameters()}
    params_within(got, from_jax_params(jparams, cfg, device="cpu"), STEPS)
    assert all(int(d) >= 0 for d in moe_dropped(trainer.model))
    assert len(moe_dropped(trainer.model)) == SPEC["n_layers"]
    assert float(moe_aux_loss(trainer.model)) >= SPEC["n_layers"] * (1 - 1e-6)


def test_grouped_moe_model_decodes_like_jax():
    """A grouped MoE model generates (decode at S 1 clamps the group): the
    port's greedy tokens equal the JAX package's."""
    spec = dict(vocab_size=32, d_model=32, n_layers=1, n_heads=2, max_seq_len=32,
                moe_experts=4, moe_top_k=2, moe_group_size=8)
    jcfg = jt.TransformerConfig(**spec)
    tree = jax_float_tree(jcfg)
    prompt = np.random.Generator(np.random.PCG64(4)).integers(0, 32, (1, 4))
    want = np.asarray(jax_generate(jt.TransformerLM(jcfg), tree, jnp.asarray(prompt, jnp.int32),
                                   6))
    cfg = TransformerConfig(**spec)
    got = generate(TransformerLM(cfg), from_jax_params(to_np(tree), cfg, device="cpu"),
                   torch.tensor(prompt), 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_refusals_and_rules():
    base = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, moe_experts=4)
    with pytest.raises(ValueError, match="dense blocks only"):
        TransformerConfig(**base, quantized=True)
    with pytest.raises(ValueError, match="LoRA adapters support dense blocks only"):
        TransformerConfig(**base, lora_adapters=2, lora_rank=2)
    with pytest.raises(ValueError, match="dense blocks only"):
        jax_leaf_to_port(("block_0", "moe", "router"), torch.zeros(32, 4), quantized=True)
    assert ep_rules() == MOE_RULES + TP_RULES
    with pytest.raises(ValueError, match="4 experts over an expert group of 3"):
        class Three:
            tp_size, rank = 3, 0
        MoEFFN(32, 4, ep=Three())
    assert float(moe_aux_loss(TransformerLM(TransformerConfig(**{**base, "moe_experts": 0}),
                                            device="cpu"))) == 0.0
