"""Sequence parallelism in the PyTorch port — ring and Ulysses attention,
``ShardedLoader(batch_spec=)`` and ``TensorParallel(seq_axis=)`` — in a
gloo world of 2 (``{"seq": 2}``), against the JAX package's
``make_ring_attention`` / ``make_ulysses_attention`` on a ``{"seq": 2}``
mesh of the CPU devices and its single-device train step.

Each rank holds its (B, S/2, H, D) block. Tolerances and why:

- attention outputs ``atol 2e-5`` (``tests/test_ring_attention.py:41-55``)
  and the gradients of the mean of ``out ** 2`` ``rtol 1e-4, atol 1e-6``
  (``tests/test_ulysses.py:69``): both sides fold the same float32
  products, in other blockings;
- ``hop_block`` 8 against 16 (a hop of 16 positions): outputs and
  gradients within ``1e-5`` (the JAX test's own ``hop_block`` bound);
- the LM (toy widths, float32, dense inner attention): one step's loss
  ``rtol 1e-6`` and every gradient (the two ranks' average, what the
  trainer's seq mean takes) within ``2e-5`` of its largest entry
  (``tests/test_torch_train.py``'s float32 bounds); three ``Trainer``
  steps hold the JAX losses at ``rtol 1e-5`` and the parameters within
  ``2e-6`` for 99.9% of the elements and ``2 * lr * steps`` for all.
  The same step with the RoPE offset planted at 0 (rank 1's positions
  start at 0 again) must miss those bounds: a finite, falling loss that
  is another model;
- generation: tokens equal to the JAX dense model's greedy tokens from a
  5-token prompt, which the seq axis does not divide (the port's serving
  paths hold every token on every rank and prefill through the dense
  causal path at any length).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_sp_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.models.generate import generate as jax_generate
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.parallel.ring_attention import (
    make_ring_attention as jax_ring,
)
from pytorch_distributed_training_tutorials_tpu.parallel.ulysses import (
    make_ulysses_attention as jax_ulysses,
)
from pytorch_distributed_training_tutorials_tpu.train import trainer as jtrainer
from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerConfig, from_jax_params
from pytorch_distributed_training_tutorials_tpu_torch.parallel import create_mesh, make_ring_attention
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp
from test_torch_train import batch_np, jax_float_tree, to_np

SPEC = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=32)
STEPS = 3
PROMPT, NEW = 5, 4


def jax_steps(jcfg, tree, x, y, steps: int, aux_loss_weight: float = 0.0):
    """``steps`` JAX single-device AdamW steps on one batch: the losses
    and the final parameters (numpy)."""
    state = jtrainer.TrainState.create(apply_fn=jt.TransformerLM(jcfg).apply, params=tree,
                                       tx=optax.adamw(torch_sp_worker.LR, weight_decay=0.01))
    step = jax.jit(jtrainer._train_step_fn("cross_entropy", aux_loss_weight=aux_loss_weight))
    losses = []
    for _ in range(steps):
        state, m = step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(m["loss"]))
    return losses, to_np(state.params)


def jax_grads(jcfg, tree, x, y, aux_loss_weight: float = 0.0):
    """The JAX single-device objective's value and gradient tree."""
    loss_fn = jtrainer._make_loss_fn("cross_entropy", False, aux_loss_weight)
    state = jtrainer.TrainState.create(apply_fn=jt.TransformerLM(jcfg).apply, params=tree,
                                       tx=optax.sgd(0.0))
    fn = jax.jit(lambda p, b: jax.value_and_grad(loss_fn, has_aux=True)(p, state, b))
    (value, _), grads = fn(tree, (jnp.asarray(x), jnp.asarray(y)))
    return float(value), to_np(grads)


def grads_gap(got: dict, want: dict) -> float:
    """The largest gradient gap over its leaf's largest entry."""
    return max(float((got[n] - w).abs().max() / w.abs().max()) for n, w in want.items())


def params_within(got: dict, want: dict, steps: int) -> None:
    diffs = np.concatenate([(got[n] - w).abs().reshape(-1).numpy() for n, w in want.items()])
    assert diffs.max() <= 2 * torch_sp_worker.LR * steps, diffs.max()
    assert np.mean(diffs <= 2e-6) >= 0.999, np.sort(diffs)[-20:]


def _qkv(b=2, s=32, h=4, d=16, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))


def _jax_attention(fn, q, k, v):
    args = tuple(jnp.asarray(t) for t in (q, k, v))
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(lambda *a: (fn(*a) ** 2).mean(), argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def setup(tmp_path_factory, devices):
    workdir = tmp_path_factory.mktemp("seq")
    jcfg = jt.TransformerConfig(**SPEC)
    tree = jax_float_tree(jcfg)
    cfg = TransformerConfig(**SPEC)
    whole = from_jax_params(to_np(tree), cfg, device="cpu")
    x, y = batch_np()
    q, k, v = _qkv()
    prompt = np.random.Generator(np.random.PCG64(3)).integers(0, SPEC["vocab_size"], (2, PROMPT))
    torch.save({"spec": SPEC, "params": whole, "x": torch.tensor(x), "y": torch.tensor(y),
                "q": torch.tensor(q), "k": torch.tensor(k), "v": torch.tensor(v),
                "prompt": torch.tensor(prompt), "new": NEW}, workdir / "seq.pt")
    ranks = spawn_tp(torch_sp_worker.seq_case, 2, (str(workdir), STEPS), backend="gloo",
                     device="cpu")
    jm = jax_mesh({"seq": 2}, devices=devices[:2])
    return {
        "ranks": ranks, "cfg": cfg, "x": x, "y": y, "q": q,
        "jax_attention": {"ring": _jax_attention(jax_ring(jm, hop_block=8), q, k, v),
                          "ulysses": _jax_attention(jax_ulysses(jm), q, k, v)},
        "jax_grads": jax_grads(jcfg, tree, x, y),
        "jax_steps": jax_steps(jcfg, tree, x, y, STEPS),
        "jax_tokens": np.asarray(jax_generate(jt.TransformerLM(jcfg), tree,
                                              jnp.asarray(prompt, jnp.int32), NEW)),
    }


def _block(a, r, n=2):
    k = a.shape[1] // n
    return a[:, r * k:(r + 1) * k]


@pytest.mark.parametrize("name", ["ring_8", "ulysses"])
def test_attention_matches_jax_on_a_seq_mesh(setup, name):
    want_out, want_grads = setup["jax_attention"][name.split("_")[0]]
    for r in setup["ranks"]:
        got = r["attention"][name]
        np.testing.assert_allclose(got["out"].numpy(), _block(want_out, r["rank"]), atol=2e-5)
        for g, w in zip(got["grads"], want_grads):
            np.testing.assert_allclose(g.numpy(), _block(w, r["rank"]), rtol=1e-4, atol=1e-6)
        # the ring: one hop forward, its transpose backward; Ulysses: two
        # all_to_alls forward, two backward
        want = ({"ring_hop": 1, "ring_hop_grad": 1} if name.startswith("ring")
                else {"all_to_all": 4})
        assert got["collectives"] == want


def test_hop_block_does_not_change_the_ring(setup):
    for r in setup["ranks"]:
        a, b = r["attention"]["ring_8"], r["attention"]["ring_16"]
        np.testing.assert_allclose(a["out"].numpy(), b["out"].numpy(), rtol=1e-5, atol=1e-5)
        for ga, gb in zip(a["grads"], b["grads"]):
            np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-5, atol=1e-5)


def test_ulysses_refuses_heads_the_seq_axis_does_not_divide(setup):
    for r in setup["ranks"]:
        assert "divisible" in r["ulysses_refusal"] and "(3 local)" in r["ulysses_refusal"]


def test_loader_gives_each_rank_its_sequence_block(setup):
    for r in setup["ranks"]:
        xb, yb = r["loader"]
        np.testing.assert_array_equal(xb.numpy(), _block(setup["x"], r["rank"]))
        np.testing.assert_array_equal(yb.numpy(), _block(setup["y"], r["rank"]))


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sp_step_gradients_match_jax_single_device(setup, attn):
    """The two ranks' losses and gradients averaged (the seq mean the
    trainer takes) against the JAX single-device step; the planted RoPE
    offset 0 misses both bounds."""
    jloss, jgrads = setup["jax_grads"]
    want = from_jax_params(jgrads, setup["cfg"], device="cpu")
    runs = [r[attn] for r in setup["ranks"]]

    def averaged(key):
        loss = sum(float(r[key]["loss"] if key else r["loss"]) for r in runs) / 2
        grads = {n: sum((r[key] if key else r)["grads"][n] for r in runs) / 2 for n in want}
        return loss, grads

    loss, grads = averaged(None)
    assert loss == pytest.approx(jloss, rel=1e-6)
    assert grads_gap(grads, want) <= 2e-5
    bad_loss, bad_grads = averaged("planted_offset_0")
    assert np.isfinite(bad_loss)
    assert grads_gap(bad_grads, want) > 100 * 2e-5
    # per layer: ring 1 hop forward + 1 back, Ulysses 2 + 2 all_to_alls
    per_layer = ({"ring_hop": 1, "ring_hop_grad": 1} if attn == "ring" else {"all_to_all": 4})
    for r in runs:
        assert r["collectives"] == {k: v * SPEC["n_layers"] for k, v in per_layer.items()}


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sp_trainer_steps_match_jax_single_device(setup, attn):
    """``Trainer(strategy=TensorParallel(mesh, [], seq_axis="seq"))`` with
    ``batch_spec=("data", "seq")``: three steps against the JAX
    single-device step; the seq mean one bucketed all_reduce a step."""
    jlosses, jparams = setup["jax_steps"]
    want = from_jax_params(jparams, setup["cfg"], device="cpu")
    runs = [r[attn]["train"] for r in setup["ranks"]]
    np.testing.assert_allclose(runs[0]["losses"], jlosses, rtol=1e-5)
    assert runs[0]["losses"][-1] < runs[0]["losses"][0]
    params_within(runs[0]["params"], want, STEPS)
    for r in runs:
        assert r["losses"] == runs[0]["losses"] and r["step"] == STEPS
        for n, p in r["params"].items():
            assert torch.equal(p, runs[0]["params"][n]), n
        assert r["collectives"] == {"all_reduce": 0, "all_gather": 0, "seq_all_reduce": STEPS}
        assert np.isfinite(r["eval"]["loss"]) and r["eval"]["samples"] == setup["x"].size


def test_sp_model_generates_for_any_prompt_length(setup):
    for r in setup["ranks"]:
        np.testing.assert_array_equal(r["generate"].numpy(), setup["jax_tokens"])


def test_ring_refuses_a_mesh_without_a_seq_axis():
    with pytest.raises(ValueError, match="no 'seq' axis"):
        make_ring_attention(create_mesh(device="cpu"))
    one = make_ring_attention(create_mesh({"seq": 1}, device="cpu"))
    assert one.requires_seq_divisible == 1 and one.seq_shard.position_offset(8) == 0
    cfg = dataclasses.replace(TransformerConfig(**SPEC), attention_fn=one)
    assert cfg.attention_fn.seq_shard.size == 1
