"""The port's quantized tensor-parallel model against the JAX package's
``int8_mesh`` model, and what tensor-parallel serving refuses.

A toy LM (vocab 128, d_model 64, 2 layers, 4 heads, d_ff 256, window 64)
initialized by the JAX package, quantized by both packages (bitwise the
same codes) and converted through ``models/convert.py:from_jax_params``.
One gloo world of 2 spawned ranks (``tests/torch_tp_worker.py``) runs the
port's model with ``int8_mesh`` = its ``TensorParallel``; the JAX model
runs here with ``int8_mesh`` = a ``{"model": 2}`` mesh of the forced
8-device CPU mesh — the same Megatron split (row layers quantize their
activations per LOCAL K-tile, in both packages).

Tolerances and why: logits (full sequence; prefill then decode steps)
within ``atol 1e-4`` of the JAX model's, on logits of order 1 — the
tolerance of ``tests/test_torch_transformer.py`` for the unsharded pair
(the port's attention and RMSNorm statistics run in float64, the
packages' ``cos``/``sin`` differ in the last ulp, and an ulp can move one
int8 activation code). Not held token-exact to the replicated int8 model:
the row split's local K-tiles regroup the activation quantization (the
JAX package's own non-strict pins, ``tests/test_int8_serving.py``); its
distance from it is bounded at 5% of the logit scale, the JAX test's
bound. Every rank's logits are the same bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    spawn_tp,
)

SPEC = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=256, max_seq_len=64)
ATOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_int8")
    jcfg = jt.TransformerConfig(**SPEC)
    params = jt.TransformerLM(jcfg).init(jax.random.PRNGKey(3),
                                         jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = TransformerConfig(**SPEC, quantized=True)
    whole = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    tokens = np.random.Generator(np.random.PCG64(5)).integers(0, SPEC["vocab_size"], (2, 12))
    torch.save(whole, workdir / "int8.pt")
    torch.save(SPEC, workdir / "int8_cfg.pt")
    torch.save(torch.tensor(tokens), workdir / "int8_tokens.pt")
    ranks = spawn_tp(torch_tp_worker.int8_cases, 2, (str(workdir),), backend="gloo",
                     device="cpu")
    qparams = jt.quantize_lm_params(params)
    jtp = jt.TransformerLM(dataclasses.replace(jcfg, quantized=True,
                                               int8_mesh=jax_mesh({"model": 2})))
    jax_logits = np.asarray(jax.jit(jtp.apply)({"params": qparams}, jnp.asarray(tokens)))
    rep = TransformerLM(cfg)
    bind_params(rep, whole)
    return {"ranks": ranks, "jax": jax_logits, "replicated": rep(torch.tensor(tokens))}


def test_quantized_tp_logits_match_jax_int8_mesh(setup):
    for got in setup["ranks"]:
        np.testing.assert_allclose(got["full"].numpy(), setup["jax"], rtol=0, atol=ATOL)
        # the cached path: prefill of 4 (its last position) then 8 decode steps
        np.testing.assert_allclose(got["cached"].numpy(), setup["jax"][:, 3:], rtol=0,
                                   atol=ATOL)
        assert got["kv_shape"] == (2, 2, 65, 2, 16)  # 2 of the 4 KV heads


def test_quantized_tp_ranks_agree_and_stay_near_replicated(setup):
    ranks = setup["ranks"]
    for got in ranks[1:]:
        assert torch.equal(got["full"], ranks[0]["full"])
        assert torch.equal(got["cached"], ranks[0]["cached"])
    rep = setup["replicated"]
    gap = float((ranks[0]["full"] - rep).abs().max())
    assert gap < 0.05 * float(rep.abs().max())


@pytest.mark.parametrize("option", ["default_deadline_s", "chaos_stall",
                                    "request_deadline_s"])
def test_clock_driven_options_refused_under_tp(setup, option):
    """A deadline or a chaos stall is a host decision read off the clock;
    under tp > 1 ranks could decide differently and hang each other in a
    collective. The engine no longer refuses them: rank 0 decides and
    broadcasts its verdicts (``tests/test_torch_tp_deadlines.py`` serves
    them), so each option is accepted on every rank."""
    for got in setup["ranks"]:
        assert got["refused"][option] is None


def test_engine_over_a_model_built_sharded(setup):
    """A model built with ``int8_mesh`` and holding its shard serves, its
    strategy taken from the config, the tokens of an engine that cut the
    whole weights itself."""
    for got in setup["ranks"]:
        built, from_whole = got["prebuilt"]
        assert built == from_whole and got["prebuilt_tp"] == 2


def test_clock_driven_options_allowed_at_tp1():
    """The same options on a strategy of one rank: the replicated engine."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import init_quantized_lm
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    cfg = TransformerConfig(**SPEC, quantized=True)
    eng = ServeEngine(TransformerLM(cfg), init_quantized_lm(cfg, device="cpu"), device="cpu",
                      strategy=TensorParallel(), default_deadline_s=30.0)
    eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=2, deadline_s=30.0))
    assert len(eng.run_until_idle()) == 1


def test_int8_rules_place_a_rank_shard():
    """``place_int8_lm_params`` / ``int8_param_sharding`` (the JAX names):
    column layers' q rows and scales split, row layers' q columns split
    with scales whole, float leaves whole — exactly the shapes a model
    built for that rank holds. (A strategy of width 2 set by hand: shapes
    only, no collective.)"""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        init_quantized_lm,
        int8_param_sharding,
        place_int8_lm_params,
    )

    strat = TensorParallel()
    strat.tp_size, strat.rank = 2, 1
    whole_cfg = TransformerConfig(**SPEC, quantized=True)
    cfg = dataclasses.replace(whole_cfg, int8_mesh=strat)
    whole = init_quantized_lm(whole_cfg, seed=0, device="cpu")
    placed = place_int8_lm_params(whole, cfg)
    want = TransformerLM(cfg).state_dict()
    assert {n: tuple(t.shape) for n, t in placed.items()} == {
        n: tuple(t.shape) for n, t in want.items()}
    q = whole["blocks.0.attn.q_proj.qt"]
    assert torch.equal(placed["blocks.0.attn.q_proj.qt"], q[q.shape[0] // 2:])
    assert int8_param_sharding("blocks.0.attn.o_proj.qt", (64, 64), cfg) == 1
    assert int8_param_sharding("blocks.0.attn.o_proj.scale", (1, 64), cfg) is None
    assert int8_param_sharding("lm_head.scale", (1, 128), cfg) == 1
    assert int8_param_sharding("tok_emb.weight", (128, 64), cfg) is None
