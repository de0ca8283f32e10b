"""The port's streaming int8 loader under tensor parallelism:
``load_quantized_lm(path, mesh)`` in a gloo world of 2 spawned ranks
(``tests/torch_auto_worker.py``, no JAX), against the whole-tree bridge.

A toy LM (vocab 128, d_model 64, 2 layers, 4 heads, 2 KV heads, d_ff 256,
window 64) initialized by the JAX package and saved, unrolled and
stacked, with the port's ``save_checkpoint``. Each rank's load is
bitwise ``place_int8_lm_params(from_jax_params(tree))`` (the whole leaf
quantized, then cut), and the TP engine over the loaded shards gives the
replicated engine's greedy tokens on a staggered stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_auto_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu_torch.parallel.auto import save_checkpoint
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import spawn_tp

SPEC = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256,
            max_seq_len=64)
REQS = [(5, 9), (9, 12), (3, 6), (12, 8)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("auto_tp")
    jcfg = jt.TransformerConfig(**SPEC)
    params = jt.TransformerLM(jcfg).init(jax.random.PRNGKey(7),
                                         jnp.zeros((1, 4), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    save_checkpoint(workdir / "unrolled", tree)
    save_checkpoint(workdir / "stacked", jax.tree_util.tree_map(
        np.asarray, jt.stack_quantized_lm_params(tree)))
    rng = np.random.Generator(np.random.PCG64(3))
    reqs = [(rng.integers(0, SPEC["vocab_size"], p).tolist(), m) for p, m in REQS]
    torch.save(SPEC, workdir / "spec.pt")
    torch.save(reqs, workdir / "reqs.pt")
    return spawn_tp(torch_auto_worker.load_cases, 2, (str(workdir),), backend="gloo",
                    device="cpu")


@pytest.mark.parametrize("layout", ["unrolled", "stacked"])
def test_rank_load_bitwise_the_bridge_shard(ranks, layout):
    for rank, out in enumerate(ranks):
        got = out[layout]
        assert got["keys_equal"], rank
        assert len(got["bitwise"]) == got["n_keys"], rank
        shapes = got["shapes"]
        assert shapes["blocks.0.attn.q_proj.qt"] == (32, 64)  # 2 of 4 heads (N, K)
        assert shapes["blocks.0.attn.k_proj.qt"] == (16, 64)  # 1 of 2 KV heads
        assert shapes["blocks.0.attn.o_proj.qt"] == (64, 32)  # row: half of K
        assert shapes["blocks.0.attn.o_proj.scale"] == (1, 64)  # row scales whole
        assert shapes["blocks.0.mlp.down_proj.qt"] == (64, 128)
        assert shapes["lm_head.qt"] == (64, 64)  # vocab split
        assert shapes["tok_emb.weight"] == (128, 64)


@pytest.mark.parametrize("layout", ["unrolled", "stacked"])
def test_tp_engine_tokens_equal_replicated(ranks, layout):
    for out in ranks:
        assert out[layout]["tp_tokens"] == out[layout]["replicated_tokens"]
        assert [len(t) for t in out[layout]["tp_tokens"]] == [m for _, m in REQS]
    assert ranks[0][layout]["tp_tokens"] == ranks[1][layout]["tp_tokens"]
