"""Tensor-parallel serving in the port (``ServeEngine(strategy=)``) against
the port's replicated engine and the JAX package's TP engine, mirroring
the JAX ``tests/test_tp_serve.py``.

Toy float models (vocab 64, d_model 32, 2 layers, 4 heads, window 64;
the JAX test's ``CFG``, its GQA and ``scan_layers`` variants) initialized
by the JAX package and converted through
``models/convert.py:from_jax_params``. One gloo world of 2 and one of 4
spawned ranks (``tests/torch_tp_worker.py``, no JAX) run every case of
their width; the replicated port engine runs the same case here, and the
JAX ``ServeEngine(strategy=TensorParallel(create_mesh({"model": 2}),
TP_RULES))`` on the forced 8-device CPU mesh.

Tolerances: greedy tokens are equal — the row-parallel sums reorder
float32 additions by an ulp, far inside these models' top-2 logit gaps —
and every rank's tokens and teacher-forced logits are bitwise equal
(each rank receives the same bytes from the collectives); the TP
teacher-forced logits are within ``atol 1e-5`` of the replicated
engine's (logits of order 0.1–1: the row-parallel partials' float32 sum
in another order, a few ulps through two layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.parallel import TensorParallel as JaxTP
from pytorch_distributed_training_tutorials_tpu.parallel.mesh import create_mesh as jax_mesh
from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    spawn_tp,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)
REQS = [(3, 9), (7, 12), (5, 5), (12, 6), (2, 17)]


def _prompts(seed, lens):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [(rng.integers(0, CFG["vocab_size"], p).tolist(), m) for p, m in lens]


def _shared_prefix_reqs():
    """The JAX composed pin's stream: 8 requests, most of each prompt from
    one shared family, so splices fire."""
    rng = np.random.Generator(np.random.PCG64(42))
    shared = rng.integers(0, CFG["vocab_size"], (14,)).tolist()
    reqs = []
    for i in range(8):
        p_len = (6, 10, 14)[i % 3]
        k = int(round(0.7 * p_len))
        tail = rng.integers(0, CFG["vocab_size"], (p_len - k,)).tolist()
        reqs.append((shared[:k] + tail, 5 + (i % 3)))
    return reqs


def _jax_params(**cfg_kwargs):
    jcfg = jt.TransformerConfig(**CFG, **cfg_kwargs)
    params = jt.TransformerLM(jcfg).init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 4), jnp.int32))["params"]
    return jcfg, params


def _port_params(params, **cfg_kwargs):
    cfg = TransformerConfig(**CFG, **cfg_kwargs)
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


def _cases():
    stream = _prompts(8100, REQS)
    layouts = _prompts(8400, REQS[:4])
    paged = _prompts(870, [(3, 9), (17, 12), (2, 17)])
    composed = _shared_prefix_reqs()
    two = {
        "stream": dict(cfg=CFG, params="float.pt", reqs=stream),
        "paged_kernel": dict(cfg=CFG, params="float.pt", reqs=paged,
                             engine=dict(paged=True, page_size=8, pool_pages=6,
                                         paged_kernel=True)),
        "paged_gather": dict(cfg=CFG, params="float.pt", reqs=paged,
                             engine=dict(paged=True, page_size=8, pool_pages=6)),
        "composed": dict(
            cfg=CFG, params="float.pt", reqs=composed, bank=(4, 4, 1000, 0.3),
            adapters=[(i % 3) % 2 + 1 if i % 3 else 0 for i in range(len(composed))],
            engine=dict(prefix_cache_bytes=16 * 1024 * 1024, speculative_k=2,
                        pipeline_depth=2, prefill_chunk=8, paged=True, page_size=8,
                        pool_pages=16)),
    }
    four = {
        "scan": dict(cfg=CFG, params="scan.pt", reqs=layouts),
        "gqa": dict(cfg={**CFG, "n_kv_heads": 2}, params="gqa.pt", reqs=layouts),
        "int8kv": dict(cfg=CFG, params="float.pt", reqs=layouts, engine=dict(kv_bits=8)),
    }
    return two, four


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_serve")
    _, params = _jax_params()
    torch.save(_port_params(params), workdir / "float.pt")
    _, scan_params = _jax_params(scan_layers=True)
    torch.save(_port_params(scan_params), workdir / "scan.pt")
    _, gqa_params = _jax_params(n_kv_heads=2)
    torch.save(_port_params(gqa_params, n_kv_heads=2), workdir / "gqa.pt")
    two, four = _cases()
    worlds = {2: spawn_tp(torch_tp_worker.serve_cases, 2, (str(workdir), two),
                          backend="gloo", device="cpu"),
              4: spawn_tp(torch_tp_worker.serve_cases, 4, (str(workdir), four),
                          backend="gloo", device="cpu")}
    replicated = {name: torch_tp_worker.serve_case(TensorParallel(), str(workdir), case)
                  for name, case in {**two, **four}.items()}
    return {"workdir": str(workdir), "params": params, "cases": {**two, **four},
            "worlds": worlds, "replicated": replicated}


def _ranks(setup, name):
    tp = 2 if name in _cases()[0] else 4
    return [rank[name] for rank in setup["worlds"][tp]]


def test_tp1_identical_to_bare_engine(setup):
    """A strategy of one rank gates the sharded path off: the same state
    tensors, syncs, launches and tokens as ``strategy=None``."""
    params = torch.load(f"{setup['workdir']}/float.pt")
    reqs = setup["cases"]["stream"]["reqs"][:3]
    engines = [ServeEngine(TransformerLM(TransformerConfig(**CFG)), params, n_slots=2,
                           tokens_per_launch=8, device="cpu", strategy=s)
               for s in (None, TensorParallel())]
    toks = [torch_tp_worker.run_stream(e, reqs) for e in engines]
    assert toks[0] == toks[1]
    bare, one = engines
    assert one._tp is None and one.tp_stats() == {"tp": 1} == bare.tp_stats()
    assert one.model.cfg.int8_mesh is None
    for name in ("k", "v", "index"):
        assert torch.equal(getattr(one._state.cache, name), getattr(bare._state.cache, name))
    assert torch.equal(one._state.last_tok, bare._state.last_tok)
    assert (one.n_host_syncs, one.n_chains, one.n_prefills) == (
        bare.n_host_syncs, bare.n_chains, bare.n_prefills)
    assert one.stats() == bare.stats()


def test_tp2_token_exact_and_kv_sharded(setup):
    """tp=2 over the staggered stream: every rank's completions equal the
    replicated port engine's and the JAX TP engine's, while the cache
    holds each rank's 2 of the 4 KV heads and prices them per chip."""
    jcfg = jt.TransformerConfig(**CFG)
    jeng = JaxServeEngine(jt.TransformerLM(jcfg), setup["params"], n_slots=2,
                          tokens_per_launch=8,
                          strategy=JaxTP(jax_mesh({"model": 2}), jt.TP_RULES))
    reqs = setup["cases"]["stream"]["reqs"]
    ids = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=m, seed=i))
           for i, (p, m) in enumerate(reqs[:2])]
    pending = list(range(2, len(reqs)))
    done = {}
    while not jeng.idle or pending:
        if pending:
            i = pending.pop(0)
            p, m = reqs[i]
            ids.append(jeng.submit(JaxRequest(prompt=p, max_new_tokens=m, seed=i)))
        for c in jeng.step():
            done[c.request_id] = c.tokens
    jax_tokens = [done[r] for r in ids]
    rep = setup["replicated"]["stream"]
    assert rep["tokens"] == jax_tokens
    for got in _ranks(setup, "stream"):
        assert got["tokens"] == jax_tokens
        assert got["kv_shape"] == (2, 2, 65, 2, 8) and rep["kv_shape"] == (2, 2, 65, 4, 8)
        st = got["tp_stats"]
        assert st["tp"] == 2 and st["mesh_shape"] == "model:2" and st["tp_backend"] == "gloo"
        # K/V halve; the slots' positions (2 x int64) stay whole
        idx = 2 * 8
        assert st["tp_kv_bytes_global"] - idx == 2 * (st["tp_kv_bytes_per_chip"] - idx)


@pytest.mark.parametrize("name", ["stream", "gqa"])
def test_generate_on_a_tp_model(setup, name):
    """``generate()`` on the engine's sharded model (every rank alike)
    gives the engine's tokens for the stream's first request."""
    for got in _ranks(setup, name):
        assert got["generate"] == got["tokens"][0]


def test_tp2_host_sync_budget_unchanged(setup):
    """Sharding adds no host sync of the engine's own: each rank's count
    is its budget and the replicated engine's."""
    rep = setup["replicated"]["stream"]
    assert rep["host_syncs"] == rep["budget"]
    for got in _ranks(setup, "stream"):
        assert got["host_syncs"] == got["budget"] == rep["host_syncs"]


def test_tp2_audit_decode_counts(setup):
    """The decode chain's collectives: 2 all_reduce a layer and one
    all_gather a forward, exactly — and the whole stream's the same per
    forward (prefills and decode steps alike)."""
    for got in _ranks(setup, "stream"):
        audit = got["audit"]
        assert audit["ok"], audit["problems"]
        assert audit["collectives"] == {"all_reduce": 2 * 2 * 8, "all_gather": 8}
        st = got["tp_stats_after_audit"]
        assert st["tp_hlo_ok"] is True and st["tp_collectives"] == 40
        forwards = got["n_prefills"] + 8 * got["n_chains"]
        assert got["stream_collectives"] == {"all_reduce": 4 * forwards,
                                             "all_gather": forwards}


@pytest.mark.parametrize("name", ["scan", "gqa", "int8kv"])
def test_tp4_token_exact_layouts(setup, name):
    """tp=4 on the stacked-layout weights, GQA (2 KV heads do not divide 4:
    every rank stores both and reads its query head's) and int8 KV (the
    scales shard with their K/V): token-exact to the replicated engine."""
    rep = setup["replicated"][name]
    for got in _ranks(setup, name):
        assert got["tokens"] == rep["tokens"]
        assert got["audit"]["ok"], got["audit"]["problems"]
    heads = {"scan": 1, "gqa": 2, "int8kv": 1}[name]
    assert _ranks(setup, name)[0]["kv_shape"][3] == heads


def test_tp2_paged_kernel_plain(setup):
    """The paged-attention read path (its plain version on the CPU) at
    tp=2, each rank over its KV heads' pools: token-exact to the
    replicated kernel engine and to the replicated gather engine."""
    for got in _ranks(setup, "paged_kernel"):
        assert got["tokens"] == setup["replicated"]["paged_kernel"]["tokens"]
        assert got["tokens"] == setup["replicated"]["paged_gather"]["tokens"]
        assert got["kv_shape"][3] == 2


def test_tp2_composed_full_stack(setup):
    """tp=2 under the prefix cache, speculation, adapters, paged KV, depth-2
    pipelining and chunked prefill: token-exact to the same composition
    replicated, host syncs at the summed budget (chains + prefills +
    splices), and the bank's factors bound as views (a register reaches
    every rank's shards)."""
    rep = setup["replicated"]["composed"]
    for got in _ranks(setup, "composed"):
        assert got["tokens"] == rep["tokens"]
        assert got["host_syncs"] == got["budget"] == rep["host_syncs"]
        assert got["audit"]["ok"], got["audit"]["problems"]


@pytest.mark.parametrize("name", ["stream", "paged_kernel", "paged_gather", "composed",
                                  "scan", "gqa", "int8kv"])
def test_every_rank_same_completions_and_logits(setup, name):
    """SPMD agreement: every rank's tokens and teacher-forced logits are
    the same bytes (rank 0's are the engine's output)."""
    ranks = _ranks(setup, name)
    for got in ranks[1:]:
        assert got["tokens"] == ranks[0]["tokens"]
        assert torch.equal(got["tf_logits"], ranks[0]["tf_logits"])
    assert ranks[0]["tf_logits"].shape[-1] == CFG["vocab_size"]  # gathered
    np.testing.assert_allclose(ranks[0]["tf_logits"].numpy(),
                               setup["replicated"][name]["tf_logits"].numpy(),
                               rtol=0, atol=1e-5)


def test_dataclass_replace_keeps_the_strategy():
    """A config with a strategy of one rank is the whole model's."""
    cfg = TransformerConfig(**CFG, int8_mesh=TensorParallel())
    assert dataclasses.replace(cfg, max_seq_len=32).int8_mesh is cfg.int8_mesh
    assert tuple(TransformerLM(cfg).blocks[0].attn.q_proj.weight.shape) == (32, 32)
