"""Multi-tenant serving in the PyTorch port (``ServeEngine(adapter_bank=)``)
against the JAX package's ``ServeEngine`` with the same bank.

A toy int8 LM (vocab 64, d_model 32, 2 layers, 4 heads, window 64) and a
bank of 3 rows of rank 4; weights and tenant factors are drawn with numpy
from a seed and reach both packages through ``models/convert.py``. The
tenants' factors are N(0, 0.5^2): large enough that every tenant's greedy
tokens differ from the base model's (asserted), so a fault that ignores
the ids, or serves one tenant's factors to another, changes tokens. (The
JAX package's own tests draw factors at 0.05, where a tenant's tokens on
its toy model equal the base model's; two of its pins are red for that
reason, so this file compares against the JAX engine's actual outputs.)

Checks, each exact: greedy tokens per request, ``n_splices``,
``adapter_stats()`` and finish reasons equal the JAX engine's on whole,
prefix-cache (splice), chunked, paged-gather and speculative engines;
host syncs are chains + refills; id 0 equals the bank-less engine; a
request queued behind an ``evict`` completes as ``"adapter_evicted"`` with
no device work; a ``register`` into a live engine is served at the next
step; prefix splices stay inside a tenant's (adapter, generation)
namespace.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.adapters import bank as jbank
from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.adapters import AdapterBank
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.convert import adapter_from_jax
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
from helpers import requires_pallas_interpret

pytestmark = requires_pallas_interpret

TOY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)
N, R = 3, 4
PREFIX_BYTES = 1 << 22
# (shared head tokens, tail tokens, new tokens); request i serves id i % N
STREAM = [(16, 3, 8), (16, 5, 6), (16, 2, 7), (16, 4, 7), (16, 9, 5), (16, 6, 9),
          (12, 11, 4), (20, 2, 6)]
ARMS = {
    "whole": {},
    "prefix": dict(prefix_cache_bytes=PREFIX_BYTES),
    "chunk": dict(prefill_chunk=8),
    "paged-prefix": dict(prefix_cache_bytes=PREFIX_BYTES, paged=True, page_size=8,
                         pool_pages=32),
    "spec": dict(speculative_k=2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Toy:
    """The toy int8 LM and its tenants in both packages."""

    def __init__(self):
        jcfg = jt.TransformerConfig(**TOY)
        shapes = jax.eval_shape(jt.TransformerLM(jcfg).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 4), jnp.int32))["params"]
        rng = np.random.Generator(np.random.PCG64(0))

        def draw(path, leaf):
            x = rng.standard_normal(leaf.shape).astype(np.float32)
            if str(path[-1].key) == "scale":
                return (1.0 + 0.1 * x).astype(np.float32)
            return (0.2 * x).astype(np.float32)

        self.qtree = jt.quantize_lm_params(jax.tree_util.tree_map_with_path(draw, shapes))
        self.jcfg = dataclasses.replace(jcfg, quantized=True)
        self.cfg = TransformerConfig(**TOY, quantized=True)
        self.params = from_jax_params(_np(self.qtree), self.cfg, device="cpu")
        zeros = _np(jbank.AdapterBank(jt.TransformerLM(self.jcfg), N, R).row_zeros())
        self.rows = []
        for seed in (1, 2, 3):
            trng = np.random.Generator(np.random.PCG64(100 + seed))
            self.rows.append(jax.tree_util.tree_map(
                lambda z: (0.5 * trng.standard_normal(z.shape)).astype(np.float32), zeros))
        prng = np.random.Generator(np.random.PCG64(7))
        shared = prng.integers(0, 64, 20).tolist()
        self.prompts = [shared[:k] + prng.integers(0, 64, t).tolist() for k, t, _ in STREAM]
        self.budgets = [m for _, _, m in STREAM]
        self.ids = [i % N for i in range(len(STREAM))]

    def banks(self, tenants=(1, 2)):
        """(JAX bank, port bank), each with ``tenants`` registered: tenant
        t's factors are ``rows[t - 1]``, named ``t{t}``."""
        jb = jbank.AdapterBank(jt.TransformerLM(self.jcfg), N, R)
        tb = AdapterBank(TransformerLM(self.cfg), N, R, device="cpu")
        for t in tenants:
            self.register(jb, tb, f"t{t}", self.rows[t - 1])
        return jb, tb

    def register(self, jb, tb, name, row):
        aid = jb.register(name, row)
        assert tb.register(name, adapter_from_jax(row, self.cfg, device="cpu")) == aid
        return aid

    def engines(self, jb, tb, **kw):
        je = JaxServeEngine(jt.TransformerLM(self.jcfg), self.qtree, n_slots=2,
                            tokens_per_launch=8, adapter_bank=jb, **kw)
        te = ServeEngine(TransformerLM(self.cfg), self.params, n_slots=2, tokens_per_launch=8,
                         device="cpu", adapter_bank=tb, **kw)
        return je, te


def _drain(engine, submitted):
    done = {}
    while not engine.idle:
        for c in engine.step():
            done[c.request_id] = c
    return [done[i] for i in submitted]


def _submit_all(engine, toy, make, ids):
    return [engine.submit(make(prompt=p, max_new_tokens=m, adapter=a))
            for p, m, a in zip(toy.prompts, toy.budgets, ids)]


@pytest.fixture(scope="module")
def toy():
    return Toy()


@pytest.fixture(scope="module")
def base_tokens(toy):
    """The bank-less engine's tokens: what id 0 must reproduce."""
    eng = ServeEngine(TransformerLM(toy.cfg), toy.params, n_slots=2, tokens_per_launch=8,
                      device="cpu")
    return [c.tokens for c in _drain(eng, _submit_all(eng, toy, Request, [0] * len(STREAM)))]


@pytest.mark.parametrize("arm", list(ARMS))
def test_mixed_tenant_stream_matches_jax(toy, base_tokens, arm):
    """Ids ``i % 3`` co-batched through one engine: per-request tokens,
    splices and ``adapter_stats()`` equal the JAX engine's; id 0's tokens
    equal the bank-less engine's and every tenant request's differ from
    them; host syncs are chains + refills."""
    jb, tb = toy.banks()
    je, te = toy.engines(jb, tb, **ARMS[arm])
    want = _drain(je, _submit_all(je, toy, JaxRequest, toy.ids))
    got = _drain(te, _submit_all(te, toy, Request, toy.ids))
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want]
    assert te.n_splices == je.n_splices
    assert te.adapter_stats() == je.adapter_stats()
    for i, aid in enumerate(toy.ids):
        assert (got[i].tokens == base_tokens[i]) == (aid == 0), i
    assert te.n_host_syncs == te.n_chains + sum(te.refills.values())
    if arm in ("prefix", "paged-prefix"):
        assert te.n_splices > 0


class Side:
    """One package's engine over its own bank (``tenants`` registered),
    and how to register a tenant row into that bank."""

    def __init__(self, toy, pkg, tenants=(1, 2), **kw):
        jb, tb = toy.banks(tenants)
        je, te = toy.engines(jb, tb, **kw)
        self.toy, self.pkg = toy, pkg
        self.engine, self.make, self.bank = (
            (je, JaxRequest, jb) if pkg == "jax" else (te, Request, tb))

    def register(self, name, row):
        if self.pkg == "port":
            row = adapter_from_jax(row, self.toy.cfg, device="cpu")
        return self.bank.register(name, row)

    def submit(self, i, aid, new=6):
        return self.engine.submit(self.make(prompt=self.toy.prompts[i], max_new_tokens=new,
                                            adapter=aid))

    def drain(self) -> dict:
        done = {}
        while not self.engine.idle:
            for c in self.engine.step():
                done[c.request_id] = c
        return done


def _evicted_while_queued(toy, pkg):
    side = Side(toy, pkg)
    first = [side.submit(i, 2, new=20) for i in range(2)]
    assert not side.engine.step()  # both slots busy
    queued = [side.submit(i, 1) for i in (2, 3)]
    side.bank.evict("t1")
    assert side.register("t3", toy.rows[2]) == 1  # row 1 recycled
    done = side.drain()
    e = side.engine
    return ([(done[r].finish_reason, done[r].tokens) for r in queued],
            [done[r].tokens for r in first], e.adapter_stats(), e.n_prefills + e.n_splices)


def test_adapter_evicted_while_queued_matches_jax(toy):
    """Two slots busy, two requests of tenant 1 queued; tenant 1 is
    evicted and another tenant lands on the recycled row 1: both queued
    requests complete as ``"adapter_evicted"`` with zero tokens and no
    refill (the generation moved), as in the JAX engine; the counters
    agree."""
    jq, jf, js, jr = _evicted_while_queued(toy, "jax")
    tq, tf, ts, tr = _evicted_while_queued(toy, "port")
    assert tq == jq == [("adapter_evicted", [])] * 2
    assert tf == jf and ts == js and ts["adapter_rejected"] == 2
    assert tr == jr == 2


def _late_register(toy, pkg, late):
    side = Side(toy, pkg, tenants=(1,) if late else (1, 2))
    warm = side.submit(0, 1, new=20)
    assert not side.engine.step()  # tenant 1 decoding
    if late:
        version = side.bank.version
        assert side.register("t2", toy.rows[1]) == 2
        assert side.bank.version == version + 1
    rid = side.submit(1, 2)
    done = side.drain()
    return done[warm].tokens, done[rid].tokens


def test_register_into_live_engine_is_served_next_step(toy):
    """A tenant registered while the engine serves is picked up at the
    next ``step()`` (the bank's version moved): its request's tokens equal
    those of an engine whose bank held the tenant from the start, and the
    JAX engine's."""
    late = _late_register(toy, "port", True)
    assert late == _late_register(toy, "jax", True)
    assert late == _late_register(toy, "port", False)


def _scoped(toy, pkg):
    side = Side(toy, pkg, prefix_cache_bytes=PREFIX_BYTES)
    trace = []

    def serve(aid):
        rid = side.submit(5, aid, new=5)
        tokens = side.drain()[rid].tokens
        trace.append((aid, side.engine.n_splices, tokens))

    for aid in (1, 2, 0, 1):
        serve(aid)
    side.bank.evict("t1")
    side.register("t3", toy.rows[2])
    serve(1)
    serve(1)
    return trace


def test_prefix_keys_are_tenant_scoped(toy):
    """One prompt under tenants 1 and 2 and the base model: no splice
    crosses tenants; after evicting tenant 1 and registering tenant 3 on
    its row, the prompt under row 1 does not splice the old tenant's
    segment (the generation is in the key), while a repeat within a
    tenant does — splice counts and tokens equal the JAX engine's."""
    got = _scoped(toy, "port")
    assert got == _scoped(toy, "jax")
    assert [n for _, n, _ in got] == [0, 0, 0, 1, 1, 2]
    assert got[4][2] != got[3][2]  # row 1's new tenant decodes its own factors
