"""The PyTorch port's paged KV serving against its unpaged engine and the
JAX package's paged ``ServeEngine``.

A toy int8 GQA LM (vocab 64, d_model 32, 2 layers, 4 query and 2 KV heads,
window 64) whose float weights are drawn with numpy from a seed and
quantized by the JAX package, so both packages serve the same weights. The
stream is OVERSUBSCRIBED: 3 slots of 64-token windows over a pool of 6
pages of 8 tokens, so requests wait queued for pages.

- The gather read path is bitwise the unpaged decode (logits equal, not
  close) at f32, int8 and int4 storage, and the paged engine's tokens are
  the unpaged engine's.
- The kernel read path (here its plain version, the wrapper's CPU route)
  is token-exact to the gather path.
- Both equal the JAX paged engine's tokens, per request, at f32, int8
  and int4 KV, and the page counters equal JAX's ``page_stats()``. The
  seeded inputs are ones on which no int8 activation code moves a step
  between float32 and float64 attention (ROADMAP.md, section C).
- Admission: ``PoolExhausted`` at submit for a request that can never fit
  the pool; no page leaks; host syncs are chains + prefills, counted by a
  spy on ``Tensor.cpu`` too; int4 ``page_bytes`` is half of int8's.
- ``ServeEngine.teacher_forced_logits`` follows the served tokens (the
  gather's rows equal the unpaged engine's), and ``chip_smoke.py``'s
  teacher-forced gate passes the kernel path and trips on a planted page
  fault; its paged-attention bound counts only the positions a call needs.
- ``python -m pytorch_distributed_training_tutorials_tpu_torch.serve
  --selftest --paged ... --device cpu`` exits 0.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.models import transformer as jt
from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    KVCache,
    PagedKVCache,
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as tpa
from pytorch_distributed_training_tutorials_tpu_torch.serve import (
    PoolExhausted,
    Request,
    ServeEngine,
)
from helpers import requires_pallas_interpret

REPO = Path(__file__).resolve().parents[1]
TOY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)
GEOM = dict(paged=True, page_size=8, pool_pages=6)
# (prompt length, max_new_tokens): prompt buckets 8 and 16 only, and 2-3
# pages each against a 6-page pool
STREAM = [(3, 9), (12, 12), (5, 5), (9, 6), (2, 17), (7, 14)]
KV_BITS = [None, 8, 4]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Served:
    """The toy int8 LM in both packages, over the same weights."""

    def __init__(self):
        jcfg = jt.TransformerConfig(**TOY)
        shapes = jax.eval_shape(
            jt.TransformerLM(jcfg).init, jax.random.PRNGKey(0),
            jnp.zeros((1, 4), jnp.int32),
        )["params"]
        rng = np.random.Generator(np.random.PCG64(0))

        def draw(path, leaf):
            x = rng.standard_normal(leaf.shape).astype(np.float32)
            if str(path[-1].key) == "scale":
                return (1.0 + 0.1 * x).astype(np.float32)
            return (0.2 * x).astype(np.float32)

        self.qtree = jt.quantize_lm_params(jax.tree_util.tree_map_with_path(draw, shapes))
        self.jmodel = jt.TransformerLM(dataclasses.replace(jcfg, quantized=True))
        self.cfg = TransformerConfig(**TOY, quantized=True)
        self.params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, self.qtree), self.cfg, device="cpu")
        prng = np.random.Generator(np.random.PCG64(7))
        self.prompts = [prng.integers(0, TOY["vocab_size"], p).tolist() for p, _ in STREAM]
        self.budgets = [m for _, m in STREAM]

    def engine(self, **kw):
        return ServeEngine(TransformerLM(self.cfg), self.params, n_slots=3,
                           tokens_per_launch=8, device="cpu", **kw)

    def run(self, engine, make=Request):
        """Submit the whole stream, drain; tokens in submit order. Also
        records whether a request ever waited for pages with a slot free."""
        ids = [engine.submit(make(prompt=p, max_new_tokens=m))
               for p, m in zip(self.prompts, self.budgets)]
        done, waited = {}, False
        while not engine.idle:
            for c in engine.step():
                done[c.request_id] = c
            waited |= len(engine.scheduler) > 0 and engine.active_slots < engine.n_slots
        engine.waited_for_pages = waited
        return [done[i].tokens for i in ids]


@pytest.fixture(scope="module")
def served():
    return Served()


@pytest.fixture(scope="module")
def runs(served):
    """Port engine runs by (kv_bits, mode), mode "flat", "gather" or
    "kernel"; each computed once."""
    cache = {}

    def get(kv, mode):
        if (kv, mode) not in cache:
            kw = {} if mode == "flat" else dict(GEOM, paged_kernel=mode == "kernel")
            eng = served.engine(kv_bits=kv, **kw)
            cache[(kv, mode)] = (eng, served.run(eng))
        return cache[(kv, mode)]

    return get


@pytest.mark.parametrize("kv", KV_BITS)
def test_paged_engines_token_exact_to_unpaged(runs, kv):
    """Gather and kernel read paths over an oversubscribed pool: the
    tokens of the whole-slot engine at the same storage."""
    _, flat = runs(kv, "flat")
    gather_eng, gather = runs(kv, "gather")
    kernel_eng, kernel = runs(kv, "kernel")
    assert gather == flat
    assert kernel == gather
    for eng in (gather_eng, kernel_eng):
        assert eng.waited_for_pages  # the pool, not the slots, held requests back
        stats = eng.page_stats()
        assert stats["pages_in_use"] == 0 and stats["pages_high_water"] <= 6
        assert eng.n_host_syncs == eng.n_chains + eng.n_prefills
        assert (eng._state.cache.table == GEOM["pool_pages"]).all()  # all parked
    assert tpa.paged_attention.launches == 0  # CPU tensors: the plain version


@requires_pallas_interpret
@pytest.mark.parametrize("kv,kernel", [(None, False), (8, True), (4, True)],
                         ids=["f32-gather", "int8-kernel", "int4-kernel"])
def test_tokens_and_page_stats_equal_jax_paged_engine(served, runs, kv, kernel):
    """The JAX paged engine (its Pallas kernel in interpret mode where
    ``paged_kernel``) on the same stream: the same tokens per request from
    the port's gather AND kernel paths, and the same page counters."""
    jeng = JaxServeEngine(served.jmodel, served.qtree, n_slots=3, tokens_per_launch=8,
                          kv_bits=kv, paged_kernel=kernel, **GEOM)
    want = served.run(jeng, make=JaxRequest)
    gather_eng, gather = runs(kv, "gather")
    kernel_eng, kernel_toks = runs(kv, "kernel")
    assert gather == want
    assert kernel_toks == want
    jstats = jeng.page_stats()
    assert kernel_eng.page_stats() == jstats | {"paged_kernel": 1}
    assert gather_eng.page_stats() == jstats | {"paged_kernel": 0}


def _flat_then_paged(served, kv):
    """A prompt prefilled into a flat batch-1 cache, its pages copied into
    a 2-row paged state (row 1 parked); then the unpaged model and the two
    paged read paths decode the same 6 tokens. Returns the logits."""
    cfg = dataclasses.replace(served.cfg, kv_cache_dtype={None: None, 8: torch.int8,
                                                           4: "int4"}[kv])
    flat_model = TransformerLM(cfg)
    bind_params(flat_model, served.params)
    prompt = torch.tensor([served.prompts[1] + [0] * 4])  # 12 tokens, bucket 16
    flat = KVCache.zeros(cfg, 1)
    flat_model(prompt, flat, prefill=True, last_pos=11)
    flat.index[:] = 12
    outs = {"flat": []}
    paged = {}
    for mode in ("gather", "kernel"):
        pcfg = dataclasses.replace(cfg, kv_pages=5, kv_page_size=8,
                                   paged_kernel=mode == "kernel")
        model = TransformerLM(pcfg)
        bind_params(model, served.params)
        cache = PagedKVCache.zeros(pcfg, 2)
        pages = [3, 0, 4]  # scattered, 24 tokens' worth
        for pool, src in ((cache.k, flat.k), (cache.v, flat.v),
                          (cache.k_scale, flat.k_scale), (cache.v_scale, flat.v_scale)):
            if pool is not None:
                pool[:, pages] = src[:, 0, :24].reshape(pool.shape[0], 3, 8, *pool.shape[3:])
        cache.table[0, :3] = torch.tensor(pages, dtype=torch.int32)
        cache.index[:] = 12
        paged[mode] = (model, cache)
        outs[mode] = []
    toks = torch.tensor(served.prompts[3][:6])
    for t in toks:
        outs["flat"].append(flat_model(t.view(1, 1), flat, decode=True))
        for mode, (model, cache) in paged.items():
            outs[mode].append(model(t.view(1, 1).expand(2, 1), cache, decode=True)[:1])
    return {k: torch.cat(v) for k, v in outs.items()}, paged


@pytest.mark.parametrize("kv", KV_BITS)
def test_gather_decode_bitwise_unpaged_and_kernel_close(served, kv):
    """Model level: the gather path's logits EQUAL the unpaged decode's;
    the kernel path's agree to float32 summation order (1e-4 of the
    logits' scale); the parked row's writes land in the sink page only."""
    logits, paged = _flat_then_paged(served, kv)
    assert torch.equal(logits["gather"], logits["flat"])
    scale = float(logits["flat"].abs().max())
    assert float((logits["kernel"] - logits["gather"]).abs().max()) <= 1e-4 * scale
    for _, cache in paged.values():
        untouched = [1, 2]  # never allocated: neither row wrote there
        assert not cache.k[:, untouched].any() and not cache.v[:, untouched].any()


def test_admission_shed_and_page_bytes(served, runs):
    """A request that fits the window but never the pool sheds at submit
    (counted); int4 pages cost exactly half of int8's; f32 pages cost
    2 layers x (K + V) x 8 tokens x 2 heads x 8 dims x 4 bytes."""
    eng, _ = runs(None, "gather")
    with pytest.raises(PoolExhausted):
        eng.submit(Request(prompt=served.prompts[1] * 2, max_new_tokens=30))
    assert eng.page_stats()["pages_sheds"] == 1 and eng.idle
    pb = {kv: runs(kv, "gather")[0].page_stats()["page_bytes"] for kv in KV_BITS}
    assert pb[None] == 2 * 2 * 8 * 2 * 8 * 4
    assert pb[8] == 2 * 2 * 8 * 2 * (8 + 4)
    assert 2 * pb[4] == pb[8]
    assert served.engine().page_stats() == {"paged": 0}


def test_host_syncs_one_per_chain_plus_prefill(served, monkeypatch):
    """A paged kernel-path engine syncs exactly once per chain and once per
    prefill, counted by the engine and by a spy on Tensor.cpu; nothing
    calls .item()."""
    eng = served.engine(kv_bits=4, paged_kernel=True, **GEOM)
    calls = {"cpu": 0, "item": 0}
    real_cpu, real_item = torch.Tensor.cpu, torch.Tensor.item

    def spy_cpu(self, *a, **kw):
        calls["cpu"] += 1
        return real_cpu(self, *a, **kw)

    def spy_item(self):
        calls["item"] += 1
        return real_item(self)

    monkeypatch.setattr(torch.Tensor, "cpu", spy_cpu)
    monkeypatch.setattr(torch.Tensor, "item", spy_item)
    toks = served.run(eng)
    monkeypatch.undo()
    assert [len(t) for t in toks] == served.budgets
    assert eng.n_host_syncs == eng.n_chains + eng.n_prefills
    assert calls == {"cpu": eng.n_host_syncs, "item": 0}


def test_engine_argument_checks(served):
    for kw in (dict(paged=True), dict(paged=True, page_size=8),
               dict(page_size=8, pool_pages=6), dict(kv_bits=3),
               dict(paged_kernel=True), dict(paged=True, page_size=7, pool_pages=6)):
        with pytest.raises(ValueError):
            served.engine(**kw)


def test_selftest_paged_subprocess_cpu():
    flags = ["--paged", "--paged-kernel", "--kv-bits", "4"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_training_tutorials_tpu_torch.serve",
         "--selftest", "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    receipt = json.loads(out.stdout.strip().splitlines()[-1])
    assert receipt["ok"] and receipt["paged_token_exact"], receipt["problems"]
    assert receipt["paged_shed_ok"] and receipt["pages_in_use"] == 0
    assert receipt["paged_kernel_token_exact_f32"] and receipt["paged_int4_page_bytes_halved"]
    assert receipt["kv_bits"] == 4 and receipt["paged_kernel"] == 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kv", KV_BITS)
def test_teacher_forced_logits_follow_the_served_tokens(served, runs, kv):
    """A request's served tokens fed back through ``teacher_forced_logits``:
    each row's argmax is the greedy token served there; the gather path's
    rows EQUAL the unpaged engine's and the kernel path's agree to float32
    summation order. The engine is left idle and parked, with no page in use
    and its request counters unmoved."""
    prompt, toks = served.prompts[1], runs(kv, "flat")[1][1]
    logits = {}
    for mode in ("flat", "gather", "kernel"):
        kw = {} if mode == "flat" else dict(GEOM, paged_kernel=mode == "kernel")
        eng = served.engine(kv_bits=kv, **kw)
        logits[mode] = eng.teacher_forced_logits(prompt, toks)
        assert eng.idle and (eng.n_prefills, eng.n_chains, eng.n_host_syncs) == (0, 0, 0)
        if mode != "flat":
            assert eng.page_stats()["pages_in_use"] == 0
            assert (eng._state.cache.table == GEOM["pool_pages"]).all()
    assert logits["flat"].shape == (len(toks), TOY["vocab_size"])
    assert logits["flat"].argmax(-1).tolist() == toks
    assert torch.equal(logits["gather"], logits["flat"])
    scale = float(logits["flat"].abs().max())
    assert float((logits["kernel"] - logits["gather"]).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("fault", ["wrong_page", "dropped_page"])
def test_teacher_forced_gate_trips_on_a_planted_fault(served, runs, fault):
    """``chip_smoke.py``'s gate on the toy: the kernel path passes against
    the gather; the same path with the first page of its table swapped for
    a page it does not own, or dropped, fails."""
    smoke = _chip_smoke()
    prompt, toks = served.prompts[1], runs(None, "flat")[1][1]
    ref = served.engine(**GEOM).teacher_forced_logits(prompt, toks)
    eng = served.engine(paged_kernel=True, **GEOM)
    assert smoke.tf_compare(ref, eng.teacher_forced_logits(prompt, toks))["ok"]
    with smoke.planted_fault(fault):
        bad = eng.teacher_forced_logits(prompt, toks)
    rec = smoke.tf_compare(ref, bad)
    assert not rec["ok"] and rec["diff_share"] > smoke.TF_LOGIT_BOUND


@pytest.mark.parametrize("store", ["f32", "int8"])
def test_chip_smoke_paged_bound_counts_needed_positions(store):
    """The byte bound reads each row's positions [0, min(pos + S, window))
    once, none of a parked row and not the masked tail of a last page."""
    smoke = _chip_smoke()
    # B 3, S 2, H 4, KV 2, D 8, pages of 8, 4 per row; row 2 parked
    shape = ("toy", 3, 2, 4, 2, 8, 8, 4, (5, 30, 9), (2,))
    q = torch.zeros(3, 2, 4, 8)
    if store == "int8":
        k, kw = torch.zeros(10, 8, 2, 8, dtype=torch.int8), {"k_scale": torch.zeros(10, 8, 2)}
        per_pos = 2 * 2 * 8 * 1 + 2 * 2 * 4
    else:
        k, kw, per_pos = torch.zeros(10, 8, 2, 8), {}, 2 * 2 * 8 * 4
    ms, by = smoke.paged_bound(shape, q, k, kw)
    nbytes = (5 + 2 + 32) * per_pos + 2 * q.numel() * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)
