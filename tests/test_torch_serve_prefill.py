"""The prefill side of the PyTorch port's serving against the JAX package's:
flash prefill (int8 and float weights), the suffix continuation, and the
prefix-cache splices and chunked prefill of ``ServeEngine`` on the
whole-slot and the paged cache.

Toy models (vocab 64, d_model 32, 2 layers, 4 query and 2 KV heads,
window 64) whose float weights are drawn with numpy from a seed; both
packages get the same values through ``models/convert.py:from_jax_params``.
On the CPU the port's ``flash_attention`` runs its plain version and the
JAX package's its Pallas kernel in interpret mode.

Tolerances and why:

- int8 weights, flash prefill: the next-token logits and every cache row
  within ``atol 1e-4`` of the JAX model's (the flash reference sums in
  another order, the port's RMSNorm runs in float64, and a one-ulp change
  can move one int8 activation code, as ``test_torch_transformer.py``
  states); greedy ``generate`` tokens equal.
- float weights, flash prefill and dense decode: float32 within ``atol
  1e-4``; bfloat16 within ``atol 3e-2`` on logits of order 1 (one bf16
  rounding of an activation is 2^-8 of it, and the two packages round
  different sums).
- The suffix continuation (decode with S > 1 from depth d on a batch-1
  cache) against the JAX model's ``decode=True`` apply on the same
  prefix: ``atol 1e-4``. The JAX package's own bitwise pin of this
  (``test_chunked_decode_matches_full_prefill``) is red on the CPU; the
  port's int8 continuation with float32 KV is BITWISE its own full
  prefill (logits and every cache row: the attention and norm sums run in
  float64 and round once), and so are its splices and chunks: the
  prefix-cache and chunked engines' tokens equal the plain engine's.
- Engine streams (prefix cache, chunked prefill, both, and the paged
  prefix cache): greedy tokens equal to the JAX ``ServeEngine``'s with the
  same ``prefix_cache_bytes`` / ``prefill_chunk`` per request; the refill
  counters (``n_prefills``, ``n_splices``, ``n_chunks``) and
  ``prefix_stats()`` equal the JAX engine's, the byte counts but for the
  segments' position counters (JAX: an int32 a layer, the port one
  int64; paged segments are priced in pages, equal); ``page_stats()``
  equal, ``pages_shares`` included. The seeded prompts are ones on which
  no int8 activation code moves a step between float32 and float64
  attention (ROADMAP.md, section C).
- Host syncs: chains + whole prefills + splices + final chunks, also
  counted by a spy on ``Tensor.cpu``.
"""

import dataclasses
import importlib
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
from pytorch_distributed_training_tutorials_tpu.models.generate import generate as jax_generate
from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    KVCache,
    TransformerConfig,
    TransformerLM,
    bind_params,
    from_jax_params,
    generate,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops import flash_attention as tfa
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
from helpers import requires_pallas_interpret

jfa = importlib.import_module("pytorch_distributed_training_tutorials_tpu.ops.flash_attention")
tmodel = importlib.import_module("pytorch_distributed_training_tutorials_tpu_torch.models.transformer")

pytestmark = requires_pallas_interpret

REPO = Path(__file__).resolve().parents[1]
TOY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)
ATOL = 1e-4
# a shared head and per-request tails: (head tokens, tail tokens, new)
STREAM = [(16, 3, 8), (16, 5, 6), (20, 2, 10), (12, 4, 7), (18, 9, 5), (16, 6, 9), (20, 11, 4)]
PREFIX_BYTES = 1 << 22
GEOM = dict(paged=True, page_size=8, pool_pages=24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _float_tree(jcfg, seed=0, scale=0.2):
    shapes = jax.eval_shape(jt.TransformerLM(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))["params"]
    rng = np.random.Generator(np.random.PCG64(seed))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if str(path[-1].key) == "scale":
            return (1.0 + 0.1 * x).astype(np.float32)
        return (scale * x).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Int8:
    """The toy int8 LM in both packages, dense and flash prefill."""

    def __init__(self):
        jcfg = jt.TransformerConfig(**TOY)
        self.qtree = jt.quantize_lm_params(_float_tree(jcfg))
        self.jcfg = dataclasses.replace(jcfg, quantized=True)
        self.cfg = TransformerConfig(**TOY, quantized=True)
        self.params = from_jax_params(_np(self.qtree), self.cfg, device="cpu")
        prng = np.random.Generator(np.random.PCG64(7))
        shared = prng.integers(0, 64, 20).tolist()
        self.prompts = [shared[:k] + prng.integers(0, 64, t).tolist() for k, t, _ in STREAM]
        self.budgets = [m for _, _, m in STREAM]

    def jmodel(self, flash=False):
        return jt.TransformerLM(dataclasses.replace(
            self.jcfg, attention_fn=jfa.flash_attention if flash else None))

    def model(self, flash=False):
        m = TransformerLM(dataclasses.replace(
            self.cfg, attention_fn=tfa.flash_attention if flash else None))
        bind_params(m, self.params)
        return m

    def run(self, engine, make=Request):
        ids = [engine.submit(make(prompt=p, max_new_tokens=m))
               for p, m in zip(self.prompts, self.budgets)]
        done = {}
        while not engine.idle:
            for c in engine.step():
                done[c.request_id] = c.tokens
        return [done[i] for i in ids]


@pytest.fixture(scope="module")
def int8():
    return Int8()


def _jax_prefill(jmodel, params, tokens, last_pos):
    return jmodel.apply({"params": params}, jnp.asarray(tokens, jnp.int32), prefill=True,
                        mutable=["cache"], last_pos=last_pos)


def _cache_rows(jcache, n_layers, p):
    return {name: np.stack([np.asarray(jcache[f"block_{i}"]["attn"][name])[:, :p]
                            for i in range(n_layers)])
            for name in ("cached_key", "cached_value")}


def test_int8_flash_prefill_matches_jax(int8):
    """Prefill through the flash forward (its plain version here, the JAX
    Pallas kernel in interpret mode there): logits at last_pos and the
    cache rows; the dense prefill of the same prompt within the same
    bound; no kernel launched on the CPU."""
    launches = dict(tfa.flash_attention.launches)
    tokens = np.asarray([int8.prompts[6] + [0] * 1])  # 31 tokens, bucket 32
    p = len(int8.prompts[6])
    jlog, jupd = _jax_prefill(int8.jmodel(flash=True), int8.qtree, tokens, p - 1)
    cache = KVCache.zeros(int8.cfg, 1, device="cpu")
    got = int8.model(flash=True)(torch.as_tensor(tokens), cache, prefill=True, last_pos=p - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
    rows = _cache_rows(jupd["cache"], 2, p)
    np.testing.assert_allclose(cache.k[:, 0, :p].numpy(), rows["cached_key"][:, 0], atol=ATOL)
    np.testing.assert_allclose(cache.v[:, 0, :p].numpy(), rows["cached_value"][:, 0], atol=ATOL)
    dense = int8.model()(torch.as_tensor(tokens), KVCache.zeros(int8.cfg, 1, device="cpu"),
                         prefill=True, last_pos=p - 1)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=ATOL, rtol=0)
    assert tfa.flash_attention.launches == launches


def test_int8_generate_with_flash_matches_jax(int8):
    """``generate`` with ``attention_fn=flash_attention`` prefills through
    the flash op, as the JAX package's generate does: greedy tokens equal."""
    prompt = [int8.prompts[4]]
    want = jax_generate(int8.jmodel(flash=True), int8.qtree, jnp.asarray(prompt, jnp.int32), 12)
    got = generate(int8.model(flash=True), None, prompt, 12, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_model_serves_like_jax(dtype):
    """A float TransformerLM (the training weights) prefills through the
    flash op and decodes the cache in cfg.dtype, against the JAX float
    model: prefill logits, then 6 teacher-forced decode steps."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    atol = ATOL if dtype == "float32" else 3e-2
    jcfg = jt.TransformerConfig(**TOY, dtype=jdt, attention_fn=jfa.flash_attention)
    tree = _float_tree(jt.TransformerConfig(**TOY), seed=3, scale=0.1)
    cfg = TransformerConfig(**TOY, dtype=tdt, attention_fn=tfa.flash_attention)
    model = TransformerLM(cfg)
    bind_params(model, from_jax_params(_np(tree), cfg, device="cpu"))
    prng = np.random.Generator(np.random.PCG64(9))
    prompt = prng.integers(0, 64, (1, 16))
    steps = prng.integers(0, 64, (6, 1, 1))
    jmodel = jt.TransformerLM(jcfg)
    jlog, upd = _jax_prefill(jmodel, tree, prompt, 15)
    jouts = [np.asarray(jlog[:, -1], np.float32)]
    jcache = upd["cache"]
    for t in steps:
        out, upd = jmodel.apply({"params": tree, "cache": jcache}, jnp.asarray(t, jnp.int32),
                                decode=True, mutable=["cache"])
        jcache = upd["cache"]
        jouts.append(np.asarray(out[:, -1], np.float32))
    cache = KVCache.zeros(cfg, 1, device="cpu")
    assert cache.k.dtype == tdt  # stored in the compute type, as JAX's
    with torch.no_grad():
        outs = [model(torch.as_tensor(prompt), cache, prefill=True)[:, -1].float()]
        for t in steps:
            outs.append(model(torch.as_tensor(t), cache, decode=True)[:, -1].float())
    for got, want in zip(outs, jouts):
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    assert cache.index.tolist() == [16 + len(steps)]


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_suffix_continuation_matches_jax_and_own_prefill(int8, variant):
    """Prefill [0, d), then decode the bucket-padded suffix [d, P) in one
    call: against the JAX model's decode=True apply (its actual outputs,
    atol 1e-4), and bitwise the port's own full prefill of [0, P)."""
    kv = {"mha": None, "gqa": 2}[variant]
    toy = {**TOY, "n_kv_heads": kv}
    jcfg = jt.TransformerConfig(**toy)
    qtree = jt.quantize_lm_params(_float_tree(jcfg, seed=1))
    jmodel = jt.TransformerLM(dataclasses.replace(jcfg, quantized=True))
    cfg = TransformerConfig(**toy, quantized=True)
    model = TransformerLM(cfg)
    bind_params(model, from_jax_params(_np(qtree), cfg, device="cpu"))
    tokens = np.random.Generator(np.random.PCG64(2)).integers(0, 64, (1, 21))
    P, d, pad_to = 21, 7, 16
    suffix = np.concatenate([tokens[:, d:], np.zeros((1, pad_to - (P - d)), np.int64)], 1)
    _, upd = _jax_prefill(jmodel, qtree, tokens[:, :d], d - 1)
    jchunk, jupd = jmodel.apply({"params": qtree, "cache": upd["cache"]},
                                jnp.asarray(suffix, jnp.int32), decode=True,
                                mutable=["cache"], last_pos=P - 1 - d)
    cache = KVCache.zeros(cfg, 1, device="cpu")
    model(torch.as_tensor(tokens[:, :d]), cache, prefill=True)
    chunk = model(torch.as_tensor(suffix), cache, decode=True, last_pos=P - 1 - d)
    np.testing.assert_allclose(chunk.numpy(), np.asarray(jchunk), atol=ATOL, rtol=0)
    rows = _cache_rows(jupd["cache"], 2, P)
    np.testing.assert_allclose(cache.k[:, 0, :P].numpy(), rows["cached_key"][:, 0], atol=ATOL)
    assert cache.index.tolist() == [d + pad_to]
    full_cache = KVCache.zeros(cfg, 1, device="cpu")
    full = model(torch.as_tensor(tokens), full_cache, prefill=True, last_pos=P - 1)
    assert torch.equal(full, chunk)
    assert torch.equal(full_cache.k[:, :, :P], cache.k[:, :, :P])
    assert torch.equal(full_cache.v[:, :, :P], cache.v[:, :, :P])


class _SyncSpy:
    """Counts device->host copies through ``Tensor.cpu``."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = torch.Tensor.cpu

        def counting(t, *a, **k):
            self.n += 1
            return real(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "cpu", counting)


ARMS = {
    "prefix": dict(prefix_cache_bytes=PREFIX_BYTES),
    "chunk": dict(prefill_chunk=8),
    "prefix-chunk": dict(prefix_cache_bytes=PREFIX_BYTES, prefill_chunk=8),
    "paged-prefix": dict(prefix_cache_bytes=PREFIX_BYTES, **GEOM),
    "paged-prefix-kernel": dict(prefix_cache_bytes=PREFIX_BYTES, paged_kernel=True, **GEOM),
    "paged-prefix-chunk": dict(prefix_cache_bytes=PREFIX_BYTES, prefill_chunk=8, **GEOM),
}


@pytest.fixture(scope="module")
def plain_tokens(int8):
    return int8.run(ServeEngine(int8.model(), int8.params, n_slots=2, tokens_per_launch=8,
                                device="cpu"))


@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_stream_matches_jax_engine(int8, plain_tokens, arm, monkeypatch):
    """One overlapping stream through the port's engine and the JAX
    package's with the same options: tokens per request, refill counters,
    prefix_stats and page_stats; the port's tokens equal its cache-off,
    chunk-off engine's; the host syncs are budgeted; no page leaks once
    the index lets go of its segments."""
    kw = ARMS[arm]
    jeng = JaxServeEngine(int8.jmodel(), int8.qtree, n_slots=2, tokens_per_launch=8, **kw)
    want = int8.run(jeng, make=JaxRequest)
    eng = ServeEngine(int8.model(), int8.params, n_slots=2, tokens_per_launch=8, device="cpu",
                      **kw)
    spy = _SyncSpy(monkeypatch)
    rows = []  # query rows of each paged-attention call
    real = tmodel.paged_attention
    monkeypatch.setattr(tmodel, "paged_attention",
                        lambda q, *a, **k: rows.append(q.shape[1]) or real(q, *a, **k))
    got = int8.run(eng)
    monkeypatch.undo()
    assert got == want
    # a paged_kernel engine's splices read the pool through the kernel's
    # wrapper (one call a layer at the suffix bucket), as decode does
    n_suffix = TOY["n_layers"] * eng.refills["splice"] if kw.get("paged_kernel") else 0
    assert sum(s > 1 for s in rows) == n_suffix
    assert got == plain_tokens
    assert (eng.n_prefills, eng.n_splices, eng.n_chunks) == (
        jeng.n_prefills, jeng.n_splices, jeng.n_chunks)
    if "prefix" in arm:
        assert eng.n_splices >= 1
    if "chunk" in arm:
        assert eng.n_chunks >= 1
    final_chunks = eng.refills["chunked"] + eng.refills["chunked_splice"]
    budget = (eng.n_chains + eng.refills["prefill"] + eng.refills["splice"]
              + final_chunks)
    assert eng.n_host_syncs == spy.n == budget
    jstats, stats = jeng.prefix_stats(), eng.prefix_stats()
    if eng._paged:
        assert stats == jstats
        pstats, jpstats = eng.page_stats(), jeng.page_stats()
        assert pstats == jpstats | {"paged_kernel": int(kw.get("paged_kernel", False))}
        if "chunk" not in arm:
            assert pstats["pages_shares"] > 0
        while eng.prefix.evict_coldest():
            pass
        assert eng.page_stats()["pages_in_use"] == 0
    elif "prefix" in arm:
        n_seg, counter = stats["prefix_segments"], 4 * TOY["n_layers"] - 8
        assert stats["prefix_used_bytes"] == jstats["prefix_used_bytes"] - n_seg * counter
        drop = ("prefix_used_bytes", "prefix_evicted_bytes")
        assert {k: v for k, v in stats.items() if k not in drop} == {
            k: v for k, v in jstats.items() if k not in drop}
        assert stats["prefix_hit_rate"] > 0
    assert tfa.flash_attention.launches["fwd"] == 0  # CPU: plain versions


def test_prefix_and_chunk_engines_with_flash_prefill(int8):
    """Flash prefill under the prefix cache and chunked prefill: tokens
    equal the dense engine's on this stream, and teacher-forced logits
    through a splice stay within the flash bound of the dense path's."""
    dense = ServeEngine(int8.model(), int8.params, n_slots=2, tokens_per_launch=8,
                        device="cpu", prefix_cache_bytes=PREFIX_BYTES, prefill_chunk=16)
    flash = ServeEngine(int8.model(flash=True), int8.params, n_slots=2, tokens_per_launch=8,
                        device="cpu", prefix_cache_bytes=PREFIX_BYTES, prefill_chunk=16)
    want, got = int8.run(dense), int8.run(flash)
    assert got == want
    assert flash.refills == dense.refills and flash.n_splices >= 1
    toks = want[6]
    a = dense.teacher_forced_logits(int8.prompts[6], toks)
    b = flash.teacher_forced_logits(int8.prompts[6], toks)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
    assert a.shape == (len(toks), TOY["vocab_size"])


def test_engine_checks_the_new_options(int8):
    m = int8.model()
    for chunk in (4, 12, -8):
        with pytest.raises(ValueError, match="prefill_chunk"):
            ServeEngine(m, int8.params, prefill_chunk=chunk, device="cpu")
    with pytest.raises(ValueError, match="prefix_cache_bytes"):
        ServeEngine(m, int8.params, prefix_cache_bytes=-1, device="cpu")
    eng = ServeEngine(m, int8.params, device="cpu")
    assert eng.prefix_stats() == {"prefix_cache": 0} and eng.prefix is None


def test_splice_leaves_other_slots_alone(int8):
    """A splice writes its slot from a side cache: the other slot's rows
    and position do not move."""
    eng = ServeEngine(int8.model(), int8.params, n_slots=2, tokens_per_launch=4,
                      device="cpu", prefix_cache_bytes=PREFIX_BYTES)
    eng.submit(Request(prompt=int8.prompts[0], max_new_tokens=30))
    eng.step()  # slot 0 decodes
    k0 = eng._state.cache.k[:, 0].clone()
    idx0 = int(eng._state.cache.index[0])
    eng.submit(Request(prompt=int8.prompts[1], max_new_tokens=4))
    eng._refill(1, eng._pop_request())
    assert eng.n_splices == 1
    assert torch.equal(eng._state.cache.k[:, 0], k0)
    assert int(eng._state.cache.index[0]) == idx0
    assert int(eng._state.cache.index[1]) == len(int8.prompts[1])


@pytest.mark.parametrize("paged", [False, True], ids=["whole-slot", "paged"])
def test_failed_splice_releases_donor_and_pages(int8, paged):
    """A splice whose forward raises: the error reaches the caller, the
    donor segment is unpinned, the slot parked and (paged) every page
    reference the refill took goes back; the engine then serves on."""
    kw = dict(GEOM) if paged else {}
    eng = ServeEngine(int8.model(), int8.params, n_slots=2, tokens_per_launch=8,
                      device="cpu", prefix_cache_bytes=PREFIX_BYTES, **kw)
    eng.submit(Request(prompt=int8.prompts[0], max_new_tokens=2))
    eng.run_until_idle()
    (seg,) = list(eng.prefix.segments())
    in_use = eng.page_stats().get("pages_in_use")
    forward = eng._dec_model if paged else eng.model

    def boom(*a, **k):
        raise RuntimeError("planted splice failure")

    forward.forward = boom
    eng.submit(Request(prompt=int8.prompts[1], max_new_tokens=4))
    with pytest.raises(RuntimeError, match="planted"):
        eng.step()
    del forward.forward
    assert seg.refcount == 0 and eng.n_splices == 0
    assert int(eng._state.remaining[0]) == 0
    if paged:
        assert eng.page_stats()["pages_in_use"] == in_use  # the segment's only
        assert (eng._state.cache.table[0] == GEOM["pool_pages"]).all()
    eng.submit(Request(prompt=int8.prompts[1], max_new_tokens=4))
    (done,) = eng.run_until_idle()
    assert len(done.tokens) == 4 and eng.n_splices == 1


def _selftest(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_training_tutorials_tpu_torch.serve",
         "--selftest", "--device", "cpu", *args],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_selftest_prefix_chunk_flash_arms_exit_0():
    r = _selftest("--prefix", "--chunk", "--flash")
    assert r["ok"] and r["prefix_token_exact"] and r["chunk_token_exact"]
    assert r["prefix_n_splices"] >= 1 and r["chunk_n_chunks"] >= 1
    assert r["flash_teacher_forced_ok"]


def test_selftest_paged_prefix_leg_exits_0():
    r = _selftest("--paged", "--prefix")
    assert r["ok"] and r["paged_prefix_token_exact"]
    assert r["paged_prefix_pages_shares"] > 0 and r["paged_prefix_pages_in_use"] == 0
