"""The PyTorch port's prefix index and segment surgery against the JAX
package's.

- ``serve/prefix.py``: the port's ``PrefixIndex`` and the JAX package's
  run one seeded sequence of inserts, lookups, acquires, releases and
  evictions (LRU under a byte budget, a refused insert when pinned
  segments fill it, ``evict_coldest``, the ``on_evict`` hook) and agree
  on every return value, on ``stats()`` after every operation and on the
  resident segments in LRU order — exactly (host integers).
- A fresh interpreter imports the port's ``serve/prefix.py`` and finds no
  ``torch`` in ``sys.modules``.
- ``serve/slots.py``: ``extract_segment`` / ``seed_cache`` / ``zero_cache``
  / ``copy_slot`` over the port's ``KVCache`` (leading layer axis, int8
  scales) against the JAX helpers over the JAX cache tree: the same
  values, bitwise (pure copies); ``tree_nbytes`` of a segment from its
  shapes and dtypes, equal to the JAX price but for the position counter
  (JAX keeps one int32 a layer, the port one int64).
- Eviction never takes an acquired segment, in an engine too: a segment
  pinned by a decoding splice survives an insert that needs its bytes,
  the insert is refused, and after the release the next insert evicts it.
"""

import dataclasses
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
from pytorch_distributed_training_tutorials_tpu.serve import prefix as jprefix
from pytorch_distributed_training_tutorials_tpu.serve import slots as jslots
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    KVCache,
    TransformerConfig,
    TransformerLM,
    init_quantized_lm,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve import (
    PrefixIndex,
    Request,
    Segment,
    ServeEngine,
    slots as tslots,
)

REPO = Path(__file__).resolve().parents[1]
TOY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)


def _ops(seed: int, n: int = 300):
    """A seeded operation sequence over keys drawn from a few shared
    families (so lookups hit at many depths)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    families = [rng.integers(0, 6, 12).tolist() for _ in range(3)]
    out = []
    for _ in range(n):
        fam = families[int(rng.integers(0, 3))]
        key = fam[: int(rng.integers(1, 13))] + rng.integers(0, 6, int(rng.integers(0, 3))).tolist()
        op = ["insert", "lookup", "lookup", "acquire", "release", "evict"][int(rng.integers(0, 6))]
        out.append((op, key, int(rng.integers(1, 40)), int(rng.integers(1, 4))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_index_matches_jax(seed):
    """Both indexes, fed the same operations, answer the same and hold the
    same state after every step."""
    evicted = {"jax": [], "port": []}
    idx = {
        "jax": jprefix.PrefixIndex(120, on_evict=lambda s: evicted["jax"].append(s.key)),
        "port": PrefixIndex(120, on_evict=lambda s: evicted["port"].append(s.key)),
    }
    pinned = {"jax": [], "port": []}
    for step, (op, key, nbytes, min_depth) in enumerate(_ops(seed)):
        got = {}
        for name, ix in idx.items():
            if op == "insert":
                got[name] = ix.insert(key, ("h", tuple(key)), nbytes)
            elif op == "lookup":
                hit = ix.lookup(key, min_depth)
                got[name] = None if hit is None else (hit[0], hit[1].key, hit[1].nbytes)
            elif op == "acquire":
                hit = ix.lookup(key, 1)
                if hit is not None:
                    ix.acquire(hit[1])
                    pinned[name].append(hit[1])
                got[name] = None if hit is None else hit[1].key
            elif op == "release":
                seg = pinned[name].pop(0) if pinned[name] else None
                if seg is not None:
                    ix.release(seg)
                got[name] = None if seg is None else seg.key
            else:
                got[name] = ix.evict_coldest()
        assert got["jax"] == got["port"], (step, op, key)
        js, ts = idx["jax"].stats(), idx["port"].stats()
        assert js == ts, (step, op)
        assert ([(s.key, s.nbytes, s.refcount) for s in idx["jax"].segments()]
                == [(s.key, s.nbytes, s.refcount) for s in idx["port"].segments()])
        assert len(idx["jax"]) == len(idx["port"])
    assert evicted["jax"] == evicted["port"] and evicted["port"]
    assert idx["port"].stats()["hits"] > 0 and idx["port"].stats()["evicted_bytes"] > 0


def test_index_refuses_to_evict_acquired_segment():
    """A budget full of pinned segments refuses an insert (returns False,
    stores nothing) instead of evicting under a live refcount."""
    for cls in (jprefix.PrefixIndex, PrefixIndex):
        ix = cls(100)
        assert ix.insert([1, 2, 3], "a", 60)
        depth, seg = ix.lookup([1, 2, 3, 4])
        ix.acquire(seg)
        assert not ix.insert([5, 6], "b", 60)  # would need seg's bytes
        assert not ix.evict_coldest()
        assert [s.key for s in ix.segments()] == [(1, 2, 3)]
        ix.release(seg)
        assert ix.insert([5, 6], "b", 60)  # now the cold one goes
        assert [s.key for s in ix.segments()] == [(5, 6)]
        assert ix.stats()["evicted_bytes"] == 60
        with pytest.raises(ValueError):
            ix.release(seg)


def test_prefix_module_imports_no_torch():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('prefix', "
        f"{str(REPO / 'pytorch_distributed_training_tutorials_tpu_torch' / 'serve' / 'prefix.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert mod.PrefixIndex(10).stats()['segments'] == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy', 'jax'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr


@pytest.fixture(scope="module")
def prefilled():
    """One toy prompt prefilled by both packages from the same int8
    weights, at int8 KV (so the scale leaves take part)."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        bind_params,
        from_jax_params,
    )

    jcfg = jt.TransformerConfig(**TOY, quantized=True, kv_cache_dtype=jnp.int8)
    shapes = jax.eval_shape(
        jt.TransformerLM(dataclasses.replace(jcfg, quantized=False)).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    rng = np.random.Generator(np.random.PCG64(0))
    ftree = jax.tree_util.tree_map(
        lambda x: (0.2 * rng.standard_normal(x.shape)).astype(np.float32), shapes)
    qtree = jt.quantize_lm_params(ftree)
    jmodel = jt.TransformerLM(jcfg)
    tokens = np.random.Generator(np.random.PCG64(5)).integers(0, 64, (1, 16))
    _, upd = jmodel.apply({"params": qtree}, jnp.asarray(tokens, jnp.int32), prefill=True,
                          mutable=["cache"], last_pos=12)
    cfg = TransformerConfig(**TOY, quantized=True, kv_cache_dtype=torch.int8)
    model = TransformerLM(cfg)
    bind_params(model, from_jax_params(jax.tree_util.tree_map(np.asarray, qtree), cfg,
                                       device="cpu"))
    cache = KVCache.zeros(cfg, 1, device="cpu")
    model(torch.as_tensor(tokens), cache, prefill=True, last_pos=12)
    # the JAX tree holds the port's values (the two prefills agree to
    # float32 rounding, not bitwise), so the surgery is compared on equal
    # inputs
    port = _port_leaves_like_jax(cache)
    jcache = {blk: {"attn": {name: (jnp.asarray(port[name][int(blk.split("_")[1])])
                                    if name in port else leaf)
                             for name, leaf in sub["attn"].items()}}
              for blk, sub in upd["cache"].items()}
    return cfg, jcache, cache


def _port_leaves_like_jax(cache):
    """The port cache's K, V, scales as (L, B, W, ...) arrays without the
    sink position, in the JAX tree's leaf order per layer."""
    w = cache.window
    return {"cached_key": cache.k[:, :, :w].numpy(), "cached_value": cache.v[:, :, :w].numpy(),
            "cached_key_scale": cache.k_scale[:, :, :w].numpy(),
            "cached_value_scale": cache.v_scale[:, :, :w].numpy()}


def _jax_leaves(tree, n_layers):
    out = {}
    for name in ("cached_key", "cached_value", "cached_key_scale", "cached_value_scale"):
        out[name] = np.stack([np.asarray(tree[f"block_{i}"]["attn"][name])
                              for i in range(n_layers)])
    return out


def test_segment_surgery_matches_jax(prefilled):
    """extract / seed / zero on both packages' caches: bitwise equal
    values, and the segment's price from metadata."""
    cfg, jcache, cache = prefilled
    names = set(jcache["block_0"]["attn"])
    assert {"cached_key", "cached_value", "cached_key_scale", "cached_value_scale"} <= names
    seg_len, depth = 16, 9
    jseg = jslots.extract_segment(jcache, seg_len, scan_layers=False)
    tseg = tslots.extract_segment(cache, seg_len)
    assert tseg.k.shape == (cfg.n_layers, 1, seg_len, cfg.kv_heads, cfg.head_dim)
    assert tseg.k.data_ptr() != cache.k.data_ptr()  # owns its memory
    js = _jax_leaves(jseg, cfg.n_layers)
    for name, x in zip(js, (tseg.k, tseg.v, tseg.k_scale, tseg.v_scale)):
        np.testing.assert_array_equal(x.numpy(), js[name])
    # the price: K/V and scales as JAX's, the counter one int64 (JAX: one
    # int32 per layer)
    assert tslots.tree_nbytes(tseg) == jslots.tree_nbytes(jseg) - 4 * cfg.n_layers + 8
    proto = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jcache)
    jseeded = jslots.seed_cache(proto, jseg, depth)
    side = KVCache.zeros(cfg, 1, device="cpu")
    side.k.fill_(7)  # a recycled side cache: seeding overwrites all of it
    tseeded = tslots.seed_cache(side, tseg, depth)
    assert tseeded is side and side.index.tolist() == [depth]
    assert int(jseeded["block_0"]["attn"]["cache_index"]) == depth
    for name, x in _port_leaves_like_jax(side).items():
        np.testing.assert_array_equal(x, _jax_leaves(jseeded, cfg.n_layers)[name])
    assert not side.k[:, :, cfg.max_seq_len].any()  # the sink too
    jz = jslots.zero_cache(proto)
    tslots.zero_cache(side)
    for name, x in _port_leaves_like_jax(side).items():
        np.testing.assert_array_equal(x, _jax_leaves(jz, cfg.n_layers)[name])
    assert side.index.tolist() == [0] and not side.k.any()


def test_copy_slot_moves_only_that_slot(prefilled):
    cfg, _, cache = prefilled
    state = tslots.init_slot_state(cfg, 3, "cpu")
    state.cache.k.fill_(3)
    state.cache.index[:] = torch.tensor([5, 6, 7])
    tslots.copy_slot(state, cache, 1)
    assert torch.equal(state.cache.k[:, 1], cache.k[:, 0])
    assert torch.equal(state.cache.v_scale[:, 1], cache.v_scale[:, 0])
    assert (state.cache.k[:, [0, 2]] == 3).all()
    assert state.cache.index.tolist() == [5, 6, 7]  # write_slot sets the slot's


def test_engine_never_evicts_a_segment_a_slot_decodes_from():
    """An engine whose budget holds one segment: while a splice of it
    decodes, a new prompt's insert is refused rather than evicting it;
    once that request completes, the next insert evicts it."""
    cfg = TransformerConfig(**TOY, quantized=True)
    params = init_quantized_lm(cfg, seed=0, device="cpu")
    rng = np.random.Generator(np.random.PCG64(4))
    base = rng.integers(0, 64, 12).tolist()
    seg_bytes = 2 * cfg.n_layers * 16 * cfg.kv_heads * cfg.head_dim * 4 + 8  # bucket 16
    eng = ServeEngine(TransformerLM(cfg), params, n_slots=2, tokens_per_launch=4,
                      prefix_cache_bytes=seg_bytes, device="cpu")
    eng.submit(Request(prompt=base, max_new_tokens=1))
    eng.run_until_idle()
    (seg,) = list(eng.prefix.segments())
    assert seg.nbytes == seg_bytes and seg.refcount == 0
    # a splice of it decodes for a while; a different prompt arrives
    eng.submit(Request(prompt=base + [1, 2], max_new_tokens=20))
    eng.step()
    assert eng.n_splices == 1 and seg.refcount == 1
    other = rng.integers(0, 64, 10).tolist()
    eng.submit(Request(prompt=other, max_new_tokens=2))
    eng.step()
    assert [s.key for s in eng.prefix.segments()] == [tuple(base)]  # refused, kept
    assert seg.handle is not None and eng.prefix.stats()["evicted_bytes"] == 0
    eng.run_until_idle()
    assert seg.refcount == 0
    eng.submit(Request(prompt=other[:9], max_new_tokens=2))  # a miss: inserts
    eng.run_until_idle()
    assert [s.key for s in eng.prefix.segments()] == [tuple(other[:9])]
    assert seg.handle is None and eng.prefix.stats()["evicted_bytes"] == seg_bytes


def test_segment_is_a_public_name():
    assert Segment((1,), None, 0).refcount == 0
