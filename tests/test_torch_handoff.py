"""Prefill/decode roles in the PyTorch port (``ServeEngine(role=)``,
``serve/scheduler.py`` ``Handoff``) against the JAX package's, through the
cases of ``tests/test_handoff.py`` (its non-slow ones) and the engine
contracts around them.

The JAX test's toy float model (vocab 64, d_model 32, 2 layers, 4 heads,
window 64, ``PRNGKey(0)``) converted through
``models/convert.py:from_jax_params``. A ``role="prefill"`` engine emits
each request's segment, first token and generator state; a
``role="decode"`` engine accepts them. Exact: the greedy tokens of the
disaggregated pair equal the JAX monolithic engine's (float storage) and
the port's monolithic engine's at every layout; after the same stream the
decode engine's slot state is BITWISE the monolithic engine's (unrolled,
GQA, int8 and int4 KV: nothing is recomputed); sampled streams
(``temperature`` 0.8) equal the monolithic engine's draws, whole, paged
and speculative. An int4 segment's K/V bytes are exactly half an int8
one's. The prefill engine makes no host sync (a spy on ``Tensor.cpu``);
the decode engine's syncs are its chains + handoffs accepted. The JAX
engine's construction refusals, and ``_validate_segment``'s of another
storage, window or layer count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_handoff as jax_handoff
from pytorch_distributed_training_tutorials_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
)
from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs.flight import FlightRecorder
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
from pytorch_distributed_training_tutorials_tpu_torch.serve.slots import tree_nbytes
from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)
SPECS = [(4, 9), (9, 7), (13, 11)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    """The JAX test's model and params (``_make``) and the port's weights
    for each config variant asked for."""
    cache = {}

    def get(**cfg_kwargs):
        key = tuple(sorted(cfg_kwargs.items()))
        if key not in cache:
            jmodel = JaxLM(JaxConfig(**{**CFG, **cfg_kwargs}))
            params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
            cfg = TransformerConfig(**{**CFG, **cfg_kwargs})
            port = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                                   device="cpu")
            cache[key] = (jmodel, params, cfg, port)
        return cache[key]

    return get


def _engine(toy, cfg_kwargs=None, **kw):
    _, _, cfg, params = toy(**(cfg_kwargs or {}))
    kw.setdefault("n_slots", 2)
    return ServeEngine(TransformerLM(cfg), params, tokens_per_launch=8, device="cpu", **kw)


def _templates(seed0=9000, specs=SPECS):
    """The JAX test's ``_templates``: its prompts, budgets and seeds."""
    return [Request(prompt=jax_handoff._prompt(seed0 + i, p), max_new_tokens=m, seed=i)
            for i, (p, m) in enumerate(specs)]


def _mono(eng, templates):
    ids = [eng.submit(dataclasses.replace(t)) for t in templates]
    done = {c.request_id: c for c in eng.run_until_idle()}
    return [done[i].tokens for i in ids]


def _pair(pre, dec, templates):
    """The JAX test's ``_drive_pair``: prefill every template, move each
    handoff in submit order, run the decode engine to idle."""
    rids = [pre.submit(dataclasses.replace(t)) for t in templates]
    comps = pre.run_until_idle()
    assert [c.finish_reason for c in comps] == ["handoff"] * len(templates)
    assert all(c.tokens == [] for c in comps)
    aids = [dec.accept(dataclasses.replace(t), pre.take_handoff(r))
            for t, r in zip(templates, rids)]
    done = {c.request_id: c for c in dec.run_until_idle()}
    return [done[a].tokens for a in aids]


@pytest.fixture(scope="module")
def jax_mono(toy):
    """The JAX monolithic engine's greedy tokens on the templates."""
    jmodel, params, _, _ = toy()
    eng = JaxServeEngine(jmodel, params, n_slots=2, tokens_per_launch=8)
    ids = [eng.submit(JaxRequest(prompt=t.prompt, max_new_tokens=t.max_new_tokens,
                                 seed=t.seed)) for t in _templates()]
    done = {c.request_id: c.tokens for c in eng.run_until_idle()}
    return [done[i] for i in ids]


def _cache_equal(a, b) -> bool:
    return all((getattr(a, n) is None and getattr(b, n) is None)
               or torch.equal(getattr(a, n), getattr(b, n))
               for n in ("k", "v", "k_scale", "v_scale", "index"))


@pytest.mark.parametrize("layout", ["unrolled", "gqa", "int8_kv", "int4_kv"])
def test_handoff_roundtrip_state_bitwise(toy, jax_mono, layout):
    """The transfer is a transplant: after the same requests in the same
    order the decode engine's slot state (cache, positions, last tokens,
    budgets) is byte-identical to the monolithic engine's; the tokens
    equal the monolithic engine's and, float, the JAX engine's. The
    prefill engine ran no chain and made no sync; the decode engine's
    syncs are its chains + handoffs."""
    cfg_kwargs = {"n_kv_heads": 2} if layout == "gqa" else {}
    kw = {"kv_bits": {"int8_kv": 8, "int4_kv": 4}[layout]} if "kv" in layout else {}
    templates = _templates()
    mono = _engine(toy, cfg_kwargs, **kw)
    ref = _mono(mono, templates)
    pre = _engine(toy, cfg_kwargs, role="prefill", **kw)
    dec = _engine(toy, cfg_kwargs, role="decode", **kw)
    out = _pair(pre, dec, templates)
    assert out == ref
    if layout == "unrolled":
        assert out == jax_mono
    assert _cache_equal(dec._state.cache, mono._state.cache)
    assert torch.equal(dec._state.last_tok, mono._state.last_tok)
    assert torch.equal(dec._state.remaining, mono._state.remaining)
    assert pre.n_chains == 0 and pre.n_handoffs_out == 3 and pre.n_host_syncs == 0
    assert dec.n_handoffs_in == 3 and dec.n_host_syncs == dec.n_chains + dec.n_handoffs_in
    assert pre.role_stats() == {"role": "prefill", "handoffs_out": 3, "handoffs_in": 0}
    assert dec.stats("role") == {"role": "decode", "handoffs_out": 0, "handoffs_in": 3}


@pytest.mark.parametrize("kw", [{}, {"paged": True, "page_size": 8, "pool_pages": 8},
                                {"speculative_k": 2, "pipeline_depth": 2}],
                         ids=["whole", "paged", "spec_depth2"])
def test_sampled_stream_equals_monolithic(toy, kw):
    """``temperature`` 0.8: the handoff carries the request's generator
    state after its first draw, so the decode engine's draws continue the
    monolithic engine's."""
    templates = _templates()
    ref = _mono(_engine(toy, temperature=0.8, **kw), templates)
    out = _pair(_engine(toy, role="prefill", temperature=0.8),
                _engine(toy, role="decode", temperature=0.8, **kw), templates)
    assert out == ref


def _kv_bytes(seg) -> int:
    """A segment's K/V and scale bytes, its index left out."""
    return sum(x.numel() * x.element_size()
               for x in (seg.k, seg.v, seg.k_scale, seg.v_scale) if x is not None)


def test_handoff_segment_pricing_int4_vs_int8(toy):
    """The JAX pin's identity: an int4 segment's K/V (packed nibbles and
    bf16 scales) costs exactly half an int8 segment's (int8 and f32
    scales); the index keeps the whole tree above half."""
    tmpl = Request(prompt=jax_handoff._prompt(9100, 11), max_new_tokens=4, seed=0)
    segs = {}
    for bits in (8, 4):
        pre = _engine(toy, role="prefill", n_slots=1, kv_bits=bits)
        rid = pre.submit(dataclasses.replace(tmpl))
        (comp,) = pre.run_until_idle()
        assert comp.finish_reason == "handoff" and comp.tokens == []
        segs[bits] = pre.take_handoff(rid)
    h8, h4 = segs[8], segs[4]
    assert h8.p_len == h4.p_len == 11 and h8.bucket == h4.bucket == 16
    assert _kv_bytes(h4.segment) * 2 == _kv_bytes(h8.segment)
    total8, total4 = tree_nbytes(h8.segment), tree_nbytes(h4.segment)
    assert total8 // 2 < total4 < total8


def test_handoff_paged_decode_accept(toy, jax_mono):
    """A paged decode engine lands handoffs through the pool: the tokens
    of the monolithic paged engine (and the JAX engine's), the same
    ``hbm_high_water_bytes``, and the pool drained at the end."""
    geometry = dict(paged=True, page_size=8, pool_pages=6)
    templates = _templates()
    mono = _engine(toy, **geometry)
    ref = _mono(mono, templates)
    dec = _engine(toy, role="decode", **geometry)
    out = _pair(_engine(toy, role="prefill"), dec, templates)
    assert out == ref == jax_mono
    sd, sm = dec.page_stats(), mono.page_stats()
    assert sd["paged"] == 1 and sd["pages_allocs"] > 0
    assert sd["hbm_high_water_bytes"] == sm["hbm_high_water_bytes"]
    assert sd["pages_in_use"] == 0


def test_prefill_role_makes_no_host_sync(toy, monkeypatch):
    """A spy on ``Tensor.cpu``: the prefill engine's whole stream —
    prefills, a prefix splice and a chunked prefill — fetches nothing; the
    decode engine fetches once a chain and once a handoff."""
    shared = jax_handoff._prompt(9400, 20)
    templates = [Request(prompt=shared + jax_handoff._prompt(9410 + i, 2 + i),
                         max_new_tokens=6, seed=i) for i in range(3)]
    templates.append(Request(prompt=jax_handoff._prompt(9420, 30), max_new_tokens=5, seed=3))
    kw = dict(prefix_cache_bytes=1 << 20, prefill_chunk=16)
    pre = _engine(toy, role="prefill", **kw)
    dec = _engine(toy, role="decode")
    calls = {"n": 0}
    real = torch.Tensor.cpu
    spy = (lambda t, *a, **k: (calls.__setitem__("n", calls["n"] + 1), real(t, *a, **k))[1])
    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    rids = [pre.submit(dataclasses.replace(t)) for t in templates]
    pre.run_until_idle()
    assert calls["n"] == 0 == pre.n_host_syncs
    assert pre.n_splices >= 1 and pre.n_chunks >= 2
    aids = [dec.accept(dataclasses.replace(t), pre.take_handoff(r))
            for t, r in zip(templates, rids)]
    done = {c.request_id: c.tokens for c in dec.run_until_idle()}
    monkeypatch.undo()
    assert calls["n"] == dec.n_host_syncs == dec.n_chains + dec.n_handoffs_in
    ref = _mono(_engine(toy, **kw), templates)
    assert [done[a] for a in aids] == ref


def test_role_construction_and_entry_refusals(toy):
    """The JAX engine's refusals (``:348-392``, ``:1762``): a prefill
    engine takes no paged pool, speculation or pipelining; a decode engine
    no prefix cache or chunked prefill; an unknown role raises. A decode
    engine refuses ``submit``, the others ``accept``; ``take_handoff``
    belongs to the prefill role."""
    for bad in (dict(role="prefill", paged=True, page_size=8, pool_pages=8),
                dict(role="prefill", speculative_k=2),
                dict(role="prefill", pipeline_depth=2),
                dict(role="decode", prefix_cache_bytes=1 << 20),
                dict(role="decode", prefill_chunk=8),
                dict(role="both")):
        with pytest.raises(ValueError):
            _engine(toy, **bad)
    pre, dec, mono = (_engine(toy, role="prefill"), _engine(toy, role="decode"),
                      _engine(toy))
    tmpl = _templates()[0]
    with pytest.raises(ValueError):
        dec.submit(dataclasses.replace(tmpl))
    rid = pre.submit(dataclasses.replace(tmpl))
    pre.run_until_idle()
    h = pre.take_handoff(rid)
    for eng in (pre, mono):
        with pytest.raises(ValueError):
            eng.accept(dataclasses.replace(tmpl), h)
    for eng in (dec, mono):
        with pytest.raises(ValueError):
            eng.take_handoff(rid)
    assert pre.role == "prefill" and dec.role == "decode" and mono.role is None


def test_validate_segment_refuses_other_storage_window_and_layers(toy):
    """``accept`` checks the segment before admission: another KV
    storage, a longer window or another layer count raise ``ValueError``
    and admit nothing."""
    tmpl = Request(prompt=jax_handoff._prompt(9500, 20), max_new_tokens=4)

    def handoff(cfg_kwargs=None, **kw):
        pre = _engine(toy, cfg_kwargs, role="prefill", **kw)
        rid = pre.submit(dataclasses.replace(tmpl))
        pre.run_until_idle()
        return pre.take_handoff(rid)

    dec = _engine(toy, role="decode")
    for h in (handoff(kv_bits=8), handoff(kv_bits=4), handoff({"n_layers": 3})):
        with pytest.raises(ValueError):
            dec.accept(dataclasses.replace(tmpl), h)
    small = _engine(toy, {"max_seq_len": 16}, role="decode")
    with pytest.raises(ValueError):  # a 32-position segment past a 16-token window
        small.accept(Request(prompt=tmpl.prompt[:10], max_new_tokens=2), handoff())
    assert len(dec.scheduler) == 0 and dec.load == 0 and dec.idle


def test_role_off_engine_is_the_monolithic_engine(toy):
    """``role=None``: no transfer cache, empty handoff maps, the role
    stats' off value, and the stream, state and syncs of an engine built
    without the argument."""
    templates = _templates()
    base, off = _engine(toy), _engine(toy, role=None)
    assert off._xfer is None and off.role_stats() == {"role": 0}
    outs = [(_mono(e, templates), e.n_host_syncs) for e in (base, off)]
    assert outs[0] == outs[1] and not off._handoffs and not off._handoff_in
    assert _cache_equal(base._state.cache, off._state.cache)


def test_decode_role_load_cancel_and_flight(toy):
    """``load`` counts accepted handoffs (queued ones twice, as the JAX
    engine's does); a queued accepted request cancelled completes with no
    tokens and drops its handoff; the recorder stamps ``handoff_emit`` and
    a first token of kind ``"handoff"``."""
    rec_p, rec_d = FlightRecorder(capacity=256), FlightRecorder(capacity=256)
    templates = _templates()
    pre = _engine(toy, role="prefill", flight=rec_p)
    dec = _engine(toy, role="decode", n_slots=1, flight=rec_d)
    rids = [pre.submit(dataclasses.replace(t)) for t in templates]
    pre.run_until_idle()
    aids = [dec.accept(dataclasses.replace(t), pre.take_handoff(r))
            for t, r in zip(templates, rids)]
    assert dec.load == 6 and not dec.idle
    assert dec.cancel(aids[2])
    done = {c.request_id: c for c in dec.run_until_idle()}
    assert done[aids[2]].finish_reason == "cancelled" and done[aids[2]].tokens == []
    assert not dec._handoff_in and dec.n_handoffs_in == 2 and dec.load == 0
    assert sum(e["kind"] == "handoff_emit" for e in rec_p.events) == 3
    assert sum(e["kind"] == "handoff_accept" for e in rec_d.events) == 2
    assert not any(e["kind"] in ("prefill", "splice") for e in rec_d.events)


def test_refill_errors_are_isolated_on_both_roles(toy):
    """A failing prefill on the prefill engine completes ``"error"`` and
    emits nothing; a failing accept on the decode engine completes
    ``"error"``; every other request is served as the monolithic engine
    serves it."""
    templates = _templates()
    ref = _mono(_engine(toy), templates)
    pre = _engine(toy, role="prefill", chaos=ChaosConfig(fail_prefill_request=1))
    rids = [pre.submit(dataclasses.replace(t)) for t in templates]
    comps = {c.request_id: c.finish_reason for c in pre.run_until_idle()}
    assert comps == {0: "handoff", 1: "error", 2: "handoff"}
    assert set(pre._handoffs) == {0, 2} and pre.n_prefill_errors == 1
    dec = _engine(toy, role="decode", chaos=ChaosConfig(fail_prefill_request=0))
    aids = [dec.accept(dataclasses.replace(templates[i]), pre.take_handoff(rids[i]))
            for i in (0, 2)]
    done = {c.request_id: c for c in dec.run_until_idle()}
    assert done[aids[0]].finish_reason == "error" and done[aids[0]].tokens == []
    assert done[aids[1]].tokens == ref[2] and dec.n_prefill_errors == 1
