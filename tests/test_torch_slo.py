"""SLO tiers in the PyTorch port (``serve/slo.py`` and
``ServeEngine(priority_classes=)``) against the JAX package's, through the
cases of ``tests/test_slo.py``.

The policy half: the JAX file's host-only scenarios (pop order of one and
of several classes, admission, ``requeue``, the peeks, ``choose_victim``)
run twice, as written and with the port's names bound in (the JAX file is
imported, not edited); and the port's ``PriorityScheduler`` pops, requeues
and peeks what the JAX one does on seeded random streams.

The mechanism half, on real engines: the JAX test's toy float model
(vocab 64, d_model 32, 2 layers, 4 heads, window 64, ``PRNGKey(0)``)
converted through ``models/convert.py:from_jax_params``. Greedy tokens of
the preempted stream — whole-slot and paged under pool pressure, and the
chaos force-preempt — equal the JAX engine's; at int8 / int4 KV and GQA
they equal the port's own undisturbed engine, and a chaos-preempted
whole-slot engine holds a slot state BITWISE the clean engine's after
every step (the swap moves the stored values, recomputing nothing);
sampled streams (``temperature`` 0.8) resume on the same draws, whole,
paged and speculative at depth 2. Host syncs are chains + prefills +
splices + swaps out, by the engine's count and a spy on ``Tensor.cpu``;
``priority_classes=0`` is the FIFO engine, with none of the swap state.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_slo as jax_slo
from pytorch_distributed_training_tutorials_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
)
from pytorch_distributed_training_tutorials_tpu.serve import (
    PriorityScheduler as JaxPriorityScheduler,
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu.utils.chaos import ChaosConfig as JaxChaos
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    from_jax_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs.flight import FlightRecorder
from pytorch_distributed_training_tutorials_tpu_torch.serve import (
    FifoScheduler,
    PriorityScheduler,
    QueueFull,
    Request,
    ServeEngine,
    choose_victim,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve import engine as engine_mod
from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)
HOST_SCENARIOS = ["test_single_class_pop_order_identical_to_fifo",
                  "test_multi_class_pop_order", "test_priority_admission_validated_at_submit",
                  "test_requeue_bypasses_backpressure_keeps_arrival_order",
                  "test_peek_priority_and_peek_request", "test_choose_victim_policy"]
PORT_NAMES = {"FifoScheduler": FifoScheduler, "PriorityScheduler": PriorityScheduler,
              "Request": Request, "QueueFull": QueueFull, "choose_victim": choose_victim}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    """The JAX test's model (``_make``: PRNGKey(0)) and its port weights
    for each config variant asked for."""
    cache = {}

    def get(**cfg_kwargs):
        key = tuple(sorted(cfg_kwargs.items()))
        if key not in cache:
            jcfg = JaxConfig(**CFG, **cfg_kwargs)
            jmodel = JaxLM(jcfg)
            params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
            cfg = TransformerConfig(**CFG, **cfg_kwargs)
            port = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                                   device="cpu")
            cache[key] = (jmodel, params, cfg, port)
        return cache[key]

    return get


def _engine(toy, cfg_kwargs=None, **kw):
    _, _, cfg, params = toy(**(cfg_kwargs or {}))
    return ServeEngine(TransformerLM(cfg), params, tokens_per_launch=8, device="cpu", **kw)


def _prompts():
    # the JAX test's _prompt(7200, 3) and _prompt(7201, 9)
    return jax_slo._prompt(7200, 3), jax_slo._prompt(7201, 9)


def _drive(make, engine, lo_prompt, hi_prompt):
    """The JAX test's ``_drive_preemption``: a class-1 request decodes
    (one step: its prefill and first chain), then a class-0 request
    arrives. Returns (lo, hi) completions."""
    lo = engine.submit(make(prompt=lo_prompt, max_new_tokens=17, seed=0, priority=1))
    engine.step()
    hi = engine.submit(make(prompt=hi_prompt, max_new_tokens=6, seed=1, priority=0))
    done = {c.request_id: c for c in engine.run_until_idle()}
    return done[lo], done[hi]


def _undisturbed(engine_fn, lo_prompt, hi_prompt):
    """The same two requests one at a time on a FIFO engine."""
    out = []
    for prompt, n, seed in ((lo_prompt, 17, 0), (hi_prompt, 6, 1)):
        eng = engine_fn()
        eng.submit(Request(prompt=prompt, max_new_tokens=n, seed=seed))
        (c,) = eng.run_until_idle()
        out.append(c.tokens)
    return out


# -- the policy half -------------------------------------------------------

def _rebind(names: dict) -> dict:
    """The JAX test module's namespace with ``names`` bound in and its own
    functions rebuilt over it (so ``_host_req`` builds the bound
    ``Request``)."""
    g = dict(vars(jax_slo))
    g.update(names)
    for name, v in vars(jax_slo).items():
        if isinstance(v, types.FunctionType) and v.__module__ == jax_slo.__name__:
            g[name] = types.FunctionType(v.__code__, g, v.__name__, v.__defaults__,
                                         v.__closure__)
    return g


@pytest.mark.parametrize("name", HOST_SCENARIOS)
def test_host_scenario_holds_for_both(name):
    """Each host-only case of the JAX file passes as written and with the
    port's scheduler, request and victim policy bound in."""
    getattr(jax_slo, name)()
    g = _rebind(PORT_NAMES)
    assert g["PriorityScheduler"] is PriorityScheduler
    g[name]()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pop_order_equals_jax_on_random_streams(seed):
    """Seeded random streams of classes and prompt lengths, popped with
    the chunk and ``fits`` predicates in random turns, with preempted
    requests requeued and peeks between: the port's scheduler gives what
    the JAX one gives at every call, for one class and for three."""
    rng = np.random.Generator(np.random.PCG64(seed))
    for n_classes in (1, 3):
        scheds = [(PriorityScheduler(64, max_queue=64, n_classes=n_classes), Request),
                  (JaxPriorityScheduler(64, max_queue=64, n_classes=n_classes), JaxRequest)]
        logs = [[] for _ in scheds]
        popped = [[] for _ in scheds]
        ops = rng.integers(0, 6, 120)
        lens = rng.integers(1, 30, 120)
        prios = rng.integers(0, n_classes, 120)
        limit = rng.integers(4, 30, 120)
        for i, op in enumerate(ops):
            for (sch, make), log, out in zip(scheds, logs, popped):
                if op <= 1:
                    log.append(sch.submit(make(prompt=list(range(int(lens[i]))),
                                               max_new_tokens=2, priority=int(prios[i]))))
                    continue
                if op == 2 and out:
                    sch.requeue(out.pop(0))
                    log.append(("requeue", len(sch)))
                    continue
                kw = {}
                if op == 3:
                    kw = dict(chunk=8, pending_long=1)
                elif op == 4:
                    lim = int(limit[i])
                    kw = dict(fits=lambda r, lim=lim: len(r.prompt) <= lim)
                r = sch.pop(**kw)
                if r is not None:
                    out.append(r)
                head = sch.peek_request()
                log.append((None if r is None else r.request_id, sch.peek_priority(),
                            None if head is None else head.request_id))
        assert logs[0] == logs[1]


# -- the mechanism half: real engines ---------------------------------------

def test_priority_off_engine_is_the_fifo_engine(toy):
    """``priority_classes=0`` (the default) is the FIFO engine: its
    scheduler, none of the swap state or counters, the SLO stats' off
    value, and after the same stream the same tokens, slot state, chains
    and host syncs as an engine built without the argument."""
    reqs = [(jax_slo._prompt(7100 + i, p), m) for i, (p, m) in enumerate([(3, 6), (9, 5),
                                                                          (6, 8)])]
    base = _engine(toy, n_slots=2)
    off = _engine(toy, n_slots=2, priority_classes=0)
    assert type(off.scheduler) is FifoScheduler
    for attr in ("_swapped", "n_swaps_out", "n_swaps_in", "_chaos_preempt_fired"):
        assert not hasattr(off, attr), attr
    assert off._xfer is None and off.slo_stats() == {"priority_classes": 0}
    outs = []
    for eng in (base, off):
        ids = [eng.submit(Request(prompt=p, max_new_tokens=m, seed=i))
               for i, (p, m) in enumerate(reqs)]
        done = {c.request_id: c.tokens for c in eng.run_until_idle()}
        outs.append(([done[i] for i in ids], eng.n_chains, eng.n_host_syncs))
    assert outs[0] == outs[1]
    for name in ("k", "v", "index"):
        assert torch.equal(getattr(base._state.cache, name), getattr(off._state.cache, name))
    assert torch.equal(base._state.last_tok, off._state.last_tok)
    assert torch.equal(base._state.remaining, off._state.remaining)


def test_single_class_engine_serves_the_fifo_stream(toy):
    """``priority_classes=1``: every pop is the FIFO's, so a staggered
    stream through a 2-slot engine gives the FIFO engine's tokens,
    chains and syncs, and never preempts."""
    reqs = [(jax_slo._prompt(7150 + i, p), m)
            for i, (p, m) in enumerate([(3, 9), (7, 12), (5, 5), (12, 6), (2, 17)])]
    outs = []
    for kw in ({}, {"priority_classes": 1}):
        eng = _engine(toy, n_slots=2, **kw)
        ids = [eng.submit(Request(prompt=p, max_new_tokens=m, seed=i))
               for i, (p, m) in enumerate(reqs)]
        done = {c.request_id: c.tokens for c in eng.run_until_idle()}
        outs.append(([done[i] for i in ids], eng.n_chains, eng.n_host_syncs))
    assert outs[0] == outs[1] and eng.n_swaps_out == 0


def test_slo_engine_validation(toy):
    """The JAX engine's refusals: a negative class count and classes
    beside a role at construction, an out-of-range priority at submit."""
    with pytest.raises(ValueError):
        _engine(toy, n_slots=1, priority_classes=-1)
    with pytest.raises(ValueError):
        _engine(toy, n_slots=1, priority_classes=2, role="prefill")
    eng = _engine(toy, n_slots=1, priority_classes=2)
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=[1, 2], max_new_tokens=1, priority=2))
    st = eng.slo_stats()
    assert st["priority_classes"] == 2 and st["preemption"] == 1
    assert eng.stats("slo") == st


@pytest.fixture(scope="module")
def jax_preempted(toy):
    """The JAX test's preemption scenario on the JAX engine (whole-slot),
    and the undisturbed JAX tokens."""
    jmodel, params, _, _ = toy()
    lo_p, hi_p = _prompts()
    eng = JaxServeEngine(jmodel, params, n_slots=1, tokens_per_launch=8, priority_classes=2)
    lo, hi = _drive(JaxRequest, eng, lo_p, hi_p)
    assert eng.n_swaps_out == 1
    return lo.tokens, hi.tokens


@pytest.mark.parametrize("layout", ["whole", "gqa", "int8_kv", "int4_kv", "paged",
                                    "paged_int8", "spec_depth2"])
def test_preempt_resume_token_exact(toy, jax_preempted, layout):
    """The JAX acceptance pin on the port: a preempted and resumed greedy
    request, and the class-0 request that preempted it, are token-exact to
    the undisturbed engine of the same layout; with float storage (whole,
    paged, speculative) to the JAX engine's preempted stream too. One swap
    out, one in, nothing left parked; the class-0 request finishes
    first."""
    cfg_kwargs, kw = {}, {}
    if layout == "gqa":
        cfg_kwargs = {"n_kv_heads": 2}
    elif layout.endswith("kv") or layout == "paged_int8":
        kw["kv_bits"] = 4 if layout == "int4_kv" else 8
    if layout.startswith("paged"):
        kw.update(paged=True, page_size=8, pool_pages=8)
    if layout == "spec_depth2":
        kw.update(speculative_k=2, pipeline_depth=2)
    lo_p, hi_p = _prompts()
    eng = _engine(toy, cfg_kwargs, n_slots=1, priority_classes=2, **kw)
    lo, hi = _drive(Request, eng, lo_p, hi_p)
    assert eng.n_swaps_out == 1 and eng.n_swaps_in == 1 and not eng._swapped
    assert lo.finish_reason == "length" and len(lo.tokens) == 17
    assert hi.latency_s < lo.latency_s
    st = eng.slo_stats()
    assert st["n_preemptions"] == 1 and st["swapped_now"] == 0
    ref = _undisturbed(lambda: _engine(toy, cfg_kwargs, n_slots=1, **kw), lo_p, hi_p)
    assert [lo.tokens, hi.tokens] == ref
    if layout in ("whole", "paged", "spec_depth2"):
        assert [lo.tokens, hi.tokens] == list(jax_preempted)
    if kw.get("paged"):
        assert eng.page_stats()["pages_in_use"] == 0


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_swap_in_state_bitwise_every_step(toy, kv_bits):
    """The chaos force-preempt swaps slot 0 out and, the victim being the
    only waiter, straight back in the same step: after every step the
    preempted engine's slot state — K, V, scales, positions, last tokens,
    budgets — is bitwise the clean engine's."""
    reqs = [(jax_slo._prompt(7300 + i, p), m) for i, (p, m) in enumerate([(3, 12), (7, 10)])]
    engines = [_engine(toy, n_slots=2, kv_bits=kv_bits, priority_classes=2, chaos=c)
               for c in (None, ChaosConfig(preempt_slot=0, preempt_at_chain=1))]
    for eng in engines:
        for i, (p, m) in enumerate(reqs):
            eng.submit(Request(prompt=p, max_new_tokens=m, seed=i, priority=1))
    outs = [[], []]
    while not engines[0].idle:
        for eng, out in zip(engines, outs):
            out.extend((c.request_id, c.tokens) for c in eng.step())
        a, b = (e._state for e in engines)
        for name in ("k", "v", "k_scale", "v_scale", "index"):
            x, y = getattr(a.cache, name), getattr(b.cache, name)
            assert (x is None and y is None) or torch.equal(x, y), name
        assert torch.equal(a.last_tok, b.last_tok) and torch.equal(a.remaining, b.remaining)
    assert engines[1].idle and outs[0] == outs[1]
    assert engines[1].n_swaps_out == 1 == engines[1].n_swaps_in


def test_preempt_paged_pool_pressure_matches_jax(toy):
    """The paged trigger (JAX ``test_preempt_paged_pool_pressure``): slot 1
    is free but the pool cannot back the class-0 request, so the class-1
    slot swaps out and its pages return. Token-exact to the JAX engine's
    run and to the undisturbed paged engine; the pool drains."""
    jmodel, params, _, _ = toy()
    geometry = dict(paged=True, page_size=8, pool_pages=4)
    lo_p, hi_p = jax_slo._prompt(7210, 3), jax_slo._prompt(7211, 9)
    eng = _engine(toy, n_slots=2, priority_classes=2, **geometry)
    lo, hi = _drive(Request, eng, lo_p, hi_p)
    assert eng.n_swaps_out == 1 and eng.n_swaps_in == 1
    jeng = JaxServeEngine(jmodel, params, n_slots=2, tokens_per_launch=8, priority_classes=2,
                          **geometry)
    jlo, jhi = _drive(JaxRequest, jeng, lo_p, hi_p)
    assert jeng.n_swaps_out == 1
    assert [lo.tokens, hi.tokens] == [jlo.tokens, jhi.tokens]
    assert [lo.tokens, hi.tokens] == _undisturbed(
        lambda: _engine(toy, n_slots=2, **geometry), lo_p, hi_p)
    assert eng.page_stats()["pages_in_use"] == 0


def test_chaos_preempt_at_chain_once_matches_jax(toy):
    """``preempt_at_chain`` forces slot 0 through the swap path exactly
    once with no pressure; both requests' tokens equal the clean engine's
    and the JAX engine's under the same injector."""
    jmodel, params, _, _ = toy()
    reqs = [(jax_slo._prompt(7300 + i, p), m) for i, (p, m) in enumerate([(3, 12), (7, 10)])]

    def run(eng, make):
        ids = [eng.submit(make(prompt=p, max_new_tokens=m, seed=i, priority=1))
               for i, (p, m) in enumerate(reqs)]
        done = {c.request_id: c.tokens for c in eng.run_until_idle()}
        return [done[i] for i in ids]

    clean = run(_engine(toy, n_slots=2, priority_classes=2), Request)
    eng = _engine(toy, n_slots=2, priority_classes=2,
                  chaos=ChaosConfig(preempt_slot=0, preempt_at_chain=1))
    chaotic = run(eng, Request)
    assert eng.n_swaps_out == 1 and eng.n_swaps_in == 1
    jeng = JaxServeEngine(jmodel, params, n_slots=2, tokens_per_launch=8, priority_classes=2,
                          chaos=JaxChaos(preempt_slot=0, preempt_at_chain=1))
    assert chaotic == clean == run(jeng, JaxRequest)


@pytest.mark.parametrize("kw", [{}, {"paged": True, "page_size": 8, "pool_pages": 8},
                                {"speculative_k": 2}],
                         ids=["whole", "paged", "spec"])
def test_slo_host_sync_budget(toy, monkeypatch, kw):
    """Host syncs are chains + prefills + splices + swaps out, by the
    engine's count and by a spy on ``Tensor.cpu``: a swap-out is ONE
    fetch of the packed buffer, a swap-in none."""
    lo_p, hi_p = _prompts()
    eng = _engine(toy, n_slots=1, priority_classes=2, **kw)
    calls = {"n": 0}
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: (calls.__setitem__("n", calls["n"] + 1),
                                            real(t, *a, **k))[1])
    _drive(Request, eng, lo_p, hi_p)
    monkeypatch.undo()
    assert eng.n_swaps_out == 1
    budget = eng.n_chains + eng.n_prefills + eng.n_splices + eng.n_swaps_out
    assert calls["n"] == eng.n_host_syncs == budget


def test_flight_preempt_resume_events(toy):
    """One ``preempt`` / ``resume`` pair naming the victim, its earned
    tokens parked, and the preempted-wait histogram fed once."""
    rec = FlightRecorder(capacity=256)
    lo_p, hi_p = _prompts()
    eng = _engine(toy, n_slots=1, priority_classes=2, flight=rec)
    lo, _ = _drive(Request, eng, lo_p, hi_p)
    pre = [e for e in rec.events if e["kind"] == "preempt"]
    res = [e for e in rec.events if e["kind"] == "resume"]
    assert len(pre) == 1 and len(res) == 1
    assert pre[0]["rid"] == res[0]["rid"] == lo.request_id
    assert pre[0]["tokens"] > 0 and res[0]["wait_s"] >= 0.0
    assert rec.hist["preempt_wait"].n == 1
    assert "preempt_wait_p95_s" in rec.summary()


@pytest.mark.parametrize("kw", [{}, {"paged": True, "page_size": 8, "pool_pages": 8},
                                {"speculative_k": 2, "pipeline_depth": 2},
                                {"kv_bits": 4, "paged": True, "page_size": 8,
                                 "pool_pages": 8, "pipeline_depth": 2}],
                         ids=["whole", "paged", "spec_depth2", "int4_paged_depth2"])
def test_sampled_stream_resumes_on_the_same_draws(toy, kw):
    """``temperature`` 0.8: the swap carries the slot generator's state,
    so the preempted request and the one that preempted it draw what the
    undisturbed engine's do."""
    lo_p, hi_p = _prompts()
    eng = _engine(toy, n_slots=1, priority_classes=2, temperature=0.8, **kw)
    lo, hi = _drive(Request, eng, lo_p, hi_p)
    assert eng.n_swaps_out == 1
    ref = _undisturbed(lambda: _engine(toy, n_slots=1, temperature=0.8, **kw), lo_p, hi_p)
    assert [lo.tokens, hi.tokens] == ref


@pytest.mark.parametrize("paged", [False, True])
def test_preempt_composed_prefix_spec_pipeline(toy, paged):
    """The JAX file's composed arm (slow there): prefix splicing,
    speculation and depth-2 pipelining — a victim decoding from a spliced
    prefix is preempted (the donor released, the swap-in splicing from
    the parked copy), token-exact to the same composed engine run
    without contention; paged too, with the pages accounted."""
    kw = dict(prefix_cache_bytes=16 * 1024 * 1024, speculative_k=2, pipeline_depth=2)
    if paged:
        kw.update(paged=True, page_size=8, pool_pages=16)
    shared = jax_slo._prompt(7400, 12)
    lo_p, hi_p = shared + jax_slo._prompt(7401, 2), shared + jax_slo._prompt(7402, 4)

    def warm(eng):
        eng.submit(Request(prompt=shared, max_new_tokens=2, seed=9, priority=1))
        eng.run_until_idle()
        return eng

    eng = warm(_engine(toy, n_slots=1, priority_classes=2, **kw))
    lo, hi = _drive(Request, eng, lo_p, hi_p)
    assert eng.n_swaps_out >= 1 and eng.n_swaps_out == eng.n_swaps_in
    assert eng.n_splices >= 1
    ref = warm(_engine(toy, n_slots=1, priority_classes=2, **kw))
    outs = []
    for p, n, seed, prio in ((lo_p, 17, 0, 1), (hi_p, 6, 1, 0)):
        ref.submit(Request(prompt=p, max_new_tokens=n, seed=seed, priority=prio))
        (c,) = ref.run_until_idle()
        outs.append(c.tokens)
    assert ref.n_swaps_out == 0 and [lo.tokens, hi.tokens] == outs
    if paged:
        # only the index's segments still hold pages
        while eng.prefix.evict_coldest():
            pass
        assert eng.page_stats()["pages_in_use"] == 0


@pytest.mark.parametrize("paged", [False, True])
def test_swap_in_error_is_isolated(toy, monkeypatch, paged):
    """A swap-in that raises completes its request ``"error"`` with the
    tokens it earned before the swap; the class-0 request is untouched,
    the engine keeps serving and no page leaks."""
    kw = dict(paged=True, page_size=8, pool_pages=8) if paged else {}
    lo_p, hi_p = _prompts()
    eng = _engine(toy, n_slots=1, priority_classes=2, **kw)
    real = engine_mod.seed_cache

    def failing(cache1, segment, depth):
        if eng._swapped == {} and eng.n_swaps_out:  # the swap-in's seed
            raise RuntimeError("injected swap-in fault")
        return real(cache1, segment, depth)

    monkeypatch.setattr(engine_mod, "seed_cache", failing)
    lo, hi = _drive(Request, eng, lo_p, hi_p)
    monkeypatch.undo()
    assert lo.finish_reason == "error" and 0 < len(lo.tokens) < 17
    assert eng.n_prefill_errors == 1 and eng.n_swaps_in == 0
    ref = _undisturbed(lambda: _engine(toy, n_slots=1, **kw), lo_p, hi_p)
    assert hi.tokens == ref[1] and lo.tokens == ref[0][:len(lo.tokens)]
    if paged:
        assert eng.page_stats()["pages_in_use"] == 0
    eng.submit(Request(prompt=lo_p, max_new_tokens=17, seed=0, priority=1))
    (again,) = eng.run_until_idle()
    assert again.tokens == ref[0]


@pytest.mark.parametrize("how", ["cancel", "deadline"])
def test_parked_request_bounced_keeps_its_tokens(toy, how):
    """A preempted request cancelled, or past its deadline, while parked
    completes at the refill boundary with the tokens it earned before the
    swap (started work, not unstarted), and is never swapped back in."""
    lo_p, hi_p = _prompts()
    eng = _engine(toy, n_slots=1, priority_classes=2)
    lo = eng.submit(Request(prompt=lo_p, max_new_tokens=17, seed=0, priority=1))
    eng.step()  # its prefill and first chain
    eng.submit(Request(prompt=hi_p, max_new_tokens=6, seed=1, priority=0))
    done = {c.request_id: c for c in eng.step()}  # the swap out, hi's prefill
    assert eng.n_swaps_out == 1 and lo in eng._swapped
    earned = list(eng._swapped[lo].active.tokens)
    if how == "cancel":
        assert eng.cancel(lo)
    else:
        eng._swapped[lo].active.request.deadline_s = 1e-6
    done.update((c.request_id, c) for c in eng.run_until_idle())
    assert done[lo].finish_reason == ("cancelled" if how == "cancel" else "deadline")
    assert done[lo].tokens == earned and len(earned) == 9
    assert eng.n_swaps_in == 0 and not eng._swapped
