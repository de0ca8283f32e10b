"""Serving's failure handling in the PyTorch port against the JAX package's
``ServeEngine``: deadlines, cancel, close and drain, the non-finite guard's
quarantine and prefill-error isolation, driven by the chaos injectors of
``utils/chaos.py``.

The toy int8 LM of ``test_torch_serve_prefill.py`` (vocab 64, d_model 32,
2 layers, 4 query and 2 KV heads, window 64; weights drawn with numpy from
a seed, both packages fed the same values through
``models/convert.py:from_jax_params``) serves one scripted stream through
both engines at each option set of ``ARMS``: whole-slot with the guard on
and off, speculation with the guard, chunked prefill with the prefix cache
(a failing chunked splice, a cancel landing mid chunked prefill) and depth
2 (the observed boundary). ``test_torch_serve_faults_paged.py`` runs the
same script on paged engines.

The script, the same for both engines: eight requests at once — one
poisoned by ``nan_logit_slot``/``nan_logit_step`` (guard arms), one whose
prefill fails (``fail_prefill_request``), one cancelled while queued, one
whose 1 µs deadline has passed when it is popped; the others carry no
deadline. A cancel of an active request when the engine reaches
``CANCEL_AT`` chains; a late request with a ``LATE_DEADLINE_S`` deadline
submitted just before the step that dispatches chain ``STALL_AT``, which
stalls for several times that deadline (``stall_s``): the request is
popped microseconds after its submit and expires at the next sweep, so
both engines reach the same boundary whatever the host's speed.

Exact, per arm: every request's tokens and finish reason, ``fault_stats()``,
the chain and refill counters; the port's host syncs are chains + whole
prefills + splices + final chunks, counted by the engine and by a spy on
``Tensor.cpu`` (the guard's flags ride the chain's one fetch); the victims'
tokens are prefixes of the fault-free run's (the late request's of
``generate``'s) and every untouched request equals it. Then, port only:
guard on without faults is the fault-free stream with equal syncs, its
block one more plane and the guard-off block unchanged; admission checks,
``cancel`` of unknown and finished ids, ``QueueClosed`` after ``drain``,
``fault_stats()`` and ``stats()``; the chaos NaN at a host step index
decided on the host (no tensor made from host data).
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu.utils import chaos as jchaos
from pytorch_distributed_training_tutorials_tpu_torch.models import generate
from pytorch_distributed_training_tutorials_tpu_torch.serve import (
    QueueClosed,
    Request,
    ServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.utils import chaos
from helpers import requires_pallas_interpret
from test_torch_serve_prefill import Int8

pytestmark = requires_pallas_interpret

PREFIX_BYTES = 1 << 22
# (prompt length, budget): eight requests in two buckets (8, 16)
SHAPES = [(5, 12), (12, 10), (16, 8), (10, 9), (6, 7), (16, 10), (11, 6), (4, 8)]
POISONED, FAILED, CANCEL_QUEUED, EXPIRED_QUEUED, CANCEL_ACTIVE = 1, 2, 3, 4, 0
# the active cancel lands once this many chains were dispatched; the late
# request's chain is the first, from FIRST_STALL on, whose step begins
# with an empty queue, a free slot and no chunked prefill pending
CANCEL_AT, FIRST_STALL = 1, 2
LATE_DEADLINE_S, STALL_S = 0.1, 0.5
NAN = dict(nan_logit_slot=1, nan_logit_step=5)
FAULTS = dict(fail_prefill_request=FAILED, stall_s=STALL_S)
GEOM = dict(paged=True, page_size=8, pool_pages=24)
# arm -> (engine options, chaos fields)
ARMS = {
    "whole-guard": (dict(guard_nonfinite=True), {**NAN, **FAULTS}),
    "whole-guard-off": (dict(), FAULTS),
    "spec-guard": (dict(guard_nonfinite=True, speculative_k=2), {**NAN, **FAULTS}),
    "chunk-prefix": (dict(guard_nonfinite=True, prefill_chunk=8,
                          prefix_cache_bytes=PREFIX_BYTES), {**NAN, **FAULTS}),
    "depth2-guard": (dict(guard_nonfinite=True, pipeline_depth=2), {**NAN, **FAULTS}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Stream:
    """The toy int8 LM and the scripted stream (module docstring)."""

    def __init__(self):
        self.m = Int8()
        rng = np.random.Generator(np.random.PCG64(21))
        head = rng.integers(0, 64, 4).tolist()
        # a shared 4-token head, so prefix-cache arms splice
        self.prompts = [head + rng.integers(0, 64, p - 4).tolist() if p > 4 else head[:p]
                        for p, _ in SHAPES]
        self.late = head + rng.integers(0, 64, 6).tolist()

    def run(self, engine, make=Request, faults=True, stall_at=None):
        """Drive ``engine`` through the script; returns ``(outcomes, late,
        stall_at)``: ``(tokens, finish_reason)`` of the eight requests in
        submit order and of the late request (None without ``faults``),
        and the chain whose step took the late request. ``stall_at`` None:
        a dry run that finds that chain (the first from ``FIRST_STALL`` on
        whose step begins with an empty queue, a free slot and no chunked
        prefill pending); else the late request goes in just before the
        step that dispatches chain ``stall_at``. A chunked prefill seen
        pending is cancelled (the chunked arm)."""
        ids = []
        for i, (prompt, (_, new)) in enumerate(zip(self.prompts, SHAPES)):
            dl = 1e-6 if faults and i == EXPIRED_QUEUED else None
            ids.append(engine.submit(make(prompt=prompt, max_new_tokens=new, deadline_s=dl)))
        if faults:
            assert engine.cancel(ids[CANCEL_QUEUED]) is True
        late = cancelled = pending_cancelled = None
        done = {}
        for _ in range(200):
            if faults and cancelled is None and engine.n_chains >= CANCEL_AT:
                cancelled = engine.cancel(ids[CANCEL_ACTIVE])
                assert cancelled
            if faults and pending_cancelled is None and engine._pending:
                (pend,) = engine._pending.values()
                pending_cancelled = engine.cancel(pend.request.request_id)
            if faults and late is None:
                free = (len(engine.scheduler) == 0 and not engine._pending
                        and engine.active_slots < engine.n_slots)
                if stall_at is None and free and engine.n_chains >= FIRST_STALL:
                    stall_at = engine.n_chains
                if stall_at is not None and engine.n_chains == stall_at:
                    assert free
                    late = engine.submit(make(prompt=self.late, max_new_tokens=12,
                                              deadline_s=LATE_DEADLINE_S))
            if engine.idle and (late is not None or not faults):
                break
            for c in engine.step():
                done[c.request_id] = (c.tokens, c.finish_reason)
        assert engine.idle
        return [done[i] for i in ids], done.get(late), stall_at

    def engine(self, **kw):
        return ServeEngine(self.m.model(), self.m.params, n_slots=2, tokens_per_launch=4,
                           device="cpu", **kw)


@pytest.fixture(scope="module")
def stream():
    return Stream()


class _SyncSpy:
    """Counts device->host copies through ``Tensor.cpu``."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = torch.Tensor.cpu

        def counting(t, *a, **k):
            self.n += 1
            return real(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "cpu", counting)


def _budget(eng) -> int:
    return eng.n_chains + sum(eng.refills.values())


@pytest.fixture(scope="module")
def clean(stream):
    """The fault-free stream through the plain engine (no guard, no chaos)."""
    return stream.run(stream.engine(), faults=False)[0]


def _stall_at(stream, options, fields) -> int:
    """The late request's chain for an arm: a dry run of the port engine
    with the stall at 0 s (the schedule before the late submit does not
    depend on it)."""
    eng = stream.engine(chaos=chaos.ChaosConfig(**{**fields, "stall_s": 0.0}), **options)
    return stream.run(eng)[2]


def check_arm(stream, clean, options, fields, monkeypatch):
    """One arm against the JAX engine (module docstring); returns the
    port engine."""
    stall_at = _stall_at(stream, options, fields)
    fields = {**fields, "stall_chain": stall_at}
    jeng = JaxServeEngine(stream.m.jmodel(), stream.m.qtree, n_slots=2, tokens_per_launch=4,
                          chaos=jchaos.ChaosConfig(**fields), **options)
    want, want_late, _ = stream.run(jeng, make=JaxRequest, stall_at=stall_at)
    eng = stream.engine(chaos=chaos.ChaosConfig(**fields), **options)
    spy = _SyncSpy(monkeypatch)
    got, got_late, _ = stream.run(eng, stall_at=stall_at)
    monkeypatch.undo()
    assert got == want
    assert got_late == want_late
    assert eng.fault_stats() == jeng.fault_stats()
    assert (eng.n_chains, eng.n_prefills, eng.n_splices, eng.n_chunks) == (
        jeng.n_chains, jeng.n_prefills, jeng.n_splices, jeng.n_chunks)
    assert eng.n_host_syncs == _budget(eng) == spy.n
    # what each fault did, against the fault-free stream
    guard = options.get("guard_nonfinite", False)
    reasons = [r for _, r in got]
    assert reasons[FAILED] == "error" and got[FAILED][0] == []
    assert got[CANCEL_QUEUED] == ([], "cancelled")
    assert got[EXPIRED_QUEUED] == ([], "deadline")
    assert reasons[CANCEL_ACTIVE] == "cancelled" and 0 < len(got[CANCEL_ACTIVE][0])
    assert got_late[1] == "deadline" and 0 < len(got_late[0]) < 12
    stats = eng.fault_stats()
    chunked = bool(options.get("prefill_chunk"))
    assert stats["prefill_errors"] == 1 and stats["cancelled"] == 2 + chunked
    assert stats["deadline_expired"] == 2
    assert stats["nonfinite_quarantined"] == int(guard)
    if guard:
        assert reasons[POISONED] == "nonfinite"
    if chunked:
        assert eng.n_chunks > 0 and reasons.count("cancelled") == 3
    for i, (toks, reason) in enumerate(got):
        ref = clean[i][0]
        if reason in ("length", "eos"):
            assert toks == ref, i
        else:
            assert toks == ref[:len(toks)] and len(toks) < len(ref), i
    late_ref = generate(stream.m.model(), None, [stream.late], 12, device="cpu")[0]
    assert got_late[0] == late_ref[len(stream.late):len(stream.late) + len(got_late[0])].tolist()
    return eng


@pytest.mark.parametrize("arm", list(ARMS))
def test_fault_stream_matches_jax_engine(stream, clean, arm, monkeypatch):
    check_arm(stream, clean, *ARMS[arm], monkeypatch)


def test_guard_without_faults_is_the_guard_off_stream(stream, clean, monkeypatch):
    """The guard on and no fault: the clean stream's tokens and host syncs
    (a spy on ``Tensor.cpu``); its block carries one more plane, the
    guard-off block is the (n_slots, tokens_per_launch) token block."""
    blocks = {}
    for guard in (False, True):
        eng = stream.engine(guard_nonfinite=guard)
        real = eng._chain

        def chain(real=real, guard=guard):
            block = real()
            blocks.setdefault(guard, block)
            return block

        eng._chain = chain
        spy = _SyncSpy(monkeypatch)
        got = stream.run(eng, faults=False)[0]
        monkeypatch.undo()
        assert got == clean
        assert spy.n == eng.n_host_syncs == _budget(eng)
        assert eng.fault_stats()["nonfinite_quarantined"] == 0
    assert blocks[False].shape == (2, 4) and blocks[True].shape == (2, 2, 4)
    assert blocks[True].dtype == torch.int64 and bool((blocks[True][1] == 1).all())


def test_admission_cancel_and_close(stream):
    """Admission: a deadline <= 0, a priority class the FIFO lacks and a
    non-positive ``default_deadline_s`` raise; ``cancel`` knows queued,
    pending and active ids only; ``drain`` closes (``QueueClosed``) and runs
    every accepted request to its end."""
    eng = stream.engine(default_deadline_s=300.0)
    for bad in (dict(deadline_s=0.0), dict(deadline_s=-1.0), dict(priority=1)):
        with pytest.raises(ValueError):
            eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4, **bad))
    with pytest.raises(ValueError):
        stream.engine(default_deadline_s=0.0)
    rids = [eng.submit(Request(prompt=p, max_new_tokens=4)) for p in stream.prompts[:3]]
    assert eng.scheduler.has(rids[2]) and not eng.scheduler.has(99)
    assert eng.cancel(99) is False
    done = eng.drain()
    assert eng.closed and eng.idle
    assert sorted(c.request_id for c in done) == rids
    assert all(c.finish_reason == "length" and len(c.tokens) == 4 for c in done)
    assert eng.cancel(rids[0]) is False  # finished
    with pytest.raises(QueueClosed):
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
    assert eng.fault_stats() == {
        "deadline_s": 300.0, "guard_nonfinite": 0, "chaos": 0, "deadline_expired": 0,
        "cancelled": 0, "nonfinite_quarantined": 0, "prefill_errors": 0}
    assert eng.stats("fault", "flight") == {**eng.fault_stats(), "flight": 0}
    # tensor-parallel serving's part (the replicated engine's), the roles',
    # the SLO tiers' and the contract sentry's off values; an unknown part
    # raises
    assert eng.stats("tp") == {"tp": 1}
    assert eng.stats("role", "slo") == {"role": 0, "priority_classes": 0}
    assert eng.stats("sentry") == {"sentry": 0}
    with pytest.raises(ValueError):
        eng.stats("no_such_part")


def test_poison_is_decided_on_the_host(stream, monkeypatch):
    """The chaos NaN at a host step index makes no tensor from host data:
    ``poison_logits`` fills the victim row only at its step (a spy on
    ``torch.as_tensor`` and ``torch.tensor``); a device step index still
    selects, equal to the host decision."""
    made = []
    for name in ("as_tensor", "tensor"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, real=real, **k: (made.append(a), real(*a, **k))[1])
    logits = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    same = chaos.poison_logits(logits, 4, 1, 5)
    hit = chaos.poison_logits(logits, 5, 1, 5)
    monkeypatch.undo()
    assert made == [] and same is logits
    assert torch.isnan(hit[1]).all() and torch.equal(hit[[0, 2]], logits[[0, 2]])
    dev = chaos.poison_logits(logits, torch.tensor(5), 1, 5)
    assert torch.equal(dev.isnan(), hit.isnan())
    assert torch.equal(chaos.poison_logits(logits, torch.tensor(4), 1, 5), logits)
