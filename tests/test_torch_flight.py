"""The port's flight recorder and streaming histograms (``obs/flight.py``,
``obs/histogram.py``) against the JAX package's, and the recorder's hooks
in the port's ``ServeEngine`` and ``Trainer``.

- ``LogHistogram``: the same samples (log-normal, zeros, NaN, values past
  the cap, exact bucket edges) into both: equal counts, quantiles,
  summaries, ``to_dict``, merges and ``from_dict`` round trips; the same
  geometry refusals.
- ``FlightRecorder``: the same calls (the request lifecycle, chains with
  their overlap stamps, sweeps, faults, stalls, the trainer hooks) into
  both under one fake ``time.perf_counter``: equal snapshots, timestamps
  included, equal summaries, equal fleet merges and merged summaries; each
  package's ``load_flightlog`` reads the other's dump; the same refusals.
- The engine's hooks: the scripted fault stream of
  ``test_torch_serve_faults.py`` (guard on, a poisoned slot, a failing
  prefill, queued and active cancels, deadlines) through the JAX and the
  port engine, each with a recorder: the same event sequence (kinds and
  fields, times aside), the same ``flight_stats()`` counters; with a
  recorder the port's tokens and host syncs are the recorder-less run's
  (a spy on ``Tensor.cpu``); every span complete; the auto-dump of the
  quarantine names the slot and the chain step.
- ``Trainer(flight=)``: the JAX Trainer and the port's on the same MLP
  (``test_torch_guardrails.py``'s pair) with ``ChaosConfig(nan_batch_step=3)``
  give the same ``step_skipped`` events, and under a chaos loss spike after
  a ``save`` the same ``rollback`` event (its loss ``rtol 1e-5``).
"""

import json
import math
import time

import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.obs import flight as jflight
from pytorch_distributed_training_tutorials_tpu.obs import histogram as jhist
from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu.utils import chaos as jchaos
from pytorch_distributed_training_tutorials_tpu_torch.obs import flight as tflight
from pytorch_distributed_training_tutorials_tpu_torch.obs import histogram as thist
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request
from pytorch_distributed_training_tutorials_tpu_torch.train import sgd
from pytorch_distributed_training_tutorials_tpu_torch.utils import chaos
from helpers import requires_pallas_interpret
import test_torch_guardrails as guardrails
from test_torch_guardrails import ROLLBACK, SPIKE
from test_torch_serve_faults import FAULTS, NAN, Stream, _stall_at


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- histograms -------------------------------------------------------------

def _samples(seed: int) -> list[float]:
    rng = np.random.Generator(np.random.PCG64(seed))
    vals = list(rng.lognormal(-3.0, 2.0, 500))
    edges = [1e-4 * 2.0 ** (i / 8) for i in range(0, 60, 7)]
    return vals + edges + [0.0, float("nan"), 5e4, 1e-9]


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_matches_jax(seed):
    vals = _samples(seed)
    j, t = jhist.LogHistogram(), thist.LogHistogram()
    for v in vals:
        j.record(v)
        t.record(v)
    assert t.counts == j.counts and t.n == j.n == len(vals) - 1
    assert t.rel_error_bound == j.rel_error_bound
    for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert t.quantile(q) == j.quantile(q)
    assert t.summary(prefix="e2e_", unit="s") == j.summary(prefix="e2e_", unit="s")
    assert t.to_dict() == j.to_dict()
    assert thist.LogHistogram.from_dict(json.loads(json.dumps(t.to_dict()))).to_dict() == \
        t.to_dict()
    # a merge of two halves is recording everything into one
    jh = [jhist.LogHistogram(), jhist.LogHistogram()]
    th = [thist.LogHistogram(), thist.LogHistogram()]
    for i, v in enumerate(vals):
        jh[i % 2].record(v)
        th[i % 2].record(v)
    merged = th[0].merge(th[1])
    assert merged.to_dict() == jh[0].merge(jh[1]).to_dict()
    assert merged.counts == t.counts and merged.quantile(0.95) == t.quantile(0.95)
    assert thist.LogHistogram().quantile(0.5) == jhist.LogHistogram().quantile(0.5) == 0.0


@pytest.mark.parametrize("kw", [dict(min_value=0.0), dict(min_value=2.0, max_value=1.0),
                                dict(bins_per_octave=0)])
def test_histogram_refusals_match_jax(kw):
    for mod in (jhist, thist):
        with pytest.raises(ValueError):
            mod.LogHistogram(**kw)
    with pytest.raises(ValueError):
        thist.LogHistogram().merge(thist.LogHistogram(bins_per_octave=4))
    with pytest.raises(ValueError):
        thist.LogHistogram().quantile(1.5)


# -- the recorder ---------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _script(rec):
    """One recorder's worth of calls, the same for both packages."""
    for rid in range(4):
        rec.request_submitted(rid, p_len=5 + rid, max_new=8, adapter=rid % 2)
    rec.request_popped(0)
    rec.request_prefilled(0, 0)
    rec.request_popped(1)
    rec.request_prefilled(1, 1, kind="splice", cached_len=4)
    rec.chain_start(2, 4, chain=0)
    rec.chain_start(2, 4, chain=1)
    rec.chain_end(tokens=8, occupancy=2, chain=0)
    rec.prefill_chunk(2, 2, done=8, total=20)
    rec.chain_end(tokens=8, occupancy=2, chain=1)
    rec.fault("nonfinite", rid=1, slot=1, chain_step=2)
    rec.request_completed(1, "nonfinite", tokens=3, latency_s=0.04, ttft_s=0.01)
    rec.sweep(1)
    rec.record("stall", chain=2, stall_s=0.5)
    rec.fault("deadline", rid=3)
    rec.request_completed(3, "deadline", tokens=0, latency_s=0.6)
    rec.request_completed(0, "length", tokens=8, latency_s=0.2, ttft_s=0.02)
    rec.step_skipped(step=3)
    rec.rollback(step=7, loss=1e6)
    rec.chain_start(1, 4)
    rec.chain_end(tokens=4, occupancy=1)
    for i in range(40):  # wrap the ring
        rec.record("adapter_refresh", version=i)


@pytest.fixture()
def both(monkeypatch, tmp_path):
    clock = _Clock()
    monkeypatch.setattr("time.perf_counter", clock)
    recs = {}
    for name, mod in (("jax", jflight), ("port", tflight)):
        clock.t = 100.0
        rec = mod.FlightRecorder(capacity=32, dump_path=str(tmp_path / f"{name}.jsonl"),
                                 dump_events=16, max_done_spans=8)
        _script(rec)
        recs[name] = rec
    clock.t = 200.0
    return recs, tmp_path


def test_recorder_matches_jax(both):
    recs, _ = both
    j, t = recs["jax"], recs["port"]
    snaps = []
    for rec in (j, t):
        time.perf_counter.t = 200.0  # the snapshot's own stamp
        snaps.append(rec.snapshot())
    assert snaps[1] == snaps[0]
    assert t.summary() == j.summary()
    assert t.dropped == j.dropped > 0
    assert (t.n_faults, t.n_dumps) == (j.n_faults, j.n_dumps) == (4, 4)
    assert tflight.EVENT_KINDS == jflight.EVENT_KINDS
    assert tflight.FLIGHT_SCHEMA == jflight.FLIGHT_SCHEMA


def test_dumps_cross_load_and_merges_match_jax(both):
    recs, tmp = both
    j_snaps = jflight.load_flightlog(str(tmp / "jax.jsonl"))
    t_snaps = tflight.load_flightlog(str(tmp / "port.jsonl"))
    assert t_snaps == j_snaps and len(t_snaps) == 4
    assert tflight.load_flightlog(str(tmp / "jax.jsonl")) == jflight.load_flightlog(
        str(tmp / "port.jsonl"))
    assert [s["trigger"]["kind"] for s in t_snaps] == ["fault", "fault", "step_skipped",
                                                      "rollback"]
    time.perf_counter.t = 200.0
    tagged = [(0, recs["port"].snapshot()), ("router", recs["jax"].snapshot())]
    merged = tflight.merge_snapshots(tagged)
    assert merged == jflight.merge_snapshots(tagged)
    tflight.validate_flightlog(merged)
    assert tflight.summarize_merged([s for _, s in tagged]) == jflight.summarize_merged(
        [s for _, s in tagged])


def test_recorder_refusals_match_jax():
    for mod in (jflight, tflight):
        with pytest.raises(ValueError):
            mod.FlightRecorder(capacity=0)
        with pytest.raises(ValueError):
            mod.FlightRecorder().record("no_such_kind")
        for bad in ({}, {"schema": "other"}, {"schema": mod.FLIGHT_SCHEMA}):
            with pytest.raises(ValueError):
                mod.validate_flightlog(bad)


# -- the engine's hooks ---------------------------------------------------

def _untimed(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


@requires_pallas_interpret
def test_engine_events_match_jax_and_cost_no_sync(monkeypatch, tmp_path):
    stream = Stream()
    options = dict(guard_nonfinite=True)
    fields = {**NAN, **FAULTS}
    stall_at = _stall_at(stream, options, fields)
    fields["stall_chain"] = stall_at
    recs = {}
    jrec = jflight.FlightRecorder(capacity=4096)
    jeng = JaxServeEngine(stream.m.jmodel(), stream.m.qtree, n_slots=2, tokens_per_launch=4,
                          chaos=jchaos.ChaosConfig(**fields), flight=jrec, **options)
    want = stream.run(jeng, make=JaxRequest, stall_at=stall_at)[:2]
    syncs = {}
    for name, rec in (("off", None), ("on", tflight.FlightRecorder(
            capacity=4096, dump_path=str(tmp_path / "faults.jsonl")))):
        eng = stream.engine(chaos=chaos.ChaosConfig(**fields), flight=rec, **options)
        n = {"cpu": 0}
        real = torch.Tensor.cpu
        monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, real=real, **k: (
            n.__setitem__("cpu", n["cpu"] + 1), real(t, *a, **k))[1])
        recs[name] = (stream.run(eng, stall_at=stall_at)[:2], eng)
        monkeypatch.undo()
        syncs[name] = (n["cpu"], eng.n_host_syncs)
    (got, eng), trec = recs["on"], recs["on"][1]._flight
    assert got == want == recs["off"][0]
    assert syncs["on"] == syncs["off"]
    assert recs["off"][1].flight_stats() == {"flight": 0}
    assert _untimed(trec.events) == _untimed(jrec.events)
    assert trec.kind_counts == jrec.kind_counts
    for key in ("flight_events", "flight_faults", "flight_spans_live", "flight_spans_done",
                "ttft_count", "e2e_count", "queue_wait_count", "chain_util_count"):
        assert eng.flight_stats()[key] == jeng.flight_stats()[key], key
    # every request's span is complete, and the counts reconcile
    outcomes = got[0] + [got[1]]
    kc = trec.kind_counts
    assert kc["submit"] == len(outcomes) == kc["complete"] == len(trec.done_spans)
    assert kc["prefill"] + kc["splice"] == eng.n_prefills + eng.n_splices
    assert kc["chain_start"] == kc["chain_end"] == eng.n_chains
    assert kc["fault"] == sum(eng.fault_stats()[k] for k in (
        "deadline_expired", "nonfinite_quarantined", "prefill_errors"))
    reasons = sorted(s["finish_reason"] for s in trec.done_spans)
    assert reasons == sorted(r for _, r in outcomes)
    assert all("submit_t" in s and "complete_t" in s for s in trec.done_spans)
    assert all("prefill_t" in s for s in trec.done_spans if s["tokens"])
    # the quarantine's auto-dump names the slot and the chain step
    snaps = tflight.load_flightlog(str(tmp_path / "faults.jsonl"))
    (nf,) = [s for s in snaps if s["trigger"].get("fault_kind") == "nonfinite"]
    assert nf["trigger"]["slot"] == NAN["nan_logit_slot"] and "chain_step" in nf["trigger"]
    assert any(s.get("slot") == NAN["nan_logit_slot"] for s in nf["live_spans"])
    assert len(snaps) == trec.n_faults == kc["fault"]


def test_engine_histograms_within_one_bucket_of_the_sort():
    stream = Stream()
    rec = tflight.FlightRecorder(capacity=256)
    eng = stream.engine(flight=rec)
    ids = [eng.submit(Request(prompt=p, max_new_tokens=6)) for p in stream.prompts]
    done = {c.request_id: c for c in eng.run_until_idle()}
    assert sorted(done) == ids
    for name, vals in (("e2e", [c.latency_s for c in done.values()]),
                       ("ttft", [c.ttft_s for c in done.values()])):
        h = rec.hist[name]
        for q in (0.5, 0.95):
            sv = sorted(vals)[max(1, math.ceil(q * len(vals))) - 1]
            assert abs(h.quantile(q) - sv) <= h.rel_error_bound * max(sv, h.min_value) + 1e-9


# -- the trainer's hooks --------------------------------------------------

def _events(rec, kind):
    return [{k: v for k, v in e.items() if k != "t"} for e in rec.events if e["kind"] == kind]


def _pair(monkeypatch, recs, **kw):
    """``test_torch_guardrails.py``'s Trainer pair, each built with its own
    recorder (``Trainer(flight=)`` in both packages)."""
    made = iter(recs)
    for cls in (guardrails.JaxTrainer, guardrails.Trainer):
        real = cls.__init__

        def init(self, *a, real=real, **k):
            real(self, *a, flight=next(made), **k)

        monkeypatch.setattr(cls, "__init__", init)
    jt, tt = guardrails._mlp_pair(optax.sgd(0.05), sgd(0.05), **kw)
    monkeypatch.undo()
    assert jt._flight is recs[0] and tt._flight is recs[1] and tt.metrics.flight is recs[1]
    return jt, tt


def test_trainer_step_skipped_events_match_jax(monkeypatch):
    recs = (jflight.FlightRecorder(capacity=64), tflight.FlightRecorder(capacity=64))
    jt, tt = _pair(monkeypatch, recs, skip_nonfinite=True,
                   chaos=chaos.ChaosConfig(nan_batch_step=3))
    jt.train(2)
    tt.train(2)
    assert tt.steps_skipped == jt.steps_skipped == 1
    assert _events(recs[1], "step_skipped") == _events(recs[0], "step_skipped") == [
        {"kind": "step_skipped", "step": 3}]
    assert recs[1].n_faults == recs[0].n_faults == 1


def test_trainer_rollback_event_matches_jax(monkeypatch, tmp_path):
    recs = (jflight.FlightRecorder(capacity=64), tflight.FlightRecorder(capacity=64))
    jt, tt = _pair(monkeypatch, recs, chaos=chaos.ChaosConfig(**SPIKE), **ROLLBACK)
    for t, ck in ((jt, tmp_path / "jax"), (tt, tmp_path / "port")):
        t.train(1)
        t.save(ck)
        t.train(3)
    (je,), (te,) = _events(recs[0], "rollback"), _events(recs[1], "rollback")
    assert te["step"] == je["step"]
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-5)
    assert tt.rollbacks == jt.rollbacks == 1
