"""Self-speculative serving in the PyTorch port against the JAX package's
``ServeEngine(speculative_k=...)``.

The toy int8 LM of ``test_torch_serve_prefill.py`` (vocab 64, d_model 32,
2 layers, 4 query and 2 KV heads, window 64; weights drawn with numpy
from a seed, both packages fed the same values through
``models/convert.py:from_jax_params``) serves one stream — three templated
prompts (the prompt-lookup workload: a 5-token template tiled 3 times,
a distinct last token), two random ones, budgets that end inside verify
blocks and chains, one request stopped by an EOS token — through both
engines at each option set of ``ARMS``: whole-slot, int8 KV with the
prefix cache and chunked prefill (splices, chunks and chunked splices
all seed the draft history), paged gather with the prefix cache, and the
paged kernel (its plain version on the CPU; the JAX package's Pallas
kernel in interpret mode) with chunks. The prompts fall in two buckets
(8 and 16), which keeps the JAX engines' compiles few.

Exact, per arm: the tokens and finish reasons of every request, the
``spec_stats()`` dicts (verify forwards, steps consumed, drafts accepted
and the two ratios), the chain and refill counters; the port's tokens
equal its engine's with the same options but speculation off; the host syncs are chains + whole
prefills + splices + final chunks, also counted by a spy on
``Tensor.cpu``. Then, port only: sampled streams reproducible per seed
whatever shares the batch, the speculation-off state unchanged, the
checks on the new options, and ``chip_smoke.py``'s host replay of
``spec_stats()`` (its gate on the card) against the engine's counters.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import generate
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
from helpers import requires_pallas_interpret
from test_torch_serve_prefill import Int8

pytestmark = requires_pallas_interpret

REPO = Path(__file__).resolve().parents[1]
TEMPLATE = [7, 8, 9, 10, 11]
PREFIX_BYTES = 1 << 22
GEOM = dict(paged=True, page_size=8, pool_pages=24)
ARMS = {
    "whole": dict(speculative_k=3),
    "int8-kv-prefix-chunk": dict(speculative_k=2, kv_bits=8, prefix_cache_bytes=PREFIX_BYTES,
                                 prefill_chunk=8),
    "paged-prefix": dict(speculative_k=3, prefix_cache_bytes=PREFIX_BYTES, **GEOM),
    "paged-kernel-chunk": dict(speculative_k=2, paged_kernel=True, prefill_chunk=8, **GEOM),
}
# the request whose EOS token stops it early, and the position in its
# greedy output of the token chosen as EOS
EOS_REQUEST, EOS_AT = 3, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Stream:
    """The toy int8 LM and the stream: (prompt, budget, eos) triples."""

    def __init__(self):
        self.m = Int8()
        rng = np.random.Generator(np.random.PCG64(13))
        reqs = [(TEMPLATE * 3 + [20 + i], 10 + 3 * i) for i in range(3)]
        reqs += [(rng.integers(0, 64, p).tolist(), n) for p, n in ((5, 12), (11, 9))]
        prompt, n = reqs[EOS_REQUEST]
        ref = generate(self.m.model(), None, [prompt], n, device="cpu")[0, len(prompt):]
        eos = int(ref[EOS_AT])
        self.eos_stop = ref.tolist().index(eos) + 1  # the stop token's first emission
        self.reqs = [(p, n, eos if i == EOS_REQUEST else None) for i, (p, n) in enumerate(reqs)]

    def run(self, engine, make=Request):
        ids = [engine.submit(make(prompt=p, max_new_tokens=n, eos_token=e))
               for p, n, e in self.reqs]
        done = {}
        while not engine.idle:
            for c in engine.step():
                done[c.request_id] = (c.tokens, c.finish_reason)
        return [done[i] for i in ids]

    def engine(self, **kw):
        return ServeEngine(self.m.model(), self.m.params, n_slots=2, tokens_per_launch=8,
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
    r = eng.refills
    return eng.n_chains + r["prefill"] + r["splice"] + r["chunked"] + r["chunked_splice"]


@pytest.mark.parametrize("arm", list(ARMS))
def test_spec_stream_matches_jax_engine(stream, arm, monkeypatch):
    kw = ARMS[arm]
    jeng = JaxServeEngine(stream.m.jmodel(), stream.m.qtree, n_slots=2, tokens_per_launch=8,
                          **kw)
    want = stream.run(jeng, make=JaxRequest)
    eng = stream.engine(**kw)
    spy = _SyncSpy(monkeypatch)
    got = stream.run(eng)
    monkeypatch.undo()
    assert got == want
    # the same options with speculation off (int8 KV: a chunked prompt's
    # codes differ from a whole prefill's, so the same chunking on both)
    assert got == stream.run(stream.engine(**{k: v for k, v in kw.items()
                                              if k != "speculative_k"}))
    assert got[EOS_REQUEST][1] == "eos" and len(got[EOS_REQUEST][0]) == stream.eos_stop
    assert {r for _, r in got} == {"eos", "length"}
    stats = eng.spec_stats()
    assert stats == jeng.spec_stats()
    assert stats["spec_drafts_accepted"] > 0
    assert stats["n_verify_forwards"] == eng.n_chains * eng.tokens_per_launch
    assert (eng.n_chains, eng.n_prefills, eng.n_splices, eng.n_chunks) == (
        jeng.n_chains, jeng.n_prefills, jeng.n_splices, jeng.n_chunks)
    if "prefix_cache_bytes" in kw:
        assert eng.n_splices >= 1
    if "prefill_chunk" in kw:
        assert eng.n_chunks >= 1
    assert eng.n_host_syncs == spy.n == _budget(eng)
    if eng._paged:
        while eng.prefix is not None and eng.prefix.evict_coldest():
            pass
        assert eng.page_stats()["pages_in_use"] == 0


def test_spec_sampled_reproducible_per_seed(stream):
    """temperature > 0: a request's tokens depend on its own seed only,
    whether it runs alone or beside another request."""
    prompt = TEMPLATE * 3
    kw = dict(temperature=1.0, speculative_k=2)
    solo = stream.engine(**kw)
    rid = solo.submit(Request(prompt=prompt, max_new_tokens=10, seed=7))
    alone = {c.request_id: c.tokens for c in solo.run_until_idle()}[rid]
    busy = stream.engine(**kw)
    busy.submit(Request(prompt=stream.reqs[4][0], max_new_tokens=14, seed=3))
    rid = busy.submit(Request(prompt=prompt, max_new_tokens=10, seed=7))
    beside = {c.request_id: c.tokens for c in busy.run_until_idle()}[rid]
    assert alone == beside and all(0 <= t < 64 for t in alone)
    other = stream.engine(**kw)
    rid = other.submit(Request(prompt=prompt, max_new_tokens=10, seed=8))
    assert {c.request_id: c.tokens for c in other.run_until_idle()}[rid] != alone


def test_spec_off_state_unchanged_and_options_checked(stream):
    """speculative_k 0 keeps the state without a history and reports
    itself off; on, the history is (slots, window + 1) with a trash
    column; the JAX package's checks and messages."""
    off = stream.engine()
    assert off._state.hist is None and off._state.hist_len is None
    assert off.spec_stats() == {"speculative": 0}
    on = stream.engine(speculative_k=2)
    assert on._state.hist.shape == (2, 65) and on._state.hist_len.shape == (2,)
    m, params = stream.m.model(), stream.m.params
    for kw, msg in ((dict(speculative_k=-1), "speculative_k must be >= 0"),
                    (dict(speculative_k=2, spec_ngram=0), "spec_ngram must be >= 1"),
                    (dict(speculative_k=64), "speculative_k \\+ 1 must fit the window")):
        with pytest.raises(ValueError, match=msg):
            ServeEngine(m, params, device="cpu", **kw)


def test_history_seeded_at_refill(stream):
    """A refilled slot's history is its prompt and first token, whatever
    the slot held before (here a longer earlier request's tokens)."""
    eng = stream.engine(speculative_k=2, prefix_cache_bytes=PREFIX_BYTES)
    long_p, short_p = TEMPLATE * 4 + [9], stream.reqs[0][0]
    for p in (long_p, short_p):  # the second one splices from the first
        eng.submit(Request(prompt=p, max_new_tokens=3))
        eng._refill(0, eng._pop_request())
        first = eng._slots[0].tokens[0]
        assert eng._state.hist_len.tolist()[0] == len(p) + 1
        assert eng._state.hist[0, :len(p) + 1].tolist() == p + [first]
        eng.run_until_idle()
    assert eng.n_splices == 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", [1, 3])
def test_chip_replay_equals_engine_spec_stats(stream, k):
    """``chip_smoke.py``'s gate on the card: replaying each request's
    drafts on the host from its greedy tokens (extended by k past the
    budget through ``generate``) gives the greedy engine's
    ``spec_steps_consumed`` and ``spec_drafts_accepted`` exactly."""
    cs = _chip_smoke()
    model = stream.m.model()
    reqs = [(p, n) for p, n, _ in stream.reqs]
    eng = stream.engine(speculative_k=k)
    ids = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in reqs]
    eng.run_until_idle()
    steps = accepted = 0
    for (p, n), _ in zip(reqs, ids):
        ext = generate(model, None, [p], n + k, device="cpu")[0, len(p):].tolist()
        s, lo, hi = cs.replay_spec(p, ext, n, k, 3)
        assert lo == hi
        steps, accepted = steps + s, accepted + lo
    stats = eng.spec_stats()
    assert (stats["spec_steps_consumed"], stats["spec_drafts_accepted"]) == (steps, accepted)
    assert accepted > 0


@pytest.mark.parametrize("k", [1, 3])
def test_chip_paged_spec_gates_hold_on_the_stream_own_tokens(stream, k):
    """``chip_smoke.py``'s gates on the paged speculative arm (paged
    kernel, depth 2): replayed over the stream's own tokens (nothing past
    the budget), the drafts give ``spec_steps_consumed`` exactly and bound
    ``spec_drafts_accepted``; each request's tokens are the argmax of the
    engine's verify-shaped teacher-forced logits on them wherever the
    top-2 gap is clear (``greedy_held``), and a clear step's token
    swapped for another fails it."""
    cs = _chip_smoke()
    reqs = [(p, n) for p, n, _ in stream.reqs]
    eng = stream.engine(speculative_k=k, paged_kernel=True, pipeline_depth=2, **GEOM)
    ids = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in reqs]
    done = {c.request_id: c.tokens for c in eng.run_until_idle()}
    toks = [done[i] for i in ids]
    replay = [cs.replay_spec(p, t, n, k, 3) for (p, n), t in zip(reqs, toks)]
    stats = eng.spec_stats()
    assert stats["spec_steps_consumed"] == sum(r[0] for r in replay)
    assert (sum(r[1] for r in replay) <= stats["spec_drafts_accepted"]
            <= sum(r[2] for r in replay))
    for (p, _), t in zip(reqs, toks):
        logits = eng.teacher_forced_logits(p, t, rows=k + 1)
        rec = cs.greedy_held(logits, t)
        assert rec["ok"] and rec["clear_steps"] > 0
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > cs.TF_LOGIT_BOUND * logits.abs().max()
        j = int(clear.nonzero()[0])
        wrong = t[:j] + [(t[j] + 1) % 64] + t[j + 1:]
        assert cs.greedy_held(logits, wrong)["first_clear_disagreement"] == j
