"""Serving's failure handling on paged engines, in the PyTorch port against
the JAX package's ``ServeEngine``, and two findings about the reference's
paged path.

- The scripted fault stream of ``test_torch_serve_faults.py`` (a poisoned
  slot, a failing prefill, queued and active cancels, a queued and a
  stalled deadline) through the paged kernel (its plain version here; the
  JAX package's Pallas kernel in interpret mode) with the prefix cache and
  the guard: tokens, finish reasons, ``fault_stats()``, counters and host
  syncs exact, and no page left once the index lets its segments go.
- The quarantined slot's junk token. A NaN logits row has no position
  equal to its maximum, so the JAX ``greedy_token`` returns ``V`` — out of
  range — and its embedding lookup fills NaN: for the rest of the chain
  (one more at depth 2) the quarantined slot writes NaN K/V into its pages,
  which the pool recycles. With the prefix cache, speculation and depth 2
  the next spliced request's fresh pages are those pages, and the kernel
  accumulates ``0 * NaN`` from the masked positions: the JAX engine
  completes those neighbours ``"nonfinite"`` with the out-of-range token
  ``V`` as their first token (two of the eight and the late request on
  this script). The port's ``greedy_token`` gives ``V - 1`` for such a
  row, so its quarantined slot writes finite K/V and the neighbours equal
  the fault-free stream (``ROADMAP.md`` section C).
- Stale NaN in recycled pages: NaN planted past a request's depth (in a
  page's V rows, or a quantized pool's V scales) still reaches the JAX
  kernel's output, because the masked positions' weights are 0 and ``0 *
  NaN`` is NaN; the port leaves those positions' V out of the sum in its
  kernels and in every plain statement (the plain version, its split
  statement, the gather oracle and the model's gather path), so its output
  is finite and equal, bitwise, to the run with those rows zeroed, which
  both packages agree on (f32 2e-5 + 1e-5 relative, as
  ``test_torch_paged_attention.py``).
- A whole-slot cache hands no previous holder's NaN to the next request:
  every refill kind (whole prefill, splice, chunked prefill) writes the
  slot's whole window, zeros past the new request's bucket.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.ops.paged_attention import (
    paged_attention as j_paged_attention,
)
from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu.utils import chaos as jchaos
from pytorch_distributed_training_tutorials_tpu_torch.models import transformer as tt
from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as tpa
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request
from pytorch_distributed_training_tutorials_tpu_torch.utils import chaos
from helpers import requires_pallas_interpret
from test_torch_paged_attention import _both, _np32, _setup
from test_torch_serve_faults import (
    FAULTS,
    NAN,
    PREFIX_BYTES,
    Stream,
    _stall_at,
    check_arm,
)

pytestmark = requires_pallas_interpret

GEOM = dict(paged=True, page_size=8, pool_pages=24)
PAGED = dict(guard_nonfinite=True, paged_kernel=True, prefix_cache_bytes=PREFIX_BYTES, **GEOM)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    return Stream()


@pytest.fixture(scope="module")
def clean(stream):
    return stream.run(stream.engine(), faults=False)[0]


def test_paged_fault_stream_matches_jax_engine(stream, clean, monkeypatch):
    eng = check_arm(stream, clean, PAGED, {**NAN, **FAULTS}, monkeypatch)
    stats = eng.page_stats()
    assert eng.n_splices > 0 and stats["pages_high_water"] <= GEOM["pool_pages"]
    while eng.prefix.evict_coldest():
        pass
    assert eng.page_stats()["pages_in_use"] == 0


def test_quarantined_slot_junk_token_poisons_recycled_pages_in_jax_only(stream, clean):
    options = dict(PAGED, speculative_k=2, pipeline_depth=2)
    fields = {**NAN, **FAULTS}
    stall_at = _stall_at(stream, options, fields)
    fields["stall_chain"] = stall_at
    jeng = JaxServeEngine(stream.m.jmodel(), stream.m.qtree, n_slots=2, tokens_per_launch=4,
                          chaos=jchaos.ChaosConfig(**fields), **options)
    want, want_late, _ = stream.run(jeng, make=JaxRequest, stall_at=stall_at)
    eng = stream.engine(chaos=chaos.ChaosConfig(**fields), **options)
    got, got_late, _ = stream.run(eng, stall_at=stall_at)
    vocab = stream.m.cfg.vocab_size
    # the JAX neighbours whose first token is the out-of-range V
    spread = [i for i, (toks, _) in enumerate(want) if toks[:1] == [vocab]]
    assert spread and all(want[i][1] == "nonfinite" for i in spread)
    assert want_late[0][:1] == [vocab]
    assert jeng.fault_stats()["nonfinite_quarantined"] == 1 + len(spread)
    # the port: one quarantine, the neighbours equal the fault-free stream
    assert eng.fault_stats()["nonfinite_quarantined"] == 1
    assert all(got[i] == clean[i] for i in spread)
    assert got_late[1] == "deadline" and vocab not in got_late[0]
    assert [g for i, g in enumerate(got) if i not in spread] == [
        w for i, w in enumerate(want) if i not in spread]


def _port_paths(q, k, v, table, pos, kw) -> dict:
    """The port's paged attention over CPU operands along every plain
    statement: the wrapper (the plain version), the sm90 kernel's split
    statement (a page a split), the gather oracle, and the model's gather
    decode (pages gathered through the table, decoded, grouped masked
    attention in float32; a zero sink page behind the pools for the
    sentinel entries)."""
    quant = kw.get("quant")
    out = {
        "plain": tpa.paged_attention(q, k, v, table, pos, **kw),
        "split": tpa.paged_attention_plain(q, k, v, table, pos, **kw, pages_per_split=1),
        "reference": tpa.paged_attention_reference(q, k, v, table, pos, **kw),
    }

    def gathered(pool, scale):
        sink = lambda t: torch.cat([t, torch.zeros_like(t[:1])])  # noqa: E731
        return tt._decode_kv(tt._gather_pages(sink(pool), table),
                             tt._gather_pages(sink(scale), table) if quant else None,
                             quant, q.dtype)

    kr, vr = gathered(k, kw.get("k_scale")), gathered(v, kw.get("v_scale"))
    valid = tt._validity(pos.to(torch.int64), q.shape[1], kr.shape[1])
    out["gather"] = tt.grouped_masked_attention(q, kr, vr, valid[:, None], torch.float32)
    return out


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("row", [0, 2])
def test_stale_nan_past_the_depth_stays_out_of_the_port(row, quant):
    q, k, v, table, pos, kw = _setup(0, 4, 1, 4, 4, 16, 8, 4, 24, quant)
    v, kw = np.array(v), {n: a if isinstance(a, str) else np.array(a) for n, a in kw.items()}
    page_size = k.shape[1]
    last = int(pos[row]) // page_size
    first_dead = int(pos[row]) % page_size + 1
    assert first_dead < page_size  # there are dead positions to plant in

    def plant(value):
        # the V rows of an exact pool; the V scales of a quantized one
        (kw["v_scale"] if quant else v)[table[row, last], first_dead:] = value
        return _both((q, k, v, table, pos), kw)

    (jx, jkw), (tx, tkw) = plant(np.nan)
    want_nan = _np32(j_paged_attention(*jx, **jkw))
    got_nan = _port_paths(*tx, tkw)
    (jx, jkw), (tx, tkw) = plant(0.0)
    want = _np32(j_paged_attention(*jx, **jkw))
    got = _port_paths(*tx, tkw)
    # the reference still accumulates 0 * NaN; its other rows are untouched
    others = [i for i in range(4) if i != row]
    assert np.isnan(want_nan[row]).all()
    np.testing.assert_array_equal(want_nan[others], want[others])
    assert np.isfinite(want).all()
    for path, out in got_nan.items():
        assert torch.isfinite(out).all(), path
        assert torch.equal(out, got[path]), path
        np.testing.assert_allclose(_np32(out), want, atol=2e-5, rtol=1e-5, err_msg=path)


@pytest.mark.parametrize("kind, options", [
    ("prefill", {}),
    ("splice", dict(prefix_cache_bytes=PREFIX_BYTES)),
    ("chunked", dict(prefill_chunk=8)),
])
def test_whole_slot_refill_wipes_a_previous_holders_nan(stream, kind, options):
    """NaN in every position of every slot of a whole-slot cache (what a
    non-finite holder could leave) is gone from the slot a new request
    takes, whatever the refill kind: every position of its window is
    finite once the request has run, and its tokens equal a fresh
    engine's."""
    first, second = stream.prompts[5], stream.prompts[1]  # 16 tokens; 12 sharing a head

    def run(plant: bool):
        eng = stream.engine(**options)
        eng.submit(Request(prompt=first, max_new_tokens=4))
        eng.run_until_idle()
        cache = eng._state.cache
        if plant:
            for x in (cache.k, cache.v, cache.k_scale, cache.v_scale):
                if x is not None:
                    x.fill_(float("nan"))
        before = dict(eng.refills)
        rid = eng.submit(Request(prompt=second, max_new_tokens=6))
        slot = None
        while not eng.idle:
            done = eng.step()
            slot = slot if slot is not None else next(
                (i for i, a in enumerate(eng._slots) if a is not None), None)
            if done:
                (c,) = done
                assert c.request_id == rid
                tokens = c.tokens
        assert eng.refills[kind] > before[kind], (kind, eng.refills)
        return tokens, cache, slot

    want, _, _ = run(plant=False)
    got, cache, slot = run(plant=True)
    assert got == want
    window = cache.window  # row W is the sink: written, never read
    for x in (cache.k, cache.v):
        assert torch.isfinite(x[:, slot, :window]).all()
