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
- Stale NaN in recycled pages: NaN planted in a page's V rows past a
  request's depth reaches that request's output in both packages' paged
  attention — the JAX kernel and the port's plain version — because the
  masked positions' weights are 0 and ``0 * NaN`` is NaN. The same inputs
  with the NaN rows zeroed give finite outputs, equal in both packages
  (f32 2e-5 + 1e-5 relative, as ``test_torch_paged_attention.py``). The
  repair (a select on the weight before the accumulate, or a loop bounded
  by the depth) is left to a later change of both.
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
from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as tpa
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


@pytest.mark.parametrize("row", [0, 2])
def test_stale_nan_past_the_depth_reaches_the_output_in_both(row):
    q, k, v, table, pos, kw = _setup(0, 4, 1, 4, 4, 16, 8, 4, 24)
    page_size = k.shape[1]
    last = int(pos[row]) // page_size
    first_dead = int(pos[row]) % page_size + 1
    assert first_dead < page_size  # there are dead positions to plant in
    v[table[row, last], first_dead:] = np.nan
    (jx, jkw), (tx, tkw) = _both((q, k, v, table, pos), kw)
    got = _np32(tpa.paged_attention(*tx, **tkw))
    want = _np32(j_paged_attention(*jx, **jkw))
    assert np.isnan(got[row]).all() and np.isnan(want[row]).all()
    others = [i for i in range(4) if i != row]
    np.testing.assert_allclose(got[others], want[others], atol=2e-5, rtol=1e-5)
    assert np.isfinite(got[others]).all()
    # the same inputs with the planted rows zeroed: finite, equal
    v[table[row, last], first_dead:] = 0.0
    (jx, jkw), (tx, tkw) = _both((q, k, v, table, pos), kw)
    got = _np32(tpa.paged_attention(*tx, **tkw))
    want = _np32(j_paged_attention(*jx, **jkw))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
