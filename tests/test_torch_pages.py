"""The PyTorch port's page pool and fit-aware scheduler pop against the JAX
package's.

The port keeps its own copy of ``serve/pages.py`` (it imports nothing of
the JAX package); this holds the copy to the original: the same stats
after one scripted alloc / retain / release / shed sequence, lowest-id-
first reuse, and the same errors. ``FifoScheduler.pop(fits=...)`` pops
the first request in arrival order that fits and leaves the others queued
in place, as the JAX scheduler does.
"""

import pytest

from pytorch_distributed_training_tutorials_tpu.serve import pages as jpages
from pytorch_distributed_training_tutorials_tpu.serve import scheduler as jsched
from pytorch_distributed_training_tutorials_tpu_torch.serve import (
    FifoScheduler,
    PagePool,
    PoolExhausted,
    Request,
)


def _script(pool_cls, exhausted):
    """One scripted life of a 6-page pool; returns (stats after each
    step, the page ids handed out)."""
    pool = pool_cls(6, 8)
    trace, handed = [], []
    a = pool.alloc(pool.pages_needed(20))  # 3 pages
    b = pool.alloc(2)
    handed += [a, b]
    trace.append(pool.stats())
    pool.retain(a[0])
    pool.retain(a[1])
    trace.append(pool.stats())
    pool.release_all(a)  # a[0], a[1] keep one holder; a[2] frees
    trace.append(pool.stats())
    c = pool.alloc(2)  # lowest first: a[2], then the next never-used id
    handed.append(c)
    with pytest.raises(exhausted):
        pool.alloc(2)
    pool.shed()
    trace.append(pool.stats())
    pool.release_all([a[0], a[1]] + b + c)
    trace.append(pool.stats())
    return trace, handed, pool


def test_stats_equal_jax_pool_over_a_scripted_sequence():
    want, want_ids, jpool = _script(jpages.PagePool, jpages.PoolExhausted)
    got, got_ids, pool = _script(PagePool, PoolExhausted)
    assert got == want
    assert got_ids == want_ids == [[0, 1, 2], [3, 4], [2, 5]]
    assert got[-1]["in_use"] == 0 and got[-1]["high_water"] == 6
    assert (pool.available, pool.in_use) == (jpool.available, jpool.in_use) == (6, 0)
    assert [pool.refcount(i) for i in range(6)] == [0] * 6


def test_lowest_id_first_reuse_and_errors():
    pool = PagePool(4, 16)
    assert pool.pages_needed(0) == 0 and pool.pages_needed(16) == 1
    assert pool.pages_needed(17) == 2
    ids = pool.alloc(4)
    pool.release(ids[2])
    pool.release(ids[0])
    assert pool.alloc(1) == [0]  # the lowest free id, not the last freed
    with pytest.raises(ValueError):
        pool.retain(2)  # free page
    with pytest.raises(ValueError):
        pool.release(2)
    with pytest.raises(ValueError):
        pool.alloc(-1)
    with pytest.raises(ValueError):
        pool.pages_needed(-1)
    for bad in ((0, 8), (4, 0)):
        with pytest.raises(ValueError):
            PagePool(*bad)
    assert issubclass(PoolExhausted, Exception)


@pytest.mark.parametrize("budget", [0, 1, 3, 99])
def test_pop_fits_matches_jax_scheduler(budget):
    """A queue of requests needing 1..4 units and a budget: the first that
    fits pops; the others keep their order; the same as the JAX pop."""
    needs = [4, 2, 1, 3, 1]
    queues = []
    for sched, req in ((FifoScheduler(64), Request),
                       (jsched.FifoScheduler(64), jsched.Request)):
        for n in needs:
            sched.submit(req(prompt=[1] * n, max_new_tokens=1))
        popped = []
        while True:
            r = sched.pop(fits=lambda r: len(r.prompt) <= budget)
            if r is None:
                break
            popped.append(r.request_id)
        popped.append([r.request_id for r in list(sched._queue)])
        queues.append(popped)
    assert queues[0] == queues[1]
    sched = FifoScheduler(64)
    assert sched.pop(fits=lambda r: True) is None
    sched.submit(Request(prompt=[1, 2], max_new_tokens=1))
    assert sched.pop().request_id == 0  # fits=None: the plain FIFO pop
