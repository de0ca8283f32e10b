"""Pipelined serving (``pipeline_depth``) in the PyTorch port against the
JAX package's, and the request loop's uploads.

The toy int8 LM and the overlapping stream of ``test_torch_serve_prefill.py``
(seven prompts of 16-31 tokens sharing a head, budgets 4-10; weights drawn
with numpy from a seed, both packages fed the same values through
``models/convert.py:from_jax_params``) through 2 slots, chains of 8.

Exact: a depth-2 stream's tokens equal the depth-1 engine's with the same
options and the JAX package's depth-2 engine's, with equal chain, refill
and ``pipeline_stats()`` counters, and (the full composition: paged
kernel — its plain version on the CPU, the JAX package's Pallas kernel in
interpret mode — prefix cache, speculation, depth 2 and chunks of 8)
equal ``spec_stats()`` and ``page_stats()``; the host syncs stay chains +
whole prefills + splices + final chunks, also counted by a spy on
``Tensor.cpu``. The ordering spy sees chain 1 dispatched before chain 0 is
collected at depth 2 and the serial order at depth 1. ``upload`` pins its
host tensor and copies it non-blocking when the device is a card (a spy
on ``Tensor.pin_memory`` and ``Tensor.to``: there is no card here).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import transformer as tmodel
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine, slots
from helpers import requires_pallas_interpret
from test_torch_serve_prefill import Int8

pytestmark = requires_pallas_interpret

REPO = Path(__file__).resolve().parents[1]
PREFIX_BYTES = 1 << 22
GEOM = dict(paged=True, page_size=8, pool_pages=24)
# arm -> (options of both depths, held against the JAX depth-2 engine)
ARMS = {
    "plain": (dict(), True),
    "composition": (dict(paged_kernel=True, prefix_cache_bytes=PREFIX_BYTES, speculative_k=2,
                         prefill_chunk=8, **GEOM), True),
    "int8-kv-spec-chunk": (dict(kv_bits=8, speculative_k=3, prefill_chunk=8), False),
    # 12 pages for 2 slots of 4-5 pages each: a finished slot's pages go
    # straight to the next request while its junk chain is in flight
    "paged-tight": (dict(paged=True, page_size=8, pool_pages=12, paged_kernel=True), False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def int8():
    return Int8()


def _engine(int8, **kw):
    return ServeEngine(int8.model(), int8.params, n_slots=2, tokens_per_launch=8, device="cpu",
                       **kw)


class _SyncSpy:
    """Counts device->host copies through ``Tensor.cpu``."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = torch.Tensor.cpu

        def counting(t, *a, **k):
            self.n += 1
            return real(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "cpu", counting)


@pytest.mark.parametrize("arm", list(ARMS))
def test_depth2_stream_matches_depth1_and_jax(int8, arm, monkeypatch):
    kw, against_jax = ARMS[arm]
    serial = int8.run(_engine(int8, **kw))
    eng = _engine(int8, pipeline_depth=2, **kw)
    spy = _SyncSpy(monkeypatch)
    got = int8.run(eng)
    monkeypatch.undo()
    assert got == serial
    r = eng.refills
    budget = eng.n_chains + r["prefill"] + r["splice"] + r["chunked"] + r["chunked_splice"]
    assert eng.n_host_syncs == spy.n == budget
    assert eng.pipeline_stats() == {"pipeline_depth": 2, "prefill_chunk": kw.get("prefill_chunk", 0),
                                    "n_chunks": eng.n_chunks}
    if "prefill_chunk" in kw:
        assert eng.n_chunks > 0
    if against_jax:
        jeng = JaxServeEngine(int8.jmodel(), int8.qtree, n_slots=2, tokens_per_launch=8,
                              pipeline_depth=2, **kw)
        assert got == int8.run(jeng, make=JaxRequest)
        assert eng.pipeline_stats() == jeng.pipeline_stats()
        assert eng.spec_stats() == jeng.spec_stats()
        assert (eng.n_chains, eng.n_prefills, eng.n_splices) == (
            jeng.n_chains, jeng.n_prefills, jeng.n_splices)
        if kw.get("paged"):
            assert eng.prefix_stats() == jeng.prefix_stats()
            assert eng.page_stats() == jeng.page_stats() | {"paged_kernel": 1}
    if kw.get("paged"):
        while eng.prefix is not None and eng.prefix.evict_coldest():
            pass
        assert eng.page_stats()["pages_in_use"] == 0


def test_ordering_dispatch_before_fetch(int8):
    """The pipeline observed, not inferred: at depth 2 chain 1 is
    dispatched before chain 0's block is fetched; at depth 1 chain 0 is
    fetched first. Chains are collected in dispatch order, each once (the
    trailing chain the end of the stream drains included)."""
    prompt = int8.prompts[3]

    def run(depth):
        eng = ServeEngine(int8.model(), int8.params, n_slots=1, tokens_per_launch=4,
                          device="cpu", pipeline_depth=depth)
        log = []
        real_chain, real_land = eng._chain, eng._land

        def chain():
            log.append(("dispatch", eng.n_chains))
            return real_chain()

        def land(fl):
            log.append(("fetch", fl.chain_id))
            return real_land(fl)

        eng._chain, eng._land = chain, land
        eng.submit(Request(prompt=prompt, max_new_tokens=13))
        (done,) = eng.run_until_idle()
        assert len(done.tokens) == 13 and not eng._inflight
        return log, done.tokens

    serial_log, serial_toks = run(1)
    piped_log, piped_toks = run(2)
    assert piped_toks == serial_toks
    assert serial_log.index(("fetch", 0)) < serial_log.index(("dispatch", 1))
    assert piped_log.index(("dispatch", 1)) < piped_log.index(("fetch", 0))
    for log in (serial_log, piped_log):
        fetched = [i for op, i in log if op == "fetch"]
        assert fetched == list(range(len(fetched)))
        assert [i for op, i in log if op == "dispatch"] == fetched
    assert len(piped_log) == len(serial_log) + 2  # the trailing junk chain


def test_pipeline_off_engine_unchanged_and_validation(int8):
    """Depth 1 and chunk 0 (the defaults) are today's engine: no pinned
    ring, nothing left in flight after a step, the JAX package's
    ``pipeline_stats()`` keys; depth 0 is refused."""
    default, explicit = _engine(int8), _engine(int8, pipeline_depth=1, prefill_chunk=0)
    assert int8.run(default) == int8.run(explicit)
    assert default._ring is None and not default._inflight
    assert default.pipeline_stats() == {"pipeline_depth": 1, "prefill_chunk": 0, "n_chunks": 0}
    assert _engine(int8, pipeline_depth=2)._ring is None  # pinned buffers only on a card
    with pytest.raises(ValueError, match="pipeline_depth"):
        _engine(int8, pipeline_depth=0)


def test_upload_pins_and_copies_non_blocking(monkeypatch):
    """``slots.upload`` on a card: the host tensor is pinned, then copied
    with ``non_blocking=True`` (a pageable copy would synchronize the
    stream); on the CPU it is a plain ``.to``. Spied, as this box has no
    card."""
    calls = []
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda t, *a, **k: calls.append(("pin",)) or t)
    monkeypatch.setattr(torch.Tensor, "to",
                        lambda t, *a, **k: calls.append(("to", a, k)) or t)
    out = slots.upload([[1, 2, 3]], torch.int32, torch.device("cuda"))
    assert calls == [("pin",), ("to", (torch.device("cuda"),), {"non_blocking": True})]
    assert out.dtype == torch.int32 and out.tolist() == [[1, 2, 3]]
    calls.clear()
    slots.upload([4], torch.int64, "cpu")
    assert calls == [("to", ("cpu",), {})]


def test_request_loop_uploads_go_through_upload(int8, monkeypatch):
    """Every host-to-device input of the request loop (prompt tokens,
    page ids and tables, the draft history's prompt) goes through
    ``upload``: a paged, prefix, chunked, speculative stream never builds
    a tensor from host data on a device any other way, and never writes a
    host number into a tensor by item assignment (on a card that copies a
    host scalar and synchronizes the stream; the loop fills instead); the
    forward takes host scalars (a rope offset, a ``last_pos``) without
    making a tensor of them."""
    eng = _engine(int8, paged_kernel=True, prefix_cache_bytes=PREFIX_BYTES, speculative_k=2,
                  prefill_chunk=8, **GEOM)
    uploads, strays = [], []
    real_upload, real_tensor, real_as = slots.upload, torch.tensor, torch.as_tensor

    def counted(values, dtype, device):
        uploads.append(dtype)
        return real_upload(values, dtype, device)

    def stray(real):  # a tensor made from host data straight on a device
        def f(*a, **k):
            if "device" in k:
                strays.append(a[0] if a else k)
            return real(*a, **k)
        return f

    monkeypatch.setattr(slots, "upload", counted)
    from pytorch_distributed_training_tutorials_tpu_torch.serve import engine as emod
    monkeypatch.setattr(emod, "upload", counted)
    got = int8.run(eng)
    monkeypatch.setattr(torch, "tensor", stray(real_tensor))
    monkeypatch.setattr(torch, "as_tensor", stray(real_as))
    real_setitem = torch.Tensor.__setitem__

    def setitem(t, index, value):
        if isinstance(value, (int, float)):
            strays.append(("item assignment", tuple(t.shape), value))
        return real_setitem(t, index, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", setitem)
    assert int8.run(_engine(int8, paged_kernel=True, prefix_cache_bytes=PREFIX_BYTES,
                            speculative_k=2, prefill_chunk=8, **GEOM)) == got
    monkeypatch.undo()
    assert strays == [] and len(uploads) > 2 * len(int8.prompts)
    assert {torch.int64, torch.int32} <= set(uploads)
    x = torch.randn(1, 3, 2, 8)
    assert torch.equal(tmodel.apply_rope(x, 1e4, 5), tmodel.apply_rope(x, 1e4, torch.tensor(5)))


def test_selftest_spec_and_pipeline_arms_exit_0():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_training_tutorials_tpu_torch.serve",
         "--selftest", "--device", "cpu", "--spec-k", "2", "--pipeline-depth", "2"],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["ok"] and r["spec_token_exact"] and r["pipeline_token_exact"]
    assert r["spec_mean_accepted_len"] > 1 and r["n_verify_forwards"] < r["spec_generated_tokens"]
    assert r["n_chunks"] >= 1 and r["pipeline_depth"] == 2
