"""The PyTorch port's continuous-batching ServeEngine.

Mirrors ``tests/test_serve.py`` for the port's core engine, on a toy int8
LM (vocab 64, d_model 32, 2 layers, 4 heads, window 64) whose float
weights are drawn with numpy from a seed and quantized by the JAX package,
so the JAX and the port engines serve the same weights:

- greedy output is token-exact against the port's own ``generate`` for
  staggered, mixed-length arrivals (MHA and GQA) — slot refill, bucketed
  prefill, per-slot positions and chained decode are invisible;
- the same stream through the JAX ``ServeEngine`` gives the same tokens
  (equal, not within a tolerance);
- host syncs: exactly one per chain plus one per prefill, counted both by
  the engine and by a spy on ``torch.Tensor.cpu``; no ``.item()``;
- scheduler edge cases: ``QueueFull`` backpressure, admission validation,
  FIFO order, finishing mid-chain, ``max_new_tokens == 1``, EOS, close and
  drain; sampled tokens are a function of the request's own seed;
- ``python -m pytorch_distributed_training_tutorials_tpu_torch.serve
  --selftest --device cpu`` exits 0.
"""

import dataclasses
import json
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
from pytorch_distributed_training_tutorials_tpu.serve import (
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    from_jax_params,
    generate,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve import (
    QueueClosed,
    QueueFull,
    Request,
    ServeEngine,
    bucket_len,
)
from helpers import requires_pallas_interpret

REPO = Path(__file__).resolve().parents[1]
TOY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Toy widths gain nothing from intra-op threads; one thread keeps
    this file from competing for cores with the suite's other workers
    (the port's results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_float_tree(cfg, seed=0):
    """Float JAX params drawn with numpy: kernels and the embedding
    N(0, 0.2^2), norm scales 1 + N(0, 0.1^2)."""
    shapes = jax.eval_shape(
        jt.TransformerLM(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4), jnp.int32),
    )["params"]
    rng = np.random.Generator(np.random.PCG64(seed))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if str(path[-1].key) == "scale":
            return (1.0 + 0.1 * x).astype(np.float32)
        return (0.2 * x).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class Served:
    """A toy int8 LM in both packages, over the same weights."""

    def __init__(self, **extra):
        kw = {**TOY, **extra}
        jcfg = jt.TransformerConfig(**kw)
        self.qtree = jt.quantize_lm_params(jax_float_tree(jcfg))
        self.jmodel = jt.TransformerLM(dataclasses.replace(jcfg, quantized=True))
        self.cfg = TransformerConfig(**kw, quantized=True)
        self.params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, self.qtree), self.cfg,
            device="cpu",
        )
        self.model = TransformerLM(self.cfg)

    def engine(self, **kw):
        kw = {"n_slots": 2, "tokens_per_launch": 8, **kw}
        return ServeEngine(self.model, self.params, device="cpu", **kw)

    def reference(self, prompt, max_new):
        """One-shot greedy generate(), new tokens only."""
        out = generate(self.model, self.params, [prompt], max_new, device="cpu")
        return out[0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def served():
    return Served()


def _prompt(seed, p_len, vocab=TOY["vocab_size"]):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, vocab, p_len).tolist()


STREAM = [(3, 9), (7, 12), (5, 5), (12, 6), (2, 17)]


def _run_staggered(engine, prompts, budgets, make=Request):
    """Two requests up front, the rest one per scheduling round."""
    ids = [
        engine.submit(make(prompt=prompts[i], max_new_tokens=budgets[i]))
        for i in range(2)
    ]
    pending = list(range(2, len(prompts)))
    completions = {}
    while not engine.idle or pending:
        if pending:
            i = pending.pop(0)
            ids.append(
                engine.submit(make(prompt=prompts[i], max_new_tokens=budgets[i]))
            )
        for c in engine.step():
            completions[c.request_id] = c
    return ids, completions


@pytest.mark.parametrize("extra", [{}, {"n_kv_heads": 2}], ids=["mha", "gqa"])
def test_token_exact_staggered_mixed_lengths(served, extra):
    """2 slots, 5 staggered requests with mixed prompt lengths/budgets:
    every completion equals the port's one-shot generate()."""
    s = served if not extra else Served(**extra)
    engine = s.engine()
    prompts = [_prompt(100 + i, p) for i, (p, _) in enumerate(STREAM)]
    budgets = [m for _, m in STREAM]
    ids, completions = _run_staggered(engine, prompts, budgets)
    assert sorted(completions) == sorted(ids)
    for i, max_new in enumerate(budgets):
        c = completions[ids[i]]
        assert c.tokens == s.reference(prompts[i], max_new), f"request {i}"
        assert c.finish_reason == "length"
        assert c.latency_s > 0 and 0 < c.ttft_s <= c.latency_s


@requires_pallas_interpret
def test_token_exact_vs_jax_engine(served):
    """The same staggered stream through the JAX ServeEngine (its Pallas
    int8 kernel in interpret mode) and the port's: the same tokens."""
    prompts = [_prompt(100 + i, p) for i, (p, _) in enumerate(STREAM)]
    budgets = [m for _, m in STREAM]
    jeng = JaxServeEngine(served.jmodel, served.qtree, n_slots=2, tokens_per_launch=8)
    jids, jdone = _run_staggered(jeng, prompts, budgets, make=JaxRequest)
    ids, done = _run_staggered(served.engine(), prompts, budgets)
    for i in range(len(prompts)):
        assert done[ids[i]].tokens == jdone[jids[i]].tokens, f"request {i}"
        assert done[ids[i]].finish_reason == jdone[jids[i]].finish_reason


def test_host_syncs_one_per_chain_plus_prefill(served, monkeypatch):
    """Host syncs: one batched copy per chain + one per prefill — counted
    by the engine and by a spy on Tensor.cpu; nothing calls .item()."""
    engine = served.engine()
    calls = {"cpu": 0, "item": 0}
    real_cpu, real_item = torch.Tensor.cpu, torch.Tensor.item

    def spy_cpu(self, *a, **kw):
        calls["cpu"] += 1
        return real_cpu(self, *a, **kw)

    def spy_item(self):
        calls["item"] += 1
        return real_item(self)

    for i in range(3):
        engine.submit(Request(prompt=_prompt(400 + i, 4 + 3 * i), max_new_tokens=20))
    monkeypatch.setattr(torch.Tensor, "cpu", spy_cpu)
    monkeypatch.setattr(torch.Tensor, "item", spy_item)
    completions = engine.run_until_idle()
    monkeypatch.undo()
    assert len(completions) == 3
    assert engine.n_chains >= 3  # 20 tokens at 8 per chain, several rounds
    assert engine.n_host_syncs == engine.n_chains + engine.n_prefills
    assert calls == {"cpu": engine.n_host_syncs, "item": 0}
    total = sum(len(c.tokens) for c in completions)
    assert total == 60 == engine.generated_tokens
    assert engine.n_host_syncs * engine.tokens_per_launch >= total


def test_backpressure_queue_full(served):
    engine = served.engine(n_slots=1, max_queue=2)
    for i in range(2):
        engine.submit(Request(prompt=_prompt(500 + i, 3), max_new_tokens=4))
    with pytest.raises(QueueFull):
        engine.submit(Request(prompt=_prompt(502, 3), max_new_tokens=4))
    assert len(engine.run_until_idle()) == 2
    rid = engine.submit(Request(prompt=_prompt(502, 3), max_new_tokens=4))
    assert rid == 2
    assert len(engine.run_until_idle()) == 1


def test_admission_validation(served):
    engine = served.engine(n_slots=1)
    with pytest.raises(ValueError):
        engine.submit(Request(prompt=[], max_new_tokens=4))
    with pytest.raises(ValueError):
        engine.submit(Request(prompt=[1, 2], max_new_tokens=0))
    with pytest.raises(ValueError):  # can never fit the 64-token window
        engine.submit(Request(prompt=[1] * 30, max_new_tokens=40))
    assert engine.idle
    with pytest.raises(ValueError):
        served.engine(n_slots=0)
    with pytest.raises(ValueError):
        served.engine(tokens_per_launch=0)


def test_fifo_order(served):
    engine = served.engine(n_slots=1)
    ids = [
        engine.submit(Request(prompt=_prompt(600 + i, 4), max_new_tokens=3))
        for i in range(3)
    ]
    assert [c.request_id for c in engine.run_until_idle()] == ids


def test_finish_mid_chain(served):
    """A budget that is not a chain multiple finishes mid-chain; the
    co-scheduled longer request stays token-exact."""
    engine = served.engine()
    p_short, p_long = _prompt(700, 5), _prompt(701, 6)
    i_short = engine.submit(Request(prompt=p_short, max_new_tokens=3))
    i_long = engine.submit(Request(prompt=p_long, max_new_tokens=19))
    done = {c.request_id: c for c in engine.run_until_idle()}
    assert done[i_short].tokens == served.reference(p_short, 3)
    assert done[i_long].tokens == served.reference(p_long, 19)


def test_max_new_tokens_one(served):
    """Completes straight out of prefill — no decode chain at all."""
    engine = served.engine(n_slots=1)
    prompt = _prompt(800, 6)
    rid = engine.submit(Request(prompt=prompt, max_new_tokens=1))
    done = engine.step()
    assert [c.request_id for c in done] == [rid]
    assert done[0].tokens == served.reference(prompt, 1)
    assert done[0].finish_reason == "length"
    assert engine.n_chains == 0 and engine.n_host_syncs == 1
    assert engine.idle


def test_eos_early_stop(served):
    """EOS mid-stream stops the request (stop token included), parks the
    slot, and the freed slot serves the next request exactly."""
    prompt = _prompt(900, 5)
    ref = served.reference(prompt, 12)
    eos = ref[4]
    stop_at = ref.index(eos) + 1
    engine = served.engine(n_slots=1)
    rid = engine.submit(Request(prompt=prompt, max_new_tokens=12, eos_token=eos))
    done = engine.run_until_idle()
    assert [c.request_id for c in done] == [rid]
    assert done[0].finish_reason == "eos"
    assert done[0].tokens == ref[:stop_at]
    assert int(engine._state.remaining[0]) == 0  # parked
    p2 = _prompt(901, 7)
    engine.submit(Request(prompt=p2, max_new_tokens=6))
    assert engine.run_until_idle()[0].tokens == served.reference(p2, 6)


def test_eos_at_first_token(served):
    prompt = _prompt(902, 4)
    first = served.reference(prompt, 1)[0]
    engine = served.engine(n_slots=1)
    engine.submit(Request(prompt=prompt, max_new_tokens=9, eos_token=first))
    done = engine.step()
    assert done[0].finish_reason == "eos"
    assert done[0].tokens == [first]
    assert engine.n_chains == 0
    assert engine.idle


def test_sampled_tokens_reproducible_per_seed(served):
    """temperature > 0: a request's tokens are a function of its own seed,
    alone or co-scheduled with strangers; another seed changes them."""
    prompt = _prompt(1000, 5)
    req = dict(prompt=prompt, max_new_tokens=10, seed=7)
    solo_eng = served.engine(temperature=1.0, top_k=20, top_p=0.95)
    rid = solo_eng.submit(Request(**req))
    solo = {c.request_id: c for c in solo_eng.run_until_idle()}[rid]
    busy_eng = served.engine(temperature=1.0, top_k=20, top_p=0.95)
    busy_eng.submit(Request(prompt=_prompt(1001, 9), max_new_tokens=14, seed=3))
    rid_busy = busy_eng.submit(Request(**req))
    busy_eng.submit(Request(prompt=_prompt(1002, 3), max_new_tokens=6, seed=11))
    busy = {c.request_id: c for c in busy_eng.run_until_idle()}[rid_busy]
    assert solo.tokens == busy.tokens
    other_eng = served.engine(temperature=1.0, top_k=20, top_p=0.95)
    rid2 = other_eng.submit(Request(**{**req, "seed": 8}))
    other = {c.request_id: c for c in other_eng.run_until_idle()}[rid2]
    assert other.tokens != solo.tokens


def test_close_and_drain(served):
    engine = served.engine(n_slots=1)
    ids = [
        engine.submit(Request(prompt=_prompt(1100 + i, 4), max_new_tokens=5))
        for i in range(2)
    ]
    engine.close()
    assert engine.closed
    with pytest.raises(QueueClosed):
        engine.submit(Request(prompt=[1, 2], max_new_tokens=2))
    done = engine.drain()
    assert [c.request_id for c in done] == ids
    assert all(len(c.tokens) == 5 for c in done)


def test_bucket_len():
    assert bucket_len(1, 64) == 8
    assert bucket_len(8, 64) == 8
    assert bucket_len(9, 64) == 16
    assert bucket_len(33, 64) == 64
    assert bucket_len(60, 64) == 64
    assert bucket_len(5, 6) == 6
    with pytest.raises(ValueError):
        bucket_len(0, 64)


def test_default_device_is_cuda(served):
    """Entry points run on cuda unless asked for the CPU; without a GPU
    they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(served.model, served.params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(served.model, served.params, [[1, 2]], 2)


def test_selftest_subprocess_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_training_tutorials_tpu_torch.serve",
         "--selftest", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    receipt = json.loads(out.stdout.strip().splitlines()[-1])
    assert receipt["ok"] and receipt["mismatches"] == 0
    assert receipt["n_host_syncs"] == receipt["n_chains"] + receipt["n_prefills"]
    assert receipt["backpressured"]
