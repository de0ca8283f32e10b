"""Serving's failure handling on the card (marked ``requires_cuda``): the
guard's flags in the chain's block and the chaos poison decided on the
host, on CUDA tensors.

They skip where ``torch.cuda.is_available()`` is false (decided inside
each test, never at import). This file imports no jax, so it also runs on
the GPU machine (``--noconftest``: ``tests/conftest.py`` imports jax).

- The guard: a small int8 LM (vocab 64, d_model 32, 2 layers) on the card,
  with and without ``guard_nonfinite``: the guarded chain's block is one
  int64 tensor of (2, n_slots, tokens_per_launch) whose flag plane is all
  ones, the tokens equal the unguarded engine's, and both engines make the
  same host syncs (chains + prefills) and no more stream syncs (PyTorch's
  sync debug mode).
- The poison: ``poison_logits`` at a host step index on a CUDA tensor makes
  no sync (sync debug mode set to raise) and fills only the victim row at
  its step; an engine with the chaos NaN quarantines the victim
  (``"nonfinite"``, a prefix of the clean run's tokens), its neighbour
  equal to the clean run, with no more stream syncs than the clean run's
  budget and no device-side assert (a NaN row's greedy token is in range).
"""

import pytest
import torch

from pytorch_distributed_training_tutorials_tpu_torch.bench.harness import count_host_syncs
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    init_quantized_lm,
)
from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
from pytorch_distributed_training_tutorials_tpu_torch.utils import chaos

pytestmark = pytest.mark.requires_cuda

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64, quantized=True)
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6, 8, 10, 12, 14, 16, 18], [1, 2, 3], [13, 17, 19, 23]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serving path's kernels have no CPU mode here")


def _engine(**kw):
    cfg = TransformerConfig(**CFG)
    return ServeEngine(TransformerLM(cfg), init_quantized_lm(cfg, seed=0, device="cuda"),
                       n_slots=2, tokens_per_launch=4, device="cuda", **kw)


def _serve(eng):
    with count_host_syncs(torch) as got:
        ids = [eng.submit(Request(prompt=p, max_new_tokens=10)) for p in PROMPTS]
        done = {c.request_id: c for c in eng.run_until_idle()}
    torch.cuda.synchronize()
    return [(done[i].tokens, done[i].finish_reason) for i in ids], got[0]


def test_guard_block_on_the_card():
    _card()
    off = _engine()
    on = _engine(guard_nonfinite=True)
    blocks = []
    real = on._chain

    def chain():
        blocks.append(real())
        return blocks[-1]

    on._chain = chain
    want, syncs_off = _serve(off)
    got, syncs_on = _serve(on)
    assert got == want and all(r == "length" for _, r in got)
    assert blocks and all(b.dtype == torch.int64 and b.shape == (2, 2, 4) and b.is_cuda
                          for b in blocks)
    assert all(bool((b[1] == 1).all()) for b in blocks)
    assert on.n_host_syncs == off.n_host_syncs == on.n_chains + on.n_prefills
    assert syncs_on <= on.n_host_syncs and syncs_off <= off.n_host_syncs


def test_poison_decided_on_the_host_on_the_card():
    _card()
    logits = torch.randn(3, 64, device="cuda")
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        same = chaos.poison_logits(logits, 4, 1, 5)
        hit = chaos.poison_logits(logits, 5, 1, 5)
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    assert same is logits
    assert bool(hit[1].isnan().all()) and torch.equal(hit[[0, 2]], logits[[0, 2]])
    clean, _ = _serve(_engine(guard_nonfinite=True))
    eng = _engine(guard_nonfinite=True, chaos=chaos.ChaosConfig(nan_logit_slot=1,
                                                                nan_logit_step=2))
    got, syncs = _serve(eng)
    assert got[1][1] == "nonfinite" and got[1][0] == clean[1][0][:len(got[1][0])]
    assert len(got[1][0]) == 1 + 2
    assert got[0] == clean[0] and got[2:] == clean[2:]
    assert eng.fault_stats()["nonfinite_quarantined"] == 1
    assert syncs <= eng.n_host_syncs == eng.n_chains + eng.n_prefills
