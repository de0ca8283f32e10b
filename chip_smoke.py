#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100, sm_90a).

    python3 chip_smoke.py                 # every phase, from the repo root
    python3 chip_smoke.py --kernel-only   # phases 0-2: build, check, time
    python3 chip_smoke.py --ddp-only      # phases 0, 1, 8 and 9
    python3 chip_smoke.py --serve-only    # phases 0, 1, 4 and the serving phases after it

It drives the port (``pytorch_distributed_training_tutorials_tpu_torch``)
on the card and fails — non-zero exit, no result line — if a phase fails.
Every phase prints JSON lines:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. the build of every hand-written kernel from ``csrc/`` (one ``nvcc`` per
   source, all started together; seconds, ptxas); then two seconds of bf16
   matmuls, so that no timing below catches the card's clocks rising from
   idle;
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes: the max abs difference against a stated tolerance and
   CUDA-event times (median of 25 launches, L2 flushed before each and the
   card held while the host queues the call, ``quiesce``) beside
   the bound and, where one PyTorch call computes the same function, its
   time — ``int8_matmul`` (expected bitwise) at every 1b (K, N) pair at M
   1-64 (M 12: a speculative verify forward) and the prefill M 512 and
   2048, through the sm90 kernel
   (``int8_matmul_sm90.cu``: s8 wgmma, TMA, split K; the route counted, two
   calls bitwise equal), the v1 kernel (``int8_matmul.cu``) checked and
   timed in turns with it at M 4 and the prefill M (sm90, v1, v1, sm90
   in every round, ``time_turns_ms``),
   two ragged shapes through v1, and the host's cost of a TMA map; then
   ``flash_fwd``,
   ``flash_dq`` and ``flash_dkv`` at the 760m train shape (B 2, S 2048, H
   16, D 96) in bf16 and f32, D 64 and 128, a ragged S 1000 (strided
   inputs) and S 8 — all three through the sm90 kernels
   (``flash_attention_sm90.cu``, wgmma and TMA) where the operands are
   bf16, else through ``flash_attention.cu``'s, the route counted and two
   sm90 calls bitwise equal; at the main shape the old kernels too,
   checked and timed in turns with the sm90 ones (sm90, old, old, sm90) —
   then ``fused_ce_fwd``, ``fused_ce_dh`` and ``fused_ce_dw`` at the 760m
   loss shape (N 4096, D 1536, V 32768) in bf16 and f32, a ragged (1000,
   1536, 32000) with a target out of range, an odd vocab (1000, 1536,
   32001), D not a multiple of 64 (200, 200, 1000), D under 64 (64, 40,
   1000) and a tiny shape — all three through the sm90 kernels
   (``fused_loss_sm90.cu``) where the operands are bf16 with D and V
   multiples of 8, else through ``fused_loss.cu``'s, the route counted and
   two sm90 calls bitwise equal; at the main shape the old kernels too,
   checked and timed in turns with the sm90 ones — each output held element by element to
   the bound of ``ops._check.KERNEL_TOLERANCE`` (``kernel_error``); then ``fused_adamw``
   over leaves of the 760m parameter shapes (expected bitwise); then
   ``paged_attention`` at the 1b and 1b-gqa decode geometry (B 4, H 16, KV
   16 or 4, D 128, pages of 64, a 4096-token window, ragged depths, an S 4
   chunk, a parked row, the paged stream's depths, a 3-row verify forward
   at ragged depths) over f32, bf16, int8 and
   int4 pools, through the sm90 kernel (``paged_attention_sm90.cu``: pages
   split across blocks, TMA, a merge in split order; the route counted, two
   calls bitwise equal), held to the plain statement of its split and merge
   and to the unsplit plain version, a parked row exactly 0, and at the
   stream shape the v1 kernel (``paged_attention.cu``) checked and timed in
   turns with it; then ``flash_fwd`` at the serving shapes (one prefill's
   attention of one layer: B 1, S 16 to 512, H 16, D 128) in f32 through
   ``fwd_kernel`` (the int8 model's route) and bf16 through
   ``fwd_sm90_kernel`` (the float model's), each held to its plain version
   and timed beside SDPA;
3. serving: a 2-layer model at the 1b preset's widths, on the card (kernel)
   against the CPU (plain version): logits and greedy tokens;
4. the serving slice: the 1b preset at full depth serving the ``--server``
   stream of ``examples/serve_llm_int8.py`` (12 requests, prompts {16, 32,
   48}, 32 new tokens, greedy) through ``ServeEngine(n_slots=4,
   tokens_per_launch=8)``, with the kernel-launch and host-sync counts
   checked, every int8 call on the sm90 route, and two requests held
   against ``generate``;
5. training: a 2-layer model at the 760m preset's widths, S 256, flash
   attention, in float32 and bfloat16, on the card (kernels) against the
   CPU (plain versions): the loss and every gradient, with cross entropy
   and with the fused loss (then also one ``fused_adamw`` step);
6. the train slice: the port's ``bench.lm_headline`` default arm (760m at
   full depth and width, seq 2048, batch 2, bf16, flash, remat "dots",
   AdamW) for a warmup chain and 2 timed chains of 6 steps and one
   profiled step: finite, falling loss, exactly 48 / 24 / 24 flash
   forward / dq / dk-dv launches per step, every one on the sm90 route,
   step time, MFU, peak memory;
7. its fused arm (``--fused``: the fused loss and ``fused_adamw``), the
   same chains in the same call: finite, falling loss, the first loss
   within one bf16 ulp of phase 6's, exactly 48 / 24 / 24 flash, 1 / 1 / 1
   fused-loss and 1 fused-AdamW launches per step, every flash forward,
   dq and dk/dv and every fused-loss forward, dh and dW launch on the sm90
   route;
8. ``resnet_card_vs_cpu``: one train step of ``resnet18(stem="cifar")`` at
   batch 16, 28x28x1, in float32 (TF32 off) and bfloat16, on the card and
   on the CPU from the same weights — the loss, every gradient, the
   BatchNorm running statistics, the eval-mode logits — each no farther
   from the CPU's float64 run than 1.5x the CPU's own plus a floor; the
   float32 step with TF32 on must break that bound (the control);
9. ``train_resnet_ddp``, the DDP slice: an NCCL world of one formed
   through the spawn contract on 127.0.0.1 (backend and an all-reduce on
   the card checked), the ResNet-18 MNIST headline of ``bench.headline``
   (512 images per device, uint8 surrogate resident on the card, bf16,
   SGD momentum) for 2 epochs through ``Trainer.train``: finite losses,
   epoch 2's mean below epoch 1's, eval accuracy on the test surrogate
   above ``RESNET_ACC_FLOOR``, at most one host sync an epoch (sync debug
   mode); one step with BatchNorm synced and the gradients all-reduced on
   NCCL bitwise equal to the unsynced step; images/sec/GPU, step ms, peak
   memory, idle share and the top device ops; then its fused-AdamW arm
   for one epoch: one ``fused_adamw`` launch a step, loss falling, the
   kernel bitwise the plain AdamW at the arm's own leaves, its time on
   this path beside its bound.

Between phases 4 and 5, ``serve_1b_paged``: the 1b-gqa preset at full
depth, window 4096, serving 12 requests (prompts {16, 480, 1500}, 32 new
tokens) through 4 slots over a pool of 48 pages of 64 tokens, arm by arm —
(a) whole-slot, (b) paged gather f32 (tokens equal to (a)), (c) paged
kernel f32, (d) kernel int8, (e) kernel int4 — each with its launch, sync,
page and shed gates, and every int8 and paged call on the sm90 route. Then each kernel arm is held teacher-forced against a
gather engine at its KV storage on (b)'s tokens (``teacher_forced_logits``:
logits within 4% of their scale, the same argmax where the top-2 gap is
wider): (c) on every request, (d) and (e) on one request of each prompt
length; (d) and (e) against the f32 gather are read as a lower-precision
control, and two planted faults (the first page of each table swapped for
another request's page, or dropped) must trip the gate. Then
``serve_1b_gqa_paged_spec``: arm (c) with ``speculative_k=2`` and
``pipeline_depth=2`` — one paged launch a layer a verify forward (3 query
rows), 113 int8 calls a forward, all sm90; no page leaked; one request of
each prompt length teacher-forced in verify-shaped forwards (3 rows) within
4% of the f32 gather's logits; every request's speculative tokens the
argmax of the same engine's teacher-forced logits on them wherever the
top-2 gap is wider than 4% of the logit scale, and ``spec_stats()``
within a host replay of the drafts over those tokens.

Then ``serve_1b_prefill``, the prefill slice: the 1b preset at full width
and depth, int8 weights, serving 12 requests (prompts {128, 256, 384},
three quarters of each from one shared family, 32 new tokens) through 4
slots, arm by arm (PREFILL_ARMS): (a) dense prefill, (b) flash prefill,
(c) flash with a 512 MiB prefix cache, (d) dense with the cache, (e)
flash with the cache and chunks of 128 (the first 128-token prompt
prefills whole through flash, longer misses stream in chunks). Gates:
every request completes;
flash forward launches = 16 x the whole prefills, all on the f32 route
(none in a splice or a chunk); every int8 call on the sm90 route; host
syncs = chains + whole prefills + splices + final chunks; hits and
splices in (c)-(e), fewer whole-prompt prefills than (a), chunks in (e);
(d) token-identical to (a); (b), (c), (e) teacher-forced against (a),
(d), (d) within 4% of the logit scale on one request of each length.
``generate`` with flash prefill launches 16. One prefill per bucket,
dense against flash, in turns (events and the profiler's device time).
(f) the 1b-gqa preset over serve_1b_paged's pool with the paged kernel,
the cache and flash prefill (6 requests): pages shared, paged calls all
sm90, a spliced request teacher-forced against a cache-off gather twin,
no page in use after the drain and the index clear. (g) ``init_lm`` 1b in
bf16 with flash prefill (4 requests): every flash launch on the sm90
route, teacher-forced against the same weights with dense prefill.

Then ``serve_1b_spec``: phase 4's cell (the 1b preset, 4 slots, 12
requests, prompts {16, 32, 48}, 32 new tokens) with flash prefill, arm by
arm (SPEC_ARMS): (a) plain, (s) ``speculative_k=2``, (p)
``pipeline_depth=2``, (sp) both. Gates: (s), (p) and (sp) token-identical
to (a); 113 int8 calls a forward (a verify forward at M = 12) and 16 flash
launches a whole prefill, all on their routes; host syncs = chains +
prefills; in a profiled window of (p) and (sp) each next chain's first
kernel queued before the previous chain's collect returned, in (a) and (s)
never; ``spec_stats()`` equal to a host replay of the drafts over (a)'s
greedy tokens. Each arm's tok/s, latency, TTFT, verify forwards, acceptance
and the device's busy and idle share.

Every serving stream is also run under PyTorch's sync debug mode: its
stream syncs (with their call sites) must not exceed the host syncs the
engine budgets.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Needs no network and one card. It
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "pytorch_distributed_training_tutorials_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8
# and bf16 tensor-core ops/s, float32 outside the tensor cores — the
# roofline every bound below is taken against
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# the 760m preset of bench/lm_headline.py
PRESET_760M = dict(vocab_size=32768, d_model=1536, n_layers=24, n_heads=16)
N_PARAMS_760M = 1_006_708_224
# flash launches per 760m train step: 24 layers, the forward run twice
# (remat "dots" recomputes it in the backward), one dq and one dk/dv
FLASH_PER_STEP = {"fwd": 48, "dq": 24, "dkv": 24}
# (B, S, H, D, dtype, strided) of the flash checks; the first is the main
# shape of the 760m train step
FLASH_SHAPES = [
    (2, 2048, 16, 96, "bf16", False),
    (2, 2048, 16, 96, "f32", False),
    (2, 2048, 16, 64, "bf16", False),
    (2, 2048, 16, 128, "bf16", False),
    (2, 1000, 16, 96, "bf16", True),
    (2, 8, 16, 96, "bf16", False),
]
FLASH_REPLACES = {
    "fwd": "pytorch_distributed_training_tutorials_tpu/ops/flash_attention.py:50",
    "dq": "pytorch_distributed_training_tutorials_tpu/ops/flash_attention.py:113",
    "dkv": "pytorch_distributed_training_tutorials_tpu/ops/flash_attention.py:157",
}
# products of B*H*S(S+1)/2*D multiply-adds each kernel runs (causal work)
FLASH_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}

# (N, D, V, dtype, a target out of range) of the fused loss checks; the
# first is the loss of the 760m train step (B 2 x S 2048 rows)
FUSED_CE_SHAPES = [
    (4096, 1536, 32768, "bf16", False),
    (4096, 1536, 32768, "f32", False),
    (1000, 1536, 32000, "bf16", True),
    (1000, 1536, 32001, "bf16", True),  # an odd vocab: the old bf16 kernels
    (200, 200, 1000, "bf16", True),  # D not a multiple of 64: a partial last TMA box
    (64, 40, 1000, "bf16", True),  # D under 64: one box, mostly past D
    (8, 64, 200, "bf16", True),
]
FUSED_CE_REPLACES = {
    "fwd": "pytorch_distributed_training_tutorials_tpu/ops/fused_loss.py:89",
    "dh": "pytorch_distributed_training_tutorials_tpu/ops/fused_loss.py:159",
    "dw": "pytorch_distributed_training_tutorials_tpu/ops/fused_loss.py:190",
}
# score passes (2 N D V FLOPs each) per kernel: dh and dW recompute the
# scores and run one gradient product
FUSED_CE_PASSES = {"fwd": 1, "dh": 2, "dw": 2}
# fused-loss and fused-AdamW launches per 760m train step (219 leaves: one
# multi-tensor launch)
FUSED_PER_STEP = {"fwd": 1, "dh": 1, "dw": 1}
ADAMW_PER_STEP = 1
ADAMW_REPLACES = "pytorch_distributed_training_tutorials_tpu/ops/fused_optim.py:50"

PAGED_REPLACES = "pytorch_distributed_training_tutorials_tpu/ops/paged_attention.py:123"
# (name, B, S, H, KV, D, page_size, pages per row, depths, parked rows) of
# the paged-attention checks: the 1b and 1b-gqa decode geometry over a
# 4096-token window, ragged depths, distinct pages and sentinel tails; an S
# 4 chunk; a parked row; and the serve stream's mid-decode depths (prompts
# {16, 480, 1500} + 16), the shape of the kernels line
PAGED_SHAPES = [
    ("1b", 4, 1, 16, 16, 128, 64, 64, (0, 1000, 2500, 4095), ()),
    ("1b-gqa", 4, 1, 16, 4, 128, 64, 64, (0, 1000, 2500, 4095), ()),
    ("1b-gqa-chunk4", 4, 4, 16, 4, 128, 64, 64, (0, 1000, 2500, 4092), ()),
    ("1b-gqa-parked", 4, 1, 16, 4, 128, 64, 64, (0, 1000, 2500, 4095), (2,)),
    ("1b-gqa-stream", 4, 1, 16, 4, 128, 64, 64, (32, 496, 1516, 32), ()),
    # a paged splice's suffix forward in serve_1b_prefill (f): one row, a
    # 256-token suffix bucket from depth 96, in row blocks
    ("1b-gqa-splice", 1, 256, 16, 4, 128, 64, 64, (96,), ()),
    # a speculative verify forward of the paged stream (k = 2): 3 query
    # rows a slot at ragged mid-decode depths, one launch
    ("1b-gqa-verify", 4, 3, 16, 4, 128, 64, 64, (34, 498, 1518, 40), ()),
]
PAGED_STORES = ("f32", "bf16", "int8", "int4")
# bf16 queries (the JAX kernel's sweep), on the 1b-gqa shape
PAGED_BF16_Q = ("bf16", "int8")
PAGED_MAIN = ("1b-gqa-stream", "f32", "f32")  # (shape, storage, q) of the kernels line
PAGED_LIBRARY_NOTE = (
    "no single PyTorch call walks a page table: the nearest is two calls, a "
    "gather of the pages (index_select) and F.scaled_dot_product_attention "
    "over the gathered window, timed as gather_sdpa_ms (exact pools only)"
)

# serve_1b_spec: the 1b int8 cell of serve_1b (4 slots, 12 requests,
# prompts {16, 32, 48}, 32 new tokens, greedy) with flash prefill, arm by
# arm: (a) plain, (s) speculative_k=2, (p) pipeline_depth=2, (sp) both;
# the verify forward is M = 4 x 3 = 12 rows of every int8 matmul
SPEC_K, SPEC_NGRAM = 2, 3
SPEC_ARMS = {
    "a": {},
    "s": dict(speculative_k=SPEC_K, spec_ngram=SPEC_NGRAM),
    "p": dict(pipeline_depth=2),
    "sp": dict(speculative_k=SPEC_K, spec_ngram=SPEC_NGRAM, pipeline_depth=2),
}
# steady steps of the profiled window of each serve_1b_spec arm
SPEC_PROFILE_STEPS = 3

# the 1b preset of examples/serve_llm_int8.py
PRESET_1B = dict(
    vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, d_ff=8192,
    max_seq_len=512,
)
# (K, N) of every int8 matmul of one 1b forward and its count per forward:
# q/k/v/o (16 layers x 4), gate/up (x 2), down, and the lm_head
DECODE_MIX = [((2048, 2048), 64), ((2048, 8192), 32), ((8192, 2048), 16),
              ((2048, 32000), 1)]
# prefill M of the int8 checks: serve_1b's largest bucket and the paged
# stream's (its 1500-token prompt)
INT8_PREFILL_M = (512, 2048)
INT8_REPLACES = "pytorch_distributed_training_tutorials_tpu/ops/quant.py:141"
# the 1b-gqa preset of examples/serve_llm_int8.py at the real-chip window
# of its --paged recipe, and the paged stream: 4 slots, 12 requests with
# prompts cycling {16, 480, 1500} and 32 new tokens, a pool of 48 pages of
# 64 tokens against the 256 that 4 whole slots would take
PRESET_1B_GQA = dict(
    vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=4,
    d_ff=8192, max_seq_len=4096,
)
PAGED_STREAM = dict(n_slots=4, tokens_per_launch=8, requests=12, prompts=(16, 480, 1500),
                    new=32, page_size=64, pool_pages=48, shed_prompt=3500)
# arm -> engine options: (a) whole-slot, (b) paged gather f32, (c) paged
# kernel f32, (d) paged kernel int8, (e) paged kernel int4
PAGED_ARMS = {
    "a": {},
    "b": dict(paged=True),
    "c": dict(paged=True, paged_kernel=True),
    "d": dict(paged=True, paged_kernel=True, kv_bits=8),
    "e": dict(paged=True, paged_kernel=True, kv_bits=4),
}
# a kernel arm against the gather at the same KV storage, teacher-forced:
# logits within this share of the request's largest |logit|. On an H100 the
# sound pairs differ by at most 1.9% (an int8 activation code step,
# ROADMAP.md section C) and the planted faults by 8.2% (dropped page) and
# 16.7% (wrong page); 4% is near the geometric middle (PERF.md section 6)
TF_LOGIT_BOUND = 0.04
# kernel arm -> (its gather reference, requests held: None = all, 3 = one
# of each prompt length); "b8"/"b4" are gather engines at kv_bits 8/4
TF_PAIRS = {"c": ("b", None), "d": ("b8", 3), "e": ("b4", 3)}
TF_GATHER = {"b8": dict(paged=True, kv_bits=8), "b4": dict(paged=True, kv_bits=4)}
# planted faults arm (c) must fail the gate with, on request 1 (8 pages)
TF_FAULTS = ("wrong_page", "dropped_page")
# one page across the 16 layers' K, V (and scales): 64 tokens x 4 kv heads
# x (2 x 128 x 4 bytes | 2 x (128 + 4) | 2 x (64 + 2))
PAGE_BYTES = {0: 4_194_304, 8: 1_081_344, 4: 540_672}
# the flash forward on the serving path: one prefill at B 1, H 16, D 128
# per bucket of serve_1b_spec's prompts (16, 32, 64: partial tiles of the
# f32 kernel's 64-row blocks) and of serve_1b_prefill's (128, 256, 512),
# in f32 (the int8 model) and bf16 (the float model)
FLASH_SERVE_SHAPES = [(1, s, 16, 128, dt) for dt in ("f32", "bf16")
                      for s in (16, 32, 64, 128, 256, 512)]
# serve_1b_prefill: the 1b preset at full width and depth, int8 weights
# from init_quantized_lm(seed=0); 4 slots, 12 timed requests of 32 new
# tokens, prompts {128, 256, 384} made as examples/serve_llm_int8.py makes
# them (one shared family: prompt = shared[:round(0.75 p_len)] + tail)
PREFILL_STREAM = dict(n_slots=4, tokens_per_launch=8, requests=12, prompts=(128, 256, 384),
                      new=32, overlap=0.75, seed=11)
PREFIX_BYTES = 512 * 2**20
# the chunk of arm (e): 128, so a 128-token miss prefills whole (through
# flash) and only longer uncached suffixes stream in chunks
PREFILL_CHUNK = 128
# arm -> (flash prefill, engine options): (a) today's dense prefill, (b)
# flash, (c) flash + prefix cache, (d) dense + prefix cache, (e) flash +
# prefix cache + chunks of PREFILL_CHUNK
PREFILL_ARMS = {
    "a": (False, {}),
    "b": (True, {}),
    "c": (True, dict(prefix_cache_bytes=PREFIX_BYTES)),
    "d": (False, dict(prefix_cache_bytes=PREFIX_BYTES)),
    "e": (True, dict(prefix_cache_bytes=PREFIX_BYTES, prefill_chunk=PREFILL_CHUNK)),
}
# flash arm -> its dense twin, teacher-forced on one request of each length
PREFILL_TF = {"b": "a", "c": "d", "e": "d"}
LIBRARY_NOTE = (
    "no single PyTorch call computes an int8 matmul with dynamic "
    "per-(row, 512-column tile) activation quantization and f32 "
    "accumulation across tiles (torch._int_mm takes one whole-K int8 "
    "product with no per-tile scales)"
)


def draft_host(hist: list, k: int, ngram: int) -> list:
    """``ngram_draft``'s statement on the host, for one history (a list of
    ints, all valid): the latest candidate end ``i < len - 1`` with the
    longest run of trailing-token matches (at most ``ngram``, at least 1)
    drafts the ``k`` tokens after it, a missing one the last token."""
    n = len(hist)
    best, best_len = -1, 0
    for i in range(n - 1):
        m = 0
        while m < ngram and m <= i and hist[i - m] == hist[n - 1 - m]:
            m += 1
        if m and m >= best_len:
            best, best_len = i, m
    return [hist[best + 1 + j] if best >= 0 and best + 1 + j <= n - 1 else hist[-1]
            for j in range(k)]


def replay_spec(prompt: list, tokens: list, new: int, k: int, ngram: int) -> tuple[int, int, int]:
    """(verify steps consumed, least and most drafts accepted) that a
    greedy speculative engine counts for one request of ``new`` tokens,
    replayed on the host from its greedy continuation ``tokens``. Each step
    drafts from the history (:func:`draft_host`), accepts while the draft
    equals the greedy tokens, and appends the accepted drafts and the bonus
    token. The last step may look past the budget: where ``tokens`` ends
    before that step's first mismatch, its accepted drafts lie between the
    matches seen and k. With ``tokens`` at least ``new + k`` long the two
    counts are equal; the steps are exact either way."""
    hist = list(prompt) + [tokens[0]]
    got, steps, lo, hi = 1, 0, 0, 0
    while got < new:
        draft = draft_host(hist, k, ngram)
        n = 0
        while n < k and got + n < len(tokens) and draft[n] == tokens[got + n]:
            n += 1
        steps += 1
        lo += n
        hi += k if n < k and got + n == len(tokens) else n
        hist += tokens[got:got + n + 1]
        got += n + 1
    return steps, lo, hi


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(m: int, k: int, n: int) -> tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes, ops) of one int8_matmul call: x read in
    f32, the int8 weight and f32 scales read once, the f32 output written
    once; 2*M*N*K int8 operations."""
    nbytes = m * k * 4 + k * n + n * 4 + m * n * 4
    ops = 2.0 * m * n * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


# device cycles the card spins after each L2 flush and before a timed
# call (~0.5 ms at 1.98 GHz): the host has queued the call under test
# before the start event fires, so host time cannot leak into a kernel's
# time (a wrapper's Python path can outlast the flush alone)
HOLD_CYCLES = 1_000_000


def quiesce(torch, flush) -> None:
    """Before a timed call: flush the L2 cache (a 256 MB write), then hold
    the card for HOLD_CYCLES."""
    flush.zero_()
    torch.cuda._sleep(HOLD_CYCLES)


def time_ms(fn, torch, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, each after
    ``quiesce`` (the L2 flushed, the card held while the host queues the
    call), outside the timed region."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        quiesce(torch, flush)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_turns_ms(new, old, torch, flush, reps: int = 25, warmup: int = 3) -> list:
    """A kernel against the one it replaces, in turns at the finest grain:
    each of ``reps`` rounds times new, old, old, new (one call each,
    ``quiesce`` before each), so both see the same clock and host state.
    Returns the four positions' medians; new's time is the mean of the
    first and last, old's of the middle two."""
    for _ in range(warmup):
        new()
        old()
    times = [[], [], [], []]
    for _ in range(reps):
        for i, fn in enumerate((new, old, old, new)):
            quiesce(torch, flush)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def warm_card(torch, seconds: float = 2.0) -> float:
    """Bring the card's clocks up from idle before anything is timed: bf16
    matmuls for ``seconds``; returns the seconds spent."""
    a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(8):
            a @ a
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_kernels(torch, quant, gpu: str) -> dict:
    """Phase 2: the kernel against its plain version at every listed shape:
    every 1b (K, N) pair at decode M and at the prefill buckets, through the
    sm90 kernel (two calls bitwise equal, the route counted); at M = 4 and
    the prefill M the v1 kernel too, checked and timed in turns with the
    sm90 one (sm90, v1, v1, sm90); two ragged shapes through v1."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    pairs = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 32000))
    # M 12: serve_1b_spec's verify forward (4 slots x k + 1 = 3 rows)
    shapes = [(m, k, n) for m in (1, 4, 12, 16, 32, 64) + INT8_PREFILL_M for (k, n) in pairs]
    shapes.append((3, 200, 130))  # ragged M and N, K padded to a 256 tile: v1
    shapes.append((5, 201, 67))  # K % 4 != 0: v1's byte-load path
    results = {}
    max_err = 0.0
    for m, k, n in shapes:
        x = torch.randn((m, k), generator=gen, device=dev)
        wq = quant.quantize_int8(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        w = quant.Int8Param(q=wq.q.t().contiguous().t(), scale=wq.scale)
        route = "sm90" if k % 16 == 0 else "v1"
        routes0 = dict(quant.int8_matmul.routes)
        got = quant.int8_matmul(x, w)
        if quant.int8_matmul.routes[route] != routes0[route] + 1:
            raise AssertionError(f"int8_matmul at M={m} K={k} N={n} did not take the "
                                 f"{route} route: {quant.int8_matmul.routes}")
        if route == "sm90" and not torch.equal(got, quant.int8_matmul(x, w)):
            raise AssertionError(f"two sm90 int8_matmul calls differ at M={m} K={k} N={n}")
        want = quant.int8_matmul_reference(x, w)
        in_turns = route == "sm90" and m in (4,) + INT8_PREFILL_M
        checks = [("sm90" if route == "sm90" else "v1", got)]
        if in_turns:
            checks.append(("v1", quant.int8_matmul(x, w, route="v1")))
        torch.cuda.synchronize()
        # expected bitwise; the only admissible difference is a double
        # rounding of the plain version's float64 fma (a few float32 ulps)
        tol = 4 * 2.0**-24 * float(want.abs().max())
        errs = {}
        for name, out in checks:
            err = float((out - want).abs().max())
            errs[name] = {"max_abs_err": err, "n_mismatch": int((out != want).sum())}
            if not err <= tol:
                raise AssertionError(
                    f"int8_matmul {name} kernel != plain at M={m} K={k} N={n}: max abs "
                    f"err {err} > {tol} ({errs[name]['n_mismatch']} elements differ)"
                )
        err = errs[route]["max_abs_err"]
        max_err = max(max_err, err)
        v1 = {}
        if in_turns:
            turns = time_turns_ms(lambda: quant.int8_matmul(x, w),
                                  lambda: quant.int8_matmul(x, w, route="v1"), torch, flush,
                                  reps=25 if m <= 64 else 10)
            ms, v1_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            v1 = {"v1_ms": v1_ms, "turns_ms": turns, "speedup_vs_v1": v1_ms / ms,
                  "errors_v1": errs["v1"]}
        else:
            ms = time_ms(lambda: quant.int8_matmul(x, w), torch, flush)
        plain_ms = time_ms(lambda: quant.int8_matmul_reference(x, w), torch, flush,
                           reps=25 if m <= 64 else 5, warmup=3 if m <= 64 else 1)
        b_ms, b_by, nbytes, ops = bound(m, k, n)
        results[(m, k, n)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, **v1)
        emit({
            "phase": "kernel_vs_plain", "kernel": "int8_matmul", "route": route,
            "M": m, "K": k, "N": n, "block_k": quant.block_k_for(k),
            "plan": quant._sm90_plan(m, k, n, torch.cuda.get_device_properties(0)
                                     .multi_processor_count) if route == "sm90" else None,
            "max_abs_err": err, "n_mismatch": errs[route]["n_mismatch"], "tolerance": tol,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, **v1,
            "bound_by": b_by, "roofline_share": b_ms / ms,
            "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
            "library_ms": None, "library_note": LIBRARY_NOTE, "gpu": gpu,
        })
    # the host's cost of one TMA map of a 1b weight, encoded afresh and
    # through the map cache the sm90 wrapper uses
    lib = quant._build.library("int8_matmul_sm90")
    wq = torch.zeros((2048, 2048), dtype=torch.int8, device=dev)
    encode_ns = {kind: lib.int8_matmul_sm90_encode_ns(wq.data_ptr(), 2048, 2048, 2000, cached)
                 for kind, cached in (("fresh", 0), ("cached", 1))}
    emit({"phase": "tma_map_encode", "kernel": "int8_matmul", "ns_per_map": encode_ns,
          "gpu": gpu})
    return {"results": results, "max_abs_err": max_err, "encode_ns": encode_ns}


def flash_bound(kind: str, b: int, s: int, h: int, d: int, elem: int,
                flops_per_s: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of one flash kernel call: its causal products
    (2 FLOPs per multiply-add over the S(S+1)/2 query-key pairs) at the
    card's peak for the input type, against its bytes — each (B, S, H, D)
    input read once, each output written once, the f32 (B, H, S) lse and
    delta."""
    pairs = b * h * s * (s + 1) / 2
    ops = FLASH_PRODUCTS[kind] * 2.0 * pairs * d
    t = b * s * h * d * elem
    row = b * h * s * 4
    nbytes = {"fwd": 4 * t + row, "dq": 5 * t + 2 * row, "dkv": 6 * t + 2 * row}[kind]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_flash(torch, fa, gpu: str) -> dict:
    """Phase 2 (flash): the forward, dq and dk/dv kernels against their
    plain versions on the same inputs, at every shape of FLASH_SHAPES."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    blocks = (1024, 1024)  # the bench's --block_q/--block_k: the plain blocks
    results, max_err = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    worst = dict(max_err)  # the largest error-to-bound ratio
    for i, (b, s, h, d, dt, strided) in enumerate(FLASH_SHAPES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator(device=dev).manual_seed(10 + i)

        def draw():
            if strided:  # (B, H, S, D) storage seen as (B, S, H, D)
                return torch.randn((b, h, s, d), generator=gen, device=dev,
                                   dtype=dtype).transpose(1, 2)
            return torch.randn((b, s, h, d), generator=gen, device=dev, dtype=dtype)

        q, k, v, do = draw(), draw(), draw(), draw()
        # the route of all three: sm90 for bf16 (fresh allocations, or
        # their transposed views: 16-byte aligned, strides of whole 16 bytes)
        route = "sm90" if dt == "bf16" else "sm80"
        routes0 = {kd: dict(r) for kd, r in fa.flash_attention.routes.items()}
        o, lse = fa.flash_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = fa.flash_dq(q, k, v, do, lse, delta)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
        for kd in ("fwd", "dq", "dkv"):
            if fa.flash_attention.routes[kd][route] != routes0[kd][route] + 1:
                raise AssertionError(f"flash_{kd} at B={b} S={s} H={h} D={d} {dt} did not take "
                                     f"the {route} route: {fa.flash_attention.routes}")
        if route == "sm90" and not (
                all(map(torch.equal, (o, lse), fa.flash_fwd(q, k, v)))
                and torch.equal(dq, fa.flash_dq(q, k, v, do, lse, delta))
                and all(map(torch.equal, (dk, dv), fa.flash_dkv(q, k, v, do, lse, delta)))):
            raise AssertionError(f"two sm90 flash calls differ at B={b} S={s} D={d}")
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, *blocks)
        dq_ref = fa.flash_dq_reference(q, k, v, do, lse, delta, *blocks)
        dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, *blocks)
        checks = [("O", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                  ("dk", dk, dk_ref), ("dv", dv, dv_ref)]
        if i == 0:  # the old kernels on the main shape too, held the same way
            checks += [*zip(("O_v1", "lse_v1"), fa.flash_fwd(q, k, v, route="sm80"),
                            (o_ref, lse_ref)),
                       ("dq_v1", fa.flash_dq(q, k, v, do, lse, delta, route="sm80"), dq_ref),
                       *zip(("dk_v1", "dv_v1"),
                            fa.flash_dkv(q, k, v, do, lse, delta, route="sm80"),
                            (dk_ref, dv_ref))]
        torch.cuda.synchronize()
        # each output held element by element to fa.KERNEL_TOLERANCE
        errs = {}
        for name, got, want in checks:
            errs[name] = fa.kernel_error(got, want)
            if not errs[name]["worst_ratio"] <= 1.0:
                raise AssertionError(
                    f"flash {name} kernel != plain at B={b} S={s} H={h} D={d} {dt}: "
                    f"{errs[name]}"
                )
        for kind, names in (("fwd", ("O", "lse")), ("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            max_err[kind] = max(max_err[kind], *(errs[n]["max_abs_err"] for n in names))
            worst[kind] = max(worst[kind], *(errs[n]["worst_ratio"] for n in names))
        # the library yardstick: SDPA on (B, H, S, D) copies, never used by the port
        ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
        dol = do.transpose(1, 2).contiguous()
        sdpa_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        timed = {
            "fwd": (lambda: fa.flash_fwd(q, k, v),
                    lambda: fa.flash_fwd_reference(q, k, v, *blocks),
                    lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)),
            "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta),
                   lambda: fa.flash_dq_reference(q, k, v, do, lse, delta, *blocks),
                   lambda: torch.autograd.grad(sdpa_out, (ql, kl, vl), dol, retain_graph=True)),
            "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta),
                    lambda: fa.flash_dkv_reference(q, k, v, do, lse, delta, *blocks),
                    None),
        }
        flops = BF16_FLOPS if dt == "bf16" else F32_FLOPS
        for kind, (kern, plain, lib) in timed.items():
            v1 = {}
            if i == 0:
                # the redesign against the old kernel in turns: sm90, old,
                # old, sm90
                old = {"fwd": lambda: fa.flash_fwd(q, k, v, route="sm80"),
                       "dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, route="sm80"),
                       "dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, route="sm80")}[kind]
                turns = [time_ms(fn, torch, flush) for fn in (kern, old, old, kern)]
                ms, v1_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                v1 = {"v1_ms": v1_ms, "turns_ms": turns, "speedup_vs_v1": v1_ms / ms,
                      "errors_v1": {n: errs[n] for n in {"fwd": ("O_v1", "lse_v1"),
                                                         "dq": ("dq_v1",),
                                                         "dkv": ("dk_v1", "dv_v1")}[kind]}}
            else:
                ms = time_ms(kern, torch, flush)
            plain_ms = time_ms(plain, torch, flush)
            lib_ms = time_ms(lib, torch, flush) if lib is not None else results[
                (i, "dq")]["library_ms"]
            b_ms, b_by = flash_bound(kind, b, s, h, d, q.element_size(), flops)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms, **v1)
            results[(i, kind)] = row
            emit({
                "phase": "kernel_vs_plain", "kernel": f"flash_{kind}",
                "B": b, "S": s, "H": h, "D": d, "dtype": dt, "strided_inputs": strided,
                "route": route,
                "errors": {n: errs[n] for n in {"fwd": ("O", "lse"), "dq": ("dq",),
                                                "dkv": ("dk", "dv")}[kind]},
                **row, "roofline_share": b_ms / ms,
                "library": "F.scaled_dot_product_attention(is_causal=True)"
                           + (" forward" if kind == "fwd" else
                              " backward (dq, dk, dv in one call; the same number "
                              "stands for flash_dq and flash_dkv)"),
                "gpu": gpu,
            })
        del ql, kl, vl, sdpa_out
    return {"results": results, "max_abs_err": max_err, "worst_ratio": worst}


def phase_flash_serving(torch, fa, gpu: str) -> dict:
    """Phase 2 (flash, serving shapes): the forward kernel against its
    plain version at FLASH_SERVE_SHAPES, one prefill's attention per
    bucket — f32 through ``fwd_kernel`` (the int8 model's route), bf16
    through ``fwd_sm90_kernel`` (the float model's) — each output held
    element by element to ``KERNEL_TOLERANCE``; times beside the bound and
    SDPA's."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    results = {}
    for i, (b, s, h, d, dt) in enumerate(FLASH_SERVE_SHAPES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator(device=dev).manual_seed(40 + i)
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=dtype)
                   for _ in range(3))
        route = "sm90" if dt == "bf16" else "sm80"
        before = fa.flash_attention.routes["fwd"][route]
        o, lse = fa.flash_fwd(q, k, v)
        if fa.flash_attention.routes["fwd"][route] != before + 1:
            raise AssertionError(f"flash_fwd at S={s} {dt} did not take the {route} route")
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
        torch.cuda.synchronize()
        errs = {"O": fa.kernel_error(o, o_ref), "lse": fa.kernel_error(lse, lse_ref)}
        for name, e in errs.items():
            if not e["worst_ratio"] <= 1.0:
                raise AssertionError(f"flash_fwd {name} kernel != plain at S={s} {dt}: {e}")
        ql, kl, vl = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_fwd(q, k, v), torch, flush)
        plain_ms = time_ms(lambda: fa.flash_fwd_reference(q, k, v), torch, flush)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True),
                         torch, flush)
        b_ms, b_by = flash_bound("fwd", b, s, h, d, q.element_size(),
                                 BF16_FLOPS if dt == "bf16" else F32_FLOPS)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                   worst_ratio=max(e["worst_ratio"] for e in errs.values()), route=route)
        results[(s, dt)] = row
        emit({"phase": "kernel_vs_plain", "kernel": "flash_fwd", "path": "serve_prefill",
              "B": b, "S": s, "H": h, "D": d, "dtype": dt, "errors": errs, **row,
              "roofline_share": b_ms / ms,
              "library": "F.scaled_dot_product_attention(is_causal=True) forward",
              "gpu": gpu})
    return results


def fused_ce_bound(kind: str, n: int, d: int, v: int, elem: int,
                   flops_per_s: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of one fused-loss kernel call: its score
    passes and gradient product (2 N D V FLOPs each) at the card's peak for
    the input type, against its bytes — h and W read once, the int64
    targets, the f32 per-row lse and cotangent (backward) and per-row
    outputs (forward: lse and target logit), dh or dW written once."""
    ops = FUSED_CE_PASSES[kind] * 2.0 * n * d * v
    nbytes = n * d * elem + d * v * elem + 8 * n
    nbytes += {"fwd": 8 * n, "dh": 8 * n + n * d * elem, "dw": 8 * n + d * v * elem}[kind]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_fused_ce(torch, fl, gpu: str) -> dict:
    """Phase 2 (fused loss): the forward, dh and dW kernels against their
    plain versions on the same inputs, at every shape of FUSED_CE_SHAPES;
    the yardstick is the materialized-logits path (cuBLAS h @ W, then
    F.cross_entropy, and that pair's backward), which the port never
    calls."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    results, max_err = {}, {"fwd": 0.0, "dh": 0.0, "dw": 0.0}
    worst = dict(max_err)
    for i, (n, d, v, dt, oor) in enumerate(FUSED_CE_SHAPES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator(device=dev).manual_seed(20 + i)
        h = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        w = (torch.randn((d, v), generator=gen, device=dev) * d ** -0.5).to(dtype)
        y = torch.randint(0, v, (n,), generator=gen, device=dev)
        if oor:
            y[n // 2] = v + 7  # hits nothing: its loss is the lse
        g = torch.full((n,), 1.0 / n, device=dev)  # the mean's cotangent
        # the route of all three: sm90 for bf16 with D, V multiples of 8 (the
        # operands here are fresh allocations, 16-byte aligned)
        route = "sm90" if dt == "bf16" and d % 8 == 0 and v % 8 == 0 else "sm80"
        routes0 = {k: dict(r) for k, r in fl.fused_cross_entropy.routes.items()}
        lse, tgt = fl.fused_ce_fwd(h, w, y)
        dh = fl.fused_ce_dh(h, w, y, lse, g)
        dw = fl.fused_ce_dw(h, w, y, lse, g)
        for k in ("fwd", "dh", "dw"):
            if fl.fused_cross_entropy.routes[k][route] != routes0[k][route] + 1:
                raise AssertionError(f"fused_ce_{k} at N={n} D={d} V={v} {dt} did not take "
                                     f"the {route} route: {fl.fused_cross_entropy.routes}")
        if route == "sm90" and not (all(map(torch.equal, (lse, tgt), fl.fused_ce_fwd(h, w, y)))
                                    and torch.equal(dh, fl.fused_ce_dh(h, w, y, lse, g))
                                    and torch.equal(dw, fl.fused_ce_dw(h, w, y, lse, g))):
            raise AssertionError(f"two sm90 calls differ at N={n} D={d} V={v}")
        lse_ref, tgt_ref = fl.fused_ce_fwd_reference(h, w, y)
        dh_ref = fl.fused_ce_dh_reference(h, w, y, lse, g)
        dw_ref = fl.fused_ce_dw_reference(h, w, y, lse, g)
        checks = [("lse", lse, lse_ref), ("tgt", tgt, tgt_ref), ("dh", dh, dh_ref),
                  ("dw", dw, dw_ref)]
        if i == 0:  # the old kernels on the main shape too, held the same way
            checks += [*zip(("lse_v1", "tgt_v1"), fl.fused_ce_fwd(h, w, y, route="sm80"),
                            (lse_ref, tgt_ref)),
                       ("dh_v1", fl.fused_ce_dh(h, w, y, lse, g, route="sm80"), dh_ref),
                       ("dw_v1", fl.fused_ce_dw(h, w, y, lse, g, route="sm80"), dw_ref)]
        torch.cuda.synchronize()
        errs = {}
        for name, got, want in checks:
            errs[name] = fl.kernel_error(got, want)
            if not errs[name]["worst_ratio"] <= 1.0:
                raise AssertionError(
                    f"fused loss {name} kernel != plain at N={n} D={d} V={v} {dt}: {errs[name]}")
        if oor and float(tgt[n // 2]) != 0.0:
            raise AssertionError("a target out of range hit a column")
        for kind, names in (("fwd", ("lse", "tgt")), ("dh", ("dh",)), ("dw", ("dw",))):
            max_err[kind] = max(max_err[kind], *(errs[x]["max_abs_err"] for x in names))
            worst[kind] = max(worst[kind], *(errs[x]["worst_ratio"] for x in names))
        # the yardstick: materialized logits (targets clamped into range,
        # which F.cross_entropy requires)
        yc = y.clamp(0, v - 1)
        hl, wl = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
        lib_loss = F.cross_entropy((hl @ wl).float(), yc, reduction="none")
        timed = {
            "fwd": (lambda: fl.fused_ce_fwd(h, w, y),
                    lambda: fl.fused_ce_fwd_reference(h, w, y),
                    lambda: F.cross_entropy((h @ w).float(), yc, reduction="none")),
            "dh": (lambda: fl.fused_ce_dh(h, w, y, lse, g),
                   lambda: fl.fused_ce_dh_reference(h, w, y, lse, g),
                   lambda: torch.autograd.grad(lib_loss, (hl, wl), g, retain_graph=True)),
            "dw": (lambda: fl.fused_ce_dw(h, w, y, lse, g),
                   lambda: fl.fused_ce_dw_reference(h, w, y, lse, g),
                   None),
        }
        flops = BF16_FLOPS if dt == "bf16" else F32_FLOPS
        for kind, (kern, plain, lib) in timed.items():
            v1 = {}
            if i == 0:
                # the redesign against the old kernel in turns: sm90, old,
                # old, sm90
                old = {"fwd": lambda: fl.fused_ce_fwd(h, w, y, route="sm80"),
                       "dh": lambda: fl.fused_ce_dh(h, w, y, lse, g, route="sm80"),
                       "dw": lambda: fl.fused_ce_dw(h, w, y, lse, g, route="sm80")}[kind]
                turns = [time_ms(fn, torch, flush, warmup=1) for fn in (kern, old, old, kern)]
                ms, v1_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                v1 = {"v1_ms": v1_ms, "turns_ms": turns, "speedup_vs_v1": v1_ms / ms,
                      "errors_v1": {x: errs[x] for x in {"fwd": ("lse_v1", "tgt_v1"),
                                                          "dh": ("dh_v1",),
                                                          "dw": ("dw_v1",)}[kind]}}
            else:
                ms = time_ms(kern, torch, flush, warmup=1)
            plain_ms = time_ms(plain, torch, flush, warmup=1)
            lib_ms = (time_ms(lib, torch, flush, warmup=1) if lib is not None
                      else results[(i, "dh")]["library_ms"])
            b_ms, b_by = fused_ce_bound(kind, n, d, v, h.element_size(), flops)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms, **v1)
            results[(i, kind)] = row
            emit({
                "phase": "kernel_vs_plain", "kernel": f"fused_ce_{kind}",
                "N": n, "D": d, "V": v, "dtype": dt, "target_out_of_range": oor,
                "route": route,
                "errors": {x: errs[x] for x in {"fwd": ("lse", "tgt"), "dh": ("dh",),
                                                "dw": ("dw",)}[kind]},
                **row, "roofline_share": b_ms / ms,
                "library": "materialized logits: cuBLAS h @ W + F.cross_entropy"
                           + (" forward" if kind == "fwd" else
                              ", that pair's backward (dh and dW in one call; the same "
                              "number stands for fused_ce_dh and fused_ce_dw)"),
                "gpu": gpu,
            })
        del hl, wl, lib_loss, timed
    return {"results": results, "max_abs_err": max_err, "worst_ratio": worst}


def phase_adamw(torch, gpu: str) -> dict:
    """Phase 2 (fused AdamW): the kernel against the plain foreach AdamW
    over leaves of the 760m parameter shapes (219 leaves, 1,006,708,224
    elements), bitwise, at the 10th step (bias corrections != 1);
    yardstick ``torch._fused_adamw_``, whose decay order differs."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw

    dev = torch.device("cuda")
    cfg = TransformerConfig(**PRESET_760M, max_seq_len=2048, dtype=torch.bfloat16,
                            quantized=False)
    shapes = [p.shape for p in TransformerLM(cfg).parameters()]  # meta: no memory
    gen = torch.Generator(device=dev).manual_seed(4)

    def draw(scale=1.0, positive=False):
        out = []
        for s in shapes:
            x = torch.randn(s, generator=gen, device=dev) * scale
            out.append(x.abs_() if positive else x)
        return out

    params, grads = draw(), draw(1e-3)
    mu, nu = draw(1e-3), draw(1e-6, positive=True)
    n_el = sum(p.numel() for p in params)
    tx, plain = fused_adamw(3e-4, weight_decay=0.01), adamw(3e-4, weight_decay=0.01)
    state = tx.init([torch.empty(0, device=dev)])  # moments replaced below
    state.count, state.mu, state.nu = 9, mu, nu
    p_plain = [p.clone() for p in params]
    s_plain = plain.init([torch.empty(0, device=dev)])
    s_plain.count = 9
    s_plain.mu, s_plain.nu = [m.clone() for m in mu], [x.clone() for x in nu]
    tx.update_(params, grads, state)
    plain.update_(p_plain, grads, s_plain)
    torch.cuda.synchronize()
    err, n_bad = 0.0, 0
    for a, b in zip(params + state.mu + state.nu, p_plain + s_plain.mu + s_plain.nu):
        err = max(err, float((a - b).abs().max()))
        n_bad += int((a != b).sum())
    del p_plain, s_plain
    if n_bad:
        raise AssertionError(f"fused_adamw kernel != plain: {n_bad} elements differ, max {err}")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    ms = time_ms(lambda: tx.update_(params, grads, state), torch, flush, warmup=1)
    plain_ms = time_ms(lambda: plain.update_(params, grads, state), torch, flush, warmup=1)
    steps = [torch.tensor(10.0, device=dev) for _ in params]
    lib_ms = time_ms(lambda: torch._fused_adamw_(
        params, grads, state.mu, state.nu, [], steps, lr=3e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False), torch, flush, warmup=1)
    nbytes = 28.0 * n_el  # g, m, v, p read; m, v, p written: f32
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes", library_ms=lib_ms,
               max_abs_err=err, n_mismatch=n_bad)
    emit({
        "phase": "kernel_vs_plain", "kernel": "fused_adamw", "leaves": len(params),
        "elements": n_el, **row, "roofline_share": b_ms / ms,
        "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
        "library": "torch._fused_adamw_ (decays p by (1 - lr wd) first: the nearest "
                   "PyTorch call, not the same function)",
        "gpu": gpu,
    })
    del params, grads, state, mu, nu, steps
    torch.cuda.empty_cache()
    return row


def paged_operands(torch, shape, store: str, q_type: str, seed: int):
    """Paged-attention operands on the card for one PAGED_SHAPES row: a pool
    of the live pages plus 8 spare, shuffled, the sentinel past each row's
    pages and on parked rows; pools stored as ``store`` (quantized by the
    port's KV quantizers)."""
    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
        _quantize_kv,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import quantize_kv_int4

    _, b, s, h, kv, d, ps, p_cap, depths, parked = shape
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    live = [0 if r in parked else -(-(p + s) // ps) for r, p in enumerate(depths)]
    n_pages = sum(live) + 8
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dt[q_type])
    kf, vf = (torch.randn((n_pages, ps, kv, d), generator=gen, device=dev) for _ in range(2))
    kw = {}
    if store == "int8":
        (k, ks), (v, vs) = _quantize_kv(kf), _quantize_kv(vf)
        kw = dict(k_scale=ks, v_scale=vs, quant="int8")
    elif store == "int4":
        (k, ks), (v, vs) = quantize_kv_int4(kf), quantize_kv_int4(vf)
        kw = dict(k_scale=ks, v_scale=vs, quant="int4")
    else:
        k, v = kf.to(dt[store]), vf.to(dt[store])
    perm = torch.randperm(n_pages, generator=gen, device=dev).tolist()
    table = torch.full((b, p_cap), n_pages, dtype=torch.int32)
    for r, n in enumerate(live):
        table[r, :n] = torch.tensor([perm.pop() for _ in range(n)], dtype=torch.int32)
    pos = torch.tensor(depths, dtype=torch.int64, device=dev)
    return q, k, v, table.to(dev), pos, kw, live


def paged_bound(shape, q, k, kw) -> tuple[float, str]:
    """(bound_ms, bound_by) of one paged-attention call, counting what this
    call's depths need: the K/V (and scales) of every kv head at each row's
    positions [0, min(pos + S, window)) read once (a parked row none; the
    masked tail of a row's last page not at all), q read and the output
    written once; against the score and PV products (4 flops per query
    head, head dim and position its query row sees) at the card's float32
    peak."""
    _, b, s, h, kv, d, ps, p_cap, depths, parked = shape
    cap = p_cap * ps
    per_pos = 2 * kv * k.shape[-1] * k.element_size()
    if kw:
        per_pos += 2 * kv * kw["k_scale"].element_size()
    rows = [p for r, p in enumerate(depths) if r not in parked]
    positions = sum(min(p + s, cap) for p in rows)
    seen = sum(min(p + j + 1, cap) for p in rows for j in range(s))
    nbytes = positions * per_pos + 2 * q.numel() * q.element_size()
    ops = 4.0 * seen * h * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_paged(torch, pa, gpu: str) -> dict:
    """Phase 2 (paged attention): the kernel against its plain version on
    the same operands at every PAGED_SHAPES row and pool storage (and bf16
    queries on the 1b-gqa shape), each output element within the bound of
    ``pa.KERNEL_TOLERANCE`` for ``pa.tolerance_type`` (bf16 where p rounds
    to bf16, else q's type), every parked row exactly 0; CUDA
    event times beside the byte bound, and the gather + SDPA pair as a
    note."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    runs = [(shape, store, "f32") for shape in PAGED_SHAPES for store in PAGED_STORES]
    runs += [(PAGED_SHAPES[1], store, "bf16") for store in PAGED_BF16_Q]
    results, max_err, worst = {}, 0.0, 0.0
    for i, (shape, store, q_type) in enumerate(runs):
        name, b, s, h, kv, d, ps, p_cap, depths, parked = shape
        q, k, v, table, pos, kw, live = paged_operands(torch, shape, store, q_type, 40 + i)
        routes0 = dict(pa.paged_attention.routes)
        got = pa.paged_attention(q, k, v, table, pos, **kw)
        n_launch = pa.paged_attention.routes["sm90"] - routes0["sm90"]
        rows_per = pa._rows_per_launch(True, q, k, kw.get("quant"), h // kv, p_cap)
        if (pa.paged_attention.routes["v1"] != routes0["v1"]
                or n_launch != -(-s // rows_per)):
            raise AssertionError(f"paged_attention at {name} {store} q {q_type} did not take "
                                 f"the sm90 route in {-(-s // rows_per)} row blocks: "
                                 f"{pa.paged_attention.routes}")
        if not torch.equal(got, pa.paged_attention(q, k, v, table, pos, **kw)):
            raise AssertionError(f"two sm90 paged_attention calls differ at {name} {store}")
        pps = pa._sm90_plan(b, kv, p_cap)[0]
        # the plain statement of the kernel's split and merge, and the
        # unsplit plain version: the kernel held to both
        want = pa.paged_attention_plain(q, k, v, table, pos, **kw, pages_per_split=pps)
        unsplit = pa.paged_attention_plain(q, k, v, table, pos, **kw)
        main = (name, store, q_type) == PAGED_MAIN
        old_out = pa.paged_attention(q, k, v, table, pos, **kw, route="v1") if main else None
        torch.cuda.synchronize()
        tol_type = pa.tolerance_type(q, v, kw.get("quant"))
        err = pa.kernel_error(got, want, tol_type)
        err_unsplit = pa.kernel_error(got, unsplit, tol_type)
        err_v1 = pa.kernel_error(old_out, unsplit, tol_type) if main else None
        for what, e in (("split plain", err), ("unsplit plain", err_unsplit),
                        ("v1 vs unsplit plain", err_v1)):
            if e is not None and not e["worst_ratio"] <= 1.0:
                raise AssertionError(f"paged_attention kernel != {what} at {name} {store} "
                                     f"q {q_type}: {e}")
        for r in parked:
            if got[r].any():
                raise AssertionError(f"paged_attention: parked row {r} is not 0 at {name}")
        max_err = max(max_err, err["max_abs_err"], err_unsplit["max_abs_err"])
        worst = max(worst, err["worst_ratio"], err_unsplit["worst_ratio"])
        v1 = {}
        if main:
            # the redesign against the v1 kernel in turns: sm90, v1, v1, sm90
            turns = time_turns_ms(
                lambda: pa.paged_attention(q, k, v, table, pos, **kw),
                lambda: pa.paged_attention(q, k, v, table, pos, **kw, route="v1"),
                torch, flush)
            ms, v1_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            v1 = {"v1_ms": v1_ms, "turns_ms": turns, "speedup_vs_v1": v1_ms / ms,
                  "errors_v1": err_v1}
        else:
            ms = time_ms(lambda: pa.paged_attention(q, k, v, table, pos, **kw), torch, flush)
        plain_ms = time_ms(lambda: pa.paged_attention_plain(q, k, v, table, pos, **kw),
                           torch, flush, reps=10, warmup=1)
        note_ms = None
        if not kw and not parked:
            # the grp query heads of a kv head as one (S * grp)-row query:
            # row r is query r // grp, its mask t <= pos + r // grp
            grp = h // kv
            ids = table.long().clamp(max=k.shape[0] - 1).flatten()
            qt = (q.reshape(b, s, kv, grp, d).permute(0, 2, 1, 3, 4)
                  .reshape(b, kv, s * grp, d).to(k.dtype))
            rows = pos[:, None] + torch.arange(s * grp, device=dev) // grp
            mask = (torch.arange(p_cap * ps, device=dev) <= rows[..., None])[:, None]

            def gather_sdpa():
                kg, vg = (x.index_select(0, ids).view(b, p_cap * ps, kv, d).transpose(1, 2)
                          for x in (k, v))
                return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask)

            note_ms = time_ms(gather_sdpa, torch, flush)
        b_ms, b_by = paged_bound(shape, q, k, kw)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   gather_sdpa_ms=note_ms, **v1)
        results[(name, store, q_type)] = row
        pps, splits, stages = pa._sm90_plan(b, kv, p_cap)
        emit({
            "phase": "kernel_vs_plain", "kernel": "paged_attention", "route": "sm90",
            "shape": name, "B": b, "S": s, "H": h, "KV": kv, "D": d, "page_size": ps,
            "pages_per_row": p_cap, "depths": list(depths), "parked_rows": list(parked),
            "live_pages": live, "storage": store, "q": q_type, "errors": err,
            "launches_per_call": n_launch, "query_rows_per_launch": rows_per,
            "errors_vs_unsplit": err_unsplit,
            "tolerance_type": str(tol_type).removeprefix("torch."), **row,
            "roofline_share": b_ms / ms, "library_ms": None,
            "library_note": PAGED_LIBRARY_NOTE,
            "pages_per_split": pps, "stages": stages, "blocks": splits * b * kv,
            "blocks_with_live_pages": kv * sum(-(-n // pps) for n in live if n),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "gpu": gpu,
        })
    return {"results": results, "max_abs_err": max_err, "worst_ratio": worst}


def phase_model(torch, gpu: str) -> None:
    """Phase 3: a 2-layer model at the 1b widths, card against CPU."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        KVCache,
        TransformerConfig,
        TransformerLM,
        bind_params,
        init_quantized_lm,
    )

    cfg = TransformerConfig(**{**PRESET_1B, "n_layers": 2}, quantized=True)
    params = init_quantized_lm(cfg, seed=1, device="cuda")
    on_card, on_cpu = TransformerLM(cfg), TransformerLM(cfg)
    bind_params(on_card, params)
    bind_params(on_cpu, {k: v.cpu() for k, v in params.items()})
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, 32), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (8, 1, 1), generator=g)
    caches = {d: KVCache.zeros(cfg, 1, device=d) for d in ("cuda", "cpu")}
    outs = {"cuda": [], "cpu": []}
    for dev, model in (("cuda", on_card), ("cpu", on_cpu)):
        outs[dev].append(model(prompt.to(dev), caches[dev], prefill=True)[:, -1])
        for tok in steps:  # teacher-forced: both sides read the same tokens
            outs[dev].append(model(tok.to(dev), caches[dev], decode=True)[:, -1])
    # card vs CPU differ in transcendental ulps (cos/sin/exp/pow of two
    # libms); a one-ulp change of an activation can move its int8 code by
    # one step (1/127 of the tile's absmax), which the tolerance covers
    max_diff, scale, greedy_checked, greedy_equal = 0.0, 0.0, 0, 0
    per_step = []
    for a, b in zip(outs["cuda"], outs["cpu"]):
        a = a.cpu()
        d = float((a - b).abs().max())
        per_step.append(d)
        max_diff, scale = max(max_diff, d), max(scale, float(b.abs().max()))
    tol = 2e-2 * scale
    for a, b in zip(outs["cuda"], outs["cpu"]):
        top2 = b.topk(2, dim=-1).values[0]
        if float(top2[0] - top2[1]) > tol:
            greedy_checked += 1
            greedy_equal += int(int(a.argmax()) == int(b.argmax()))
    ok = max_diff <= tol and greedy_equal == greedy_checked
    emit({
        "phase": "model_card_vs_cpu", "layers": 2, "widths": "1b",
        "prefill_tokens": 32, "decode_steps": 8,
        "max_abs_diff": max_diff, "per_step_max_abs_diff": per_step,
        "logit_max_abs": scale, "tolerance": tol,
        "greedy_checked": greedy_checked, "greedy_equal": greedy_equal,
        "ok": ok, "gpu": gpu,
    })
    if not ok:
        raise AssertionError("model logits on the card disagree with the CPU")


@contextlib.contextmanager
def real_syncs(torch):
    """The synchronizing CUDA calls made inside the block, counted by
    PyTorch's sync debug mode (``bench.harness.count_host_syncs``): yields
    a dict that holds, when the block ends, ``count`` and ``sites`` (each
    call site ``file:line`` with its count)."""
    from pytorch_distributed_training_tutorials_tpu_torch.bench.harness import (
        count_host_syncs,
    )

    out = {}
    with count_host_syncs(torch) as got:
        yield out
    out["count"] = got[0]
    out["sites"] = dict(collections.Counter(got[1:]))


def percentile(vals, q: float) -> float:
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def profile_chain(torch, engine, mk_request, gpu: str, label: str = "serve_1b") -> None:
    """Where a decode chain's time goes: ``torch.profiler`` over one
    ``step()`` that runs a chain of ``tokens_per_launch`` decode steps on 4
    active slots (no prefill inside). Device time by kernel name, the
    device's busy and idle share of the step's wall time, kernels per
    decode step."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(engine.n_slots):
        engine.submit(mk_request(100 + i))
    engine.step()  # the prefills and a first chain, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    engine.run_until_idle()
    events = prof.key_averages()
    kernels = [
        e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    cpu_ops = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda e: -e.self_cpu_time_total,
    )[:10]
    emit({
        "phase": "profile_decode_chain", "of": label,
        "decode_steps": engine.tokens_per_launch,
        "slots_active": engine.n_slots, "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_decode_step":
            sum(e.count for e in kernels) / engine.tokens_per_launch,
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
        "top_host_ops_self_ms": {
            e.key[:80]: [e.self_cpu_time_total / 1e3, e.count] for e in cpu_ops
        },
        "gpu": gpu,
    })


def phase_serve(torch, quant, gpu: str) -> int:
    """Phase 4: the 1b preset at full depth through ServeEngine. Returns
    the kernel launches of the timed stream."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        generate,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    cfg = TransformerConfig(**PRESET_1B, quantized=True)
    t0 = time.perf_counter()
    params = init_quantized_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = TransformerLM(cfg)
    n_slots, tpl, new, n_req = 4, 8, 32, 12
    engine = ServeEngine(model, params, n_slots=n_slots, tokens_per_launch=tpl,
                         max_queue=64, device="cuda")
    window = cfg.max_seq_len
    lengths = sorted({16, min(32, window - new), min(48, window - new)})
    rng = np.random.Generator(np.random.PCG64(11))

    def mk_request(i: int) -> Request:
        p_len = lengths[i % len(lengths)]
        prompt = rng.integers(0, cfg.vocab_size, (p_len,)).tolist()
        return Request(prompt=prompt, max_new_tokens=new, seed=i)

    engine.submit(mk_request(0))  # warmup: first launches, cuBLAS handles
    engine.run_until_idle()
    torch.cuda.synchronize()
    base = (engine.n_prefills, engine.n_chains, engine.n_host_syncs)
    torch.cuda.reset_peak_memory_stats()
    reqs = [mk_request(len(lengths) + i) for i in range(n_req)]
    quant.int8_matmul.launches = 0
    quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
    t0 = time.perf_counter()
    with real_syncs(torch) as real:
        for r in reqs:
            engine.submit(r)
        done = engine.run_until_idle()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = quant.int8_matmul.launches
    routes = dict(quant.int8_matmul.routes)
    prefills = engine.n_prefills - base[0]
    chains = engine.n_chains - base[1]
    syncs = engine.n_host_syncs - base[2]
    peak = torch.cuda.max_memory_allocated()
    forwards = prefills + chains * tpl
    per_forward = 16 * 7 + 1
    if len(done) != n_req:
        raise AssertionError(f"{len(done)} completions for {n_req} requests")
    for c in done:
        if c.finish_reason != "length" or len(c.tokens) != new:
            raise AssertionError(
                f"request {c.request_id}: {c.finish_reason} with "
                f"{len(c.tokens)} tokens, want length with {new}"
            )
    if launches != per_forward * forwards:
        raise AssertionError(
            f"int8_matmul launched {launches} times, want {per_forward} x "
            f"({prefills} prefills + {chains} chains x {tpl}) = "
            f"{per_forward * forwards}"
        )
    if routes != {"sm90": launches, "v1": 0}:
        raise AssertionError(f"int8_matmul routes {routes}: every one of the {launches} "
                             "calls must take the sm90 route")
    if syncs != chains + prefills:
        raise AssertionError(
            f"{syncs} host syncs != {chains} chains + {prefills} prefills"
        )
    if real["count"] > syncs:
        raise AssertionError(f"{real['count']} stream syncs (sync debug mode) > the {syncs} "
                             f"budgeted: {real['sites']}")
    by_id = {c.request_id: c for c in done}
    checked = []
    for r in reqs[:2]:
        ref = generate(model, None, [r.prompt], new, device="cuda")
        ref = ref[0, len(r.prompt):].tolist()
        if by_id[r.request_id].tokens != ref:
            raise AssertionError(
                f"request {r.request_id}: engine {by_id[r.request_id].tokens} "
                f"!= generate {ref}"
            )
        checked.append(r.request_id)
    profile_chain(torch, engine, mk_request, gpu)
    toks = sum(len(c.tokens) for c in done)
    lat = [c.latency_s for c in done]
    ttft = [c.ttft_s for c in done]
    emit({
        "phase": "serve_1b", "preset": "1b", "layers": cfg.n_layers,
        "n_slots": n_slots, "tokens_per_launch": tpl, "requests": n_req,
        "prompt_lengths": lengths, "new_tokens": new,
        "completed": len(done), "generated_tokens": toks,
        "prefills": prefills, "chains": chains, "decode_steps": chains * tpl,
        "int8_matmul_launches": launches, "int8_matmul_routes": routes,
        "launches_per_forward": per_forward, "host_syncs": syncs,
        "stream_syncs": real["count"], "stream_sync_sites": real["sites"],
        "checked_vs_generate": checked,
        "wall_s": wall_s, "aggregate_tok_s": toks / wall_s,
        "latency_p50_s": percentile(lat, 0.5),
        "latency_p95_s": percentile(lat, 0.95),
        "ttft_p50_s": percentile(ttft, 0.5),
        "ttft_p95_s": percentile(ttft, 0.95),
        "max_memory_allocated_bytes": peak, "weights_init_s": init_s,
        "gpu": gpu,
    })
    return {"launches": launches, "routes": routes}


def tf_compare(ref, got) -> dict:
    """Teacher-forced logits ``got`` against ``ref`` (one row per step): the
    worst step's max |difference| as a share of ``ref``'s largest |logit|,
    held to TF_LOGIT_BOUND, and the same argmax wherever ``ref``'s top-2 gap
    is wider than the bound."""
    diff = (ref - got).abs().amax(-1)
    scale = float(ref.abs().max())
    top2 = ref.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    agree = ref.argmax(-1) == got.argmax(-1)
    clear = gap > TF_LOGIT_BOUND * scale
    first = None if bool(agree.all()) else int((~agree).nonzero()[0])
    share = float(diff.max()) / scale
    return {
        "per_step_max_abs_logit_diff": diff.tolist(),
        "steps_bitwise_equal": int((diff == 0).sum()),
        "max_abs_logit_diff": float(diff.max()), "logit_max_abs": scale,
        "diff_share": share, "bound_share": TF_LOGIT_BOUND,
        "argmax_agree_steps": int(agree.sum()), "first_argmax_disagreement": first,
        "ref_top2_gap_there": None if first is None else float(gap[first]),
        "ref_top2_gap_min": float(gap.min()), "clear_steps": int(clear.sum()),
        "ok": share <= TF_LOGIT_BOUND and bool(agree[clear].all()),
    }


def greedy_held(logits, tokens: list) -> dict:
    """A greedy stream's own ``tokens`` held to the teacher-forced
    ``logits`` on them (row i the logits that chose ``tokens[i]``): each
    token must be its row's argmax wherever the row's top-2 gap is wider
    than TF_LOGIT_BOUND of the logits' largest |value| (``tf_compare``'s
    near-tie rule)."""
    scale = float(logits.abs().max())
    top2 = logits.topk(2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > TF_LOGIT_BOUND * scale).tolist()
    agree = [a == int(t) for a, t in zip(logits.argmax(-1).tolist(), tokens)]
    wrong = [i for i, (c, a) in enumerate(zip(clear, agree)) if c and not a]
    return {"steps": len(tokens), "clear_steps": sum(clear),
            "argmax_agree_steps": sum(agree),
            "first_clear_disagreement": wrong[0] if wrong else None, "ok": not wrong}


@contextlib.contextmanager
def planted_fault(kind: str):
    """A fault the teacher-forced gate must catch: every paged refill
    installs its table with the first page replaced — by a page the request
    does not own, holding another request's K/V (``wrong_page``), or by the
    sentinel, so the read skips it (``dropped_page``)."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import engine as mod

    real = mod.write_slot_paged

    def faulty(state, flat, pages, slot, *rest):
        real(state, flat, pages, slot, *rest)
        n = state.cache.n_pages
        state.cache.table[slot, 0] = (
            n if kind == "dropped_page" else next(p for p in range(n) if p not in pages))

    mod.write_slot_paged = faulty
    try:
        yield
    finally:
        mod.write_slot_paged = real


def phase_serve_paged(torch, pa, gpu: str) -> dict:
    """The paged serving slice: the 1b-gqa preset at full depth and width,
    int8 weights, window 4096, through ``ServeEngine`` on the paged stream
    (PAGED_STREAM), arm by arm (PAGED_ARMS), each with its gates; then
    the kernel arms teacher-forced against the gather (TF_PAIRS), the
    lower-precision controls and the planted faults (TF_FAULTS). Returns
    the kernel launches of arm (c), the main path, and every arm's line."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        PoolExhausted,
        Request,
        ServeEngine,
    )

    st = PAGED_STREAM
    cfg = TransformerConfig(**PRESET_1B_GQA, quantized=True)
    t0 = time.perf_counter()
    params = init_quantized_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = TransformerLM(cfg)
    rng = np.random.Generator(np.random.PCG64(12))

    def prompt(i: int) -> list[int]:
        return rng.integers(0, cfg.vocab_size, (st["prompts"][i % 3],)).tolist()

    prompts = [prompt(i) for i in range(st["requests"])]
    shed_prompt = rng.integers(0, cfg.vocab_size, (st["shed_prompt"],)).tolist()

    def mk_request(i: int) -> Request:
        return Request(prompt=prompt(i), max_new_tokens=st["new"], seed=i)

    def engine(options: dict):
        kw = dict(options)
        if kw.get("paged"):
            kw.update(page_size=st["page_size"], pool_pages=st["pool_pages"])
        return ServeEngine(model, params, n_slots=st["n_slots"],
                           tokens_per_launch=st["tokens_per_launch"], max_queue=64,
                           device="cuda", **kw)

    for arm in ("a", "c"):  # warmup: first launches, cuBLAS handles
        warm = engine(PAGED_ARMS[arm])
        warm.submit(mk_request(99))
        warm.run_until_idle()
        del warm
    torch.cuda.synchronize()
    tokens, summary, kept, problems = {}, {}, {}, []
    tpl = st["tokens_per_launch"]
    for arm, options in PAGED_ARMS.items():
        eng = engine(options)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pa.paged_attention.launches = 0
        pa.paged_attention.routes = {"sm90": 0, "v1": 0}
        quant.int8_matmul.launches = 0
        quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
        t0 = time.perf_counter()
        with real_syncs(torch) as real:
            ids = [eng.submit(Request(prompt=p, max_new_tokens=st["new"], seed=i))
                   for i, p in enumerate(prompts)]
            done = eng.run_until_idle()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = pa.paged_attention.launches
        routes = {"paged_attention": dict(pa.paged_attention.routes),
                  "int8_matmul": dict(quant.int8_matmul.routes)}
        peak = torch.cuda.max_memory_allocated()
        by_id = {c.request_id: c for c in done}
        tokens[arm] = [by_id[i].tokens if i in by_id else None for i in ids]
        bad = []
        if len(done) != st["requests"] or any(
                c.finish_reason != "length" or len(c.tokens) != st["new"] for c in done):
            bad.append(f"not every request finished 'length' with {st['new']} tokens")
        if eng.n_host_syncs != eng.n_chains + eng.n_prefills:
            bad.append(f"{eng.n_host_syncs} host syncs != {eng.n_chains} chains + "
                       f"{eng.n_prefills} prefills")
        if real["count"] > eng.n_host_syncs:
            bad.append(f"{real['count']} stream syncs > the {eng.n_host_syncs} budgeted: "
                       f"{real['sites']}")
        steps = eng.n_chains * tpl
        want_launches = cfg.n_layers * steps if options.get("paged_kernel") else 0
        if launches != want_launches:
            bad.append(f"paged_attention launched {launches} times, want {want_launches}")
        for kern, calls in (("paged_attention", launches),
                            ("int8_matmul", quant.int8_matmul.launches)):
            if routes[kern] != {"sm90": calls, "v1": 0}:
                bad.append(f"{kern} routes {routes[kern]}: every one of its {calls} calls "
                           "must take the sm90 route")
        stats = eng.page_stats()
        shed = None
        if options:
            if stats["pages_in_use"] != 0:
                bad.append(f"{stats['pages_in_use']} pages leaked")
            if stats["pages_high_water"] > st["pool_pages"]:
                bad.append(f"high_water {stats['pages_high_water']} > {st['pool_pages']}")
            if stats["page_bytes"] != PAGE_BYTES[stats["kv_bits"]]:
                bad.append(f"page_bytes {stats['page_bytes']} != {PAGE_BYTES[stats['kv_bits']]}")
            try:
                eng.submit(Request(prompt=shed_prompt, max_new_tokens=st["new"]))
                bad.append(f"a {st['shed_prompt']}-token prompt was admitted")
            except PoolExhausted:
                shed = True
        if arm == "b" and tokens["b"] != tokens["a"]:
            bad.append("gather tokens != whole-slot tokens")
        toks = sum(len(c.tokens) for c in done)
        lat, ttft = [c.latency_s for c in done], [c.ttft_s for c in done]
        row = {
            "phase": "serve_1b_paged", "arm": arm, "options": options,
            "preset": "1b-gqa", "layers": cfg.n_layers, "max_seq_len": cfg.max_seq_len,
            **{k: st[k] for k in ("n_slots", "tokens_per_launch", "requests", "new")},
            "prompt_lengths": list(st["prompts"]), "completed": len(done),
            "generated_tokens": toks, "prefills": eng.n_prefills, "chains": eng.n_chains,
            "decode_steps": steps, "host_syncs": eng.n_host_syncs,
            "stream_syncs": real["count"], "stream_sync_sites": real["sites"],
            "paged_attention_launches": launches, "routes": routes, "shed_ok": shed,
            "wall_s": wall_s, "aggregate_tok_s": toks / wall_s,
            "latency_p50_s": percentile(lat, 0.5), "latency_p95_s": percentile(lat, 0.95),
            "ttft_p50_s": percentile(ttft, 0.5), "ttft_p95_s": percentile(ttft, 0.95),
            "max_memory_allocated_bytes": peak, "page_stats": stats,
            "weights_init_s": init_s, "ok": not bad, "problems": bad, "gpu": gpu,
        }
        emit(row)
        problems += [f"arm {arm}: {x}" for x in bad]
        summary[arm] = row
        if arm == "c":
            profile_chain(torch, eng, mk_request, gpu, label="serve_1b_paged arm c")
        if arm != "a":
            kept[arm] = eng
        del eng
    if problems:
        raise AssertionError("; ".join(problems))
    # each kernel arm against the gather at its KV storage, teacher-forced
    # on (b)'s tokens: the f32 kernel and the float64 gather differ by
    # float32 ulps, which the int8 activation quantization can turn into a
    # code step (ROADMAP.md section C), and a token then flips on a near
    # tie; so the gate holds logits, not tokens
    kept.update({g: engine(o) for g, o in TF_GATHER.items()})
    refs, shares = {}, {}

    def held(kind: str, arm: str, ref: str, i: int, got) -> dict:
        """Emit and return the teacher-forced record of ``got``, arm's
        logits on request i, against the gather engine ``ref``'s."""
        if (ref, i) not in refs:
            refs[ref, i] = kept[ref].teacher_forced_logits(prompts[i], tokens["b"][i])
        rec = {"phase": "serve_1b_paged_teacher_forced", "kind": kind, "arm": arm,
               "ref": ref, "request": i, "prompt_len": len(prompts[i]),
               "steps": len(tokens["b"][i]), **tf_compare(refs[ref, i], got), "gpu": gpu}
        if arm == "c":
            rec["first_divergent_token"] = next((j for j, (x, y) in enumerate(
                zip(tokens["b"][i], tokens["c"][i])) if x != y), None)
        emit(rec)
        key = f"{kind} {arm} vs {ref}"
        shares[key] = max(shares.get(key, 0.0), rec["diff_share"])
        return rec

    for arm, (ref, n_req) in TF_PAIRS.items():
        for i in range(n_req or len(prompts)):
            got = kept[arm].teacher_forced_logits(prompts[i], tokens["b"][i])
            if not held("gate", arm, ref, i, got)["ok"]:
                problems.append(f"arm {arm}: request {i}'s teacher-forced logits "
                                f"outside the bound of the gather's ({ref})")
            if arm != "c":  # lower-precision control: quantized KV against f32
                held("control", arm, "b", i, got)
    for kind in TF_FAULTS:
        with planted_fault(kind):
            got = kept["c"].teacher_forced_logits(prompts[1], tokens["b"][1])
        if held(kind, "c", "b", 1, got)["ok"]:
            problems.append(f"the teacher-forced gate passed a planted {kind}")
    spec_row = paged_spec_arm(torch, pa, quant, engine, prompts, st, cfg, tokens, held, gpu)
    problems += [f"serve_1b_gqa_paged_spec: {x}" for x in spec_row["problems"]]
    kept.clear()
    refs.clear()
    if problems:
        raise AssertionError("; ".join(problems))
    pb = {a: summary[a]["page_stats"]["page_bytes"] for a in ("c", "d", "e")}
    emit({"phase": "serve_1b_paged_summary", "page_bytes": pb,
          "int4_half_of_int8": 2 * pb["e"] == pb["d"],
          "tokens_b_equal_a": tokens["b"] == tokens["a"],
          "tokens_c_equal_b": tokens["c"] == tokens["b"],
          "requests_with_tokens_c_equal_b": sum(x == y for x, y in zip(tokens["c"], tokens["b"])),
          "requests_with_tokens_d_equal_c": sum(x == y for x, y in zip(tokens["d"], tokens["c"])),
          "requests_with_tokens_e_equal_c": sum(x == y for x, y in zip(tokens["e"], tokens["c"])),
          "requests_with_tokens_spec_equal_c": sum(
              x == y for x, y in zip(tokens["spec"], tokens["c"])),
          "teacher_forced_max_diff_share": shares, "bound_share": TF_LOGIT_BOUND,
          "gpu": gpu})
    return {"launches": summary["c"]["paged_attention_launches"],
            "routes": summary["c"]["routes"]["paged_attention"], "arms": summary,
            "spec": {k: spec_row[k] for k in ("paged_attention_launches", "routes",
                                                 "n_verify_forwards")},
            "spec_int8": spec_row["int8_matmul_launches"]}


def paged_spec_arm(torch, pa, quant, engine, prompts, st, cfg, tokens, held, gpu) -> dict:
    """``serve_1b_gqa_paged_spec``: the paged stream through arm (c)'s
    engine (paged kernel, f32 pool) with ``speculative_k=SPEC_K`` and
    ``pipeline_depth=2``. Gates: every request finishes; one paged launch
    a layer a verify forward (its k+1 query rows fit one launch) and 113
    int8 calls a forward, all sm90; host syncs chains + prefills, stream
    syncs no more; no page leaked; one request of each prompt length
    teacher-forced in verify-shaped forwards (k+1 rows a forward) within
    TF_LOGIT_BOUND of the f32 gather's logits on (b)'s tokens; every
    request's own tokens greedy (``greedy_held``) under the same engine's
    verify-shaped teacher-forced logits on them, and ``spec_stats()``
    within the host replay (``replay_spec``) over those tokens. Returns its
    line."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request

    t_arm = time.perf_counter()
    layers = cfg.n_layers
    options = dict(PAGED_ARMS["c"], speculative_k=SPEC_K, spec_ngram=SPEC_NGRAM,
                   pipeline_depth=2)
    eng = engine(options)
    warm = engine(options)  # the first verify-shaped launches, outside the timing
    warm.submit(Request(prompt=prompts[0], max_new_tokens=st["new"], seed=99))
    warm.run_until_idle()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0
    pa.paged_attention.routes = {"sm90": 0, "v1": 0}
    quant.int8_matmul.launches = 0
    quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
    t0 = time.perf_counter()
    with real_syncs(torch) as real:
        ids = [eng.submit(Request(prompt=p, max_new_tokens=st["new"], seed=i))
               for i, p in enumerate(prompts)]
        done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, int8_calls = pa.paged_attention.launches, quant.int8_matmul.launches
    routes = {"paged_attention": dict(pa.paged_attention.routes),
              "int8_matmul": dict(quant.int8_matmul.routes)}
    by_id = {c.request_id: c for c in done}
    tokens["spec"] = [by_id[i].tokens if i in by_id else None for i in ids]
    sstats, stats = eng.spec_stats(), eng.page_stats()
    verify = sstats["n_verify_forwards"]
    bad = []
    if len(done) != st["requests"] or any(
            c.finish_reason != "length" or len(c.tokens) != st["new"] for c in done):
        bad.append(f"not every request finished 'length' with {st['new']} tokens")
    if launches != layers * verify:
        bad.append(f"paged_attention launched {launches} times, want {layers} x {verify} "
                   "verify forwards (one launch of k+1 rows a layer)")
    if int8_calls != (layers * 7 + 1) * (eng.n_prefills + verify):
        bad.append(f"int8_matmul launched {int8_calls} times, want {layers * 7 + 1} x "
                   f"({eng.n_prefills} prefills + {verify} verify forwards)")
    for kern, calls in (("paged_attention", launches), ("int8_matmul", int8_calls)):
        if routes[kern] != {"sm90": calls, "v1": 0}:
            bad.append(f"{kern} routes {routes[kern]}: every one of its {calls} calls sm90")
    if eng.n_host_syncs != eng.n_chains + eng.n_prefills:
        bad.append(f"{eng.n_host_syncs} host syncs != {eng.n_chains} chains + "
                   f"{eng.n_prefills} prefills")
    if real["count"] > eng.n_host_syncs:
        bad.append(f"{real['count']} stream syncs > the {eng.n_host_syncs} budgeted: "
                   f"{real['sites']}")
    if stats["pages_in_use"] != 0 or stats["pages_high_water"] > st["pool_pages"]:
        bad.append(f"pages: {stats}")
    shares = []
    for i in range(len(st["prompts"])):
        got = eng.teacher_forced_logits(prompts[i], tokens["b"][i], rows=SPEC_K + 1)
        rec = held("gate", "spec", "b", i, got)
        shares.append(rec["diff_share"])
        if not rec["ok"]:
            bad.append(f"request {i}'s verify-shaped teacher-forced logits outside the bound "
                       "of the gather's")
    # the speculative stream's own tokens, teacher-forced through the same
    # engine in verify-shaped forwards, one request alone in a fresh slot:
    # a fault of the stream (a wrong rewind, a corrupted history, a junk
    # chain writing into pages handed on) emits tokens that are not greedy
    # the drafts replayed on the host over the same tokens: the steps
    # exact, the accepted drafts within the bounds the budget leaves
    replay = [replay_spec(p, t, st["new"], SPEC_K, SPEC_NGRAM)
              for p, t in zip(prompts, tokens["spec"])]
    want = [sum(r[j] for r in replay) for j in range(3)]
    if (sstats["spec_steps_consumed"] != want[0]
            or not want[1] <= sstats["spec_drafts_accepted"] <= want[2]):
        bad.append(f"spec_stats {sstats} outside the host replay's (steps, least and most "
                   f"accepted) {want}")
    greedy = []
    for i in range(st["requests"]):
        logits = eng.teacher_forced_logits(prompts[i], tokens["spec"][i], rows=SPEC_K + 1)
        greedy.append(greedy_held(logits, tokens["spec"][i]))
        if not greedy[-1]["ok"]:
            bad.append(f"request {i}'s speculative tokens are not greedy under their own "
                       f"teacher-forced logits: {greedy[-1]}")
    toks = sum(len(c.tokens) for c in done)
    lat, ttft = [c.latency_s for c in done], [c.ttft_s for c in done]
    row = {
        "phase": "serve_1b_gqa_paged_spec", "options": options, "preset": "1b-gqa",
        "layers": layers, "max_seq_len": cfg.max_seq_len,
        **{k: st[k] for k in ("n_slots", "tokens_per_launch", "requests", "new")},
        "prompt_lengths": list(st["prompts"]), "completed": len(done),
        "generated_tokens": toks, "prefills": eng.n_prefills, "chains": eng.n_chains,
        "n_verify_forwards": verify, "spec_stats": sstats,
        "pipeline_stats": eng.pipeline_stats(), "host_syncs": eng.n_host_syncs,
        "stream_syncs": real["count"], "stream_sync_sites": real["sites"],
        "paged_attention_launches": launches, "int8_matmul_launches": int8_calls,
        "routes": routes, "teacher_forced_max_diff_share": max(shares),
        "bound_share": TF_LOGIT_BOUND, "replay_steps_accepted_bounds": want,
        "greedy_own_tokens": {"requests_ok": sum(g["ok"] for g in greedy),
                              "steps": sum(g["steps"] for g in greedy),
                              "clear_steps": sum(g["clear_steps"] for g in greedy),
                              "argmax_agree_steps": sum(g["argmax_agree_steps"]
                                                        for g in greedy)},
        "wall_s": wall_s, "aggregate_tok_s": toks / wall_s,
        "latency_p50_s": percentile(lat, 0.5), "latency_p95_s": percentile(lat, 0.95),
        "ttft_p50_s": percentile(ttft, 0.5), "ttft_p95_s": percentile(ttft, 0.95),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "page_stats": stats, "arm_seconds": time.perf_counter() - t_arm,
        "ok": not bad, "problems": bad, "gpu": gpu,
    }
    emit(row)
    return row


def prefill_prompts(vocab: int, n: int) -> list:
    """The stream's prompts, as ``examples/serve_llm_int8.py`` makes them:
    PCG64(seed), one shared family of the longest prompt's length, request
    i's prompt = shared[:round(overlap * p_len)] + its own tail."""
    import numpy as np

    st = PREFILL_STREAM
    rng = np.random.Generator(np.random.PCG64(st["seed"]))
    shared = rng.integers(0, vocab, (max(st["prompts"]),)).tolist()
    out = []
    for i in range(n):
        p_len = st["prompts"][i % len(st["prompts"])]
        k = min(p_len, int(round(st["overlap"] * p_len)))
        out.append(shared[:k] + rng.integers(0, vocab, (p_len - k,)).tolist())
    return out


def profile_device_ms(torch, fn) -> tuple[float, int]:
    """Device busy ms and kernel count of one call of ``fn``
    (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in kernels) / 1e3, sum(e.count for e in kernels)


def phase_serve_prefill(torch, fa, gpu: str) -> dict:
    """The prefill slice: the 1b preset at full width and depth through
    ``ServeEngine`` on PREFILL_STREAM, arm by arm (PREFILL_ARMS), each with
    its launch, route, counter and sync gates; (d) token-identical to
    (a), the flash arms teacher-forced against their dense twins
    (PREFILL_TF); (f) the paged leg on the 1b-gqa preset (the paged
    kernel, the prefix cache, serve_1b_paged's pool); (g) the float arm
    (``init_lm`` 1b in bf16, flash prefill on the sm90 route, against the
    same model with dense prefill). Then one prefill per bucket, dense
    against flash, in turns. Returns the flash launches per arm."""
    import dataclasses

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        KVCache,
        TransformerConfig,
        TransformerLM,
        bind_params,
        generate,
        init_lm,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as pa
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    st = PREFILL_STREAM
    cfg = TransformerConfig(**PRESET_1B, quantized=True)
    t0 = time.perf_counter()
    params = init_quantized_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    models = {False: TransformerLM(cfg),
              True: TransformerLM(dataclasses.replace(cfg, attention_fn=fa.flash_attention))}
    n_lens = len(st["prompts"])
    prompts = prefill_prompts(cfg.vocab_size, n_lens + st["requests"])
    warm, timed = prompts[:n_lens], prompts[n_lens:]
    tpl, layers = st["tokens_per_launch"], cfg.n_layers

    for m in models.values():
        bind_params(m, params)  # both models hold the same weight tensors

    def engine(model, **kw):
        return ServeEngine(model, None, n_slots=st["n_slots"], tokens_per_launch=tpl,
                           max_queue=64, device="cuda", **kw)
    # warmup, outside the timed streams: one request per bucket on each
    # model through every refill path (prefill, splice, chunks)
    for flash in (False, True):
        w = engine(models[flash], prefix_cache_bytes=PREFIX_BYTES, prefill_chunk=PREFILL_CHUNK)
        for i, p in enumerate(warm + warm[:1]):
            w.submit(Request(prompt=p, max_new_tokens=st["new"], seed=100 + i))
        w.run_until_idle()
        del w
    torch.cuda.synchronize()

    def counters():
        fa.flash_attention.launches["fwd"] = 0
        fa.flash_attention.routes["fwd"] = {"sm90": 0, "sm80": 0}
        quant.int8_matmul.launches = 0
        quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
        pa.paged_attention.launches = 0
        pa.paged_attention.routes = {"sm90": 0, "v1": 0}

    def serve(eng, reqs, seed0=0):
        """Submit, drain, time; the stream's numbers and gates' inputs."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counters()
        t0 = time.perf_counter()
        with real_syncs(torch) as real:
            ids = [eng.submit(Request(prompt=p, max_new_tokens=st["new"], seed=seed0 + i))
                   for i, p in enumerate(reqs)]
            done = eng.run_until_idle()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        by_id = {c.request_id: c for c in done}
        toks = sum(len(c.tokens) for c in done)
        lat, ttft = [c.latency_s for c in done], [c.ttft_s for c in done]
        return {
            "tokens": [by_id[i].tokens if i in by_id else None for i in ids],
            "completed": len(done),
            "all_length": all(c.finish_reason == "length" and len(c.tokens) == st["new"]
                              for c in done),
            "flash_fwd_launches": fa.flash_attention.launches["fwd"],
            "flash_fwd_routes": dict(fa.flash_attention.routes["fwd"]),
            "int8_matmul_launches": quant.int8_matmul.launches,
            "int8_matmul_routes": dict(quant.int8_matmul.routes),
            "paged_attention_launches": pa.paged_attention.launches,
            "paged_attention_routes": dict(pa.paged_attention.routes),
            "refills": dict(eng.refills), "prefills": eng.n_prefills,
            "splices": eng.n_splices, "chunks": eng.n_chunks, "chains": eng.n_chains,
            "host_syncs": eng.n_host_syncs, "prefix_stats": eng.prefix_stats(),
            "stream_syncs": real["count"], "stream_sync_sites": real["sites"],
            "wall_s": wall_s, "generated_tokens": toks, "aggregate_tok_s": toks / wall_s,
            "latency_p50_s": percentile(lat, 0.5), "latency_p95_s": percentile(lat, 0.95),
            "ttft_p50_s": percentile(ttft, 0.5), "ttft_p95_s": percentile(ttft, 0.95),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        }

    def gates(row, flash: bool, n_req: int, f32: bool = True) -> list:
        bad = []
        rf = row["refills"]
        if row["completed"] != n_req or not row["all_length"]:
            bad.append(f"not every request finished 'length' with {st['new']} tokens")
        want = layers * rf["prefill"] if flash else 0
        if row["flash_fwd_launches"] != want:
            bad.append(f"flash_fwd launched {row['flash_fwd_launches']} times, want {layers} "
                       f"x {rf['prefill']} whole prefills = {want}" if flash else
                       f"flash_fwd launched {row['flash_fwd_launches']} times in a dense arm")
        route = "sm80" if f32 else "sm90"
        if row["flash_fwd_routes"][route] != row["flash_fwd_launches"]:
            bad.append(f"flash_fwd routes {row['flash_fwd_routes']}: every launch must take "
                       f"the {route} route")
        calls = row["int8_matmul_launches"]
        if f32 and row["int8_matmul_routes"] != {"sm90": calls, "v1": 0}:
            bad.append(f"int8_matmul routes {row['int8_matmul_routes']}: every call sm90")
        sync_budget = (row["chains"] + rf["prefill"] + rf["splice"] + rf["chunked"]
                       + rf["chunked_splice"])
        if row["host_syncs"] != sync_budget:
            bad.append(f"{row['host_syncs']} host syncs != {row['chains']} chains + "
                       f"{rf['prefill']} prefills + {rf['splice']} splices + "
                       f"{rf['chunked'] + rf['chunked_splice']} final chunks")
        if row["stream_syncs"] > sync_budget:
            bad.append(f"{row['stream_syncs']} stream syncs > the {sync_budget} budgeted: "
                       f"{row['stream_sync_sites']}")
        return bad

    rows, kept, problems = {}, {}, []
    for arm, (flash, options) in PREFILL_ARMS.items():
        eng = engine(models[flash], **options)
        row = serve(eng, timed)
        bad = gates(row, flash, len(timed))
        if options.get("prefix_cache_bytes"):
            ps = row["prefix_stats"]
            if not (ps["prefix_hit_rate"] > 0 and row["splices"] >= 1):
                bad.append(f"no prefix hits: {ps}")
        if options.get("prefill_chunk") and row["chunks"] < 1:
            bad.append("no chunk ran")
        rows[arm] = row
        kept[arm] = eng
        problems += [f"arm {arm}: {x}" for x in bad]
        emit({"phase": "serve_1b_prefill", "arm": arm, "flash_prefill": flash,
              "options": options, "preset": "1b", "layers": layers,
              **{k: st[k] for k in ("n_slots", "tokens_per_launch", "requests", "new")},
              "prompt_lengths": list(st["prompts"]),
              **{k: v for k, v in row.items() if k != "tokens"},
              "weights_init_s": init_s, "ok": not bad, "problems": bad, "gpu": gpu})
    for arm in ("c", "d", "e"):
        if not rows[arm]["prefills"] < rows["a"]["prefills"]:
            problems.append(f"arm {arm}: {rows[arm]['prefills']} prefills, not fewer than "
                            f"(a)'s {rows['a']['prefills']}")
    if rows["d"]["tokens"] != rows["a"]["tokens"]:
        problems.append("arm d (dense, prefix cache) is not token-identical to arm a")
    # the flash arms against their dense twins, teacher-forced on (a)'s
    # tokens, one request of each prompt length
    shares = {}
    for arm, twin in PREFILL_TF.items():
        for i in range(n_lens):
            ref = kept[twin].teacher_forced_logits(timed[i], rows["a"]["tokens"][i])
            got = kept[arm].teacher_forced_logits(timed[i], rows["a"]["tokens"][i])
            rec = tf_compare(ref, got)
            emit({"phase": "serve_1b_prefill_teacher_forced", "arm": arm, "ref": twin,
                  "request": i, "prompt_len": len(timed[i]), **rec, "gpu": gpu})
            shares[f"{arm} vs {twin}"] = max(shares.get(f"{arm} vs {twin}", 0.0),
                                              rec["diff_share"])
            if not rec["ok"]:
                problems.append(f"arm {arm}: request {i}'s teacher-forced logits outside "
                                f"the bound of arm {twin}'s")
    segment_bytes = {a: rows[a]["prefix_stats"].get("prefix_used_bytes") for a in "cde"}
    kept.clear()
    # generate() with attention_fn=flash_attention prefills through the
    # kernel too: one launch a layer for the whole prompt
    counters()
    gen = generate(models[True], None, [timed[2]], st["new"], device="cuda")
    gen_launches = fa.flash_attention.launches["fwd"]
    if gen_launches != layers:
        problems.append(f"generate with flash launched flash_fwd {gen_launches} times, "
                        f"want {layers}")
    emit({"phase": "serve_1b_prefill_generate", "prompt_len": len(timed[2]),
          "flash_fwd_launches": gen_launches,
          "flash_fwd_routes": dict(fa.flash_attention.routes["fwd"]),
          "tokens_equal_arm_b": gen[0, len(timed[2]):].tolist() == rows["b"]["tokens"][2],
          "gpu": gpu})
    if problems:
        raise AssertionError("; ".join(problems))

    # one prefill per bucket, dense against flash in turns (events: the
    # time on the card's clock, host starvation included; profiler: the
    # device's busy time)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    prefill_ms = {}
    for p in warm:
        bucket = 1 << max(3, (len(p) - 1).bit_length())
        tokens = torch.tensor([p + [0] * (bucket - len(p))], device="cuda")
        cache = KVCache.zeros(cfg, 1, device="cuda")

        def run(flash, tokens=tokens, cache=cache, last=len(p) - 1):
            return models[flash](tokens, cache, prefill=True, last_pos=last)

        turns = time_turns_ms(lambda: run(True), lambda: run(False), torch, flush, reps=5,
                              warmup=1)
        busy = {name: profile_device_ms(torch, lambda f=f: run(f))
                for name, f in (("flash", True), ("dense", False))}
        prefill_ms[bucket] = {
            "flash_ms": (turns[0] + turns[3]) / 2, "dense_ms": (turns[1] + turns[2]) / 2,
            "turns_ms": turns, "flash_device_busy_ms": busy["flash"][0],
            "dense_device_busy_ms": busy["dense"][0],
            "flash_kernels": busy["flash"][1], "dense_kernels": busy["dense"][1]}
    emit({"phase": "serve_1b_prefill_bucket_ms", "prompt_lengths": [len(p) for p in warm],
          "by_bucket": prefill_ms, "gpu": gpu})
    del models, params

    # (f) the paged leg: 1b-gqa, paged kernel, prefix cache, flash prefill
    gcfg = TransformerConfig(**PRESET_1B_GQA, quantized=True)
    gparams = init_quantized_lm(gcfg, seed=0, device="cuda")
    gmodel = TransformerLM(dataclasses.replace(gcfg, attention_fn=fa.flash_attention))
    geo = dict(paged=True, page_size=PAGED_STREAM["page_size"],
               pool_pages=PAGED_STREAM["pool_pages"])
    feng = ServeEngine(gmodel, gparams, n_slots=st["n_slots"], tokens_per_launch=tpl,
                       device="cuda", paged_kernel=True, prefix_cache_bytes=PREFIX_BYTES, **geo)
    freqs = timed[:6]
    frow = serve(feng, freqs)
    bad = gates(frow, True, len(freqs))
    # decode: one launch a layer and step; each splice's suffix forward
    # reads the pool through the kernel too, in row blocks (at least one
    # launch a layer)
    decode_launches = layers * frow["chains"] * tpl
    launches_f = launches = frow["paged_attention_launches"]
    splice_launches = launches - decode_launches
    if (splice_launches < layers * frow["refills"]["splice"] or splice_launches % layers
            or frow["paged_attention_routes"] != {"sm90": launches, "v1": 0}):
        bad.append(f"paged_attention launched {launches} times "
                   f"({frow['paged_attention_routes']}): want {decode_launches} decode "
                   f"launches and at least {layers} a splice for "
                   f"{frow['refills']['splice']} splices, all sm90")
    if frow["splices"] < 1:
        bad.append("no splice in the paged leg")
    pstats = feng.page_stats()
    if pstats["pages_shares"] <= 0:
        bad.append(f"no page shared: {pstats}")
    # teacher-forced: the last spliced request against a paged gather twin
    # with dense prefill and no cache
    twin = ServeEngine(TransformerLM(gcfg), gparams, n_slots=st["n_slots"],
                       tokens_per_launch=tpl, device="cuda", **geo)
    i = len(freqs) - 1
    rec = tf_compare(twin.teacher_forced_logits(freqs[i], frow["tokens"][i]),
                     feng.teacher_forced_logits(freqs[i], frow["tokens"][i]))
    if not rec["ok"]:
        bad.append(f"request {i}'s teacher-forced logits outside the bound")
    while feng.prefix.evict_coldest():
        pass
    in_use = feng.page_stats()["pages_in_use"]
    if in_use:
        bad.append(f"{in_use} pages in use after the drain and the index clear")
    emit({"phase": "serve_1b_prefill", "arm": "f", "preset": "1b-gqa",
          "max_seq_len": gcfg.max_seq_len, "flash_prefill": True,
          "options": dict(paged_kernel=True, prefix_cache_bytes=PREFIX_BYTES, **geo),
          "requests": len(freqs), **{k: v for k, v in frow.items() if k != "tokens"},
          "paged_attention_decode_launches": decode_launches,
          "paged_attention_splice_launches": splice_launches,
          "page_stats": pstats, "pages_in_use_after_clear": in_use,
          "teacher_forced": {k: rec[k] for k in ("diff_share", "bound_share", "ok")},
          "ok": not bad, "problems": bad, "gpu": gpu})
    problems += [f"arm f: {x}" for x in bad]
    del feng, twin, gparams, gmodel

    # (g) the float arm: init_lm 1b in bf16, flash prefill (sm90) against
    # dense prefill
    fcfg = TransformerConfig(**PRESET_1B, dtype=torch.bfloat16)
    fparams = init_lm(fcfg, seed=0, device="cuda")
    dense_f = ServeEngine(TransformerLM(fcfg), fparams, n_slots=st["n_slots"],
                          tokens_per_launch=tpl, device="cuda")
    flash_f = ServeEngine(TransformerLM(dataclasses.replace(fcfg, attention_fn=fa.flash_attention)),
                          fparams, n_slots=st["n_slots"], tokens_per_launch=tpl, device="cuda")
    greqs = timed[:4]
    float_row = serve(flash_f, greqs)
    bad = gates(float_row, True, len(greqs), f32=False)
    gshare = 0.0
    for i in range(2):
        rec = tf_compare(dense_f.teacher_forced_logits(greqs[i], float_row["tokens"][i]),
                         flash_f.teacher_forced_logits(greqs[i], float_row["tokens"][i]))
        emit({"phase": "serve_1b_prefill_teacher_forced", "arm": "g", "ref": "g-dense",
              "request": i, "prompt_len": len(greqs[i]), **rec, "gpu": gpu})
        gshare = max(gshare, rec["diff_share"])
        if not rec["ok"]:
            bad.append(f"request {i}'s teacher-forced logits outside the bound")
    emit({"phase": "serve_1b_prefill", "arm": "g", "preset": "1b", "dtype": "bfloat16",
          "weights": "init_lm(seed=0), float32 parameters computing in bfloat16",
          "flash_prefill": True, "requests": len(greqs),
          **{k: v for k, v in float_row.items() if k != "tokens"},
          "ok": not bad, "problems": bad, "gpu": gpu})
    problems += [f"arm g: {x}" for x in bad]
    shares["g vs g-dense"] = gshare
    del dense_f, flash_f, fparams
    if problems:
        raise AssertionError("; ".join(problems))
    summary = {
        "phase": "serve_1b_prefill_summary",
        "tokens_d_equal_a": True, "tokens_b_equal_a": rows["b"]["tokens"] == rows["a"]["tokens"],
        "tokens_c_equal_a": rows["c"]["tokens"] == rows["a"]["tokens"],
        "tokens_e_equal_a": rows["e"]["tokens"] == rows["a"]["tokens"],
        "teacher_forced_max_diff_share": shares, "bound_share": TF_LOGIT_BOUND,
        "prefix_used_bytes": segment_bytes,
        "ttft_p50_s": {a: r["ttft_p50_s"] for a, r in rows.items()},
        "ttft_p95_s": {a: r["ttft_p95_s"] for a, r in rows.items()},
        "prefill_ms_by_bucket": prefill_ms, "gpu": gpu}
    emit(summary)
    launches = {a: r["flash_fwd_launches"] for a, r in rows.items()}
    launches["f"] = frow["flash_fwd_launches"]
    paged_f = {"launches": launches_f, "decode": decode_launches, "splices": splice_launches,
               "routes": frow["paged_attention_routes"]}
    launches["g"] = float_row["flash_fwd_launches"]
    return {"launches": launches, "paged_f": paged_f,
            "prefills": {a: r["refills"]["prefill"] for a, r in rows.items()},
            "routes_g": float_row["flash_fwd_routes"], "routes_b": rows["b"]["flash_fwd_routes"]}


def profile_steps(torch, engine, mk_request, n_steps: int) -> dict:
    """``torch.profiler`` over ``n_steps`` steady ``step()`` calls of
    ``engine`` with 4 fresh requests (their prefills and first two chains
    outside the window), each chain's dispatch and collect marked
    (``record_function``). Returns the device's busy and idle share of the
    window's wall time, kernels per step and, for each chain i collected
    in the window whose successor was dispatched in it, whether chain
    i+1's first kernel launch (a ``cudaLaunch*`` runtime call inside its
    dispatch) was queued before chain i's collect returned — the pipeline's
    overlap at depth 2, the serial order at depth 1 — and how long the
    collect took."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for i in range(engine.n_slots):
        engine.submit(mk_request(i))
    engine.step()
    engine.step()
    real_dispatch, real_collect = engine._dispatch, engine._collect_chain

    def dispatch():
        with record_function(f"chain_dispatch {engine.n_chains}"):
            real_dispatch()

    def collect():
        with record_function(f"chain_collect {engine._inflight[0].chain_id}"):
            return real_collect()

    engine._dispatch, engine._collect_chain = dispatch, collect
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                engine.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del engine._dispatch, engine._collect_chain
    engine.run_until_idle()
    # host-side events only: a record_function range also shows on the
    # device's timeline (a user annotation spanning its kernels)
    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.events() if e.device_type == cpu]
    marks = {}
    for e in events:
        if e.name.startswith(("chain_dispatch ", "chain_collect ")):
            kind, i = e.name.split()
            marks[kind, int(i)] = (e.time_range.start, e.time_range.end)
    launches = sorted(e.time_range.start for e in events
                      if e.name.startswith(("cudaLaunch", "cuLaunch")))
    pairs = []
    for (kind, i), (c0, c1) in sorted(marks.items()):
        if kind != "chain_collect" or ("chain_dispatch", i + 1) not in marks:
            continue
        d0, d1 = marks["chain_dispatch", i + 1]
        first = next((t for t in launches if d0 <= t <= d1), None)
        pairs.append({"chain": i, "collect_us": c1 - c0,
                      "next_first_launch_minus_collect_end_us":
                          None if first is None else first - c1,
                      "next_queued_before_collect_returned": first is not None and first < c1})
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("chain_")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"steps": n_steps, "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_step": sum(e.count for e in kernels) / n_steps,
            "launch_events": len(launches), "chain_pairs": pairs}


def phase_serve_spec(torch, fa, gpu: str) -> dict:
    """``serve_1b_spec``: the 1b int8 cell (PRESET_1B at full depth, 4
    slots, 12 requests, prompts {16, 32, 48}, 32 new tokens, greedy), flash
    prefill, arm by arm (SPEC_ARMS). Gates: every request finishes; (s),
    (p) and (sp) token-identical to (a); 113 int8 calls a forward (a
    verify forward: M = 12) and 16 flash launches a whole prefill, all on
    their routes (int8 sm90, flash f32); host syncs = chains + prefills,
    stream syncs (sync debug mode) no more, their sites printed; in the
    profiled window of (p) and (sp) every next chain's first kernel queued
    before the previous chain's collect returned, in (a) and (s) never
    (the control); ``spec_stats()`` of (s) and (sp) equal to the host
    replay (``replay_spec``) over (a)'s greedy tokens extended by k. Each
    arm's tok/s, latency, TTFT, verify forwards, acceptance and busy/idle
    share. Returns the launches by arm."""
    import dataclasses

    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        bind_params,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    cfg = TransformerConfig(**PRESET_1B, quantized=True)
    params = init_quantized_lm(cfg, seed=0, device="cuda")
    model = TransformerLM(dataclasses.replace(cfg, attention_fn=fa.flash_attention))
    bind_params(model, params)
    n_slots, tpl, new, n_req, layers = 4, 8, 32, 12, cfg.n_layers
    lengths = (16, 32, 48)
    rng = np.random.Generator(np.random.PCG64(11))
    prompts = [rng.integers(0, cfg.vocab_size, (lengths[i % 3],)).tolist()
               for i in range(n_req + 4)]
    timed, spare = prompts[:n_req], prompts[n_req:]

    def engine(**kw):
        return ServeEngine(model, None, n_slots=n_slots, tokens_per_launch=tpl, max_queue=64,
                           device="cuda", **kw)

    def mk_request(i: int) -> Request:  # the profiled window's: 64 new tokens
        return Request(prompt=spare[i % len(spare)], max_new_tokens=2 * new, seed=100 + i)

    def serve(eng, max_new=new):
        ids = [eng.submit(Request(prompt=p, max_new_tokens=max_new, seed=i))
               for i, p in enumerate(timed)]
        done = {c.request_id: c for c in eng.run_until_idle()}
        return ids, done

    for arm in ("a", "sp"):  # warmup: the decode and the verify chains' first launches
        warm = engine(**SPEC_ARMS[arm])
        warm.submit(Request(prompt=spare[0], max_new_tokens=16))
        warm.run_until_idle()
        del warm
    torch.cuda.synchronize()
    rows, problems = {}, []
    for arm, options in SPEC_ARMS.items():
        eng = engine(**options)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        quant.int8_matmul.launches = 0
        quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
        fa.flash_attention.launches["fwd"] = 0
        fa.flash_attention.routes["fwd"] = {"sm90": 0, "sm80": 0}
        t0 = time.perf_counter()
        with real_syncs(torch) as real:
            ids, done = serve(eng)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        int8_calls, routes = quant.int8_matmul.launches, dict(quant.int8_matmul.routes)
        flash_calls = fa.flash_attention.launches["fwd"]
        flash_routes = dict(fa.flash_attention.routes["fwd"])
        toks = [done[i].tokens if i in done else None for i in ids]
        prefills, chains, syncs = eng.n_prefills, eng.n_chains, eng.n_host_syncs
        sstats = eng.spec_stats()
        forwards = prefills + chains * tpl
        per_forward = layers * 7 + 1
        bad = []
        if len(done) != n_req or any(c.finish_reason != "length" or len(c.tokens) != new
                                     for c in done.values()):
            bad.append(f"not every request finished 'length' with {new} tokens")
        if arm != "a" and toks != rows["a"]["tokens"]:
            bad.append("greedy tokens differ from arm a's")
        if int8_calls != per_forward * forwards or routes != {"sm90": int8_calls, "v1": 0}:
            bad.append(f"int8_matmul launched {int8_calls} times ({routes}), want "
                       f"{per_forward} x ({prefills} prefills + {chains} chains x {tpl}), "
                       "all sm90")
        if flash_calls != layers * prefills or flash_routes["sm80"] != flash_calls:
            bad.append(f"flash_fwd launched {flash_calls} times ({flash_routes}), want "
                       f"{layers} x {prefills} prefills on the f32 route")
        if syncs != chains + prefills:
            bad.append(f"{syncs} host syncs != {chains} chains + {prefills} prefills")
        if real["count"] > syncs:
            bad.append(f"{real['count']} stream syncs > the {syncs} budgeted: {real['sites']}")
        t_prof = time.perf_counter()
        prof = profile_steps(torch, eng, mk_request, SPEC_PROFILE_STEPS)
        prof_s = time.perf_counter() - t_prof
        piped = options.get("pipeline_depth", 1) > 1
        overlap = [p["next_queued_before_collect_returned"] for p in prof["chain_pairs"]]
        if not prof["launch_events"] or not overlap or any(x != piped for x in overlap):
            bad.append(f"profiled chain pairs {prof['chain_pairs']}: want every next chain "
                       f"queued {'before' if piped else 'after'} the previous collect returned")
        lat = [c.latency_s for c in done.values()]
        ttft = [c.ttft_s for c in done.values()]
        n_tok = sum(len(t or []) for t in toks)
        rows[arm] = {
            "phase": "serve_1b_spec", "arm": arm, "options": options, "preset": "1b",
            "layers": layers, "flash_prefill": True, "n_slots": n_slots,
            "tokens_per_launch": tpl, "requests": n_req, "prompt_lengths": list(lengths),
            "new_tokens": new, "completed": len(done), "generated_tokens": n_tok,
            "prefills": prefills, "chains": chains, "forwards": forwards,
            "spec_stats": sstats, "pipeline_stats": eng.pipeline_stats(),
            "int8_matmul_launches": int8_calls, "int8_matmul_routes": routes,
            "flash_fwd_launches": flash_calls, "flash_fwd_routes": flash_routes,
            "host_syncs": syncs, "stream_syncs": real["count"],
            "stream_sync_sites": real["sites"], "wall_s": wall_s,
            "aggregate_tok_s": n_tok / wall_s,
            "latency_p50_s": percentile(lat, 0.5), "latency_p95_s": percentile(lat, 0.95),
            "ttft_p50_s": percentile(ttft, 0.5), "ttft_p95_s": percentile(ttft, 0.95),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "profile": prof, "profile_s": prof_s, "ok": not bad, "problems": bad, "gpu": gpu,
            "tokens": toks,
        }
        emit({k: v for k, v in rows[arm].items() if k != "tokens"})
        problems += [f"arm {arm}: {x}" for x in bad]
        del eng
    # the host replay: (a)'s greedy tokens, extended by k past the budget
    # by an untimed plain engine, give each request's verify steps and
    # accepted drafts at greedy
    t_ext = time.perf_counter()
    ext_ids, ext_done = serve(engine(), new + SPEC_K)
    ext_s = time.perf_counter() - t_ext
    ext = [ext_done[i].tokens for i in ext_ids]
    if [t[:new] for t in ext] != rows["a"]["tokens"]:
        problems.append("the extended plain stream's first tokens differ from arm a's")
    replay = [replay_spec(p, t, new, SPEC_K, SPEC_NGRAM) for p, t in zip(timed, ext)]
    want = (sum(r[0] for r in replay), sum(r[1] for r in replay))
    if want[1] != sum(r[2] for r in replay):
        problems.append("the extended plain stream is too short for an exact replay")
    for arm in ("s", "sp"):
        st = rows[arm]["spec_stats"]
        got = (st["spec_steps_consumed"], st["spec_drafts_accepted"])
        if got != want:
            problems.append(f"arm {arm}: spec_stats (steps, accepted) {got} != the host "
                            f"replay's {want}")
    emit({"phase": "serve_1b_spec_summary", "k": SPEC_K, "ngram": SPEC_NGRAM,
          "replay_steps_consumed": want[0], "replay_drafts_accepted": want[1],
          "replay_stream_s": ext_s,
          "profile_s": {a: r["profile_s"] for a, r in rows.items()},
          "spec_stats": {a: rows[a]["spec_stats"] for a in ("s", "sp")},
          "aggregate_tok_s": {a: r["aggregate_tok_s"] for a, r in rows.items()},
          "latency_p50_s": {a: r["latency_p50_s"] for a, r in rows.items()},
          "ttft_p50_s": {a: r["ttft_p50_s"] for a, r in rows.items()},
          "device_idle_share": {a: r["profile"]["device_idle_share"] for a, r in rows.items()},
          "tokens_equal_a": {a: r["tokens"] == rows["a"]["tokens"] for a, r in rows.items()},
          "ok": not problems, "gpu": gpu})
    if problems:
        raise AssertionError("; ".join(problems))
    return {"int8": {a: r["int8_matmul_launches"] for a, r in rows.items()},
            "int8_routes": {a: r["int8_matmul_routes"] for a, r in rows.items()},
            "flash": {a: r["flash_fwd_launches"] for a, r in rows.items()},
            "verify_forwards": {a: r["spec_stats"].get("n_verify_forwards", 0)
                                for a, r in rows.items()}}


LOSSES = ("cross_entropy", "fused_cross_entropy")


def phase_train_card_vs_cpu(torch, gpu: str) -> None:
    """Phase 5: a 2-layer model at the 760m widths, S 256, flash attention,
    in float32 and in bfloat16 (the train step's compute type), with cross
    entropy and with the fused loss: the loss and every gradient on the
    card (kernels, TF32 off) against the CPU (plain versions), on the same
    weights and tokens; with the fused loss, then one train step with the
    fused AdamW on both sides and the parameters compared."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        bind_params,
        init_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_loss import (
        fused_cross_entropy,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import (
        TrainState,
        _make_loss_fn,
        _train_step_fn,
    )

    seq = 256
    rng = np.random.Generator(np.random.PCG64(6))
    toks = torch.as_tensor(rng.integers(0, PRESET_760M["vocab_size"], (2, seq + 1)),
                           dtype=torch.int64)
    # float32: sums in other orders (cuBLAS against oneDNN over up to 6144
    # terms, the kernels' 64-key tiles against the plain 256-key block):
    # 1e-5 relative on the loss, 1e-3 of each gradient's largest entry.
    # bfloat16: both sides round every activation, p and ds to bf16 from f32
    # sums taken in other orders; a flipped rounding (2^-8 of a value)
    # travels through two layers and back: 2^-10 relative on the loss, and
    # each gradient's error norm within 2^-5 of its norm
    tols = {
        torch.float32: {"loss_rel": 1e-5, "grad_rel_to_max": 1e-3},
        torch.bfloat16: {"loss_rel": 2.0 ** -10, "grad_rel_norm": 2.0 ** -5},
    }
    lr = 3e-4
    for (dtype, tol), loss_name in itertools.product(tols.items(), LOSSES):
        fused = loss_name == "fused_cross_entropy"
        cfg = TransformerConfig(**{**PRESET_760M, "n_layers": 2}, max_seq_len=seq, dtype=dtype,
                                attention_fn=make_flash_attention(1024, 1024), quantized=False)
        params = init_lm(cfg, seed=5, device="cpu")
        loss_fn = _make_loss_fn(loss_name)
        out, stepped = {}, {}
        before = dict(flash_attention.launches)
        loss_before = dict(fused_cross_entropy.launches)
        adamw_before = fused_adamw.launches
        for dev in ("cuda", "cpu"):
            model = TransformerLM(cfg)
            bind_params(model, {k: v.to(dev) for k, v in params.items()})
            batch = (toks[:, :-1].to(dev), toks[:, 1:].to(dev))
            named = list(model.named_parameters())
            loss = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, [p for _, p in named])
            out[dev] = (float(loss.detach()),
                        {n: g.double().cpu() for (n, _), g in zip(named, grads)})
            if fused:  # then one train step with the fused AdamW
                p0 = {n: p.detach().double().cpu() for n, p in named}
                state = TrainState.create(model=model, tx=fused_adamw(lr, weight_decay=0.01))
                _train_step_fn(loss_name)(state, batch)
                stepped[dev] = (p0, {n: p.detach().double().cpu() for n, p in named})
        launched = {k: flash_attention.launches[k] - before[k] for k in before}
        loss_launched = {k: fused_cross_entropy.launches[k] - loss_before[k] for k in loss_before}
        adamw_launched = fused_adamw.launches - adamw_before
        # the card side: one loss-and-gradient pass, plus the train step when fused
        passes = 2 if fused else 1
        if launched != {"fwd": 2 * passes, "dq": 2 * passes, "dkv": 2 * passes}:
            raise AssertionError(f"card side launched {launched}, want {2 * passes} of each")
        want_loss = {k: passes if fused else 0 for k in FUSED_PER_STEP}
        if loss_launched != want_loss or adamw_launched != (1 if fused else 0):
            raise AssertionError(
                f"card side launched {loss_launched} fused-loss and {adamw_launched} "
                f"fused-AdamW kernels, want {want_loss} and {1 if fused else 0}")
        loss_err = abs(out["cuda"][0] - out["cpu"][0])
        worst_max, worst_norm = (0.0, ""), (0.0, "")
        for name, g_cpu in out["cpu"][1].items():
            diff = out["cuda"][1][name] - g_cpu
            worst_max = max(worst_max, (float(diff.abs().max() / g_cpu.abs().max()), name))
            worst_norm = max(worst_norm, (float(diff.norm() / g_cpu.norm()), name))
        grad_err = worst_max[0] if "grad_rel_to_max" in tol else worst_norm[0]
        ok = (loss_err <= tol["loss_rel"] * abs(out["cpu"][0])
              and grad_err <= tol.get("grad_rel_to_max", tol.get("grad_rel_norm")))
        step = {}
        if fused:
            # AdamW's first step is u = -lr (g / (|g| + eps) + wd p) (m_hat =
            # g, v_hat = g^2): each side's step is held to it from its own
            # gradients, within the f32 rounding of p + u (2^-22 |p|) and
            # 1e-8 for the f32 arithmetic of u; the gradients themselves
            # are held card against CPU above. An element whose gradient
            # changes sign between the two sides steps the other way, so
            # the parameters agree only to 2.5 lr
            ratio, diff = {}, []
            for dev in ("cuda", "cpu"):
                start, after = stepped[dev]
                worst = 0.0
                for n, p0 in start.items():
                    g = out[dev][1][n]
                    u = -lr * (g / (g.abs() + 1e-8) + 0.01 * p0)
                    bound = 2.0 ** -22 * p0.abs() + 1e-8
                    worst = max(worst, float(((after[n] - p0 - u).abs() / bound).max()))
                ratio[dev] = worst
            for n in stepped["cpu"][1]:
                diff.append(float((stepped["cuda"][1][n] - stepped["cpu"][1][n]).abs().max()))
            step = {"adamw_step_worst_ratio": ratio, "param_max_abs_diff": max(diff),
                    "param_tolerance": {"step": "2^-22 |p| + 1e-8", "card_vs_cpu": 2.5 * lr}}
            ok = (ok and max(ratio.values()) <= 1.0
                  and step["param_max_abs_diff"] <= 2.5 * lr)
        emit({
            "phase": "train_card_vs_cpu", "layers": 2, "widths": "760m", "seq": seq,
            "batch": 2, "dtype": str(dtype).removeprefix("torch."), "attention": "flash",
            "loss": loss_name, "loss_cuda": out["cuda"][0], "loss_cpu": out["cpu"][0],
            "loss_abs_err": loss_err,
            "grad_worst_rel_to_max": worst_max[0], "grad_worst_rel_to_max_param": worst_max[1],
            "grad_worst_rel_norm": worst_norm[0], "grad_worst_rel_norm_param": worst_norm[1],
            "tolerance": tol, "flash_launches": launched,
            "fused_loss_launches": loss_launched, "fused_adamw_launches": adamw_launched,
            **step, "ok": ok, "gpu": gpu,
        })
        if not ok:
            raise AssertionError(
                f"{dtype} {loss_name} training on the card disagrees with the CPU")


def phase_train(torch, gpu: str) -> dict:
    """Phase 6: the 760m train step through the port's bench entry point,
    with the flash launch counts of exactly this run."""
    from pytorch_distributed_training_tutorials_tpu_torch.bench import lm_headline
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    argv = ["--steps", "6", "--reps", "2", "--trace"]
    args = lm_headline.parse(argv)
    for counts in (flash_attention.launches, *flash_attention.routes.values()):
        for k in counts:
            counts[k] = 0
    r = lm_headline.measure(args)
    launches = dict(flash_attention.launches)
    routes = {k: dict(c) for k, c in flash_attention.routes.items()}
    steps = r["steps_run"]
    losses = r["losses_first_chain"]
    problems = []
    if not r["all_losses_finite"]:
        problems.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        problems.append(f"loss did not fall over the first chain: {losses}")
    want = {k: n * steps for k, n in FLASH_PER_STEP.items()}
    if launches != want:
        problems.append(f"flash launches {launches} != {want} ({steps} steps)")
    # every flash launch of the bf16 760m step takes the sm90 route
    if routes != {k: {"sm90": n, "sm80": 0} for k, n in launches.items()}:
        problems.append(f"flash routes {routes}: not all sm90")
    if r["n_params"] != N_PARAMS_760M:
        problems.append(f"n_params {r['n_params']} != {N_PARAMS_760M}")
    emit({
        "phase": "train_760m", "arm": "baseline", "argv": argv,
        "note": "6 chained steps and 2 timed chains (the bench default is 12 and 3) "
                "to fit the smoke's time",
        "flash_launches": launches, "flash_routes": routes, "launches_per_step": {
            k: v / steps for k, v in launches.items()},
        **{k: r[k] for k in (
            "preset", "n_layers", "d_model", "seq", "batch", "attn", "remat_policy",
            "n_params", "steps_run", "losses_first_chain", "step_ms", "chain_ms_samples",
            "wall_s_samples", "tokens_per_s", "model_tflops_per_step", "mfu",
            "peak_memory_bytes", "init_s", "trace")},
        "ok": not problems, "problems": problems, "gpu": gpu,
    })
    if problems:
        raise AssertionError("; ".join(problems))
    return {"flash": launches, "flash_routes": routes, "first_loss": losses[0]}


def phase_train_fused(torch, gpu: str, baseline_first_loss: float) -> dict:
    """Phase 7: the fused arm of the 760m train step (``--fused``: the
    fused loss kernels and fused AdamW) through the port's bench entry
    point, the chains of phase 6, with the launch counts of exactly this
    run."""
    from pytorch_distributed_training_tutorials_tpu_torch.bench import lm_headline
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_loss import (
        fused_cross_entropy,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw

    argv = ["--steps", "6", "--reps", "2", "--trace", "--fused"]
    args = lm_headline.parse(argv)
    for counts in (flash_attention.launches, *flash_attention.routes.values(),
                   fused_cross_entropy.launches, *fused_cross_entropy.routes.values()):
        for k in counts:
            counts[k] = 0
    fused_adamw.launches = 0
    r = lm_headline.measure(args)
    launches = {"flash": dict(flash_attention.launches),
                "fused_loss": dict(fused_cross_entropy.launches),
                "fused_adamw": fused_adamw.launches}
    routes = {k: dict(c) for k, c in fused_cross_entropy.routes.items()}
    flash_routes = {k: dict(c) for k, c in flash_attention.routes.items()}
    steps = r["steps_run"]
    losses = r["losses_first_chain"]
    problems = []
    if not r["all_losses_finite"]:
        problems.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        problems.append(f"loss did not fall over the first chain: {losses}")
    want = {"flash": {k: n * steps for k, n in FLASH_PER_STEP.items()},
            "fused_loss": {k: n * steps for k, n in FUSED_PER_STEP.items()},
            "fused_adamw": ADAMW_PER_STEP * steps}
    if launches != want:
        problems.append(f"launches {launches} != {want} ({steps} steps)")
    # every fused-loss and flash launch of the bf16 760m step takes the sm90
    # route
    want_routes = {k: {"sm90": launches["fused_loss"][k], "sm80": 0} for k in routes}
    if routes != want_routes:
        problems.append(f"fused-loss routes {routes} != {want_routes}")
    if flash_routes != {k: {"sm90": n, "sm80": 0} for k, n in launches["flash"].items()}:
        problems.append(f"flash routes {flash_routes}: not all sm90")
    # the same weights and batch: the baseline's loss is a bf16 value, one
    # bf16 ulp (2^-7 of the power of two below it) away at most
    ulp = 2.0 ** (math.floor(math.log2(abs(baseline_first_loss))) - 7)
    if not abs(losses[0] - baseline_first_loss) <= ulp:
        problems.append(f"first loss {losses[0]} vs the baseline's {baseline_first_loss}: "
                        f"more than one bf16 ulp ({ulp}) apart")
    if r["n_params"] != N_PARAMS_760M:
        problems.append(f"n_params {r['n_params']} != {N_PARAMS_760M}")
    emit({
        "phase": "train_760m", "arm": "fused", "argv": argv,
        "note": "6 chained steps and 2 timed chains (the bench default is 12 and 3) "
                "to fit the smoke's time",
        "launches": launches, "routes": routes, "flash_routes": flash_routes,
        "launches_per_step": {
            "flash": {k: v / steps for k, v in launches["flash"].items()},
            "fused_loss": {k: v / steps for k, v in launches["fused_loss"].items()},
            "fused_adamw": launches["fused_adamw"] / steps},
        "baseline_first_loss": baseline_first_loss, "first_loss_tolerance": ulp,
        **{k: r[k] for k in (
            "preset", "n_layers", "d_model", "seq", "batch", "attn", "remat_policy",
            "loss", "optimizer", "n_params", "steps_run", "losses_first_chain", "step_ms",
            "chain_ms_samples", "wall_s_samples", "tokens_per_s", "model_tflops_per_step",
            "mfu", "peak_memory_bytes", "init_s", "trace")},
        "ok": not problems, "problems": problems, "gpu": gpu,
    })
    if problems:
        raise AssertionError("; ".join(problems))
    return {**launches, "routes": routes, "flash_routes": flash_routes}


# the DDP main path: ResNet-18 (cifar stem) on the MNIST surrogate, 512
# images per device, 2 epochs, then the fused-AdamW arm for 1 epoch
RESNET_EPOCHS = 2
RESNET_BATCH = 512
ADAMW_ARM = dict(learning_rate=1e-3, weight_decay=1e-4)
# the eval-accuracy floor of the headline arm on the test surrogate after
# its 2 epochs: measured 0.9948 on an H100 80GB HBM3 (700 W), the same
# in three runs; the floor sits well below it
RESNET_ACC_FLOOR = 0.9
# resnet_card_vs_cpu: the card's distance to the CPU's float64 run may be
# at most 1.5x the CPU's own at the same dtype, plus this share of the
# quantity's own largest entry. float32, TF32 off, needs 0.0713 (a conv
# weight gradient of the last block): against float64, cuDNN's rounding
# flips the block-output ReLUs of one element each in blocks 2.1, 3.0 and
# 3.1, PyTorch's own CUDA convolutions only the one in 3.0, and a flip
# moves one whole term of the weight-gradient sums; the same step with
# TF32 on (the control, which must fail) flips 92-167 a block and needs
# 0.403. The floor sits between (both measured on an H100 80GB HBM3 at
# 700 W). bf16: the CPU's own bf16 error covers the card's.
CARD_FLOOR = {"f32": 0.15, "bf16": 0.02}


@contextlib.contextmanager
def tf32(torch, on: bool):
    """cuDNN and cuBLAS float32 with TF32 ``on`` or off inside the block
    (the flags restored after it)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def precision_flags(torch) -> dict:
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.conv.fp32_precision": getattr(
                getattr(torch.backends.cudnn, "conv", None), "fp32_precision", None)}


def phase_resnet_card_vs_cpu(torch, gpu: str) -> None:
    """One train step of ``resnet18(stem="cifar")`` at batch 16, 28x28x1,
    in float32 and bfloat16, on the card and on the CPU from the same
    weights: the loss, every gradient, the BatchNorm running mean and
    variance after the step, then the eval-mode logits. Each is held
    against the CPU's float64 run: the card may be at most 1.5x as far
    from it as the CPU at the same dtype, plus ``CARD_FLOOR`` times the
    quantity's largest entry (BatchNorm nets amplify rounding, so the
    CPU's own error sets the scale). float32 runs with TF32 off; the same
    float32 step with TF32 on is the control and must break the float32
    bound. Printed, not gated: the float32 step without cuDNN, the CPU's
    float32 step, the direct card-to-CPU difference, and how many block
    output ReLUs flip against float64 in each."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import init_params, resnet18
    from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import (
        BasicBlock,
        BatchNorm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import _compute_loss

    rng = np.random.Generator(np.random.PCG64(0))
    x = rng.integers(0, 256, (16, 28, 28, 1)).astype(np.uint8)
    y = rng.integers(0, 10, 16).astype(np.int64)
    weights = init_params(resnet18(num_classes=10, stem="cifar", in_channels=1), 0, "cpu")

    def run(device: str, dtype) -> tuple[dict, dict]:
        model = resnet18(num_classes=10, stem="cifar", in_channels=1, dtype=dtype)
        model.load_state_dict({k: v.to(device, copy=True) for k, v in weights.items()},
                              assign=True)
        # where each block's output ReLU passes its input, in the train
        # forward (the first call)
        passes = {}

        def record(name: str):
            def hook(module, args, out) -> None:
                if name not in passes:
                    passes[name] = (out > 0).cpu()
            return hook

        for n, m in model.named_modules():
            if isinstance(m, BasicBlock):
                m.register_forward_hook(record(n))
        if dtype == torch.float64:
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.mean, m.var = m.mean.double(), m.var.double()
        xb = torch.from_numpy(x).to(device).to(dtype) / 255
        loss = _compute_loss("cross_entropy", model(xb, train=True),
                             torch.from_numpy(y).to(device))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out = {"loss": loss.detach()}
        out.update({f"grad:{n}": g for (n, _), g in zip(model.named_parameters(), grads)})
        out.update({f"stat:{k}": v for k, v in model.state_dict().items()
                    if k.endswith((".mean", ".var"))})
        with torch.no_grad():
            out["eval_logits"] = model(xb, train=False)
        return {k: v.detach().double().cpu() for k, v in out.items()}, passes

    def floor_needed(got: dict, cpu: dict) -> tuple[float, str]:
        """The least floor that holds ``got``: over the quantities, the
        largest (card error - 1.5 x the CPU's) / the quantity's largest
        entry; and the quantity that sets it."""
        need = []
        for k, want in ref.items():
            scale = float(want.abs().max())
            excess = (float((got[k] - want).abs().max())
                      - 1.5 * float((cpu[k] - want).abs().max()))
            need.append((excess / scale if scale else (math.inf if excess > 0 else 0.0), k))
        return max(need, key=lambda t: t[0])

    def direct(got: dict, cpu: dict) -> float:
        return max(float((got[k] - cpu[k]).abs().max()) / max(float(want.abs().max()), 1e-30)
                   for k, want in ref.items())

    problems, results = [], {}
    with tf32(torch, False):
        ref, ref_passes = run("cpu", torch.float64)
        cpu = {"f32": run("cpu", torch.float32), "bf16": run("cpu", torch.bfloat16)}
        arms = {"cpu_f32": ("f32", *cpu["f32"], {})}
        cpu = {k: v[0] for k, v in cpu.items()}
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            arms[name] = (name, *run("cuda", dtype), precision_flags(torch))
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            arms["f32_without_cudnn"] = ("f32", *run("cuda", torch.float32),
                                         precision_flags(torch))
        with tf32(torch, True):
            arms["f32_tf32_control"] = ("f32", *run("cuda", torch.float32),
                                        precision_flags(torch))
    for arm, (dtype, card, passes, flags) in arms.items():
        need, at = floor_needed(card, cpu[dtype])
        flips = {n: int((p != ref_passes[n]).sum()) for n, p in passes.items()}
        results[arm] = {"floor_needed": need, "at": at, "floor": CARD_FLOOR[dtype],
                        "relu_flips_vs_float64": {n: v for n, v in flips.items() if v},
                        "max_card_vs_cpu_over_scale": direct(card, cpu[dtype]),
                        "loss": [float(card["loss"]), float(cpu[dtype]["loss"]),
                                 float(ref["loss"])],
                        "precision_flags": flags}
        if arm in ("f32", "bf16") and not need <= CARD_FLOOR[dtype]:
            problems.append(f"{arm}: {at} needs a floor of {need} > {CARD_FLOOR[dtype]}")
        if arm == "f32_tf32_control" and not need > CARD_FLOOR[dtype]:
            problems.append(f"the TF32 control passes the float32 bound (needs {need} <= "
                            f"{CARD_FLOOR[dtype]} at {at}): the gate cannot see TF32")
    emit({"phase": "resnet_card_vs_cpu", "model": "resnet18 cifar stem", "batch": 16,
          "image": [28, 28, 1], "quantities": len(ref),
          "bound": "card error vs the CPU float64 run <= 1.5 x the CPU's own + "
                   "floor x the quantity's largest entry",
          "gated": {"f32": "passes", "bf16": "passes", "f32_tf32_control": "fails"},
          "results": results, "ok": not problems, "problems": problems, "gpu": gpu})
    if problems:
        raise AssertionError("; ".join(problems))


def nccl_sync_check(torch, setup) -> dict:
    """The data-parallel collectives on NCCL and CUDA tensors in the world
    of one: one headline step's loss, gradients (in their parameters'
    layout, as the step lays them out) and BatchNorm statistics with every
    BatchNorm synced over the world (``all_reduce_sum``, forward and
    backward) and the gradients and loss through the bucketed
    ``all_reduce_mean_``, against the same step unsynced before and after
    it. A sum over one rank is its input, so all three must be bitwise
    equal (cuDNN deterministic inside). The all-reduces are counted."""
    import torch.distributed as dist

    from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import BatchNorm
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import collective
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import (
        _laid_out_like,
        _make_loss_fn,
        batch_stats,
    )

    model, batch = setup.trainer.state.model, setup.batch
    params = setup.trainer.state.params
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    stats0 = [b.clone() for b in batch_stats(model)]
    loss_fn = _make_loss_fn("cross_entropy", has_batch_stats=True)
    world = dist.group.WORLD
    calls = [0]
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        calls[0] += 1
        return all_reduce(*a, **kw)

    def step(group) -> list:
        with torch.no_grad():
            for b, b0 in zip(batch_stats(model), stats0):
                b.copy_(b0)
        for m in norms:
            m.sync_group = group
        loss = loss_fn(model, batch)
        grads = _laid_out_like(torch.autograd.grad(loss, params), params)
        loss = loss.detach().clone()
        if group is not None:
            collective.all_reduce_mean_([*grads, loss], group, dist.get_world_size(group))
        return [loss, *grads, *(b.clone() for b in batch_stats(model))]

    dist.all_reduce = counted
    try:
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
            before = step(None)
            n_unsynced = calls[0]
            synced = step(world)
            n_synced = calls[0] - n_unsynced
            after = step(None)
    finally:
        dist.all_reduce = all_reduce
        for m in norms:
            m.sync_group = None
        with torch.no_grad():
            for b, b0 in zip(batch_stats(model), stats0):
                b.copy_(b0)
    differ = sum(int((a != b).sum()) for a, b in zip(synced, before))
    differ_unsynced = sum(int((a != b).sum()) for a, b in zip(after, before))
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(synced, before))
    return {"norms": len(norms), "gradient_leaves": len(params),
            "all_reduces_synced_step": n_synced, "all_reduces_unsynced_step": n_unsynced,
            "elements_differ": differ, "elements_differ_unsynced_repeat": differ_unsynced,
            "max_abs_err": err, "tensors_compared": len(before)}


def adamw_check(torch, arm) -> dict:
    """Kernel 9 at this path's shapes: one more step of the fused arm with
    the optimizer swapped for a recorder takes the step's real parameters
    and gradients (laid out by ``_laid_out_like``); these and a copy of
    the arm's optimizer state (its count past 1) go through
    ``fused_adamw`` and the plain ``train.optim.adamw`` on the card. The
    parameters and both moments must be bitwise equal. The recorder's
    step and these launches come after the path's launches were read."""
    import dataclasses

    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw

    state = arm.trainer.state
    fused, opt_state = state.tx, state.opt_state
    seen = []

    class Recorder:
        def update_(self, params, grads, _state):
            seen.append(([p.detach().clone() for p in params], [g.clone() for g in grads]))

    state.tx = Recorder()
    try:
        arm.step_fn(state, arm.batch)
    finally:
        state.tx = fused
    (p_fused, grads), = seen
    p_plain = [p.clone() for p in p_fused]

    def copy_state():
        return dataclasses.replace(opt_state, mu=[m.clone() for m in opt_state.mu],
                                   nu=[v.clone() for v in opt_state.nu])

    s_fused, s_plain = copy_state(), copy_state()
    count = s_fused.count + 1
    fused.update_(p_fused, grads, s_fused)
    adamw(fused.lr, fused.b1, fused.b2, fused.eps, fused.weight_decay).update_(
        p_plain, grads, s_plain)
    torch.cuda.synchronize()
    got = p_fused + s_fused.mu + s_fused.nu
    want = p_plain + s_plain.mu + s_plain.nu
    return {"leaves": len(grads), "count": count,
            "conv_leaves": sum(g.dim() == 4 for g in grads),
            "smallest_leaf": min(g.numel() for g in grads),
            "elements_differ": sum(int((a != b).sum()) for a, b in zip(got, want)),
            "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, want))}


def phase_train_resnet_ddp(torch, gpu: str) -> dict:
    """The DDP slice in an NCCL world of one, formed through the spawn
    contract on 127.0.0.1 and torn down whatever happens in it."""
    from pytorch_distributed_training_tutorials_tpu_torch.launch import pick_unused_port
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import distributed

    distributed.init(f"127.0.0.1:{pick_unused_port()}", num_processes=1, process_id=0)
    try:
        return resnet_ddp_arms(torch, gpu)
    finally:
        distributed.shutdown()


def resnet_ddp_arms(torch, gpu: str) -> dict:
    """The NCCL group checked (backend, an all-reduce on the card), the
    headline workload (``bench.headline``:
    ResNet-18, bf16 on f32 params, 512 images per device, uint8 MNIST
    surrogate resident on the card, SGD 0.05 momentum 0.9) for 2 epochs
    through ``Trainer.train``, ``evaluate`` on the test surrogate, a
    profiled chain of steps, ``nccl_sync_check``; then the fused-AdamW arm
    (the same model and data, ``fused_adamw``) for one epoch and
    ``adamw_check``. Returns the fused arm's ``fused_adamw`` launches,
    the kernel's time and bound on this path and its error."""
    import torch.distributed as dist

    from pytorch_distributed_training_tutorials_tpu_torch.bench import headline
    from pytorch_distributed_training_tutorials_tpu_torch.bench.harness import (
        count_host_syncs,
        profile_step,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.data import DeviceResidentLoader, mnist
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw

    problems = []
    backend, world = dist.get_backend(), dist.get_world_size()
    probe = torch.arange(4, dtype=torch.float32, device="cuda")
    summed = probe.clone()
    dist.all_reduce(summed)
    if backend != "nccl":
        problems.append(f"backend {backend}, want nccl")
    if not torch.equal(summed, probe * world):
        problems.append(f"all_reduce gave {summed.tolist()} for {probe.tolist()} x {world}")

    t0 = time.perf_counter()
    setup = headline.make_headline_setup(RESNET_BATCH, quiet=True)
    setup_s = time.perf_counter() - t0
    trainer = setup.trainer
    epochs = []
    for e in range(RESNET_EPOCHS):
        fetches = trainer.host_syncs
        if e == RESNET_EPOCHS - 1:
            torch.cuda.reset_peak_memory_stats()
        with count_host_syncs(torch) as syncs:
            r = headline.time_epoch(setup)
        r["host_syncs"], r["sync_sites"] = syncs[0], syncs[1:]
        r["trainer_fetches"] = trainer.host_syncs - fetches
        epochs.append(r)
    peak = torch.cuda.max_memory_allocated()
    losses = [ev["loss"] for ev in trainer.metrics.step_events()]
    test = DeviceResidentLoader(mnist("test", raw=True), RESNET_BATCH, setup.mesh,
                                transform=headline.normalize)
    ev = trainer.evaluate(test)
    if not all(math.isfinite(v) for v in losses):
        problems.append("a loss is not finite")
    if not epochs[1]["mean_loss"] < epochs[0]["mean_loss"]:
        problems.append(f"epoch mean loss did not fall: {[r['mean_loss'] for r in epochs]}")
    if not ev["accuracy"] > RESNET_ACC_FLOOR:
        problems.append(f"eval accuracy {ev['accuracy']} <= floor {RESNET_ACC_FLOOR}")
    for r in epochs:
        if r["host_syncs"] > 1 or r["trainer_fetches"] != 1:
            problems.append(f"epoch {r['epoch']}: {r['host_syncs']} host syncs counted, "
                            f"{r['trainer_fetches']} trainer fetches (want at most 1, 1)")
    # step time: chains of eager steps on one cached batch, closed by one
    # fetch, CUDA events, min of 3; then one profiled chain
    chain = headline.time_chain(setup, chain_len=20, reps=3)
    prof_steps = 5
    trace = profile_step(headline.make_step_chain(setup, prof_steps), torch)
    trace.pop("port_kernels_ms")  # no hand-written kernel on this arm
    sync = nccl_sync_check(torch, setup)
    if sync["elements_differ"] or sync["elements_differ_unsynced_repeat"]:
        problems.append(f"the NCCL-synced step differs from the unsynced one: {sync}")
    if not sync["all_reduces_synced_step"] > 2 * sync["norms"] or sync[
            "all_reduces_unsynced_step"]:
        problems.append(f"all-reduces: {sync['all_reduces_synced_step']} in the synced step "
                        f"(want more than 2 x {sync['norms']} norms), "
                        f"{sync['all_reduces_unsynced_step']} unsynced (want 0)")
    trace["kernels_per_step"] = trace["kernels_per_step"] / prof_steps
    trace["device_busy_ms_per_step"] = trace["device_busy_ms"] / prof_steps
    n_dev = trainer.strategy.num_devices
    emit({"phase": "train_resnet_ddp", "arm": "headline", "backend": backend, "world": world,
          "allreduce_probe": summed.tolist(), "nccl_sync_check": sync, "model": "resnet18 cifar stem, bf16 on f32 params",
          "per_device_batch": RESNET_BATCH, "global_batch": setup.loader.global_batch,
          "dataset": {"rows": len(setup.dataset), "synthetic": setup.dataset.synthetic},
          "optimizer": "sgd(0.05, momentum=0.9)", "steps_per_epoch": len(setup.loader),
          "epochs": epochs, "images_per_sec_per_gpu": epochs[-1]["images_per_sec"] / n_dev,
          **chain,
          "peak_memory_bytes": peak, "eval": ev, "accuracy_floor": RESNET_ACC_FLOOR,
          "setup_s": setup_s, "trace": trace, "ok": not problems, "problems": problems,
          "gpu": gpu})
    headline_problems, problems = problems, []
    dataset = setup.dataset
    del setup, trainer, test

    # the fused-AdamW arm: the same model, data and loop
    opt = fused_adamw(**ADAMW_ARM)
    arm = headline.make_headline_setup(RESNET_BATCH, quiet=True, optimizer=opt, dataset=dataset)
    fused_adamw.launches = 0
    with count_host_syncs(torch) as syncs:
        r = headline.time_epoch(arm)
    launches = fused_adamw.launches
    losses = [ev["loss"] for ev in arm.trainer.metrics.step_events()]
    # the kernel's device time on this path, from a profiled chain, beside
    # its byte bound: p, g, m, v read and p, m, v written, 4 bytes each
    arm_trace = profile_step(headline.make_step_chain(arm, prof_steps), torch)
    adamw_ms = sum(v for k, v in arm_trace["port_kernels_ms"].items()
                   if "adamw_kernel" in k) / prof_steps
    elements = sum(p.numel() for p in arm.trainer.state.params)
    adamw_bound_ms = elements * 28 / HBM_BYTES_PER_S * 1e3
    steps = r["steps"]
    head, tail = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    check = adamw_check(torch, arm)
    if check["elements_differ"]:
        problems.append(f"fused_adamw != plain adamw at the ResNet-18 leaves: {check}")
    if launches != steps:
        problems.append(f"fused_adamw launched {launches} times in {steps} steps")
    if not all(math.isfinite(v) for v in losses):
        problems.append("a loss is not finite")
    if not tail < head:
        problems.append(f"loss did not fall: first 10 steps {head}, last 10 {tail}")
    emit({"phase": "train_resnet_ddp", "arm": "fused_adamw", "optimizer": "fused_adamw",
          "hyper": ADAMW_ARM, "epoch": r, "host_syncs": syncs[0], "sync_sites": syncs[1:],
          "fused_adamw_launches": launches, "launches_per_step": launches / steps,
          "kernel_vs_plain": check,
          "mean_loss_first_10": head, "mean_loss_last_10": tail,
          "adamw_kernel_ms_per_step": adamw_ms, "adamw_bound_ms": adamw_bound_ms,
          "adamw_leaves": len(arm.trainer.state.params), "adamw_elements": elements,
          "trace_idle_share": arm_trace["device_idle_share"],
          "images_per_sec_per_gpu": r["images_per_sec"] / n_dev, "ok": not problems,
          "problems": problems, "gpu": gpu})
    # both arms run and print before either fails the phase
    if headline_problems or problems:
        raise AssertionError("; ".join(headline_problems + problems))
    return {"fused_adamw": launches, "adamw_ms": adamw_ms, "adamw_bound_ms": adamw_bound_ms,
            "adamw_max_abs_err": check["max_abs_err"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after phase 2 (build, check and time the kernels)")
    ap.add_argument("--ddp-only", action="store_true",
                    help="after the build, run phases 8 and 9 (the DDP slice) only")
    ap.add_argument("--serve-only", action="store_true",
                    help="after the build, run the serving phases (4, serve_1b_paged, "
                         "serve_1b_prefill, serve_1b_spec) only")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pytorch_distributed_training_tutorials_tpu_torch.ops import _build, quant
    from pytorch_distributed_training_tutorials_tpu_torch.ops import (
        flash_attention as fa,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import fused_loss as fl
    from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as pa

    # plain float32 matmuls stay float32 on the card (TF32 off, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    emit({
        "phase": "device", "nvidia_smi": gpu, "torch": torch.__version__,
        "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    })

    t0 = time.perf_counter()
    info = _build.build_all()
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "kernels": {
            name: {
                "seconds": v["seconds"],
                "ptxas": [ln.strip() for ln in v["log"].splitlines()
                          if "entry function" in ln or "registers" in ln or "spill" in ln],
            }
            for name, v in info.items()
        },
    })

    emit({"phase": "warm_card", "seconds": warm_card(torch), "gpu": gpu})
    seconds = {}

    def run(phase, *a):
        """``phase(*a)``, its wall seconds kept under its name."""
        t = time.perf_counter()
        out = phase(*a)
        seconds[phase.__name__] = time.perf_counter() - t
        return out

    if args.ddp_only:
        run(phase_resnet_card_vs_cpu, torch, gpu)
        run(phase_train_resnet_ddp, torch, gpu)
        emit({"phase": "phase_seconds", **seconds})
        return 0
    if args.serve_only:
        run(phase_serve, torch, quant, gpu)
        run(phase_serve_paged, torch, pa, gpu)
        run(phase_serve_prefill, torch, fa, gpu)
        run(phase_serve_spec, torch, fa, gpu)
        emit({"phase": "phase_seconds", **seconds})
        return 0
    kern = run(phase_kernels, torch, quant, gpu)
    flash = run(phase_flash, torch, fa, gpu)
    fused = run(phase_fused_ce, torch, fl, gpu)
    adamw_row = run(phase_adamw, torch, gpu)
    paged = run(phase_paged, torch, pa, gpu)
    flash_serving = run(phase_flash_serving, torch, fa, gpu)
    if args.kernel_only:
        emit({"phase": "phase_seconds", **seconds})
        return 0
    run(phase_model, torch, gpu)
    serve = run(phase_serve, torch, quant, gpu)
    paged_serve = run(phase_serve_paged, torch, pa, gpu)
    prefill = run(phase_serve_prefill, torch, fa, gpu)
    spec = run(phase_serve_spec, torch, fa, gpu)
    run(phase_train_card_vs_cpu, torch, gpu)
    base = run(phase_train, torch, gpu)
    train_launches = base["flash"]
    fused_launches = run(phase_train_fused, torch, gpu, base["first_loss"])
    run(phase_resnet_card_vs_cpu, torch, gpu)
    ddp = run(phase_train_resnet_ddp, torch, gpu)
    emit({"phase": "phase_seconds", **seconds})

    # the kernels line: one decode forward's 113 int8 matmuls at M = 4
    # (the slot count) — time, plain time, v1 in turns and bound summed
    # over the mix
    res = kern["results"]
    mix = {key: sum(res[(4, k, n)][key] * c for (k, n), c in DECODE_MIX)
           for key in ("ms", "plain_ms", "v1_ms")}
    nbytes = sum(bound(4, k, n)[2] * c for (k, n), c in DECODE_MIX)
    ops = sum(bound(4, k, n)[3] * c for (k, n), c in DECODE_MIX)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    kernels = [{
        "name": "int8_matmul", "route": "cuda",
        "source": f"{PKG}/csrc/int8_matmul_sm90.cu", "replaces": INT8_REPLACES,
        "design": "wgmma-s8+tma", "route_counts": serve["routes"],
        "v1_ms": mix["v1_ms"], "v1_source": f"{PKG}/csrc/int8_matmul.cu",
        "launches": serve["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": mix["ms"], "plain_ms": mix["plain_ms"],
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "work": "one 1b decode forward: 113 calls at M=4",
        "prefill_ms": {f"M={m} K={k} N={n}": [res[(m, k, n)]["ms"], res[(m, k, n)]["v1_ms"]]
                       for m in INT8_PREFILL_M for k, n in (kn for kn, _ in DECODE_MIX)},
        "tma_encode_ns": kern["encode_ns"],
        # the speculative verify forward: 113 calls at M = 4 slots x (k+1)
        "verify": {key: sum(res[(4 * (SPEC_K + 1), k, n)][key] * c for (k, n), c in DECODE_MIX)
                   for key in ("ms", "plain_ms", "bound_ms")}
        | {"work": f"one 1b verify forward: 113 calls at M={4 * (SPEC_K + 1)}"},
        "launches_by_path": {"serve_1b": serve["launches"],
                             **{f"serve_1b_spec_{a}": n for a, n in spec["int8"].items()},
                             "serve_1b_gqa_paged_spec": paged_serve["spec_int8"]},
        "verify_forwards_by_path": {
            **{f"serve_1b_spec_{a}": n for a, n in spec["verify_forwards"].items() if n},
            "serve_1b_gqa_paged_spec": paged_serve["spec"]["n_verify_forwards"]},
    }]
    # the flash kernels: one 760m train step's launches at the main shape
    # (FLASH_SHAPES[0]), times, bound and library time summed over them
    for kind, per_step in FLASH_PER_STEP.items():
        row = flash["results"][(0, kind)]
        redesign = {
            "design": "wgmma+tma", "route_counts": base["flash_routes"][kind],
            "v1_ms": row["v1_ms"] * per_step,
            "v1_source": f"{PKG}/csrc/flash_attention.cu"}
        kernels.append({
            "name": f"flash_{kind}", "route": "cuda",
            "source": f"{PKG}/csrc/flash_attention_sm90.cu",
            "replaces": FLASH_REPLACES[kind], **redesign,
            "launches": train_launches[kind], "max_abs_err": flash["max_abs_err"][kind],
            "worst_ratio": flash["worst_ratio"][kind],
            "ms": row["ms"] * per_step, "plain_ms": row["plain_ms"] * per_step,
            "bound_ms": row["bound_ms"] * per_step, "bound_by": row["bound_by"],
            "library_ms": row["library_ms"] * per_step,
            "work": f"one 760m train step: {per_step} calls at B=2 S=2048 H=16 D=96 bf16",
            "library_note": "F.scaled_dot_product_attention(is_causal=True) "
                            + ("forward" if kind == "fwd" else
                               "backward, one number for flash_dq and flash_dkv "
                               "together (it computes dq, dk and dv in one call)"),
        })
        if kind == "fwd":
            # the serving path: 16 launches (one a layer) per whole prefill
            kernels[-1]["launches_by_path"] = {
                "train_760m": train_launches["fwd"],
                **{f"serve_1b_prefill_{a}": n for a, n in prefill["launches"].items()},
                **{f"serve_1b_spec_{a}": n for a, n in spec["flash"].items()}}
            kernels[-1]["serving"] = {
                "launches_per_prefill": PRESET_1B["n_layers"],
                "whole_prefills": prefill["prefills"],
                "route_counts": {"b (f32, int8 model)": prefill["routes_b"],
                                 "g (bf16, float model)": prefill["routes_g"]},
                "work": "one prefill's attention of one layer: B=1 H=16 D=128",
                "shapes": [{"S": s_, "dtype": dt, **row}
                           for (s_, dt), row in flash_serving.items()],
                "source_f32": f"{PKG}/csrc/flash_attention.cu"}
    # the fused tail: one 760m train step's launches at the main shape
    # (FUSED_CE_SHAPES[0]); AdamW over the 760m leaves
    for kind, per_step in FUSED_PER_STEP.items():
        row = fused["results"][(0, kind)]
        redesign = {
            "design": "wgmma+tma", "route_counts": fused_launches["routes"][kind],
            "v1_ms": row["v1_ms"] * per_step,
            "v1_source": f"{PKG}/csrc/fused_loss.cu"}
        kernels.append({
            "name": f"fused_ce_{kind}", "route": "cuda",
            "source": f"{PKG}/csrc/fused_loss_sm90.cu",
            "replaces": FUSED_CE_REPLACES[kind], **redesign,
            "launches": fused_launches["fused_loss"][kind],
            "max_abs_err": fused["max_abs_err"][kind],
            "worst_ratio": fused["worst_ratio"][kind],
            "ms": row["ms"] * per_step, "plain_ms": row["plain_ms"] * per_step,
            "bound_ms": row["bound_ms"] * per_step, "bound_by": row["bound_by"],
            "library_ms": row["library_ms"] * per_step,
            "work": f"one 760m train step: {per_step} call at N=4096 D=1536 V=32768 bf16",
            "library_note": "materialized logits: cuBLAS h @ W + F.cross_entropy, "
                            + ("forward" if kind == "fwd" else
                               "backward, one number for fused_ce_dh and fused_ce_dw "
                               "together (the pair's backward computes dh and dW in one "
                               "call)"),
        })
    kernels.append({
        "name": "fused_adamw", "route": "cuda",
        "source": f"{PKG}/csrc/fused_adamw.cu", "replaces": ADAMW_REPLACES,
        "launches": fused_launches["fused_adamw"],
        "launches_by_path": {"train_760m_fused": fused_launches["fused_adamw"],
                             "train_resnet_ddp_fused_adamw": ddp["fused_adamw"]},
        "resnet18_step": {"ms": ddp["adamw_ms"], "bound_ms": ddp["adamw_bound_ms"],
                          "max_abs_err": ddp["adamw_max_abs_err"],
                          "work": "one ResNet-18 step: 1 launch over 62 leaves"},
        "max_abs_err": adamw_row["max_abs_err"],
        "ms": adamw_row["ms"] * ADAMW_PER_STEP, "plain_ms": adamw_row["plain_ms"],
        "bound_ms": adamw_row["bound_ms"], "bound_by": adamw_row["bound_by"],
        "library_ms": adamw_row["library_ms"],
        "work": "one 760m train step: 1 launch over 219 leaves, 1,006,708,224 elements",
        "library_note": "torch._fused_adamw_: decays p by (1 - lr wd) first, the nearest "
                        "PyTorch call, not the same function",
    })
    # paged attention: one 1b-gqa decode forward (16 layers) at the paged
    # stream's mid-decode depths (PAGED_MAIN), f32 queries over an f32 pool
    row = paged["results"][PAGED_MAIN]
    kernels.append({
        "name": "paged_attention", "route": "cuda",
        "source": f"{PKG}/csrc/paged_attention_sm90.cu", "replaces": PAGED_REPLACES,
        "design": "split-pages+tma", "route_counts": paged_serve["routes"],
        "v1_ms": row["v1_ms"] * 16, "v1_source": f"{PKG}/csrc/paged_attention.cu",
        "launches": paged_serve["launches"], "max_abs_err": paged["max_abs_err"],
        "worst_ratio": paged["worst_ratio"],
        "ms": row["ms"] * 16, "plain_ms": row["plain_ms"] * 16,
        "bound_ms": row["bound_ms"] * 16, "bound_by": row["bound_by"],
        "library_ms": None,
        "work": "one 1b-gqa decode forward: 16 calls at B=4 S=1 H=16 KV=4 D=128, "
                "pages of 64, depths (32, 496, 1516, 32), f32",
        "library_note": PAGED_LIBRARY_NOTE,
        "gather_sdpa_ms": row["gather_sdpa_ms"] * 16,
        "launches_by_path": {"serve_1b_paged": paged_serve["launches"],
                             "serve_1b_prefill_f": prefill["paged_f"],
                             "serve_1b_gqa_paged_spec": paged_serve["spec"]},
        "verify": {k: paged["results"][("1b-gqa-verify", "f32", "f32")][k] * 16
                   for k in ("ms", "plain_ms", "bound_ms")}
        | {"bound_by": paged["results"][("1b-gqa-verify", "f32", "f32")]["bound_by"],
           "work": "one 1b-gqa verify forward: 16 calls at B=4 S=3 H=16 KV=4 D=128, depths "
                   "(34, 498, 1518, 40), f32"},
        "splice": {k: paged["results"][("1b-gqa-splice", "f32", "f32")][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        | {"work": "one call at B=1 S=256 H=16 KV=4 D=128 from depth 96, f32, in row "
                   "blocks"},
    })
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
