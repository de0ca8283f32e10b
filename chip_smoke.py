#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100, sm_90a).

    python3 chip_smoke.py                 # every phase, from the repo root
    python3 chip_smoke.py --kernel-only   # phases 0-2: build, check, time
    python3 chip_smoke.py --ddp-only      # the training path: fused AdamW's check, 8, 9 and 10-12
    python3 chip_smoke.py --serve-only    # phases 0, 1, 4 and the serving phases after it
    python3 chip_smoke.py --lora-only     # phases 0, 1 and the LoRA / dots_attn phases
    python3 chip_smoke.py --faults-only   # phases 0, 1 and the failure-handling phases
    python3 chip_smoke.py --tp-only       # phases 0, 1 and the tensor-parallel phases
    python3 chip_smoke.py --strategies-only  # phases 0, 1 and the model-parallel phases
    python3 chip_smoke.py --slo-roles-only   # phases 0, 1, the engine features' and the sentry's
    python3 chip_smoke.py --load-only     # phases 0, 1 and serve_1b_from_checkpoint

It drives the port (``pytorch_distributed_training_tutorials_tpu_torch``)
on the card and fails — non-zero exit, no result line — if a phase fails.
``serve_1b_paged``, ``serve_1b_prefill``, ``serve_1b_spec``,
``serve_1b_lora``, the failure-handling phases, ``serve_1b_slo``,
``serve_1b_disagg`` and ``serve_1b_sentry`` serve the presets' widths at
SERVE_LAYERS (8) of their 16 layers: where their text below counts 113
int8 calls, or 16 flash or paged launches, a forward, read 57 and 8
(``serve_1b_tp2`` and ``serve_1b_tp2_world4``: TP_LAYERS, also 8). Every
phase prints JSON lines:

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
5. training: a 2-layer model at the 760m preset's widths, S 128, flash
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
   this path beside its bound;
10. ``train_resnet_streaming``: the headline in an NCCL world of one, one
   epoch in each of three arms under deterministic cuDNN — resident,
   ``ChunkedStreamingLoader`` (16 steps a chunk, 2 ahead) and
   ``PrefetchLoader`` over ``ShardedLoader`` (2 ahead): every step's batch
   the resident loader's (bit sums), every step's loss bitwise the
   resident arm's, at most one host sync an epoch, an H2D copy overlapping
   compute in a profiled window of the chunked arm; images/s of each arm
   and the H2D ceiling (7 pinned chunk uploads) before and after the
   chunked epoch (``DriftBracket``);
11. ``train_guardrails``: (a) the headline over its first 12 steps with
   ``skip_nonfinite`` and batch 3 poisoned, under SGD and ``fused_adamw``:
   one step skipped, the state bitwise (``bit_checksum``) a clean run's
   with that update elided, host syncs as the guard-off run's, one AdamW
   launch a step; (b) the 760m fused step with the guard: a poisoned step
   (``nan_grad_step``) leaves p, m, v, the count and ``step`` bitwise
   unchanged, a clean guarded step is bitwise the guard-off step, step ms
   guard on and off in turns; (c) rollback after a save under a chaos loss
   spike: one rollback, the epoch kept, training on;
12. ``bench_and_scaling``: the bench twin (``python -m ...bench``'s
   ``main``, in this process): one JSON line, a receipt that validates,
   stamped with this card; ``bench.scaling.sweep`` at every power-of-two
   width up to the card count (NCCL worlds through spawn);
   ``launch_overhead_fit`` over eager chains of 64 and 1024 ops.

Phase 2's ``fused_adamw`` check also runs the kernel with its skip flag
``ok`` at 1 and 0 (bitwise the plain version; with 0 the state's bit
patterns unchanged) and times both.

Between phases 4 and 5, ``serve_1b_paged``: the 1b-gqa preset at
SERVE_LAYERS, window 4096, serving 12 requests (prompts {16, 480, 1500}, 32 new
tokens) through 4 slots over a pool of 48 pages of 64 tokens, arm by arm —
(a) whole-slot, (b) paged gather f32 (tokens equal to (a)), (c) paged
kernel f32, (d) kernel int8, (e) kernel int4 — each with its launch, sync,
page and shed gates, and every int8 and paged call on the sm90 route. Then each kernel arm is held teacher-forced against a
gather engine at its KV storage on (b)'s tokens (``teacher_forced_logits``:
logits within 4% of their scale, the same argmax where the top-2 gap is
wider): (c) on two requests of each prompt length, (d) and (e) on one; (d) and (e) against the f32 gather are read as a lower-precision
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
prefills; in a window of (p) and (sp) each next chain's dispatch (its
launches) returned before the previous chain's collect returned, in (a)
and (s) never (host clock marks, ``chain_order``); ``spec_stats()`` equal
to a host replay of the drafts over (a)'s greedy tokens. Each arm's tok/s,
latency, TTFT, verify forwards and acceptance.

Then ``serve_1b_lora``, the multi-tenant slice: the 1b preset (int8
weights, flash prefill) with ``ServeEngine(adapter_bank=AdapterBank(
n_adapters=4, rank=8))`` — three synthetic tenants drawn N(0, 0.02^2)
as ``examples/serve_llm_int8.py --adapters 4`` draws them — serving phase
4's stream with ids i % 4, in turns with the bank-less engine (base,
bank, bank, base). Gates: every tenant's tokens equal a dedicated
single-tenant engine's, id 0's the bank-less engine's; each tenant's
teacher-forced logits off the base model's by more than 1% of the logit
scale, and a planted fault that ignores the ids failing that gate; host
syncs equal the bank-less stream's; 113 int8 calls a forward, all sm90;
a request queued behind an ``evict`` completes as ``"adapter_evicted"``
with no launch; a ``register`` into a live engine served at the next
step. Then its composed arm:
``paged=True, paged_kernel=True``, a prefix cache and
``speculative_k=2`` on serve_1b_prefill's overlapping prompts with ids
i % 4, and the same arm on the gather: splices equal a host replay of
the tenant-namespaced index (fewer than an un-namespaced replay's), the
requests whose tokens differ from the gather's held teacher-forced,
paged launches all sm90, flash forwards on the f32 route, no page left.

After phase 7, ``train_760m`` arm ``dots_attn``: the 760m model's loss
and gradients under remat "dots" and "dots_attn" in turns, bitwise
equal, with device ms and peak memory of each; the bench's default arm
with ``--remat_policy dots_attn``: 24 / 24 / 24 flash launches a step,
all sm90, its first loss bitwise "dots"'. Then ``train_lora``: phase 5's
model as a LoRA model fine-tuned on row 1 by ``Trainer(model_kwargs=
{"adapter_ids": 1})`` with ``fused_adamw(mask=lora_param_mask)`` for 5
steps: base parameters bitwise unchanged, one AdamW launch a step over
the factors only (timed against 28 B an element), the factors bitwise
the plain AdamW's run, flash and fused-loss launches sm90; the trained
row registered into a bank and served, its teacher-forced logits within
1e-4 of the merged model's in float32.

Then the failure-handling slice. ``serve_1b_faults``: phase 4's cell
with flash prefill, (a) guard off and (g) ``guard_nonfinite`` in turns
(a, g, g, a): token-identical, equal host and stream syncs, tok/s of
each; (c) the guard with a ``ChaosConfig`` (NaN
logits at slot 1, global step 5; request 5's prefill failing; chain 1's
dispatch stalled 5 s past request 2's 1.5 s deadline), a queued and an
active cancel, then ``drain()``: the poisoned request ``"nonfinite"`` with
exactly (g)'s tokens before the poisoned step, the failed prefill
``"error"`` and its slot serving the next request token-identically, the
deadline and cancel victims prefixes of (g)'s tokens, every other request
equal to (g), ``QueueClosed`` after the drain, ``fault_stats()`` equal to
what was injected (one ``prefill_errors`` exactly), host syncs = chains +
prefills + splices, stream syncs over them as (g)'s, 113 int8 calls a
forward and 16 flash launches a whole prefill on their routes.
``serve_1b_gqa_paged_faults``: the same on serve_1b_paged's kernel arm
(c) with ``speculative_k=2`` and ``pipeline_depth=2`` (the observed
boundary; the poisoned request's tokens replayed on the host), no page
left after the drain, one paged launch a layer a verify forward, all
sm90. ``serve_1b_flight``: (g)'s stream with a ``FlightRecorder``: equal
tokens, host and stream syncs; every span complete, event counts
reconciled, the histograms' p50/p95 within one bucket of the sorted
latencies. ``serve_1b_fleet``: three engines over one set of 1b weights
behind a ``FleetRouter``: fault-free, token-identical to (g); with
request 0's replica chaos-killed at its second chain (work in flight and
queued), the ledger verified, re-dispatched requests token-identical, the
killed replica frozen, host syncs the replicas' summed budget.

Then the rest of serving's engine features. ``serve_1b_slo``: the 1b
preset with flash prefill, 4 slots, ``priority_classes=2``: twelve
class-1 requests (prompts {16, 32, 48}, 32 new tokens), then four class-0
arrivals while every slot is busy, beside the SLO-off engine on the same
stream, greedy (a) and sampled (s): tokens equal the SLO-off engine's,
swaps out and as many in, host syncs = chains + prefills + splices +
swaps out (stream syncs no more), 113 int8 calls a forward and 16 flash
launches a whole prefill on their routes; (c) the chaos force-preempt of
slot 0 at chain 1 with no pressure, token-exact; then
``serve_1b_gqa_paged_slo``: the 1b-gqa preset with the paged kernel, two
class-1 requests of 1,500 tokens holding every page of the pool when two
class-0 requests of 480 tokens arrive (free slots, no free pages): the
same gates, 16 paged launches a decode step (sm90), no page left. Bytes a
swap, swap-out and swap-in ms (CUDA events) and host ms, class-0 TTFT with
SLO on and off. ``serve_1b_disagg``: a 1-prefill + 2-decode fleet of 1b
engines (one decode engine paged with the kernel) on card 0 behind a
``FleetRouter``, greedy (12 requests) and sampled (4): each request's
tokens the monolithic engine's of its decode engine's cache, 12 handoffs
moved, the prefill engine 0 host syncs (alone under sync debug mode: 0
stream syncs), each decode engine's syncs its chains + handoffs in, a CUDA
generator's state read and set under sync debug mode "error", 113 int8
calls a forward, 16 flash launches a prefill (f32 route) and 16 paged
launches a paged decode step, all on their routes; handoff bytes, TTFT
and tok/s of the fleet and the monolithic engines.

Then the tensor-parallel slice, ``serve_1b_tp2``: two ranks, NCCL where
the machine has a card for each, else gloo with both ranks on card 0 (NCCL
refuses two ranks on one device), the backend printed with the card
count. First ``int8_matmul_tp`` against its plain version in this
process, with no group, at the 1b shard shapes (q/k/v, gate/up and the
lm_head split on N, o and down on K; M 1, 4 and 512): a column shard
bitwise the unsharded kernel's columns, the row shards' partials summed
within ``KERNEL_TOLERANCE`` of ``int8_matmul_tp_reference``, each shard
call timed beside the unsharded call and its bound. Then two arms, each
replicated here and sharded on two spawned ranks: the 1b preset's int8
stream (8 requests, prompts {16, 32, 48}, 16 new tokens, flash prefill,
whole-slot cache) and the 1b-gqa paged-kernel arm (4 requests, prompts
{16, 480}). Gates: every rank's tokens equal and its teacher-forced
logits bitwise equal; tokens equal the replicated engine's except where
held teacher-forced within 4% of the logit scale; a rank's K/V half the
replicated bytes, 8 (1b) and 2 (1b-gqa) KV heads; ``audit_decode()``
clean and the stream's collectives 2 all_reduce a layer and 1 all_gather
a forward; 113 int8 calls a forward, all ``int8_matmul_tp`` shard calls on
the sm90 route, 16 flash launches a whole prefill, 16 paged launches a
decode step; host syncs a rank = chains + prefills = the replicated
engine's (the sync debug mode's count beside it, with what gloo adds);
no decision broadcast with no clock feature on. Then its clock legs
(TP_CLOCK_LEGS, rank 0 deciding): deadlines under a stall on rank 0 only,
a cancel made on rank 0 alone (the other rank's call a no-op), a stall
alone, each beside the leg with none: the ranks' completions identical,
one broadcast a step (none off), the victims completed with a prefix of
their tokens or none, every int8 call a shard call on the sm90 route.
Then its roles, SLO and router-clock legs (TP_ROLES, TP_SLO), each rank
with its own contract sentry: a TP prefill engine and two TP decode
engines (whole-slot, and paged with the kernel) behind a ``FleetRouter``
whose clock runs 101x fast on rank 1 with hedging on — every rank's
tokens, dispatches, replica states and clock broadcasts identical, tokens
the monolithic TP engine's (the paged decode engine's held greedy under
its own teacher-forced logits where they differ) and the unsharded
engine's (held teacher-forced where they differ, as the int8 arm holds
its own: ``tp_roles_unsharded``), the prefill side 0 host
syncs, a rank's handoff half the unsharded bytes within 1%, 57 int8 shard
calls a forward, 8 flash launches a prefill (f32 route) and 8 paged
launches a paged decode step (sm90); a one-slot ``priority_classes=2``
engine preempting a class-1 request for a class-0 one — tokens the int8
arm's (the SLO-off TP engine's), victims identical on both ranks, a rank's swap half the
unsharded bytes within 1%, host syncs chains + prefills + splices + swaps
out; every rank's sentry balanced (fetched == budgeted == host syncs, no
violation, no re-upload). Then ``serve_1b_tp2_world4``: a gloo world of 4
on card 0 (``{"data": 2, "model": 2}``), ranks {0, 1} and {2, 3} each
serving their data rank's share of TP_WORLD4's requests through a TP
engine with a default deadline — the two ranks of a group identical, the
tokens the unsharded engine's (or the TP-2 world's, held teacher-forced
there), one broadcast a step in each group over its own decision group.
With gloo its times are not tensor parallelism's speed.

After ``serve_1b_disagg``, ``serve_1b_sentry``: the contract sentry
(``obs/sentry.py``) on SLO_STREAM's greedy leg and DISAGG's greedy fleet
(one sentry shared by the fleet, read through ``fleet_sentry_summary``),
sentry off and on in turns: tokens the sentry-off turn's, no steady
recompile, violation or re-upload, fetched == budgeted == host syncs,
tok/s on and off; then three injections on the SLO engine, each exactly
one violation and one dump naming it (a kernel library loaded again after
the steady mark, a ``.item()`` of a device tensor inside one round, a
CPU-tensor leaf beside its silent CUDA twin). After ``train_guardrails``,
``train_sentry``: ``Trainer(sentry=)`` on the guardrails' ResNet-18 arm
for 2 epochs with fused AdamW: two phases, two state walks with 0 bytes
off the card.

Then ``train_760m_tp2``, tensor-parallel training: the 760m preset of
``bench/lm_headline.py`` at full width and TP_TRAIN_LAYERS (8) of its 24
layers (bf16, flash, remat "dots", the fused loss through
``fused_cross_entropy_tp``, fused AdamW, the skip guard) through
``Trainer(strategy=TensorParallel(create_mesh({"model": 2})))`` on two
spawned ranks (gloo on card 0 where the machine has one card), 4 steps,
beside the single-device ``Trainer`` from the same seed: falling
losses, every rank's losses the same floats and its replicated leaves
the same bits, the first step's loss and named leaves'
first moments (the step's gradient) within TP_TRAIN_LOSS_TOL and
TP_TRAIN_GRAD_TOL of the single-device step's slices while a planted
fault (f's backward sum dropped) falls outside, the collectives a step
exactly TP_TRAIN_COLLECTIVES, and per rank a step 16 / 8 / 8 flash,
1 / 1 / 1 fused-loss and 1 AdamW launches on the sm90 route. Its
``kernel_vs_plain`` lines (``fused_cross_entropy_tp``, run with phase
2): a rank's forward, dh and dW shard calls at N 4096, D 1536, V_local
16384 held against the unsharded kernels at V 32768 and timed in turns
with them. Phase 2's paged check also plants NaN past every row's depth
in a recycled page at every pool storage (``paged_stale_nan``): both
kernels' outputs finite and bitwise the zero-planted run's.

Then the model-parallel slice (``strategy_phases``).
``train_resnet50_pipeline``: the 03 lesson's split ResNet-50 (SURVEY C15/
C17: the imagenet stem, 1000 classes, batch 120 of 128x128 random images,
MSE on one-hot labels, SGD 1e-3) through ``ManualPipeline`` on ``["cuda:0",
"cuda:0"]`` and unsplit through the ``Trainer``'s step, from the same
weights: stage counts summing to 25,557,032, three losses and the
parameters within PIPE_TOL, ``forward`` in eval mode, a fused-AdamW
pipeline launching kernel 9 once a stage a step; ms a ``train()`` of 3
batches (mean and std of 10, in turns), peak memory and kernels a step.
``train_resnet50_gpipe``: the same model and batch through ``GPipe`` at
1, 2 and 4 microbatches, each step within PIPE_TOL of the single-device
gradient accumulation over the same microbatches, n*m / n*m / n stage
forwards, backwards and applies; ms a step and kernels a microbatch.
``train_resnet18_fsdp``: ``Trainer(strategy=FSDP(mesh))`` on the JAX
``examples/train_resnet_mnist.py --fsdp`` config: bitwise DataParallel in
an NCCL world of one with no collective; in a gloo world of 2 on card 0
within FSDP_TOL of DataParallel's, a rank's parameter and moment bytes
half, kernel 9 once a step over the rank's shards and bitwise its plain
version there (timed beside its bound), the collectives by kind.
``train_lm_hybrid_fsdp``: ``HybridFSDP(mesh, TP_RULES)`` on a gloo world
of 4 (``{"data": 2, "model": 2}``) at the 760m widths and 2 layers, every
leaf placed as the JAX strategy places it (HYBRID_SPECS), the first step
within TP_TRAIN_LOSS_TOL / TP_TRAIN_GRAD_TOL of the single-device
``Trainer``'s, flash and AdamW launches on the sm90 route.

Between ``serve_1b_tp2`` and ``train_760m_tp2``, the checkpoint-loading
slice, ``serve_1b_from_checkpoint`` (``--load-only``: the build and this
phase), under a temporary directory of ``build/`` (the disk's usage
printed first, each arm's files removed when it ends). Arm ``port``: the
1b preset's float32 flax tree drawn on the card from a seed, written with
``save_checkpoint`` one file a top-level subtree (4.82 GB), streamed back
with ``load_quantized_lm`` onto ``cuda:0``: every entry bitwise
``from_jax_params`` of the same tree; the card's allocated bytes after
the load the state dict's within 1%; a child process's host peak RSS
growth over the same load (VmRSS sampled, read only) under LOAD_RSS_SHARE of
the tree; ``audit_placement``: int8 exactly the ``_QUANTIZED_KERNELS``
weights, float32 the rest, all on ``cuda:0``; phase 4's stream shape (4
slots, 4 requests) over the loaded weights: 113 int8 calls a forward, all
sm90, tokens equal to the same engine's over ``from_jax_params`` weights;
load seconds and GB/s. Arm ``hf``: the 1b-gqa preset's bfloat16 weights
drawn on the card, written as an HF directory (``config.json``, ~1 GB
shards by the port's ``save_safetensors``, an index; each weight named
and transposed to (out, in) here, not by the loader): ``load_hf_llama``
float and int8 each bitwise ``from_jax_params`` of the drawn tree; 4
requests on ``serve_1b_paged``'s arm (c) (paged kernel): 113 int8 and 16
paged calls a forward, all sm90, no page left; the int8 model's
teacher-forced logits against the float model's with mean |difference|
under LOAD_HF_GATE of their std, and a load with ``o_proj`` left
untransposed failing that gate.

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
import dataclasses
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
# timed calls a median of the fused-loss checks: fewer than time_ms's 25,
# to keep the whole script inside the tool's time limit
FUSED_CE_REPS = 10
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
# timed calls a median of the plain paged attention: a per-page loop of
# 10-900 ms a call, most of the paged check's time, so few, to keep the whole
# script inside the tool's time limit
PAGED_PLAIN_REPS = 3
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
# steady steps of the marked window of a serve_1b_spec arm at depth 1
# (a, s): two give the overlap gate one chain pair; at depth 2 (p, sp) one
# step already dispatches the next chain before it collects the last, one
# pair (the window's marks are host clock reads: a profiler over it cost
# ~10 s of post-processing a step at 1b, ~80 s a run)
SPEC_WINDOW_STEPS = {1: 2, 2: 1}

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
# the served depth of serve_1b_paged, serve_1b_prefill, serve_1b_spec,
# serve_1b_lora, the failure-handling phases, serve_1b_slo,
# serve_1b_disagg and serve_1b_sentry: the presets' widths at 8 of their
# 16 layers, cut to keep the whole script inside the tool's time limit as
# phases were added (serve_1b_paged last, whose planted faults must still
# fail its teacher-forced gate at this depth). Phase 4 and
# serve_1b_from_checkpoint serve the full depth
SERVE_LAYERS = 8
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
# kernel arm -> (its gather reference, requests held: the first n, the
# prompt lengths cycling: 6 = two of each, 3 = one of each); "b8"/"b4"
# are gather engines at kv_bits 8/4
TF_PAIRS = {"c": ("b", 6), "d": ("b8", 3), "e": ("b4", 3)}
TF_GATHER = {"b8": dict(paged=True, kv_bits=8), "b4": dict(paged=True, kv_bits=4)}
# planted faults arm (c) must fail the gate with, on request 1 (8 pages)
TF_FAULTS = ("wrong_page", "dropped_page")
# one page of one layer's K, V (and scales): 64 tokens x 4 kv heads x
# (2 x 128 x 4 bytes | 2 x (128 + 4) | 2 x (64 + 2)); a page spans every
# served layer
PAGE_BYTES_PER_LAYER = {0: 262_144, 8: 67_584, 4: 33_792}
# the flash forward on the serving path: one prefill at B 1, H 16, D 128
# per bucket of serve_1b_spec's prompts (16, 32, 64: partial tiles of the
# f32 kernel's 64-row blocks) and of serve_1b_prefill's (128, 256, 512),
# in f32 (the int8 model) and bf16 (the float model)
FLASH_SERVE_SHAPES = [(1, s, 16, 128, dt) for dt in ("f32", "bf16")
                      for s in (16, 32, 64, 128, 256, 512)]
# serve_1b_prefill: the 1b preset at full width, SERVE_LAYERS deep, int8 weights
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
                turns = [time_ms(fn, torch, flush, reps=FUSED_CE_REPS, warmup=1)
                         for fn in (kern, old, old, kern)]
                ms, v1_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                v1 = {"v1_ms": v1_ms, "turns_ms": turns, "speedup_vs_v1": v1_ms / ms,
                      "errors_v1": {x: errs[x] for x in {"fwd": ("lse_v1", "tgt_v1"),
                                                          "dh": ("dh_v1",),
                                                          "dw": ("dw_v1",)}[kind]}}
            else:
                ms = time_ms(kern, torch, flush, reps=FUSED_CE_REPS, warmup=1)
            plain_ms = time_ms(plain, torch, flush, reps=FUSED_CE_REPS, warmup=1)
            lib_ms = (time_ms(lib, torch, flush, reps=FUSED_CE_REPS, warmup=1) if lib is not None
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


FUSED_CE_TP_REPLACES = "pytorch_distributed_training_tutorials_tpu/ops/fused_loss.py:487"


def phase_fused_ce_tp(torch, fl, gpu: str) -> dict:
    """``fused_cross_entropy_tp``'s kernel work at TP 2, in this process:
    each rank's shard calls of kernels 6-8 at the 760m loss with the
    vocabulary split (N 4096, D 1536, V_local 16384, bf16, the sm90
    route), the targets shifted by ``rank * V_local`` (out of the shard:
    negative past the owner, ``>= V_local`` before it), the shards'
    (lse, target) combined as the op's MAX and SUM do and dh summed in f32
    — held element by element (``KERNEL_TOLERANCE``) against the unsharded
    kernels at V 32768: lse, the target logit, dh and each rank's dW
    columns. Each shard call timed in turns with the unsharded call (shard,
    whole, whole, shard), beside its plain version, its bound at V 16384
    and the materialized logits of the shard as the library yardstick."""
    import torch.nn.functional as F

    n, d, v = FUSED_CE_SHAPES[0][:3]
    vl = v // TP
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    h = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((d, v), generator=gen, device=dev) * d ** -0.5).to(torch.bfloat16)
    y = torch.randint(0, v, (n,), generator=gen, device=dev)
    g = torch.full((n,), 1.0 / n, device=dev)
    lse, tgt = fl.fused_ce_fwd(h, w, y)
    dh = fl.fused_ce_dh(h, w, y, lse, g)
    dw = fl.fused_ce_dw(h, w, y, lse, g)
    ws = [w[:, r * vl:(r + 1) * vl].contiguous() for r in range(TP)]
    ys = [y - r * vl for r in range(TP)]
    routes0 = {k: dict(c) for k, c in fl.fused_cross_entropy.routes.items()}
    parts = [fl.fused_ce_fwd(h, ws[r], ys[r]) for r in range(TP)]
    # the op's collectives, in one process: a MAX, then one SUM of the
    # shifted exp-sums and of the target logits
    m = torch.stack([p[0] for p in parts]).amax(0)
    lse_g = m + torch.log(sum(torch.exp(p[0] - m) for p in parts))
    tgt_g = sum(p[1] for p in parts)
    dh_g = sum(fl.fused_ce_dh(h, ws[r], ys[r], lse_g, g, out_dtype=torch.float32)
               for r in range(TP)).to(h.dtype)
    dws = [fl.fused_ce_dw(h, ws[r], ys[r], lse_g, g) for r in range(TP)]
    for k in ("fwd", "dh", "dw"):
        if fl.fused_cross_entropy.routes[k]["sm90"] != routes0[k]["sm90"] + TP:
            raise AssertionError(f"fused_cross_entropy_tp's {k} shard calls left the sm90 "
                                 f"route: {fl.fused_cross_entropy.routes}")
    torch.cuda.synchronize()
    errs = {"lse": fl.kernel_error(lse_g, lse), "tgt": fl.kernel_error(tgt_g, tgt),
            "dh": fl.kernel_error(dh_g, dh)}
    errs.update({f"dw_rank{r}": fl.kernel_error(dws[r], dw[:, r * vl:(r + 1) * vl])
                 for r in range(TP)})
    bad = {k: e for k, e in errs.items() if not e["worst_ratio"] <= 1.0}
    if bad:
        raise AssertionError(f"fused_cross_entropy_tp shards != the unsharded kernels: {bad}")
    # rank 0's shard calls, timed (rank 1's are the same work)
    h0, w0, y0 = h, ws[0], ys[0]
    yc = y0.clamp(0, vl - 1)
    hl, wl = h0.detach().requires_grad_(True), w0.detach().requires_grad_(True)
    lib_loss = F.cross_entropy((hl @ wl).float(), yc, reduction="none")
    calls = {
        "fwd": (lambda: fl.fused_ce_fwd(h0, w0, y0), lambda: fl.fused_ce_fwd(h, w, y),
                lambda: fl.fused_ce_fwd_reference(h0, w0, y0),
                lambda: F.cross_entropy((h0 @ w0).float(), yc, reduction="none")),
        "dh": (lambda: fl.fused_ce_dh(h0, w0, y0, lse_g, g, out_dtype=torch.float32),
               lambda: fl.fused_ce_dh(h, w, y, lse, g),
               lambda: fl.fused_ce_dh_reference(h0, w0, y0, lse_g, g),
               lambda: torch.autograd.grad(lib_loss, (hl, wl), g, retain_graph=True)),
        "dw": (lambda: fl.fused_ce_dw(h0, w0, y0, lse_g, g), lambda: fl.fused_ce_dw(h, w, y, lse, g),
               lambda: fl.fused_ce_dw_reference(h0, w0, y0, lse_g, g), None),
    }
    results = {}
    for kind, (shard, whole, plain, lib) in calls.items():
        turns = time_turns_ms(shard, whole, torch, flush, warmup=1)
        ms, whole_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        plain_ms = time_ms(plain, torch, flush, reps=5, warmup=1)
        lib_ms = (time_ms(lib, torch, flush, warmup=1) if lib is not None
                  else results["dh"]["library_ms"])
        b_ms, b_by = fused_ce_bound(kind, n, d, vl, h.element_size(), BF16_FLOPS)
        names = {"fwd": ("lse", "tgt"), "dh": ("dh",), "dw": ("dw_rank0", "dw_rank1")}[kind]
        row = dict(ms=ms, unsharded_ms=whole_ms, turns_ms=turns, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   max_abs_err=max(errs[x]["max_abs_err"] for x in names),
                   worst_ratio=max(errs[x]["worst_ratio"] for x in names))
        results[kind] = row
        emit({
            "phase": "kernel_vs_plain", "kernel": "fused_cross_entropy_tp", "kind": kind,
            "tp": TP, "N": n, "D": d, "V": v, "V_local": vl, "dtype": "bf16", "route": "sm90",
            "errors": {x: errs[x] for x in names}, **row, "roofline_share": b_ms / ms,
            "library": "the shard's materialized logits: cuBLAS h @ W_local + F.cross_entropy"
                       + (" forward" if kind == "fwd" else
                          ", that pair's backward (one number for dh and dW)"),
            "gpu": gpu,
        })
    del hl, wl, lib_loss, calls
    return {"results": results,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values())}


def bit_checksum(torch, tensors) -> "torch.Tensor":
    """(2,) int64 on the device: the sum and the sum of squares (mod 2^64)
    of the tensors' 32-bit patterns; any changed bit moves the first. A
    bitwise check of large state without holding a copy of it."""
    sums = []
    for t in tensors:
        b = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        sums.append(torch.stack([b.sum(), (b * b).sum()]))
        del b
    return torch.stack(sums).sum(0)


def host_scalar_adamw(torch, tx, params, grads, mu, nu, count: int) -> None:
    """One unguarded AdamW step with the bias corrections of ``count``
    passed as host floats (``tx.inverse_bias_corrections``): the foreach
    arithmetic of the trainer's AdamW before its count and corrections
    moved to the device, 16 leaves a call. ``phase_adamw`` holds the
    device-scalar step to it, bitwise."""
    inv1, inv2 = tx.inverse_bias_corrections(count)
    for lo in range(0, len(params), 16):
        p, g = params[lo:lo + 16], grads[lo:lo + 16]
        m, v = mu[lo:lo + 16], nu[lo:lo + 16]
        torch._foreach_mul_(m, tx.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - tx.b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - tx.b2)
        torch._foreach_mul_(v, tx.b2)
        torch._foreach_add_(v, g2)
        del g2
        u = torch._foreach_mul(m, inv1)
        den = torch._foreach_mul(v, inv2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, tx.eps)
        torch._foreach_div_(u, den)
        del den
        torch._foreach_add_(u, torch._foreach_mul(p, tx.weight_decay))
        torch._foreach_mul_(u, -tx.lr)
        torch._foreach_add_(p, u)


def phase_adamw(torch, gpu: str) -> dict:
    """Phase 2 (fused AdamW): the kernel against the plain foreach AdamW
    over leaves of the 760m parameter shapes (219 leaves, 1,006,708,224
    elements), bitwise, at the 10th step (bias corrections != 1), with the
    skip flag ``ok`` absent, 1 and 0; with ``ok`` 0 the kernel's p, m, v
    and count keep their bit patterns (``bit_checksum``). With no flag,
    both the kernel and the plain version are also bitwise the host-scalar
    step (``host_scalar_adamw``: the bias corrections as host floats, the
    arithmetic guard-off training had before the count moved to the
    device). Times for each flag; yardstick ``torch._fused_adamw_``, whose
    decay order differs."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import finite_flag

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
    state.mu, state.nu = mu, nu
    s_plain = plain.init([torch.empty(0, device=dev)])
    s_plain.mu, s_plain.nu = [m.clone() for m in mu], [x.clone() for x in nu]
    for st in (state, s_plain):
        st.count.fill_(9)
        st.calls = 9
    p_plain = [p.clone() for p in params]
    host = [[x.clone() for x in xs] for xs in (params, mu, nu)]
    host_scalar_adamw(torch, plain, host[0], grads, host[1], host[2], count=10)
    flags = {v: torch.tensor(v, dtype=torch.int32, device=dev) for v in (0, 1)}
    checks = {}

    def bits_differ(xs, ys) -> int:
        return sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                   for a, b in zip(xs, ys, strict=True))

    for name, ok in (("none", None), ("ok=1", flags[1]), ("ok=0", flags[0])):
        kept = bit_checksum(torch, params + state.mu + state.nu + [state.count])
        tx.update_(params, grads, state, ok=ok)
        plain.update_(p_plain, grads, s_plain, ok=ok)
        torch.cuda.synchronize()
        err, n_bad = 0.0, 0
        for a, b in zip(params + state.mu + state.nu + [state.count],
                        p_plain + s_plain.mu + s_plain.nu + [s_plain.count]):
            err = max(err, float((a.double() - b.double()).abs().max()))
            n_bad += int((a.view(torch.int32) != b.view(torch.int32)).sum())
        kept_bits = bool(torch.equal(
            kept, bit_checksum(torch, params + state.mu + state.nu + [state.count])))
        checks[name] = {"elements_differ": n_bad, "max_abs_err": err,
                        "count": int(state.count), "state_bits_unchanged": kept_bits}
        if name == "none":
            flat = [x for xs in host for x in xs]
            checks[name]["host_scalar_elements_differ"] = {
                "kernel": bits_differ(params + state.mu + state.nu, flat),
                "plain": bits_differ(p_plain + s_plain.mu + s_plain.nu, flat)}
            del flat, host
            if any(checks[name]["host_scalar_elements_differ"].values()):
                raise AssertionError(f"fused_adamw vs the host-scalar step: {checks[name]}")
        if n_bad or (name == "ok=0") != kept_bits:
            raise AssertionError(f"fused_adamw kernel ({name}): {checks[name]}")
    del p_plain, s_plain
    err = max(c["max_abs_err"] for c in checks.values())
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    ms = time_ms(lambda: tx.update_(params, grads, state), torch, flush, warmup=1)
    ms_flag = {name: time_ms(lambda: tx.update_(params, grads, state, ok=flags[v]), torch, flush,
                             warmup=1) for name, v in (("ok=1", 1), ("ok=0", 0))}
    plain_ms = time_ms(lambda: plain.update_(params, grads, state), torch, flush, warmup=1)
    # the skip-step guard's flag over the same gradients: each leaf's
    # largest |g| read once (4 bytes an element)
    loss = torch.tensor(1.0, device=dev)
    finite_ms = time_ms(lambda: finite_flag(loss, grads), torch, flush, warmup=1)
    steps = [torch.tensor(10.0, device=dev) for _ in params]
    lib_ms = time_ms(lambda: torch._fused_adamw_(
        params, grads, state.mu, state.nu, [], steps, lr=3e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False), torch, flush, warmup=1)
    nbytes = 28.0 * n_el  # g, m, v, p read; m, v, p written: f32
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes", library_ms=lib_ms,
               max_abs_err=err, n_mismatch=0, ms_by_flag=ms_flag, flag_checks=checks,
               finite_flag_ms=finite_ms, finite_flag_bound_ms=4.0 * n_el / HBM_BYTES_PER_S * 1e3)
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
                           torch, flush, reps=PAGED_PLAIN_REPS, warmup=1)
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
    stale = paged_stale_nan(torch, pa, gpu)
    return {"results": results, "max_abs_err": max_err, "worst_ratio": worst,
            "stale_nan": stale}


def paged_stale_nan(torch, pa, gpu: str) -> list:
    """Stale NaN in recycled pages stays out (ROADMAP C1): on the 1b-gqa
    decode shape (rows at depths 0, 1000 and 2500 end inside a page) at
    every pool storage, NaN planted in K and V (the scales of a quantized
    pool) at every position past each row's depth in its last live page —
    what a previous tenant could leave — through the sm90 and the v1
    kernel: the output finite and bitwise the run with those positions
    zeroed."""
    shape = PAGED_SHAPES[1]
    name, b, s, h, kv, d, ps, p_cap, depths, parked = shape
    out = []
    for i, store in enumerate(PAGED_STORES):
        q, k, v, table, pos, kw, live = paged_operands(torch, shape, store, "f32", 90 + i)
        planted = (kw["k_scale"], kw["v_scale"]) if kw else (k, v)
        tails = []
        for r, depth in enumerate(depths):
            last, first_dead = divmod(depth + s - 1, ps)
            if first_dead + 1 < ps:
                tails.append((int(table[r, last]), first_dead + 1))

        def plant(value):
            for t in planted:
                for pid, lo in tails:
                    t[pid, lo:] = value

        for route in (None, "v1"):
            plant(float("nan"))
            routes0 = dict(pa.paged_attention.routes)
            got = pa.paged_attention(q, k, v, table, pos, **kw, route=route)
            taken = {k_: pa.paged_attention.routes[k_] - routes0[k_] for k_ in routes0}
            plant(0.0)
            zero = pa.paged_attention(q, k, v, table, pos, **kw, route=route)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got).all())
            equal = bool(torch.equal(got, zero))
            row = {"phase": "paged_stale_nan", "shape": name, "storage": store,
                   "route": route or "sm90", "launches": taken, "dead_tails": tails,
                   "finite": finite, "equal_zero_planted": equal, "ok": finite and equal,
                   "gpu": gpu}
            emit(row)
            out.append({k_: row[k_] for k_ in ("storage", "route", "finite",
                                               "equal_zero_planted")})
            if not (finite and equal and taken[route or "sm90"] == 1):
                raise AssertionError(f"stale NaN past the depth reached the paged kernel's "
                                     f"output: {row}")
    return out


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
    """The paged serving slice: the 1b-gqa preset's widths at SERVE_LAYERS
    of its 16 layers, int8 weights, window 4096, through ``ServeEngine`` on the paged stream
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
    cfg = TransformerConfig(**{**PRESET_1B_GQA, "n_layers": SERVE_LAYERS}, quantized=True)
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

    def engine(options: dict):
        kw = dict(options)
        if kw.get("paged"):
            kw.update(page_size=st["page_size"], pool_pages=st["pool_pages"])
        return ServeEngine(model, params, n_slots=st["n_slots"],
                           tokens_per_launch=st["tokens_per_launch"], max_queue=64,
                           device="cuda", **kw)

    for arm in ("a", "c"):  # warmup: first launches, cuBLAS handles
        warm = engine(PAGED_ARMS[arm])
        warm.submit(Request(prompt=prompt(99), max_new_tokens=2, seed=99))
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
            want_pb = PAGE_BYTES_PER_LAYER[stats["kv_bits"]] * cfg.n_layers
            if stats["page_bytes"] != want_pb:
                bad.append(f"page_bytes {stats['page_bytes']} != {want_pb}")
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
    """The prefill slice: the 1b preset at full width (SERVE_LAYERS deep) through
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
    cfg = TransformerConfig(**{**PRESET_1B, "n_layers": SERVE_LAYERS}, quantized=True)
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
    gcfg = TransformerConfig(**{**PRESET_1B_GQA, "n_layers": SERVE_LAYERS}, quantized=True)
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
    fcfg = TransformerConfig(**{**PRESET_1B, "n_layers": SERVE_LAYERS}, dtype=torch.bfloat16)
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


def chain_order(torch, engine, mk_request, n_steps: int) -> dict:
    """The pipeline's overlap over ``n_steps`` steady ``step()`` calls of
    ``engine`` with 4 fresh requests (their prefills and first two chains
    outside the window): each chain's dispatch and collect marked on the
    host clock. For each chain i collected in the window whose successor
    was dispatched in it, whether chain i+1's dispatch — every launch of
    it — returned before chain i's collect returned (the overlap at depth
    2; at depth 1 the serial order: the dispatch starts after the collect),
    and how long the collect took; the int8 launches in the window."""
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant

    for i in range(engine.n_slots):
        engine.submit(mk_request(i))
    engine.step()
    engine.step()
    real_dispatch, real_collect = engine._dispatch, engine._collect_chain
    marks = {}

    def dispatch():
        i, t0 = engine.n_chains, time.perf_counter_ns()
        real_dispatch()
        marks["dispatch", i] = (t0, time.perf_counter_ns())

    def collect():
        i, t0 = engine._inflight[0].chain_id, time.perf_counter_ns()
        out = real_collect()
        marks["collect", i] = (t0, time.perf_counter_ns())
        return out

    engine._dispatch, engine._collect_chain = dispatch, collect
    torch.cuda.synchronize()
    launches = quant.int8_matmul.launches
    try:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del engine._dispatch, engine._collect_chain
    launches = quant.int8_matmul.launches - launches
    engine.run_until_idle()
    pairs = []
    for (kind, i), (c0, c1) in sorted(marks.items()):
        if kind != "collect" or ("dispatch", i + 1) not in marks:
            continue
        d0, d1 = marks["dispatch", i + 1]
        pairs.append({"chain": i, "collect_us": (c1 - c0) / 1e3,
                      "next_dispatch_end_minus_collect_end_us": (d1 - c1) / 1e3,
                      "next_queued_before_collect_returned": d1 <= c1})
    return {"steps": n_steps, "wall_ms": wall_ms, "int8_launches": launches,
            "chain_pairs": pairs}


def phase_serve_spec(torch, fa, gpu: str) -> dict:
    """``serve_1b_spec``: the 1b int8 cell (PRESET_1B, SERVE_LAYERS deep, 4
    slots, 12 requests, prompts {16, 32, 48}, 32 new tokens, greedy), flash
    prefill, arm by arm (SPEC_ARMS). Gates: every request finishes; (s),
    (p) and (sp) token-identical to (a); 113 int8 calls a forward (a
    verify forward: M = 12) and 16 flash launches a whole prefill, all on
    their routes (int8 sm90, flash f32); host syncs = chains + prefills,
    stream syncs (sync debug mode) no more, their sites printed; in a
    window of (p) and (sp) every next chain's dispatch returned before the
    previous chain's collect returned, in (a) and (s) never (the control;
    ``chain_order``); ``spec_stats()`` of (s) and (sp) equal to the host
    replay (``replay_spec``) over (a)'s greedy tokens extended by k. Each
    arm's tok/s, latency, TTFT, verify forwards and acceptance. Returns the
    launches by arm."""
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

    cfg = TransformerConfig(**{**PRESET_1B, "n_layers": SERVE_LAYERS}, quantized=True)
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
        depth = options.get("pipeline_depth", 1)
        order = chain_order(torch, eng, mk_request, SPEC_WINDOW_STEPS[depth])
        piped = depth > 1
        overlap = [p["next_queued_before_collect_returned"] for p in order["chain_pairs"]]
        if not order["int8_launches"] or not overlap or any(x != piped for x in overlap):
            bad.append(f"chain pairs {order['chain_pairs']}: want every next chain "
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
            "chain_order": order, "ok": not bad, "problems": bad, "gpu": gpu,
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
          "spec_stats": {a: rows[a]["spec_stats"] for a in ("s", "sp")},
          "aggregate_tok_s": {a: r["aggregate_tok_s"] for a, r in rows.items()},
          "latency_p50_s": {a: r["latency_p50_s"] for a, r in rows.items()},
          "ttft_p50_s": {a: r["ttft_p50_s"] for a, r in rows.items()},
          "tokens_equal_a": {a: r["tokens"] == rows["a"]["tokens"] for a, r in rows.items()},
          "ok": not problems, "gpu": gpu})
    if problems:
        raise AssertionError("; ".join(problems))
    return {"int8": {a: r["int8_matmul_launches"] for a, r in rows.items()},
            "int8_routes": {a: r["int8_matmul_routes"] for a, r in rows.items()},
            "flash": {a: r["flash_fwd_launches"] for a, r in rows.items()},
            "verify_forwards": {a: r["spec_stats"].get("n_verify_forwards", 0)
                                for a, r in rows.items()}}


# serving's failure handling (serve_1b_faults, serve_1b_gqa_paged_faults):
# where each fault lands in the 12-request streams. The chaos NaN hits slot
# 1 at global decode step 5 (chain 0; request 1, the first wave filling
# slots in order); request 5's prefill fails; request 2 carries a deadline
# of FAULT_DEADLINE_S and chain 1's dispatch stalls FAULT_CHAOS["stall_s"],
# over three times that deadline, so it expires at the boundary after chain
# 1 (the observed one at depth 2) whatever the host's speed: the first wave
# is popped microseconds after its submit and reaches chain 1 well inside
# the deadline. Request 11 is cancelled while queued, request 0 once the
# first chain was observed. Clean requests carry no deadline.
FAULT_CHAOS = dict(nan_logit_slot=1, nan_logit_step=5, fail_prefill_request=5,
                   stall_chain=1, stall_s=5.0)
FAULT_DEADLINE_S = 1.5
FAULT_VICTIMS = dict(poisoned=1, failed=5, deadline=2, cancel_queued=11, cancel_active=0)
# serve_1b_fleet: three engines over one set of 1b weights, 2 slots each;
# the stream is serve_1b_faults' 12 requests and two copies of request 0,
# so request 0's affine replica holds work in flight and queued when the
# chaos kills it at its second chain
FLEET = dict(replicas=3, n_slots=2, clones=2, kill_at_chain=2)


def replay_emitted(prompt: list, tokens: list, k: int, ngram: int, steps: int) -> int:
    """How many of ``tokens`` (a greedy stream, its first token the
    prefill's) a greedy speculative engine holds after ``steps`` verify
    steps: each step accepts the drafts (:func:`draft_host`) while they
    equal the stream and adds the bonus token, as :func:`replay_spec`."""
    hist = list(prompt) + [tokens[0]]
    got = 1
    for _ in range(steps):
        if got >= len(tokens):
            break
        draft = draft_host(hist, k, ngram)
        n = 0
        while n < k and got + n < len(tokens) and draft[n] == tokens[got + n]:
            n += 1
        hist += tokens[got:got + n + 1]
        got += n + 1
    return min(got, len(tokens))


def serve_stream(torch, eng, prompts: list, new: int, recorder=None) -> dict:
    """The 12-request stream through ``eng`` under sync debug mode: tokens
    in submit order, wall seconds, tok/s, latency and TTFT percentiles,
    host and stream syncs."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request

    t0 = time.perf_counter()
    with real_syncs(torch) as real:
        ids = [eng.submit(Request(prompt=p, max_new_tokens=new, seed=i))
               for i, p in enumerate(prompts)]
        done = {c.request_id: c for c in eng.run_until_idle()}
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    comps = [done[i] for i in ids]
    lat, ttft = [c.latency_s for c in comps], [c.ttft_s for c in comps]
    return {"tokens": [c.tokens for c in comps], "reasons": [c.finish_reason for c in comps],
            "completions": comps, "wall_s": wall_s,
            "aggregate_tok_s": sum(len(c.tokens) for c in comps) / wall_s,
            "latency_p50_s": percentile(lat, 0.5), "latency_p95_s": percentile(lat, 0.95),
            "ttft_p50_s": percentile(ttft, 0.5), "ttft_p95_s": percentile(ttft, 0.95),
            "host_syncs": eng.n_host_syncs, "stream_syncs": real["count"],
            "stream_sync_sites": real["sites"], "chains": eng.n_chains,
            "prefills": eng.n_prefills}


def fault_leg(torch, eng, prompts: list, new: int, cancel_after: int) -> dict:
    """The chaos leg (FAULT_CHAOS is ``eng``'s chaos): the 12 requests, the
    deadline on FAULT_VICTIMS["deadline"], the queued cancel, ``cancel_after``
    steps, the active cancel, then ``drain()`` — all under sync debug mode;
    then a submit that must raise ``QueueClosed``."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import QueueClosed, Request

    v = FAULT_VICTIMS
    t0 = time.perf_counter()
    with real_syncs(torch) as real:
        ids = [eng.submit(Request(prompt=p, max_new_tokens=new, seed=i,
                                  deadline_s=FAULT_DEADLINE_S if i == v["deadline"] else None))
               for i, p in enumerate(prompts)]
        queued = eng.cancel(ids[v["cancel_queued"]])
        done = []
        for _ in range(cancel_after):
            done += eng.step()
        active = eng.cancel(ids[v["cancel_active"]])
        done += eng.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    try:
        eng.submit(Request(prompt=prompts[0], max_new_tokens=2))
        closed = False
    except QueueClosed:
        closed = True
    by_id = {c.request_id: c for c in done}
    return {"ids": ids, "done": [by_id.get(i) for i in ids], "real": real,
            "cancel_ok": [queued, active], "closed": closed, "wall_s": wall_s,
            "completions": len(done)}


def seen_syncs(run: dict, depth: int) -> int:
    """The host syncs sync debug mode can see: at depth 2 a chain lands by
    its event's wait, which it does not see (``bench.harness.count_host_syncs``),
    so only the refills' fetches count there."""
    return run["host_syncs"] - (run["chains"] if depth > 1 else 0)


def fault_gates(eng, rec, leg: dict, ref: dict, prompts: list, new: int,
                spec_k: int, depth: int) -> tuple:
    """The chaos leg's gates against the guarded run ``ref`` (a
    :func:`serve_stream` result of the same options); ``rec`` is ``eng``'s
    flight recorder, ``depth`` its pipeline depth. Returns the problems and
    the line's fields."""
    v, c = FAULT_VICTIMS, FAULT_CHAOS
    done, ref_toks = leg["done"], ref["tokens"]
    bad = []
    if leg["completions"] != len(prompts) or any(d is None for d in done):
        bad.append(f"{leg['completions']} completions for {len(prompts)} requests")
        return bad, {}
    want = {v["poisoned"]: "nonfinite", v["failed"]: "error", v["deadline"]: "deadline",
            v["cancel_queued"]: "cancelled", v["cancel_active"]: "cancelled"}
    reasons = [d.finish_reason for d in done]
    for i, d in enumerate(done):
        if d.finish_reason != want.get(i, "length"):
            bad.append(f"request {i} finished {d.finish_reason!r}, want "
                       f"{want.get(i, 'length')!r}")
        elif i not in want and d.tokens != ref_toks[i]:
            bad.append(f"request {i}, untouched by any fault, differs from the guarded run")
    poisoned = done[v["poisoned"]].tokens
    ref_p = ref_toks[v["poisoned"]]
    if spec_k:
        want_len = replay_emitted(prompts[v["poisoned"]], ref_p, spec_k, SPEC_NGRAM,
                                  c["nan_logit_step"])
    else:
        want_len = 1 + c["nan_logit_step"]
    if poisoned != ref_p[:want_len]:
        bad.append(f"the poisoned request kept {len(poisoned)} tokens, want the guarded "
                   f"run's first {want_len} (the steps before the poisoned one)")
    for name in ("deadline", "cancel_active"):
        t = done[v[name]].tokens
        if not 0 < len(t) < new or t != ref_toks[v[name]][:len(t)]:
            bad.append(f"the {name} victim's {len(t)} tokens are not a proper prefix of the "
                       "guarded run's")
    for name in ("failed", "cancel_queued"):
        if done[v[name]].tokens:
            bad.append(f"the {name} request has tokens")
    stats = eng.fault_stats()
    injected = {"nonfinite_quarantined": 1, "prefill_errors": 1, "deadline_expired": 1,
                "cancelled": 2}
    if {k: stats[k] for k in injected} != injected:
        bad.append(f"fault_stats {stats} != what was injected {injected}")
    # the failed prefill's slot: the next refill of that slot (the
    # recorder's events) must serve its request token-identically
    events = list(rec.events)
    (err,) = [e for e in events if e.get("fault_kind") == "prefill_error"]
    nxt = next((e for e in events[events.index(err):]
                if e["kind"] in ("prefill", "splice") and e["slot"] == err["slot"]), None)
    if nxt is None or reasons[nxt["rid"]] != "length" or done[nxt["rid"]].tokens != ref_toks[
            nxt["rid"]]:
        bad.append(f"the failed prefill's slot {err['slot']} did not serve its next request "
                   f"({nxt}) token-identically")
    budget = eng.n_chains + eng.n_prefills + eng.n_splices
    if eng.n_host_syncs != budget:
        bad.append(f"{eng.n_host_syncs} host syncs != {budget} chains + prefills + splices")
    real = leg["real"]["count"]
    seen = seen_syncs({"host_syncs": eng.n_host_syncs, "chains": eng.n_chains}, depth)
    if real > seen or real - seen != ref["stream_syncs"] - seen_syncs(ref, depth):
        bad.append(f"{real} stream syncs for {seen} host syncs sync debug mode sees; the "
                   f"guarded run {ref['stream_syncs']} for {seen_syncs(ref, depth)}: "
                   f"{leg['real']['sites']}")
    if not leg["closed"] or leg["cancel_ok"] != [True, True]:
        bad.append(f"QueueClosed after drain {leg['closed']}, cancels known {leg['cancel_ok']}")
    fields = {"reasons": reasons, "poisoned_tokens": len(poisoned),
              "poisoned_tokens_want": want_len,
              "deadline_victim_tokens": len(done[v["deadline"]].tokens),
              "cancel_active_tokens": len(done[v["cancel_active"]].tokens),
              "failed_slot_next_request": None if nxt is None else nxt["rid"],
              "fault_stats": stats, "host_syncs": eng.n_host_syncs,
              "stream_syncs": real, "stream_sync_sites": leg["real"]["sites"],
              "queue_closed_after_drain": leg["closed"], "wall_s": leg["wall_s"],
              "flight_faults": rec.n_faults}
    return bad, fields


def phase_serve_faults(torch, fa, gpu: str) -> dict:
    """``serve_1b_faults``: the 1b int8 cell (PRESET_1B, 4 slots, 12
    requests, prompts {16, 32, 48}, 32 new tokens, flash prefill). (a)
    guard off and (g) ``guard_nonfinite`` in turns (a, g, g, a): token-
    identical, equal host and stream syncs, tok/s of each. (c) the guard with FAULT_CHAOS, the
    deadline and the cancels (:func:`fault_leg`), a recorder riding along:
    :func:`fault_gates`; 113 int8 calls a forward and 16 flash launches a
    whole prefill, on their routes (the failed prefill launches none).
    Returns what serve_1b_flight and serve_1b_fleet reuse and the launch
    counts."""
    import dataclasses

    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        bind_params,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs import FlightRecorder
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

    cfg = TransformerConfig(**{**PRESET_1B, "n_layers": SERVE_LAYERS}, quantized=True)
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

    def mk_request(i: int) -> Request:
        return Request(prompt=spare[i % len(spare)], max_new_tokens=2 * new, seed=100 + i)

    for guard in (False, True):  # warmup
        warm = engine(guard_nonfinite=guard)
        warm.submit(Request(prompt=spare[0], max_new_tokens=16))
        warm.run_until_idle()
    torch.cuda.synchronize()
    runs, problems = [], []
    for arm in ("a", "g", "g", "a"):
        eng = engine(guard_nonfinite=arm == "g")
        quant.int8_matmul.launches = 0
        quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
        fa.flash_attention.launches["fwd"] = 0
        fa.flash_attention.routes["fwd"] = {"sm90": 0, "sm80": 0}
        run = serve_stream(torch, eng, timed, new)
        run.update(arm=arm, int8=quant.int8_matmul.launches,
                   int8_routes=dict(quant.int8_matmul.routes),
                   flash=fa.flash_attention.launches["fwd"],
                   flash_routes=dict(fa.flash_attention.routes["fwd"]))
        runs.append(run)
        emit({"phase": "serve_1b_faults", "arm": arm, "turn": len(runs),
              **{k: v for k, v in run.items() if k not in ("tokens", "completions")},
              "gpu": gpu})
        forwards = run["prefills"] + run["chains"] * tpl
        if run["int8"] != (layers * 7 + 1) * forwards or run["int8_routes"]["v1"]:
            problems.append(f"turn {len(runs)} ({arm}): int8_matmul {run['int8']} calls "
                            f"{run['int8_routes']}, want {layers * 7 + 1} x {forwards}, sm90")
        if run["flash"] != layers * run["prefills"] or run["flash_routes"]["sm80"] != run[
                "flash"]:
            problems.append(f"turn {len(runs)} ({arm}): flash_fwd {run['flash']} "
                            f"{run['flash_routes']}, want {layers} x {run['prefills']} f32")
        if run["host_syncs"] != run["chains"] + run["prefills"] or run["stream_syncs"] > run[
                "host_syncs"]:
            problems.append(f"turn {len(runs)} ({arm}): {run['host_syncs']} host syncs, "
                            f"{run['stream_syncs']} stream syncs for {run['chains']} chains "
                            f"+ {run['prefills']} prefills: {run['stream_sync_sites']}")
        if any(r != "length" for r in run["reasons"]) or run["tokens"] != runs[0]["tokens"]:
            problems.append(f"turn {len(runs)} ({arm}): not every request finished 'length' "
                            "with the first turn's tokens")
        if (run["host_syncs"], run["stream_syncs"]) != (runs[0]["host_syncs"],
                                                        runs[0]["stream_syncs"]):
            problems.append(f"turn {len(runs)} ({arm}): host and stream syncs "
                            f"{run['host_syncs']}, {run['stream_syncs']} != the first turn's")
    ref = runs[1]
    rec = FlightRecorder(capacity=4096)
    eng = engine(guard_nonfinite=True, chaos=ChaosConfig(**FAULT_CHAOS), flight=rec)
    quant.int8_matmul.launches = 0
    quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
    fa.flash_attention.launches["fwd"] = 0
    fa.flash_attention.routes["fwd"] = {"sm90": 0, "sm80": 0}
    leg = fault_leg(torch, eng, timed, new, cancel_after=1)
    bad, fields = fault_gates(eng, rec, leg, ref, timed, new, 0, 1)
    int8_calls, flash_calls = quant.int8_matmul.launches, fa.flash_attention.launches["fwd"]
    forwards = eng.n_prefills + eng.n_chains * tpl
    if int8_calls != (layers * 7 + 1) * forwards or quant.int8_matmul.routes["v1"]:
        bad.append(f"int8_matmul {int8_calls} calls {quant.int8_matmul.routes}, want "
                   f"{layers * 7 + 1} x {forwards}, all sm90")
    if flash_calls != layers * eng.n_prefills or fa.flash_attention.routes["fwd"]["sm80"] != \
            flash_calls:
        bad.append(f"flash_fwd {flash_calls} launches, want {layers} x {eng.n_prefills} "
                   "whole prefills on the f32 route")
    emit({"phase": "serve_1b_faults", "arm": "c", "chaos": FAULT_CHAOS,
          "deadline_s": FAULT_DEADLINE_S, "victims": FAULT_VICTIMS, **fields,
          "chains": eng.n_chains, "prefills": eng.n_prefills, "int8_matmul_launches": int8_calls,
          "flash_fwd_launches": flash_calls, "ok": not bad, "problems": bad, "gpu": gpu})
    problems += [f"arm c: {x}" for x in bad]
    by_arm = {a: [r for r in runs if r["arm"] == a] for a in ("a", "g")}
    summary = {
        "phase": "serve_1b_faults_summary",
        "aggregate_tok_s": {a: [r["aggregate_tok_s"] for r in rs] for a, rs in by_arm.items()},
        "latency_p50_s": {a: [r["latency_p50_s"] for r in rs] for a, rs in by_arm.items()},
        "host_syncs": {a: rs[0]["host_syncs"] for a, rs in by_arm.items()},
        "stream_syncs": {a: rs[0]["stream_syncs"] for a, rs in by_arm.items()},
        "ok": not problems, "gpu": gpu,
    }
    emit(summary)
    if problems:
        raise AssertionError("; ".join(problems))
    return {"model": model, "cfg": cfg, "prompts": timed, "new": new, "ref": ref,
            "int8": {f"serve_1b_faults_{r['arm']}{i + 1}": r["int8"] for i, r in enumerate(runs)}
            | {"serve_1b_faults_c": int8_calls},
            "flash": {"serve_1b_faults_c": flash_calls}}


def phase_serve_paged_faults(torch, pa, gpu: str) -> dict:
    """``serve_1b_gqa_paged_faults``: serve_1b_paged's kernel arm (c) (the
    1b-gqa preset, window 4096, 48 pages of 64, f32 pool) with
    ``speculative_k=2`` and ``pipeline_depth=2``: (g) the guard, then (c)
    the guard with FAULT_CHAOS, the deadline and the cancels, at the
    observed boundary (the active cancel after two steps). :func:`fault_gates`
    (the poisoned request's tokens: the verify steps before the poisoned
    one, replayed on the host over (g)'s tokens); no page in use after the
    drain; one paged launch a layer a verify forward and 113 int8 calls a
    forward, all sm90. Returns the launch counts."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs import FlightRecorder
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

    st = PAGED_STREAM
    cfg = TransformerConfig(**{**PRESET_1B_GQA, "n_layers": SERVE_LAYERS}, quantized=True)
    params = init_quantized_lm(cfg, seed=0, device="cuda")
    model = TransformerLM(cfg)
    rng = np.random.Generator(np.random.PCG64(12))
    prompts = [rng.integers(0, cfg.vocab_size, (st["prompts"][i % 3],)).tolist()
               for i in range(st["requests"])]
    options = dict(PAGED_ARMS["c"], page_size=st["page_size"], pool_pages=st["pool_pages"],
                   speculative_k=SPEC_K, spec_ngram=SPEC_NGRAM, pipeline_depth=2,
                   guard_nonfinite=True)
    layers, tpl = cfg.n_layers, st["tokens_per_launch"]

    def engine(**kw):
        return ServeEngine(model, params, n_slots=st["n_slots"], tokens_per_launch=tpl,
                           max_queue=64, device="cuda", **options, **kw)

    warm = engine()
    warm.submit(Request(prompt=prompts[0], max_new_tokens=st["new"], seed=99))
    warm.run_until_idle()
    del warm
    torch.cuda.synchronize()
    rows, problems = {}, []
    for arm in ("g", "c"):
        rec = FlightRecorder(capacity=4096)
        eng = engine(**({} if arm == "g" else dict(chaos=ChaosConfig(**FAULT_CHAOS), flight=rec)))
        pa.paged_attention.launches = 0
        pa.paged_attention.routes = {"sm90": 0, "v1": 0}
        quant.int8_matmul.launches = 0
        quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
        if arm == "g":
            ref = serve_stream(torch, eng, prompts, st["new"])
            fields = {k: v for k, v in ref.items() if k not in ("tokens", "completions")}
            bad = [] if (all(r == "length" for r in ref["reasons"])
                         and ref["stream_syncs"] <= seen_syncs(ref, 2)
                         and ref["host_syncs"] == eng.n_chains + eng.n_prefills) else [
                f"not every request finished 'length', or syncs {ref['host_syncs']} host, "
                f"{ref['stream_syncs']} stream for {eng.n_chains} chains + {eng.n_prefills} "
                "prefills"]
        else:
            leg = fault_leg(torch, eng, prompts, st["new"], cancel_after=2)
            bad, fields = fault_gates(eng, rec, leg, ref, prompts, st["new"], SPEC_K, 2)
        verify, launches = eng.spec_stats()["n_verify_forwards"], pa.paged_attention.launches
        int8_calls = quant.int8_matmul.launches
        if launches != layers * verify or pa.paged_attention.routes != {"sm90": launches,
                                                                          "v1": 0}:
            bad.append(f"paged_attention {launches} launches {pa.paged_attention.routes}, want "
                       f"{layers} x {verify} verify forwards, all sm90")
        if int8_calls != (layers * 7 + 1) * (eng.n_prefills + verify) or \
                quant.int8_matmul.routes["v1"]:
            bad.append(f"int8_matmul {int8_calls} calls {quant.int8_matmul.routes}, want "
                       f"{layers * 7 + 1} x ({eng.n_prefills} prefills + {verify}), all sm90")
        pstats = eng.page_stats()
        if pstats["pages_in_use"] != 0 or pstats["pages_high_water"] > st["pool_pages"]:
            bad.append(f"pages after the drain: {pstats}")
        rows[arm] = {"paged_attention_launches": launches, "int8_matmul_launches": int8_calls,
                     "n_verify_forwards": verify}
        emit({"phase": "serve_1b_gqa_paged_faults", "arm": arm, "options": {
                  k: v for k, v in options.items() if k != "guard_nonfinite"},
              "guard_nonfinite": True, **({"chaos": FAULT_CHAOS, "deadline_s": FAULT_DEADLINE_S}
                                          if arm == "c" else {}),
              **fields, **rows[arm], "chains": eng.n_chains, "prefills": eng.n_prefills,
              "spec_stats": eng.spec_stats(), "page_stats": pstats, "ok": not bad,
              "problems": bad, "gpu": gpu})
        problems += [f"arm {arm}: {x}" for x in bad]
    if problems:
        raise AssertionError("; ".join(problems))
    return rows


def phase_serve_flight(torch, gpu: str, ctx: dict) -> dict:
    """``serve_1b_flight``: serve_1b_faults' (g) stream through an engine
    with a ``FlightRecorder``: tokens, host and stream syncs equal (g)'s;
    every request's span complete (submit, pop, first token, completion);
    event counts reconciled with the engine's counters and the
    completions; the histograms' p50/p95 of latency and TTFT within one
    bucket of the sorted completions'."""
    from pytorch_distributed_training_tutorials_tpu_torch.obs import FlightRecorder
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    ref = ctx["ref"]
    rec = FlightRecorder(capacity=4096)
    eng = ServeEngine(ctx["model"], None, n_slots=4, tokens_per_launch=8, max_queue=64,
                      device="cuda", guard_nonfinite=True, flight=rec)
    run = serve_stream(torch, eng, ctx["prompts"], ctx["new"])
    bad = []
    if run["tokens"] != ref["tokens"]:
        bad.append("the recorder changed the tokens")
    if (run["host_syncs"], run["stream_syncs"]) != (ref["host_syncs"], ref["stream_syncs"]):
        bad.append(f"host, stream syncs {run['host_syncs']}, {run['stream_syncs']} != (g)'s "
                   f"{ref['host_syncs']}, {ref['stream_syncs']}: {run['stream_sync_sites']}")
    n = len(ctx["prompts"])
    spans = {s["rid"]: s for s in rec.done_spans}
    keys = ("submit_t", "queue_pop_t", "prefill_t", "complete_t", "finish_reason")
    span_full = len(spans) == n and all(all(k in s for k in keys) for s in spans.values())
    kc = rec.kind_counts
    counts_ok = (kc["submit"] == kc["queue_pop"] == kc["complete"] == n
                 and kc["prefill"] == eng.n_prefills
                 and kc["chain_start"] == kc["chain_end"] == eng.n_chains
                 and sum(s["tokens"] for s in spans.values()) == sum(map(len, run["tokens"])))
    timing_ok = span_full and all(
        abs(spans[c.request_id]["e2e_s"] - c.latency_s) < 1e-5
        and abs(spans[c.request_id]["ttft_s"] - c.ttft_s) < 1e-5 for c in run["completions"])
    hist = {}
    for name, vals in (("e2e", [c.latency_s for c in run["completions"]]),
                       ("ttft", [c.ttft_s for c in run["completions"]])):
        h = rec.hist[name]
        for q in (0.5, 0.95):
            sv = sorted(vals)[max(1, math.ceil(q * len(vals))) - 1]
            hist[f"{name}_p{int(q * 100)}"] = {
                "histogram": h.quantile(q), "sorted": sv,
                "ok": abs(h.quantile(q) - sv) <= h.rel_error_bound * max(sv, h.min_value) + 1e-9}
    if not (span_full and counts_ok and timing_ok):
        bad.append(f"spans complete {span_full}, counts {dict(kc)} reconciled {counts_ok}, "
                   f"timings {timing_ok}")
    if not all(v["ok"] for v in hist.values()):
        bad.append(f"histogram quantiles beyond one bucket of the sort: {hist}")
    emit({"phase": "serve_1b_flight", **{k: v for k, v in run.items()
                                          if k not in ("tokens", "completions")},
          "ref_aggregate_tok_s": ref["aggregate_tok_s"], "span_full": span_full,
          "event_counts": dict(kc), "counts_reconciled": counts_ok, "timings_ok": timing_ok,
          "histogram_vs_sort": hist, "flight_stats": eng.flight_stats(), "ok": not bad,
          "problems": bad, "gpu": gpu})
    if bad:
        raise AssertionError("; ".join(bad))
    return {"events": rec.n_events}


def phase_serve_fleet(torch, gpu: str, ctx: dict) -> dict:
    """``serve_1b_fleet``: FLEET["replicas"] engines over serve_1b_faults'
    model (one set of 1b weights), each with a recorder on a shared epoch,
    behind a ``FleetRouter``; the stream is (g)'s 12 requests and
    FLEET["clones"] copies of request 0. Leg 1, no fault: every request
    token-identical to (g) (the single engine), the ledger clean. Leg 2,
    ``FleetChaosConfig`` kills request 0's affine replica at its
    FLEET["kill_at_chain"]-th chain, holding work in flight (completed
    ``"replica_dead"``) and queued (re-dispatched): the ledger verifies,
    every request completes once, the re-dispatched ones token-identical to
    leg 1, the killed replica's chains frozen at the kill, the fleet's host
    syncs the sum of the replicas' chains + prefills + splices and its
    stream syncs no more. Returns the int8 launches of leg 2."""
    from pytorch_distributed_training_tutorials_tpu_torch.obs import FlightRecorder
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        FleetRouter,
        Request,
        ServeEngine,
        affinity_hash,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import FleetChaosConfig

    prompts = ctx["prompts"] + [ctx["prompts"][0]] * FLEET["clones"]
    want = ctx["ref"]["tokens"] + [ctx["ref"]["tokens"][0]] * FLEET["clones"]
    new, n_rep = ctx["new"], FLEET["replicas"]
    target = affinity_hash(prompts[0], adapter=0, depth=16) % n_rep

    def leg(chaos):
        t0 = time.perf_counter()
        engines = [ServeEngine(ctx["model"], None, n_slots=FLEET["n_slots"], tokens_per_launch=8,
                               max_queue=64, device="cuda",
                               flight=FlightRecorder(capacity=4096, t0=t0))
                   for _ in range(n_rep)]
        fr = FleetRouter(engines, chaos=chaos, flight=FlightRecorder(capacity=1024, t0=t0))
        quant.int8_matmul.launches = 0
        t1 = time.perf_counter()
        with real_syncs(torch) as real:
            gids = [fr.submit(Request(prompt=p, max_new_tokens=new, seed=i))
                    for i, p in enumerate(prompts)]
            done = {}
            for c in fr.run_until_idle():
                done.setdefault(c.request_id, []).append(c)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t1
        return fr, engines, gids, done, real, wall_s, quant.int8_matmul.launches

    rows, problems = {}, []
    for name, chaos in (("ok", None), ("kill", FleetChaosConfig(
            kill_replica=target, kill_at_chain=FLEET["kill_at_chain"]))):
        fr, engines, gids, done, real, wall_s, int8_calls = leg(chaos)
        bad = []
        if sorted(done) != sorted(gids) or any(len(v) != 1 for v in done.values()):
            bad.append(f"completions {({g: len(v) for g, v in done.items()})} for gids {gids}")
        comps = [done[g][0] for g in gids]
        if fr.ledger.verify():
            bad.append(f"ledger: {fr.ledger.verify()}")
        syncs = sum(e.n_host_syncs for e in engines)
        budget = sum(e.n_chains + e.n_prefills + e.n_splices for e in engines)
        if syncs != budget or real["count"] > syncs:
            bad.append(f"{syncs} host syncs, {real['count']} stream syncs; the replicas' "
                       f"budget {budget}: {real['sites']}")
        reasons = [c.finish_reason for c in comps]
        if name == "ok":
            if reasons != ["length"] * len(prompts) or [c.tokens for c in comps] != want:
                bad.append("the fault-free fleet is not token-identical to the single engine")
            ok_tokens = [c.tokens for c in comps]
        else:
            dead = [i for i, r in enumerate(reasons) if r == "replica_dead"]
            moved = fr.ledger.n_redispatched
            if fr.replica_states()[target] != "dead" or not dead or moved < 1:
                bad.append(f"replica {target} {fr.replica_states()[target]!r}: {len(dead)} "
                           f"in flight died, {moved} queued moved (want >= 1 each)")
            for i, c in enumerate(comps):
                if c.finish_reason == "length" and c.tokens != ok_tokens[i]:
                    bad.append(f"request {i} differs from the fault-free fleet")
                elif c.finish_reason not in ("length", "replica_dead"):
                    bad.append(f"request {i} finished {c.finish_reason!r}")
            if engines[target].n_chains != FLEET["kill_at_chain"]:
                bad.append(f"the killed replica ran {engines[target].n_chains} chains, want "
                           f"{FLEET['kill_at_chain']} (frozen at its kill)")
        rows[name] = {"int8_matmul_launches": int8_calls}
        emit({"phase": "serve_1b_fleet", "leg": name, "replicas": n_rep,
              "n_slots": FLEET["n_slots"], "requests": len(prompts), "killed": target
              if chaos else None, "kill_at_chain": FLEET["kill_at_chain"] if chaos else None,
              "reasons": reasons, "replica_states": fr.replica_states(),
              "replica_chains": [e.n_chains for e in engines],
              "replica_host_syncs": [e.n_host_syncs for e in engines],
              "host_syncs": syncs, "budget": budget, "stream_syncs": real["count"],
              "router_stats": fr.router_stats(), "wall_s": wall_s,
              "aggregate_tok_s": sum(len(c.tokens) for c in comps) / wall_s,
              "fleet_flight": {k: v for k, v in (fr.fleet_flight_summary() or {}).items()
                               if k.startswith(("flight_", "e2e_p", "ttft_p"))},
              "int8_matmul_launches": int8_calls, "ok": not bad, "problems": bad, "gpu": gpu})
        problems += [f"leg {name}: {x}" for x in bad]
    if problems:
        raise AssertionError("; ".join(problems))
    return rows


# SLO preemption (serve_1b_slo): the 1b int8 preset at full width,
# SERVE_LAYERS deep, with flash prefill, 4 slots, priority_classes=2 — twelve class-1 requests
# (phase 4's prompts {16, 32, 48}, 32 new tokens), then, once every slot
# is busy (after SLO_STREAM["high_after"] steps), four class-0 arrivals;
# each leg beside the SLO-off engine on the same stream. The paged leg
# (serve_1b_gqa_paged_slo): the 1b-gqa preset (window 4096) over a pool of
# 48 pages of 64 with the paged kernel — two class-1 requests of 1500-token
# prompts hold every page (24 each) with two slots free when two class-0
# requests of 480 tokens arrive: pool pressure, not slot pressure
SLO_STREAM = dict(n_slots=4, tokens_per_launch=8, low=12, high=4, prompts=(16, 32, 48),
                  new=32, high_after=2, temperature=0.8)
SLO_PAGED = dict(n_slots=4, tokens_per_launch=8, page_size=64, pool_pages=48,
                 low=(1500, 1500), high=(480, 480), new=32, high_after=1)
# the chaos leg: slot 0 force-preempted once at chain 1 of a 4-request
# class-1 stream, with no pressure
SLO_CHAOS = dict(requests=4, preempt_slot=0, preempt_at_chain=1)


def timed_calls(torch, fn, log: list):
    """``fn`` wrapped so that each call appends (CUDA start event, end
    event, host seconds) to ``log``."""
    def wrapped(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        out = fn(*a, **k)
        end.record()
        log.append((start, end, time.perf_counter() - t))
        return out
    return wrapped


def slo_stream(torch, eng, low: list, high: list, new: int, high_after: int) -> dict:
    """Submit ``low`` (class 1 on a priority engine, else the FIFO's one
    class), step ``high_after`` times, submit ``high`` (class 0), run to
    idle — under sync debug mode, the swap calls timed. Returns the
    completions in submit order, the wall time, the stream syncs and the
    swaps' bytes and times."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request

    slo = eng.slo_stats()["priority_classes"] > 0
    outs, ins, nbytes = [], [], []
    if slo:
        swap_out = eng._swap_out

        def counted(slot):
            rid = eng._slots[slot].request.request_id
            swap_out(slot)
            nbytes.append(eng._swapped[rid].packed.numel())

        eng._swap_out = timed_calls(torch, counted, outs)
        eng._swap_in = timed_calls(torch, eng._swap_in, ins)
    base = (eng.n_prefills, eng.n_splices, eng.n_chains, eng.n_host_syncs)
    t0 = time.perf_counter()
    done = []
    with real_syncs(torch) as real:
        ids = [eng.submit(Request(prompt=p, max_new_tokens=new, seed=i, priority=int(slo)))
               for i, p in enumerate(low)]
        for _ in range(high_after):
            done += eng.step()
        ids += [eng.submit(Request(prompt=p, max_new_tokens=new, seed=len(low) + i))
                for i, p in enumerate(high)]
        done += eng.run_until_idle()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    by_id = {c.request_id: c for c in done}
    comps = [by_id.get(i) for i in ids]
    return {
        "comps": comps, "wall_s": wall_s, "stream_syncs": real["count"],
        "stream_sync_sites": real["sites"],
        "prefills": eng.n_prefills - base[0], "splices": eng.n_splices - base[1],
        "chains": eng.n_chains - base[2], "host_syncs": eng.n_host_syncs - base[3],
        "swaps_out": eng.n_swaps_out if slo else 0, "swaps_in": eng.n_swaps_in if slo else 0,
        "swap_bytes": nbytes,
        "swap_out_ms": [s.elapsed_time(e) for s, e, _ in outs],
        "swap_out_host_ms": [h * 1e3 for _, _, h in outs],
        "swap_in_ms": [s.elapsed_time(e) for s, e, _ in ins],
        "swap_in_host_ms": [h * 1e3 for _, _, h in ins],
    }


def slo_gates(run: dict, ref: dict, new: int, layers: int, tpl: int, launches: dict) -> list:
    """The gates of one SLO-on stream against its SLO-off twin: every
    request complete with ``new`` tokens equal to the twin's, at least one
    swap out and as many in, host syncs = chains + prefills + splices +
    swaps out with the stream syncs no more, 7 int8 calls a layer and the
    head's a forward on the sm90 route, and where counted one flash launch
    a layer a whole prefill (f32 route) and one paged call a layer a
    decode step (sm90)."""
    bad = []
    comps = run["comps"]
    if any(c is None or c.finish_reason != "length" or len(c.tokens) != new for c in comps):
        bad.append("finish " + str([None if c is None else (c.finish_reason, len(c.tokens))
                                    for c in comps]))
    elif [c.tokens for c in comps] != [c.tokens for c in ref["comps"]]:
        diff = [i for i, (a, b) in enumerate(zip(comps, ref["comps"])) if a.tokens != b.tokens]
        bad.append(f"requests {diff}: tokens differ from the SLO-off engine's")
    if run["swaps_out"] < 1 or run["swaps_in"] != run["swaps_out"]:
        bad.append(f"swaps out {run['swaps_out']}, in {run['swaps_in']}")
    budget = run["chains"] + run["prefills"] + run["splices"] + run["swaps_out"]
    if run["host_syncs"] != budget or run["stream_syncs"] > budget:
        bad.append(f"{run['host_syncs']} host syncs, {run['stream_syncs']} stream syncs; "
                   f"budget {budget}: {run['stream_sync_sites']}")
    forwards = run["prefills"] + run["chains"] * tpl
    per_forward = layers * 7 + 1
    if launches["int8"] != per_forward * forwards or launches["int8_routes"]["v1"]:
        bad.append(f"int8 {launches['int8']} {launches['int8_routes']}, want "
                   f"{per_forward} x {forwards} sm90")
    if "paged" in launches:
        want = layers * run["chains"] * tpl
        if launches["paged"] != want or launches["paged_routes"]["v1"]:
            bad.append(f"paged {launches['paged']} {launches['paged_routes']}, want {want} sm90")
    if "flash" in launches:
        want = layers * run["prefills"]
        if launches["flash"] != want or launches["flash_routes"]["sm80"] != want:
            bad.append(f"flash {launches['flash']} {launches['flash_routes']}, want {want} "
                       "on the f32 route")
    return bad


def reset_counts(quant, fa=None, pa=None) -> None:
    """Zero the serving kernels' launch and route counters."""
    quant.int8_matmul.launches = 0
    quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
    if fa is not None:
        fa.flash_attention.launches["fwd"] = 0
        fa.flash_attention.routes["fwd"] = {"sm90": 0, "sm80": 0}
    if pa is not None:
        pa.paged_attention.launches = 0
        pa.paged_attention.routes = {"sm90": 0, "v1": 0}


def read_counts(quant, fa=None, pa=None) -> dict:
    out = {"int8": quant.int8_matmul.launches, "int8_routes": dict(quant.int8_matmul.routes)}
    if fa is not None:
        out.update(flash=fa.flash_attention.launches["fwd"],
                   flash_routes=dict(fa.flash_attention.routes["fwd"]))
    if pa is not None:
        out.update(paged=pa.paged_attention.launches,
                   paged_routes=dict(pa.paged_attention.routes))
    return out


def ttft(comps: list) -> dict:
    vals = [c.ttft_s for c in comps]
    return {"p50_s": percentile(vals, 0.5), "p95_s": percentile(vals, 0.95)}


def phase_serve_slo(torch, quant, fa, pa, gpu: str, dev: str = "cuda") -> dict:
    """``serve_1b_slo``: SLO preemption by KV swap on the 1b preset
    (SLO_STREAM), each leg beside the SLO-off engine on the same stream:
    (a) greedy and (s) sampled (temperature SLO_STREAM["temperature"]),
    gated by ``slo_gates`` — tokens equal the SLO-off engine's, swaps out
    and in, host syncs chains + prefills + splices + swaps out, 113 int8
    calls a forward and 16 flash launches a whole prefill on their routes;
    (c) the chaos force-preempt (SLO_CHAOS) token-exact to the clean run;
    then ``serve_1b_gqa_paged_slo`` (SLO_PAGED) under pool pressure with the
    paged kernel: the same gates, 16 paged launches a decode step (sm90),
    no page left. Numbers: swaps, bytes a swap, swap-out and swap-in ms
    (CUDA events) and host ms, class-0 TTFT p50/p95 with SLO on and off.
    Returns the launches by leg."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

    st = SLO_STREAM
    cfg = TransformerConfig(**{**PRESET_1B, "n_layers": SERVE_LAYERS}, quantized=True,
                            attention_fn=fa.flash_attention)
    params = init_quantized_lm(cfg, seed=0, device=dev)
    model = TransformerLM(cfg)
    rng = np.random.Generator(np.random.PCG64(20))
    n = st["low"] + st["high"]
    prompts = [rng.integers(0, cfg.vocab_size, (st["prompts"][i % 3],)).tolist()
               for i in range(n)]
    low, high = prompts[:st["low"]], prompts[st["low"]:]
    tpl, layers = st["tokens_per_launch"], cfg.n_layers

    def engine(**kw):
        return ServeEngine(model, params, n_slots=st["n_slots"], tokens_per_launch=tpl,
                           max_queue=64, device=dev, **kw)

    warm = engine(priority_classes=2)  # first launches, cuBLAS handles
    warm.submit(Request(prompt=low[0], max_new_tokens=2, seed=99, priority=1))
    warm.run_until_idle()
    del warm
    out, problems, launches = {}, [], {}
    for leg, temp in (("a", 0.0), ("s", st["temperature"])):
        runs = {}
        for slo in (False, True):
            eng = engine(temperature=temp, **({"priority_classes": 2} if slo else {}))
            reset_counts(quant, fa)
            runs[slo] = slo_stream(torch, eng, low, high, st["new"], st["high_after"])
            runs[slo]["launches"] = read_counts(quant, fa)
            del eng
        on, off = runs[True], runs[False]
        bad = slo_gates(on, off, st["new"], layers, tpl, on["launches"])
        launches[f"serve_1b_slo_{leg}"] = on["launches"]
        hi_on, hi_off = on["comps"][st["low"]:], off["comps"][st["low"]:]
        emit({"phase": "serve_1b_slo", "leg": leg, "temperature": temp,
              "n_slots": st["n_slots"], "requests": {"class_1": st["low"], "class_0": st["high"]},
              "prompt_lengths": st["prompts"], "new_tokens": st["new"],
              "class_0_after_steps": st["high_after"],
              "swaps_out": on["swaps_out"], "swaps_in": on["swaps_in"],
              "swap_bytes": on["swap_bytes"], "swap_out_ms": on["swap_out_ms"],
              "swap_out_host_ms": on["swap_out_host_ms"], "swap_in_ms": on["swap_in_ms"],
              "swap_in_host_ms": on["swap_in_host_ms"],
              "class_0_ttft_slo_on": ttft(hi_on), "class_0_ttft_slo_off": ttft(hi_off),
              "class_1_ttft_slo_on": ttft(on["comps"][:st["low"]]),
              "class_1_ttft_slo_off": ttft(off["comps"][:st["low"]]),
              "class_0_latency_p95_s": {"on": percentile([c.latency_s for c in hi_on], 0.95),
                                        "off": percentile([c.latency_s for c in hi_off], 0.95)},
              "prefills": on["prefills"], "chains": [on["chains"], off["chains"]],
              "host_syncs": [on["host_syncs"], off["host_syncs"]],
              "stream_syncs": [on["stream_syncs"], off["stream_syncs"]],
              "wall_s": [on["wall_s"], off["wall_s"]],
              "tok_s": [n * st["new"] / on["wall_s"], n * st["new"] / off["wall_s"]],
              "launches": on["launches"], "ok": not bad, "problems": bad, "gpu": gpu})
        problems += [f"{leg}: {x}" for x in bad]
    # (c) the chaos force-preempt: no pressure, one swap, token-exact
    ch = SLO_CHAOS
    runs = {}
    for name, kw in (("clean", {}), ("chaos", dict(priority_classes=2, chaos=ChaosConfig(
            preempt_slot=ch["preempt_slot"], preempt_at_chain=ch["preempt_at_chain"])))):
        eng = engine(**kw)
        reset_counts(quant, fa)
        runs[name] = slo_stream(torch, eng, low[:ch["requests"]], [], st["new"], 0)
        runs[name]["launches"] = read_counts(quant, fa)
    bad = slo_gates(runs["chaos"], runs["clean"], st["new"], layers, tpl,
                    runs["chaos"]["launches"])
    if runs["chaos"]["swaps_out"] != 1:
        bad.append(f"the chaos preempt fired {runs['chaos']['swaps_out']} times, want 1")
    launches["serve_1b_slo_c"] = runs["chaos"]["launches"]
    emit({"phase": "serve_1b_slo", "leg": "c", "chaos": ch,
          "swaps_out": runs["chaos"]["swaps_out"], "swap_bytes": runs["chaos"]["swap_bytes"],
          "swap_out_ms": runs["chaos"]["swap_out_ms"], "swap_in_ms": runs["chaos"]["swap_in_ms"],
          "host_syncs": runs["chaos"]["host_syncs"], "launches": runs["chaos"]["launches"],
          "ok": not bad, "problems": bad, "gpu": gpu})
    problems += [f"c: {x}" for x in bad]
    del params, model
    torch.cuda.empty_cache()
    paged = phase_serve_gqa_paged_slo(torch, quant, pa, gpu, dev)
    problems += paged["problems"]
    launches["serve_1b_gqa_paged_slo"] = paged["launches"]
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def phase_serve_gqa_paged_slo(torch, quant, pa, gpu: str, dev: str = "cuda") -> dict:
    """``serve_1b_gqa_paged_slo`` (inside ``serve_1b_slo``): SLO_PAGED on
    the 1b-gqa preset with the paged kernel, beside the SLO-off paged
    engine: the class-0 requests find free slots but no free pages, so the
    newest class-1 request swaps out (its 24 pages back to the pool) and
    back in later; ``slo_gates`` with the paged kernel's launches, and no
    page in use at the end."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    st = SLO_PAGED
    cfg = TransformerConfig(**{**PRESET_1B_GQA, "n_layers": SERVE_LAYERS}, quantized=True)
    params = init_quantized_lm(cfg, seed=0, device=dev)
    model = TransformerLM(cfg)
    rng = np.random.Generator(np.random.PCG64(21))
    low = [rng.integers(0, cfg.vocab_size, (p,)).tolist() for p in st["low"]]
    high = [rng.integers(0, cfg.vocab_size, (p,)).tolist() for p in st["high"]]
    tpl = st["tokens_per_launch"]

    def engine(**kw):
        return ServeEngine(model, params, n_slots=st["n_slots"], tokens_per_launch=tpl,
                           max_queue=64, device=dev, paged=True, paged_kernel=True,
                           page_size=st["page_size"], pool_pages=st["pool_pages"], **kw)

    warm = engine()
    warm.submit(Request(prompt=high[0][:16], max_new_tokens=2, seed=99))
    warm.run_until_idle()
    del warm
    runs, pages_left = {}, {}
    for slo in (False, True):
        eng = engine(**({"priority_classes": 2} if slo else {}))
        reset_counts(quant, pa=pa)
        runs[slo] = slo_stream(torch, eng, low, high, st["new"], st["high_after"])
        runs[slo]["launches"] = read_counts(quant, pa=pa)
        pages_left[slo] = eng.page_stats()["pages_in_use"]
        del eng
    on, off = runs[True], runs[False]
    bad = slo_gates(on, off, st["new"], cfg.n_layers, tpl, on["launches"])
    if pages_left != {False: 0, True: 0}:
        bad.append(f"pages in use at the end: {pages_left}")
    hi_on, hi_off = on["comps"][len(low):], off["comps"][len(low):]
    emit({"phase": "serve_1b_gqa_paged_slo", "n_slots": st["n_slots"],
          "page_size": st["page_size"], "pool_pages": st["pool_pages"],
          "class_1_prompts": st["low"], "class_0_prompts": st["high"], "new_tokens": st["new"],
          "swaps_out": on["swaps_out"], "swaps_in": on["swaps_in"],
          "swap_bytes": on["swap_bytes"], "swap_out_ms": on["swap_out_ms"],
          "swap_out_host_ms": on["swap_out_host_ms"], "swap_in_ms": on["swap_in_ms"],
          "swap_in_host_ms": on["swap_in_host_ms"],
          "class_0_ttft_slo_on": ttft(hi_on), "class_0_ttft_slo_off": ttft(hi_off),
          "chains": [on["chains"], off["chains"]], "host_syncs": [on["host_syncs"],
                                                                   off["host_syncs"]],
          "stream_syncs": [on["stream_syncs"], off["stream_syncs"]],
          "wall_s": [on["wall_s"], off["wall_s"]], "launches": on["launches"],
          "ok": not bad, "problems": bad, "gpu": gpu})
    del params, model
    torch.cuda.empty_cache()
    return {"problems": [f"gqa_paged: {x}" for x in bad], "launches": on["launches"]}


# disaggregation (serve_1b_disagg): a 1-prefill + 2-decode fleet of 1b
# engines (int8 weights, SERVE_LAYERS deep, flash prefill) in one process on card 0 behind a
# FleetRouter, one decode engine paged with the kernel; phase 4's stream
# (12 requests, prompts {16, 32, 48}, 32 new tokens), greedy, then a
# sampled leg of DISAGG["sampled"] requests
DISAGG = dict(n_slots=4, tokens_per_launch=8, requests=12, prompts=(16, 32, 48), new=32,
              page_size=64, pool_pages=32, sampled=4, temperature=0.8)


def phase_serve_disagg(torch, quant, fa, pa, gpu: str, dev: str = "cuda") -> dict:
    """``serve_1b_disagg``: DISAGG's fleet against the monolithic engines
    (whole-slot, and paged with the kernel for the requests the paged
    decode engine served). Gates: every request's tokens equal the
    monolithic engine's of its decode engine's cache; handoffs moved =
    requests, the ledger clean; the prefill engine made 0 host syncs (and
    alone, under sync debug mode, 0 stream syncs) and each decode engine's
    syncs are its chains + handoffs in; reading and setting a CUDA
    generator's state raises nothing under sync debug mode "error"; 113
    int8 calls a forward (prefill and decode), 16 flash launches a prefill
    (f32 route) and 16 paged launches a paged decode step, all on their
    routes. Numbers: handoff bytes, TTFT p50/p95 and tok/s of the fleet
    and of the monolithic engine. A sampled leg (temperature
    DISAGG["temperature"]): the fleet's draws equal the monolithic
    engines'."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        FleetRouter,
        Request,
        ServeEngine,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve.slots import tree_nbytes

    st = DISAGG
    cfg = TransformerConfig(**{**PRESET_1B, "n_layers": SERVE_LAYERS}, quantized=True,
                            attention_fn=fa.flash_attention)
    params = init_quantized_lm(cfg, seed=0, device=dev)
    rng = np.random.Generator(np.random.PCG64(22))
    prompts = [rng.integers(0, cfg.vocab_size, (st["prompts"][i % 3],)).tolist()
               for i in range(st["requests"])]
    tpl, per_forward = st["tokens_per_launch"], cfg.n_layers * 7 + 1
    paged_kw = dict(paged=True, paged_kernel=True, page_size=st["page_size"],
                    pool_pages=st["pool_pages"])

    def engine(**kw):
        return ServeEngine(TransformerLM(cfg), params, n_slots=st["n_slots"],
                           tokens_per_launch=tpl, max_queue=64, device=dev, **kw)

    def reqs(n):
        return [Request(prompt=p, max_new_tokens=st["new"], seed=i)
                for i, p in enumerate(prompts[:n])]

    # a CUDA generator's state is host data: reading and setting it must
    # not synchronize (sync debug mode "error" raises on a sync)
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.randn(8, device=dev, generator=gen)
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen.set_state(gen.get_state())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # warm up every engine kind; then the prefill engine alone under sync
    # debug mode: no stream sync
    pre_alone = engine(role="prefill")
    with real_syncs(torch) as pre_real:
        for r in reqs(4):
            pre_alone.submit(r)
        pre_alone.run_until_idle()
    for kw in ({}, paged_kw):
        warm = engine(**kw)
        warm.submit(Request(prompt=prompts[0], max_new_tokens=2, seed=99))
        warm.run_until_idle()
    del pre_alone, warm
    problems, rows, launches = [], {}, {}
    for leg, n, temp in (("greedy", st["requests"], 0.0),
                         ("sampled", st["sampled"], st["temperature"])):
        mono = {}
        for name, kw in (("whole", {}), ("paged", paged_kw)):
            eng = engine(temperature=temp, **kw)
            t0 = time.perf_counter()
            ids = [eng.submit(r) for r in reqs(n)]
            done = {c.request_id: c for c in eng.run_until_idle()}
            torch.cuda.synchronize()
            mono[name] = {"comps": [done[i] for i in ids], "wall_s": time.perf_counter() - t0}
            del eng
        engines = [engine(role="prefill", temperature=temp),
                   engine(role="decode", temperature=temp),
                   engine(role="decode", temperature=temp, **paged_kw)]
        fr = FleetRouter(engines)
        take, handoff_bytes = engines[0].take_handoff, []

        def taking(rid, take=take, handoff_bytes=handoff_bytes):
            h = take(rid)
            handoff_bytes.append(tree_nbytes(h.segment))
            return h

        engines[0].take_handoff = taking
        reset_counts(quant, fa, pa)
        t0 = time.perf_counter()
        with real_syncs(torch) as real:
            gids = [fr.submit(r) for r in reqs(n)]
            done = {c.request_id: c for c in fr.run_until_idle()}
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts(quant, fa, pa)
        comps = [done.get(g) for g in gids]
        served_by = {g: next(r for r, _, kind, _ in e.dispatches if kind == "handoff")
                     for g, e in fr.ledger.entries.items()}
        bad = []
        pre, dec_w, dec_p = engines
        for i, (g, c) in enumerate(zip(gids, comps)):
            ref = mono["paged" if served_by[g] == 2 else "whole"]["comps"][i]
            if c is None or c.finish_reason != "length" or c.tokens != ref.tokens:
                bad.append(f"request {i} (decode replica {served_by[g]}): "
                           f"{None if c is None else c.finish_reason}, tokens differ from "
                           "the monolithic engine's")
        if fr.ledger.verify() or fr.router_stats()["handoffs_moved"] != n:
            bad.append(f"ledger {fr.ledger.verify()}, handoffs moved "
                       f"{fr.router_stats()['handoffs_moved']} for {n} requests")
        if pre.n_host_syncs or pre.n_chains or pre.n_handoffs_out != n:
            bad.append(f"prefill engine: {pre.n_host_syncs} syncs, {pre.n_chains} chains, "
                       f"{pre.n_handoffs_out} handoffs")
        for d in (dec_w, dec_p):
            if d.n_host_syncs != d.n_chains + d.n_handoffs_in:
                bad.append(f"decode engine: {d.n_host_syncs} syncs != {d.n_chains} chains + "
                           f"{d.n_handoffs_in} handoffs")
        budget = dec_w.n_host_syncs + dec_p.n_host_syncs
        if real["count"] > budget:
            bad.append(f"{real['count']} stream syncs > the decode engines' {budget}: "
                       f"{real['sites']}")
        forwards = pre.n_prefills + pre.n_splices + (dec_w.n_chains + dec_p.n_chains) * tpl
        if counts["int8"] != per_forward * forwards or counts["int8_routes"]["v1"]:
            bad.append(f"int8 {counts['int8']} {counts['int8_routes']}, want {per_forward} x "
                       f"{forwards} sm90")
        if (counts["flash"] != cfg.n_layers * pre.n_prefills
                or counts["flash_routes"]["sm80"] != counts["flash"]):
            bad.append(f"flash {counts['flash']} {counts['flash_routes']}, want one a layer "
                       f"x {pre.n_prefills} prefills on the f32 route")
        if (counts["paged"] != cfg.n_layers * dec_p.n_chains * tpl
                or counts["paged_routes"]["v1"]):
            bad.append(f"paged {counts['paged']} {counts['paged_routes']}, want one a layer "
                       f"x {dec_p.n_chains} chains x {tpl} sm90")
        if dec_p.page_stats()["pages_in_use"]:
            bad.append(f"{dec_p.page_stats()['pages_in_use']} pages in use at the end")
        launches[f"serve_1b_disagg_{leg}"] = counts
        toks = n * st["new"]
        emit({"phase": "serve_1b_disagg", "leg": leg, "temperature": temp,
              "fleet": "1 prefill + 2 decode (whole-slot, paged kernel)", "requests": n,
              "prompt_lengths": st["prompts"], "new_tokens": st["new"],
              "served_by": [served_by[g] for g in gids],
              "handoffs_moved": fr.router_stats()["handoffs_moved"],
              "handoff_bytes": {"total": sum(handoff_bytes), "each": handoff_bytes},
              "prefill_engine": {"host_syncs": pre.n_host_syncs, "prefills": pre.n_prefills,
                                 "handoffs_out": pre.n_handoffs_out,
                                 "alone_stream_syncs": pre_real["count"]},
              "decode_engines": [{"chains": d.n_chains, "handoffs_in": d.n_handoffs_in,
                                  "host_syncs": d.n_host_syncs} for d in (dec_w, dec_p)],
              "stream_syncs": real["count"], "launches": counts,
              "ttft_fleet": ttft(comps) if all(comps) else None,
              "ttft_mono": {k: ttft(v["comps"]) for k, v in mono.items()},
              "tok_s_fleet": toks / wall_s,
              "tok_s_mono": {k: toks / v["wall_s"] for k, v in mono.items()},
              "wall_s": wall_s, "ok": not bad, "problems": bad, "gpu": gpu})
        if pre_real["count"]:
            bad.append(f"the prefill engine alone made {pre_real['count']} stream syncs: "
                       f"{pre_real['sites']}")
        problems += [f"{leg}: {x}" for x in bad]
        del engines, fr
    del params
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return launches

# the contract sentry on the card (serve_1b_sentry): SLO_STREAM's greedy
# leg cut to SENTRY_SLO requests and DISAGG's greedy fleet to
# SENTRY_FLEET_REQUESTS, each sentry off and on, in turns (off, on, off,
# on), then three injected violations on the SLO engine; train_sentry:
# the guardrails' ResNet-18 arm (GUARD_STEPS steps an epoch, fused AdamW)
# for 2 epochs through Trainer(sentry=)
SENTRY_TURNS = 2
SENTRY_SLO = dict(low=8, high=2)
SENTRY_FLEET_REQUESTS = 6


def sentry_gates(sen, host_syncs: int, comps: list, ref: list) -> list:
    """A clean sentry-on stream: tokens equal the sentry-off twin's, no
    steady recompile, violation or re-upload, and fetched == budgeted ==
    the engines' host syncs."""
    bad = []
    if [c.tokens for c in comps] != [c.tokens for c in ref]:
        bad.append("tokens differ from the sentry-off twin's")
    s = sen.summary()
    if s["sentry_steady_recompiles"] or s["sentry_budget_violations"] or s["sentry_reuploads"]:
        bad.append(f"sentry {s}")
    if not s["sentry_fetched"] == s["sentry_budgeted"] == host_syncs:
        bad.append(f"sentry fetched {s['sentry_fetched']}, budgeted {s['sentry_budgeted']}, "
                   f"host syncs {host_syncs}")
    return bad


def phase_serve_sentry(torch, quant, fa, pa, gpu: str, dev: str = "cuda") -> dict:
    """``serve_1b_sentry``: the contract sentry (``obs/sentry.py``: native
    loads, ``Tensor.cpu`` and sync debug mode's counts, leaves off the
    card) on two serving paths, each sentry off and on in turns
    (SENTRY_TURNS of each): (slo) SLO_STREAM's greedy leg (SENTRY_SLO's
    requests) through a ``priority_classes=2`` engine; (disagg) DISAGG's
    greedy fleet (SENTRY_FLEET_REQUESTS), one sentry shared by its three
    engines and read through ``FleetRouter.fleet_sentry_summary``. Gates
    (``sentry_gates``): tokens equal the sentry-off turn's, no steady
    recompile, violation or re-upload, fetched == budgeted == host syncs;
    every int8 call sm90. Numbers: tok/s on and off. Then three injections
    on the SLO engine, each exactly one violation and one dump naming it:
    a kernel library loaded again through ``ops/_build.py`` after the
    steady mark, a ``.item()`` of a device tensor inside one round (a
    leaky ``_sweep``), a CPU-tensor leaf beside its silent CUDA twin.
    Returns the launches by leg."""
    import tempfile

    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs import (
        ContractSentry,
        FlightRecorder,
        load_flightlog,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import _build
    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        FleetRouter,
        Request,
        ServeEngine,
    )

    st, dg = SLO_STREAM, DISAGG
    cfg = TransformerConfig(**{**PRESET_1B, "n_layers": SERVE_LAYERS}, quantized=True,
                            attention_fn=fa.flash_attention)
    params = init_quantized_lm(cfg, seed=0, device=dev)
    rng = np.random.Generator(np.random.PCG64(20))
    n = SENTRY_SLO["low"] + SENTRY_SLO["high"]
    prompts = [rng.integers(0, cfg.vocab_size, (st["prompts"][i % 3],)).tolist()
               for i in range(max(n, SENTRY_FLEET_REQUESTS))]
    low, high = prompts[:SENTRY_SLO["low"]], prompts[SENTRY_SLO["low"]:n]
    problems, launches, rows = [], {}, {}

    def slo_engine(**kw):
        return ServeEngine(TransformerLM(cfg), params, n_slots=st["n_slots"],
                           tokens_per_launch=st["tokens_per_launch"], max_queue=64, device=dev,
                           priority_classes=2, **kw)

    def slo_run(eng, lows=low, highs=high):
        ids = [eng.submit(Request(prompt=p, max_new_tokens=st["new"], seed=i, priority=1))
               for i, p in enumerate(lows)]
        done = []
        for _ in range(st["high_after"]):
            done += eng.step()
        ids += [eng.submit(Request(prompt=p, max_new_tokens=st["new"], seed=len(lows) + i))
                for i, p in enumerate(highs)]
        done += eng.run_until_idle()
        by_id = {c.request_id: c for c in done}
        return [by_id[i] for i in ids]

    def fleet_run(engines):
        fleet = FleetRouter(engines)
        gids = [fleet.submit(Request(prompt=p, max_new_tokens=dg["new"], seed=i))
                for i, p in enumerate(prompts[:SENTRY_FLEET_REQUESTS])]
        done = {c.request_id: c for c in fleet.run_until_idle()}
        return fleet, [done[g] for g in gids]

    def fleet_engines(**kw):
        paged = dict(paged=True, paged_kernel=True, page_size=dg["page_size"],
                     pool_pages=dg["pool_pages"])
        return [ServeEngine(TransformerLM(cfg), params, n_slots=dg["n_slots"],
                            tokens_per_launch=dg["tokens_per_launch"], max_queue=64, device=dev,
                            **extra, **kw)
                for extra in (dict(role="prefill"), dict(role="decode"),
                              dict(role="decode", **paged))]

    warm = slo_engine()
    slo_run(warm)  # first launches, cuBLAS handles
    del warm
    for leg in ("slo", "disagg"):
        turns = {"off": [], "on": []}
        for _ in range(SENTRY_TURNS):
            for mode in ("off", "on"):
                sen = ContractSentry() if mode == "on" else None
                kw = {"sentry": sen} if sen is not None else {}
                engines = [slo_engine(**kw)] if leg == "slo" else fleet_engines(**kw)
                if sen is not None:
                    sen.install()
                reset_counts(quant, fa, pa)
                t0 = time.perf_counter()
                try:
                    if leg == "slo":
                        comps, fleet = slo_run(engines[0]), None
                    else:
                        fleet, comps = fleet_run(engines)
                finally:
                    if sen is not None:
                        sen.uninstall()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                syncs = sum(e.n_host_syncs for e in engines)
                turns[mode].append({"comps": comps, "wall_s": wall, "host_syncs": syncs,
                                    "sentry": sen, "fleet": fleet,
                                    "launches": read_counts(quant, fa, pa)})
                del engines, fleet
        ref = turns["off"][0]["comps"]
        bad = []
        for run in turns["off"][1:]:
            if [c.tokens for c in run["comps"]] != [c.tokens for c in ref]:
                bad.append("the sentry-off turns differ")
        for run in turns["on"]:
            bad += sentry_gates(run["sentry"], run["host_syncs"], run["comps"], ref)
            if run["fleet"] is not None and (run["fleet"].fleet_sentry_summary()
                                             != run["sentry"].summary()):
                bad.append("fleet_sentry_summary is not the shared sentry's")
            if run["launches"]["int8_routes"]["v1"]:
                bad.append(f"int8 routes {run['launches']['int8_routes']}")
        toks = sum(len(c.tokens) for c in ref)
        on = turns["on"][-1]
        launches[f"serve_1b_sentry_{leg}"] = on["launches"]
        rows[leg] = {
            "requests": len(ref), "tokens": toks,
            "tok_s_on": [toks / r["wall_s"] for r in turns["on"]],
            "tok_s_off": [toks / r["wall_s"] for r in turns["off"]],
            "host_syncs": on["host_syncs"], "sentry": on["sentry"].summary(),
            "launches": on["launches"], "problems": bad}
        emit({"phase": "serve_1b_sentry", "leg": leg, "turns": SENTRY_TURNS,
              "order": "off, on, off, on", **rows[leg], "ok": not bad, "gpu": gpu})
        problems += [f"{leg}: {x}" for x in bad]
    # the three injections, on one SLO engine after a clean steady stream
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        dump = os.path.join(tmp, "sentry.flightlog.jsonl")
        fl = FlightRecorder(capacity=256, dump_path=dump)
        sen = ContractSentry(flight=fl)
        eng = slo_engine(sentry=sen, flight=fl)
        stray = torch.zeros((), device=dev)
        cpu_leaf = torch.ones((64, 64))
        twin = {"w": cpu_leaf.to(dev)}
        got, bad = {}, []
        sen.install()
        try:
            slo_run(eng, low[:4], high[:1])
            sen.mark_steady()  # after a warmup stream
            slo_run(eng, low[:4], high[:1])
            clean = sen.summary()
            if (clean["sentry_steady_recompiles"] or clean["sentry_budget_violations"]
                    or not clean["sentry_fetched"] == clean["sentry_budgeted"]
                    == eng.n_host_syncs):
                bad.append(f"clean stream: {clean}, host syncs {eng.n_host_syncs}")
            _build._libs.pop("fused_adamw", None)
            _build.library("fused_adamw")  # a post-steady load, the real loader
            got["compile"] = sen.n_steady_recompiles
            orig = eng._sweep

            def leaky_sweep():
                stray.item()
                return orig()

            eng.submit(Request(prompt=low[0], max_new_tokens=3, priority=1))
            eng._sweep = leaky_sweep
            eng.step()
            eng._sweep = orig
            eng.run_until_idle()
            got["budget_violation"] = sen.n_budget_violations
            nbytes = sen.check_args({"w": cpu_leaf}, label="card_cpu_leaf", device=dev)
            twin_bytes = sen.check_args(twin, label="card_cpu_leaf", device=dev)
            got["reupload"] = sen.n_reuploads
        finally:
            sen.uninstall()
        snaps = load_flightlog(dump)
    checks = {"compile": lambda t: t.get("steady") is True and t.get("library") == "fused_adamw",
              "budget_violation": lambda t: t.get("fetched", 0) == t.get("budgeted", 0) + 1,
              "reupload": lambda t: t.get("label") == "card_cpu_leaf"}
    dumps = {}
    for reason, check in checks.items():
        hits = [s["trigger"] for s in snaps if s["reason"] == reason]
        dumps[reason] = hits
        if got.get(reason) != 1 or len(hits) != 1 or not check(hits[0] or {}):
            bad.append(f"{reason}: counted {got.get(reason)}, dumps {hits}")
    if nbytes != cpu_leaf.nbytes or twin_bytes:
        bad.append(f"re-upload bytes {nbytes} (want {cpu_leaf.nbytes}), CUDA twin {twin_bytes}")
    emit({"phase": "serve_1b_sentry", "leg": "injections", "counted": got, "dumps": dumps,
          "reupload_bytes": nbytes, "twin_bytes": twin_bytes, "clean": clean,
          "sync_probe": "sync_debug_mode", "ok": not bad, "problems": bad, "gpu": gpu})
    problems += [f"injections: {x}" for x in bad]
    del params, eng
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def phase_train_sentry(torch, gpu: str) -> dict:
    """``train_sentry``: ``Trainer(sentry=)`` on the guardrails' ResNet-18
    arm (the headline model, GUARD_STEPS steps of 512 MNIST images an
    epoch, fused AdamW) for 2 epochs, the sentry installed: two phases
    (``"epoch 0"``, ``"epoch 1"``), two train-state walks with 0 bytes off
    the card, no steady recompile or violation, one ``fused_adamw``
    launch a step, the loss finite."""
    from pytorch_distributed_training_tutorials_tpu_torch.bench import headline
    from pytorch_distributed_training_tutorials_tpu_torch.data import mnist
    from pytorch_distributed_training_tutorials_tpu_torch.obs import ContractSentry
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw

    sen = ContractSentry()
    phases = []
    set_phase = sen.set_phase

    def recorded(label):
        phases.append(label)
        set_phase(label)

    sen.set_phase = recorded
    setup = headline.make_headline_setup(
        RESNET_BATCH, quiet=True, dataset=headline_rows(mnist("train", raw=True), GUARD_STEPS),
        optimizer=fused_adamw(**ADAMW_ARM), sentry=sen)
    fused_adamw.launches = 0
    t0 = time.perf_counter()
    with sen:
        m = setup.trainer.train(2)
    torch.cuda.synchronize()
    s = sen.summary()
    bad = []
    if phases != ["epoch 0", "epoch 1"] or sen.n_checked != 2:
        bad.append(f"phases {phases}, state walks {sen.n_checked}")
    if s["sentry_reupload_bytes"] or s["sentry_reuploads"] or s["sentry_steady_recompiles"]:
        bad.append(f"sentry {s}")
    if fused_adamw.launches != 2 * GUARD_STEPS or not math.isfinite(m["loss"]):
        bad.append(f"fused_adamw {fused_adamw.launches} launches, loss {m['loss']}")
    emit({"phase": "train_sentry", "epochs": 2, "steps_per_epoch": GUARD_STEPS,
          "phases": phases, "sentry": s, "fused_adamw_launches": fused_adamw.launches,
          "loss": m["loss"], "seconds": time.perf_counter() - t0, "ok": not bad,
          "problems": bad, "gpu": gpu})
    if bad:
        raise AssertionError("; ".join(bad))
    return {"fused_adamw": fused_adamw.launches}


# Tensor-parallel serving (serve_1b_tp2): TP ranks, the backend NCCL where
# the machine has a card per rank, else gloo with every rank on card 0
# (NCCL refuses two ranks on one device: "Duplicate GPU detected"), which
# stages each collective through host memory — the phase proves the shard
# arithmetic, the kernels at shard shapes, the KV split and the collective
# count; its times are not TP's speed
TP = 2
TP_REPLACES = "pytorch_distributed_training_tutorials_tpu/ops/quant.py:262"
TP_STREAM = dict(n_slots=4, tokens_per_launch=8)
# the served depth of the TP arms: the 1b widths at 8 of their 16 layers
# (cut in PR 19 to make room for that slice's phases; each rank's
# teacher-forced decode of every request, through gloo's staged
# all_reduces, was most of the phase)
TP_LAYERS = 8
# arm -> preset, engine options and stream: the 1b int8 stream (flash
# prefill, whole-slot cache) and the 1b-gqa paged-kernel arm (2 of the 4
# KV heads a rank)
TP_ARMS = {
    "int8": dict(preset=dict(PRESET_1B, n_layers=TP_LAYERS), engine={}, requests=8,
                 prompts=(16, 32, 48), new=16),
    "gqa_paged": dict(preset=dict(PRESET_1B_GQA, n_layers=TP_LAYERS), requests=4,
                      prompts=(16, 480), new=16,
                      engine=dict(paged=True, paged_kernel=True, page_size=64,
                                  pool_pages=48)),
}
# one 1b decode forward's int8 calls at TP 2, as whole (K, N, kind) and
# their count: q/k/v and gate/up split their output (column), o and down
# their input (row), the lm_head the vocabulary
TP_MIX = [((2048, 2048, "column"), 48), ((2048, 2048, "row"), 16),
          ((2048, 8192, "column"), 32), ((8192, 2048, "row"), 16),
          ((2048, 32000, "column"), 1)]
TP_M = (1, 4, 512)
TP_NOTE = ("gloo on one card: every collective staged through host memory; the phase's "
           "times are not tensor parallelism's speed")


def tp_shards(quant, whole, kind: str) -> list:
    """The TP ranks' shards of a whole int8 weight as a served model holds
    them, cut by the port's ``shard_params`` under the rule of a column
    layer (gate_proj: a block of N, scales with it) or a row layer
    (down_proj: a block of K, scales whole)."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        shard_params,
    )

    name = "gate_proj" if kind == "column" else "down_proj"
    tree = {f"{name}.qt": whole.q.t(), f"{name}.scale": whole.scale.reshape(1, -1)}
    out = []
    for r in range(TP):
        part = shard_params(tree, r, TP, head_dim=1)
        out.append(quant.Int8Param(q=part[f"{name}.qt"].t(), scale=part[f"{name}.scale"]))
    return out


def tp_kernel_checks(torch, quant, gpu: str) -> dict:
    """``int8_matmul_tp`` against its plain version in one process, with no
    group, at the 1b TP-2 shard shapes (TP_MIX) and M in TP_M: each rank's
    shard call (``int8_matmul_shard``, the sm90 kernel) — a column shard's
    output bitwise the unsharded kernel's columns, the row shards'
    partials summed within KERNEL_TOLERANCE of ``int8_matmul_tp_reference``
    (expected bitwise: each shard call is its plain version's bits, and a
    2-term sum is one rounding either way); the shard call timed beside
    the unsharded call, the plain version and its bound."""
    from pytorch_distributed_training_tutorials_tpu_torch.ops._check import kernel_error
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        TensorParallel,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    one = TensorParallel()  # no group: the partials are summed here
    results, max_err = {}, 0.0
    for (k, n, kind), _ in TP_MIX:
        wq = quant.quantize_int8(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        whole = quant.Int8Param(q=wq.q.t().contiguous().t(),
                                scale=wq.scale.reshape(1, -1).contiguous())
        shards = tp_shards(quant, whole, kind)
        for m in TP_M:
            x = torch.randn((m, k), generator=gen, device=dev)
            kl = k // TP
            xs = [x if kind == "column" else x[:, r * kl:(r + 1) * kl].contiguous()
                  for r in range(TP)]
            routes0 = quant.int8_matmul.routes["sm90"]
            outs = [quant.int8_matmul_shard(xs[r], shards[r], one, kind) for r in range(TP)]
            if quant.int8_matmul.routes["sm90"] != routes0 + TP:
                raise AssertionError(f"int8_matmul_tp shard calls at M={m} K={k} N={n} "
                                     f"{kind} left the sm90 route: {quant.int8_matmul.routes}")
            torch.cuda.synchronize()
            if kind == "column":
                full = quant.int8_matmul(x, whole)
                nl = n // TP
                bad = [r for r in range(TP)
                       if not torch.equal(outs[r], full[:, r * nl:(r + 1) * nl])]
                if bad:
                    raise AssertionError(f"int8_matmul_tp column shards {bad} at M={m} K={k} "
                                         f"N={n} differ from the unsharded kernel's columns")
                err = {"max_abs_err": 0.0, "worst_ratio": 0.0}
                bitwise = True
            else:
                got = outs[0] + outs[1]
                ref = quant.int8_matmul_tp_reference(x, whole, TP, "row")
                err = kernel_error(got, ref, torch.float32)
                bitwise = bool(torch.equal(got, ref))
                if not err["worst_ratio"] <= 1.0:
                    raise AssertionError(f"int8_matmul_tp row at M={m} K={k} N={n}: {err}")
            max_err = max(max_err, err["max_abs_err"])
            ks, ns = (k, n // TP) if kind == "column" else (k // TP, n)
            ms = time_ms(lambda: quant.int8_matmul_shard(xs[0], shards[0], one, kind), torch,
                         flush)
            whole_ms = time_ms(lambda: quant.int8_matmul(x, whole), torch, flush)
            plain_ms = time_ms(lambda: quant.int8_matmul_reference(xs[0], shards[0]), torch,
                               flush, reps=25 if m <= 64 else 5, warmup=3 if m <= 64 else 1)
            b_ms, b_by, nbytes, ops = bound(m, ks, ns)
            results[(m, k, n, kind)] = dict(ms=ms, whole_ms=whole_ms, plain_ms=plain_ms,
                                            bound_ms=b_ms, nbytes=nbytes, ops=ops)
            emit({
                "phase": "kernel_vs_plain", "kernel": "int8_matmul_tp", "kind": kind,
                "tp": TP, "M": m, "K": k, "N": n, "shard_K": ks, "shard_N": ns,
                "route": "sm90", "bitwise": bitwise, **err, "ms": ms,
                "unsharded_ms": whole_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "roofline_share": b_ms / ms, "library_ms": None,
                "gpu": gpu,
            })
    return {"results": results, "max_abs_err": max_err}


@contextlib.contextmanager
def native_sync_warnings():
    """Sync debug mode's warnings that C++ threads print (a backend's own
    worker threads: gloo's staging of CUDA tensors), counted: file
    descriptor 2 goes to a temporary file for the block, the warnings are
    counted and every other line is written back to stderr. Yields a dict
    that holds ``count`` when the block ends. (Warnings raised on a
    Python thread reach ``real_syncs``'s hook instead.)"""
    import tempfile

    out = {}
    with tempfile.TemporaryFile() as f:
        sys.stderr.flush()
        saved = os.dup(2)
        os.dup2(f.fileno(), 2)
        try:
            yield out
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            f.seek(0)
            lines = f.read().decode(errors="replace").splitlines()
            sync = [ln for ln in lines if "called a synchronizing CUDA operation" in ln]
            out["count"] = len(sync)
            rest = [ln for ln in lines if ln not in sync]
            if rest:
                print("\n".join(rest), file=sys.stderr, flush=True)


def tp_serve_arm(torch, strategy, name: str, keep: bool = False) -> dict:
    """One TP_ARMS arm through ``ServeEngine(strategy=strategy)`` — the
    replicated engine for a strategy of one rank: a warmup request, then
    the stream under sync debug mode with every counter read, each
    request's teacher-forced logits on its own tokens, and on a sharded
    engine ``audit_decode()``. ``keep``: the engine too (the replicated
    side's, for the near-tie gate)."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import (
        flash_attention as fa,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as pa
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    arm = TP_ARMS[name]
    cfg = TransformerConfig(**arm["preset"], quantized=True, attention_fn=fa.flash_attention)
    t0 = time.perf_counter()
    params = init_quantized_lm(cfg, seed=0, device="cuda")
    eng = ServeEngine(TransformerLM(cfg), params, max_queue=64, device="cuda",
                      strategy=strategy, **TP_STREAM, **arm["engine"])
    del params  # a sharded engine holds its copies: the whole tree goes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    rng = np.random.Generator(np.random.PCG64(15))
    prompts = [rng.integers(0, cfg.vocab_size, (arm["prompts"][i % len(arm["prompts"])],))
               .tolist() for i in range(arm["requests"])]
    eng.submit(Request(prompt=prompts[0][:16], max_new_tokens=2, seed=99))  # warmup
    eng.run_until_idle()
    torch.cuda.synchronize()
    base = (eng.n_prefills, eng.n_chains, eng.n_host_syncs)
    quant.int8_matmul.launches = 0
    quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
    quant.int8_matmul_tp.launches = 0
    fa.flash_attention.launches["fwd"] = 0
    fa.flash_attention.routes["fwd"] = {"sm90": 0, "sm80": 0}
    pa.paged_attention.launches = 0
    pa.paged_attention.routes = {"sm90": 0, "v1": 0}
    strategy.reset_collectives()
    t0 = time.perf_counter()
    # a blocking collective returns after its staging: the backend's
    # thread syncs of the stream all land inside the block
    with native_sync_warnings() as native, real_syncs(torch) as real:
        ids = [eng.submit(Request(prompt=p, max_new_tokens=arm["new"], seed=i))
               for i, p in enumerate(prompts)]
        done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    out = {
        "prefills": eng.n_prefills - base[0], "chains": eng.n_chains - base[1],
        "host_syncs": eng.n_host_syncs - base[2], "stream_syncs": real["count"],
        "backend_thread_syncs": native["count"],
        "stream_sync_sites": real["sites"],
        "int8": quant.int8_matmul.launches, "int8_routes": dict(quant.int8_matmul.routes),
        "int8_tp": quant.int8_matmul_tp.launches,
        "flash": fa.flash_attention.launches["fwd"],
        "flash_routes": dict(fa.flash_attention.routes["fwd"]),
        "paged": pa.paged_attention.launches, "paged_routes": dict(pa.paged_attention.routes),
        "collectives": dict(strategy.collectives), "wall_s": wall_s, "build_s": build_s,
    }
    by_id = {c.request_id: c for c in done}
    out["reasons"] = [by_id[i].finish_reason if i in by_id else None for i in ids]
    out["tokens"] = [by_id[i].tokens if i in by_id else [] for i in ids]
    out["prompts"] = prompts
    if strategy.tp_size > 1:  # the replicated side's are taken on the TP tokens
        out["tf"] = [eng.teacher_forced_logits(p, t).cpu()
                     for p, t in zip(prompts, out["tokens"])]
    cache = eng._state.cache
    out["kv_heads"] = cache.k.shape[3]
    out["kv_leaf_bytes"] = sum(x.numel() * x.element_size()
                               for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)
                               if x is not None)
    out["tp_stats"] = eng.tp_stats()
    if strategy.tp_size > 1:
        out["audit"] = eng.audit_decode()
        out["tp_stats"] = eng.tp_stats()
        out["expected_per_forward"] = eng.expected_collectives(1)
    if keep:
        out["engine"] = eng
    return out


def tp_kernel_row(tp: dict) -> dict:
    """The kernels line's ``int8_matmul_tp`` row: one TP-2 rank's share of
    one 1b decode forward (TP_MIX's 113 shard calls at M 4, the slots),
    its time, plain time, the unsharded forward's and the bound summed
    over the mix; launches from ``serve_1b_tp2`` (rank 0's int8 arm, and
    by path and rank)."""
    res = tp["kern"]["results"]
    tot = {key: sum(res[(4, k, n, kind)][key] * c for (k, n, kind), c in TP_MIX)
           for key in ("ms", "plain_ms", "whole_ms", "nbytes", "ops")}
    t_bytes, t_ops = tot["nbytes"] / HBM_BYTES_PER_S, tot["ops"] / INT8_OPS_PER_S
    return {
        "name": "int8_matmul_tp", "route": "cuda",
        "source": f"{PKG}/csrc/int8_matmul_sm90.cu", "replaces": TP_REPLACES,
        "wrapper": f"{PKG}/ops/quant.py int8_matmul_tp / int8_matmul_shard",
        "launches": tp["launches"]["int8"][0], "max_abs_err": tp["kern"]["max_abs_err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        "unsharded_forward_ms": tot["whole_ms"],
        "work": f"one rank's share of one 1b decode forward at TP {TP}: 113 shard calls "
                "at M=4",
        "launches_by_path": {f"serve_1b_tp2_{name}": n for name, n in tp["launches"].items()},
        "launches_note": f"serve_1b_tp2 serves {TP_LAYERS} layers: {TP_LAYERS * 7 + 1} shard "
                         "calls a forward",
        "backend": tp["backend"],
        "library_note": "no one PyTorch call quantizes per (row, 512-tile)",
    }


def tp_serve_rank(tp, names: list, clock: bool = True) -> dict:
    """One rank of serve_1b_tp2 (spawned by ``spawn_tp``): every arm of
    ``names`` through the sharded engine, then (``clock``) the clock legs
    (``tp_clock_legs``) under ``"clock"`` and the roles / SLO /
    router-clock legs (``tp_roles_slo_legs``) under ``"roles_slo"``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {name: tp_serve_arm(torch, tp, name) for name in names}
    if clock:
        out["clock"] = tp_clock_legs(torch, tp)
        out["roles_slo"] = tp_roles_slo_legs(torch, tp)
    return out


# serve_1b_tp2's clock legs (rank 0 decides, every rank applies): the int8
# arm's first TP_CLOCK["requests"] prompts on its 4 slots (two queued),
# TP_CLOCK["new"] new tokens (four chains: a victim still decodes when its
# deadline or cancel lands) — "deadline": requests 1 (decoding) and 5
# (queued) with 1 s deadlines, chain 1 stalled 2.5 s on rank 0 only;
# "cancel": a cancellable engine, every rank calling cancel on requests 0
# (decoding) and 5 (queued) after step 2 (rank 0's call counts); "stall":
# 0.5 s on rank 0, no deadline; each beside "off", no clock feature
TP_CLOCK = dict(requests=6, new=32)
TP_CLOCK_LEGS = {
    "off": {},
    "deadline": dict(deadlines={1: 1.0, 5: 1.0}, chaos=dict(stall_chain=1, stall_s=2.5)),
    "cancel": dict(engine=dict(cancellable=True), cancel=(0, 5), cancel_after=2),
    "stall": dict(chaos=dict(stall_chain=1, stall_s=0.5)),
}


def tp_clock_legs(torch, tp, dev: str = "cuda") -> dict:
    """Every TP_CLOCK_LEGS leg through the sharded int8 engine of this
    rank: the completions (ids, reasons, tokens) in order, the steps and
    decision broadcasts, the cancel calls' answers and what they recorded,
    the stall events of this rank's recorder, ``fault_stats()``, host syncs
    and their budget, and the int8 launches (shard calls and routes)."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs import FlightRecorder
    from pytorch_distributed_training_tutorials_tpu_torch.ops import (
        flash_attention as fa,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

    arm = TP_ARMS["int8"]
    cfg = TransformerConfig(**arm["preset"], quantized=True, attention_fn=fa.flash_attention)
    params = init_quantized_lm(cfg, seed=0, device=dev)
    rng = np.random.Generator(np.random.PCG64(15))
    prompts = [rng.integers(0, cfg.vocab_size, (arm["prompts"][i % len(arm["prompts"])],))
               .tolist() for i in range(TP_CLOCK["requests"])]
    out = {}
    for name, leg in TP_CLOCK_LEGS.items():
        kw = dict(leg.get("engine", {}))
        if "chaos" in leg:
            kw["chaos"] = ChaosConfig(**leg["chaos"])
        flight = FlightRecorder(capacity=4096)
        eng = ServeEngine(TransformerLM(cfg), params, max_queue=64, device=dev,
                          strategy=tp, flight=flight, **TP_STREAM, **kw)
        quant.int8_matmul.launches = 0
        quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
        quant.int8_matmul_tp.launches = 0
        deadlines = leg.get("deadlines", {})
        t0 = time.perf_counter()
        ids = [eng.submit(Request(prompt=p, max_new_tokens=TP_CLOCK["new"], seed=i,
                                  deadline_s=deadlines.get(i)))
               for i, p in enumerate(prompts)]
        done, steps, known, recorded = [], 0, [], []
        while not eng.idle:
            done += eng.step()
            steps += 1
            if steps == leg.get("cancel_after"):
                known = [eng.cancel(ids[i]) for i in leg["cancel"]]
                recorded = sorted(eng._cancelled)
        torch.cuda.synchronize()
        out[name] = {
            "completions": [(c.request_id, c.finish_reason, c.tokens) for c in done],
            "ids": ids, "steps": steps, "broadcasts": eng.n_decision_broadcasts,
            "known": known, "cancel_recorded": recorded,
            "stall_events": sum(e["kind"] == "stall" for e in flight.events),
            "fault_stats": eng.fault_stats(), "host_syncs": eng.n_host_syncs,
            "budget": eng.n_chains + eng.n_prefills + eng.n_splices,
            "forwards": eng.n_prefills + eng.n_chains * TP_STREAM["tokens_per_launch"],
            "int8": quant.int8_matmul.launches, "int8_tp": quant.int8_matmul_tp.launches,
            "int8_routes": dict(quant.int8_matmul.routes), "wall_s": time.perf_counter() - t0,
        }
        del eng
    del params
    torch.cuda.empty_cache()
    return out


def tp_clock_gates(ranks: list) -> list:
    """serve_1b_tp2's clock-leg gates over the ranks' ``tp_clock_legs``:
    identical completions on every rank; no broadcast in "off", one a step
    in the others; the deadline and cancel victims completed with a prefix
    of "off"'s tokens (decoding) or none (queued); the stall leg equal to
    "off"; the stall on rank 0 alone; cancel calls known everywhere and
    recorded on rank 0 only; host syncs the budget; 57 int8 shard calls a
    forward (8 layers), all sm90."""
    bad = []
    off = {rid: (reason, toks) for rid, reason, toks in ranks[0]["off"]["completions"]}
    for name, leg in TP_CLOCK_LEGS.items():
        rows = [r[name] for r in ranks]
        if any(r["completions"] != rows[0]["completions"] for r in rows):
            bad.append(f"{name}: the ranks' completions differ")
        want_b = 0 if name == "off" else rows[0]["steps"]
        for rank, r in enumerate(rows):
            if r["broadcasts"] != want_b or r["steps"] != rows[0]["steps"]:
                bad.append(f"{name} rank {rank}: {r['broadcasts']} broadcasts in {r['steps']} "
                           f"steps, want {want_b}")
            if r["host_syncs"] != r["budget"]:
                bad.append(f"{name} rank {rank}: {r['host_syncs']} host syncs, budget "
                           f"{r['budget']}")
            per = TP_LAYERS * 7 + 1
            if (r["int8"] != per * r["forwards"] or r["int8_tp"] != r["int8"]
                    or r["int8_routes"] != {"sm90": r["int8"], "v1": 0}):
                bad.append(f"{name} rank {rank}: int8 {r['int8']} (tp {r['int8_tp']}, "
                           f"{r['int8_routes']}), want {per} x {r['forwards']} sm90")
            want_stall = int("chaos" in leg and rank == 0)
            if r["stall_events"] != want_stall:
                bad.append(f"{name} rank {rank}: {r['stall_events']} stall events, want "
                           f"{want_stall}")
        got = {rid: (reason, toks) for rid, reason, toks in rows[0]["completions"]}
        ids = rows[0]["ids"]
        victims = {ids[i]: "deadline" for i in leg.get("deadlines", {})}
        victims.update({ids[i]: "cancelled" for i in leg.get("cancel", ())})
        for rid, (reason, toks) in got.items():
            if rid in victims:
                full = off[rid][1]
                if reason != victims[rid] or toks != full[:len(toks)] or len(toks) >= len(full):
                    bad.append(f"{name}: victim {rid} {reason} with {len(toks)} tokens")
            elif (reason, toks) != off[rid]:
                bad.append(f"{name}: request {rid} differs from the off leg")
        if "cancel" in leg:
            want_rec = sorted(ids[i] for i in leg["cancel"])
            for rank, r in enumerate(rows):
                if r["known"] != [True] * len(leg["cancel"]) or r["cancel_recorded"] != (
                        want_rec if rank == 0 else []):
                    bad.append(f"cancel rank {rank}: known {r['known']}, recorded "
                               f"{r['cancel_recorded']}")
    return bad


def phase_serve_tp(torch, quant, gpu: str) -> dict:
    """``serve_1b_tp2``: tensor-parallel serving at TP 2. The backend
    (NCCL with a card per rank, else gloo on card 0) is printed with the
    card count. ``int8_matmul_tp`` against its plain version at the shard
    shapes (``tp_kernel_checks``); each TP_ARMS arm replicated, here, then
    sharded on TP spawned ranks. Gates: every rank's tokens equal and its
    teacher-forced logits bitwise equal; tokens equal the replicated
    engine's, except requests held teacher-forced against it within 4% of
    the logit scale (``tf_compare``, ``greedy_held``); K/V bytes a rank
    half the replicated engine's, KV heads a rank 8 (1b) and 2 (1b-gqa);
    ``audit_decode()`` clean and the stream's collectives 2 all_reduce a
    layer and one all_gather a forward; a rank's 113 int8 calls a forward,
    every one a ``int8_matmul_tp`` shard call on the sm90 route, a flash
    launch a layer a whole prefill, a paged launch a layer a decode step
    (sm90), at the arms' TP_LAYERS; host
    syncs a rank = chains + prefills = the replicated engine's."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        TensorParallel,
        spawn_tp,
    )

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= TP else "gloo"
    emit({"phase": "serve_1b_tp2_world", "tp": TP, "backend": backend, "cards": cards,
          "note": TP_NOTE if backend == "gloo" else None, "gpu": gpu})
    kern = tp_kernel_checks(torch, quant, gpu)
    one = TensorParallel()
    replicated = {name: tp_serve_arm(torch, one, name, keep=True) for name in TP_ARMS}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_tp(tp_serve_rank, TP, (list(TP_ARMS),), backend=backend, device="cuda",
                     join_timeout_s=900)
    clock = [r.pop("clock") for r in ranks]
    roles = [r.pop("roles_slo") for r in ranks]
    ranks_s = time.perf_counter() - t0
    problems, launches = [], {}
    layers = TP_LAYERS
    tpl = TP_STREAM["tokens_per_launch"]
    for name, arm in TP_ARMS.items():
        rep = replicated[name]
        got = [r[name] for r in ranks]
        bad = []
        forwards = got[0]["prefills"] + got[0]["chains"] * tpl
        per_forward = layers * 7 + 1
        for r, g in enumerate(got):
            if g["reasons"] != ["length"] * arm["requests"] or any(
                    len(t) != arm["new"] for t in g["tokens"]):
                bad.append(f"rank {r}: finish {g['reasons']}")
            if g["tokens"] != got[0]["tokens"]:
                bad.append(f"rank {r}: tokens differ from rank 0's")
            if not all(torch.equal(a, b) for a, b in zip(g["tf"], got[0]["tf"])):
                bad.append(f"rank {r}: teacher-forced logits not bitwise rank 0's")
            if g["host_syncs"] != g["chains"] + g["prefills"] or g["host_syncs"] != rep[
                    "host_syncs"]:
                bad.append(f"rank {r}: {g['host_syncs']} host syncs; budget "
                           f"{g['chains'] + g['prefills']}, replicated {rep['host_syncs']}")
            if (g["int8"] != per_forward * forwards or g["int8_tp"] != g["int8"]
                    or g["int8_routes"] != {"sm90": g["int8"], "v1": 0}):
                bad.append(f"rank {r}: int8 {g['int8']} (tp {g['int8_tp']}, routes "
                           f"{g['int8_routes']}), want {per_forward} x {forwards} all sm90")
            if g["flash"] != layers * g["prefills"] or g["flash_routes"]["sm80"] != g["flash"]:
                bad.append(f"rank {r}: flash {g['flash']} {g['flash_routes']}, want "
                           f"{layers} x {g['prefills']} on the f32 route")
            want_paged = layers * g["chains"] * tpl if arm["engine"].get("paged_kernel") else 0
            if g["paged"] != want_paged or g["paged_routes"]["sm90"] != g["paged"]:
                bad.append(f"rank {r}: paged {g['paged']} {g['paged_routes']}, want "
                           f"{want_paged} sm90")
            want_kv = arm["preset"].get("n_kv_heads", arm["preset"]["n_heads"]) // TP
            if g["kv_heads"] != want_kv or 2 * g["kv_leaf_bytes"] != rep["kv_leaf_bytes"]:
                bad.append(f"rank {r}: {g['kv_heads']} KV heads, {g['kv_leaf_bytes']} K/V "
                           f"bytes; want {want_kv} and half of {rep['kv_leaf_bytes']}")
            if g["tp_stats"]["tp_decision_broadcasts"]:
                bad.append(f"rank {r}: {g['tp_stats']['tp_decision_broadcasts']} decision "
                           "broadcasts with no clock feature on")
            want_c = {k: v * forwards for k, v in g["expected_per_forward"].items()}
            if g["collectives"] != want_c or not g["audit"]["ok"]:
                bad.append(f"rank {r}: collectives {g['collectives']} (want {want_c}), "
                           f"audit {g['audit']}")
        held = {}
        for i, (want, have) in enumerate(zip(rep["tokens"], got[0]["tokens"])):
            if want == have:
                continue
            ref = rep["engine"].teacher_forced_logits(rep["prompts"][i], have).cpu()
            tf = tf_compare(ref, got[0]["tf"][i])
            gh = greedy_held(got[0]["tf"][i], have)
            held[i] = {"tf": {k: v for k, v in tf.items()
                              if k != "per_step_max_abs_logit_diff"}, "greedy_held": gh}
            if not (tf["ok"] and gh["ok"]):
                bad.append(f"request {i}: tokens differ from the replicated engine's and "
                           f"fail the teacher-forced gate: {held[i]}")
        launches[name] = [g["int8_tp"] for g in got]
        row = got[0]
        toks = sum(len(t) for t in row["tokens"])
        emit({
            "phase": "serve_1b_tp2", "arm": name, "tp": TP, "backend": backend,
            "cards": cards, "layers": TP_LAYERS, "requests": arm["requests"], "prompt_lengths": arm["prompts"],
            "new_tokens": arm["new"], "engine": arm["engine"],
            "prefills": row["prefills"], "chains": row["chains"], "forwards": forwards,
            "tokens_equal_replicated": sum(a == b for a, b in
                                           zip(rep["tokens"], row["tokens"])),
            "held_teacher_forced": held, "kv_heads_per_rank": row["kv_heads"],
            "kv_leaf_bytes_per_rank": row["kv_leaf_bytes"],
            "kv_leaf_bytes_replicated": rep["kv_leaf_bytes"], "tp_stats": row["tp_stats"],
            "audit": row["audit"], "stream_collectives": [g["collectives"] for g in got],
            "int8_matmul_launches": [g["int8"] for g in got],
            "int8_matmul_tp_launches": [g["int8_tp"] for g in got],
            "flash_fwd_launches": [g["flash"] for g in got],
            "paged_attention_launches": [g["paged"] for g in got],
            "host_syncs": [g["host_syncs"] for g in got],
            "replicated_host_syncs": rep["host_syncs"],
            "stream_syncs": [g["stream_syncs"] for g in got],
            "replicated_stream_syncs": rep["stream_syncs"],
            "stream_sync_sites_rank0": row["stream_sync_sites"],
            # what the backend adds beside the engine's own: syncs on its
            # worker threads (gloo stages each collective's CUDA tensor)
            "backend_thread_syncs": [g["backend_thread_syncs"] for g in got],
            "replicated_backend_thread_syncs": rep["backend_thread_syncs"],
            "wall_s_per_rank": [g["wall_s"] for g in got], "replicated_wall_s": rep["wall_s"],
            "tok_s_rank0": toks / row["wall_s"], "replicated_tok_s": toks / rep["wall_s"],
            "build_s_per_rank": [g["build_s"] for g in got],
            "timing_note": TP_NOTE if backend == "gloo" else None,
            "ok": not bad, "problems": bad, "gpu": gpu,
        })
        problems += [f"{name}: {x}" for x in bad]
        if name != "int8":  # the roles legs' unsharded holds need the int8 one
            del rep["engine"]
    bad = tp_clock_gates(clock)
    for name in TP_CLOCK_LEGS:
        rows = [r[name] for r in clock]
        launches[f"clock_{name}"] = [r["int8_tp"] for r in rows]
        emit({"phase": "serve_1b_tp2_clock", "leg": name, "tp": TP, "backend": backend,
              "layers": TP_LAYERS, "requests": TP_CLOCK["requests"],
              "new_tokens": TP_CLOCK["new"], "options": TP_CLOCK_LEGS[name],
              "reasons": [reason for _, reason, _ in rows[0]["completions"]],
              "tokens": [len(toks) for _, _, toks in rows[0]["completions"]],
              "ranks_identical": all(r["completions"] == rows[0]["completions"] for r in rows),
              "steps": [r["steps"] for r in rows], "broadcasts": [r["broadcasts"] for r in rows],
              "cancel_known": [r["known"] for r in rows],
              "cancel_recorded": [r["cancel_recorded"] for r in rows],
              "stall_events": [r["stall_events"] for r in rows],
              "fault_stats_rank0": rows[0]["fault_stats"],
              "host_syncs": [r["host_syncs"] for r in rows],
              "int8_matmul_tp_launches": [r["int8_tp"] for r in rows],
              "int8_routes": [r["int8_routes"] for r in rows],
              "wall_s": [r["wall_s"] for r in rows],
              "timing_note": TP_NOTE if backend == "gloo" else None, "gpu": gpu})
    emit({"phase": "serve_1b_tp2_clock_gates", "ok": not bad, "problems": bad, "gpu": gpu})
    problems += [f"clock: {x}" for x in bad]
    mono = ranks[0]["int8"]["tokens"]
    unsharded = tp_roles_unsharded(roles[0]["roles"], mono, ranks[0]["int8"]["tf"],
                                   replicated["int8"])
    del replicated["int8"]["engine"]
    bad = tp_roles_slo_gates(roles, mono, unsharded)
    ro, slo = [r["roles"] for r in roles], [r["slo"] for r in roles]
    for r in ro:
        r.pop("paged_tf")
    toks = sum(len(t) for t in ro[0]["tokens"])
    emit({"phase": "serve_1b_tp2_roles", "tp": TP, "backend": backend, "layers": TP_LAYERS,
          "fleet": "1 prefill + 2 decode (whole-slot, paged kernel), all TP",
          "requests": TP_ROLES["requests"], "new_tokens": TP_ARMS["int8"]["new"],
          "tokens_equal_monolithic_tp": sum(a == b for a, b in zip(ro[0]["tokens"],
                                                                   mono[:TP_ROLES["requests"]])),
          "tokens_equal_unsharded": sum(a == b for a, b in zip(
              ro[0]["tokens"], replicated["int8"]["tokens"])),
          "unsharded_held_teacher_forced": unsharded,
          "served_by": ro[0]["served_by"], "paged_held": ro[0]["paged_held"],
          "handoff_bytes_per_rank": [r["handoff_bytes"] for r in ro],
          "handoff_bytes_unsharded": roles[0]["whole_handoff_bytes"],
          "handoff_kv_heads": ro[0]["handoff_kv_heads"],
          "prefill": [r["prefill"] for r in ro], "decode": [r["decode"] for r in ro],
          "clock": "rank 1 runs 101x fast; hedging on",
          "clock_broadcasts": [r["clock_broadcasts"] for r in ro],
          "states": [r["states"] for r in ro], "transitions": [r["transitions"] for r in ro],
          "sentry": [r["sentry"] for r in ro], "launches": [r["launches"] for r in ro],
          "wall_s": [r["wall_s"] for r in ro], "tok_s_rank0": toks / ro[0]["wall_s"],
          "timing_note": TP_NOTE if backend == "gloo" else None, "gpu": gpu})
    emit({"phase": "serve_1b_tp2_slo", "tp": TP, "backend": backend, "layers": TP_LAYERS,
          "n_slots": 1, "new_tokens": TP_ARMS["int8"]["new"],
          "class_0_after_steps": TP_SLO["high_after"], "requests": [TP_SLO["low"], TP_SLO["high"]],
          "swaps": [r["swaps"] for r in slo],
          "swap_bytes_unsharded": roles[0]["whole_swap_bytes"],
          "swaps_out": [r["swaps_out"] for r in slo], "swaps_in": [r["swaps_in"] for r in slo],
          "host_syncs": [r["host_syncs"] for r in slo], "budget": [r["budget"] for r in slo],
          "swap_agreements": [r["tp_stats"]["tp_swap_agreements"] for r in slo],
          "sentry": [r["sentry"] for r in slo],
          "wall_s": [r["slo"]["wall_s"] for r in roles],
          "timing_note": TP_NOTE if backend == "gloo" else None, "gpu": gpu})
    emit({"phase": "serve_1b_tp2_roles_slo_gates", "ok": not bad, "problems": bad, "gpu": gpu})
    problems += [f"roles/slo: {x}" for x in bad]
    launches["roles"] = [r["launches"]["int8_tp"] for r in ro]
    launches["slo"] = [r["launches"]["int8_tp"] for r in slo]
    emit({"phase": "serve_1b_tp2_ranks_s", "seconds": ranks_s, "gpu": gpu})
    if problems:
        raise AssertionError("; ".join(problems))
    return {"kern": kern, "launches": launches, "backend": backend,
            "roles_launches": ro[0]["launches"],
            "replicated_tokens": replicated["int8"]["tokens"],
            "sharded_tokens": ranks[0]["int8"]["tokens"]}

# serve_1b_tp2's roles, SLO and router-clock legs (every rank with its own
# contract sentry) over the int8 arm's model and prompts: a TP prefill
# engine and two TP decode engines (whole-slot, and paged with the kernel)
# behind a FleetRouter whose clock runs 101x fast on rank 1 (hedging on),
# TP_ROLES["requests"] requests of TP_ARMS["int8"]["new"] tokens; a
# one-slot priority_classes=2 engine where request TP_SLO["low"] (class 1)
# is preempted by TP_SLO["high"] (class 0) arriving after
# TP_SLO["high_after"] steps, held to the int8 arm's tokens
TP_ROLES = dict(requests=4, page_size=64, pool_pages=16, hedge_after_s=30.0)
# low and high index the int8 arm's requests: at its new tokens (16) the
# arm's own tokens for them are the SLO-off engine's
TP_SLO = dict(low=2, high=3, high_after=1)


def tp_roles_slo_legs(torch, tp, dev: str = "cuda") -> dict:
    """The roles / SLO / router-clock legs of one rank (see TP_ROLES,
    TP_SLO). Rank 0 also serves the same requests through replicated
    engines for the unsharded handoff and swap bytes."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs import ContractSentry
    from pytorch_distributed_training_tutorials_tpu_torch.ops import (
        flash_attention as fa,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import paged_attention as pa
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        FleetRouter,
        Request,
        ServeEngine,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve.slots import tree_nbytes

    arm = TP_ARMS["int8"]
    cfg = TransformerConfig(**arm["preset"], quantized=True, attention_fn=fa.flash_attention)
    params = init_quantized_lm(cfg, seed=0, device=dev)
    rng = np.random.Generator(np.random.PCG64(15))
    prompts = [rng.integers(0, cfg.vocab_size, (arm["prompts"][i % len(arm["prompts"])],))
               .tolist() for i in range(arm["requests"])]
    n, new = TP_ROLES["requests"], arm["new"]
    paged = dict(paged=True, paged_kernel=True, page_size=TP_ROLES["page_size"],
                 pool_pages=TP_ROLES["pool_pages"])

    def engine(strategy=tp, **kw):
        return ServeEngine(TransformerLM(cfg), params, max_queue=64, device=dev,
                           strategy=strategy, **{**TP_STREAM, **kw})

    def counts():
        return {**read_counts(quant, fa, pa), "int8_tp": quant.int8_matmul_tp.launches}

    def zero():
        reset_counts(quant, fa, pa)
        quant.int8_matmul_tp.launches = 0

    out = {}
    # roles behind the router, one sentry for the fleet of this rank
    sen = ContractSentry()
    engines = [engine(role="prefill", sentry=sen), engine(role="decode", sentry=sen),
               engine(role="decode", sentry=sen, **paged)]
    take, handoffs = engines[0].take_handoff, []

    def taking(rid):
        h = take(rid)
        handoffs.append((tree_nbytes(h.segment), h.segment.k.shape[3]))
        return h

    engines[0].take_handoff = taking
    rate = 1.0 + 100.0 * tp.rank
    fleet = FleetRouter(engines, clock=lambda: time.perf_counter() * rate,
                        hedge_after_s=TP_ROLES["hedge_after_s"])
    zero()
    t0 = time.perf_counter()
    with native_sync_warnings():
        sen.install()
        try:
            gids = [fleet.submit(Request(prompt=p, max_new_tokens=new, seed=i))
                    for i, p in enumerate(prompts[:n])]
            done = {c.request_id: c for c in fleet.run_until_idle()}
        finally:
            sen.uninstall()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts()  # before the teacher-forced forwards below
    pre, dec_w, dec_p = engines
    served_by = {g: next(r for r, _, kind, _ in e.dispatches if kind == "handoff")
                 for g, e in fleet.ledger.entries.items()}
    held, paged_tf = {}, {}
    tokens = [done[g].tokens for g in gids]
    for i, g in enumerate(gids):  # the paged decode engine's, on its own logits
        if served_by[g] == 2:
            paged_tf[i] = dec_p.teacher_forced_logits(prompts[i], tokens[i]).cpu()
            held[i] = greedy_held(paged_tf[i], tokens[i])
    out["roles"] = {
        "tokens": tokens, "reasons": [done[g].finish_reason for g in gids],
        "served_by": [served_by[g] for g in gids], "paged_held": held,
        "paged_tf": paged_tf if tp.rank == 0 else {},
        "handoff_bytes": [b for b, _ in handoffs], "handoff_kv_heads": [h for _, h in handoffs],
        "prefill": {"host_syncs": pre.n_host_syncs, "chains": pre.n_chains,
                    "handoffs_out": pre.n_handoffs_out, "prefills": pre.n_prefills},
        "decode": [{"host_syncs": d.n_host_syncs, "chains": d.n_chains,
                    "handoffs_in": d.n_handoffs_in} for d in (dec_w, dec_p)],
        "host_syncs": sum(e.n_host_syncs for e in engines),
        "sentry": fleet.fleet_sentry_summary(), "ledger": fleet.ledger.verify(),
        "handoffs_moved": fleet.router_stats()["handoffs_moved"],
        "clock_broadcasts": fleet.n_clock_broadcasts, "states": fleet.replica_states(),
        "transitions": fleet.n_health_transitions,
        "dispatches": sorted((g, [(r, k) for r, _, k, _ in e.dispatches])
                             for g, e in fleet.ledger.entries.items()),
        "forwards": pre.n_prefills + (dec_w.n_chains + dec_p.n_chains) * TP_STREAM[
            "tokens_per_launch"],
        "paged_chains": dec_p.n_chains, "launches": launches,
        "wall_s": wall_s,
    }
    del engines, fleet, pre, dec_w, dec_p
    # SLO: the priority engine with its sentry
    lo, hi = TP_SLO["low"], TP_SLO["high"]
    sen = ContractSentry()
    eng = engine(n_slots=1, priority_classes=2, sentry=sen)
    swaps = []
    swap_out = eng._swap_out

    def recorded(slot):
        rid = eng._slots[slot].request.request_id
        swap_out(slot)
        swaps.append((rid, eng._swapped[rid].packed.numel()))

    eng._swap_out = recorded
    zero()
    t0 = time.perf_counter()
    with native_sync_warnings():
        sen.install()
        try:
            ids = [eng.submit(Request(prompt=prompts[lo], max_new_tokens=new, seed=lo,
                                      priority=1))]
            got = []
            for _ in range(TP_SLO["high_after"]):
                got += eng.step()
            ids.append(eng.submit(Request(prompt=prompts[hi], max_new_tokens=new, seed=hi)))
            got += eng.run_until_idle()
        finally:
            sen.uninstall()
    torch.cuda.synchronize()
    by_id = {c.request_id: c for c in got}
    out["slo"] = {
        "tokens": [by_id[i].tokens for i in ids],
        "reasons": [by_id[i].finish_reason for i in ids],
        "order": [c.request_id == ids[1] for c in got],
        "swaps": swaps, "swaps_out": eng.n_swaps_out, "swaps_in": eng.n_swaps_in,
        "host_syncs": eng.n_host_syncs,
        "budget": eng.n_chains + eng.n_prefills + eng.n_splices + eng.n_swaps_out,
        "tp_stats": eng.tp_stats(), "sentry": sen.summary(),
        "forwards": eng.n_prefills + eng.n_chains * TP_STREAM["tokens_per_launch"],
        "launches": counts(), "wall_s": time.perf_counter() - t0,
    }
    del eng
    if tp.rank == 0:  # the unsharded bytes of the same handoffs and swaps
        whole = engine(strategy=None, role="prefill")
        wids = [whole.submit(Request(prompt=p, max_new_tokens=new, seed=i))
                for i, p in enumerate(prompts[:n])]
        whole.run_until_idle()
        out["whole_handoff_bytes"] = [tree_nbytes(whole.take_handoff(w).segment) for w in wids]
        whole = engine(strategy=None, n_slots=1, priority_classes=2)
        wswaps = []
        swap_out = whole._swap_out

        def whole_recorded(slot):
            rid = whole._slots[slot].request.request_id
            swap_out(slot)
            wswaps.append(whole._swapped[rid].packed.numel())

        whole._swap_out = whole_recorded
        whole.submit(Request(prompt=prompts[lo], max_new_tokens=new, seed=lo, priority=1))
        for _ in range(TP_SLO["high_after"]):
            whole.step()
        whole.submit(Request(prompt=prompts[hi], max_new_tokens=new, seed=hi))
        whole.run_until_idle()
        out["whole_swap_bytes"] = wswaps
        del whole
    del params
    torch.cuda.empty_cache()
    return out


def tp_roles_unsharded(r0: dict, mono: list, mono_tf: list, rep: dict) -> dict:
    """The roles leg's tokens (rank 0's ``r0``) against the unsharded
    engine's (``rep``, the int8 arm's replicated side): where a request's
    differ, held as the int8 arm holds its own — the unsharded engine's
    logits teacher-forced on the roles tokens against the TP logits that
    chose them (the paged decode engine's own, else, where the tokens are
    the monolithic TP engine's, ``mono_tf``, that engine's), within
    ``tf_compare``'s bound, and greedy under those TP logits. Returns
    request -> the hold, ``ok`` in each."""
    held = {}
    for i, toks in enumerate(r0["tokens"]):
        if toks == rep["tokens"][i]:
            continue
        have = r0["paged_tf"].get(i, mono_tf[i] if toks == mono[i] else None)
        if have is None:
            held[i] = {"ok": False, "why": "no TP logits chose these tokens"}
            continue
        ref = rep["engine"].teacher_forced_logits(rep["prompts"][i], toks).cpu()
        tf, gh = tf_compare(ref, have), greedy_held(have, toks)
        held[i] = {"tf": {k: v for k, v in tf.items() if k != "per_step_max_abs_logit_diff"},
                   "greedy_held": gh, "ok": tf["ok"] and gh["ok"]}
    return held


def tp_roles_slo_gates(ranks: list, mono: list, unsharded: dict) -> list:
    """The gates of serve_1b_tp2's roles / SLO / router-clock legs over the
    ranks' ``tp_roles_slo_legs`` (``mono``: the sharded int8 arm's tokens,
    rank 0, by request: the roles' first TP_ROLES["requests"] and the SLO
    leg's two; ``unsharded``: ``tp_roles_unsharded``'s holds)."""
    bad = [f"roles: request {i} differs from the unsharded engine's and fails the "
           f"teacher-forced gate: {h}" for i, h in unsharded.items() if not h["ok"]]
    per = TP_LAYERS * 7 + 1
    tpl = TP_STREAM["tokens_per_launch"]
    whole_h, whole_s = ranks[0]["whole_handoff_bytes"], ranks[0]["whole_swap_bytes"]
    r0 = ranks[0]["roles"]
    off = [mono[TP_SLO["low"]], mono[TP_SLO["high"]]]
    mono = mono[:TP_ROLES["requests"]]
    for rank, legs in enumerate(ranks):
        ro, slo = legs["roles"], legs["slo"]
        for key in ("tokens", "served_by", "dispatches", "states", "transitions",
                    "clock_broadcasts", "handoff_kv_heads"):
            if ro[key] != r0[key]:
                bad.append(f"roles rank {rank}: {key} differs from rank 0's")
        for i, (got, want) in enumerate(zip(ro["tokens"], mono)):
            if got != want and not (i in ro["paged_held"] and ro["paged_held"][i]["ok"]):
                bad.append(f"roles rank {rank}: request {i} differs from the monolithic TP "
                           f"engine's (paged held: {ro['paged_held'].get(i)})")
        if ro["reasons"] != ["length"] * len(mono) or ro["ledger"] or ro[
                "handoffs_moved"] != len(mono):
            bad.append(f"roles rank {rank}: {ro['reasons']}, ledger {ro['ledger']}, "
                       f"moved {ro['handoffs_moved']}")
        if ro["prefill"]["host_syncs"] or ro["prefill"]["chains"]:
            bad.append(f"roles rank {rank}: prefill side {ro['prefill']}")
        for d in ro["decode"]:
            if d["host_syncs"] != d["chains"] + d["handoffs_in"]:
                bad.append(f"roles rank {rank}: decode side {d}")
        for got, whole in zip(ro["handoff_bytes"], whole_h):
            if abs(got / whole - 0.5) > 0.01:
                bad.append(f"roles rank {rank}: handoff {got} B against the unsharded {whole}")
        if ro["clock_broadcasts"] < 2 or ro["states"] != ["healthy"] * 3:
            bad.append(f"roles rank {rank}: {ro['clock_broadcasts']} clock broadcasts, "
                       f"states {ro['states']}")
        lc = ro["launches"]
        if (lc["int8"] != per * ro["forwards"] or lc["int8_tp"] != lc["int8"]
                or lc["int8_routes"]["v1"] or lc["flash"] != TP_LAYERS * ro["prefill"]["prefills"]
                or lc["flash_routes"]["sm80"] != lc["flash"]
                or lc["paged"] != TP_LAYERS * ro["paged_chains"] * tpl or lc["paged_routes"]["v1"]):
            bad.append(f"roles rank {rank}: launches {lc}, {ro['forwards']} forwards, "
                       f"{ro['paged_chains']} paged chains")
        if slo["tokens"] != off or slo["reasons"] != ["length", "length"]:
            bad.append(f"slo rank {rank}: tokens differ from the SLO-off TP engine's (the "
                       "int8 arm's)")
        if slo["swaps_out"] < 1 or slo["swaps_in"] != slo["swaps_out"] or not slo["order"][0]:
            bad.append(f"slo rank {rank}: swaps {slo['swaps_out']} / {slo['swaps_in']}, "
                       f"class-0 first {slo['order']}")
        if [r for r, _ in slo["swaps"]] != [r for r, _ in ranks[0]["slo"]["swaps"]]:
            bad.append(f"slo rank {rank}: victims differ from rank 0's")
        for (_, got), whole in zip(slo["swaps"], whole_s):
            if abs(got / whole - 0.5) > 0.01:
                bad.append(f"slo rank {rank}: swap {got} B against the unsharded {whole}")
        if slo["host_syncs"] != slo["budget"]:
            bad.append(f"slo rank {rank}: host syncs {slo['host_syncs']}, budget "
                       f"{slo['budget']}")
        if slo["tp_stats"]["tp_swap_agreements"] != slo["swaps_in"]:
            bad.append(f"slo rank {rank}: {slo['tp_stats']['tp_swap_agreements']} agreements")
        for what, s, syncs in (("roles", ro["sentry"], ro["host_syncs"]),
                               ("slo", slo["sentry"], slo["host_syncs"])):
            if (s["sentry_budget_violations"] or s["sentry_reuploads"]
                    or s["sentry_steady_recompiles"]
                    or not s["sentry_fetched"] == s["sentry_budgeted"] == syncs):
                bad.append(f"{what} rank {rank}: sentry {s}, host syncs {syncs}")
        lc = slo["launches"]
        if lc["int8"] != per * slo["forwards"] or lc["int8_routes"]["v1"]:
            bad.append(f"slo rank {rank}: int8 {lc}, {slo['forwards']} forwards")
    return bad


# the world of 4 (serve_1b_tp2_world4): gloo on card 0, {"data": 2,
# "model": 2}; model group {0, 1} serves the int8 arm's requests
# TP_WORLD4["picked"][0::2], {2, 3} its [1::2], each through a TP engine at
# the 1b widths and TP_LAYERS with a default deadline (a clock feature:
# one broadcast a step over the group's own decision group)
TP_WORLD4 = dict(picked=(1, 2, 3, 5, 6, 7), deadline_s=600.0)


def tp_world4_rank(world_tp) -> dict:
    """One rank of serve_1b_tp2_world4 (spawned by ``spawn_tp``, world 4)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import (
        flash_attention as fa,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops import quant
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        TensorParallel,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    tp = TensorParallel(create_mesh({"data": 2, "model": 2}, device="cuda"))
    arm = TP_ARMS["int8"]
    cfg = TransformerConfig(**arm["preset"], quantized=True, attention_fn=fa.flash_attention)
    params = init_quantized_lm(cfg, seed=0, device="cuda")
    rng = np.random.Generator(np.random.PCG64(15))
    prompts = [rng.integers(0, cfg.vocab_size, (arm["prompts"][i % len(arm["prompts"])],))
               .tolist() for i in range(arm["requests"])]
    eng = ServeEngine(TransformerLM(cfg), params, max_queue=64, device="cuda", strategy=tp,
                      default_deadline_s=TP_WORLD4["deadline_s"], **TP_STREAM)
    del params
    mine = list(TP_WORLD4["picked"][tp.data_rank::2])
    quant.int8_matmul_tp.launches = 0
    t1 = time.perf_counter()
    with native_sync_warnings():
        ids = [eng.submit(Request(prompt=prompts[i], max_new_tokens=arm["new"], seed=i))
               for i in mine]
        done, steps = [], 0
        while not eng.idle:
            done += eng.step()
            steps += 1
    torch.cuda.synchronize()
    by_id = {c.request_id: c for c in done}
    return {
        "rank": dist.get_rank(), "data_rank": tp.data_rank, "model_rank": tp.rank,
        "requests": mine, "tokens": [by_id[i].tokens for i in ids],
        "reasons": [by_id[i].finish_reason for i in ids], "steps": steps,
        "broadcasts": eng.n_decision_broadcasts,
        "group": dist.get_process_group_ranks(eng._dgroup), "host_syncs": eng.n_host_syncs,
        "budget": eng.n_chains + eng.n_prefills + eng.n_splices,
        "int8_tp": quant.int8_matmul_tp.launches,
        "forwards": eng.n_prefills + eng.n_chains * TP_STREAM["tokens_per_launch"],
        "serve_s": time.perf_counter() - t1, "rank_s": time.perf_counter() - t0,
    }


def phase_serve_tp_world4(torch, gpu: str, tp: dict) -> dict:
    """``serve_1b_tp2_world4``: two TP-2 engines with deadlines in one gloo
    world of 4 on card 0 (TP_WORLD4), spawned here, the decision groups of
    both model groups made on every rank (``tp_world4_rank``). Gates: the
    two ranks of each group complete the same requests with the same
    tokens; each request's tokens equal the unsharded engine's, or where
    the TP-2 world's differ from it (held teacher-forced there) the TP-2
    world's; one broadcast a step in each group; host syncs the budget; 57
    int8 shard calls a forward. Returns the int8 shard calls by rank."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        spawn_tp,
    )

    t0 = time.perf_counter()
    ranks = spawn_tp(tp_world4_rank, 4, (), backend="gloo", device="cuda", join_timeout_s=300)
    ranks = sorted(ranks, key=lambda r: r["rank"])
    bad = []
    rep, sharded = tp["replicated_tokens"], tp["sharded_tokens"]
    per = TP_LAYERS * 7 + 1
    for r in ranks:
        peer = ranks[r["rank"] ^ 1]
        if r["tokens"] != peer["tokens"] or r["steps"] != peer["steps"]:
            bad.append(f"rank {r['rank']}: differs from its group's other rank")
        if r["group"] != sorted((r["rank"], peer["rank"])):
            bad.append(f"rank {r['rank']}: decision group {r['group']}")
        for i, toks in zip(r["requests"], r["tokens"]):
            if toks != rep[i] and toks != sharded[i]:
                bad.append(f"rank {r['rank']}: request {i} equals neither the unsharded nor "
                           "the TP-2 world's tokens")
        if r["reasons"] != ["length"] * len(r["requests"]):
            bad.append(f"rank {r['rank']}: {r['reasons']}")
        if r["broadcasts"] != r["steps"] or r["host_syncs"] != r["budget"]:
            bad.append(f"rank {r['rank']}: {r['broadcasts']} broadcasts in {r['steps']} steps, "
                       f"host syncs {r['host_syncs']} of {r['budget']}")
        if r["int8_tp"] != per * r["forwards"]:
            bad.append(f"rank {r['rank']}: {r['int8_tp']} shard calls, {r['forwards']} forwards")
    emit({"phase": "serve_1b_tp2_world4", "mesh": {"data": 2, "model": 2}, "backend": "gloo",
          "layers": TP_LAYERS, "requests_by_group": [ranks[0]["requests"], ranks[2]["requests"]],
          "tokens_equal_unsharded": [sum(t == rep[i] for i, t in zip(r["requests"], r["tokens"]))
                                     for r in ranks],
          "steps": [r["steps"] for r in ranks], "broadcasts": [r["broadcasts"] for r in ranks],
          "groups": [r["group"] for r in ranks], "host_syncs": [r["host_syncs"] for r in ranks],
          "int8_matmul_tp_launches": [r["int8_tp"] for r in ranks],
          "serve_s": [r["serve_s"] for r in ranks], "rank_s": [r["rank_s"] for r in ranks],
          "seconds": time.perf_counter() - t0, "timing_note": TP_NOTE,
          "ok": not bad, "problems": bad, "gpu": gpu})
    if bad:
        raise AssertionError("; ".join(bad))
    return {"int8_tp": [r["int8_tp"] for r in ranks]}


# train_760m_tp2: bench/lm_headline.py's 760m preset (vocab 32768, d_model
# 1536, 16 heads of 96, d_ff 6144, seq 2048, batch 2, bf16,
# flash, remat "dots") with the fused loss, fused AdamW (3e-4, weight decay
# 0.01) and the skip guard, through Trainer(strategy=TensorParallel(
# create_mesh({"model": 2}))): 8 heads, 3072 of d_ff and 16384 vocabulary
# columns a rank, both ranks on card 0 over gloo; beside the single-device
# Trainer from the same seed. Full width at TP_TRAIN_LAYERS of the 24
# layers, to keep the whole script inside the tool's time limit (a
# rank's gloo-staged steps scale with the depth)
TP_TRAIN_STEPS = 4
TP_TRAIN_LAYERS = 8
TP_TRAIN_CFG = dict(PRESET_760M, n_layers=TP_TRAIN_LAYERS, max_seq_len=2048, remat=True,
                    remat_policy="dots")
TP_TRAIN_BATCH = 2
# the leaves whose first step is held against the single-device step's
# slice: AdamW's first moment after one step is (1 - b1) g, the step's
# gradient (an early and a late block's column and row shards, norms)
TP_TRAIN_LEAVES = ("blocks.0.attn_norm.scale", "blocks.0.attn.q_proj.weight",
                   "blocks.0.attn.o_proj.weight",
                   f"blocks.{TP_TRAIN_LAYERS // 2}.mlp_norm.scale",
                   f"blocks.{TP_TRAIN_LAYERS // 2}.attn.k_proj.weight",
                   f"blocks.{TP_TRAIN_LAYERS - 1}.attn.o_proj.weight", "final_norm.scale")
# the first step's gates against the single-device step: the loss within
# 1e-3 of it (relative), and each named leaf's first moment within 10% of
# the single-device one's (relative error norm). Both sides run bf16
# matmuls: TP rounds each half-K row-parallel partial to bf16 and gloo
# sums the pair in bf16, a bf16 ulp (2^-8) of every row-parallel output
# against the single-device product's one rounding, which the layers
# carry into the gradients at the percent level (0.4-1.0% on a 2-layer
# toy model on the CPU); the planted fault (f's backward sum dropped: a
# column region's input gradient only the rank's part) missed by 63-94%
# there. The first update itself is no gate: AdamW's first step is lr
# times the gradient's sign (plus the decay), the same bits wherever the
# signs agree, fault or not
TP_TRAIN_LOSS_TOL = 1e-3
TP_TRAIN_GRAD_TOL = 0.1
# per rank and step: every block's g twice forward and once more in its
# recompute (remat "dots" recomputes a block only up to the last tensor
# its backward reads, the down_proj's matmul: its sum is not redone), f
# twice backward; the fused loss's MAX, SUM and dh; the guard's flag MIN
TP_TRAIN_COLLECTIVES = {
    "all_reduce": 0, "all_gather": 0, "g": 3 * TP_TRAIN_LAYERS,
    "f": 2 * TP_TRAIN_LAYERS, "lse_max": 1, "lse_sum": 1, "dh": 1, "flag_min": 1}
# flash launches a rank a step (FLASH_PER_STEP at the cut depth)
TP_TRAIN_FLASH = {"fwd": 2 * TP_TRAIN_LAYERS, "dq": TP_TRAIN_LAYERS, "dkv": TP_TRAIN_LAYERS}


def tp_train_batch():
    """bench/lm_headline.py's batch: tokens from PCG64(0), (2, 2049)."""
    import numpy as np

    rng = np.random.Generator(np.random.PCG64(0))
    toks = rng.integers(0, PRESET_760M["vocab_size"], (TP_TRAIN_BATCH, 2049))
    return toks[:, :-1], toks[:, 1:]


def tp_train_run(torch, tp, steps: int) -> dict:
    """``steps`` steps of the 760m fused, guarded Trainer — with ``tp`` a
    TensorParallel, this rank's shard; None, the single-device Trainer —
    one step an epoch on one batch: the losses, each step's host ms (to
    the epoch's fetch), peak memory, the launches and routes, the
    collectives, the first step's loss, first moments and updates of
    TP_TRAIN_LEAVES (this rank's shards, on the host) and the bit sums
    of the replicated leaves."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_loss import (
        fused_cross_entropy,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer

    cfg = TransformerConfig(**TP_TRAIN_CFG, dtype=torch.bfloat16,
                            attention_fn=make_flash_attention(1024, 1024))
    x, y = tp_train_batch()
    mesh = tp.mesh if tp is not None else create_mesh(device="cuda")
    loader = ShardedLoader(ArrayDataset((x, y)), TP_TRAIN_BATCH, mesh, batch_mode="global",
                           shuffle=False)
    t0 = time.perf_counter()
    trainer = Trainer(TransformerLM(cfg), loader, fused_adamw(3e-4, weight_decay=0.01),
                      strategy=tp, loss="fused_cross_entropy", seed=0, quiet=True,
                      skip_nonfinite=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model, state = trainer.model, trainer.state
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    named = {n: p for n, p in model.named_parameters()}
    before = {n: named[n].detach().cpu() for n in TP_TRAIN_LEAVES}
    for counts in (flash_attention.launches, *flash_attention.routes.values(),
                   fused_cross_entropy.launches, *fused_cross_entropy.routes.values()):
        for k in counts:
            counts[k] = 0
    fused_adamw.launches = 0
    if tp is not None:
        tp.reset_collectives()
    torch.cuda.reset_peak_memory_stats()
    step_ms, first = [], {}
    for e in range(1, steps + 1):
        t = time.perf_counter()
        trainer.train(e)  # one step an epoch, its loss fetched at the epoch's end
        step_ms.append((time.perf_counter() - t) * 1e3)
        if e == 1:
            mu = state.opt_state.mu
            first = {"mu": {n: mu[names.index(n)].detach().cpu() for n in TP_TRAIN_LEAVES},
                     "update": {n: named[n].detach().cpu() - before[n]
                                for n in TP_TRAIN_LEAVES}}
    replicated = [p for n, p in named.items() if n == "tok_emb.weight" or n.endswith(".scale")]
    out = {
        "losses": [ev["loss"] for ev in trainer.metrics.step_events()],
        "skipped": trainer.steps_skipped, "step_ms": step_ms, "init_s": init_s,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "flash": dict(flash_attention.launches),
        "flash_routes": {k: dict(c) for k, c in flash_attention.routes.items()},
        "fused_loss": dict(fused_cross_entropy.launches),
        "fused_loss_routes": {k: dict(c) for k, c in fused_cross_entropy.routes.items()},
        "fused_adamw": fused_adamw.launches,
        "collectives": dict(tp.collectives) if tp is not None else {},
        "replicated_bits": bit_checksum(torch, replicated).tolist(),
        "n_params": sum(p.numel() for p in model.parameters()), **first,
    }
    del trainer, model, state, named, replicated
    torch.cuda.empty_cache()
    return out


def tp_train_rank(world_tp, steps: int) -> dict:
    """One rank of train_760m_tp2 (spawned by ``spawn_tp``): the strategy
    over the ``{"model": 2}`` mesh, ``steps`` steps, then one step of a
    fresh run with the planted fault — f's backward sum replaced by the
    identity (``copy_to`` the identity both ways) — for the gate to
    catch."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        TensorParallel,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = TensorParallel(create_mesh({"model": TP}, device="cuda"))
    out = tp_train_run(torch, tp, steps)
    tp.copy_to = lambda x: x
    fault = tp_train_run(torch, tp, 1)
    del tp.copy_to
    out["fault"] = {k: fault[k] for k in ("losses", "mu", "update", "collectives")}
    out["rank"] = tp.rank
    return out


def rel_err(torch, got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


def tp_train_gaps(torch, rank_run: dict, ref: dict, rank: int) -> dict:
    """A rank's first-step loss and its TP_TRAIN_LEAVES' first moments and
    updates against the single-device step's, sliced to the rank's shard."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        shard_params,
    )

    head_dim = PRESET_760M["d_model"] // PRESET_760M["n_heads"]
    gaps = {"loss": abs(rank_run["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])}
    for what in ("mu", "update"):
        want = shard_params(ref[what], rank, TP, head_dim=head_dim)
        gaps[what] = {n: rel_err(torch, rank_run[what][n], want[n]) for n in TP_TRAIN_LEAVES}
    return gaps


def phase_train_tp(torch, gpu: str) -> dict:
    """``train_760m_tp2``: tensor-parallel training at TP 2 (TP_TRAIN_CFG),
    the single-device Trainer first, here, then the two ranks (NCCL with a
    card each, else gloo on card 0). Gates: finite losses that fall; every
    rank's losses the same floats and its replicated leaves (embedding,
    norms) the same bits after the steps; the first step's loss within
    TP_TRAIN_LOSS_TOL of the single-device one's and each named leaf's
    first moment within TP_TRAIN_GRAD_TOL of its slice, and the planted
    fault (f's backward sum dropped) outside it, its gap printed; the
    collectives a step exactly TP_TRAIN_COLLECTIVES; per rank a step
    TP_TRAIN_FLASH flash, 1 / 1 / 1 fused-loss and 1 AdamW launches, all sm90.
    Step ms and peak memory a rank beside the single-device step's (with
    gloo not TP's speed)."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        spawn_tp,
    )

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= TP else "gloo"
    ref = tp_train_run(torch, None, TP_TRAIN_STEPS)
    t0 = time.perf_counter()
    ranks = spawn_tp(tp_train_rank, TP, (TP_TRAIN_STEPS,), backend=backend, device="cuda",
                     join_timeout_s=900)
    ranks_s = time.perf_counter() - t0
    steps = TP_TRAIN_STEPS
    problems = []
    want_flash = {k: n * steps for k, n in TP_TRAIN_FLASH.items()}
    want_fused = {k: n * steps for k, n in FUSED_PER_STEP.items()}
    want_coll = {k: n * steps for k, n in TP_TRAIN_COLLECTIVES.items()}
    gaps = [tp_train_gaps(torch, r, ref, r["rank"]) for r in ranks]
    fault_gaps = [tp_train_gaps(torch, r["fault"], ref, r["rank"]) for r in ranks]
    for run in (ref, *ranks):
        who = "single device" if run is ref else f"rank {run['rank']}"
        losses = run["losses"]
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            problems.append(f"{who}: losses {losses} not finite and falling")
        if run["skipped"]:
            problems.append(f"{who}: {run['skipped']} steps skipped")
        if (run["flash"] != want_flash or run["fused_loss"] != want_fused
                or run["fused_adamw"] != ADAMW_PER_STEP * steps):
            problems.append(f"{who}: launches flash {run['flash']}, fused loss "
                            f"{run['fused_loss']}, AdamW {run['fused_adamw']}")
        routes = (*run["flash_routes"].values(), *run["fused_loss_routes"].values())
        if any(c["sm80"] for c in routes):
            problems.append(f"{who}: a launch left the sm90 route: {routes}")
    for r, g, fg in zip(ranks, gaps, fault_gaps):
        if r["losses"] != ranks[0]["losses"]:
            problems.append(f"rank {r['rank']}: losses {r['losses']} != rank 0's")
        if r["replicated_bits"] != ranks[0]["replicated_bits"]:
            problems.append(f"rank {r['rank']}: replicated leaves differ from rank 0's")
        if r["collectives"] != want_coll:
            problems.append(f"rank {r['rank']}: collectives {r['collectives']} != {want_coll}")
        if not (g["loss"] <= TP_TRAIN_LOSS_TOL
                and max(g["mu"].values()) <= TP_TRAIN_GRAD_TOL):
            problems.append(f"rank {r['rank']}: first step off the single-device one: {g}")
        if max(fg["mu"].values()) <= TP_TRAIN_GRAD_TOL:
            problems.append(f"rank {r['rank']}: the planted fault passed the gate: {fg}")
    emit({
        "phase": "train_760m_tp2", "tp": TP, "backend": backend, "cards": cards,
        "config": {**TP_TRAIN_CFG, "dtype": "bf16", "attention": "flash",
                   "batch": TP_TRAIN_BATCH, "loss": "fused_cross_entropy",
                   "optimizer": "fused_adamw(3e-4, weight_decay=0.01)",
                   "skip_nonfinite": True},
        "steps": steps, "n_params_single": ref["n_params"],
        "n_params_per_rank": [r["n_params"] for r in ranks],
        "losses_single": ref["losses"], "losses_per_rank": [r["losses"] for r in ranks],
        "first_step_gaps": gaps, "tolerance": {"loss": TP_TRAIN_LOSS_TOL,
                                               "first_moment": TP_TRAIN_GRAD_TOL},
        "planted_fault": "f's backward all_reduce replaced by the identity",
        "planted_fault_gaps": fault_gaps,
        "collectives_per_step": [{k: v / steps for k, v in r["collectives"].items()}
                                 for r in ranks],
        "expected_collectives_per_step": TP_TRAIN_COLLECTIVES,
        "launches_per_rank": [{"flash": r["flash"], "fused_loss": r["fused_loss"],
                               "fused_adamw": r["fused_adamw"]} for r in ranks],
        "routes_rank0": {"flash": ranks[0]["flash_routes"],
                         "fused_loss": ranks[0]["fused_loss_routes"]},
        "step_ms_single": ref["step_ms"], "step_ms_per_rank": [r["step_ms"] for r in ranks],
        "peak_memory_bytes_single": ref["peak_memory_bytes"],
        "peak_memory_bytes_per_rank": [r["peak_memory_bytes"] for r in ranks],
        "init_s_single": ref["init_s"], "init_s_per_rank": [r["init_s"] for r in ranks],
        "ranks_s": ranks_s, "timing_note": TP_NOTE if backend == "gloo" else None,
        "ok": not problems, "problems": problems, "gpu": gpu,
    })
    if problems:
        raise AssertionError("; ".join(problems))
    return {"fused_loss": ranks[0]["fused_loss"], "routes": ranks[0]["fused_loss_routes"],
            "backend": backend}


def fused_ce_tp_row(kern: dict, train: dict) -> dict:
    """The kernels line's ``fused_cross_entropy_tp`` row: one TP-2 rank's
    shard calls of one 760m train step (forward, dh, dW at N 4096, D 1536,
    V_local 16384), times, plain times, bounds and the library yardstick
    summed over the three; launches from train_760m_tp2's rank 0."""
    res = kern["results"]
    tot = {k: sum(res[kind][k] for kind in ("fwd", "dh", "dw"))
           for k in ("ms", "unsharded_ms", "plain_ms", "bound_ms")}
    return {
        "name": "fused_cross_entropy_tp", "route": "cuda",
        "source": f"{PKG}/csrc/fused_loss_sm90.cu", "replaces": FUSED_CE_TP_REPLACES,
        "wrapper": f"{PKG}/ops/fused_loss.py fused_cross_entropy_tp",
        "launches": sum(train["fused_loss"].values()),
        "launches_by_kernel": train["fused_loss"], "route_counts": train["routes"],
        "max_abs_err": kern["max_abs_err"], **tot,
        "bound_by": "operations", "library_ms": res["fwd"]["library_ms"]
        + res["dh"]["library_ms"],
        "by_kernel": {kind: {k: res[kind][k] for k in ("ms", "unsharded_ms", "plain_ms",
                                                         "bound_ms", "library_ms")}
                      for kind in ("fwd", "dh", "dw")},
        "work": f"one rank's share of one 760m train step at TP {TP}: the forward, dh and dW "
                "shard calls at N=4096 D=1536 V_local=16384 bf16",
        "backend": train["backend"],
        "library_note": "the shard's materialized logits: cuBLAS h @ W_local + "
                        "F.cross_entropy, forward and backward",
    }


LOSSES = ("cross_entropy", "fused_cross_entropy")


def phase_train_card_vs_cpu(torch, gpu: str) -> None:
    """Phase 5: a 2-layer model at the 760m widths, S 128, flash attention,
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

    seq = 128
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
    # dtype -> the weights both losses start from (the CPU's init is most
    # of the phase's time)
    inits = {}
    for (dtype, tol), loss_name in itertools.product(tols.items(), LOSSES):
        fused = loss_name == "fused_cross_entropy"
        cfg = TransformerConfig(**{**PRESET_760M, "n_layers": 2}, max_seq_len=seq, dtype=dtype,
                                attention_fn=make_flash_attention(1024, 1024), quantized=False)
        if dtype not in inits:
            inits[dtype] = init_lm(cfg, seed=5, device="cpu")
        params = inits[dtype]
        loss_fn = _make_loss_fn(loss_name)
        out, stepped = {}, {}
        before = dict(flash_attention.launches)
        loss_before = dict(fused_cross_entropy.launches)
        adamw_before = fused_adamw.launches
        for dev in ("cuda", "cpu"):
            model = TransformerLM(cfg)
            # copies on both sides: the fused arm's step updates them in place
            bind_params(model, {k: v.to(dev, copy=True) for k, v in params.items()})
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
                                   nu=[v.clone() for v in opt_state.nu],
                                   count=opt_state.count.clone())

    s_fused, s_plain = copy_state(), copy_state()
    count = int(s_fused.count) + 1
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


# train_resnet_streaming: the headline workload through the streaming
# loaders, 16 steps a chunk, 2 chunks (or batches) ahead
STREAM_CHUNK, STREAM_PREFETCH = 16, 2
# the profiled window of the chunked arm: the first rows of MNIST, 48
# steps, 3 whole chunks: chunks 2 and 3 upload (130 us each) while chunk
# 1 trains. A first window of 20 steps (16 + 4) caught only the 4-step
# chunk's two copies (63 us in all), both in idle gaps of the host-bound
# steps
STREAM_PROFILE_STEPS = 48
# train_guardrails (a): the headline at full width over its first rows
# (12 steps), batch 3 poisoned; (c): 4 steps an epoch, the spike at monitor
# steps 6-8 after a save at the end of epoch 1
GUARD_STEPS, GUARD_NAN_BATCH = 12, 3
ROLLBACK_STEPS = 4
ROLLBACK_SPIKE = dict(spike_loss_step=6, spike_loss_len=3, spike_loss_factor=1e6)
# launch_overhead_fit's eager chains on the card
LAUNCH_FIT_LENS = (64, 1024)


def deterministic(torch):
    """cuDNN in its deterministic algorithms (TF32 off): two runs of the
    same steps give the same bits, so arms can be compared bitwise."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def headline_rows(full, steps: int):
    """The first ``steps`` global batches' rows of ``full``."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset

    return ArrayDataset(tuple(a[:steps * RESNET_BATCH] for a in full.arrays),
                        synthetic=full.synthetic)


def batch_checksums(torch, batches) -> "torch.Tensor":
    """(steps, 2) int64 on the device: each batch's image and label bit
    sums, with no host sync."""
    out = []
    for x, y in batches:
        out.append(torch.stack([x.reshape(-1).view(torch.int16).to(torch.int64).sum(),
                                y.to(torch.int64).sum()]))
    return torch.stack(out)


def h2d_overlap(trace_path: str) -> dict:
    """From a ``torch.profiler`` chrome trace: the host-to-device copies,
    and those that overlap a kernel on another stream in time."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    t0 = min((e["ts"] for e in kernels + copies), default=0.0)
    overlapped, overlap_us, listed = 0, 0.0, []
    for c in copies:
        c0, c1 = c["ts"], c["ts"] + c["dur"]
        spans = [(max(c0, k["ts"]), min(c1, k["ts"] + k["dur"])) for k in kernels
                 if k.get("args", {}).get("stream") != c.get("args", {}).get("stream")]
        busy = sum(b - a for a, b in spans if b > a)
        overlapped += busy > 0
        overlap_us += busy
        listed.append({"at_us": c0 - t0, "us": c["dur"], "bytes": c.get("args", {}).get("bytes"),
                       "stream": c.get("args", {}).get("stream"), "kernel_us_during": busy})
    return {"h2d_copies": len(copies), "h2d_copies_overlapping_compute": overlapped,
            "h2d_us": sum(c["dur"] for c in copies), "kernel_us_during_copies": overlap_us,
            "kernels": len(kernels),
            "kernel_span_us": [min((k["ts"] for k in kernels), default=t0) - t0,
                               max((k["ts"] + k["dur"] for k in kernels), default=t0) - t0],
            "copies": listed}


def phase_train_resnet_streaming(torch, gpu: str) -> dict:
    """The headline (ResNet-18, 512 a device, bf16, SGD 0.05 momentum 0.9)
    in an NCCL world of one, one epoch in each of three arms under
    deterministic cuDNN: resident (``DeviceResidentLoader``), chunked
    (``ChunkedStreamingLoader``, 16 steps a chunk, 2 ahead) and prefetched
    (``PrefetchLoader`` over ``ShardedLoader``, 2 ahead). Gates: every
    step's batch the resident loader's (bit sums), every step's loss
    bitwise the resident arm's, at most one host sync an epoch (sync debug
    mode), and in a profiled window of the chunked arm an H2D copy
    overlapping compute. The chunked epoch is bracketed by an H2D ceiling
    (``DriftBracket``)."""
    from pytorch_distributed_training_tutorials_tpu_torch.launch import pick_unused_port
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import distributed

    distributed.init(f"127.0.0.1:{pick_unused_port()}", num_processes=1, process_id=0)
    try:
        with deterministic(torch):
            return streaming_arms(torch, gpu)
    finally:
        distributed.shutdown()


def streaming_arms(torch, gpu: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_training_tutorials_tpu_torch.bench import headline
    from pytorch_distributed_training_tutorials_tpu_torch.bench.__main__ import h2d_ceiling
    from pytorch_distributed_training_tutorials_tpu_torch.bench.harness import count_host_syncs
    from pytorch_distributed_training_tutorials_tpu_torch.data import (
        ChunkedStreamingLoader,
        PrefetchLoader,
        ShardedLoader,
        mnist,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs import DriftBracket

    def chunked(*a, **kw):
        return ChunkedStreamingLoader(*a, steps_per_chunk=STREAM_CHUNK, prefetch=STREAM_PREFETCH,
                                      **kw)

    def prefetched(*a, **kw):
        return PrefetchLoader(ShardedLoader(*a, **kw), prefetch=STREAM_PREFETCH)

    problems = []
    dataset = mnist("train", raw=True)
    arms, sums, losses = {}, {}, {}
    bracket = None
    for name, loader_cls in (("resident", None), ("chunked", chunked), ("prefetch", prefetched)):
        setup = headline.make_headline_setup(RESNET_BATCH, quiet=True, dataset=dataset,
                                             loader_cls=loader_cls)
        loader = setup.loader
        loader.set_epoch(0)
        if name == "chunked":
            batches = (loader.chunk_step(c, i) for c in loader.iter_chunks()
                       for i in range(c[0].shape[0]))
        else:
            batches = iter(loader)
        sums[name] = batch_checksums(torch, batches)
        fetches = setup.trainer.host_syncs

        def counted_epoch():
            with count_host_syncs(torch) as syncs:
                r = headline.time_epoch(setup)
            r["host_syncs"], r["sync_sites"] = syncs[0], syncs[1:]
            return r

        if name == "chunked":
            chunk_bytes = STREAM_CHUNK * RESNET_BATCH * dataset.arrays[0][0].nbytes
            ceiling, payload = h2d_ceiling(chunk_bytes, 7, setup.trainer.device)
            ceiling()
            bracket = DriftBracket(ceiling, payload_bytes=payload).around(counted_epoch)
            r = bracket.result
        else:
            r = counted_epoch()
        r["trainer_fetches"] = setup.trainer.host_syncs - fetches
        losses[name] = [e["loss"] for e in setup.trainer.metrics.step_events()]
        arms[name] = r
        if r["host_syncs"] > 1 or r["trainer_fetches"] != 1:
            problems.append(f"{name}: {r['host_syncs']} host syncs, {r['trainer_fetches']} "
                            "trainer fetches in the epoch (want at most 1, 1)")
        del setup, loader
    for name in ("chunked", "prefetch"):
        if not torch.equal(sums[name], sums["resident"]):
            differ = int((sums[name] != sums["resident"]).any(1).sum())
            problems.append(f"{name}: {differ} steps' batches differ from the resident loader's")
        if losses[name] != losses["resident"]:
            n = sum(a != b for a, b in zip(losses[name], losses["resident"]))
            problems.append(f"{name}: {n} step losses differ from the resident arm's")

    # the profiled window: a chunk's upload against the steps of the one before
    window = headline.make_headline_setup(RESNET_BATCH, quiet=True,
                                          dataset=headline_rows(dataset, STREAM_PROFILE_STEPS),
                                          loader_cls=chunked)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window.trainer.train(1)
        torch.cuda.synchronize()
    trace_path = os.path.join(REPO, "build", "streaming_trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    overlap = h2d_overlap(trace_path)
    os.remove(trace_path)
    if not overlap["h2d_copies_overlapping_compute"]:
        problems.append(f"no H2D copy overlaps compute in the chunked window: {overlap}")
    n_dev = 1
    ceiling_images = 7 * STREAM_CHUNK * RESNET_BATCH / bracket.ceiling_s
    emit({"phase": "train_resnet_streaming", "model": "resnet18 cifar stem, bf16 on f32 params",
          "per_device_batch": RESNET_BATCH, "steps_per_chunk": STREAM_CHUNK,
          "prefetch": STREAM_PREFETCH, "cudnn": "deterministic, TF32 off",
          "arms": arms, "images_per_sec_per_gpu": {
              k: v["images_per_sec"] / n_dev for k, v in arms.items()},
          "loss_comparison": "bitwise, every step, against the resident arm",
          "batches_compared": int(sums["resident"].shape[0]),
          "h2d_ceiling": {**bracket.to_dict(), "images_per_sec": ceiling_images,
                          "bytes": bracket.payload_bytes},
          "chunked_fraction_of_h2d_ceiling": arms["chunked"]["images_per_sec"] / ceiling_images,
          "profiled_window": {"steps": STREAM_PROFILE_STEPS, **overlap},
          "ok": not problems, "problems": problems, "gpu": gpu})
    if problems:
        raise AssertionError("; ".join(problems))
    return {"images_per_sec": {k: v["images_per_sec"] for k, v in arms.items()},
            "h2d_drift": bracket.drift}


def state_tensors(state) -> list:
    """Every tensor a step may write: the model's parameters and buffers
    (BatchNorm's statistics), the optimizer state, the step count."""
    opt = state.opt_state
    opt_t = [*opt.mu, *opt.nu, opt.count] if hasattr(opt, "mu") else list(opt.trace or [])
    return [*state.model.state_dict().values(), *opt_t, state.step]


def phase_train_guardrails(torch, gpu: str) -> dict:
    """(a) the headline at full width over its first GUARD_STEPS steps with
    ``skip_nonfinite=True`` and batch GUARD_NAN_BATCH poisoned, under SGD
    and ``fused_adamw``: one step skipped, the final state bitwise
    (``bit_checksum``) that of a clean run with that update elided, host
    syncs an epoch as the guard-off run's, and one AdamW launch a step;
    (b) the 760m fused step (flash, the fused loss, ``fused_adamw``) with
    the guard: a poisoned step (``nan_grad_step``) leaves p, m, v, the
    count and ``step`` bitwise unchanged, a clean guarded step is bitwise
    the guard-off step, and step ms guard on against off, in turns;
    (c) rollback after a save: one rollback, the epoch kept, training on."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import mnist

    full = mnist("train", raw=True)
    with deterministic(torch):
        a = guard_resnet(torch, gpu, headline_rows(full, GUARD_STEPS))
    b = guard_760m(torch, gpu)
    c = guard_rollback(torch, gpu, headline_rows(full, ROLLBACK_STEPS))
    return {**a, **b, "rollbacks": c}


def guard_resnet(torch, gpu: str, dataset) -> dict:
    from pytorch_distributed_training_tutorials_tpu_torch.bench import headline
    from pytorch_distributed_training_tutorials_tpu_torch.bench.harness import count_host_syncs
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.train import sgd
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

    problems, arms, launches = [], {}, 0
    for opt_name, make_opt in (("sgd", lambda: sgd(headline.LR, headline.MOMENTUM)),
                               ("fused_adamw", lambda: fused_adamw(**ADAMW_ARM))):
        runs = {}
        for run in ("guarded", "elided", "guard_off"):
            kw = {"skip_nonfinite": True,
                  "chaos": ChaosConfig(nan_batch_step=GUARD_NAN_BATCH)} if run == "guarded" else {}
            setup = headline.make_headline_setup(RESNET_BATCH, quiet=True, dataset=dataset,
                                                 optimizer=make_opt(), **kw)
            trainer = setup.trainer
            fused_adamw.launches = 0
            with count_host_syncs(torch) as syncs:
                if run == "elided":  # the clean run with the poisoned update left out
                    trainer.loader.set_epoch(0)
                    for i, batch in enumerate(trainer.loader, start=1):
                        if i != GUARD_NAN_BATCH:
                            trainer.state, _ = trainer.train_step(trainer.state, batch)
                    torch.cuda.synchronize()
                else:
                    trainer.train(1)
            runs[run] = {"checksum": bit_checksum(torch, state_tensors(trainer.state)).tolist(),
                         "host_syncs": syncs[0], "adamw_launches": fused_adamw.launches,
                         "step": int(trainer.state.step)}
            if run == "guarded":
                runs[run]["steps_skipped"] = trainer.steps_skipped
                runs[run]["skipped_at"] = [e["step"] for e in trainer.metrics.step_events()
                                           if e.get("skipped")]
                launches += fused_adamw.launches
            del setup, trainer
        g = runs["guarded"]
        if g["steps_skipped"] != 1 or g["step"] != GUARD_STEPS - 1:
            problems.append(f"{opt_name}: steps_skipped {g['steps_skipped']}, step {g['step']}")
        if g["checksum"] != runs["elided"]["checksum"]:
            problems.append(f"{opt_name}: the guarded state is not the elided run's")
        if g["host_syncs"] != runs["guard_off"]["host_syncs"] or g["host_syncs"] > 1:
            problems.append(f"{opt_name}: host syncs guarded {g['host_syncs']}, guard off "
                            f"{runs['guard_off']['host_syncs']}")
        if opt_name == "fused_adamw" and g["adamw_launches"] != GUARD_STEPS:
            problems.append(f"fused_adamw launched {g['adamw_launches']} times in "
                            f"{GUARD_STEPS} steps")
        arms[opt_name] = runs
    emit({"phase": "train_guardrails", "arm": "a_resnet18", "steps": GUARD_STEPS,
          "nan_batch_step": GUARD_NAN_BATCH, "cudnn": "deterministic, TF32 off",
          "comparison": "bit_checksum of every parameter, buffer, optimizer tensor and step",
          "arms": arms, "ok": not problems, "problems": problems, "gpu": gpu})
    if problems:
        raise AssertionError("; ".join(problems))
    return {"resnet_guarded_adamw_launches": launches}


def guard_760m(torch, gpu: str) -> dict:
    from pytorch_distributed_training_tutorials_tpu_torch.bench import lm_headline
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import _train_step_fn
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

    problems = []
    dev = torch.device("cuda")
    model, state, batch, off, n_params, _ = lm_headline.build(lm_headline.parse(["--fused"]), dev)
    on = _train_step_fn("fused_cross_entropy", skip_nonfinite=True)
    state, _ = off(state, batch)  # the moments and the count move off zero
    opt = state.opt_state
    live = [*state.params, *opt.mu, *opt.nu, opt.count, state.step]

    def snapshot():
        return [t.clone() for t in live]

    def restore(saved):
        with torch.no_grad():
            for t, v in zip(live, saved):
                t.copy_(v)

    start = snapshot()
    results = {}
    for name, fn in (("guard_off", off), ("guard_on", on)):
        restore(start)
        fused_adamw.launches = 0
        _, m = fn(state, batch)
        results[name] = {"loss": float(m["loss"]),
                         "checksum": bit_checksum(torch, live).tolist(),
                         "adamw_launches": fused_adamw.launches,
                         "skipped": int(m.get("skipped", 0))}
    if results["guard_on"]["checksum"] != results["guard_off"]["checksum"] or \
            results["guard_on"]["loss"] != results["guard_off"]["loss"]:
        problems.append(f"the clean guarded step differs from the guard-off step: {results}")
    poison = _train_step_fn("fused_cross_entropy", skip_nonfinite=True,
                            chaos=ChaosConfig(nan_grad_step=int(state.step)))
    kept = bit_checksum(torch, live).tolist()
    count = int(opt.count)
    fused_adamw.launches = 0
    _, m = poison(state, batch)
    poisoned = {"skipped": int(m["skipped"]), "loss": float(m["loss"]),
                "state_bits_unchanged": bit_checksum(torch, live).tolist() == kept,
                "count_before": count, "count_after": int(opt.count),
                "adamw_launches": fused_adamw.launches}
    if not (poisoned["skipped"] == 1 and poisoned["state_bits_unchanged"]
            and poisoned["count_after"] == count and poisoned["adamw_launches"] == 1):
        problems.append(f"the poisoned 760m step: {poisoned}")
    del start
    torch.cuda.empty_cache()

    # step ms, guard off and on in turns (off, on, on, off), CUDA events
    def timed(fn) -> float:
        nonlocal state
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        state, m = fn(state, batch)
        end.record()
        m["loss"].item()
        return begin.elapsed_time(end)

    timed(off)
    turns = {"guard_off": [], "guard_on": []}
    for _ in range(2):
        for name, fn in (("guard_off", off), ("guard_on", on), ("guard_on", on),
                         ("guard_off", off)):
            turns[name].append(timed(fn))
    step_ms = {k: statistics.median(v) for k, v in turns.items()}
    emit({"phase": "train_guardrails", "arm": "b_760m_fused", "n_params": n_params,
          "optimizer": "fused_adamw", "steps": results, "poisoned": poisoned,
          "step_ms": step_ms, "step_ms_samples": turns,
          "guard_cost_ms": step_ms["guard_on"] - step_ms["guard_off"],
          "comparison": "bit_checksum of p, m, v, the count and step",
          "ok": not problems, "problems": problems, "gpu": gpu})
    del model, state, batch, live, opt
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return {"guard_760m_step_ms": step_ms, "guard_760m_adamw_launches":
            results["guard_on"]["adamw_launches"] + poisoned["adamw_launches"]}


def guard_rollback(torch, gpu: str, dataset) -> int:
    from pytorch_distributed_training_tutorials_tpu_torch.bench import headline
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

    setup = headline.make_headline_setup(
        RESNET_BATCH, quiet=True, dataset=dataset,
        rollback_spike_factor=10.0, rollback_patience=2, chaos=ChaosConfig(**ROLLBACK_SPIKE))
    trainer = setup.trainer
    ckpt = os.path.join(REPO, "build", "rollback_ckpt")
    trainer.train(1)  # monitor steps 1-4 seed the EMA
    trainer.save(ckpt)
    trainer.train(3)  # the spike at monitor steps 6-8: strikes at 6 and 7
    losses = [e["loss"] for e in trainer.metrics.epoch_events()]
    problems = []
    if trainer.rollbacks != 1 or trainer.epoch != 3 or not all(map(math.isfinite, losses)):
        problems.append(f"rollbacks {trainer.rollbacks}, epoch {trainer.epoch}, "
                        f"epoch losses {losses}")
    emit({"phase": "train_guardrails", "arm": "c_rollback", "steps_per_epoch": ROLLBACK_STEPS,
          "spike": ROLLBACK_SPIKE, "rollbacks": trainer.rollbacks, "epoch": trainer.epoch,
          "step": int(trainer.state.step), "epoch_losses": losses,
          "host_syncs": trainer.host_syncs, "ok": not problems, "problems": problems,
          "gpu": gpu})
    if problems:
        raise AssertionError("; ".join(problems))
    return trainer.rollbacks


def phase_bench_and_scaling(torch, gpu: str) -> dict:
    """The bench twin (``python -m ...bench``, in this process): one JSON
    line, a receipt that validates, stamped with this card; the scaling
    sweep at every power-of-two width up to the card count (NCCL worlds
    through spawn); ``launch_overhead_fit`` over eager op chains."""
    import io

    from pytorch_distributed_training_tutorials_tpu_torch.bench import scaling
    from pytorch_distributed_training_tutorials_tpu_torch.bench.__main__ import main as bench
    from pytorch_distributed_training_tutorials_tpu_torch.obs import (
        MinOfN,
        launch_overhead_fit,
        validate_receipt,
    )

    problems = []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench(["--quiet"])
    lines = out.getvalue().splitlines()
    r = json.loads(lines[-1]) if lines else {}
    if len(lines) != 1:
        problems.append(f"the bench printed {len(lines)} lines on stdout, want 1")
    problems += [f"receipt: {p}" for p in validate_receipt(r, "bench_headline")]
    env = r.get("env", {})
    if env.get("nvidia_smi") != gpu or env.get("device_name") != torch.cuda.get_device_name(0):
        problems.append(f"receipt stamp {env} is not this card ({gpu})")
    if r.get("vs_baseline") is not None or not r.get("value", 0) > 0:
        problems.append(f"bench value {r.get('value')}, vs_baseline {r.get('vs_baseline')}")
    if not r.get("eval_accuracy", 0) > RESNET_ACC_FLOOR:
        problems.append(f"bench eval accuracy {r.get('eval_accuracy')} <= {RESNET_ACC_FLOOR}")
    if not all(v > 0 for k, v in r.get("breakdown", {}).items() if k.endswith("per_gpu")):
        problems.append(f"bench breakdown {r.get('breakdown')}")
    emit({"phase": "bench_and_scaling", "arm": "bench", "line": r, "gpu": gpu})

    points = scaling.sweep()
    rep = scaling.report(points)
    widths = [p.num_chips for p in points]
    if widths != [1 << i for i in range(len(widths))] or widths[-1] * 2 <= torch.cuda.device_count():
        problems.append(f"sweep widths {widths} for {torch.cuda.device_count()} cards")
    emit({"phase": "bench_and_scaling", "arm": "scaling", "report": rep,
          "collectives": scaling.collective_footprint(scaling._model(64)), "gpu": gpu})

    x = torch.zeros(16, device="cuda")

    def time_chain(n: int) -> float:
        def run():
            for _ in range(n):
                x.add_(1.0)
            torch.cuda.synchronize()
        return MinOfN(n=5).measure(run).best_s

    fit = launch_overhead_fit(time_chain, LAUNCH_FIT_LENS)
    emit({"phase": "bench_and_scaling", "arm": "launch_overhead_fit",
          "op": "x.add_(1.0) on 16 floats, eager; chain closed by torch.cuda.synchronize()",
          **fit.to_dict(), "gpu": gpu})
    if not fit.per_op_us > 0:
        problems.append(f"launch fit {fit.to_dict()}")
    emit({"phase": "bench_and_scaling", "ok": not problems, "problems": problems, "gpu": gpu})
    if problems:
        raise AssertionError("; ".join(problems))
    return {"bench_images_per_sec_per_gpu": r["value"], "per_launch_us": fit.per_op_us}


# the multi-tenant LoRA slice: the adapter bank of examples/serve_llm_int8.py
# (--adapters 4 --lora-rank 8: tenants 1-3 drawn N(0, 0.02^2) from
# PCG64(13), row 0 the base model), phase 4's stream with ids i % 4
LORA_BANK = dict(n_adapters=4, rank=8)
LORA_FACTOR_STD = 0.02
# a tenant's teacher-forced logits must differ from the base model's by
# more than this share of the logit scale (the planted fault that ignores
# the ids reads 0)
LORA_TF_MIN_SHARE = 0.01
# the composed arm: the paged kernel, the prefix cache and speculation over
# the 1b preset's window (512 = 8 pages of 64); 128 pages (16.8 MB each at
# f32) hold the 4 slots and every prompt's segment, and the 4 GiB budget
# every segment, so nothing is evicted and a host replay of the index
# predicts every splice
LORA_COMPOSED = dict(paged=True, page_size=64, pool_pages=128, prefix_cache_bytes=4 << 30,
                     speculative_k=2)
# train_lora: phase 5's model (2 layers at the 760m widths, S 256, bf16,
# flash) with a bank of 4 rows of rank 8, fine-tuned on row 1
LORA_TRAIN = dict(steps=5, lr=5e-2, weight_decay=0.01, batch=2, tenant=1)
# the served tenant against the merge_adapter'ed model, both in float32
# (the same parameters): the merge reassociates x @ W + (x @ A) @ B into
# x @ (W + A B), a float32 rounding of each merged weight, ~1e-6 of the
# logits; in bfloat16 each side rounds to 2^-8 of a value and a logit of
# 4.5 has an ulp of 2^-5, so the bf16 pair is reported, not gated
LORA_MERGE_F32_SHARE = 1e-4
# flash launches per 760m train step under each remat policy: "dots"
# recomputes the flash forward in the backward, "dots_attn" keeps its
# outputs (O and lse)
FLASH_PER_STEP_BY_POLICY = {"dots": FLASH_PER_STEP, "dots_attn": {"fwd": 24, "dq": 24, "dkv": 24}}


def lora_rows(bank, rng, std: float = LORA_FACTOR_STD) -> dict:
    """One synthetic tenant: every factor of ``bank.row_zeros()`` drawn
    N(0, std^2) from ``rng`` on the host (the bank uploads it pinned)."""
    import numpy as np
    import torch

    return {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * std).astype(np.float32))
            for k, v in bank.row_zeros().items()}


def lora_stream(torch, quant, fa, engine, reqs) -> dict:
    """Serve ``reqs`` ((prompt, seed, adapter) tuples) through ``engine``
    under sync debug mode; the kernel counts of exactly this stream and
    its host-side numbers."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request

    base = (engine.n_prefills, engine.n_splices, engine.n_chains, engine.n_host_syncs)
    quant.int8_matmul.launches = 0
    quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
    fwd0 = dict(fa.flash_attention.routes["fwd"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with real_syncs(torch) as real:
        rids = [engine.submit(Request(prompt=p, max_new_tokens=32, seed=s, adapter=a))
                for p, s, a in reqs]
        done = {c.request_id: c for c in engine.run_until_idle()}
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    comps = [done[r] for r in rids]
    toks = sum(len(c.tokens) for c in comps)
    lat = [c.latency_s for c in comps]
    return {
        "tokens": [c.tokens for c in comps], "reasons": [c.finish_reason for c in comps],
        "prefills": engine.n_prefills - base[0], "splices": engine.n_splices - base[1],
        "chains": engine.n_chains - base[2], "host_syncs": engine.n_host_syncs - base[3],
        "stream_syncs": real["count"], "stream_sync_sites": real["sites"],
        "int8_launches": quant.int8_matmul.launches, "int8_routes": dict(quant.int8_matmul.routes),
        "flash_fwd_routes": {k: v - fwd0[k] for k, v in fa.flash_attention.routes["fwd"].items()},
        "wall_s": wall_s, "aggregate_tok_s": toks / wall_s,
        "latency_p50_s": percentile(lat, 0.5), "latency_p95_s": percentile(lat, 0.95),
    }


@contextlib.contextmanager
def ids_ignored():
    """The planted fault of the LoRA gates: every forward's adapter ids
    become 0 (the base row), whatever the caller passed."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import transformer as mod

    real = mod._adapter_ids

    def faulty(adapter_ids, batch, device):
        return real(None, batch, device)

    mod._adapter_ids = faulty
    try:
        yield
    finally:
        mod._adapter_ids = real


def lora_tf_gate(torch, lora_eng, base_eng, prompt, tokens, aid: int) -> dict:
    """Tenant ``aid``'s teacher-forced logits on its own stream's tokens
    against the base model's: the largest difference as a share of the
    base logits' scale, held above LORA_TF_MIN_SHARE; id 0 on the same
    tokens bitwise the bank-less engine's."""
    ref = base_eng.teacher_forced_logits(prompt, tokens)
    got = lora_eng.teacher_forced_logits(prompt, tokens, adapter=aid)
    zero = lora_eng.teacher_forced_logits(prompt, tokens, adapter=0)
    share = float((got - ref).abs().max()) / float(ref.abs().max())
    return {"adapter": aid, "diff_share": share, "min_share": LORA_TF_MIN_SHARE,
            "id0_bitwise_base": bool(torch.equal(zero, ref)),
            "ok": share > LORA_TF_MIN_SHARE and bool(torch.equal(zero, ref))}


def replay_namespaced(prompts: list, ids: list, vocab: int, n_adapters: int, gens: dict,
                      namespaced: bool = True) -> dict:
    """A host replay of the prefix index over a stream admitted in order:
    each prompt looked up and then inserted under its tenant's key
    (``ServeEngine._prefix_key``: shifted by ``(generation * N + aid) *
    vocab``), or under the raw prompt when not ``namespaced``. Splices and
    reused tokens; the byte budget holds every segment."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve.prefix import PrefixIndex

    index = PrefixIndex(1 << 60)
    hits = tokens = 0
    for p, a in zip(prompts, ids):
        shift = (gens[a] * n_adapters + a) * vocab if (namespaced and a) else 0
        key = [t + shift for t in p]
        hit = index.lookup(key, 1)
        if hit is not None:
            hits += 1
            tokens += hit[0]
        if tuple(key) not in index:
            index.insert(key, None, 1)
    return {"splices": hits, "hit_tokens": tokens}


def phase_serve_lora(torch, quant, fa, pa, gpu: str) -> dict:
    """``serve_1b_lora``: the 1b preset (int8 weights, f32 compute, flash
    prefill) at full width, SERVE_LAYERS deep, serving phase 4's stream (12
    requests, prompts {16, 32, 48}, 32 new tokens, 4 slots) with ids i % 4
    through ``ServeEngine(adapter_bank=AdapterBank(n_adapters=4,
    rank=8))``, and the bank-less engine in turns (base, bank, bank,
    base). Gates: every request complete; each tenant's tokens those of a
    dedicated single-tenant engine; id 0's the bank-less engine's; each
    tenant's teacher-forced logits off the base model's by more than
    LORA_TF_MIN_SHARE of the logit scale, and the planted fault that
    ignores the ids failing that gate; host syncs equal the bank-less
    stream's, stream syncs within them; 113 int8 calls a forward, all
    sm90; a request queued behind an ``evict`` completes as
    ``"adapter_evicted"`` with no launch; a ``register`` into a live
    engine served at the next step. Then the composed arm
    (``phase_serve_lora_composed``)."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.adapters import AdapterBank
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    cfg = TransformerConfig(**{**PRESET_1B, "n_layers": SERVE_LAYERS}, quantized=True,
                            attention_fn=fa.flash_attention)
    params = init_quantized_lm(cfg, seed=0, device="cuda")
    bank = AdapterBank(TransformerLM(cfg), device="cuda", **LORA_BANK)
    frng = np.random.Generator(np.random.PCG64(13))
    for aid in range(1, LORA_BANK["n_adapters"]):
        bank.register(f"tenant-{aid}", lora_rows(bank, frng))
    n_ad = LORA_BANK["n_adapters"]

    def engine(with_bank: bool, **kw):
        return ServeEngine(TransformerLM(cfg), params, n_slots=4, tokens_per_launch=8,
                           device="cuda", adapter_bank=bank if with_bank else None, **kw)

    lengths = (16, 32, 48)
    rng = np.random.Generator(np.random.PCG64(11))
    reqs = [(rng.integers(0, cfg.vocab_size, (lengths[i % 3],)).tolist(), i, i % n_ad)
            for i in range(12)]
    base_reqs = [(p, s, 0) for p, s, _ in reqs]
    engines = {"base": engine(False), "bank": engine(True)}
    for eng in engines.values():  # warmup: first launches, cuBLAS handles
        eng.submit(Request(prompt=reqs[0][0], max_new_tokens=4))
        eng.run_until_idle()
    runs = {"base": [], "bank": []}
    for arm in ("base", "bank", "bank", "base"):
        runs[arm].append(lora_stream(torch, quant, fa, engines[arm],
                                     reqs if arm == "bank" else base_reqs))
    problems = []
    per_forward = cfg.n_layers * 7 + 1
    for arm, rs in runs.items():
        for r in rs:
            if r["reasons"] != ["length"] * 12:
                problems.append(f"{arm}: finish reasons {r['reasons']}")
            forwards = r["prefills"] + r["chains"] * 8
            if r["int8_launches"] != per_forward * forwards:
                problems.append(f"{arm}: {r['int8_launches']} int8 calls != "
                                f"{per_forward} x {forwards} forwards")
            if r["int8_routes"] != {"sm90": r["int8_launches"], "v1": 0}:
                problems.append(f"{arm}: int8 routes {r['int8_routes']}")
            if r["host_syncs"] != r["chains"] + r["prefills"]:
                problems.append(f"{arm}: {r['host_syncs']} host syncs != chains + prefills")
            if r["stream_syncs"] > r["host_syncs"]:
                problems.append(f"{arm}: {r['stream_syncs']} stream syncs > "
                                f"{r['host_syncs']}: {r['stream_sync_sites']}")
            if r["flash_fwd_routes"] != {"sm90": 0, "sm80": cfg.n_layers * 12}:
                problems.append(f"{arm}: flash forward routes {r['flash_fwd_routes']}")
    mixed, plain = runs["bank"][0]["tokens"], runs["base"][0]["tokens"]
    if any(r["tokens"] != mixed for r in runs["bank"]) or any(
            r["tokens"] != plain for r in runs["base"]):
        problems.append("a stream's tokens changed between turns")
    if [runs["bank"][0]["host_syncs"]] * 2 != [r["host_syncs"] for r in runs["base"]]:
        problems.append("host syncs with the bank differ from the bank-less stream's")
    dedicated = {}
    for aid in range(n_ad):
        idx = [i for i, r in enumerate(reqs) if r[2] == aid]
        got = lora_stream(torch, quant, fa, engine(True), [reqs[i] for i in idx])["tokens"]
        dedicated[aid] = got == [mixed[i] for i in idx]
        if not dedicated[aid]:
            problems.append(f"adapter {aid}: the mixed stream's tokens differ from a "
                            "dedicated engine's")
    id0_equal = all(mixed[i] == plain[i] for i, r in enumerate(reqs) if r[2] == 0)
    if not id0_equal:
        problems.append("id 0 through the bank differs from the bank-less engine")
    tenants_differ = sum(mixed[i] != plain[i] for i, r in enumerate(reqs) if r[2])
    lora_eng, base_eng = engines["bank"], engines["base"]
    tf = []
    for aid in range(1, n_ad):
        i = next(i for i, r in enumerate(reqs) if r[2] == aid)
        tf.append(lora_tf_gate(torch, lora_eng, base_eng, reqs[i][0], mixed[i][:16], aid))
    with ids_ignored():
        i = next(i for i, r in enumerate(reqs) if r[2] == 1)
        fault = lora_tf_gate(torch, lora_eng, base_eng, reqs[i][0], mixed[i][:16], 1)
    fault["kind"] = "ids_ignored"
    if not all(g["ok"] for g in tf):
        problems.append(f"teacher-forced tenant gate failed: {tf}")
    if fault["ok"]:
        problems.append(f"the planted fault (ids ignored) passed the gate: {fault}")
    # an evict behind a queued request: completed with no device work
    c0 = (quant.int8_matmul.launches, dict(fa.flash_attention.launches))
    rid = lora_eng.submit(Request(prompt=reqs[3][0], max_new_tokens=8, adapter=3))
    bank.evict("tenant-3")
    bounced = lora_eng.step()
    evict_ok = ([(c.request_id, c.finish_reason, c.tokens) for c in bounced]
                == [(rid, "adapter_evicted", [])] and lora_eng.idle
                and (quant.int8_matmul.launches, dict(fa.flash_attention.launches)) == c0)
    if not evict_ok:
        problems.append(f"queued request behind an evict: {bounced}")
    # a register into a live engine: served at the next step, as a fresh
    # engine with the same bank serves it
    busy = [lora_eng.submit(Request(prompt=reqs[i][0], max_new_tokens=32, adapter=1))
            for i in (0, 1)]
    lora_eng.step()
    live_before = lora_eng.active_slots
    new_aid = bank.register("tenant-3b", lora_rows(bank, frng))
    late = lora_eng.submit(Request(prompt=reqs[7][0], max_new_tokens=16, adapter=new_aid))
    done = {c.request_id: c.tokens for c in lora_eng.run_until_idle()}
    fresh = engine(True)
    ref = fresh.submit(Request(prompt=reqs[7][0], max_new_tokens=16, adapter=new_aid))
    ref_tokens = {c.request_id: c.tokens for c in fresh.run_until_idle()}[ref]
    register_ok = (live_before == 2 and done[late] == ref_tokens and new_aid == 3
                   and bank.generation(3) == 2 and all(b in done for b in busy))
    if not register_ok:
        problems.append(f"register into a live engine: {done.get(late)} != {ref_tokens}")
    mean = lambda arm, k: statistics.mean(r[k] for r in runs[arm])  # noqa: E731
    emit({
        "phase": "serve_1b_lora", "preset": "1b", "layers": cfg.n_layers,
        "bank": {**LORA_BANK, "factor_std": LORA_FACTOR_STD, **bank.stats()},
        "requests": 12, "ids": [r[2] for r in reqs],
        "turns": ["base", "bank", "bank", "base"],
        "aggregate_tok_s": {a: [r["aggregate_tok_s"] for r in rs] for a, rs in runs.items()},
        "latency_p50_s": {a: [r["latency_p50_s"] for r in rs] for a, rs in runs.items()},
        "latency_p95_s": {a: [r["latency_p95_s"] for r in rs] for a, rs in runs.items()},
        "tok_s_ratio_bank_over_base": mean("bank", "aggregate_tok_s") / mean("base",
                                                                           "aggregate_tok_s"),
        "host_syncs": {a: [r["host_syncs"] for r in rs] for a, rs in runs.items()},
        "stream_syncs": {a: [r["stream_syncs"] for r in rs] for a, rs in runs.items()},
        "int8_launches": runs["bank"][0]["int8_launches"],
        "int8_routes": runs["bank"][0]["int8_routes"],
        "dedicated_equal": dedicated, "id0_equal_base": id0_equal,
        "tenant_requests_differing_from_base": tenants_differ,
        "teacher_forced": tf, "planted_fault": fault,
        "evicted_while_queued_ok": evict_ok, "register_live_ok": register_ok,
        "adapter_stats": lora_eng.adapter_stats(),
        "ok": not problems, "problems": problems, "gpu": gpu,
    })
    if problems:
        raise AssertionError("; ".join(problems))
    composed = phase_serve_lora_composed(torch, quant, fa, pa, gpu, cfg, params, bank)
    return {"launches": runs["bank"][0]["int8_launches"] * 2 + composed["int8"],
            "serve_1b_lora": 2 * runs["bank"][0]["int8_launches"], **composed}


def phase_serve_lora_composed(torch, quant, fa, pa, gpu: str, cfg, params, bank) -> dict:
    """The composed arm of ``serve_1b_lora``: the same model and bank
    through ``paged=True, paged_kernel=True``, the prefix cache and
    ``speculative_k=2`` on serve_1b_prefill's overlapping prompts (12,
    {128, 256, 384}, three quarters shared) with ids i % 4, and the same
    arm on the gather. Gates: every request complete; splices (and reused
    tokens) equal a host replay of the namespaced index, fewer than the
    un-namespaced replay's; every request whose tokens differ from the
    gather arm's held teacher-forced on its own tokens (verify-shaped
    forwards of k+1 rows, ``tf_compare`` against the gather engine, and
    ``greedy_held`` under its own engine's logits: the paged kernel's f32
    sums flip near-ties against the float64 gather, ROADMAP section C);
    paged launches all sm90, flash forwards all on the f32 route (16 a
    whole prefill); host syncs chains + refills; no page in use after the
    drain."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerLM
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    prompts = prefill_prompts(cfg.vocab_size, 12)
    n_ad = LORA_BANK["n_adapters"]
    ids = [i % n_ad for i in range(12)]
    gens = {a: bank.generation(a) for a in range(n_ad)}
    reqs = [(p, i, a) for i, (p, a) in enumerate(zip(prompts, ids))]
    out, engines, problems = {}, {}, []
    for arm, kernel in (("kernel", True), ("gather", False)):
        eng = ServeEngine(TransformerLM(cfg), params, n_slots=4, tokens_per_launch=8,
                          device="cuda", adapter_bank=bank, paged_kernel=kernel,
                          **LORA_COMPOSED)
        pa.paged_attention.launches = 0
        pa.paged_attention.routes = {"sm90": 0, "v1": 0}
        fwd0 = dict(fa.flash_attention.launches)
        r = lora_stream(torch, quant, fa, eng, reqs)
        r["paged_launches"] = pa.paged_attention.launches
        r["paged_routes"] = dict(pa.paged_attention.routes)
        r["flash_fwd"] = fa.flash_attention.launches["fwd"] - fwd0["fwd"]
        r["refills"] = dict(eng.refills)
        r["prefix_hit_tokens"] = eng.prefix_hit_tokens
        r["spec_stats"] = eng.spec_stats()
        r["adapter_stats"] = eng.adapter_stats()
        r["prefix_stats"] = eng.prefix_stats()
        out[arm], engines[arm] = r, eng
    k = out["kernel"]
    differ = [i for i, (a, b) in enumerate(zip(k["tokens"], out["gather"]["tokens"])) if a != b]
    held = []
    rows = LORA_COMPOSED["speculative_k"] + 1
    for i in differ:
        own = engines["kernel"].teacher_forced_logits(prompts[i], k["tokens"][i], rows=rows,
                                                      adapter=ids[i])
        ref = engines["gather"].teacher_forced_logits(prompts[i], k["tokens"][i], rows=rows,
                                                      adapter=ids[i])
        rec = {"request": i, "adapter": ids[i], **tf_compare(ref, own),
               "greedy_held": greedy_held(own, k["tokens"][i])}
        rec["ok"] = rec["ok"] and rec["greedy_held"]["ok"]
        held.append(rec)
        if not rec["ok"]:
            problems.append(f"request {i}: kernel arm outside the teacher-forced bound: {rec}")
    for arm, eng in engines.items():
        while eng.prefix.evict_coldest():
            pass
        out[arm]["pages_in_use_after"] = eng.page_stats()["pages_in_use"]
    replay = replay_namespaced(prompts, ids, cfg.vocab_size, n_ad, gens)
    flat = replay_namespaced(prompts, ids, cfg.vocab_size, n_ad, gens, namespaced=False)
    if k["reasons"] != ["length"] * 12:
        problems.append(f"finish reasons {k['reasons']}")
    for arm, r in out.items():
        if (r["splices"], r["prefix_hit_tokens"]) != (replay["splices"], replay["hit_tokens"]):
            problems.append(f"{arm}: splices {r['splices']} / hit tokens "
                            f"{r['prefix_hit_tokens']} != the namespaced replay's {replay}")
        if r["host_syncs"] != r["chains"] + sum(r["refills"].values()):
            problems.append(f"{arm}: host syncs {r['host_syncs']} != chains + refills")
        if r["stream_syncs"] > r["host_syncs"]:
            problems.append(f"{arm}: {r['stream_syncs']} stream syncs > {r['host_syncs']}")
        if r["flash_fwd"] != cfg.n_layers * r["refills"]["prefill"] or \
                r["flash_fwd_routes"]["sm90"]:
            problems.append(f"{arm}: flash forwards {r['flash_fwd']} / "
                            f"{r['flash_fwd_routes']} for {r['refills']['prefill']} prefills")
        if r["int8_routes"]["v1"]:
            problems.append(f"{arm}: int8 routes {r['int8_routes']}")
        if r["prefix_stats"]["prefix_evicted_bytes"]:
            problems.append(f"{arm}: segments evicted {r['prefix_stats']}")
        if r["pages_in_use_after"]:
            problems.append(f"{arm}: {r['pages_in_use_after']} pages in use after the drain")
    if not replay["splices"] or replay["splices"] >= flat["splices"]:
        problems.append(f"namespaced replay {replay} vs un-namespaced {flat}: "
                        "the stream does not show the namespaces")
    if k["paged_launches"] == 0 or k["paged_routes"] != {"sm90": k["paged_launches"], "v1": 0}:
        problems.append(f"paged kernel launches {k['paged_launches']}, routes {k['paged_routes']}")
    emit({
        "phase": "serve_1b_lora_composed", "preset": "1b", "ids": ids,
        "geometry": {k_: v for k_, v in LORA_COMPOSED.items()},
        "replay_namespaced": replay, "replay_unnamespaced": flat,
        **{arm: {k_: v for k_, v in r.items() if k_ != "tokens"} for arm, r in out.items()},
        "requests_tokens_differ_from_gather": differ, "teacher_forced_held": held,
        "ok": not problems, "problems": problems, "gpu": gpu,
    })
    if problems:
        raise AssertionError("; ".join(problems))
    return {"int8": k["int8_launches"], "composed_paged": k["paged_launches"],
            "composed_paged_routes": k["paged_routes"], "composed_flash_fwd": k["flash_fwd"],
            "composed_verify_forwards": k["spec_stats"]["n_verify_forwards"]}


def phase_train_lora(torch, gpu: str) -> dict:
    """``train_lora``: phase 5's model (2 layers at the 760m widths, S 256,
    bf16, flash) as a LoRA model (4 rows of rank 8), fine-tuned on row 1
    by ``Trainer(loss="fused_cross_entropy", model_kwargs={"adapter_ids":
    1})`` with ``fused_adamw(5e-2, weight_decay=0.01,
    mask=lora_param_mask)`` for 5 steps. Gates: a falling loss; every base
    parameter bitwise unchanged; one AdamW launch a step over the factor
    elements only; the factors within the plain AdamW's run of the same
    steps on the card; flash and fused-loss launches all sm90. Kernel 9 at
    the factor leaves timed against its 28 B/element bound. Then the
    trained row through ``extract_adapter`` -> ``AdapterBank.register`` ->
    a bank engine of the base model: its teacher-forced logits within
    LORA_MERGE_F32_SHARE of the ``merge_adapter``ed model's, both served
    in float32, the same argmax at every step; the bf16 pair reported."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.adapters import (
        AdapterBank,
        extract_adapter,
        lora_init,
        lora_param_mask,
        merge_adapter,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.data.datasets import ArrayDataset
    from pytorch_distributed_training_tutorials_tpu_torch.data.loader import ShardedLoader
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_loss import (
        fused_cross_entropy,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import LocalMesh
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine
    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import AdamW
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import Trainer

    lt = LORA_TRAIN
    seq, tid = 256, lt["tenant"]
    base_cfg = TransformerConfig(**{**PRESET_760M, "n_layers": 2}, max_seq_len=seq,
                                 dtype=torch.bfloat16, attention_fn=make_flash_attention(1024, 1024),
                                 quantized=False)
    cfg = dataclasses.replace(base_cfg, lora_adapters=LORA_BANK["n_adapters"],
                              lora_rank=LORA_BANK["rank"])
    rng = np.random.Generator(np.random.PCG64(6))
    toks = rng.integers(0, PRESET_760M["vocab_size"], (lt["batch"], seq + 1))
    mesh = LocalMesh(torch.device("cuda"))

    def run(tx):
        loader = ShardedLoader(ArrayDataset((toks[:, :-1], toks[:, 1:])), lt["batch"], mesh,
                               shuffle=False)
        trainer = Trainer(TransformerLM(cfg), loader, tx, loss="fused_cross_entropy",
                          model_kwargs={"adapter_ids": tid}, seed=5, quiet=True)
        named = dict(trainer.model.named_parameters())
        init = lora_init(named, seed=2)
        with torch.no_grad():
            for name, p in named.items():
                if name.endswith(".lora_a"):
                    p.copy_(init[name])
        start = {n: p.detach().clone() for n, p in named.items() if not p.requires_grad}
        trainer.train(lt["steps"])
        torch.cuda.synchronize()
        return trainer, start

    for counts in (flash_attention.launches, *flash_attention.routes.values(),
                   fused_cross_entropy.launches, *fused_cross_entropy.routes.values()):
        for key in counts:
            counts[key] = 0
    fused_adamw.launches = 0
    kw = dict(weight_decay=lt["weight_decay"], mask=lora_param_mask)
    trainer, start = run(fused_adamw(lt["lr"], **kw))
    adamw_launches = fused_adamw.launches
    flash = {k: dict(v) for k, v in flash_attention.routes.items()}
    loss_routes = {k: dict(v) for k, v in fused_cross_entropy.routes.items()}
    plain, _ = run(AdamW(lr=lt["lr"], **kw))
    problems = []
    losses = [e["loss"] for e in trainer.metrics.step_events()]
    if not losses[-1] < losses[0]:
        problems.append(f"loss did not fall: {losses}")
    named = dict(trainer.model.named_parameters())
    base_bitwise = all(torch.equal(named[n], t) for n, t in start.items())
    if not base_bitwise or any(named[n].requires_grad for n in start):
        problems.append("a base parameter moved or trains")
    factors = {n: p for n, p in named.items() if p.requires_grad}
    n_elems = sum(p.numel() for p in factors.values())
    plain_named = dict(plain.model.named_parameters())
    diffs = {n: float((p.detach() - plain_named[n].detach()).abs().max())
             for n, p in factors.items()}
    scale = max(float(p.detach().abs().max()) for p in factors.values())
    if max(diffs.values()) > 1e-6 * scale:
        problems.append(f"factors differ from the plain AdamW run by {max(diffs.values())}")
    steps = lt["steps"]
    if adamw_launches != steps:
        problems.append(f"{adamw_launches} fused AdamW launches in {steps} steps")
    want_flash = {k: {"sm90": 2 * steps, "sm80": 0} for k in ("fwd", "dq", "dkv")}
    if flash != want_flash:
        problems.append(f"flash routes {flash} != {want_flash}")
    if loss_routes != {k: {"sm90": steps, "sm80": 0} for k in ("fwd", "dh", "dw")}:
        problems.append(f"fused-loss routes {loss_routes}")
    # kernel 9 at the factor leaves: one launch over the trainable leaves
    tx, state = trainer.state.tx, trainer.state.opt_state
    grads = [torch.randn_like(p) * 1e-3 for p in factors.values()]
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    leaves = list(factors.values())
    with torch.no_grad():
        saved = [p.clone() for p in leaves]
        ms = time_ms(lambda: tx.update_(leaves, grads, state), torch, flush)
        plain_ms = time_ms(lambda: AdamW.update_(tx, leaves, grads, state), torch, flush)
        for p, s in zip(leaves, saved):
            p.copy_(s)
    bound_ms = 28 * n_elems / HBM_BYTES_PER_S * 1e3
    # extract -> register -> serve, against the merged model
    trained = {n: p.detach() for n, p in named.items()}
    row = extract_adapter(trained, tid)
    prompt, follow = toks[0, :64].tolist(), toks[0, 64:80].tolist()
    served = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        scfg = dataclasses.replace(base_cfg, dtype=dtype)
        bank = AdapterBank(TransformerLM(scfg), device="cuda", **LORA_BANK)
        aid = bank.register("tuned", row)
        eng = ServeEngine(TransformerLM(scfg), merge_adapter(trained, 0), n_slots=1,
                          tokens_per_launch=8, device="cuda", adapter_bank=bank)
        merged = ServeEngine(TransformerLM(scfg), merge_adapter(trained, tid), n_slots=1,
                             tokens_per_launch=8, device="cuda")
        got = eng.teacher_forced_logits(prompt, follow, adapter=aid)
        ref = merged.teacher_forced_logits(prompt, follow)
        base_logits = eng.teacher_forced_logits(prompt, follow, adapter=0)
        scale = float(ref.abs().max())
        served[name] = {
            "adapter": aid, "max_abs_logit_diff": float((got - ref).abs().max()),
            "logit_max_abs": scale,
            "diff_share": float((got - ref).abs().max()) / scale,
            "argmax_agree_steps": int((got.argmax(-1) == ref.argmax(-1)).sum()),
            "steps": len(follow),
            "tenant_vs_base_share": float((ref - base_logits).abs().max()) / scale}
    f32 = served["float32"]
    merge_ok = (f32["adapter"] == tid and f32["diff_share"] <= LORA_MERGE_F32_SHARE
                and f32["argmax_agree_steps"] == f32["steps"])
    if not merge_ok:
        problems.append(f"served tenant vs the merged model (float32): {f32}")
    emit({
        "phase": "train_lora", "model": "760m widths, 2 layers, S 256, bf16, flash",
        "bank": LORA_BANK, **lt, "losses": losses, "base_bitwise_unchanged": base_bitwise,
        "trainable_leaves": len(factors), "trainable_elements": n_elems,
        "factor_max_abs_diff_vs_plain_adamw": max(diffs.values()),
        "factors_bitwise_plain_adamw": max(diffs.values()) == 0.0,
        "fused_adamw_launches": adamw_launches, "flash_routes": flash,
        "fused_loss_routes": loss_routes,
        "adamw_factor_leaves": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": "bytes", "bytes_per_element": 28},
        "served_vs_merged": served, "served_vs_merged_bound_f32": LORA_MERGE_F32_SHARE,
        "ok": not problems, "problems": problems, "gpu": gpu,
    })
    if problems:
        raise AssertionError("; ".join(problems))
    return {"fused_adamw": adamw_launches, "adamw_ms": ms, "adamw_plain_ms": plain_ms,
            "adamw_bound_ms": bound_ms, "elements": n_elems, "flash_fwd": flash["fwd"]["sm90"]}


def phase_train_dots_attn(torch, gpu: str) -> dict:
    """``train_760m`` arm ``dots_attn``: (a) one loss-and-gradient pass of
    the bench's 760m model and batch under remat "dots" and "dots_attn" in
    turns (dots, dots_attn, dots_attn, dots): the loss and every gradient
    bitwise equal, device ms and peak memory of each; (b) the bench's
    default arm with ``--remat_policy dots_attn`` (6-step chains, 2
    timed): finite falling loss, its first loss bitwise (a)'s, exactly 24
    / 24 / 24 flash forward / dq / dk-dv launches a step, all sm90."""
    from pytorch_distributed_training_tutorials_tpu_torch.bench import lm_headline
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import _make_loss_fn

    args = lm_headline.parse([])
    model, _, batch, _, _, _ = lm_headline.build(args, torch.device("cuda"))
    loss_fn = _make_loss_fn("cross_entropy")
    params = [p for p in model.parameters()]
    ref, turns = {}, []
    for policy in ("dots", "dots_attn", "dots_attn", "dots"):
        model.cfg = dataclasses.replace(model.cfg, remat_policy=policy)
        for key in flash_attention.launches:
            flash_attention.launches[key] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        end.record()
        end.synchronize()
        turns.append({"policy": policy, "ms": start.elapsed_time(end),
                      "peak_bytes": torch.cuda.max_memory_allocated() - base_mem,
                      "flash": dict(flash_attention.launches)})
        if policy not in ref:
            ref[policy] = (loss.detach(), grads)
        else:
            del grads
        del loss
    l_d, g_d = ref["dots"]
    l_a, g_a = ref["dots_attn"]
    same = bool(torch.equal(l_d, l_a)) and all(torch.equal(a, b) for a, b in zip(g_d, g_a))
    first_loss = float(l_d)
    del ref, g_d, g_a, model, params
    torch.cuda.empty_cache()
    problems = []
    if not same:
        problems.append("dots_attn's loss or gradients differ from dots'")
    for t in turns:
        want = {"fwd": 24 if t["policy"] == "dots_attn" else 48, "dq": 24, "dkv": 24}
        if t["flash"] != want:
            problems.append(f"{t['policy']}: flash launches {t['flash']} != {want}")
    argv = ["--steps", "6", "--reps", "2", "--remat_policy", "dots_attn"]
    for counts in (flash_attention.launches, *flash_attention.routes.values()):
        for key in counts:
            counts[key] = 0
    r = lm_headline.measure(lm_headline.parse(argv))
    launches = dict(flash_attention.launches)
    routes = {k: dict(c) for k, c in flash_attention.routes.items()}
    steps = r["steps_run"]
    losses = r["losses_first_chain"]
    want = {k: n * steps for k, n in FLASH_PER_STEP_BY_POLICY["dots_attn"].items()}
    if launches != want:
        problems.append(f"flash launches {launches} != {want} ({steps} steps)")
    if routes != {k: {"sm90": n, "sm80": 0} for k, n in launches.items()}:
        problems.append(f"flash routes {routes}: not all sm90")
    if not r["all_losses_finite"] or not losses[-1] < losses[0]:
        problems.append(f"losses {losses}")
    if losses[0] != first_loss:
        problems.append(f"first loss {losses[0]} != the dots pass's {first_loss}")
    mean = lambda p, k: statistics.mean(t[k] for t in turns if t["policy"] == p)  # noqa: E731
    emit({
        "phase": "train_760m", "arm": "dots_attn", "argv": argv,
        "grad_pass_turns": turns, "loss_and_grads_bitwise_dots": same,
        "grad_pass_ms": {p: mean(p, "ms") for p in ("dots", "dots_attn")},
        "grad_pass_peak_bytes": {p: mean(p, "peak_bytes") for p in ("dots", "dots_attn")},
        "peak_bytes_dots_attn_minus_dots": mean("dots_attn", "peak_bytes")
        - mean("dots", "peak_bytes"),
        "flash_launches": launches, "flash_routes": routes,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        **{k: r[k] for k in (
            "preset", "n_layers", "d_model", "seq", "batch", "attn", "remat_policy",
            "n_params", "steps_run", "losses_first_chain", "step_ms", "chain_ms_samples",
            "tokens_per_s", "mfu", "peak_memory_bytes", "init_s")},
        "ok": not problems, "problems": problems, "gpu": gpu,
    })
    if problems:
        raise AssertionError("; ".join(problems))
    return {"flash": launches, "flash_routes": routes, "step_ms": r["step_ms"]}


# model parallelism, the 03 lesson at the reference's shapes (SURVEY
# C15/C17): ResNet-50 with the imagenet stem and 1000 classes, a batch of
# 120 random 128x128 images with one-hot(1000) random labels, MSE, SGD at
# 1e-3, a train() of 3 batches; the data is drawn on the card in bulk
# from a seed (the reference draws each batch on the host)
PIPE = dict(batch=120, px=128, classes=1000, batches=3, lr=1e-3, repeats=10)
PIPE_M = (1, 2, 4)
RESNET50_PARAMS = 25_557_032
# the split against the unsplit model from the same weights, both float32
# with TF32 off and cuDNN in its deterministic algorithms (``deterministic``;
# with its default algorithms three steps left the parameters 1.4e-5 of
# their largest entry apart on an H100 while the losses stayed bitwise):
# the same convolutions on the same shapes, so losses within
# 1e-5 relative, parameters and BatchNorm statistics within 1e-5 of their
# largest entry, the eval-mode forward within 1e-5 of its largest logit
PIPE_TOL = 1e-5
# resnet18_fsdp: the config of the JAX package's examples/train_resnet_mnist.py
# --fsdp (ResNet-18, cifar stem, bf16 on f32 parameters, SGD 0.05 momentum
# 0.9, MNIST's uint8 surrogate resident on the card) at the
# resnet18-mnist-ddp cell's 512 images a device, one epoch of the first
# FSDP_ROWS images a world size; FSDP at its default min_size (1024)
FSDP_ROWS = 4096
# the gloo world of 2 against DataParallel's: both ranks' steps under
# deterministic cuDNN, the same bf16 arithmetic, the gradients summed by an
# all_reduce (DataParallel, in 25 MB buckets) or by the staged route's
# per-leaf all_reduce: losses within 1e-3 relative, parameters within 1e-3
# of their largest entry after the epoch (bitwise reported beside)
FSDP_TOL = 1e-3
# the strategies' gloo worlds on one card: their times are correctness
# runs, not the strategies' speed
STRATEGY_NOTE = ("gloo on one card: every collective staged through host memory; the "
                 "phase's times are not the strategy's speed")
# lm_hybrid_fsdp: the 760m widths at 2 layers (bench/lm_headline.py's
# model: bf16, flash, remat "dots", seq 2048, its batch of 2), cross
# entropy, fused AdamW, 2 steps, on {"data": 2, "model": 2}
HYBRID_CFG = dict(PRESET_760M, n_layers=2, max_seq_len=2048, remat=True, remat_policy="dots")
HYBRID_MESH = {"data": 2, "model": 2}
HYBRID_STEPS = 2
# every leaf's placement in flax's dimension order: the JAX package's
# HybridFSDP(mesh, TP_RULES) spec for the same path at this config
# (tests/test_torch_hybrid_fsdp.py holds this table against the JAX
# strategy)
HYBRID_SPECS = {
    "tok_emb.weight": ((32768, 1536), ("data", None)),
    **{f"blocks.{i}.{name}": spec for i in range(2) for name, spec in {
        "attn_norm.scale": ((1536,), ("data",)),
        "attn.q_proj.weight": ((1536, 16, 96), ("data", "model", None)),
        "attn.k_proj.weight": ((1536, 16, 96), ("data", "model", None)),
        "attn.v_proj.weight": ((1536, 16, 96), ("data", "model", None)),
        "attn.o_proj.weight": ((16, 96, 1536), ("model", None, "data")),
        "mlp_norm.scale": ((1536,), ("data",)),
        "mlp.gate_proj.weight": ((1536, 6144), ("data", "model")),
        "mlp.up_proj.weight": ((1536, 6144), ("data", "model")),
        "mlp.down_proj.weight": ((6144, 1536), ("model", "data")),
    }.items()},
    "final_norm.scale": ((1536,), ("data",)),
    "lm_head.weight": ((1536, 32768), ("data", "model")),
}
HYBRID_LEAVES = ("tok_emb.weight", "blocks.0.attn_norm.scale", "blocks.0.attn.q_proj.weight",
                 "blocks.0.attn.o_proj.weight", "blocks.1.mlp.gate_proj.weight",
                 "blocks.1.mlp.down_proj.weight", "final_norm.scale", "lm_head.weight")
# per rank and step at 2 layers under remat "dots": the flash forward
# twice a layer (the recompute), dq and dk/dv once
HYBRID_FLASH = {"fwd": 4, "dq": 2, "dkv": 2}


def pipe_batches(torch, n: int, seed: int = 0) -> list:
    """``n`` batches of the lesson's shapes on the card, NHWC images."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        x = torch.randn((PIPE["batch"], PIPE["px"], PIPE["px"], 3), generator=gen, device="cuda")
        labels = torch.randint(0, PIPE["classes"], (PIPE["batch"],), generator=gen, device="cuda")
        out.append((x, torch.nn.functional.one_hot(labels, PIPE["classes"]).float()))
    return out


def resnet50_from(torch, weights: dict):
    """A ResNet-50 on ``weights`` (a state dict on the card, copied)."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import resnet50

    model = resnet50(num_classes=PIPE["classes"], stem="imagenet")
    model.load_state_dict({k: v.clone() for k, v in weights.items()}, assign=True)
    return model


def max_rel(torch, got: list, want: list) -> float:
    """The largest difference of paired tensors over the largest entry of
    the reference (or 1)."""
    return max(float((a.detach().double() - b.detach().double()).abs().max()
                     / b.detach().double().abs().max().clamp_min(1.0)) for a, b in zip(got, want))


def kernels_in(torch, fn) -> int:
    """CUDA kernels ``fn`` launches, from one profiled call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_train_resnet50_pipeline(torch, gpu: str) -> dict:
    """``train_resnet50_pipeline``: SURVEY C15/C17. The split ResNet-50
    (``ManualPipeline`` on ``["cuda:0", "cuda:0"]``) and the unsplit one
    (the ``Trainer``'s step) from the same weights, in turns. Gates: the
    stage counts sum to 25,557,032; three steps' losses, then every
    parameter and BatchNorm statistic, within PIPE_TOL of the unsplit
    model's; ``forward`` in eval mode (the unsplit eval logits, the
    statistics untouched); the hop to the device a tensor is on is no copy;
    a fused-AdamW pipeline launches kernel 9 once a stage a step. Then ms
    per ``train()`` of 3 batches, mean and std over 10 repeats each (C17's
    ``timeit.repeat``), peak memory and kernels a step of both."""
    from pytorch_distributed_training_tutorials_tpu_torch.models.convert import init_params
    from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import resnet50
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import ManualPipeline
    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import sgd
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import (
        TrainState,
        batch_stats,
        make_train_step,
    )

    weights = init_params(resnet50(num_classes=PIPE["classes"]), 0, "cuda")
    batches = pipe_batches(torch, PIPE["batches"])
    devices = ["cuda:0", "cuda:0"]
    split = resnet50_from(torch, weights)
    pipe = ManualPipeline(split, devices, loss="mse", optimizer=sgd(PIPE["lr"]))
    unsplit = resnet50_from(torch, weights)
    state = TrainState.create(model=unsplit, tx=sgd(PIPE["lr"]))
    step = make_train_step("mse", has_batch_stats=True)
    problems = []
    counts = pipe.stage_param_counts()
    if sum(counts) != RESNET50_PARAMS:
        problems.append(f"stage counts {counts} sum to {sum(counts)}, not {RESNET50_PARAMS}")
    hop = batches[0][0]
    no_copy = hop.to(torch.device("cuda:0")) is hop

    def train(which):
        """The reference's train(): the 3 batches, one step each; the
        losses (device tensors)."""
        nonlocal state
        out = []
        for x, y in batches:
            if which == "split":
                out.append(pipe.train_step(x, y))
            else:
                state, metrics = step(state, (x, y))
                out.append(metrics["loss"])
        return out

    with deterministic(torch):  # the gated steps: cuDNN's algorithms fixed
        losses = {w: [float(v) for v in train(w)] for w in ("split", "unsplit")}
        stats_before = bit_checksum(torch, batch_stats(split))
        with torch.no_grad():
            eval_pipe = pipe.forward(batches[0][0])
            eval_unsplit = unsplit(batches[0][0], train=False)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses["split"], losses["unsplit"]))
    param_gap = max_rel(torch, list(split.parameters()), list(unsplit.parameters()))
    stats_gap = max_rel(torch, batch_stats(split), batch_stats(unsplit))
    eval_gap = max_rel(torch, [eval_pipe], [eval_unsplit])
    eval_kept = bool(torch.equal(stats_before, bit_checksum(torch, batch_stats(split))))
    if loss_gap > PIPE_TOL or param_gap > PIPE_TOL or stats_gap > PIPE_TOL:
        problems.append(f"split vs unsplit: losses {loss_gap}, parameters {param_gap}, "
                        f"statistics {stats_gap} (tolerance {PIPE_TOL})")
    if eval_gap > PIPE_TOL or not eval_kept:
        problems.append(f"forward not in eval mode: {eval_gap} off the unsplit eval logits, "
                        f"statistics kept {eval_kept}")
    if not no_copy:
        problems.append("x.to(its own device) copied")
    if not all(math.isfinite(v) for v in losses["split"]):
        problems.append(f"losses {losses['split']}")
    # kernel 9 on the pipeline: each stage its own fused AdamW state
    adam_pipe = ManualPipeline(resnet50_from(torch, weights), devices, loss="mse",
                               optimizer=fused_adamw(PIPE["lr"]))
    fused_adamw.launches = 0
    adam_loss = float(adam_pipe.train_step(*batches[0]))
    adamw_launches = fused_adamw.launches
    if adamw_launches != adam_pipe.num_stages or not math.isfinite(adam_loss):
        problems.append(f"fused AdamW pipeline: {adamw_launches} launches in one step of "
                        f"{adam_pipe.num_stages} stages, loss {adam_loss}")
    del adam_pipe
    if problems:
        raise AssertionError("; ".join(problems))
    # C17: train() timed in turns, ten repeats each
    times = {"split": [], "unsplit": []}
    for _ in range(PIPE["repeats"]):
        for which in ("split", "unsplit"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train(which)
            torch.cuda.synchronize()
            times[which].append((time.perf_counter() - t0) * 1e3)
    peak = {}
    for which in ("split", "unsplit"):
        torch.cuda.reset_peak_memory_stats()
        train(which)
        torch.cuda.synchronize()
        peak[which] = torch.cuda.max_memory_allocated()
    kernels = {"split": kernels_in(torch, lambda: pipe.train_step(*batches[0])),
               "unsplit": kernels_in(torch, lambda: step(state, batches[0]))}
    ms = {w: statistics.mean(t) for w, t in times.items()}
    row = {
        "phase": "train_resnet50_pipeline", "model": "resnet50 imagenet stem, 1000 classes",
        "batch": PIPE["batch"], "image_px": PIPE["px"], "loss": "mse on one-hot(1000)",
        "optimizer": f"sgd({PIPE['lr']})", "batches_per_train": PIPE["batches"],
        "devices": devices, "stage_param_counts": counts, "placement": pipe.placement_audit(),
        "losses_split": losses["split"], "losses_unsplit": losses["unsplit"],
        "loss_max_rel_gap": loss_gap, "param_max_rel_gap": param_gap,
        "batch_stats_max_rel_gap": stats_gap, "eval_logits_max_rel_gap": eval_gap,
        "eval_mode_stats_unchanged": eval_kept, "tolerance": PIPE_TOL,
        "hop_to_same_device_is_no_copy": no_copy,
        "adamw_launches_one_step": adamw_launches,
        "train_ms_mean": ms, "train_ms_std": {w: statistics.stdev(t) for w, t in times.items()},
        "train_ms_repeats": times, "split_over_unsplit": ms["split"] / ms["unsplit"],
        "peak_memory_bytes": peak, "kernels_per_step": kernels,
        "note": "both stages on cuda:0: the hop is no copy, so the split's cost is its "
                "overhead only; the real hop needs two cards",
        "ok": True, "gpu": gpu,
    }
    emit(row)
    del pipe, split, unsplit, state, weights, batches
    torch.cuda.empty_cache()
    return {"adamw_launches": adamw_launches}


def accum_reference(torch, model, xs: list, ys: list, lr: float) -> None:
    """The GPipe comparator (the JAX ``tests/test_gpipe.py:50-86``): plain
    gradient accumulation on one device over the same microbatches, each
    from the step's starting BatchNorm statistics, their new statistics
    and the gradients averaged, one SGD update; in place."""
    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import sgd
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import batch_stats

    params = list(model.parameters())
    stats = batch_stats(model)
    start = [s.clone() for s in stats]
    g_acc = [torch.zeros_like(p) for p in params]
    s_acc = [torch.zeros_like(s) for s in stats]
    for x, y in zip(xs, ys):
        with torch.no_grad():
            for s, s0 in zip(stats, start):
                s.copy_(s0)
        loss = torch.mean((model(x, train=True) - y) ** 2)
        torch._foreach_add_(g_acc, torch.autograd.grad(loss, params))
        with torch.no_grad():
            torch._foreach_add_(s_acc, stats)
    inv = 1.0 / len(xs)
    with torch.no_grad():
        for s, a in zip(stats, s_acc):
            s.copy_(a * inv)
    torch._foreach_mul_(g_acc, inv)
    tx = sgd(lr)
    tx.update_(params, g_acc, tx.init(params))


def phase_train_resnet50_gpipe(torch, gpu: str) -> dict:
    """``train_resnet50_gpipe``: the lesson's model and batch through
    ``GPipe`` on ``create_mesh({"data": 1, "stage": 2}, stage_devices=
    ["cuda:0", "cuda:0"])`` at m in PIPE_M microbatches. Gates: one step's
    parameters and BatchNorm statistics within PIPE_TOL of the
    single-device gradient-accumulation step over the same microbatches
    (``accum_reference``); n*m stage forwards, n*m stage backwards and n
    applies. Then ms a step (mean of 5) and kernels a microbatch for each
    m."""
    from pytorch_distributed_training_tutorials_tpu_torch.models.convert import init_params
    from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import resnet50
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import GPipe, create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import sgd
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import batch_stats

    weights = init_params(resnet50(num_classes=PIPE["classes"]), 1, "cuda")
    (x, y), = pipe_batches(torch, 1, seed=1)
    mesh = create_mesh({"data": 1, "stage": 2}, stage_devices=["cuda:0", "cuda:0"])
    rows, problems = {}, []
    for m in PIPE_M:
        model = resnet50_from(torch, weights)
        pipe = GPipe(model, mesh, num_microbatches=m, loss="mse", optimizer=sgd(PIPE["lr"]))
        calls = {"forward": 0, "backward": 0, "apply": 0}

        def counted(fn, key):
            def inner(*a, **kw):
                calls[key] += 1
                return fn(*a, **kw)
            return inner

        pipe._stage_forward = counted(pipe._stage_forward, "forward")
        pipe._stage_backward = counted(pipe._stage_backward, "backward")
        pipe._apply_stage = counted(pipe._apply_stage, "apply")
        ref = resnet50_from(torch, weights)
        mb = PIPE["batch"] // m
        with deterministic(torch):
            loss = float(pipe.train_step(x, y))
            accum_reference(torch, ref, [x[k * mb:(k + 1) * mb] for k in range(m)],
                            [y[k * mb:(k + 1) * mb] for k in range(m)], PIPE["lr"])
        gated = dict(calls)  # the gated step's; the timed steps below count on
        n = pipe.num_stages
        param_gap = max_rel(torch, list(model.parameters()), list(ref.parameters()))
        stats_gap = max_rel(torch, batch_stats(model), batch_stats(ref))
        want_calls = {"forward": n * m, "backward": n * m, "apply": n}
        if gated != want_calls:
            problems.append(f"m={m}: calls {gated}, want {want_calls}")
        if param_gap > PIPE_TOL or stats_gap > PIPE_TOL or not math.isfinite(loss):
            problems.append(f"m={m}: off the accumulation step: parameters {param_gap}, "
                            f"statistics {stats_gap}, loss {loss}")
        del ref
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.train_step(x, y)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        kernels = kernels_in(torch, lambda: pipe.train_step(x, y))
        rows[m] = {"loss": loss, "calls": gated, "param_max_rel_gap": param_gap,
                   "batch_stats_max_rel_gap": stats_gap, "step_ms_mean": statistics.mean(times[1:]),
                   "step_ms": times[1:], "kernels_per_step": kernels,
                   "kernels_per_microbatch": kernels / m}
        del pipe, model
        torch.cuda.empty_cache()
    emit({"phase": "train_resnet50_gpipe", "model": "resnet50 imagenet stem, 1000 classes",
          "batch": PIPE["batch"], "image_px": PIPE["px"], "mesh": {"data": 1, "stage": 2},
          "stage_devices": ["cuda:0", "cuda:0"], "by_microbatches": rows,
          "tolerance": PIPE_TOL, "ok": not problems, "problems": problems, "gpu": gpu})
    if problems:
        raise AssertionError("; ".join(problems))
    return rows


def fsdp_dataset(rows: int):
    """The first ``rows`` images of the MNIST train surrogate (uint8)."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, mnist

    full = mnist("train", raw=True)
    return ArrayDataset(tuple(a[:rows] for a in full.arrays))


def fsdp_arm(torch, strategy, optimizer=None) -> dict:
    """One epoch of the headline workload (``bench.headline``) over
    FSDP_ROWS images a rank under ``strategy`` (None: DataParallel),
    deterministic cuDNN: the losses, the state's bit sums and bytes, the
    parameters as the model sees them, the collectives and the fused-AdamW
    launches and elements."""
    import torch.distributed as dist

    from pytorch_distributed_training_tutorials_tpu_torch.bench import headline
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.fsdp import param_names
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import batch_stats

    world = dist.get_world_size() if dist.is_initialized() else 1
    kw = {} if strategy is None else {"strategy": strategy}
    with deterministic(torch):
        setup = headline.make_headline_setup(RESNET_BATCH, quiet=True, optimizer=optimizer,
                                             dataset=fsdp_dataset(FSDP_ROWS * world), **kw)
        trainer = setup.trainer
        if strategy is not None:
            strategy.reset_collectives()
        fused_adamw.launches = 0
        t0 = time.perf_counter()
        trainer.train(1)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
    state, model = trainer.state, trainer.model
    opt = state.opt_state
    moments = ([*opt.mu, *opt.nu] if hasattr(opt, "mu") else list(opt.trace or []))
    names = param_names(model)
    out = {
        "losses": [e["loss"] for e in trainer.metrics.step_events()], "epoch_s": epoch_s,
        "steps": len(trainer.metrics.step_events()),
        "param_bytes": sum(p.numel() * p.element_size() for p in state.params),
        "moment_bytes": sum(m.numel() * m.element_size() for m in moments),
        "param_elements": sum(p.numel() for p in state.params),
        "bits": bit_checksum(torch, [*state.params, *batch_stats(model)]).tolist(),
        "collectives": dict(getattr(strategy, "collectives", {})),
        "fused_adamw": fused_adamw.launches,
    }
    with torch.no_grad():  # as the model sees them (an FSDP leaf: its gather)
        whole = {}
        for n in names:
            prefix, _, leaf = n.rpartition(".")
            whole[n] = getattr(model.get_submodule(prefix), leaf).detach().float().cpu()
    out["whole"] = whole
    if strategy is not None and strategy.plan:
        out["replicated"] = sorted(n for n, p in strategy.plan.items() if p.dim is None)
        out["sharded"] = sum(p.dim is not None for p in strategy.plan.values())
        out["route"] = strategy.route
    out["state"], out["tx"] = state, state.tx
    return out


def adamw_at_shards(torch, state) -> dict:
    """Kernel 9 at the leaves FSDP hands it (this rank's shards and the
    replicated leaves): one update of ``fused_adamw`` against the plain
    AdamW on copies of the state and the same random gradients, bitwise;
    then both timed beside the bound (28 bytes an element) and
    ``torch._fused_adamw_``."""
    import dataclasses

    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw

    tx = state.tx
    params = [p.detach().clone() for p in state.params]
    gen = torch.Generator(device="cuda").manual_seed(7)
    grads = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3 for p in params]
    opt = state.opt_state

    def copy():
        return dataclasses.replace(opt, mu=[m.clone() for m in opt.mu],
                                   nu=[v.clone() for v in opt.nu], count=opt.count.clone())

    s_k, s_p = copy(), copy()
    p_k, p_p = params, [p.clone() for p in params]
    tx.update_(p_k, grads, s_k)
    plain = adamw(tx.lr, tx.b1, tx.b2, tx.eps, tx.weight_decay)
    plain.update_(p_p, grads, s_p)
    torch.cuda.synchronize()
    got, want = p_k + s_k.mu + s_k.nu, p_p + s_p.mu + s_p.nu
    differ = sum(int((a != b).sum()) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: tx.update_(p_k, grads, s_k), torch, flush, warmup=1)
    plain_ms = time_ms(lambda: plain.update_(p_p, grads, s_p), torch, flush, warmup=1)
    steps = [torch.tensor(10.0, device="cuda") for _ in p_k]
    lib_ms = time_ms(lambda: torch._fused_adamw_(
        p_k, grads, s_k.mu, s_k.nu, [], steps, lr=tx.lr, beta1=tx.b1, beta2=tx.b2,
        weight_decay=tx.weight_decay, eps=tx.eps, amsgrad=False, maximize=False),
        torch, flush, warmup=1)
    n_el = sum(p.numel() for p in p_k)
    return {"leaves": len(p_k), "elements": n_el, "elements_differ": differ, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": 28.0 * n_el / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def fsdp_rank(world_tp) -> dict:
    """One rank of the gloo world of 2 on card 0 (spawned): the headline
    workload under DataParallel, FSDP, and FSDP with fused AdamW, one
    epoch each; kernel 9 at this rank's shards."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import FSDP, create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh(device="cuda")
    out = {"rank": world_tp.rank}
    for arm, make in (("dp", lambda: (None, None)),
                      ("fsdp", lambda: (FSDP(mesh), None)),
                      ("fsdp_adamw", lambda: (FSDP(mesh), fused_adamw(1e-3)))):
        strategy, opt = make()
        run = fsdp_arm(torch, strategy, opt)
        state = run.pop("state")
        run.pop("tx")
        if arm == "fsdp_adamw":
            out["adamw_shards"] = adamw_at_shards(torch, state)
        out[arm] = run
        del state
        torch.cuda.empty_cache()
    return out


def phase_train_resnet18_fsdp(torch, gpu: str) -> dict:
    """``train_resnet18_fsdp``: ``Trainer(strategy=FSDP(mesh))`` on the
    config of the JAX package's ``examples/train_resnet_mnist.py --fsdp``
    (see FSDP_ROWS). In an NCCL world of one, the FSDP epoch bitwise the
    DataParallel epoch with no collective. In a gloo world of 2 on card 0
    (NCCL refuses two ranks on one device): the ranks' losses equal, the
    FSDP losses and parameters within FSDP_TOL of DataParallel's, a rank's
    parameter and moment bytes about half DataParallel's (the leaves
    ``min_size`` keeps replicated listed), kernel 9 once a step over the
    rank's shards and bitwise its plain version there, the collectives by
    kind (the staged route: gloo on CUDA tensors)."""
    from pytorch_distributed_training_tutorials_tpu_torch.launch import pick_unused_port
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        FSDP,
        create_mesh,
        distributed,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        spawn_tp,
    )

    problems = []
    distributed.init(f"127.0.0.1:{pick_unused_port()}", num_processes=1, process_id=0)
    try:
        one_dp = fsdp_arm(torch, None)
        one_fsdp = fsdp_arm(torch, FSDP(create_mesh()))
    finally:
        distributed.shutdown()
    for run in (one_dp, one_fsdp):
        run.pop("state"), run.pop("tx")
    world_one = {"losses_bitwise": one_fsdp["losses"] == one_dp["losses"],
                 "state_bitwise": one_fsdp["bits"] == one_dp["bits"],
                 "collectives": one_fsdp["collectives"], "steps": one_fsdp["steps"]}
    if not (world_one["losses_bitwise"] and world_one["state_bitwise"]) or world_one[
            "collectives"]:
        problems.append(f"NCCL world of one: FSDP not DataParallel's bits, or collectives: "
                        f"{world_one}")
    t0 = time.perf_counter()
    ranks = spawn_tp(fsdp_rank, 2, (), backend="gloo", device="cuda", join_timeout_s=900)
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    dp, fs, fa = r0["dp"], r0["fsdp"], r0["fsdp_adamw"]
    for arm in ("dp", "fsdp", "fsdp_adamw"):
        if ranks[1][arm]["losses"] != ranks[0][arm]["losses"]:
            problems.append(f"{arm}: the ranks' losses differ")
        if not all(map(math.isfinite, ranks[0][arm]["losses"])):
            problems.append(f"{arm}: a loss is not finite")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(fs["losses"], dp["losses"]))
    param_gap = max(float((fs["whole"][n] - dp["whole"][n]).abs().max()
                          / dp["whole"][n].abs().max().clamp_min(1.0)) for n in dp["whole"])
    if loss_gap > FSDP_TOL or param_gap > FSDP_TOL:
        problems.append(f"FSDP vs DataParallel (gloo, 2): losses {loss_gap}, parameters "
                        f"{param_gap} (tolerance {FSDP_TOL})")
    ratio = {"params": fs["param_bytes"] / dp["param_bytes"],
             "sgd_trace": fs["moment_bytes"] / dp["moment_bytes"]}
    if not all(0.5 <= v <= 0.51 for v in ratio.values()):
        problems.append(f"a rank's bytes against DataParallel's: {ratio}")
    steps = fa["steps"]
    sh = r0["adamw_shards"]
    if fa["fused_adamw"] != steps or sh["elements"] != fa["param_elements"] or sh[
            "elements_differ"]:
        problems.append(f"kernel 9: {fa['fused_adamw']} launches in {steps} steps, "
                        f"{sh['elements']} elements vs {fa['param_elements']} held, "
                        f"{sh['elements_differ']} differ from the plain AdamW")
    per_step = {k: v / fs["steps"] for k, v in fs["collectives"].items()}
    gather, scatter = fs["route"]
    if per_step.get(gather) != fs["sharded"] or per_step.get(scatter) != fs["sharded"]:
        problems.append(f"collectives a step {per_step}, want {fs['sharded']} of each of "
                        f"{fs['route']}")
    row = {
        "phase": "train_resnet18_fsdp",
        "config": "examples/train_resnet_mnist.py --fsdp: resnet18 cifar stem bf16, "
                  f"sgd(0.05, momentum=0.9), MNIST surrogate, {RESNET_BATCH} a device",
        "rows_per_rank": FSDP_ROWS, "nccl_world_of_one": world_one,
        "gloo_world": 2, "route": fs["route"], "steps": fs["steps"],
        "losses": {"dp": dp["losses"], "fsdp": fs["losses"], "fsdp_adamw": fa["losses"]},
        "loss_max_rel_gap": loss_gap, "param_max_rel_gap": param_gap,
        "bitwise_dp": {"losses": fs["losses"] == dp["losses"],
                       "parameters": all(torch.equal(fs["whole"][n], dp["whole"][n])
                                         for n in dp["whole"])},
        "tolerance": FSDP_TOL, "bytes_per_rank": {
            "dp": {"params": dp["param_bytes"], "sgd_trace": dp["moment_bytes"]},
            "fsdp": {"params": fs["param_bytes"], "sgd_trace": fs["moment_bytes"]},
            "fsdp_adamw": {"params": fa["param_bytes"], "adamw_moments": fa["moment_bytes"]}},
        "bytes_ratio_fsdp_over_dp": ratio, "replicated_leaves": fs["replicated"],
        "sharded_leaves": fs["sharded"], "collectives_per_step": per_step,
        "fused_adamw": {"launches": fa["fused_adamw"], "steps": steps, **sh},
        "epoch_s": {arm: [r[arm]["epoch_s"] for r in ranks] for arm in ("dp", "fsdp",
                                                                          "fsdp_adamw")},
        "ranks_s": ranks_s, "timing_note": STRATEGY_NOTE,
        "ok": not problems, "problems": problems, "gpu": gpu,
    }
    emit(row)
    if problems:
        raise AssertionError("; ".join(problems))
    return {"adamw_launches": fa["fused_adamw"], "adamw_shards": sh}


def hybrid_run(torch, strategy) -> dict:
    """HYBRID_STEPS steps of HYBRID_CFG through the ``Trainer`` — under
    ``strategy`` (a HybridFSDP) this rank's shards, with None the single
    device — one step an epoch on bench/lm_headline.py's batch: losses,
    the first step's first moments of HYBRID_LEAVES (the rank's stored
    shards), the launches and routes, peak memory, step ms."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.fsdp import param_names
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer

    cfg = TransformerConfig(**HYBRID_CFG, dtype=torch.bfloat16,
                            attention_fn=make_flash_attention(1024, 1024))
    x, y = tp_train_batch()
    mesh = strategy.mesh if strategy is not None else create_mesh(device="cuda")
    loader = ShardedLoader(ArrayDataset((x, y)), TP_TRAIN_BATCH, mesh, batch_mode="global",
                           shuffle=False)
    trainer = Trainer(TransformerLM(cfg), loader, fused_adamw(3e-4, weight_decay=0.01),
                      strategy=strategy, loss="cross_entropy", seed=0, quiet=True)
    names = param_names(trainer.model)
    for counts in (flash_attention.launches, *flash_attention.routes.values()):
        for k in counts:
            counts[k] = 0
    fused_adamw.launches = 0
    if strategy is not None:
        strategy.reset_collectives()
        strategy.tp.reset_collectives()
    torch.cuda.reset_peak_memory_stats()
    step_ms, mu = [], {}
    for e in range(1, HYBRID_STEPS + 1):
        t = time.perf_counter()
        trainer.train(e)
        step_ms.append((time.perf_counter() - t) * 1e3)
        if e == 1:
            mus = trainer.state.opt_state.mu
            mu = {n: mus[names.index(n)].detach().cpu() for n in HYBRID_LEAVES}
    out = {"losses": [ev["loss"] for ev in trainer.metrics.step_events()], "mu": mu,
           "step_ms": step_ms, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "flash": dict(flash_attention.launches),
           "flash_routes": {k: dict(c) for k, c in flash_attention.routes.items()},
           "fused_adamw": fused_adamw.launches,
           "stored_elements": sum(p.numel() for p in trainer.state.params),
           "stored_shapes": {n: tuple(p.shape) for n, p in zip(names,
                                                               trainer.model.parameters())}}
    if strategy is not None:
        out["plan"] = {n: (p.flax_shape, p.spec, p.dim) for n, p in strategy.plan.items()}
        out["collectives"] = dict(strategy.collectives)
        out["tp_collectives"] = dict(strategy.tp.collectives)
        out["route"] = strategy.route
        out["rank"], out["data_rank"] = strategy.tp.rank, strategy.tp.data_rank
    del trainer
    torch.cuda.empty_cache()
    return out


def hybrid_rank(world_tp) -> dict:
    """One rank of train_lm_hybrid_fsdp (spawned): HybridFSDP over the
    {"data": 2, "model": 2} mesh of the world, TP_RULES."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import TP_RULES
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import HybridFSDP, create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return hybrid_run(torch, HybridFSDP(create_mesh(HYBRID_MESH, device="cuda"), TP_RULES))


def hybrid_expected(torch, name: str, plan: tuple, model_rank: int, data_rank: int, whole):
    """The stored shard a rank must hold of ``whole`` (a tensor of the
    single device's, e.g. its first moment): its model rank's TP block,
    then its data rank's block of the FSDP dimension."""
    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import TP_RULES
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        shard_tensor,
        split_dim,
    )

    tp, dp = HYBRID_MESH["model"], HYBRID_MESH["data"]
    head_dim = PRESET_760M["d_model"] // PRESET_760M["n_heads"]
    local = shard_tensor(whole, split_dim(name, tuple(whole.shape), TP_RULES, tp,
                                          {"head": head_dim}), model_rank, tp)
    return shard_tensor(local, plan[2], data_rank, dp)


def phase_train_lm_hybrid_fsdp(torch, gpu: str) -> dict:
    """``train_lm_hybrid_fsdp``: ``Trainer(strategy=HybridFSDP(mesh,
    TP_RULES))`` on a gloo world of 4 on card 0 (``{"data": 2, "model":
    2}``) at HYBRID_CFG, beside the single-device ``Trainer`` from the same
    seed (the JAX DP x TP pin is xfail, so the single-device step is the
    oracle, as for train_760m_tp2). Gates: every leaf's flax shape and spec
    those of HYBRID_SPECS (the JAX HybridFSDP's), its stored shard the
    model rank's TP block's data-rank block; every rank's losses the same
    floats and finite; the first step's loss within TP_TRAIN_LOSS_TOL and
    each of HYBRID_LEAVES' first moments within TP_TRAIN_GRAD_TOL of the
    single-device step's matching block; a step's 4 / 2 / 2 flash and 1
    AdamW launches per rank, all flash on the sm90 route; one reduce-scatter
    a sharded leaf a step. Correctness only: gloo stages every collective
    through host memory."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        spawn_tp,
    )

    ref = hybrid_run(torch, None)
    whole = dict(TransformerLM(TransformerConfig(**HYBRID_CFG)).named_parameters())  # meta
    t0 = time.perf_counter()
    ranks = spawn_tp(hybrid_rank, 4, (), backend="gloo", device="cuda", join_timeout_s=900)
    ranks_s = time.perf_counter() - t0
    problems, gaps = [], []
    want_flash = {k: v * HYBRID_STEPS for k, v in HYBRID_FLASH.items()}
    for r in (ref, *ranks):
        who = "single device" if r is ref else f"rank {r['rank']}/{r['data_rank']}"
        if not all(map(math.isfinite, r["losses"])):
            problems.append(f"{who}: losses {r['losses']}")
        if r["flash"] != want_flash or r["fused_adamw"] != HYBRID_STEPS:
            problems.append(f"{who}: flash {r['flash']}, AdamW {r['fused_adamw']}")
        if any(c["sm80"] for c in r["flash_routes"].values()):
            problems.append(f"{who}: a flash launch left the sm90 route: {r['flash_routes']}")
    for r in ranks:
        who = f"rank (model {r['rank']}, data {r['data_rank']})"
        if r["losses"] != ranks[0]["losses"]:
            problems.append(f"{who}: losses {r['losses']} != rank 0's")
        bad = [n for n, (shape, spec) in HYBRID_SPECS.items()
               if tuple(r["plan"][n][:2]) != (shape, spec)]
        if bad or set(r["plan"]) != set(HYBRID_SPECS):
            problems.append(f"{who}: placements off the JAX HybridFSDP spec: {bad}")
        wrong = [n for n, t in whole.items() if r["stored_shapes"][n] != tuple(
            hybrid_expected(torch, n, r["plan"][n], r["rank"], r["data_rank"],
                            torch.empty(t.shape, device="meta")).shape)]
        if wrong:
            problems.append(f"{who}: stored shards of the wrong shape: {wrong}")
        g = {"loss": abs(r["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
             "mu": {n: rel_err(torch, r["mu"][n], hybrid_expected(
                 torch, n, r["plan"][n], r["rank"], r["data_rank"], ref["mu"][n]))
                    for n in HYBRID_LEAVES}}
        gaps.append(g)
        if g["loss"] > TP_TRAIN_LOSS_TOL or max(g["mu"].values()) > TP_TRAIN_GRAD_TOL:
            problems.append(f"{who}: first step off the single-device one: {g}")
        sharded = sum(p[2] is not None for p in r["plan"].values())
        scatter = r["collectives"].get(r["route"][1], 0)
        if scatter != sharded * HYBRID_STEPS:
            problems.append(f"{who}: {scatter} reduce-scatters in {HYBRID_STEPS} steps of "
                            f"{sharded} sharded leaves")
    r0 = ranks[0]
    row = {
        "phase": "train_lm_hybrid_fsdp", "mesh": HYBRID_MESH, "backend": "gloo", "ranks": 4,
        "config": {**HYBRID_CFG, "dtype": "bf16", "attention": "flash", "batch": TP_TRAIN_BATCH,
                   "loss": "cross_entropy", "optimizer": "fused_adamw(3e-4, weight_decay=0.01)"},
        "steps": HYBRID_STEPS, "losses_single": ref["losses"],
        "losses_per_rank": [r["losses"] for r in ranks], "first_step_gaps": gaps,
        "tolerance": {"loss": TP_TRAIN_LOSS_TOL, "first_moment": TP_TRAIN_GRAD_TOL},
        "placements_checked": len(HYBRID_SPECS), "route": r0["route"],
        "collectives_per_step_rank0": {k: v / HYBRID_STEPS for k, v in r0["collectives"].items()},
        "tp_collectives_per_step_rank0": {k: v / HYBRID_STEPS
                                          for k, v in r0["tp_collectives"].items()},
        "stored_elements": {"single": ref["stored_elements"],
                            "per_rank": [r["stored_elements"] for r in ranks]},
        "launches_per_rank": [{"flash": r["flash"], "fused_adamw": r["fused_adamw"]}
                              for r in ranks],
        "step_ms_single": ref["step_ms"], "step_ms_per_rank": [r["step_ms"] for r in ranks],
        "peak_memory_bytes_single": ref["peak_memory_bytes"],
        "peak_memory_bytes_per_rank": [r["peak_memory_bytes"] for r in ranks],
        "ranks_s": ranks_s, "timing_note": STRATEGY_NOTE,
        "ok": not problems, "problems": problems, "gpu": gpu,
    }
    emit(row)
    if problems:
        raise AssertionError("; ".join(problems))
    return {"flash": r0["flash"], "fused_adamw": r0["fused_adamw"]}


# the checkpoint-loading slice (serve_1b_from_checkpoint): arm "port" writes
# the 1b preset's float32 flax tree with save_checkpoint, one file a
# top-level subtree (the JAX examples/serve_llm_int8.py layout), and
# streams it back int8 onto the card with load_quantized_lm; arm "hf"
# writes the 1b-gqa preset's bfloat16 weights as an HF directory (shards of
# about LOAD_HF_SHARD_BYTES and an index) and loads it with load_hf_llama
LOAD_SEED = 5
LOAD_STREAM = dict(n_slots=4, tokens_per_launch=8, prompts=(16, 32, 48, 16), new=32)
LOAD_HF_STREAM = dict(prompts=(16, 480, 16, 480), new=32)
LOAD_HF_SHARD_BYTES = 1 << 30
# the card's allocated bytes after the load against the state dict's
LOAD_CARD_TOL = 0.01
# a load's host peak RSS growth, read in a child process (VmRSS sampled
# every 2 ms, and getrusage's maxrss where the load raised it; the card's
# machine has no VmHWM), as a share of the float32 tree it streams (one
# leaf at a time: the largest, 262 MB, is 5.4% of it)
LOAD_RSS_SHARE = 0.2
# int8 against float logits, teacher-forced: mean |difference| under this
# share of the float logits' std (the JAX tests/test_hf_llama.py gate)
LOAD_HF_GATE = 0.15
LOAD_RSS_CHILD = r"""
import json, os, resource, sys, threading, time
sys.path.insert(0, sys.argv[1])
import torch
from pytorch_distributed_training_tutorials_tpu_torch.models import load_quantized_lm


def rss_kb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise RuntimeError("VmRSS")


def maxrss_kb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


torch.zeros(1, device="cuda")
torch.cuda.synchronize()
base, max_before = rss_kb(), maxrss_kb()
peak, stop = [base], threading.Event()


def sample():
    while not stop.is_set():
        peak[0] = max(peak[0], rss_kb())
        stop.wait(0.002)


sampler = threading.Thread(target=sample)
sampler.start()
t0 = time.perf_counter()
sd = {}
for name in sorted(os.listdir(sys.argv[2])):
    sd.update(load_quantized_lm(os.path.join(sys.argv[2], name), device="cuda"))
torch.cuda.synchronize()
seconds = time.perf_counter() - t0
stop.set()
sampler.join()
max_after, sampled = maxrss_kb(), max(peak[0], rss_kb())
# the kernel's own high-water mark where the load raised it, else the samples
print(json.dumps({"base_kb": base, "sampled_peak_kb": sampled,
                  "maxrss_before_kb": max_before, "maxrss_after_kb": max_after,
                  "peak_kb": max(sampled, max_after if max_after > max_before else 0),
                  "seconds": seconds, "entries": len(sd)}))
"""


def flax_lm_shapes(cfg) -> dict:
    """The JAX ``TransformerLM``'s parameter tree for ``cfg`` as nested
    dicts of shapes, in its order: the flax layout (kernels (in, out),
    q/k/v (d, H, D), o_proj (H, D, d))."""
    d, h, kv, hd, ff = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.ff_dim
    block = {
        "attn_norm": {"scale": (d,)},
        "attn": {"q_proj": {"kernel": (d, h, hd)}, "k_proj": {"kernel": (d, kv, hd)},
                 "v_proj": {"kernel": (d, kv, hd)}, "o_proj": {"kernel": (h, hd, d)}},
        "mlp_norm": {"scale": (d,)},
        "mlp": {"gate_proj": {"kernel": (d, ff)}, "up_proj": {"kernel": (d, ff)},
                "down_proj": {"kernel": (ff, d)}},
    }
    return {"tok_emb": {"embedding": (cfg.vocab_size, d)},
            **{f"block_{i}": block for i in range(cfg.n_layers)},
            "final_norm": {"scale": (d,)}, "lm_head": {"kernel": (d, cfg.vocab_size)}}


def draw_subtree(torch, shapes: dict, seed: int, dtype):
    """One top-level subtree drawn on the card from its own seed: every
    matrix N(0, 0.02^2) (the JAX example's synthetic checkpoint), norm
    scales 1 + N(0, 0.02^2)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(name, shape):
        x = torch.randn(shape, generator=gen, device="cuda") * 0.02
        return (x + 1.0 if name == "scale" else x).to(dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v) for k, v in tree.items()}

    return walk(shapes)


def draw_flax_tree(torch, cfg, dtype) -> dict:
    return {name: draw_subtree(torch, sub, LOAD_SEED * 1000 + i, dtype)
            for i, (name, sub) in enumerate(flax_lm_shapes(cfg).items())}


def tree_bytes(tree) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict) else v.nbytes for v in tree.values())


def bitwise_mismatches(torch, got: dict, want: dict) -> list:
    """Names whose tensors differ in dtype, shape or any bit (or that one
    side lacks)."""
    return sorted({k for k in set(got) ^ set(want)}
                  | {k for k in set(got) & set(want)
                     if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k])})


def load_serve(torch, quant, pa, cfg, params, prompts: list, new: int, **options) -> dict:
    """A stream through ``ServeEngine`` over ``params``: the tokens, the
    int8 and paged launches and routes, counted from 0 over the stream."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerLM
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    tpl = LOAD_STREAM["tokens_per_launch"]
    eng = ServeEngine(TransformerLM(cfg), params, n_slots=LOAD_STREAM["n_slots"],
                      tokens_per_launch=tpl, max_queue=64, device="cuda", **options)
    quant.int8_matmul.launches = 0
    quant.int8_matmul.routes = {"sm90": 0, "v1": 0}
    pa.paged_attention.launches = 0
    pa.paged_attention.routes = {"sm90": 0, "v1": 0}
    t0 = time.perf_counter()
    ids = [eng.submit(Request(prompt=p, max_new_tokens=new, seed=i))
           for i, p in enumerate(prompts)]
    done = {c.request_id: c for c in eng.run_until_idle()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {
        "tokens": [done[i].tokens if i in done else None for i in ids],
        "finished": sum(done[i].finish_reason == "length" and len(done[i].tokens) == new
                        for i in ids if i in done),
        "forwards": eng.n_prefills + eng.n_chains * tpl, "decode_steps": eng.n_chains * tpl,
        "int8_matmul_launches": quant.int8_matmul.launches,
        "int8_matmul_routes": dict(quant.int8_matmul.routes),
        "paged_attention_launches": pa.paged_attention.launches,
        "paged_attention_routes": dict(pa.paged_attention.routes),
        "wall_s": wall, "aggregate_tok_s": sum(len(c.tokens) for c in done.values()) / wall,
    }
    if options.get("paged"):
        out["pages_in_use"] = eng.page_stats()["pages_in_use"]
    return out


def serve_problems(run: dict, n_req: int, layers: int, paged: bool) -> list:
    """The launch and route gates of one :func:`load_serve` stream."""
    bad = []
    if run["finished"] != n_req:
        bad.append(f"{run['finished']} of {n_req} requests finished with every token")
    per_forward = 7 * layers + 1
    if run["int8_matmul_launches"] != per_forward * run["forwards"]:
        bad.append(f"int8_matmul launched {run['int8_matmul_launches']} times, want "
                   f"{per_forward} x {run['forwards']} forwards")
    want_paged = layers * run["decode_steps"] if paged else 0
    if run["paged_attention_launches"] != want_paged:
        bad.append(f"paged_attention launched {run['paged_attention_launches']} times, "
                   f"want {want_paged}")
    for kern in ("int8_matmul", "paged_attention"):
        calls = run[f"{kern}_launches"]
        if run[f"{kern}_routes"] != {"sm90": calls, "v1": 0}:
            bad.append(f"{kern} routes {run[f'{kern}_routes']}: every one of its {calls} "
                       "calls must take the sm90 route")
    if run.get("pages_in_use"):
        bad.append(f"{run['pages_in_use']} pages in use after the stream")
    return bad


def load_prompts(vocab: int, lengths, seed: int) -> list:
    import numpy as np

    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(0, vocab, (n,)).tolist() for n in lengths]


def load_port_arm(torch, quant, pa, gpu: str, tmp: str) -> dict:
    """Arm "port": the 1b preset's float32 tree written and streamed back
    int8 (module docstring)."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        from_jax_params,
        load_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
        _QUANTIZED_KERNELS,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.auto import (
        audit_placement,
        save_checkpoint,
    )

    cfg = TransformerConfig(**PRESET_1B, quantized=True)
    ckpt = os.path.join(tmp, "1b")
    os.makedirs(ckpt)
    t0, f32_bytes = time.perf_counter(), 0
    for i, (name, sub) in enumerate(flax_lm_shapes(cfg).items()):
        part = draw_subtree(torch, sub, LOAD_SEED * 1000 + i, torch.float32)
        f32_bytes += tree_bytes(part)
        save_checkpoint(os.path.join(ckpt, name), {name: part})
        del part
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = {}
    for name in sorted(os.listdir(ckpt)):
        params.update(load_quantized_lm(os.path.join(ckpt, name), device="cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    card_bytes = torch.cuda.memory_allocated() - base
    sd_bytes = sum(t.nbytes for t in params.values())
    child = subprocess.run([sys.executable, "-c", LOAD_RSS_CHILD, REPO, ckpt],
                           capture_output=True, text=True, timeout=600)
    if child.returncode:
        raise RuntimeError(f"the RSS child failed: {child.stderr[-2000:]}")
    rss = json.loads(child.stdout.strip().splitlines()[-1])
    rss_growth = (rss["peak_kb"] - rss["base_kb"]) * 1024
    lines = audit_placement(params)
    audit_bad = []
    for line in lines:
        name, rest = line.split(": ", 1)
        dtype, where = rest.rsplit(" on ", 1)[0].split()[-1], rest.rsplit(" on ", 1)[1]
        owner = name.rsplit(".", 2)[-2]
        if where != "cuda:0" or (dtype == "int8") != (name.endswith(".qt")
                                                      and owner in _QUANTIZED_KERNELS) \
                or dtype not in ("int8", "float32"):
            audit_bad.append(line)
    tree = draw_flax_tree(torch, cfg, torch.float32)
    want = from_jax_params(tree, cfg, device="cuda")
    del tree
    mismatched = bitwise_mismatches(torch, params, want)
    prompts = load_prompts(cfg.vocab_size, LOAD_STREAM["prompts"], 17)
    new = LOAD_STREAM["new"]
    loaded = load_serve(torch, quant, pa, cfg, params, prompts, new)
    bridged = load_serve(torch, quant, pa, cfg, want, prompts, new)
    bad = serve_problems(loaded, len(prompts), cfg.n_layers, paged=False)
    if mismatched:
        bad.append(f"{len(mismatched)} entries differ from from_jax_params: {mismatched[:4]}")
    if abs(card_bytes - sd_bytes) > LOAD_CARD_TOL * sd_bytes:
        bad.append(f"card bytes {card_bytes} against the state dict's {sd_bytes}")
    if rss_growth >= LOAD_RSS_SHARE * f32_bytes:
        bad.append(f"host RSS grew {rss_growth} bytes in the load, the bound "
                   f"{LOAD_RSS_SHARE} x {f32_bytes}")
    if rss["entries"] != len(params):
        bad.append(f"the child loaded {rss['entries']} entries, this process {len(params)}")
    if audit_bad:
        bad.append(f"{len(audit_bad)} audit lines out of place: {audit_bad[:3]}")
    if loaded["tokens"] != bridged["tokens"]:
        bad.append("tokens over the loaded weights != over from_jax_params's")
    row = {
        "phase": "serve_1b_from_checkpoint", "arm": "port", "preset": "1b",
        "layers": cfg.n_layers, "checkpoint_files": len(os.listdir(ckpt)),
        "f32_tree_bytes": f32_bytes, "write_s": write_s, "load_s": load_s,
        "load_gb_per_s": f32_bytes / load_s / 1e9, "read": "warm (just written)",
        "card_bytes_after_load": card_bytes, "state_dict_bytes": sd_bytes,
        "int8_bytes": sum(t.nbytes for t in params.values() if t.dtype == torch.int8),
        "entries": len(params), "bitwise_from_jax_params": not mismatched,
        "child_load_s": rss["seconds"], "child_rss_base_bytes": rss["base_kb"] * 1024,
        "child_rss_kb": {k: v for k, v in rss.items() if k.endswith("_kb")},
        "child_rss_growth_bytes": rss_growth, "rss_bound_bytes": LOAD_RSS_SHARE * f32_bytes,
        "audit_lines": len(lines), "audit_example": lines[:3],
        "requests": len(prompts), "new_tokens": new,
        **{k: v for k, v in loaded.items() if k != "tokens"},
        "tokens_equal_from_jax_params_engine": loaded["tokens"] == bridged["tokens"],
        "ok": not bad, "problems": bad, "gpu": gpu,
    }
    emit(row)
    return row


@contextlib.contextmanager
def untransposed_o_proj():
    """A planted fault: ``load_hf_llama`` reshapes each HF ``o_proj`` (d,
    H*D) to (H, D, d) without its transpose (square at 1b: the shape still
    fits)."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import hf_llama

    real = hf_llama._llama_layer_entries

    def faulty(i, cfg):
        return [(p, n, (lambda w: w.reshape(cfg.n_heads, cfg.head_dim, cfg.d_model))
                 if p[-2] == "o_proj" else t) for p, n, t in real(i, cfg)]

    hf_llama._llama_layer_entries = faulty
    try:
        yield
    finally:
        hf_llama._llama_layer_entries = real


def write_hf_llama(torch, path: str, cfg, tree: dict) -> int:
    """``tree`` (the flax layout, on the card) as a HF Llama directory:
    ``config.json``, shards of about LOAD_HF_SHARD_BYTES written with the
    port's ``save_safetensors``, and ``model.safetensors.index.json`` —
    each weight in HF's (out, in) layout, named and transposed here
    without the loader's mapping. Returns the tensor bytes."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.hf_llama import (
        save_safetensors,
    )

    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim

    def tensors():
        yield "model.embed_tokens.weight", tree["tok_emb"]["embedding"]
        for i in range(cfg.n_layers):
            b, pre = tree[f"block_{i}"], f"model.layers.{i}."
            att, mlp = b["attn"], b["mlp"]
            yield pre + "input_layernorm.weight", b["attn_norm"]["scale"]
            yield pre + "self_attn.q_proj.weight", att["q_proj"]["kernel"].reshape(d, h * hd).t()
            yield pre + "self_attn.k_proj.weight", att["k_proj"]["kernel"].reshape(d, kv * hd).t()
            yield pre + "self_attn.v_proj.weight", att["v_proj"]["kernel"].reshape(d, kv * hd).t()
            yield pre + "self_attn.o_proj.weight", att["o_proj"]["kernel"].reshape(h * hd, d).t()
            yield pre + "post_attention_layernorm.weight", b["mlp_norm"]["scale"]
            yield pre + "mlp.gate_proj.weight", mlp["gate_proj"]["kernel"].t()
            yield pre + "mlp.up_proj.weight", mlp["up_proj"]["kernel"].t()
            yield pre + "mlp.down_proj.weight", mlp["down_proj"]["kernel"].t()
        yield "model.norm.weight", tree["final_norm"]["scale"]
        yield "lm_head.weight", tree["lm_head"]["kernel"].t()

    shards, size = [[]], 0
    for name, t in tensors():
        if shards[-1] and size + t.nbytes > LOAD_HF_SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append((name, t))
        size += t.nbytes
    os.makedirs(path)
    weight_map = {}
    for j, part in enumerate(shards):
        fname = f"model-{j + 1:05d}-of-{len(shards):05d}.safetensors"
        save_safetensors(os.path.join(path, fname), dict(part))
        weight_map.update(dict.fromkeys((n for n, _ in part), fname))
    total = sum(t.nbytes for part in shards for _, t in part)
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": d, "intermediate_size": cfg.ff_dim,
            "num_hidden_layers": cfg.n_layers, "num_attention_heads": h,
            "num_key_value_heads": kv, "head_dim": hd,
            "max_position_embeddings": cfg.max_seq_len, "rms_norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta, "hidden_act": "silu", "rope_scaling": None,
            "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        }, f)
    return total


def logit_share(torch, cfg, fparams, qparams, tokens: list) -> float:
    """Teacher-forced mean |int8 - float| over std(float) of the logits of
    one sequence through the float and int8 models (full forwards)."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerLM,
        bind_params,
    )

    seq = torch.tensor([tokens], device="cuda")
    out = []
    for c, p in ((cfg, fparams), (dataclasses.replace(cfg, quantized=True), qparams)):
        model = TransformerLM(c)
        bind_params(model, p)
        with torch.no_grad():
            out.append(model(seq).float())
    ref, got = out
    return float((got - ref).abs().mean() / ref.std())


def load_hf_arm(torch, quant, pa, gpu: str, tmp: str) -> dict:
    """Arm "hf": the 1b-gqa preset's bfloat16 weights as an HF directory,
    loaded float and int8 and served (module docstring)."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        from_jax_params,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.hf_llama import (
        load_hf_llama,
    )

    spec = TransformerConfig(**PRESET_1B_GQA)
    tree = draw_flax_tree(torch, spec, torch.bfloat16)
    hf_dir = os.path.join(tmp, "hf")
    t0 = time.perf_counter()
    hf_bytes = write_hf_llama(torch, hf_dir, spec, tree)
    write_s = time.perf_counter() - t0
    files = sorted(os.listdir(hf_dir))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, fparams = load_hf_llama(hf_dir, device="cuda")
    torch.cuda.synchronize()
    float_s = time.perf_counter() - t0
    bad_float = bitwise_mismatches(torch, fparams, from_jax_params(tree, cfg, device="cuda"))
    t0 = time.perf_counter()
    _, qparams = load_hf_llama(hf_dir, quantize=True, device="cuda")
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t0
    qcfg = dataclasses.replace(cfg, quantized=True)
    bad_int8 = bitwise_mismatches(torch, qparams, from_jax_params(tree, qcfg, device="cuda"))
    del tree
    prompts = load_prompts(cfg.vocab_size, LOAD_HF_STREAM["prompts"], 19)
    new = LOAD_HF_STREAM["new"]
    st = PAGED_STREAM
    run = load_serve(torch, quant, pa, qcfg, qparams, prompts, new, paged=True,
                     paged_kernel=True, page_size=st["page_size"], pool_pages=st["pool_pages"])
    seq = prompts[0] + run["tokens"][0]
    share = logit_share(torch, cfg, fparams, qparams, seq)
    with untransposed_o_proj():
        _, faulty = load_hf_llama(hf_dir, quantize=True, device="cuda")
    fault_share = logit_share(torch, cfg, fparams, faulty, seq)
    del faulty
    bad = serve_problems(run, len(prompts), cfg.n_layers, paged=True)
    if cfg != spec:
        bad.append(f"config.json read as {cfg}")
    if bad_float:
        bad.append(f"float load: {len(bad_float)} entries differ from from_jax_params: "
                   f"{bad_float[:4]}")
    if bad_int8:
        bad.append(f"int8 load: {len(bad_int8)} entries differ from from_jax_params: "
                   f"{bad_int8[:4]}")
    if not share < LOAD_HF_GATE:
        bad.append(f"int8 against float logits {share} >= {LOAD_HF_GATE} of their std")
    if not fault_share >= LOAD_HF_GATE:
        bad.append(f"the untransposed o_proj passed the gate: {fault_share}")
    row = {
        "phase": "serve_1b_from_checkpoint", "arm": "hf", "preset": "1b-gqa",
        "layers": cfg.n_layers, "files": files, "tensor_bytes_bf16": hf_bytes,
        "write_s": write_s, "load_float_s": float_s, "load_int8_s": int8_s,
        "load_float_gb_per_s": hf_bytes / float_s / 1e9,
        "load_int8_gb_per_s": hf_bytes / int8_s / 1e9, "read": "warm (just written)",
        "bitwise_float": not bad_float, "bitwise_int8": not bad_int8,
        "int8_state_dict_bytes": sum(t.nbytes for t in qparams.values()),
        "float_state_dict_bytes": sum(t.nbytes for t in fparams.values()),
        "requests": len(prompts), "prompt_lengths": list(LOAD_HF_STREAM["prompts"]),
        "new_tokens": new, "options": "paged kernel, pages of 64, a pool of 48",
        **{k: v for k, v in run.items() if k != "tokens"},
        "logit_share": share, "fault_logit_share": fault_share, "gate": LOAD_HF_GATE,
        "teacher_forced_tokens": len(seq),
        "ok": not bad, "problems": bad, "gpu": gpu,
    }
    emit(row)
    return row


def phase_serve_1b_from_checkpoint(torch, quant, pa, gpu: str) -> dict:
    """The checkpoint-loading slice: arms "port" and "hf", each under a
    temporary directory of ``build/`` removed when the arm ends. Returns
    each arm's line."""
    import shutil
    import tempfile

    root = os.path.join(REPO, "build")
    os.makedirs(root, exist_ok=True)
    du = shutil.disk_usage(root)
    emit({"phase": "serve_1b_from_checkpoint_disk", "path": root, "total_bytes": du.total,
          "used_bytes": du.used, "free_bytes": du.free, "gpu": gpu})
    out = {}
    for arm, fn in (("port", load_port_arm), ("hf", load_hf_arm)):
        with tempfile.TemporaryDirectory(prefix=f"ckpt_{arm}_", dir=root) as tmp:
            out[arm] = fn(torch, quant, pa, gpu, tmp)
        torch.cuda.empty_cache()
    problems = [f"arm {a}: {x}" for a, row in out.items() for x in row["problems"]]
    if problems:
        raise AssertionError("; ".join(problems))
    return out



# the last parallel strategies (the sequence-, pipeline- and expert-
# parallel slice): three gloo worlds of 2 on card 0, each held to the
# single-device Trainer on the same weights (seed 0) in the same call
SPEP_SEED = 0
# train_760m_spmd_pipeline: the 760m widths at 4 layers, 2 a stage, bf16,
# flash, cross entropy, fused AdamW; batch 4 at M 1, 2, 4
PP_CFG = dict(PRESET_760M, n_layers=4, max_seq_len=2048)
PP_BATCH = 4
PP_M = (1, 2, 4)
PP_STEPS = 2
# one leaf of each kind and stage: the embedding (stage 0's gradient,
# summed over the stages), each stage's column and row projections, the
# replicated norm and head
PP_LEAVES = ("tok_emb.weight", "blocks.0.attn.q_proj.weight", "blocks.1.mlp.down_proj.weight",
             "blocks.2.attn.o_proj.weight", "blocks.3.mlp.gate_proj.weight",
             "final_norm.scale", "lm_head.weight")
# the first step against the single-device one (both bf16): at M 1 the
# stages run the single device's matmuls at its shapes, so the loss and
# every first moment are bitwise; at M > 1 the microbatches' weight
# gradients are bf16 partials rounded on their own: the loss within 1e-3
# relative and each leaf's first moment within 1% (relative error norm;
# the H100 reads 0.2345-0.2348%, with the loss equal); the planted fault
# (stage 0 sends microbatch 1 as 0 and 0 as 1) pairs rows with other
# targets: the head's gradient, whose target term dominates at random
# weights, moves by its whole size (0.54-1.41)
PP_LOSS_TOL = 1e-3
PP_GRAD_TOL = 0.01
# train_760m_seq: 2 layers, batch 2, {"seq": 2}; the ring's plain hop
# folds f32 scores of bf16 q/k against the reference's flash kernels, so
# train_760m_tp2's bounds again; the planted fault (rank 1's RoPE offset 0)
# rotates half the queries and keys to other positions
SEQ_CFG = dict(PRESET_760M, n_layers=2, max_seq_len=2048)
SEQ_BATCH = 2
SEQ_STEPS = 2
SEQ_HOP_BLOCK = 512
SEQ_LEAVES = ("tok_emb.weight", "blocks.0.attn.q_proj.weight", "blocks.0.attn.k_proj.weight",
              "blocks.1.attn.q_proj.weight", "blocks.1.mlp.down_proj.weight",
              "final_norm.scale", "lm_head.weight")
# train_moe_ep: 8 experts, top 2, capacity 1.25, 2 layers, batch 2, aux
# 0.01, {"expert": 2}, float32 (TF32 off) so that the gates hold the router
# and expert gradients to float32 summation order: loss within 1e-5 and
# each first moment within 1e-3; the aux loss counted twice moves the
# router's gradient by the aux term's share
MOE_CFG = dict(PRESET_760M, n_layers=2, max_seq_len=2048, moe_experts=8, moe_top_k=2,
               moe_capacity_factor=1.25)
MOE_BATCH = 2
MOE_STEPS = 2
MOE_AUX = 0.01
MOE_LEAVES = ("blocks.0.moe.router", "blocks.1.moe.router", "blocks.0.moe.w_gate",
              "blocks.0.moe.w_down", "blocks.1.moe.w_up", "tok_emb.weight", "lm_head.weight")
MOE_LOSS_TOL = 1e-5
MOE_GRAD_TOL = 1e-3
SPEP_NOTE = ("gloo on one card: every collective and hop staged through host memory; the "
             "phase's times are not the strategy's speed")


def lm_batch(batch: int):
    """``batch`` rows of 2049 tokens from PCG64(0) (bench/lm_headline.py's
    recipe): tokens and the shifted targets."""
    import numpy as np

    rng = np.random.Generator(np.random.PCG64(0))
    toks = rng.integers(0, PRESET_760M["vocab_size"], (batch, 2049))
    return toks[:, :-1], toks[:, 1:]


def reset_kernel_counts(torch) -> None:
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw

    for counts in (flash_attention.launches, *flash_attention.routes.values()):
        for k in counts:
            counts[k] = 0
    fused_adamw.launches = 0


def kernel_counts() -> dict:
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw

    return {"flash": dict(flash_attention.launches),
            "flash_routes": {k: dict(c) for k, c in flash_attention.routes.items()},
            "fused_adamw": fused_adamw.launches}


def spep_run(torch, model, mesh, strategy, batch, leaves, steps: int, *, batch_spec=None,
             aux_loss_weight: float = 0.0, counted=()) -> dict:
    """``steps`` steps of ``model`` through the ``Trainer`` (fused AdamW
    3e-4, weight decay 0.01, cross entropy, weights from SPEP_SEED) on
    ``batch``, one step an epoch: the losses, the first step's first
    moments of ``leaves`` this rank holds (on the host), the kernel
    launches and the collectives of ``counted`` (objects with
    ``collectives``) over the steps, each step's ms, peak memory, and the
    bytes of the rank's parameters by name."""
    from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
    from pytorch_distributed_training_tutorials_tpu_torch.models import moe_dropped
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.collective import bucket_plan
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer

    x, y = batch
    loader = ShardedLoader(ArrayDataset((x, y)), x.shape[0], mesh, batch_mode="global",
                           shuffle=False, batch_spec=batch_spec)
    trainer = Trainer(model, loader, fused_adamw(3e-4, weight_decay=0.01), strategy=strategy,
                      loss="cross_entropy", seed=SPEP_SEED, quiet=True,
                      aux_loss_weight=aux_loss_weight)
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    reset_kernel_counts(torch)
    for c in counted:
        c.reset_collectives()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, mu = [], {}
    for e in range(1, steps + 1):
        t = time.perf_counter()
        trainer.train(e)
        step_ms.append((time.perf_counter() - t) * 1e3)
        if e == 1:
            mus = trainer.state.opt_state.mu
            mu = {n: mus[names.index(n)].detach().to("cpu", copy=True)
                  for n in leaves if n in names}
            dropped = [int(d) for d in moe_dropped(trainer.model)]
    out = {"losses": [ev["loss"] for ev in trainer.metrics.step_events()], "mu": mu,
           "dropped": dropped, "step_ms": step_ms,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "bytes": {n: p.numel() * p.element_size() for n, p in trainer.model.named_parameters()},
           "collectives": [dict(c.collectives) for c in counted],
           # the gradient average's buckets a step: the gradients and the
           # loss (in the logits' type)
           "buckets": len(bucket_plan([*trainer.state.params,
                                       torch.zeros((), dtype=trainer.model.cfg.dtype)])),
           **kernel_counts()}
    del trainer
    torch.cuda.empty_cache()
    return out


def spep_gaps(torch, run: dict, ref: dict, block=lambda name, t: t) -> dict:
    """A rank's first-step loss and first moments against the single
    device's (``block`` cuts a whole tensor to the rank's entries)."""
    return {"loss": abs(run["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "mu": {n: rel_err(torch, m, block(n, ref["mu"][n])) for n, m in run["mu"].items()}}


def spep_problems(who: str, gaps: dict, loss_tol: float, grad_tol: float) -> list:
    if gaps["loss"] <= loss_tol and max(gaps["mu"].values()) <= grad_tol:
        return []
    return [f"{who}: first step off the single-device one: {gaps}"]


def spep_lm(torch, cfg_spec: dict, dtype, attention_fn=None, **extra):
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
    )

    return TransformerLM(TransformerConfig(**cfg_spec, dtype=dtype, attention_fn=attention_fn,
                                           **extra))


def plant_microbatch_swap(stages) -> None:
    """The pipeline fault: the stage holds microbatch 0 and sends
    microbatch 1's activations under 0's tag, then 0's under 1's."""
    real, held = stages.send, {}

    def send(x, stage, tag):
        if stage > stages.stage and tag == 0:
            held[0] = x.detach().clone()
            return
        if stage > stages.stage and tag == 1:
            real(x, stage, 0)
            real(held.pop(0), stage, 1)
            return
        real(x, stage, tag)

    stages.send = send


def pp_rank(world_tp) -> dict:
    """One rank of train_760m_spmd_pipeline (spawned): the pipeline over
    ``{"stage": 2}`` at each M of PP_M, and one step at M 2 with the
    planted microbatch swap."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerConfig
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        PipelinedTransformerLM,
        PipelineParallel,
        create_mesh,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.pipeline_spmd import (
        expected_messages,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh({"stage": 2}, device="cuda", stage_ranks=True)
    cfg = TransformerConfig(**PP_CFG, dtype=torch.bfloat16,
                            attention_fn=make_flash_attention(1024, 1024))
    out = {"by_m": {}}
    for m in (*PP_M, "planted"):
        model = PipelinedTransformerLM(cfg, mesh, num_microbatches=2 if m == "planted" else m)
        if m == "planted":
            plant_microbatch_swap(model.stages)
        strategy = PipelineParallel(mesh, num_microbatches=model.num_microbatches)
        run = spep_run(torch, model, mesh, strategy, lm_batch(PP_BATCH), PP_LEAVES,
                       1 if m == "planted" else PP_STEPS,
                       counted=(model.stages, strategy.stages))
        run["expected_messages"] = expected_messages(model.stages.stage, 2,
                                                     model.num_microbatches)
        out["by_m"][m] = run
        out["stage"] = model.stages.stage
    return out


def phase_train_760m_spmd_pipeline(torch, gpu: str) -> dict:
    """``train_760m_spmd_pipeline``: ``PipelinedTransformerLM`` +
    ``PipelineParallel`` over ``create_mesh({"stage": 2}, stage_ranks=True)``
    (a gloo world of 2 on card 0) at PP_CFG, beside the single-device
    ``Trainer`` from the same seed. Gates, at each M of PP_M: the first
    step's loss within PP_LOSS_TOL and each of PP_LEAVES' first moments a
    stage holds within PP_GRAD_TOL of the single-device step's, and at M 1
    bitwise; the planted
    microbatch swap outside them; the stages' losses the same floats; a
    step's sends, receives and broadcast the schedule's own count
    (``expected_messages``), one stage sum of the embedding's gradient; per
    rank a step 2M flash forward, dq and dk/dv launches (2 layers, M
    microbatches), all sm90, and one AdamW launch. Then step ms by M and
    peak memory a rank (gloo on one card: not pipeline speed)."""
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        spawn_tp,
    )

    ref = spep_run(torch, spep_lm(torch, PP_CFG, torch.bfloat16, make_flash_attention(1024, 1024)),
                   create_mesh(device="cuda"), None, lm_batch(PP_BATCH), PP_LEAVES,
                   PP_STEPS)
    t0 = time.perf_counter()
    ranks = spawn_tp(pp_rank, 2, (), backend="gloo", device="cuda", join_timeout_s=900)
    ranks_s = time.perf_counter() - t0
    problems, gaps, planted = [], {}, []
    for r in ranks:
        who = f"stage {r['stage']}"
        for m, run in r["by_m"].items():
            g = spep_gaps(torch, run, ref)
            if m == "planted":
                planted.append(g)
                if max(g["mu"].values()) <= PP_GRAD_TOL:
                    problems.append(f"{who}: the planted microbatch swap passed the gate: {g}")
                continue
            gaps.setdefault(m, []).append(g)
            if m == 1 and (g["loss"] or any(g["mu"].values())):
                problems.append(f"{who}, M 1: first step not bitwise the single device's: {g}")
            problems += spep_problems(f"{who}, M {m}", g, PP_LOSS_TOL, PP_GRAD_TOL)
            steps = PP_STEPS
            messages, strat = run["collectives"]
            want = {k: v * steps for k, v in run["expected_messages"].items()}
            want["staged"] = want["send"] + want["recv"]
            if messages != want or strat != {"stage_sum": steps}:
                problems.append(f"{who}, M {m}: messages {messages} / {strat} != {want}")
            if run["flash"] != {k: 2 * m * steps for k in ("fwd", "dq", "dkv")}:
                problems.append(f"{who}, M {m}: flash launches {run['flash']}")
            if any(c["sm80"] for c in run["flash_routes"].values()):
                problems.append(f"{who}, M {m}: a flash launch left the sm90 route")
            if run["fused_adamw"] != steps:
                problems.append(f"{who}, M {m}: {run['fused_adamw']} AdamW launches")
            if run["losses"] != ranks[0]["by_m"][m]["losses"]:
                problems.append(f"{who}, M {m}: losses differ from stage 0's")
            if not all(map(math.isfinite, run["losses"])):
                problems.append(f"{who}, M {m}: losses {run['losses']}")
    r0 = ranks[0]["by_m"]
    row = {
        "phase": "train_760m_spmd_pipeline", "mesh": {"stage": 2}, "backend": "gloo",
        "ranks": 2, "config": {**PP_CFG, "dtype": "bf16", "attention": "flash",
                               "batch": PP_BATCH, "loss": "cross_entropy",
                               "optimizer": "fused_adamw(3e-4, weight_decay=0.01)"},
        "microbatches": list(PP_M), "steps": PP_STEPS, "losses_single": ref["losses"],
        "losses_by_m": {m: r0[m]["losses"] for m in PP_M}, "first_step_gaps": gaps,
        "tolerance": {"loss": PP_LOSS_TOL, "first_moment": PP_GRAD_TOL, "at_m_1": "bitwise"},
        "planted_fault": "stage 0 sends microbatch 1 under 0's tag and 0 under 1's (M 2)",
        "planted_fault_gaps": planted,
        "messages_per_step": {m: [{k: v / PP_STEPS for k, v in r["by_m"][m]["collectives"][0]
                                   .items()} for r in ranks] for m in PP_M},
        "launches_per_rank_step": {m: {"flash": {k: v / PP_STEPS
                                                 for k, v in r0[m]["flash"].items()},
                                       "fused_adamw": r0[m]["fused_adamw"] / PP_STEPS}
                                   for m in PP_M},
        "step_ms_single": ref["step_ms"],
        "step_ms_by_m": {m: [r["by_m"][m]["step_ms"] for r in ranks] for m in PP_M},
        "peak_memory_bytes_single": ref["peak_memory_bytes"],
        "peak_memory_bytes_by_m": {m: [r["by_m"][m]["peak_memory_bytes"] for r in ranks]
                                   for m in PP_M},
        "param_bytes": {"single": sum(ref["bytes"].values()),
                        "per_stage": [sum(r["by_m"][1]["bytes"].values()) for r in ranks]},
        "ranks_s": ranks_s, "timing_note": SPEP_NOTE,
        "ok": not problems, "problems": problems, "gpu": gpu,
    }
    emit(row)
    if problems:
        raise AssertionError("; ".join(problems))
    return {"flash": r0[2]["flash"], "fused_adamw": r0[2]["fused_adamw"]}


def seq_rank(world_tp) -> dict:
    """One rank of train_760m_seq (spawned): ``{"seq": 2}``, each arm's
    SEQ_STEPS steps and one step with the RoPE offset planted at 0."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        TensorParallel,
        create_mesh,
        make_ring_attention,
        make_ulysses_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh({"seq": 2}, device="cuda")
    arms = {"ring": lambda: make_ring_attention(mesh, hop_block=SEQ_HOP_BLOCK),
            "ulysses": lambda: make_ulysses_attention(
                mesh, inner_attention=make_flash_attention(1024, 1024))}
    out = {}
    for name, make in arms.items():
        for planted in (False, True):
            fn = make()
            if planted:
                fn.seq_shard.position_offset = lambda s_local: 0
            tp = TensorParallel(mesh, [], seq_axis="seq")
            run = spep_run(torch, spep_lm(torch, SEQ_CFG, torch.bfloat16, fn), mesh, tp,
                           lm_batch(SEQ_BATCH), SEQ_LEAVES, 1 if planted else SEQ_STEPS,
                           batch_spec=("data", "seq"), counted=(tp, fn.seq_shard))
            out[f"{name}_planted" if planted else name] = run
        out["rank"] = fn.seq_shard.rank
    return out


def phase_train_760m_seq(torch, gpu: str) -> dict:
    """``train_760m_seq``: sequence parallelism over ``{"seq": 2}`` (a gloo
    world of 2 on card 0) at SEQ_CFG, batch 2, each rank its (2, 1024)
    block (``batch_spec=("data", "seq")``, ``TensorParallel(mesh, [],
    seq_axis="seq")``), beside the single-device flash ``Trainer``. Arms:
    ``ring`` (the plain hop, hop_block 512) and ``ulysses`` (the flash op at
    8 heads a rank). Gates: the first step's loss and SEQ_LEAVES' first
    moments within train_760m_tp2's bounds, the planted RoPE offset 0
    outside them; the ranks' losses the same floats; collectives a step by
    kind (ring: a hop a layer each way; Ulysses: 4 all_to_alls a layer;
    each staged through host memory; the seq mean's all_reduce buckets);
    Ulysses' flash launches 2 / 2 / 2 a rank a step, all sm90; one AdamW
    launch a rank a step; a rank's peak memory below the single
    device's."""
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        spawn_tp,
    )

    ref = spep_run(torch, spep_lm(torch, SEQ_CFG, torch.bfloat16, make_flash_attention(1024, 1024)),
                   create_mesh(device="cuda"), None, lm_batch(SEQ_BATCH), SEQ_LEAVES,
                   SEQ_STEPS)
    t0 = time.perf_counter()
    ranks = spawn_tp(seq_rank, 2, (), backend="gloo", device="cuda", join_timeout_s=900)
    ranks_s = time.perf_counter() - t0
    layers, steps = SEQ_CFG["n_layers"], SEQ_STEPS
    want_attn = {"ring": {"ring_hop": layers, "ring_hop_grad": layers, "staged": 2 * layers},
                 "ulysses": {"all_to_all": 4 * layers, "staged": 4 * layers}}
    problems, gaps, planted = [], {}, {}
    for r in ranks:
        who = f"seq rank {r['rank']}"
        for arm in ("ring", "ulysses"):
            run = r[arm]
            g = spep_gaps(torch, run, ref)
            gaps.setdefault(arm, []).append(g)
            problems += spep_problems(f"{who}, {arm}", g, TP_TRAIN_LOSS_TOL, TP_TRAIN_GRAD_TOL)
            pg = spep_gaps(torch, r[f"{arm}_planted"], ref)
            planted.setdefault(arm, []).append(pg)
            if pg["loss"] <= TP_TRAIN_LOSS_TOL and max(pg["mu"].values()) <= TP_TRAIN_GRAD_TOL:
                problems.append(f"{who}, {arm}: the planted RoPE offset passed the gate: {pg}")
            tp_c, attn_c = run["collectives"]
            want = {k: v * steps for k, v in want_attn[arm].items()}
            if attn_c != want or tp_c.get("seq_all_reduce") != run["buckets"] * steps:
                problems.append(f"{who}, {arm}: collectives {attn_c} / {tp_c}, want {want}")
            flash = {k: 2 * steps for k in ("fwd", "dq", "dkv")} if arm == "ulysses" else {
                k: 0 for k in ("fwd", "dq", "dkv")}
            if run["flash"] != flash or any(c["sm80"] for c in run["flash_routes"].values()):
                problems.append(f"{who}, {arm}: flash {run['flash']} {run['flash_routes']}")
            if run["fused_adamw"] != steps:
                problems.append(f"{who}, {arm}: {run['fused_adamw']} AdamW launches")
            if run["peak_memory_bytes"] >= ref["peak_memory_bytes"]:
                problems.append(f"{who}, {arm}: peak memory {run['peak_memory_bytes']} not "
                                f"below the single device's {ref['peak_memory_bytes']}")
            if run["losses"] != ranks[0][arm]["losses"] or not all(
                    map(math.isfinite, run["losses"])):
                problems.append(f"{who}, {arm}: losses {run['losses']}")
    row = {
        "phase": "train_760m_seq", "mesh": {"seq": 2}, "backend": "gloo", "ranks": 2,
        "config": {**SEQ_CFG, "dtype": "bf16", "batch": SEQ_BATCH, "loss": "cross_entropy",
                   "optimizer": "fused_adamw(3e-4, weight_decay=0.01)",
                   "reference_attention": "flash", "ring_hop_block": SEQ_HOP_BLOCK,
                   "ulysses_inner": "flash, 8 heads a rank"},
        "steps": steps, "losses_single": ref["losses"],
        "losses": {arm: ranks[0][arm]["losses"] for arm in ("ring", "ulysses")},
        "first_step_gaps": gaps,
        "tolerance": {"loss": TP_TRAIN_LOSS_TOL, "first_moment": TP_TRAIN_GRAD_TOL},
        "planted_fault": "rank 1's RoPE offset 0 (its positions restart at 0)",
        "planted_fault_gaps": planted,
        "collectives_per_step": {arm: [{k: v / steps for c in r[arm]["collectives"]
                                        for k, v in c.items()} for r in ranks]
                                 for arm in ("ring", "ulysses")},
        "launches_per_rank_step": {arm: {"flash": {k: v / steps
                                                   for k, v in ranks[0][arm]["flash"].items()},
                                         "fused_adamw": ranks[0][arm]["fused_adamw"] / steps}
                                   for arm in ("ring", "ulysses")},
        "step_ms_single": ref["step_ms"],
        "step_ms": {arm: [r[arm]["step_ms"] for r in ranks] for arm in ("ring", "ulysses")},
        "peak_memory_bytes_single": ref["peak_memory_bytes"],
        "peak_memory_bytes": {arm: [r[arm]["peak_memory_bytes"] for r in ranks]
                              for arm in ("ring", "ulysses")},
        "ranks_s": ranks_s, "timing_note": SPEP_NOTE,
        "ok": not problems, "problems": problems, "gpu": gpu,
    }
    emit(row)
    if problems:
        raise AssertionError("; ".join(problems))
    return {arm: {"flash": ranks[0][arm]["flash"], "fused_adamw": ranks[0][arm]["fused_adamw"]}
            for arm in ("ring", "ulysses")}


def moe_rank(world_tp) -> dict:
    """One rank of train_moe_ep (spawned): ``{"expert": 2}`` with
    ``ep_rules()``, MOE_STEPS steps, and one step with the aux loss counted
    twice."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.models import ep_rules
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        TensorParallel,
        create_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh({"expert": 2}, device="cuda")
    out = {}
    for planted in (False, True):
        tp = TensorParallel(mesh, ep_rules())
        run = spep_run(torch, spep_lm(torch, MOE_CFG, torch.float32,
                                      make_flash_attention(1024, 1024)),
                       mesh, tp, lm_batch(MOE_BATCH), MOE_LEAVES, 1 if planted else MOE_STEPS,
                       aux_loss_weight=MOE_AUX * (2 if planted else 1), counted=(tp.expert,))
        out["planted" if planted else "run"] = run
        out["rank"] = tp.ep_rank
    return out


def expert_block(rank: int):
    def block(name: str, t):
        if name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down"):
            n = t.shape[0] // 2
            return t[rank * n:(rank + 1) * n]
        return t
    return block


def phase_train_moe_ep(torch, gpu: str) -> dict:
    """``train_moe_ep``: MoE blocks (MOE_CFG) with expert parallelism over
    ``{"expert": 2}`` (``TensorParallel(mesh, ep_rules())``, a gloo world
    of 2 on card 0), float32, beside the single-device ``Trainer``. Gates:
    the first step's loss within MOE_LOSS_TOL and the routers' and the
    rank's expert blocks' first moments within MOE_GRAD_TOL, the aux loss
    counted twice outside them; each layer's dropped (token, choice) count
    equal to the single device's; a rank's expert bytes half of the
    whole; the expert group's collectives a step (g one a layer, f two a
    layer); one AdamW launch a rank a step; the ranks' losses the same
    floats. Then step ms and peak memory a rank."""
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        spawn_tp,
    )

    ref = spep_run(torch, spep_lm(torch, MOE_CFG, torch.float32, make_flash_attention(1024, 1024)),
                   create_mesh(device="cuda"), None, lm_batch(MOE_BATCH), MOE_LEAVES,
                   MOE_STEPS,
                   aux_loss_weight=MOE_AUX)
    t0 = time.perf_counter()
    ranks = spawn_tp(moe_rank, 2, (), backend="gloo", device="cuda", join_timeout_s=900)
    ranks_s = time.perf_counter() - t0
    layers, steps = MOE_CFG["n_layers"], MOE_STEPS
    experts = ("w_gate", "w_up", "w_down")
    whole_expert = sum(b for n, b in ref["bytes"].items() if n.rsplit(".", 1)[-1] in experts)
    problems, gaps, planted, shares = [], [], [], []
    for r in ranks:
        who, run = f"expert rank {r['rank']}", r["run"]
        g = spep_gaps(torch, run, ref, expert_block(r["rank"]))
        gaps.append(g)
        problems += spep_problems(who, g, MOE_LOSS_TOL, MOE_GRAD_TOL)
        pg = spep_gaps(torch, r["planted"], ref, expert_block(r["rank"]))
        planted.append(pg)
        if max(pg["mu"][n] for n in pg["mu"] if n.endswith("router")) <= MOE_GRAD_TOL:
            problems.append(f"{who}: the aux loss counted twice passed the router gate: {pg}")
        if run["dropped"] != ref["dropped"]:
            problems.append(f"{who}: dropped {run['dropped']} != single device {ref['dropped']}")
        mine = sum(b for n, b in run["bytes"].items() if n.rsplit(".", 1)[-1] in experts)
        shares.append(mine / whole_expert)
        if mine * 2 != whole_expert:
            problems.append(f"{who}: expert bytes {mine} of {whole_expert}")
        want = {"all_reduce": 0, "all_gather": 0, "g": layers * steps, "f": 2 * layers * steps}
        if run["collectives"][0] != want:
            problems.append(f"{who}: expert collectives {run['collectives'][0]} != {want}")
        if run["fused_adamw"] != steps:
            problems.append(f"{who}: {run['fused_adamw']} AdamW launches")
        if run["losses"] != ranks[0]["run"]["losses"] or not all(
                map(math.isfinite, run["losses"])):
            problems.append(f"{who}: losses {run['losses']}")
    r0 = ranks[0]["run"]
    row = {
        "phase": "train_moe_ep", "mesh": {"expert": 2}, "backend": "gloo", "ranks": 2,
        "config": {**MOE_CFG, "dtype": "f32 (TF32 off)", "attention": "flash (f32 route)",
                   "batch": MOE_BATCH, "loss": "cross_entropy", "aux_loss_weight": MOE_AUX,
                   "optimizer": "fused_adamw(3e-4, weight_decay=0.01)"},
        "steps": steps, "losses_single": ref["losses"],
        "losses_per_rank": [r["run"]["losses"] for r in ranks], "first_step_gaps": gaps,
        "tolerance": {"loss": MOE_LOSS_TOL, "first_moment": MOE_GRAD_TOL},
        "planted_fault": "the aux loss counted twice (what an f on the gates does at ep 2)",
        "planted_fault_gaps": planted, "dropped_single": ref["dropped"],
        "dropped_per_rank": [r["run"]["dropped"] for r in ranks],
        "expert_bytes": {"single": whole_expert, "share_per_rank": shares},
        "collectives_per_step": [{k: v / steps for k, v in r["run"]["collectives"][0].items()}
                                 for r in ranks],
        "launches_per_rank_step": {"flash": {k: v / steps for k, v in r0["flash"].items()},
                                   "flash_routes": r0["flash_routes"],
                                   "fused_adamw": r0["fused_adamw"] / steps},
        "step_ms_single": ref["step_ms"], "step_ms_per_rank": [r["run"]["step_ms"] for r in ranks],
        "peak_memory_bytes_single": ref["peak_memory_bytes"],
        "peak_memory_bytes_per_rank": [r["run"]["peak_memory_bytes"] for r in ranks],
        "ranks_s": ranks_s, "timing_note": SPEP_NOTE,
        "ok": not problems, "problems": problems, "gpu": gpu,
    }
    emit(row)
    if problems:
        raise AssertionError("; ".join(problems))
    return {"flash": r0["flash"], "fused_adamw": r0["fused_adamw"]}


def spep_phases(run, torch, gpu: str) -> dict:
    """The sequence-, pipeline- and expert-parallel slice's three phases
    (``--sp-ep-only`` runs these after the build)."""
    return {"pipeline": run(phase_train_760m_spmd_pipeline, torch, gpu),
            "seq": run(phase_train_760m_seq, torch, gpu),
            "moe": run(phase_train_moe_ep, torch, gpu)}


def strategy_phases(run, torch, gpu: str) -> dict:
    """The model-parallel slice's four phases (``--strategies-only`` runs
    these after the build)."""
    return {"pipeline": run(phase_train_resnet50_pipeline, torch, gpu),
            "gpipe": run(phase_train_resnet50_gpipe, torch, gpu),
            "fsdp": run(phase_train_resnet18_fsdp, torch, gpu),
            "hybrid": run(phase_train_lm_hybrid_fsdp, torch, gpu)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after phase 2 (build, check and time the kernels)")
    ap.add_argument("--ddp-only", action="store_true",
                    help="after the build, run the training path only: fused AdamW's "
                         "kernel check, phases 8 and 9 and the streaming, guardrail and "
                         "bench phases")
    ap.add_argument("--serve-only", action="store_true",
                    help="after the build, run the serving phases (4, serve_1b_paged, "
                         "serve_1b_prefill, serve_1b_spec, serve_1b_lora) only")
    ap.add_argument("--lora-only", action="store_true",
                    help="after the build, run the LoRA slice's phases only "
                         "(serve_1b_lora with its composed arm, train_760m dots_attn, "
                         "train_lora)")
    ap.add_argument("--faults-only", action="store_true",
                    help="after the build, run the failure-handling phases only "
                         "(serve_1b_faults, serve_1b_gqa_paged_faults, serve_1b_flight, "
                         "serve_1b_fleet)")
    ap.add_argument("--tp-only", action="store_true",
                    help="after the build, run the tensor-parallel phases only "
                         "(serve_1b_tp2, fused_cross_entropy_tp's kernel check, "
                         "train_760m_tp2)")
    ap.add_argument("--load-only", action="store_true",
                    help="after the build, run the checkpoint-loading phase only "
                         "(serve_1b_from_checkpoint)")
    ap.add_argument("--sp-ep-only", action="store_true",
                    help="after the build, run the sequence-, pipeline- and expert-parallel "
                         "slice's phases only (train_760m_spmd_pipeline, train_760m_seq, "
                         "train_moe_ep)")
    ap.add_argument("--slo-roles-only", action="store_true",
                    help="after the build, run the serving engine features' phases only "
                         "(serve_1b_slo with serve_1b_gqa_paged_slo, serve_1b_disagg, "
                         "serve_1b_sentry, serve_1b_tp2 with its clock, roles and SLO "
                         "legs, serve_1b_tp2_world4, train_sentry)")
    ap.add_argument("--strategies-only", action="store_true",
                    help="after the build, run the model-parallel slice's phases only "
                         "(train_resnet50_pipeline, train_resnet50_gpipe, "
                         "train_resnet18_fsdp, train_lm_hybrid_fsdp)")
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
        run(phase_adamw, torch, gpu)
        run(phase_resnet_card_vs_cpu, torch, gpu)
        run(phase_train_resnet_ddp, torch, gpu)
        run(phase_train_resnet_streaming, torch, gpu)
        run(phase_train_guardrails, torch, gpu)
        run(phase_bench_and_scaling, torch, gpu)
        emit({"phase": "phase_seconds", **seconds})
        return 0
    def fault_phases():
        faults = run(phase_serve_faults, torch, fa, gpu)
        paged_faults = run(phase_serve_paged_faults, torch, pa, gpu)
        run(phase_serve_flight, torch, gpu, faults)
        fleet = run(phase_serve_fleet, torch, gpu, faults)
        return faults, paged_faults, fleet

    if args.serve_only:
        run(phase_serve, torch, quant, gpu)
        run(phase_serve_paged, torch, pa, gpu)
        run(phase_serve_prefill, torch, fa, gpu)
        run(phase_serve_spec, torch, fa, gpu)
        run(phase_serve_lora, torch, quant, fa, pa, gpu)
        fault_phases()
        run(phase_serve_tp, torch, quant, gpu)
        emit({"phase": "phase_seconds", **seconds})
        return 0
    if args.tp_only:
        tp_row = tp_kernel_row(run(phase_serve_tp, torch, quant, gpu))
        ce_tp = run(phase_fused_ce_tp, torch, fl, gpu)
        train_tp = run(phase_train_tp, torch, gpu)
        emit({"kernels": [tp_row, fused_ce_tp_row(ce_tp, train_tp)]})
        emit({"phase": "phase_seconds", **seconds})
        return 0
    if args.faults_only:
        fault_phases()
        emit({"phase": "phase_seconds", **seconds})
        return 0
    if args.strategies_only:
        strategy_phases(run, torch, gpu)
        emit({"phase": "phase_seconds", **seconds})
        return 0
    if args.sp_ep_only:
        spep_phases(run, torch, gpu)
        emit({"phase": "phase_seconds", **seconds})
        return 0
    if args.load_only:
        run(phase_serve_1b_from_checkpoint, torch, quant, pa, gpu)
        emit({"phase": "phase_seconds", **seconds})
        return 0
    if args.slo_roles_only:
        run(phase_serve_slo, torch, quant, fa, pa, gpu)
        run(phase_serve_disagg, torch, quant, fa, pa, gpu)
        run(phase_serve_sentry, torch, quant, fa, pa, gpu)
        tp = run(phase_serve_tp, torch, quant, gpu)
        tp["launches"]["world4"] = run(phase_serve_tp_world4, torch, gpu, tp)["int8_tp"]
        run(phase_train_sentry, torch, gpu)
        emit({"kernels": [tp_kernel_row(tp)]})
        emit({"phase": "phase_seconds", **seconds})
        return 0
    if args.lora_only:
        run(phase_serve_lora, torch, quant, fa, pa, gpu)
        run(phase_train_dots_attn, torch, gpu)
        run(phase_train_lora, torch, gpu)
        emit({"phase": "phase_seconds", **seconds})
        return 0
    kern = run(phase_kernels, torch, quant, gpu)
    flash = run(phase_flash, torch, fa, gpu)
    fused = run(phase_fused_ce, torch, fl, gpu)
    ce_tp = run(phase_fused_ce_tp, torch, fl, gpu)
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
    lora = run(phase_serve_lora, torch, quant, fa, pa, gpu)
    faults, paged_faults, fleet = fault_phases()
    slo = run(phase_serve_slo, torch, quant, fa, pa, gpu)
    disagg = run(phase_serve_disagg, torch, quant, fa, pa, gpu)
    sentry = run(phase_serve_sentry, torch, quant, fa, pa, gpu)
    tp = run(phase_serve_tp, torch, quant, gpu)
    tp["launches"]["world4"] = run(phase_serve_tp_world4, torch, gpu, tp)["int8_tp"]
    load = run(phase_serve_1b_from_checkpoint, torch, quant, pa, gpu)
    train_tp = run(phase_train_tp, torch, gpu)
    run(phase_train_card_vs_cpu, torch, gpu)
    base = run(phase_train, torch, gpu)
    train_launches = base["flash"]
    fused_launches = run(phase_train_fused, torch, gpu, base["first_loss"])
    dots_attn = run(phase_train_dots_attn, torch, gpu)
    train_lora = run(phase_train_lora, torch, gpu)
    run(phase_resnet_card_vs_cpu, torch, gpu)
    ddp = run(phase_train_resnet_ddp, torch, gpu)
    run(phase_train_resnet_streaming, torch, gpu)
    guard = run(phase_train_guardrails, torch, gpu)
    train_sentry = run(phase_train_sentry, torch, gpu)
    run(phase_bench_and_scaling, torch, gpu)
    strat = strategy_phases(run, torch, gpu)
    spep = spep_phases(run, torch, gpu)
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
                             "serve_1b_gqa_paged_spec": paged_serve["spec_int8"],
                             "serve_1b_lora": lora["serve_1b_lora"],
                             "serve_1b_lora_composed": lora["int8"],
                             **faults["int8"],
                             **{f"serve_1b_gqa_paged_faults_{a}": r["int8_matmul_launches"]
                                for a, r in paged_faults.items()},
                             **{f"serve_1b_fleet_{leg}": r["int8_matmul_launches"]
                                for leg, r in fleet.items()},
                             **{f"serve_1b_from_checkpoint_{a}": r["int8_matmul_launches"]
                                for a, r in load.items()},
                             **{path: n["int8"] for path, n in slo.items()},
                             **{path: n["int8"] for path, n in disagg.items()},
                             **{path: n["int8"] for path, n in sentry.items()}},
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
            # remat "dots_attn" keeps the flash op's outputs: one forward a
            # layer a step
            "per_step_by_policy": {p: n[kind] for p, n in FLASH_PER_STEP_BY_POLICY.items()},
            "launches_train_760m_dots_attn": dots_attn["flash"][kind],
            # HybridFSDP at 2 layers, a rank's launches in its 2 steps
            "launches_train_lm_hybrid_fsdp_rank0": strat["hybrid"]["flash"][kind],
            # the last strategies, rank 0's launches in its 2 steps: a stage
            # of the pipeline at M 2, Ulysses' inner flash at 8 heads a
            # rank, the MoE blocks' attention (f32: the mma.sync route)
            "launches_train_760m_spmd_pipeline_m2_rank0": spep["pipeline"]["flash"][kind],
            "launches_train_760m_seq_ulysses_rank0": spep["seq"]["ulysses"]["flash"][kind],
            "launches_train_moe_ep_rank0": spep["moe"]["flash"][kind],
        })
        if kind == "fwd":
            # the serving path: 16 launches (one a layer) per whole prefill
            kernels[-1]["launches_by_path"] = {
                "train_760m": train_launches["fwd"],
                "train_760m_dots_attn": dots_attn["flash"]["fwd"],
                "train_lora": train_lora["flash_fwd"],
                "serve_1b_lora_composed": lora["composed_flash_fwd"],
                **{f"serve_1b_prefill_{a}": n for a, n in prefill["launches"].items()},
                **{f"serve_1b_spec_{a}": n for a, n in spec["flash"].items()},
                **faults["flash"],
                **{path: n["flash"] for path, n in {**slo, **disagg, **sentry}.items()
                   if "flash" in n},
                "serve_1b_tp2_roles_rank0": tp["roles_launches"]["flash"]}
            kernels[-1]["serving"] = {
                "launches_per_prefill": SERVE_LAYERS,
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
                             "train_resnet_ddp_fused_adamw": ddp["fused_adamw"],
                             "train_guardrails_resnet18": guard["resnet_guarded_adamw_launches"],
                             "train_guardrails_760m": guard["guard_760m_adamw_launches"],
                             "train_sentry_resnet18": train_sentry["fused_adamw"],
                             "train_lora_masked": train_lora["fused_adamw"],
                             "train_resnet50_pipeline_adamw": strat["pipeline"]["adamw_launches"],
                             "train_resnet18_fsdp_adamw_rank0": strat["fsdp"]["adamw_launches"],
                             "train_lm_hybrid_fsdp_rank0": strat["hybrid"]["fused_adamw"],
                             "train_760m_spmd_pipeline_m2_rank0": spep["pipeline"]["fused_adamw"],
                             "train_760m_seq_ring_rank0": spep["seq"]["ring"]["fused_adamw"],
                             "train_760m_seq_ulysses_rank0": spep["seq"]["ulysses"]["fused_adamw"],
                             "train_moe_ep_rank0": spep["moe"]["fused_adamw"]},
        "fsdp_shards": {**strat["fsdp"]["adamw_shards"],
                        "work": "one FSDP rank's update at world 2: 1 launch over its ResNet-18 "
                                "shards and the replicated leaves"},
        "lora_factor_leaves": {
            "ms": train_lora["adamw_ms"], "plain_ms": train_lora["adamw_plain_ms"],
            "bound_ms": train_lora["adamw_bound_ms"], "bound_by": "bytes",
            "elements": train_lora["elements"],
            "work": "one masked fine-tune step: 1 launch over the 28 factor leaves of "
                    "train_lora's 2-layer model"},
        "ms_by_flag": adamw_row["ms_by_flag"], "flag_checks": adamw_row["flag_checks"],
        "finite_flag_ms": adamw_row["finite_flag_ms"],
        "finite_flag_bound_ms": adamw_row["finite_flag_bound_ms"],
        "guarded_760m_step_ms": guard["guard_760m_step_ms"],
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
                             "serve_1b_gqa_paged_spec": paged_serve["spec"],
                             "serve_1b_lora_composed": lora["composed_paged"],
                             **{f"serve_1b_gqa_paged_faults_{a}": r["paged_attention_launches"]
                                for a, r in paged_faults.items()},
                             "serve_1b_from_checkpoint_hf": load["hf"]["paged_attention_launches"],
                             **{path: n["paged"] for path, n in {**slo, **disagg, **sentry}.items()
                                if "paged" in n},
                             "serve_1b_tp2_roles_rank0": tp["roles_launches"]["paged"]},
        "verify": {k: paged["results"][("1b-gqa-verify", "f32", "f32")][k] * 16
                   for k in ("ms", "plain_ms", "bound_ms")}
        | {"bound_by": paged["results"][("1b-gqa-verify", "f32", "f32")]["bound_by"],
           "work": "one 1b-gqa verify forward: 16 calls at B=4 S=3 H=16 KV=4 D=128, depths "
                   "(34, 498, 1518, 40), f32"},
        "stale_nan_checks": paged["stale_nan"],
        "splice": {k: paged["results"][("1b-gqa-splice", "f32", "f32")][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        | {"work": "one call at B=1 S=256 H=16 KV=4 D=128 from depth 96, f32, in row "
                   "blocks"},
    })
    kernels.append(tp_kernel_row(tp))
    kernels.append(fused_ce_tp_row(ce_tp, train_tp))
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
