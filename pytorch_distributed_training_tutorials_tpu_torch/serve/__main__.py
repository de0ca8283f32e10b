"""``python -m pytorch_distributed_training_tutorials_tpu_torch.serve
--selftest [--paged [--paged-kernel] [--kv-bits 8|4]] [--prefix] [--chunk]
[--flash] [--spec-k K [--spec-ngram N]] [--pipeline-depth D] [--adapters
N] [--chaos] [--flight] [--router] [--tp N [--tp-backend gloo|nccl]]
[--slo] [--sentry] [--device cpu] [--json PATH]``: end-to-end smoke of the
port's serving path.

A toy int8 LM serves a staggered stream of mixed-length requests through
:class:`.engine.ServeEngine` (2 slots, a queue bound of 2 so backpressure
fires); every completion must equal the port's ``generate`` token for
token, and the host syncs must stay within one per chain plus one per
prefill.

``--paged`` adds the paged arm (a toy subset of the JAX package's): a
mixed stream at an OVERSUBSCRIBED slot count (3 slots of 64-token windows
over a pool of 6 pages of 8 tokens) through a paged engine with the
``--paged-kernel`` read path and ``--kv-bits`` storage. Its tokens must be
byte-identical to the whole-slot engine's at the same storage, host syncs
within one per chain plus one per prefill, a request that could never fit
the pool must shed at submit, and no page may leak. Then the paged-
attention read path at f32 must be token-exact to the gather path, and an
int4 pool's ``page_bytes`` exactly half an int8 pool's.

``--prefix`` adds the prefix-cache arm (the JAX selftest's): six requests
sharing a 16-token head with their own tails through 2 slots, with the
cache off and on. The tokens must be byte-identical, the hit rate above 0,
at least one splice, fewer prefills with the cache on, and the host syncs
exactly chains + prefills + splices. With ``--paged`` it adds the paged
leg: the same stream over a page pool with the cache on (through the
paged-attention kernel, splices included, with ``--paged-kernel``) —
token-exact to the whole-slot engine, donor pages shared (``pages_shares`` > 0), and no
page left in use once the drained engine's index lets its segments go.

``--chunk`` adds the chunked-prefill arm: ``prefill_chunk=8`` on a stream
whose longest prompt is 12 tokens; at least one chunk, tokens equal to the
unchunked run, and the host syncs still one per chain plus one per
prefill (a chunked prompt's mid chunks make none).

``--flash`` adds the flash-prefill arm: the same model with
``attention_fn=flash_attention`` serves the stream, and each request's
teacher-forced logits (``ServeEngine.teacher_forced_logits``) are held
against the dense-prefill engine's within 4% of their logit scale.

``--spec-k K`` adds the speculative arm (the JAX selftest's
``run_spec_stream``): a templated stream (a 5-token template tiled 3-4
times, the prompt-lookup workload) through a ``speculative_k=K`` engine
and a plain one. The greedy tokens must be byte-identical, the host syncs
one per chain plus one per prefill, the mean accepted length above 1 and
the verify forwards fewer than the tokens emitted.

``--pipeline-depth D`` (> 1) adds the pipelined arm (the JAX selftest's
``--pipeline``): the staggered stream again through a ``pipeline_depth=D``
engine with chunks of 8 (and ``speculative_k=K`` with ``--spec-k``). Its
tokens must equal the serial engine's, the host syncs stay one per chain
plus one per prefill, and the stream's 12-token prompt must be chunked.

``--adapters N`` (>= 2) adds the multi-tenant arm (the JAX selftest's):
a bank of N rows, N - 1 tenants with distinct seeded factors, the
staggered stream with ids ``i % N`` through one engine. Every request's
tokens must equal a dedicated single-tenant engine's, id 0's the
bank-less engine's; the host syncs stay one per chain plus one per
prefill; an unregistered id raises at submit.

``--chaos`` adds the failure-handling arm (the JAX selftest's): a guarded
engine with ``ChaosConfig(nan_logit_slot=0, nan_logit_step=3)`` and a
recorder that dumps to a temporary file serves two requests, a third
whose 1 µs deadline has passed when it is popped and a fourth cancelled
while queued, then ``drain()``. The poisoned request must complete
``"nonfinite"`` with a strict prefix of a clean guarded run's tokens, its
neighbour equal to the clean run, the deadline and cancel victims with no
tokens; ``submit`` after the drain raises ``QueueClosed``; host syncs
exactly chains + prefills + splices; ``fault_stats()`` one quarantine, one
expiry, one cancel; at least two dumps, one naming the quarantined slot.
Then a training leg: ``Trainer(skip_nonfinite=True,
chaos=ChaosConfig(nan_batch_step=3), flight=...)`` on a small MLP for one
epoch must skip exactly one step, one update short, with one
``step_skipped`` event at step 3.

``--flight`` adds the flight-recorder arm: the staggered stream again
through an engine with a ``FlightRecorder``. Tokens and host syncs must
equal the base run's, every request must have a full span (submit, pop,
first token, completion), the event counts must reconcile with the
engine's counters and the spans' times with the completions', and the
histograms' p50/p95 of latency and TTFT must be within one bucket of the
sorted values.

``--router`` adds the fleet arm: three engines (one slot, chains of 4)
behind a ``FleetRouter``, each with its recorder on a shared epoch, serve
the staggered stream plus two copies of its first request. Leg 1, no
fault: every request equal to the base run. Leg 2, ``FleetChaosConfig``
kills the first request's affine replica at its second chain (it holds
work in flight and queued): the ledger verifies, the replica is dead,
work moved or died with it, every request that finished equals leg 1,
and the host syncs are the sum of the replicas' chains + prefills +
splices, the killed replica's frozen at its kill.

``--tp N`` adds the tensor-parallel arm (the JAX selftest's): N spawned
ranks (``--tp-backend``: gloo on the CPU; on cards NCCL, or gloo where
ranks share a card) each build the sharded engine over the same weights
and serve the base stream. Every rank's greedy tokens must equal the
replicated base run's, each rank's host syncs its budget and the base
run's count, its KV bytes below the unsharded engine's, and
``audit_decode()`` clean (an ``all_reduce`` per row-parallel projection
and one logits ``all_gather`` per forward, nothing else).

``--slo`` adds the SLO arm (the JAX selftest's twelfth): a
``priority_classes=2`` engine decodes a class-1 request on its only slot
when a class-0 request arrives; the engine must preempt (swap the victim
out, ``n_swaps_out``), serve the class-0 request and swap the victim back
in, both token-exact to ``generate``, with host syncs exactly chains +
prefills + splices + swaps out — and its contract sentry balanced (no
violation), its fetches equal to a ``Tensor.cpu`` spy laid under it and
to those syncs. A chaos leg (``preempt_at_chain``) force-preempts a slot
of a 2-slot engine with no pressure: both requests' tokens equal a clean
run's. A host leg: ``PriorityScheduler(n_classes=1)`` pops what
``FifoScheduler`` pops over the same submissions.

``--sentry`` adds the contract-sentry arm (the JAX selftest's eleventh):
an engine with a :class:`..obs.sentry.ContractSentry` and a dumping
recorder serves the base stream (warmup), ``mark_steady``, then serves it
again: tokens equal the base run's, no steady recompile, no violation,
no re-upload, and the sentry's fetches equal a ``Tensor.cpu`` spy laid
under it, its budgeted count and the engine's ``n_host_syncs`` (chains +
prefills). Then three injected violations, each exactly one typed event
and one ``graft-flightlog/v1`` dump naming its trigger: a post-steady
native library load through the real loader (on a card a kernel library
through ``ops/_build.py``, on the CPU the host gather through
``data/native.py``), a stray fetch inside one step round through a leaky
``_sweep`` (a ``.item()`` of a device tensor on a card, a ``.cpu()`` on
the CPU), and a numpy leaf in a checked tree, its device twin silent.

Prints one JSON line, a ``graft-receipt/v1`` envelope of kind
``serve_selftest`` validated before it is reported (``"ok": true`` when
every check held), and exits 0, or 1 when a check failed; ``--json PATH``
also writes it there. Runs on ``cuda`` unless ``--device`` names another
device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def selftest(device=None, paged: bool = False, paged_kernel: bool = False,
             kv_bits: int | None = None, prefix: bool = False, chunk: bool = False,
             flash: bool = False, spec_k: int = 0, spec_ngram: int = 3,
             pipeline_depth: int = 1, adapters: int = 0, chaos: bool = False,
             flight: bool = False, router: bool = False, tp: int = 0,
             tp_backend: str | None = None, slo: bool = False,
             sentry: bool = False, json_path: str | None = None) -> dict:
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        generate,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs import make_receipt, validate_receipt
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    dev = resolve_device(device)
    problems: list[str] = []
    cfg = TransformerConfig(**SELFTEST_CFG, quantized=True)
    params = init_quantized_lm(cfg, seed=0, device=dev)
    model = TransformerLM(cfg)
    engine = ServeEngine(
        model, params, n_slots=2, tokens_per_launch=8, max_queue=2,
        device=dev,
    )
    prompts = _base_prompts(cfg.vocab_size)
    completions, backpressured = _base_stream(engine, prompts)
    if len(completions) != len(prompts):
        problems.append(
            f"{len(completions)} completions for {len(prompts)} requests"
        )
    budget = engine.n_chains + engine.n_prefills
    if engine.n_host_syncs != budget:
        problems.append(
            f"{engine.n_host_syncs} host syncs != {budget} "
            f"({engine.n_chains} chains + {engine.n_prefills} prefills)"
        )
    mismatches = 0
    for rid, (toks, max_new) in enumerate(prompts):
        ref = generate(model, None, [toks], max_new, device=dev)
        ref = ref[0, len(toks):].tolist()
        got = completions[rid].tokens if rid in completions else None
        if got != ref:
            mismatches += 1
            problems.append(f"request {rid}: engine {got} != generate {ref}")
    paged_fields = paged_arm(model, params, dev, paged_kernel, kv_bits, problems) if paged else {}
    prefix_fields = (prefix_arm(model, params, dev, paged, paged_kernel, problems)
                     if prefix else {})
    chunk_fields = chunk_arm(model, params, dev, problems) if chunk else {}
    flash_fields = flash_arm(model, params, dev, problems) if flash else {}
    spec_fields = spec_arm(model, params, dev, spec_k, spec_ngram, problems) if spec_k else {}
    pipeline_fields = (
        pipeline_arm(model, params, dev, prompts, completions, pipeline_depth, spec_k,
                     spec_ngram, problems)
        if pipeline_depth > 1 else {}
    )
    adapter_fields = (adapter_arm(model, params, dev, prompts, completions, adapters,
                                  problems) if adapters else {})
    fault_fields = chaos_arm(model, params, dev, prompts, problems) if chaos else {}
    flight_fields = (flight_arm(model, params, dev, prompts, completions, problems)
                     if flight else {})
    router_fields = (router_arm(model, params, dev, prompts, completions, problems)
                     if router else {})
    tp_fields = (tp_arm(dev, tp, tp_backend, completions, engine.n_host_syncs, problems)
                 if tp > 1 else {})
    slo_fields = slo_arm(model, params, dev, prompts, completions, problems) if slo else {}
    sentry_fields = (sentry_arm(model, params, dev, prompts, completions, problems)
                     if sentry else {})
    payload = {
        "selftest": "serve_torch",
        "ok": not problems,
        "device": str(dev),
        "device_name": (
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        ),
        "requests": len(prompts),
        "completions": len(completions),
        "mismatches": mismatches,
        "n_chains": engine.n_chains,
        "n_prefills": engine.n_prefills,
        "n_host_syncs": engine.n_host_syncs,
        "backpressured": backpressured,
        "generated_tokens": engine.generated_tokens,
        **paged_fields,
        **prefix_fields,
        **chunk_fields,
        **flash_fields,
        **spec_fields,
        **pipeline_fields,
        **adapter_fields,
        **fault_fields,
        **flight_fields,
        **router_fields,
        **tp_fields,
        **slo_fields,
        **sentry_fields,
        "problems": problems,
    }
    # the graft-receipt/v1 envelope, validated before it is reported
    receipt = make_receipt("serve_selftest", payload, device=dev)
    problems.extend(validate_receipt(receipt, kind="serve_selftest"))
    receipt["ok"] = not problems
    receipt["problems"] = problems
    if json_path:
        with open(json_path, "w") as f:
            json.dump(receipt, f, indent=2)
            f.write("\n")
    return receipt


# the toy int8 LM every arm serves (weights: init_quantized_lm, seed 0)
SELFTEST_CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)


def _base_prompts(vocab: int) -> list:
    import numpy as np

    rng = np.random.Generator(np.random.PCG64(1))
    return [(rng.integers(0, vocab, p_len).tolist(), max_new)
            for p_len, max_new in [(3, 9), (7, 12), (5, 1), (12, 6), (2, 17)]]


def _base_stream(engine, prompts) -> tuple[dict, bool]:
    """The base arm's staggered stream: two requests up front, the rest as
    the bounded queue admits them. Returns ``(completions by id,
    backpressured)``."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import QueueFull, Request

    completions = {}
    backpressured = False
    for toks, max_new in prompts[:2]:
        engine.submit(Request(prompt=toks, max_new_tokens=max_new))
    pending = list(prompts[2:])
    while not engine.idle or pending:
        while pending:
            toks, max_new = pending[0]
            try:
                engine.submit(Request(prompt=toks, max_new_tokens=max_new))
                pending.pop(0)
            except QueueFull:
                backpressured = True
                break
        for c in engine.step():
            completions[c.request_id] = c
    return completions, backpressured


def tp_rank(strategy, device: str) -> dict:
    """One rank of the ``--tp`` arm (run by :func:`..parallel.tensor_parallel.spawn_tp`):
    the sharded engine over the base arm's weights serving the base
    stream; returns its tokens, syncs, ``tp_stats()`` and audit."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    cfg = TransformerConfig(**SELFTEST_CFG, quantized=True)
    params = init_quantized_lm(cfg, seed=0, device=device)
    engine = ServeEngine(TransformerLM(cfg), params, n_slots=2, tokens_per_launch=8,
                         max_queue=2, device=device, strategy=strategy)
    completions, _ = _base_stream(engine, _base_prompts(cfg.vocab_size))
    return {"tokens": {rid: c.tokens for rid, c in completions.items()},
            "host_syncs": engine.n_host_syncs,
            "budget": engine.n_chains + engine.n_prefills,
            "tp_stats": engine.tp_stats(), "audit": engine.audit_decode()}


def tp_arm(dev, tp: int, backend: str | None, completions: dict, base_syncs: int,
           problems: list) -> dict:
    """The ``--tp`` checks (module docstring), on ``tp`` spawned ranks."""
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
        spawn_tp,
    )
    # by its package path, so the spawned ranks import it as a module
    from pytorch_distributed_training_tutorials_tpu_torch.serve import __main__ as selftest_mod

    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    ranks = spawn_tp(selftest_mod.tp_rank, tp, (dev.type,), backend=backend, device=dev.type)
    want = {rid: c.tokens for rid, c in completions.items()}
    for r, got in enumerate(ranks):
        if got["tokens"] != want:
            problems.append(f"tp rank {r}: tokens {got['tokens']} != replicated {want}")
        if got["host_syncs"] != got["budget"] or got["host_syncs"] != base_syncs:
            problems.append(f"tp rank {r}: {got['host_syncs']} host syncs, budget "
                            f"{got['budget']}, replicated {base_syncs}")
        st = got["tp_stats"]
        if not st["tp_kv_bytes_per_chip"] < st["tp_kv_bytes_global"]:
            problems.append(f"tp rank {r}: KV bytes per chip {st['tp_kv_bytes_per_chip']} "
                            f"not below the global {st['tp_kv_bytes_global']}")
        if not got["audit"]["ok"]:
            problems.append(f"tp rank {r}: audit_decode {got['audit']['problems']}")
    return {"tp": tp, "tp_backend": backend,
            "tp_host_syncs": [g["host_syncs"] for g in ranks],
            "tp_kv_bytes_per_chip": ranks[0]["tp_stats"]["tp_kv_bytes_per_chip"],
            "tp_kv_bytes_global": ranks[0]["tp_stats"]["tp_kv_bytes_global"],
            "tp_collectives": ranks[0]["audit"]["collectives"]}


def _budget(eng) -> int:
    return eng.n_chains + eng.n_prefills + eng.n_splices


@contextlib.contextmanager
def _cpu_spy():
    """A ``Tensor.cpu`` spy for the block (laid under a sentry installed
    inside it): yields ``{"n": calls}``, restores what it replaced."""
    import torch

    had, real = "cpu" in torch.Tensor.__dict__, torch.Tensor.cpu
    count = {"n": 0}

    def spy(t, *a, **k):
        count["n"] += 1
        return real(t, *a, **k)

    torch.Tensor.cpu = spy
    try:
        yield count
    finally:
        if had:
            torch.Tensor.cpu = real
        else:
            del torch.Tensor.cpu


def _native_reload(dev) -> str:
    """Load one native library again through its real loader: on a card a
    kernel library (``ops/_build.py``, forgotten and loaded back by
    ``library``), on the CPU the host gather (``data/native.py``, its
    cached handle forgotten). Returns the library's name ("" when the
    host gather cannot be built here)."""
    if dev.type == "cuda":
        from pytorch_distributed_training_tutorials_tpu_torch.ops import _build

        _build._libs.pop("fused_adamw", None)
        _build.library("fused_adamw")
        return "fused_adamw"
    from pytorch_distributed_training_tutorials_tpu_torch.data import native

    native._tried, native._lib = False, None
    return "fastgather" if native.native_available() else ""


def sentry_arm(model, params, dev, prompts, completions, problems: list) -> dict:
    """The ``--sentry`` checks (module docstring; the JAX selftest's
    eleventh arm, ``serve/__main__.py:1315-1500``)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.obs.flight import (
        FlightRecorder,
        load_flightlog,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs.sentry import ContractSentry
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    fd, dump = tempfile.mkstemp(suffix=".flightlog.jsonl")
    os.close(fd)
    fl = FlightRecorder(capacity=256, dump_path=dump)
    sen = ContractSentry(flight=fl)
    eng = ServeEngine(model, params, n_slots=2, tokens_per_launch=8, max_queue=2, device=dev,
                      flight=fl, sentry=sen)
    with _cpu_spy() as spy:
        sen.install()  # ON the spy: every .cpu flows sentry -> spy -> real
        try:
            _base_stream(eng, prompts)  # warmup
            # the injections' operands, made before the steady mark
            stray = torch.zeros((), device=dev)
            twin = {"w": torch.ones((4, 4), device=dev)}
            sen.mark_steady()
            got, _ = _base_stream(eng, prompts)
            base = len(prompts)  # the warmup took ids 0 .. N-1
            exact = all(got[base + rid].tokens == c.tokens for rid, c in completions.items())
            if not exact:
                problems.append("sentry arm: the instrumented engine changed greedy tokens")
            if sen.n_steady_recompiles or sen.n_budget_violations or sen.n_reuploads:
                problems.append(f"sentry arm: clean stream {sen.summary()}")
            budget = eng.n_chains + eng.n_prefills
            if not sen.n_fetched == spy["n"] == sen.n_budgeted == eng.n_host_syncs == budget:
                problems.append(f"sentry arm: fetch accounting disagrees — sentry "
                                f"{sen.n_fetched} fetched / {sen.n_budgeted} budgeted, spy "
                                f"{spy['n']}, engine {eng.n_host_syncs}, budget {budget}")
            clean = dict(sen.summary())
            # violation 1: a post-steady native load through the real loader
            library = _native_reload(dev)
            recompile_caught = bool(library) and sen.n_steady_recompiles == 1
            if not recompile_caught:
                problems.append(f"sentry arm: a steady native load of {library!r} counted "
                                f"{sen.n_steady_recompiles} times (want 1)")
            # violation 2: a stray fetch inside ONE step round
            orig = eng._sweep

            def leaky_sweep():
                stray.item() if dev.type == "cuda" else stray.cpu()
                return orig()

            eng.submit(Request(prompt=prompts[0][0], max_new_tokens=3))
            eng._sweep = leaky_sweep
            eng.step()
            eng._sweep = orig
            while not eng.idle:
                eng.step()
            budget_caught = sen.n_budget_violations == 1
            if not budget_caught:
                problems.append(f"sentry arm: the stray fetch flagged "
                                f"{sen.n_budget_violations} rounds (want 1)")
            # violation 3: a numpy leaf fires, its device twin is silent
            sen.check_args({"w": np.ones((4, 4), np.float32)}, label="selftest_numpy",
                           device=dev)
            twin_bytes = sen.check_args(twin, label="selftest_numpy", device=dev)
            reupload_caught = sen.n_reuploads == 1 and twin_bytes == 0
            if not reupload_caught:
                problems.append(f"sentry arm: {sen.n_reuploads} re-uploads, {twin_bytes} B "
                                "on the device twin (want 1 and 0)")
        finally:
            sen.uninstall()
    snaps = load_flightlog(dump)
    os.unlink(dump)
    for reason, check in (("compile", lambda t: t.get("steady") is True),
                          ("budget_violation",
                           lambda t: t.get("fetched", 0) > t.get("budgeted", 0)),
                          ("reupload", lambda t: t.get("label") == "selftest_numpy")):
        hits = [x for x in snaps if x["reason"] == reason]
        if len(hits) != 1 or not check(hits[0].get("trigger") or {}):
            problems.append(f"sentry arm: {len(hits)} {reason!r} dumps "
                            f"({[x.get('trigger') for x in hits]}); want one naming it")
    return {**clean, "sentry_token_exact": exact, "sentry_spy_fetches": spy["n"],
            "sentry_injected_recompile_caught": recompile_caught,
            "sentry_injected_library": library,
            "sentry_injected_budget_caught": budget_caught,
            "sentry_injected_reupload_caught": reupload_caught,
            "sentry_dump_snapshots": len(snaps)}


def slo_arm(model, params, dev, prompts, completions, problems: list) -> dict:
    """The ``--slo`` checks (module docstring; the JAX selftest's twelfth
    arm, ``serve/__main__.py:104-120``)."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        FifoScheduler,
        PriorityScheduler,
        Request,
        ServeEngine,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs.sentry import ContractSentry
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

    (lo_toks, lo_new), (hi_toks, hi_new) = prompts[4], prompts[3]  # 2 + 17, 12 + 6
    sen = ContractSentry()
    eng = ServeEngine(model, params, n_slots=1, tokens_per_launch=8, priority_classes=2,
                      device=dev, sentry=sen)
    with _cpu_spy() as spy, sen:
        lo = eng.submit(Request(prompt=lo_toks, max_new_tokens=lo_new, priority=1))
        done = {c.request_id: c for c in eng.step()}  # its prefill and first chain
        hi = eng.submit(Request(prompt=hi_toks, max_new_tokens=hi_new, priority=0))
        done.update((c.request_id, c) for c in eng.run_until_idle())
    if eng.n_swaps_out < 1 or eng.n_swaps_in < 1:
        problems.append(f"slo arm: no preemption (swaps out {eng.n_swaps_out}, in "
                        f"{eng.n_swaps_in})")
    # the base stream's requests 4 and 3 are these prompts, served unpreempted
    exact = (done[lo].tokens == completions[4].tokens
             and done[hi].tokens == completions[3].tokens)
    if not exact:
        problems.append(f"slo arm: preemption changed tokens: {done[lo].tokens}, "
                        f"{done[hi].tokens}")
    if not done[hi].latency_s < done[lo].latency_s:
        problems.append("slo arm: the class-0 request did not finish first")
    budget = _budget(eng) + eng.n_swaps_out
    if eng.n_host_syncs != budget:
        problems.append(f"slo arm: {eng.n_host_syncs} host syncs != {budget} (chains + "
                        "prefills + splices + swaps out)")
    # the sentry half: every swap fetch went through the budgeted _fetch
    if sen.n_budget_violations or not sen.n_fetched == spy["n"] == sen.n_budgeted == budget:
        problems.append(f"slo arm: sentry {sen.n_fetched} fetched / {sen.n_budgeted} "
                        f"budgeted ({sen.n_budget_violations} violations), spy {spy['n']}, "
                        f"budget {budget}")

    def pair(**kw):
        e = ServeEngine(model, params, n_slots=2, tokens_per_launch=8, device=dev, **kw)
        prio = 1 if kw else 0
        ids = [e.submit(Request(prompt=t, max_new_tokens=n, priority=prio))
               for t, n in ((lo_toks, lo_new), (hi_toks, hi_new))]
        out = {c.request_id: c.tokens for c in e.run_until_idle()}
        return e, [out[i] for i in ids]

    _, clean = pair()
    forced, chaotic = pair(priority_classes=2,
                           chaos=ChaosConfig(preempt_slot=0, preempt_at_chain=1))
    if forced.n_swaps_out != 1:
        problems.append(f"slo arm: the chaos preempt fired {forced.n_swaps_out} times")
    if chaotic != clean:
        problems.append(f"slo arm: the forced preempt changed tokens: {chaotic} vs {clean}")
    scheds = [FifoScheduler(64, max_queue=16), PriorityScheduler(64, 16, n_classes=1)]
    for sch in scheds:
        for toks, new in prompts:
            sch.submit(Request(prompt=toks, max_new_tokens=new))
    orders = [[sch.pop(fits=lambda r: len(r.prompt) < 10).request_id
               for _ in range(3)] for sch in scheds]
    if orders[0] != orders[1]:
        problems.append(f"slo arm: one-class pop order {orders[1]} != FIFO {orders[0]}")
    return {"slo_swaps_out": eng.n_swaps_out, "slo_swaps_in": eng.n_swaps_in,
            "slo_token_exact": exact, "slo_host_syncs": eng.n_host_syncs,
            "slo_chaos_exact": chaotic == clean, "slo_fifo_order": orders[0] == orders[1],
            "slo_sentry_fetched": sen.n_fetched,
            "slo_sentry_violations": sen.n_budget_violations}


def chaos_arm(model, params, dev, prompts, problems: list) -> dict:
    """The ``--chaos`` checks (module docstring)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.data import (
        ArrayDataset,
        ShardedLoader,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.models import MLP
    from pytorch_distributed_training_tutorials_tpu_torch.obs import (
        FlightRecorder,
        load_flightlog,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import LocalMesh
    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        QueueClosed,
        Request,
        ServeEngine,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, sgd
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

    p0, p1 = prompts[0][0], prompts[1][0]
    ref_eng = ServeEngine(model, params, n_slots=2, tokens_per_launch=4, device=dev,
                          guard_nonfinite=True)
    for p, n in ((p0, 12), (p1, 16)):
        ref_eng.submit(Request(prompt=p, max_new_tokens=n))
    ref = {c.request_id: c.tokens for c in ref_eng.run_until_idle()}
    fd, dump_path = tempfile.mkstemp(suffix=".flightlog.jsonl")
    os.close(fd)
    try:
        eng = ServeEngine(model, params, n_slots=2, tokens_per_launch=4, device=dev,
                          guard_nonfinite=True,
                          chaos=ChaosConfig(nan_logit_slot=0, nan_logit_step=3),
                          flight=FlightRecorder(capacity=128, dump_path=dump_path))
        r0 = eng.submit(Request(prompt=p0, max_new_tokens=12))
        r1 = eng.submit(Request(prompt=p1, max_new_tokens=16))
        r2 = eng.submit(Request(prompt=p0, max_new_tokens=8, deadline_s=1e-6))
        r3 = eng.submit(Request(prompt=p1, max_new_tokens=8))
        eng.cancel(r3)
        out = {c.request_id: c for c in eng.drain()}
        try:
            eng.submit(Request(prompt=p0, max_new_tokens=2))
            problems.append("chaos arm: submit admitted after close()")
        except QueueClosed:
            pass
        snaps = load_flightlog(dump_path)
    finally:
        os.unlink(dump_path)
    if out[r0].finish_reason != "nonfinite":
        problems.append(f"chaos arm: the poisoned slot finished {out[r0].finish_reason!r}")
    exact = (out[r0].tokens == ref[0][:len(out[r0].tokens)]
             and len(out[r0].tokens) < len(ref[0]) and out[r1].tokens == ref[1])
    if not exact:
        problems.append(f"chaos arm: tokens diverged from the clean run: poisoned "
                        f"{out[r0].tokens} vs {ref[0]}, neighbour {out[r1].tokens} vs {ref[1]}")
    if out[r2].finish_reason != "deadline" or out[r2].tokens:
        problems.append(f"chaos arm: the deadline request finished {out[r2].finish_reason!r} "
                        f"with {len(out[r2].tokens)} tokens")
    if out[r3].finish_reason != "cancelled" or out[r3].tokens:
        problems.append(f"chaos arm: the cancelled request finished {out[r3].finish_reason!r}")
    if eng.n_host_syncs != _budget(eng):
        problems.append(f"chaos arm: {eng.n_host_syncs} host syncs != {_budget(eng)} "
                        "(chains + prefills + splices)")
    fstats = eng.stats("fault")
    for key in ("nonfinite_quarantined", "deadline_expired", "cancelled"):
        if fstats[key] != 1:
            problems.append(f"chaos arm: fault_stats[{key!r}] = {fstats[key]}, expected 1")
    named = any((s["trigger"] or {}).get("fault_kind") == "nonfinite"
                and s["trigger"].get("slot") == 0 for s in snaps)
    if len(snaps) < 2 or not named:
        problems.append(f"chaos arm: {len(snaps)} flight dumps (want >= 2, one naming slot 0)")
    # the training leg: one poisoned batch skipped, one flight event
    rng = np.random.Generator(np.random.PCG64(3))
    x = rng.standard_normal((64, 8)).astype(np.float32)
    y = rng.integers(0, 4, 64).astype(np.int64)
    rec = FlightRecorder(capacity=64)
    trainer = Trainer(MLP(features=(16, 4), in_dim=8),
                      ShardedLoader(ArrayDataset((x, y)), 16, LocalMesh(torch.device(dev)),
                                    seed=0),
                      sgd(0.05), quiet=True, skip_nonfinite=True,
                      chaos=ChaosConfig(nan_batch_step=3), flight=rec)
    trainer.train(1)
    skipped = trainer.steps_skipped
    events = [e["step"] for e in rec.events if e["kind"] == "step_skipped"]
    if skipped != 1 or int(trainer.state.step) != 3 or events != [3]:
        problems.append(f"chaos arm: training leg skipped {skipped} steps, step "
                        f"{int(trainer.state.step)} after 4 dispatches, step_skipped events "
                        f"{events} (want 1, 3, [3])")
    return {**fstats, "steps_skipped": skipped, "chaos_token_exact": exact,
            "chaos_host_syncs": eng.n_host_syncs, "chaos_flight_dumps": len(snaps),
            "chaos_flight_named_slot": named, "chaos_step_skipped_events": events}


def _staggered(eng, prompts) -> dict:
    """The base stream's submission pattern (two at once, the rest as the
    queue bound admits them); completions by request id."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import QueueFull, Request

    done = {}
    pending = list(prompts)
    for toks, max_new in pending[:2]:
        eng.submit(Request(prompt=toks, max_new_tokens=max_new))
    pending = pending[2:]
    while not eng.idle or pending:
        while pending:
            toks, max_new = pending[0]
            try:
                eng.submit(Request(prompt=toks, max_new_tokens=max_new))
                pending.pop(0)
            except QueueFull:
                break
        for c in eng.step():
            done[c.request_id] = c
    return done


def flight_arm(model, params, dev, prompts, completions, problems: list) -> dict:
    """The ``--flight`` checks (module docstring): ``prompts`` and
    ``completions`` are the base run's."""
    import math

    from pytorch_distributed_training_tutorials_tpu_torch.obs import FlightRecorder
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    rec = FlightRecorder(capacity=256)
    eng = ServeEngine(model, params, n_slots=2, tokens_per_launch=8, max_queue=2, device=dev,
                      flight=rec)
    done = _staggered(eng, prompts)
    if {r: c.tokens for r, c in done.items()} != {r: c.tokens for r, c in completions.items()}:
        problems.append("flight arm: the recorder changed greedy tokens")
    if eng.n_host_syncs != _budget(eng):
        problems.append(f"flight arm: {eng.n_host_syncs} host syncs != {_budget(eng)}")
    spans = {s["rid"]: s for s in rec.done_spans}
    keys = ("submit_t", "queue_pop_t", "prefill_t", "complete_t", "finish_reason")
    span_full = len(spans) == len(prompts) and all(all(k in s for k in keys)
                                                   for s in spans.values())
    if not span_full:
        problems.append(f"flight arm: incomplete spans: {sorted(spans)}")
    kc = rec.kind_counts
    events_ok = (kc["submit"] == kc["queue_pop"] == kc["complete"] == len(prompts)
                 and kc["prefill"] == eng.n_prefills
                 and kc["chain_start"] == kc["chain_end"] == eng.n_chains)
    if not events_ok:
        problems.append(f"flight arm: event counts {dict(kc)} do not reconcile with "
                        f"{eng.n_prefills} prefills / {eng.n_chains} chains")
    recon = span_full and all(abs(spans[r]["e2e_s"] - c.latency_s) < 1e-5
                              and abs(spans[r]["ttft_s"] - c.ttft_s) < 1e-5
                              for r, c in done.items())
    if span_full and not recon:
        problems.append("flight arm: span timings diverge from the completions'")

    def within_a_bucket(h, vals):
        ok = True
        for q in (0.50, 0.95):
            sv = sorted(vals)[max(1, math.ceil(q * len(vals))) - 1]
            ok = ok and abs(h.quantile(q) - sv) <= h.rel_error_bound * max(sv, h.min_value) + 1e-9
        return ok

    hist_ok = (within_a_bucket(rec.hist["e2e"], [c.latency_s for c in done.values()])
               and within_a_bucket(rec.hist["ttft"], [c.ttft_s for c in done.values()]))
    if not hist_ok:
        problems.append("flight arm: histogram p50/p95 outside one bucket of the sort")
    return {"flight_requests": len(prompts), "flight_span_full": span_full,
            "flight_events_consistent": events_ok, "flight_hist_vs_sort": hist_ok,
            "flight_host_syncs": eng.n_host_syncs, **eng.stats("flight")}


def router_arm(model, params, dev, prompts, completions, problems: list) -> dict:
    """The ``--router`` checks (module docstring)."""
    import time

    from pytorch_distributed_training_tutorials_tpu_torch.obs import FlightRecorder
    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        FleetRouter,
        Request,
        ServeEngine,
        affinity_hash,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import FleetChaosConfig

    n_replicas = 3
    stream = list(prompts) + [prompts[0], prompts[0]]
    expected = {g: completions[g].tokens for g in range(len(prompts))}
    expected[len(prompts)] = expected[len(prompts) + 1] = completions[0].tokens
    kill_target = affinity_hash(prompts[0][0], adapter=0, depth=16) % n_replicas

    def run_fleet(fleet_chaos):
        t0 = time.perf_counter()
        engines = [ServeEngine(model, params, n_slots=1, tokens_per_launch=4, max_queue=8,
                               device=dev, flight=FlightRecorder(capacity=256, t0=t0))
                   for _ in range(n_replicas)]
        fr = FleetRouter(engines, chaos=fleet_chaos, flight=FlightRecorder(capacity=256, t0=t0))
        for toks, max_new in stream:
            fr.submit(Request(prompt=toks, max_new_tokens=max_new))
        return fr, engines, {c.request_id: c for c in fr.run_until_idle()}

    fr_ok, eng_ok, out_ok = run_fleet(None)
    fleet_exact = len(out_ok) == len(stream) and all(
        out_ok[g].tokens == expected[g] and out_ok[g].finish_reason == "length"
        for g in expected)
    if not fleet_exact:
        problems.append("router arm: the fault-free fleet diverged from the single engine: "
                        f"{[(g, c.finish_reason) for g, c in sorted(out_ok.items())]}")
    if fr_ok.ledger.verify():
        problems.append(f"router arm: fault-free ledger: {fr_ok.ledger.verify()}")
    fr_x, eng_x, out_x = run_fleet(FleetChaosConfig(kill_replica=kill_target, kill_at_chain=2))
    if len(out_x) != len(stream):
        problems.append(f"router arm: {len(out_x)} completions for {len(stream)} requests")
    if fr_x.ledger.verify():
        problems.append(f"router arm: chaos ledger: {fr_x.ledger.verify()}")
    if fr_x.replica_states()[kill_target] != "dead":
        problems.append(f"router arm: the killed replica {kill_target} is "
                        f"{fr_x.replica_states()[kill_target]!r}")
    if fr_x.ledger.n_redispatched + fr_x.n_dead_completions < 1:
        problems.append("router arm: the killed replica held no work")
    router_exact = all(c.tokens == expected[g] for g, c in out_x.items()
                       if c.finish_reason in ("length", "eos"))
    if not router_exact:
        problems.append("router arm: a re-dispatched request diverged from the fault-free run")
    syncs = sum(e.n_host_syncs for e in eng_x)
    budget = sum(_budget(e) for e in eng_x)
    if syncs != budget or eng_x[kill_target].n_chains > 2:
        problems.append(f"router arm: {syncs} host syncs vs the summed budget {budget}; the "
                        f"killed replica ran {eng_x[kill_target].n_chains} chains")
    if (fr_x.fleet_flight_summary() or {}).get("e2e_count", 0) < 1:
        problems.append("router arm: the fleet flight summary recorded no request")
    rstats = fr_x.stats()
    return {"router_requests": len(stream), "router_fleet_exact": fleet_exact and router_exact,
            "router_host_syncs_ok": sum(e.n_host_syncs for e in eng_ok),
            "router_host_syncs_chaos": syncs, "router_killed_replica": kill_target,
            **{f"router_{k}": v for k, v in rstats.items()
               if isinstance(v, (int, float, bool))}}


def adapter_arm(model, params, dev, prompts, completions, n_adapters: int,
                problems: list) -> dict:
    """The ``--adapters`` checks (module docstring); appends to
    ``problems`` and returns the receipt fields."""
    import numpy as np
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.adapters import AdapterBank
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine

    bank = AdapterBank(model, n_adapters=n_adapters, rank=4, device=dev)
    rng = np.random.Generator(np.random.PCG64(5))
    base_row = {k: rng.standard_normal(tuple(v.shape)) * 0.5
                for k, v in bank.row_zeros().items()}
    for aid in range(1, n_adapters):
        # distinct factors per tenant (scaled copies: cheap, different)
        sign = 1.0 if aid % 2 else -1.0
        bank.register(f"tenant-{aid}", {k: torch.tensor(v * sign / aid, dtype=torch.float32)
                                        for k, v in base_row.items()})
    ids = [i % n_adapters for i in range(len(prompts))]

    def run(rows, with_bank: bool):
        eng = ServeEngine(model, params, n_slots=2, tokens_per_launch=8, device=dev,
                          adapter_bank=bank if with_bank else None)
        rids = [eng.submit(Request(prompt=prompts[i][0], max_new_tokens=prompts[i][1],
                                   adapter=ids[i] if with_bank else 0)) for i in rows]
        done = {c.request_id: c.tokens for c in eng.run_until_idle()}
        return eng, [done[r] for r in rids]

    every = list(range(len(prompts)))
    eng, mixed = run(every, True)
    for aid in range(n_adapters):
        rows = [i for i in every if ids[i] == aid]
        if rows and run(rows, True)[1] != [mixed[i] for i in rows]:
            problems.append(f"adapter {aid}: mixed-tenant tokens differ from a dedicated engine's")
    base = [i for i in every if ids[i] == 0]
    if [mixed[i] for i in base] != [completions[i].tokens for i in base]:
        problems.append("adapter 0 tokens differ from the bank-less engine's")
    budget = eng.n_chains + eng.n_prefills
    if eng.n_host_syncs != budget:
        problems.append(f"adapter arm: {eng.n_host_syncs} host syncs != {budget}")
    try:
        eng.submit(Request(prompt=[1, 2], max_new_tokens=2, adapter=n_adapters))
        problems.append(f"unregistered adapter id {n_adapters} admitted at submit")
    except ValueError:
        pass
    tenants_differ = sum(mixed[i] != completions[i].tokens for i in every if ids[i])
    if not tenants_differ:
        problems.append("no tenant request's tokens differ from the base model's")
    stats = eng.adapter_stats()
    if stats["adapter_requests"] < 1:
        problems.append(f"no tenant traffic recorded: {stats}")
    return {"adapter_n_host_syncs": eng.n_host_syncs, "adapter_tenants_differ": tenants_differ,
            **stats}


def paged_arm(model, params, dev, paged_kernel: bool, kv_bits, problems: list) -> dict:
    """The ``--paged`` checks (module docstring); appends to ``problems``
    and returns the arm's receipt fields."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        PoolExhausted,
        Request,
        ServeEngine,
    )

    rng = np.random.Generator(np.random.PCG64(2))
    reqs = [
        (rng.integers(0, model.cfg.vocab_size, p_len).tolist(), max_new)
        for p_len, max_new in [(3, 9), (17, 12), (5, 5), (12, 6), (2, 17), (9, 14)]
    ]
    geometry = dict(paged=True, page_size=8, pool_pages=6)

    def run(**kw):
        eng = ServeEngine(model, params, n_slots=3, tokens_per_launch=8, device=dev, **kw)
        ids = [eng.submit(Request(prompt=t, max_new_tokens=m)) for t, m in reqs]
        done = {c.request_id: c.tokens for c in eng.run_until_idle()}
        return eng, [done.get(i) for i in ids]

    _, toks_ws = run(kv_bits=kv_bits)
    eng, toks = run(kv_bits=kv_bits, paged_kernel=paged_kernel, **geometry)
    if toks != toks_ws:
        problems.append(f"paged engine changed greedy tokens: {toks} != {toks_ws}")
    if eng.n_host_syncs != eng.n_chains + eng.n_prefills:
        problems.append(
            f"paged arm: {eng.n_host_syncs} host syncs != {eng.n_chains} chains "
            f"+ {eng.n_prefills} prefills"
        )
    shed = False
    try:  # fits the 64-token window, never the 48-token pool
        eng.submit(Request(prompt=reqs[1][0] * 2, max_new_tokens=30))
        problems.append("pool-exceeding request admitted at submit")
    except PoolExhausted:
        shed = True
    stats = eng.page_stats()
    if stats["pages_in_use"] != 0:
        problems.append(f"paged arm: {stats['pages_in_use']} pages leaked")
    _, toks_gather = run(**geometry)
    _, toks_kernel = run(paged_kernel=True, **geometry)
    kernel_exact = toks_kernel == toks_gather
    if not kernel_exact:
        problems.append(
            f"paged kernel path changed greedy tokens at f32: {toks_kernel} != "
            f"{toks_gather}"
        )
    pb = {bits: ServeEngine(model, params, n_slots=3, device=dev, kv_bits=bits,
                            **geometry).page_stats()["page_bytes"] for bits in (8, 4)}
    if 2 * pb[4] != pb[8]:
        problems.append(f"int4 page_bytes {pb[4]} is not half of int8's {pb[8]}")
    return {
        "paged_requests": len(reqs),
        "paged_token_exact": toks == toks_ws,
        "paged_shed_ok": shed,
        "paged_kernel_token_exact_f32": kernel_exact,
        "paged_int4_page_bytes_halved": 2 * pb[4] == pb[8],
        "paged_n_host_syncs": eng.n_host_syncs,
        **stats,
    }


def _stream(engine, reqs) -> list:
    """Submit ``reqs`` ((prompt, max_new) pairs), drain; tokens in submit
    order."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request

    ids = [engine.submit(Request(prompt=t, max_new_tokens=m)) for t, m in reqs]
    done = {c.request_id: c.tokens for c in engine.run_until_idle()}
    return [done.get(i) for i in ids]


def _overlap_stream(vocab: int, seed: int, tails) -> list:
    """(prompt, max_new) pairs: one shared 16-token head, then each
    request's own tail of the given length."""
    import numpy as np

    rng = np.random.Generator(np.random.PCG64(seed))
    shared = rng.integers(0, vocab, 16).tolist()
    return [(shared + rng.integers(0, vocab, t).tolist(), m) for t, m in tails]


def prefix_arm(model, params, dev, paged: bool, paged_kernel: bool, problems: list) -> dict:
    """The ``--prefix`` checks (module docstring), and with ``paged`` the
    paged leg; appends to ``problems`` and returns the arm's fields."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    reqs = _overlap_stream(model.cfg.vocab_size, 3,
                           [(3, 8), (5, 6), (2, 10), (4, 7), (3, 5), (6, 9)])

    def run(**kw):
        eng = ServeEngine(model, params, n_slots=2, tokens_per_launch=8, device=dev, **kw)
        return eng, _stream(eng, reqs)

    off, toks_off = run()
    on, toks_on = run(prefix_cache_bytes=16 * 1024 * 1024)
    stats = on.prefix_stats()
    if toks_on != toks_off:
        problems.append(f"prefix cache changed greedy tokens: {toks_on} != {toks_off}")
    if stats["prefix_hit_rate"] <= 0 or on.n_splices < 1:
        problems.append(f"no prefix hits on an overlapping stream: {stats}")
    if on.n_prefills >= off.n_prefills:
        problems.append(f"prefix cache saved no prefills: {on.n_prefills} on vs "
                        f"{off.n_prefills} off")
    budget = on.n_chains + on.n_prefills + on.n_splices
    if on.n_host_syncs != budget:
        problems.append(f"prefix arm: {on.n_host_syncs} host syncs != {budget} "
                        f"({on.n_chains} chains + {on.n_prefills} prefills + "
                        f"{on.n_splices} splices)")
    out = {"prefix_token_exact": toks_on == toks_off, "prefix_n_splices": on.n_splices,
           "prefix_n_prefills": [off.n_prefills, on.n_prefills],
           "prefix_n_host_syncs": on.n_host_syncs, **stats}
    if paged:
        eng, toks = run(prefix_cache_bytes=16 * 1024 * 1024, paged=True, page_size=8,
                        pool_pages=24, paged_kernel=paged_kernel)
        pstats = eng.page_stats()
        if toks != toks_off:
            problems.append(f"paged prefix cache changed greedy tokens: {toks} != {toks_off}")
        if pstats["pages_shares"] <= 0 or eng.n_splices < 1:
            problems.append(f"paged prefix leg shared no pages: {pstats}")
        while eng.prefix.evict_coldest():
            pass
        in_use = eng.page_stats()["pages_in_use"]
        if in_use:
            problems.append(f"paged prefix leg: {in_use} pages leaked")
        out.update({"paged_prefix_token_exact": toks == toks_off,
                    "paged_prefix_n_splices": eng.n_splices,
                    "paged_prefix_pages_shares": pstats["pages_shares"],
                    "paged_prefix_pages_in_use": in_use})
    return out


def chunk_arm(model, params, dev, problems: list) -> dict:
    """The ``--chunk`` checks (module docstring)."""
    import numpy as np

    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    rng = np.random.Generator(np.random.PCG64(4))
    reqs = [(rng.integers(0, model.cfg.vocab_size, p).tolist(), m)
            for p, m in [(12, 6), (3, 9), (10, 5), (7, 8), (12, 4)]]
    runs = {}
    for chunk in (0, 8):
        eng = ServeEngine(model, params, n_slots=2, tokens_per_launch=8, device=dev,
                          prefill_chunk=chunk)
        runs[chunk] = (eng, _stream(eng, reqs))
    eng, toks = runs[8]
    if toks != runs[0][1]:
        problems.append(f"chunked prefill changed greedy tokens: {toks} != {runs[0][1]}")
    if eng.n_chunks < 1:
        problems.append("no prompt was chunked")
    if eng.n_host_syncs != eng.n_chains + eng.n_prefills:
        problems.append(f"chunk arm: {eng.n_host_syncs} host syncs != {eng.n_chains} "
                        f"chains + {eng.n_prefills} prefills")
    return {"chunk_token_exact": toks == runs[0][1], "chunk_n_chunks": eng.n_chunks,
            "chunk_n_host_syncs": eng.n_host_syncs}


# teacher-forced logits of the flash arm within this share of the dense
# engine's largest |logit| (chip_smoke.py's gate)
FLASH_TF_BOUND = 0.04


def flash_arm(model, params, dev, problems: list) -> dict:
    """The ``--flash`` checks (module docstring)."""
    import dataclasses

    from pytorch_distributed_training_tutorials_tpu_torch.models import TransformerLM
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    flash_model = TransformerLM(dataclasses.replace(model.cfg, attention_fn=flash_attention))
    reqs = _overlap_stream(model.cfg.vocab_size, 5, [(3, 8), (9, 6), (20, 10), (30, 7)])
    dense = ServeEngine(model, params, n_slots=2, tokens_per_launch=8, device=dev)
    flash = ServeEngine(flash_model, params, n_slots=2, tokens_per_launch=8, device=dev)
    toks = _stream(flash, reqs)
    if any(t is None for t in toks):
        problems.append("flash arm: not every request completed")
        return {"flash_teacher_forced_ok": False}
    worst = 0.0
    for (prompt, _), got in zip(reqs, toks):
        ref = dense.teacher_forced_logits(prompt, got)
        out = flash.teacher_forced_logits(prompt, got)
        worst = max(worst, float((ref - out).abs().max()) / float(ref.abs().max()))
    ok = worst <= FLASH_TF_BOUND
    if not ok:
        problems.append(f"flash prefill's teacher-forced logits differ by {worst:.3g} of "
                        f"the dense scale (> {FLASH_TF_BOUND})")
    return {"flash_teacher_forced_ok": ok, "flash_teacher_forced_share": worst,
            "flash_bound_share": FLASH_TF_BOUND}


def spec_arm(model, params, dev, k: int, ngram: int, problems: list) -> dict:
    """The ``--spec-k`` checks (module docstring)."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    template = [7, 8, 9, 10, 11]
    reqs = [(template * reps + [20 + i], new)
            for i, (reps, new) in enumerate([(4, 18), (3, 14), (4, 20), (3, 16)])]
    runs = {}
    for kk in (0, k):
        eng = ServeEngine(model, params, n_slots=2, tokens_per_launch=8, device=dev,
                          speculative_k=kk, spec_ngram=ngram)
        runs[kk] = (eng, _stream(eng, reqs))
    eng, toks = runs[k]
    stats = eng.spec_stats()
    exact = toks == runs[0][1]
    if not exact:
        problems.append(f"speculation changed greedy tokens: {toks} != {runs[0][1]}")
    if eng.n_host_syncs != eng.n_chains + eng.n_prefills:
        problems.append(f"spec arm: {eng.n_host_syncs} host syncs != {eng.n_chains} chains "
                        f"+ {eng.n_prefills} prefills")
    if stats["spec_mean_accepted_len"] <= 1.0:
        problems.append(f"drafting never helped on a repetitive stream: {stats}")
    if stats["n_verify_forwards"] >= eng.generated_tokens:
        problems.append(f"{stats['n_verify_forwards']} verify forwards >= "
                        f"{eng.generated_tokens} tokens emitted: speculation saved no step")
    return {"spec_requests": len(reqs), "spec_token_exact": exact,
            "spec_n_host_syncs": eng.n_host_syncs, "spec_generated_tokens": eng.generated_tokens,
            **stats}


def pipeline_arm(model, params, dev, prompts, completions, depth: int, spec_k: int,
                 ngram: int, problems: list) -> dict:
    """The ``--pipeline-depth`` checks (module docstring): ``prompts`` and
    ``completions`` are the serial stream's."""
    from pytorch_distributed_training_tutorials_tpu_torch.serve import ServeEngine

    eng = ServeEngine(model, params, n_slots=2, tokens_per_launch=8, device=dev,
                      pipeline_depth=depth, prefill_chunk=8, speculative_k=spec_k,
                      spec_ngram=ngram)
    toks = _stream(eng, prompts)
    serial = [completions[i].tokens if i in completions else None
              for i in range(len(prompts))]
    exact = toks == serial
    if not exact:
        problems.append(f"pipelined engine changed greedy tokens: {toks} != {serial}")
    budget = eng.n_chains + eng.n_prefills + eng.n_splices
    if eng.n_host_syncs != budget:
        problems.append(f"pipeline arm: {eng.n_host_syncs} host syncs != {eng.n_chains} "
                        f"chains + {eng.n_prefills} prefills + {eng.n_splices} splices "
                        "(chunks must add none)")
    stats = eng.pipeline_stats()
    if stats["n_chunks"] < 1:
        problems.append(f"chunked prefill never fired on a 12-token prompt: {stats}")
    return {"pipeline_requests": len(prompts), "pipeline_token_exact": exact,
            "pipeline_n_host_syncs": eng.n_host_syncs, "pipeline_n_chains": eng.n_chains,
            "pipeline_speculative_k": spec_k, **stats}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_training_tutorials_tpu_torch.serve"
    )
    ap.add_argument(
        "--selftest", action="store_true",
        help="serve a toy int8 LM stream and check it token for token "
        "against generate",
    )
    ap.add_argument(
        "--device", default=None,
        help="device to run on (default cuda; 'cpu' for a CPU run)",
    )
    ap.add_argument(
        "--json", default=None, help="also write the receipt to this path",
    )
    ap.add_argument(
        "--paged", action="store_true",
        help="add the paged-KV arm: an oversubscribed stream over a page pool",
    )
    ap.add_argument(
        "--paged-kernel", action="store_true",
        help="the paged arm reads the pool through the paged-attention kernel",
    )
    ap.add_argument(
        "--kv-bits", type=int, choices=(8, 4), default=None,
        help="KV storage of the paged arm: int8 or int4 (default float32)",
    )
    ap.add_argument(
        "--prefix", action="store_true",
        help="add the prefix-cache arm (with --paged, its paged leg too)",
    )
    ap.add_argument(
        "--chunk", action="store_true",
        help="add the chunked-prefill arm (prefill_chunk=8)",
    )
    ap.add_argument(
        "--flash", action="store_true",
        help="add the flash-prefill arm, teacher-forced against dense prefill",
    )
    ap.add_argument(
        "--spec-k", type=int, default=0,
        help="add the speculative arm with this many draft tokens a verify step",
    )
    ap.add_argument(
        "--spec-ngram", type=int, default=3,
        help="n-gram of the speculative draft (default 3)",
    )
    ap.add_argument(
        "--pipeline-depth", type=int, default=1,
        help="add the pipelined arm at this depth (> 1), with chunks of 8",
    )
    ap.add_argument(
        "--adapters", type=int, default=0,
        help="add the multi-tenant LoRA arm with a bank of this many rows (>= 2)",
    )
    ap.add_argument(
        "--chaos", action="store_true",
        help="add the failure-handling arm: quarantine, deadline, cancel, drain, a "
        "skipped training step, with the recorder's dumps",
    )
    ap.add_argument(
        "--flight", action="store_true",
        help="add the flight-recorder arm: spans, event counts and histograms",
    )
    ap.add_argument(
        "--router", action="store_true",
        help="add the fleet arm: three engines behind a FleetRouter, one chaos-killed",
    )
    ap.add_argument(
        "--tp", type=int, default=0,
        help="add the tensor-parallel arm at this width: spawned ranks serving the base "
             "stream through ServeEngine(strategy=)",
    )
    ap.add_argument(
        "--tp-backend", choices=("gloo", "nccl"), default=None,
        help="the TP arm's backend (default: gloo on the CPU, nccl on cards; gloo where "
             "ranks share a card)",
    )
    ap.add_argument(
        "--slo", action="store_true",
        help="add the SLO arm: a class-0 arrival preempts a class-1 request (KV swap "
             "out and in), token-exact, its sentry balanced, and the chaos force-preempt",
    )
    ap.add_argument(
        "--sentry", action="store_true",
        help="add the contract-sentry arm: a clean steady stream whose fetches balance, "
             "then an injected native load, stray fetch and numpy leaf, one dump each",
    )
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    if (args.paged_kernel or args.kv_bits) and not args.paged:
        ap.error("--paged-kernel and --kv-bits need --paged")
    receipt = selftest(args.device, paged=args.paged,
                       paged_kernel=args.paged_kernel, kv_bits=args.kv_bits,
                       prefix=args.prefix, chunk=args.chunk, flash=args.flash,
                       spec_k=args.spec_k, spec_ngram=args.spec_ngram,
                       pipeline_depth=args.pipeline_depth, adapters=args.adapters,
                       chaos=args.chaos, flight=args.flight, router=args.router,
                       tp=args.tp, tp_backend=args.tp_backend, slo=args.slo,
                       sentry=args.sentry, json_path=args.json)
    print(json.dumps(receipt))
    return 0 if receipt["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
