"""``python -m pytorch_distributed_training_tutorials_tpu_torch.serve
--selftest [--paged [--paged-kernel] [--kv-bits 8|4]] [--prefix] [--chunk]
[--flash] [--spec-k K [--spec-ngram N]] [--pipeline-depth D] [--device
cpu]``: end-to-end smoke of the port's serving path.

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

Prints one JSON line (``"ok": true`` when every check held) and exits 0,
or 1 when a check failed. Runs on ``cuda`` unless ``--device`` names
another device.
"""

from __future__ import annotations

import argparse
import json
import sys


def selftest(device=None, paged: bool = False, paged_kernel: bool = False,
             kv_bits: int | None = None, prefix: bool = False, chunk: bool = False,
             flash: bool = False, spec_k: int = 0, spec_ngram: int = 3,
             pipeline_depth: int = 1) -> dict:
    import numpy as np
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        generate,
        init_quantized_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.serve import (
        QueueFull,
        Request,
        ServeEngine,
    )

    dev = resolve_device(device)
    problems: list[str] = []
    cfg = TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64,
        quantized=True,
    )
    params = init_quantized_lm(cfg, seed=0, device=dev)
    model = TransformerLM(cfg)
    engine = ServeEngine(
        model, params, n_slots=2, tokens_per_launch=8, max_queue=2,
        device=dev,
    )
    rng = np.random.Generator(np.random.PCG64(1))
    prompts = [
        (rng.integers(0, cfg.vocab_size, p_len).tolist(), max_new)
        for p_len, max_new in [(3, 9), (7, 12), (5, 1), (12, 6), (2, 17)]
    ]
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
    return {
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
        "problems": problems,
    }


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
                       pipeline_depth=args.pipeline_depth)
    print(json.dumps(receipt))
    return 0 if receipt["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
