"""``python -m pytorch_distributed_training_tutorials_tpu_torch.serve
--selftest [--paged [--paged-kernel] [--kv-bits 8|4]] [--device cpu]``:
end-to-end smoke of the port's serving path.

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

Prints one JSON line (``"ok": true`` when every check held) and exits 0,
or 1 when a check failed. Runs on ``cuda`` unless ``--device`` names
another device.
"""

from __future__ import annotations

import argparse
import json
import sys


def selftest(device=None, paged: bool = False, paged_kernel: bool = False,
             kv_bits: int | None = None) -> dict:
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
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    if (args.paged_kernel or args.kv_bits) and not args.paged:
        ap.error("--paged-kernel and --kv-bits need --paged")
    receipt = selftest(args.device, paged=args.paged,
                       paged_kernel=args.paged_kernel, kv_bits=args.kv_bits)
    print(json.dumps(receipt))
    return 0 if receipt["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
