"""``python -m pytorch_distributed_training_tutorials_tpu_torch.serve
--selftest [--device cpu]``: end-to-end smoke of the port's serving path.

A toy int8 LM serves a staggered stream of mixed-length requests through
:class:`.engine.ServeEngine` (2 slots, a queue bound of 2 so backpressure
fires); every completion must equal the port's ``generate`` token for
token, and the host syncs must stay within one per chain plus one per
prefill. Prints one JSON line (``"ok": true`` when every check held) and
exits 0, or 1 when a check failed. Runs on ``cuda`` unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import json
import sys


def selftest(device=None) -> dict:
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
        "problems": problems,
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
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    receipt = selftest(args.device)
    print(json.dumps(receipt))
    return 0 if receipt["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
