"""``python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.train_llm_mfu
[--sweep] [--preset 350m] [--remat] [--fused] [--json PATH] [--device cpu]``:
LM train-step MFU, one point or the sweep grid.

The twin of the JAX package's ``scripts/train_llm_mfu.py``: the
measurement is :func:`..bench.lm_headline.measure` (one copy of the
method: eager chains timed with CUDA events, PaLM model FLOPs over the
card's bf16 peak); this script owns the grid and the CLI defaults (350m,
seq 2048, batch 8, 8-step chains, min of 3). ``--sweep`` runs
:data:`SWEEP` (presets, remat policy, batch; every row ``--fused`` when
given) and writes an ``llm_mfu_sweep`` receipt; one point writes an
``lm_headline`` receipt, and ``--fused`` runs the baseline and fused arms
side by side. A sweep row that fails (out of memory) is recorded as data.
The JAX grid's ``block_q`` / ``block_k`` are Pallas tilings: the CUDA
flash kernels tile by 64 x 64 whatever they say (``bench.lm_headline``'s
``BLOCK_NOTE``), so the grid varies the rest; ``--no_scan`` is the port's
only layout. Runs on ``cuda`` unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import sys

# (preset, seq, batch, remat, remat_policy): the JAX grid's points less
# their block sizes
SWEEP = [
    ("350m", 2048, 8, True, "dots"),
    ("350m", 2048, 4, True, "dots"),
    ("350m", 2048, 8, True, None),
    ("125m", 2048, 32, True, None),
    ("125m", 2048, 16, True, "dots"),
    ("760m", 2048, 2, True, None),
    ("760m", 2048, 2, True, "dots"),
]


def parse(argv=None):
    from pytorch_distributed_training_tutorials_tpu_torch.bench.lm_headline import PRESETS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", choices=sorted(PRESETS), default="350m")
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--attn", choices=["dense", "flash"], default="flash")
    p.add_argument("--block_q", type=int, default=512)
    p.add_argument("--block_k", type=int, default=512)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat_policy", choices=["dots", "dots_attn"], default=None)
    p.add_argument("--steps", type=int, default=8, help="steps a timed chain")
    p.add_argument("--reps", type=int, default=3, help="timed chains (min taken)")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--mem_only", action="store_true")
    p.add_argument("--fused", action="store_true",
                   help="the fused tail (fused loss + fused AdamW)")
    p.add_argument("--sweep", action="store_true", help="run the grid instead of one point")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no GPU and no --device cpu raises")
    p.add_argument("--json", default=None, help="write the receipt here")
    args = p.parse_args(argv)
    args.no_scan = True  # the port's one layout
    return args


def main(argv=None) -> dict:
    from pytorch_distributed_training_tutorials_tpu_torch.bench.lm_headline import measure
    from pytorch_distributed_training_tutorials_tpu_torch.obs import make_receipt, write_receipt

    args = parse(argv)
    if args.sweep:
        results = []
        for preset, seq, batch, remat, policy in SWEEP:
            a = argparse.Namespace(**{**vars(args), "preset": preset, "seq": seq,
                                      "batch": batch, "remat": remat,
                                      "remat_policy": policy})
            try:
                r = measure(a)
            except Exception as e:  # an out-of-memory point is data, not a crash
                r = {"preset": preset, "seq": seq, "batch": batch, "remat": remat,
                     "remat_policy": policy, "error": f"{type(e).__name__}: {str(e)[:200]}"}
                _free(args.device)
            results.append(r)
            print(json.dumps(r), flush=True)
        receipt = make_receipt("llm_mfu_sweep", {"results": results},
                               device=args.device or "cuda")
    elif args.fused:
        base = argparse.Namespace(**{**vars(args), "fused": False})
        receipt = make_receipt("lm_headline", {"baseline": measure(base), "fused": measure(args)},
                               device=args.device or "cuda")
        print(json.dumps(receipt))
    else:
        receipt = make_receipt("lm_headline", measure(args), device=args.device or "cuda")
        print(json.dumps(receipt))
    write_receipt(args.json, receipt)
    if args.json:
        print(f"results -> {args.json}")
    return receipt


def _free(device) -> None:
    import gc

    import torch

    gc.collect()
    if (device or "cuda") != "cpu":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
    sys.exit(0)
