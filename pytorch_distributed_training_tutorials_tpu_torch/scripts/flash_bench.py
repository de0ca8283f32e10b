"""``python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.flash_bench
[--seqs 1024 2048 4096] [--b 2 --h 8 --d 64] [--out FLASH.md] [--device cpu]``:
dense causal attention against the flash kernels across sequence lengths.

The twin of the JAX package's ``scripts/flash_bench.py``: at (B, S, H, D)
bf16 (float32 on the CPU, which has no bf16 flash route), the float
model's dense attention (:func:`..models.transformer.dense_causal_attention`:
the (B, H, S, S) float32 scores materialized) and the flash op
(:func:`..ops.flash_attention.flash_attention`: kernels 3-5 on the card),
forward and full backward with a fixed random cotangent (a sum loss would
let the dense backward simplify). Each time is the min of 3 chains of
``N`` = 16 applications, timed with CUDA events and closed by a sync (the
host clock on the CPU); peak memory is ``torch.cuda.max_memory_allocated``
over one forward + backward above what was allocated before it (not
measured on the CPU). Writes a markdown table to ``--out`` (default: only
printed) stamped with the card's ``nvidia-smi`` name and power limit, or
``cpu``. Runs on ``cuda`` unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import sys
import time

N = 16  # chain length


def bench(seqs=(1024, 2048, 4096), b: int = 2, h: int = 8, d: int = 64, device=None) -> dict:
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
        dense_causal_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs.receipt import environment_stamp
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    stamp = environment_stamp(device=dev)

    def chain_ms(step) -> float:
        best = float("inf")
        step()  # first launches, kernel builds
        for _ in range(3):
            if on_card:
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            for _ in range(N):
                step()
            if on_card:
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end))
            else:
                best = min(best, (time.perf_counter() - t0) * 1e3)
        return best / N

    def peak_mb(step) -> float | None:
        if not on_card:
            return None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e6

    rows = []
    for s in seqs:
        gen = torch.Generator(device=dev).manual_seed(s)
        q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
                      for _ in range(4))
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        err = float((flash_attention(q, k, v).float()
                     - dense_causal_attention(q, k, v).float()).abs().max())
        row = {"S": s}
        for name, fn in (("dense", dense_causal_attention), ("flash", flash_attention)):
            def fwd(fn=fn):
                with torch.no_grad():
                    return fn(q, k, v)

            def fwd_bwd(fn=fn):
                return torch.autograd.grad(fn(qg, kg, vg), (qg, kg, vg), g)

            row[f"{name}_fwd_ms"] = chain_ms(fwd)
            row[f"{name}_fwd_bwd_ms"] = chain_ms(fwd_bwd)
            row[f"{name}_peak_mb"] = peak_mb(fwd_bwd)
        row["max_abs_err"] = err
        rows.append(row)
    return {"shape": {"B": b, "H": h, "D": d}, "dtype": str(dtype).removeprefix("torch."),
            "chain": N, "device": str(dev), "device_name": stamp["device_name"],
            "nvidia_smi": stamp["nvidia_smi"], "rows": rows}


def markdown(res: dict) -> str:
    card = res["nvidia_smi"] or res["device_name"]
    sh = res["shape"]
    lines = [
        f"# Flash attention against dense causal attention — {card}",
        "",
        f"Shapes (B={sh['B']}, S, H={sh['H']}, D={sh['D']}) {res['dtype']}; device: {card}. "
        f"Times: min of 3 chains of {res['chain']} applications "
        f"({'CUDA events' if res['device'] != 'cpu' else 'host clock'}); the backward takes a "
        "fixed random cotangent. Peak: max allocated over one forward + backward above what "
        "was allocated before it.",
        "",
        "| S | dense fwd ms | flash fwd ms | dense fwd+bwd ms | flash fwd+bwd ms "
        "| dense peak MB | flash peak MB | max abs err |",
        "|---|---|---|---|---|---|---|---|",
    ]

    def mb(x):
        return "not measured" if x is None else f"{x:.1f}"

    for r in res["rows"]:
        lines.append(f"| {r['S']} | {r['dense_fwd_ms']:.4f} | {r['flash_fwd_ms']:.4f} "
                     f"| {r['dense_fwd_bwd_ms']:.4f} | {r['flash_fwd_bwd_ms']:.4f} "
                     f"| {mb(r['dense_peak_mb'])} | {mb(r['flash_peak_mb'])} "
                     f"| {r['max_abs_err']:.3g} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seqs", type=int, nargs="+", default=[1024, 2048, 4096])
    ap.add_argument("--b", type=int, default=2)
    ap.add_argument("--h", type=int, default=8)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--out", default=None, help="write the markdown table here")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no GPU and no --device cpu raises")
    args = ap.parse_args(argv)
    text = markdown(bench(tuple(args.seqs), args.b, args.h, args.d, args.device))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
