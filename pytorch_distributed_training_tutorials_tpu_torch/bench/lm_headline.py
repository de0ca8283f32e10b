"""LM train-step MFU: the transformer training headline, on the card.

Port of ``pytorch_distributed_training_tutorials_tpu/bench/lm_headline.py``
(same flags and defaults): the 760m preset (vocab 32768, d_model 1536, 24
layers, 16 heads of 96, d_ff 6144), seq 2048, batch 2, bfloat16 compute on
float32 params, flash attention (the hand-written kernels of
:mod:`..ops.flash_attention`), ``remat=True`` with ``remat_policy="dots"``,
unrolled layers, ``adamw(3e-4, weight_decay=0.01)`` and cross entropy. The
batch is drawn with numpy from ``PCG64(0)`` exactly as the JAX bench draws
it, and repeats every step.

A chain is ``--steps`` eager steps, timed with CUDA events and closed with
one ``.item()`` of the last loss; the first chain is the warmup, then
``--reps`` timed chains, min taken. MFU is the PaLM-convention model FLOPs
(:func:`..models.utils.model_flops_per_token`) over the card's dense bf16
peak, keyed by its device name (989 TFLOP/s for the H100 SXM data sheet;
``null`` for a card not in :data:`PEAK_BF16`). Peak memory is
``torch.cuda.max_memory_allocated`` over the timed chains.

``--fused`` also runs the fused-tail arm — the logits-free loss
(``loss="fused_cross_entropy"``: the model returns its hidden states and
the kernels of :mod:`..ops.fused_loss` stream them against the lm_head
weight) and ``fused_adamw`` (the one-pass kernel of
:mod:`..ops.fused_optim`) — on the same model, batch and chains, and
prints both arms, ``{"baseline": ..., "fused": ...}``, as the JAX bench
does. Each arm records its kernels' launches.

``--n_layers`` keeps the preset's widths at another depth (a shorter
run). ``--trace`` profiles one more step (:func:`..bench.harness.trace_step`:
busy and idle share, kernels, the top kernels) and classifies that same
trace with :class:`..obs.trace.StepReport`: ``trace_report`` (its
``to_dict()``), ``trace_step_ms`` (the step's device time) and
``trace_mfu`` (the model FLOPs over that time), as the JAX bench reports
them; and beside them each port kernel's launches in the trace against
the launch counters over the same step.

The result goes out as a ``graft-receipt/v1`` envelope of kind
``lm_headline`` (:func:`..obs.receipt.make_receipt`: the environment
stamp carries the torch and CUDA versions and the card's ``nvidia-smi``
name and power limit), printed as one JSON line and, with ``--json``,
validated and written (:func:`..obs.receipt.write_receipt`).

Runs on ``cuda`` unless ``--device cpu`` is given (then every number is a
host number: no MFU, no device memory). ``--scan`` (the JAX ``nn.scan``
layout) is not in the port and raises.

    python -m pytorch_distributed_training_tutorials_tpu_torch.bench.lm_headline [--fused] [--json out.json]
    python -m pytorch_distributed_training_tutorials_tpu_torch.bench.lm_headline \\
        --device cpu --preset smoke --seq 64 --batch 2 --steps 2 --reps 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from pytorch_distributed_training_tutorials_tpu_torch.bench.harness import trace_step

PRESETS = {
    # name: (d_model, n_layers, n_heads, vocab)
    "smoke": (64, 2, 4, 256),
    "125m": (768, 12, 12, 32768),
    "350m": (1024, 24, 16, 32768),
    "760m": (1536, 24, 16, 32768),
}

# dense bf16 tensor-core peak by device name (NVIDIA data sheets)
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}

BLOCK_NOTE = (
    "the CUDA flash kernels tile by 64 x 64 whatever --block_q/--block_k "
    "say; these set only the plain (CPU) version's blocks"
)


def _shape(args) -> tuple[int, int, int, int]:
    """(d_model, n_layers, n_heads, vocab): the preset's, its depth cut to
    ``--n_layers`` when given."""
    d_model, n_layers, n_heads, vocab = PRESETS[args.preset]
    return d_model, getattr(args, "n_layers", None) or n_layers, n_heads, vocab


def build(args, device):
    import numpy as np
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        bind_params,
        init_lm,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        make_flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import (
        TrainState,
        _train_step_fn,
    )

    d_model, n_layers, n_heads, vocab = _shape(args)
    attention_fn = None
    if args.attn == "flash":
        attention_fn = make_flash_attention(args.block_q, args.block_k)
    cfg = TransformerConfig(
        vocab_size=vocab, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
        max_seq_len=args.seq, dtype=torch.bfloat16, remat=args.remat,
        remat_policy=args.remat_policy, attention_fn=attention_fn,
        quantized=False,
    )
    model = TransformerLM(cfg)
    bind_params(model, init_lm(cfg, seed=0, device=device))
    tx = (fused_adamw if args.fused else adamw)(3e-4, weight_decay=0.01)
    state = TrainState.create(model=model, tx=tx)
    rng = np.random.Generator(np.random.PCG64(0))
    toks = torch.as_tensor(
        rng.integers(0, vocab, (args.batch, args.seq + 1)), dtype=torch.int64,
        device=device,
    )
    batch = (toks[:, :-1], toks[:, 1:])
    step_fn = _train_step_fn("fused_cross_entropy" if args.fused else "cross_entropy")
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = vocab * d_model  # tok_emb; lm_head is a matmul and counts
    return model, state, batch, step_fn, n_params, n_embed


def measure(args) -> dict:
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.models.utils import (
        model_flops_per_token,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs import MinOfN
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_loss import (
        fused_cross_entropy,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw

    if not args.no_scan:
        raise NotImplementedError(
            "--scan is not supported by the PyTorch port: it holds one module "
            "per layer (the nn.scan layout matters only in the weight bridge)"
        )
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    launches0 = dict(flash_attention.launches)
    loss_launches0 = dict(fused_cross_entropy.launches)
    adamw_launches0 = fused_adamw.launches

    def kernel_launches() -> dict:
        return {
            "flash_launches": _delta(flash_attention.launches, launches0),
            "fused_loss_launches": _delta(fused_cross_entropy.launches, loss_launches0),
            "fused_adamw_launches": fused_adamw.launches - adamw_launches0,
        }
    t0 = time.perf_counter()
    model, state, batch, step_fn, n_params, n_embed = build(args, dev)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps_run = 0

    def one_step():
        nonlocal state, steps_run
        state, metrics = step_fn(state, batch)
        steps_run += 1
        return metrics["loss"]

    def sync(loss):
        return float(loss.item())  # the one real sync of a chain

    d_model, n_layers, _, vocab = _shape(args)
    tokens_per_step = args.batch * args.seq
    model_flops = model_flops_per_token(
        n_params - n_embed, d_model, n_layers, args.seq
    ) * tokens_per_step
    peak = PEAK_BF16.get(torch.cuda.get_device_name(dev)) if on_card else None
    out = {
        "preset": args.preset, "d_model": d_model, "n_layers": n_layers,
        "vocab": vocab, "seq": args.seq, "batch": args.batch,
        "loss": "fused_cross_entropy" if args.fused else "cross_entropy",
        "optimizer": "fused_adamw" if args.fused else "adamw",
        "attn": args.attn + (f"({args.block_q},{args.block_k})" if args.attn == "flash" else ""),
        "block_note": BLOCK_NOTE if args.attn == "flash" else None,
        "remat": bool(args.remat), "remat_policy": args.remat_policy,
        "scan_layers": False, "n_params": n_params, "device": str(dev),
        "init_s": init_s,
    }
    if args.mem_only:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sync(one_step())
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
        out.update(kernel_launches())
        out["steps_run"] = steps_run
        return out

    # warmup chain: first launches, kernel builds, allocator growth
    losses = [one_step() for _ in range(args.steps)]
    sync(losses[-1])
    first_chain = [float(x) for x in torch.stack(losses).float().cpu()]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    all_losses = list(losses)
    chain_ms: list[float] = []

    def run_chain():
        ls = []
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t = time.perf_counter()
        for _ in range(args.steps):
            ls.append(one_step())
        if on_card:
            end.record()
        sync(ls[-1])
        chain_ms.append(start.elapsed_time(end) if on_card
                        else (time.perf_counter() - t) * 1e3)
        all_losses.extend(ls)

    timing = MinOfN(n=args.reps, warmup=False).measure(run_chain)
    step_s = min(chain_ms) / 1e3 / args.steps
    finite = bool(torch.isfinite(torch.stack(all_losses).float()).all())
    out.update({
        "steps_chained": args.steps,
        "wall_s_samples": [round(s, 4) for s in timing.samples_s],
        "stalled_samples": timing.n_stalled,
        "chain_ms_samples": chain_ms,
        "step_ms": step_s * 1e3,
        "step_clock": "CUDA events over the chain" if on_card else "host clock (CPU run)",
        "tokens_per_s": tokens_per_step / step_s,
        "model_tflops_per_step": model_flops / 1e12,
        "peak_bf16_flops": peak,
        "mfu": model_flops / step_s / peak if peak else None,
        "peak_memory_bytes": torch.cuda.max_memory_allocated() if on_card else None,
        "losses_first_chain": first_chain,
        "all_losses_finite": finite,
    })
    if args.trace:
        if not on_card:
            raise ValueError("--trace profiles the card; it needs --device cuda")
        out.update(trace_step(lambda: sync(one_step()), model_flops, peak))
    out.update(kernel_launches())
    out["steps_run"] = steps_run
    return out


def _delta(now: dict, before: dict) -> dict:
    return {k: now[k] - before[k] for k in now}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", choices=sorted(PRESETS), default="760m")
    p.add_argument("--n_layers", type=int, default=None,
                   help="the preset's widths at this depth (default: the preset's)")
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--attn", choices=["dense", "flash"], default="flash")
    p.add_argument("--block_q", type=int, default=1024)
    p.add_argument("--block_k", type=int, default=1024)
    p.add_argument("--remat", action="store_true", default=True)
    p.add_argument("--no_remat", dest="remat", action="store_false")
    p.add_argument("--remat_policy", choices=["dots", "dots_attn"], default="dots")
    p.add_argument("--no_scan", action="store_true", default=True,
                   help="unrolled layers (the only layout of the port)")
    p.add_argument("--scan", dest="no_scan", action="store_false")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--mem_only", action="store_true")
    p.add_argument("--fused", action="store_true",
                   help="also run the fused-tail arm (logits-free fused cross "
                   "entropy + fused AdamW kernels) and emit both arms")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no GPU and no --device cpu raises")
    p.add_argument("--json", default=None)
    return p.parse_args(argv)


def main(argv=None) -> None:
    from pytorch_distributed_training_tutorials_tpu_torch.obs import make_receipt, write_receipt

    args = parse(argv)
    if args.fused:
        # side by side: the same model, batch and chains; only the loss and
        # optimizer tail differ between the arms
        base = argparse.Namespace(**{**vars(args), "fused": False})
        r = {"baseline": measure(base), "fused": measure(args)}
    else:
        r = measure(args)
    r = make_receipt("lm_headline", r, device=args.device or "cuda")
    print(json.dumps(r))
    write_receipt(args.json, r)


if __name__ == "__main__":
    sys.exit(main())
