"""LLM training with composed parallelism: dp x pp, or dp x tp x sp — the
twin of the JAX package's ``examples/train_llm_3d.py``.

    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.train_llm_3d \\
        --mode pp --nprocs 4 --max_epochs 2
    python -m pytorch_distributed_training_tutorials_tpu_torch.examples.train_llm_3d \\
        --mode tp_sp --nprocs 8 --device cpu --max_epochs 1

Modes (N = ``--nprocs``, one rank a card; gloo on card 0 when N exceeds
the cards):

- ``pp``: ``{"data": N/2, "stage": 2}`` — the single-program pipeline over
  ranks (:class:`..parallel.PipelinedTransformerLM`, one stage a rank,
  ``PipelineParallel(num_microbatches=2)``), data parallel across the
  stage pairs;
- ``tp_sp``: ``{"data": 2, "seq": 2, "model": N/4}`` — the Megatron split
  (``TensorParallel(mesh, TP_RULES, seq_axis="seq")``) with ring attention
  over ``seq``, the tokens cut (B over data, S over seq).

The JAX toy config: vocab 64, d_model 64, 4 layers, 4 heads, 512
sequences of 32 tokens from ``synthetic_lm``, Adam 3e-3 (here
``fused_adamw`` with no weight decay: optax's Adam, the update in one
kernel pass on the card), ``--batch_size`` rows a data rank. Runs on
``cuda`` unless given ``--device cpu``. Attention is the float model's
dense attention in ``pp`` and the ring's plain fold in ``tp_sp``: neither
mode launches the flash kernels.
"""

from __future__ import annotations

import argparse
import sys

VOCAB, D_MODEL, LAYERS, HEADS, SEQ, ROWS = 64, 64, 4, 4, 32, 512
LR = 3e-3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["pp", "tp_sp"], default="pp")
    p.add_argument("--max_epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=8, help="per data-parallel rank")
    p.add_argument("--nprocs", type=int, default=2,
                   help="ranks, one a card (pp: even; tp_sp: a multiple of 4)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    return p


def mesh_axes(mode: str, n: int) -> dict:
    """The JAX example's mesh at a world of ``n``."""
    if mode == "pp":
        if n < 2 or n % 2:
            raise ValueError(f"--mode pp needs an even world of at least 2, got {n}")
        return {"data": n // 2, "stage": 2}
    if n < 4 or n % 4:
        raise ValueError(f"--mode tp_sp needs a world of a multiple of 4, got {n}")
    return {"data": 2, "seq": 2, "model": n // 4}


def build(args):
    """The rank's ``Trainer`` on its mesh (the world formed already)."""
    import torch.distributed as dist

    from pytorch_distributed_training_tutorials_tpu_torch.data import ShardedLoader, synthetic_lm
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TP_RULES,
        TransformerConfig,
        TransformerLM,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
        PipelinedTransformerLM,
        PipelineParallel,
        TensorParallel,
        create_mesh,
        make_ring_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer

    n = dist.get_world_size() if dist.is_initialized() else 1
    axes = mesh_axes(args.mode, n)
    ds = synthetic_lm(size=ROWS, seq_len=SEQ, vocab_size=VOCAB)
    if args.mode == "pp":
        mesh = create_mesh(axes, device=args.device, stage_ranks=True)
        cfg = TransformerConfig(vocab_size=VOCAB, d_model=D_MODEL, n_layers=LAYERS,
                                n_heads=HEADS, max_seq_len=64)
        model = PipelinedTransformerLM(cfg, mesh, num_microbatches=2)
        strategy = PipelineParallel(mesh, num_microbatches=2)
        loader = ShardedLoader(ds, args.batch_size, mesh)
    else:
        mesh = create_mesh(axes, device=args.device)
        cfg = TransformerConfig(vocab_size=VOCAB, d_model=D_MODEL, n_layers=LAYERS,
                                n_heads=HEADS, max_seq_len=64,
                                attention_fn=make_ring_attention(mesh))
        model = TransformerLM(cfg)
        strategy = TensorParallel(mesh, TP_RULES, seq_axis="seq")
        loader = ShardedLoader(ds, args.batch_size, mesh, batch_spec=("data", "seq"))
    return Trainer(model, loader, fused_adamw(LR, weight_decay=0.0), strategy=strategy,
                   loss="cross_entropy")


def run(args) -> dict:
    """One rank: build, train ``args.max_epochs`` epochs; the step losses
    and the kernel launches of the run (flash, fused AdamW)."""
    from pytorch_distributed_training_tutorials_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_optim import fused_adamw

    flash0, adamw0 = sum(flash_attention.launches.values()), fused_adamw.launches
    trainer = build(args)
    trainer.train(args.max_epochs)
    return {"losses": [e["loss"] for e in trainer.metrics.step_events()],
            "epoch_losses": [e["loss"] for e in trainer.metrics.epoch_events()],
            "flash_launches": sum(flash_attention.launches.values()) - flash0,
            "fused_adamw_launches": fused_adamw.launches - adamw0}


def _rank(world, args) -> dict:
    return run(args)


def main(argv=None) -> list[dict]:
    """Parse ``argv`` and train in a spawned world of ``--nprocs`` ranks;
    every rank's :func:`run` result."""
    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.examples import run_world

    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    mesh_axes(args.mode, args.nprocs)  # refuse a world the mode cannot use, before spawning
    return run_world(_rank, args.nprocs, (args,), device=args.device)


if __name__ == "__main__":
    main()
    sys.exit(0)
