"""``python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.profile_decode
[--preset 1b|toy] [--layers N] [--paged] [--new-tokens 9] [--json PATH]
[--device cpu]``: where an int8 decode chain's device time goes.

A ``ServeEngine`` over the int8 model (the 1b widths by default: vocab
32000, d_model 2048, 16 heads, d_ff 8192; ``--layers`` of them) serves
``--batch`` requests of ``--prompt-len`` random tokens at once, each for
``--new-tokens`` tokens: one prefill each, then decode chains of
``tokens_per_launch`` steps, every projection through the int8 kernel
(kernel 1) and, with ``--paged``, attention through the paged-attention
kernel over a page pool (kernel 2). The stream runs once to warm up, then
inside :func:`..utils.profiling.trace`; :class:`..obs.trace.StepReport`
classifies that trace, and each port kernel's launches in it stand beside
the launch counters over the same run (:func:`..obs.trace.capture_report`).
Prints the table, then one ``profile_decode`` receipt as the last line
(``--json`` also writes it).

:func:`run` takes a model with its weights already bound (``model=``), so
a caller that built the 1b model reuses it. Runs on ``cuda`` unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

PRESETS = {
    "1b": dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, d_ff=8192,
               max_seq_len=512),
    "toy": dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64),
}
TOKENS_PER_LAUNCH = 8


def build(preset: str = "1b", layers: int | None = None, device=None):
    """The int8 model of ``preset`` (``layers`` of its blocks), random
    weights from seed 0, bound on ``device``."""
    from pytorch_distributed_training_tutorials_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
        bind_params,
        init_quantized_lm,
    )

    spec = dict(PRESETS[preset])
    if layers is not None:
        spec["n_layers"] = layers
    cfg = TransformerConfig(**spec, quantized=True)
    model = TransformerLM(cfg)
    bind_params(model, init_quantized_lm(cfg, seed=0, device=device))
    return model


def run(model, *, device=None, batch: int = 4, prompt_len: int = 32, new_tokens: int = 9,
        paged: bool = False, page_size: int = 16, seed: int = 7, top: int = 25
        ) -> tuple[dict, str]:
    """The receipt and the rendered table for ``model`` (weights bound)."""
    import numpy as np
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.bench.harness import lost_summary
    from pytorch_distributed_training_tutorials_tpu_torch.obs import make_receipt
    from pytorch_distributed_training_tutorials_tpu_torch.obs.trace import capture_report
    from pytorch_distributed_training_tutorials_tpu_torch.serve import Request, ServeEngine
    from pytorch_distributed_training_tutorials_tpu_torch.utils import profiling

    dev = resolve_device(device)
    cfg = model.cfg
    rng = np.random.Generator(np.random.PCG64(seed))
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).tolist()
    pages = batch * -(-(prompt_len + new_tokens) // page_size) if paged else 0
    engine = ServeEngine(model, None, n_slots=batch, tokens_per_launch=TOKENS_PER_LAUNCH,
                         device=dev, paged=paged, paged_kernel=paged,
                         page_size=page_size if paged else 0, pool_pages=pages)

    def serve() -> list:
        for p in prompts:
            engine.submit(Request(prompt=p, max_new_tokens=new_tokens))
        return engine.run_until_idle()

    serve()  # warm: first launches, allocator growth

    def record(logdir):
        chains0 = engine.n_chains
        with profiling.trace(logdir, device=dev):
            done = serve()
        return done, engine.n_chains - chains0

    report, counted, (done, report_chains) = capture_report(record)
    report = dataclasses.replace(report, steps=report_chains * TOKENS_PER_LAUNCH)
    receipt = make_receipt("profile_decode", {
        "workload": f"int8-decode-d{cfg.d_model}-l{cfg.n_layers}" + ("-paged" if paged else ""),
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "batch": batch, "prompt_len": prompt_len, "new_tokens": new_tokens,
        "n_layers": cfg.n_layers, "paged": paged, "paged_kernel": paged,
        "chains": report_chains, "decode_steps": report_chains * TOKENS_PER_LAUNCH,
        "completions": len(done),
        "device_ms_ops": report.total_us / 1e3,
        "per_decode_step_ms_ops": report.step_us / 1e3,
        "by_class_ms": {k: v / 1e3 for k, v in report.by_category.items()},
        "unclassified_fraction": report.unclassified_fraction,
        "step_report": report.to_dict(),
        "port_launches": report.counter_launches(),
        "port_unmatched": report.port_unmatched,
        "lost_launches": lost_summary(report.lost_launches),
        "unplaced_ms": {k: us / 1e3 for k, us in report.unplaced.items()},
        "counted_launches": counted,
        "port_kernel_ms": {k: us / 1e3 for k, us in report.port_us.items()},
        "top_ops_ms": [[name[:100], us / 1e3, cat] for name, us, cat in report.ops[:top]],
        "top_launching_ops_ms": {op: us / 1e3 for op, us in list(report.by_op.items())[:top]},
    }, device=dev)
    return receipt, report.render(top=top)


def main(argv=None) -> int:
    from pytorch_distributed_training_tutorials_tpu_torch.obs import write_receipt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="1b")
    ap.add_argument("--layers", type=int, default=None, help="blocks of the preset served")
    ap.add_argument("--batch", type=int, default=4, help="requests, one slot each")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=1 + TOKENS_PER_LAUNCH,
                    help="tokens a request (the first from its prefill)")
    ap.add_argument("--paged", action="store_true",
                    help="serve from a page pool through the paged-attention kernel")
    ap.add_argument("--top", type=int, default=25, help="ops listed")
    ap.add_argument("--json", default=None, help="also write the receipt to this path")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no GPU and no --device cpu raises")
    args = ap.parse_args(argv)
    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device

    dev = resolve_device(args.device)
    receipt, table = run(build(args.preset, args.layers, dev), device=dev,
                         batch=args.batch, prompt_len=args.prompt_len,
                         new_tokens=args.new_tokens, paged=args.paged, top=args.top)
    print(table)
    write_receipt(args.json, receipt)
    print(json.dumps(receipt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
