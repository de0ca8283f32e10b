"""``python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.launch_overhead_probe
[--lens 64 1024] [--device cpu]``: a chain's fixed cost apart from its
per-op time.

A chain of ``n`` eager launches of one op, ended by one sync, takes
``fixed + per_op * n`` (:func:`..obs.timing.launch_overhead_fit` over two
lengths, each the min of 4 chains after a warmup,
:class:`..obs.timing.MinOfN`). Two bodies at the 1b decode shape (4, 2048)
x (2048, 8192): a bfloat16 matmul and the int8 kernel
(:func:`..ops.quant.int8_matmul`). ``per_op`` is what one more launch
costs: the device's time for the op where it exceeds the host's launch
cost, the host's where it does not; dividing one short chain by its length
instead folds the fixed cost into every op (``naive_32chain...``). Prints
one ``launch_probe`` receipt a body.

Runs on ``cuda`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import sys

SHAPE = (4, 2048, 8192)  # (M, K, N): a 1b decode projection at 4 slots


def probe(device=None, lens=(64, 1024)) -> list[dict]:
    """One ``launch_probe`` receipt a body."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.obs import (
        MinOfN,
        launch_overhead_fit,
        make_receipt,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import (
        Int8Param,
        int8_matmul,
        quantize_int8,
    )

    dev = resolve_device(device)
    m, k, n = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(m, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev)
    wb = w.to(torch.bfloat16)
    wq = quantize_int8(w)
    # the kernel reads q K-contiguous, as Int8Linear stores it: (N, K) rows
    wq = Int8Param(q=wq.q.t().contiguous().t(), scale=wq.scale)
    bodies = {
        "bf16_matmul": lambda: (x.to(torch.bfloat16) @ wb),
        "int8_matmul": lambda: int8_matmul(x, wq),
    }
    receipts = []
    for name, body in bodies.items():
        def time_chain(length: int, body=body) -> float:
            def chain():
                for _ in range(length):
                    y = body()
                float(y[0, 0])  # the chain's one sync

            return MinOfN(n=4).measure(chain).best_s

        fit = launch_overhead_fit(time_chain, lens=lens)
        receipts.append(make_receipt("launch_probe", {
            "body": name,
            "shape": list(SHAPE),
            "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "wall_ms": {str(ln): w * 1e3 for ln, w in zip(fit.lens, fit.wall_s)},
            "per_op_us": fit.per_op_us,
            "fixed_launch_ms": fit.fixed_ms,
            "naive_32chain_would_report_ms_per_op": fit.naive_per_op_us(32) / 1e3,
        }, device=dev))
    return receipts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lens", type=int, nargs=2, default=(64, 1024),
                    help="the two chain lengths of the fit")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no GPU and no --device cpu raises")
    args = ap.parse_args(argv)
    for receipt in probe(args.device, tuple(args.lens)):
        print(json.dumps(receipt), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
