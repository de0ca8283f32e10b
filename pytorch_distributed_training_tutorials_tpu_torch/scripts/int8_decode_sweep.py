"""``python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.int8_decode_sweep
[--m 4 8] [--lens 64 1024] [--device cpu]``: kernel 1's two routes at
the 1b preset's decode shapes, one JSON line a (shape, route).

The twin of the JAX package's ``scripts/int8_decode_sweep.py``. The JAX
sweep times Pallas tilings (``block_n`` / ``block_k``); the hand-written
kernel has no such knob (its plan is ``ops.quant._sm90_plan``'s), so this
sweep times its routes instead: ``route=None`` (the sm90 kernel,
``csrc/int8_matmul_sm90.cu``, where it takes the operands) and
``route="v1"`` (``csrc/int8_matmul.cu``). Each time is
:func:`..obs.timing.launch_overhead_fit` over two chain lengths (each the
min of 4 chains after a warmup, closed by one sync): ``per_op_us`` is a
launch's cost apart from the chain's fixed cost, which a short chain
divided by its length would fold in. The (K, N) pairs are the 1b
projections' (attention 2048 x 2048, FFN 2048 x 8192 and 8192 x 2048, the
head 2048 x 32000) at M 4 to 8 (the slot counts). On the CPU there are no
routes: each line times the plain version and says so. Runs on ``cuda``
unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import sys

SHAPES = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 32000))


def sweep(ms=(4, 8), shapes=SHAPES, lens=(64, 1024), device=None) -> list[dict]:
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.obs import MinOfN, launch_overhead_fit
    from pytorch_distributed_training_tutorials_tpu_torch.obs.receipt import environment_stamp
    from pytorch_distributed_training_tutorials_tpu_torch.ops.quant import (
        Int8Param,
        int8_matmul,
        quantize_int8,
    )

    dev = resolve_device(device)
    stamp = environment_stamp(device=dev)
    routes = (None, "v1") if dev.type == "cuda" else ("plain",)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for k, n in shapes:
        w = quantize_int8(torch.randn(k, n, generator=gen, device=dev))
        # the kernels read q K-contiguous, as Int8Linear stores it: (N, K) rows
        w = Int8Param(q=w.q.t().contiguous().t(), scale=w.scale)
        for m in ms:
            x = torch.randn(m, k, generator=gen, device=dev)
            for route in routes:
                kw = {} if route == "plain" else {"route": route}

                def time_chain(length: int, kw=kw, x=x, w=w) -> float:
                    def chain():
                        for _ in range(length):
                            y = int8_matmul(x, w, **kw)
                        float(y[0, 0])  # the chain's one sync

                    return MinOfN(n=4).measure(chain).best_s

                fit = launch_overhead_fit(time_chain, lens=lens)
                rows.append({
                    "shape": [m, k, n],
                    "route": {None: "sm90", "v1": "v1", "plain": "plain (cpu)"}[route],
                    "per_op_us": fit.per_op_us, "fixed_ms": fit.fixed_ms,
                    "weight_gb_per_s": k * n / (fit.per_op_us * 1e-6) / 1e9
                    if fit.per_op_us > 0 else None,
                    "fit": fit.to_dict(), "device": str(dev),
                    "device_name": stamp["device_name"], "nvidia_smi": stamp["nvidia_smi"],
                })
    return rows


def _shape(text: str) -> tuple[int, int]:
    k, n = text.lower().split("x")
    return int(k), int(n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, nargs="+", default=[4, 8], help="rows (slots)")
    ap.add_argument("--shapes", type=_shape, nargs="+", default=list(SHAPES),
                    metavar="KxN", help="(K, N) pairs (default: the 1b projections')")
    ap.add_argument("--lens", type=int, nargs=2, default=(64, 1024),
                    help="the two chain lengths of the fit")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no GPU and no --device cpu raises")
    args = ap.parse_args(argv)
    for row in sweep(tuple(args.m), tuple(args.shapes), tuple(args.lens), args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
