"""``python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.step_time_experiment
[per_device_batch] [--chain_len N] [--rows N] [--device cpu]``: the
headline workload's step time at one per-device batch, as one JSON line.

The twin of the JAX package's ``scripts/step_time_experiment.py``: a
chain of ``--chain_len`` eager train steps (:func:`..bench.headline.make_step_chain`
on :func:`..bench.headline.make_headline_setup`'s ResNet-18 bs-N bf16
MNIST setup) after an untimed one, timed with CUDA events on the card
(the host clock on the CPU) and closed by one fetch of its losses. The
JAX ``unroll`` argument is XLA's scan unroll; the port runs eager steps
and has no scan (``make_epoch_scan`` is not ported), so the twin takes
the batch only. ``--rows`` trains on the first rows of the split (a
small CPU run). Runs on ``cuda`` unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def measure(per_device_batch: int = 512, chain_len: int = 256, rows: int | None = None,
            device=None) -> dict:
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.bench.headline import (
        make_headline_setup,
        make_step_chain,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, mnist
    from pytorch_distributed_training_tutorials_tpu_torch.obs.receipt import environment_stamp

    dev = resolve_device(device)
    ds = mnist("train", raw=True)
    if rows is not None:
        ds = ArrayDataset(tuple(a[:rows] for a in ds.arrays))
    setup = make_headline_setup(per_device_batch, quiet=True, device=dev, dataset=ds)
    chain = make_step_chain(setup, chain_len)
    chain().tolist()  # first launches, allocator growth
    on_card = dev.type == "cuda"
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    losses = chain()
    if on_card:
        end.record()
    losses.tolist()  # the chain's one fetch closes it
    ms = (start.elapsed_time(end) if on_card else (time.perf_counter() - t0) * 1e3)
    stamp = environment_stamp(device=dev)
    return {
        "per_device_batch": per_device_batch, "chain_len": chain_len,
        "ms_per_step": ms / chain_len,
        "images_per_sec_per_device": chain_len * per_device_batch / (ms / 1e3),
        "timer": "cuda_events" if on_card else "host_clock",
        "device": str(dev), "device_name": stamp["device_name"],
        "nvidia_smi": stamp["nvidia_smi"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("per_device_batch", type=int, nargs="?", default=512)
    ap.add_argument("--chain_len", type=int, default=256)
    ap.add_argument("--rows", type=int, default=None,
                    help="train on the split's first rows only")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no GPU and no --device cpu raises")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.per_device_batch, args.chain_len, args.rows, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
