"""The headline benchmark: images/sec per GPU, ResNet-18 on MNIST, data
parallel (the port's twin of the root ``bench.py``).

    python -m pytorch_distributed_training_tutorials_tpu_torch.bench              # on the card
    python -m pytorch_distributed_training_tutorials_tpu_torch.bench --device cpu --rows 64 --per_device_batch 8

The workload is ``bench.headline``'s: the MNIST train split (its
surrogate without the files) at rest as uint8, a cifar-stem ResNet-18 in
bfloat16 on float32 parameters, SGD 0.05 momentum 0.9, 512 images a
device, over the world's data mesh. Legs, each closed by a real sync:

- end to end (the headline): one untimed epoch, then one epoch of
  ``Trainer.train`` over the device-resident loader, timed with CUDA
  events;
- streaming: an epoch through :class:`..data.ChunkedStreamingLoader` (16
  steps a chunk, 2 ahead), bracketed by :class:`..obs.DriftBracket`
  around an H2D ceiling: pinned copies of the same chunk bytes;
- the step alone: :class:`..obs.MinOfN` over chains of eager steps on one
  cached batch;
- eval accuracy on the test split, wrap-padded rows masked.

It prints exactly one JSON line on stdout, a receipt
(:func:`..obs.make_receipt`, kind ``bench_headline``) stamped with the
card's name and power limit; progress goes to stderr. ``vs_baseline`` is
null: the JAX package's baseline was measured on other hardware.
"""

from __future__ import annotations

import contextlib
import json
import sys


def h2d_ceiling(chunk_bytes: int, n_bufs: int, device):
    """``ceiling()``: ``n_bufs`` uploads of a pinned chunk-sized buffer,
    ended by a sync (on the CPU, copies); and the payload in bytes."""
    import torch

    pinned = device.type == "cuda"
    host = torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=pinned)
    bufs = [torch.empty(chunk_bytes, dtype=torch.uint8, device=device) for _ in range(n_bufs)]

    def ceiling():
        for b in bufs:
            b.copy_(host, non_blocking=pinned)
        if pinned:
            torch.cuda.synchronize(device)

    return ceiling, n_bufs * chunk_bytes


def _first(ds, rows):
    from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset

    if rows is None:
        return ds
    return ArrayDataset(tuple(a[:rows] for a in ds.arrays), synthetic=ds.synthetic)


def run(per_device_batch: int = 512, *, device=None, rows=None, chain_len: int = 20,
        quiet: bool = False, real: bool = False) -> dict:
    """The legs of the module docstring; returns the receipt."""
    from pytorch_distributed_training_tutorials_tpu_torch.bench import headline
    from pytorch_distributed_training_tutorials_tpu_torch.data import (
        ChunkedStreamingLoader,
        DeviceResidentLoader,
        mnist,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.obs import DriftBracket, MinOfN, make_receipt

    ds = mnist("train", raw=True)
    if real and ds.synthetic:
        raise SystemExit("--real: no MNIST idx files under DATA_DIR; refusing to report "
                         "the synthetic surrogate as real data")
    ds = _first(ds, rows)
    setup = headline.make_headline_setup(per_device_batch, quiet=quiet, device=device, dataset=ds)
    trainer, mesh = setup.trainer, setup.mesh
    n_dev = trainer.strategy.num_devices
    headline.time_epoch(setup)  # first launches, allocator growth, cuDNN's choices
    e2e = headline.time_epoch(setup)["images_per_sec_per_device"]

    stream = headline.make_headline_setup(
        per_device_batch, quiet=quiet, device=device, dataset=ds,
        loader_cls=lambda *a, **kw: ChunkedStreamingLoader(*a, steps_per_chunk=16, prefetch=2,
                                                           **kw))
    chunk = stream.loader.steps_per_chunk * per_device_batch
    ceiling, payload = h2d_ceiling(chunk * ds.arrays[0][0].nbytes, 7, trainer.device)
    ceiling()  # the first uploads pay the pinned allocation
    bracket = DriftBracket(ceiling, payload_bytes=payload).around(
        lambda: headline.time_epoch(stream)["images_per_sec_per_device"])
    stream_images_s = bracket.result
    h2d_images_s = 7 * chunk / bracket.ceiling_s
    del stream

    chain = headline.make_step_chain(setup, chain_len)
    step = MinOfN(n=2).measure(lambda: chain().tolist())
    step_images_s = chain_len * setup.loader.global_batch / step.best_s / n_dev

    test = DeviceResidentLoader(_first(mnist("test", raw=True), rows), per_device_batch, mesh, seed=0,
                                transform=headline.normalize)
    ev = trainer.evaluate(test)
    payload_line = {
        "metric": "images/sec/GPU (ResNet-18 MNIST, data-parallel train, end-to-end incl. "
                  "input pipeline)",
        "value": e2e,
        "unit": "images/sec/GPU",
        "vs_baseline": None,
        "synthetic": bool(ds.synthetic),
        "n_devices": n_dev,
        "per_device_batch": per_device_batch,
        "train_rows": len(ds),
        "epochs_trained": trainer.epoch,
        "eval_accuracy": ev["accuracy"],
        "eval_loss": ev["loss"],
        "accuracy_target": 0.99,
        "reaches_accuracy_target": bool(ev["accuracy"] >= 0.99),
        "breakdown": {
            "streaming_train_images_per_sec_per_gpu": stream_images_s,
            "h2d_ceiling_images_per_sec_per_gpu": h2d_images_s / n_dev,
            "h2d_ceiling_mb_per_sec": bracket.bandwidth_mbs(),
            "h2d_window_drift": bracket.drift,
            "streaming_fraction_of_h2d_ceiling": stream_images_s * n_dev / h2d_images_s,
            "train_step_only_images_per_sec_per_gpu": step_images_s,
            "train_step_only_ms": step.best_s * 1e3 / chain_len,
            "train_step_only_stalled_samples": step.n_stalled,
        },
    }
    return make_receipt("bench_headline", payload_line, mesh=mesh, drift=bracket.to_dict(),
                        device=trainer.device)


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--per_device_batch", type=int, default=512)
    ap.add_argument("--rows", type=int, default=None,
                    help="train and evaluate on the first N rows of each split (toy runs)")
    ap.add_argument("--chain_len", type=int, default=20, help="steps per step-alone chain")
    ap.add_argument("--real", action="store_true",
                    help="refuse to run on the synthetic surrogate")
    ap.add_argument("--quiet", action="store_true", help="no epoch lines on stderr")
    args = ap.parse_args(argv)
    from pytorch_distributed_training_tutorials_tpu_torch.obs import write_receipt

    with contextlib.redirect_stdout(sys.stderr):
        receipt = run(args.per_device_batch, device=args.device, rows=args.rows,
                      chain_len=args.chain_len, quiet=args.quiet, real=args.real)
    write_receipt(None, receipt)  # validates
    print(json.dumps(receipt), flush=True)
    return receipt


if __name__ == "__main__":
    main()
