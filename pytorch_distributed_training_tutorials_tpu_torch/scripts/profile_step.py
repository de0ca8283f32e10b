"""``python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.profile_step
[--batch 512] [--chain 16] [--rows N] [--top 25] [--json PATH] [--device cpu]``:
where the headline train step's device time goes.

The workload is ``bench.headline``'s: ResNet-18 (cifar stem) computing in
bfloat16 on float32 parameters, 512 images a device, uint8 MNIST on the
card, SGD with momentum. A chain of ``--chain`` eager steps on one cached
batch runs once to warm up (first launches, allocator growth), then once
inside :func:`..utils.profiling.trace`; :class:`..obs.trace.StepReport`
classifies that trace by the op that launched each kernel (convolution,
matmul, reduce, elementwise, ...). Prints the table and the top ops, then
one ``profile_step`` receipt as the last line (``--json`` also writes it).

Runs on ``cuda`` unless ``--device`` names another device (a CPU run
classifies the ops' host time and says so in its receipt's ``env``).
``--rows`` trains on the first N rows of MNIST (toy runs).
"""

from __future__ import annotations

import argparse
import json
import sys

CHAIN_LEN = 16


def run(per_device_batch: int = 512, *, chain_len: int = CHAIN_LEN, rows: int | None = None,
        device=None, top: int = 25) -> tuple[dict, str]:
    """The receipt and the rendered table."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.bench import headline
    from pytorch_distributed_training_tutorials_tpu_torch.bench.harness import lost_summary
    from pytorch_distributed_training_tutorials_tpu_torch.bench.__main__ import _first
    from pytorch_distributed_training_tutorials_tpu_torch.data import mnist
    from pytorch_distributed_training_tutorials_tpu_torch.obs import make_receipt
    from pytorch_distributed_training_tutorials_tpu_torch.obs.trace import capture_report
    from pytorch_distributed_training_tutorials_tpu_torch.utils import profiling

    dev = resolve_device(device)
    setup = headline.make_headline_setup(per_device_batch, quiet=True, device=dev,
                                         dataset=_first(mnist("train", raw=True), rows))
    chain = headline.make_step_chain(setup, chain_len)
    chain().tolist()  # warm

    def record(logdir):
        with profiling.trace(logdir, device=dev):
            return chain().tolist()

    report, _, losses = capture_report(record, steps=chain_len)
    receipt = make_receipt("profile_step", {
        "workload": f"resnet18-bs{per_device_batch}-bf16-mnist-train-step",
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "chain_len": chain_len,
        "per_device_batch": per_device_batch,
        "per_step_ms": report.step_us / 1e3,
        # the device-rate ceiling: the bench's number adds launch and fetch
        "images_per_sec_device": per_device_batch * 1e6 / report.step_us
        if report.step_us > 0 else None,
        "step_report": report.to_dict(),
        "port_launches": report.port_launches,
        "lost_launches": lost_summary(report.lost_launches),
        "unplaced_ms_per_step": {k: us / 1e3 / chain_len for k, us in report.unplaced.items()},
        "top_ops_ms_per_step": [[name[:100], us / 1e3 / chain_len, cat]
                                for name, us, cat in report.ops[:top]],
        "top_launching_ops_ms_per_step": {op: us / 1e3 / chain_len
                                          for op, us in list(report.by_op.items())[:top]},
        "losses_finite": all(v == v and abs(v) != float("inf") for v in losses),
    }, device=dev)
    return receipt, report.render(top=top)


def main(argv=None) -> int:
    from pytorch_distributed_training_tutorials_tpu_torch.obs import write_receipt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512, help="images a device")
    ap.add_argument("--chain", type=int, default=CHAIN_LEN, help="steps in the traced chain")
    ap.add_argument("--rows", type=int, default=None,
                    help="train on the first N rows of MNIST (toy runs)")
    ap.add_argument("--top", type=int, default=25, help="ops listed")
    ap.add_argument("--json", default=None, help="also write the receipt to this path")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no GPU and no --device cpu raises")
    args = ap.parse_args(argv)
    receipt, table = run(args.batch, chain_len=args.chain, rows=args.rows,
                         device=args.device, top=args.top)
    print(table)
    write_receipt(args.json, receipt)
    print(json.dumps(receipt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
