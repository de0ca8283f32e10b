"""``python -m pytorch_distributed_training_tutorials_tpu_torch.scripts.accuracy_demo
[--out ACCURACY.json] [--device cpu]``: the accuracy target can fail.

The twin of the JAX package's ``scripts/accuracy_demo.py``: the headline
workload (ResNet-18 cifar stem, batch 512 a rank, bf16 on the
device-resident uint8 MNIST surrogate, SGD momentum 0.9) trained for 7
epochs twice — healthy (lr 0.05) and broken (lr 10, divergent) — each
evaluated on the test split with wrap-padding masked. The JSON (printed,
and written to ``--out``) holds both runs' ``reaches_accuracy_target``
(accuracy >= 0.99) and ``falsifiable``: the healthy run reaches it and the
broken one does not. Runs on ``cuda`` unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import sys

TARGET = 0.99
EPOCHS = 7
BATCH = 512


def build(lr: float, device=None, train=None, test=None):
    """``(trainer, test loader)`` of one config: the headline setup at
    ``lr`` (``train`` / ``test`` replace the MNIST splits)."""
    from pytorch_distributed_training_tutorials_tpu_torch.bench.headline import (
        make_headline_setup,
        normalize,
    )
    from pytorch_distributed_training_tutorials_tpu_torch.data import DeviceResidentLoader, mnist
    from pytorch_distributed_training_tutorials_tpu_torch.train import sgd

    setup = make_headline_setup(BATCH, quiet=True, device=device, dataset=train,
                                optimizer=sgd(lr, 0.9))
    test_loader = DeviceResidentLoader(test if test is not None else mnist("test", raw=True),
                                       BATCH, setup.mesh, seed=0, transform=normalize)
    return setup.trainer, test_loader


def run_config(lr: float, device=None) -> dict:
    trainer, test = build(lr, device)
    trainer.train(EPOCHS)
    m = trainer.evaluate(test)
    return {"lr": lr, "epochs": EPOCHS, "eval_accuracy": m["accuracy"], "eval_loss": m["loss"],
            "reaches_accuracy_target": bool(m["accuracy"] >= TARGET)}


def main(argv=None) -> dict:
    from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device
    from pytorch_distributed_training_tutorials_tpu_torch.obs.receipt import environment_stamp

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no GPU and no --device cpu raises")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    result = {
        "workload": "ResNet-18 cifar-stem bs512 bf16, MNIST surrogate, 7 epochs, eval on "
                    "the held-out split with wrap-padding masked",
        "accuracy_target": TARGET,
        "healthy": run_config(0.05, dev),
        "broken_lr": run_config(10.0, dev),
        "env": environment_stamp(device=dev),
    }
    result["falsifiable"] = bool(result["healthy"]["reaches_accuracy_target"]
                                 and not result["broken_lr"]["reaches_accuracy_target"])
    text = json.dumps(result, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
