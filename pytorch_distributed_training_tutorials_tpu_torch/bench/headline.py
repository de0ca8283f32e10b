"""The headline workload: data-parallel ResNet-18 on MNIST, on the card
(port of the JAX package's ``bench/headline.py``).

``make_headline_setup`` builds it: the MNIST train split at rest as uint8
on the device (:class:`..data.DeviceResidentLoader`, ``x.to(bf16) / 255``
applied per batch on the device), a cifar-stem ResNet-18 computing in
bfloat16 on float32 parameters, SGD at lr 0.05 with momentum 0.9 and
cross entropy, 512 images per device (``--batch_size`` semantics). The
optimizer can be swapped (``fused_adamw`` for the fused arm).

:func:`time_epoch` times one epoch with CUDA events around
``Trainer.train``, whose one host fetch (the epoch's losses) closes the
region, and reports images/sec per GPU; :func:`make_step_chain` runs a
chain of eager steps on one cached batch, and :func:`time_chain` times
such chains, each closed by one fetch, for the step time.
``chip_smoke.py`` drives it on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

LR, MOMENTUM = 0.05, 0.9


def normalize(x, y):
    """uint8 images to bfloat16 in [0, 1], on the device."""
    import torch

    return x.to(torch.bfloat16) / 255, y


@dataclasses.dataclass
class HeadlineSetup:
    mesh: Any
    loader: Any  # DeviceResidentLoader over raw-uint8 MNIST
    trainer: Any
    batch: Any  # one transformed, device-ready batch
    step_fn: Any  # the trainer's train step
    dataset: Any


def make_headline_setup(per_device_batch: int = 512, quiet: bool = False, device=None,
                        optimizer=None, dataset=None, loader_cls=None,
                        **trainer_kw) -> HeadlineSetup:
    """The headline workload on ``device`` (``cuda`` unless the caller
    passes another) over the data mesh of the current world. ``dataset``
    replaces the MNIST train split (a small one for CPU runs);
    ``loader_cls(dataset, batch, mesh, seed=, transform=)`` replaces the
    device-resident loader (a streaming one); ``trainer_kw`` go to the
    ``Trainer`` (the guardrails)."""
    import torch

    from pytorch_distributed_training_tutorials_tpu_torch.data import DeviceResidentLoader, mnist
    from pytorch_distributed_training_tutorials_tpu_torch.models import resnet18
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
    from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, sgd

    mesh = create_mesh(device=device)
    ds = dataset if dataset is not None else mnist("train", raw=True)
    loader = (loader_cls or DeviceResidentLoader)(ds, per_device_batch, mesh, seed=0,
                                                  transform=normalize)
    model = resnet18(num_classes=10, stem="cifar", dtype=torch.bfloat16,
                     in_channels=ds.arrays[0].shape[-1])
    trainer = Trainer(model, loader, optimizer if optimizer is not None else sgd(LR, MOMENTUM),
                      loss="cross_entropy", quiet=quiet, **trainer_kw)
    return HeadlineSetup(mesh=mesh, loader=loader, trainer=trainer, batch=next(iter(loader)),
                         step_fn=trainer.train_step, dataset=ds)


def make_step_chain(setup: HeadlineSetup, chain_len: int):
    """``run()``: ``chain_len`` eager steps on the cached batch, returning
    the losses stacked on the device (the caller's one fetch closes it)."""
    import torch

    trainer, batch = setup.trainer, setup.batch

    def run():
        losses = []
        for _ in range(chain_len):
            trainer.state, m = setup.step_fn(trainer.state, batch)
            losses.append(m["loss"])
        return torch.stack(losses)

    return run


def time_chain(setup: HeadlineSetup, chain_len: int = 20, reps: int = 3) -> dict:
    """Step ms on the card: ``reps`` chains of ``chain_len`` steps, each
    timed with CUDA events and closed by one fetch of its losses, after an
    untimed chain; the min over chains."""
    import torch

    chain = make_step_chain(setup, chain_len)
    chain().tolist()
    chain_ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chain().tolist()
        end.record()
        end.synchronize()
        chain_ms.append(start.elapsed_time(end))
    return {"step_ms": min(chain_ms) / chain_len, "chain_ms_samples": chain_ms,
            "chain_len": chain_len}


def time_epoch(setup: HeadlineSetup) -> dict:
    """One epoch of ``Trainer.train`` (the next one), timed with CUDA
    events: start recorded before it, end after its one host fetch."""
    import torch

    trainer = setup.trainer
    epoch = trainer.epoch
    on_card = trainer.device.type == "cuda"
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    m = trainer.train(epoch + 1)
    if on_card:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        seconds = m["steps"] / m["steps_per_sec"]
    images = m["steps"] * setup.loader.global_batch
    steps = trainer.metrics.step_events()[-m["steps"]:]
    return {"epoch": epoch, "steps": m["steps"], "seconds": seconds,
            "images_per_sec": images / seconds,
            "images_per_sec_per_device": images / seconds / setup.trainer.strategy.num_devices,
            "step_ms": seconds * 1e3 / m["steps"], "last_loss": m["loss"],
            "mean_loss": sum(e["loss"] for e in steps) / len(steps),
            "timer": "cuda_events" if on_card else "host_clock"}

