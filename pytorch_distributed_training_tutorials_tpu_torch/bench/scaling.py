"""DDP all-reduce scaling sweep: weak scaling over data-parallel worlds
(port of the JAX package's ``bench/scaling.py``).

With the per-device batch ``b`` held fixed, a D-process run's images/s per
device divided by the narrowest run's is the efficiency: 1.0 when the
gradient all-reduce hides under the backward, less where it is exposed.
Each width is a ``torch.distributed`` world of that many processes,
formed through :func:`..launch.spawn` (NCCL on the card, one card a
process; gloo on the CPU), training a cifar-stem ResNet-18 with SGD
momentum on a fixed synthetic batch; rank 0 writes the width's point.

There is no compiled program to read collectives from: a step's
all-reduces are the gradient buckets of
:func:`..parallel.collective.bucket_plan` (the gradients and the loss)
and two per BatchNorm (its synced sums, forward and backward), and
:func:`collective_footprint` counts them from the model; the sweep also
counts the calls and bytes one step really makes.
:func:`predict_link_efficiency` turns a payload into a ring all-reduce's
time over a stated link bandwidth, against a stated step time: a
prediction, labelled as one.

    python -m pytorch_distributed_training_tutorials_tpu_torch.bench.scaling --widths 1 2 --device cpu
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import asdict, dataclass

import numpy as np
import torch

from pytorch_distributed_training_tutorials_tpu_torch._device import resolve_device


@dataclass
class ScalePoint:
    """One width's measurement."""

    num_chips: int
    per_device_batch: int
    global_batch: int
    step_time_s: float
    images_per_sec: float
    images_per_sec_per_chip: float
    efficiency: float  # vs the narrowest width
    all_reduce_calls: int  # counted in one step
    all_reduce_bytes: int


def _model(num_filters: int):
    from pytorch_distributed_training_tutorials_tpu_torch.models import resnet18

    return resnet18(num_classes=10, stem="cifar", num_filters=num_filters, in_channels=1)


def make_batch(global_batch: int, image_px: int) -> tuple[np.ndarray, np.ndarray]:
    """The sweep's fixed batch: standard-normal images and labels, seed 0."""
    rng = np.random.Generator(np.random.PCG64(0))
    x = rng.standard_normal((global_batch, image_px, image_px, 1)).astype(np.float32)
    y = rng.integers(0, 10, global_batch).astype(np.int32)
    return x, y


def collective_footprint(model, loss_dtype: torch.dtype = torch.float32) -> dict:
    """The all-reduce calls and bytes of one data-parallel train step of
    ``model``: the gradient buckets (the gradients and the loss, through
    ``bucket_plan``) and, per BatchNorm, its sums of x and x² forward and
    their gradient backward (2C floats each)."""
    from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import BatchNorm
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.collective import bucket_plan

    tensors = [p for p in model.parameters() if p.requires_grad]
    tensors.append(torch.empty((), dtype=loss_dtype))
    buckets = [sum(tensors[i].numel() * tensors[i].element_size() for i in b)
               for b in bucket_plan(tensors)]
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    bn_bytes = sum(2 * 2 * m.scale.numel() * torch.promote_types(m.dtype, torch.float32).itemsize
                   for m in norms)
    ops, nbytes = len(buckets) + 2 * len(norms), sum(buckets) + bn_bytes
    return {"all-reduce": {"ops": ops, "bytes": nbytes}, "total": {"ops": ops, "bytes": nbytes},
            "gradient_buckets": buckets, "batchnorm_all_reduces": 2 * len(norms),
            "batchnorm_bytes": bn_bytes}


def collective_stats(width: int, *, num_filters: int = 64) -> dict:
    """The footprint of the sweep's model at ``width`` (the plan does not
    depend on the width; a world of one runs no collective) and its f32
    gradient bytes."""
    model = _model(num_filters)
    return {"num_chips": width, "collectives": collective_footprint(model) if width > 1 else
            {"all-reduce": {"ops": 0, "bytes": 0}, "total": {"ops": 0, "bytes": 0}},
            "f32_grad_bytes": 4 * sum(p.numel() for p in model.parameters())}


def _count_all_reduces(fn) -> tuple[int, int]:
    """Calls and bytes of ``torch.distributed.all_reduce`` inside ``fn()``."""
    import torch.distributed as dist

    seen = [0, 0]
    all_reduce = dist.all_reduce

    def counted(t, *a, **kw):
        seen[0] += 1
        seen[1] += t.numel() * t.element_size()
        return all_reduce(t, *a, **kw)

    dist.all_reduce = counted
    try:
        fn()
    finally:
        dist.all_reduce = all_reduce
    return seen[0], seen[1]


def _measure(width: int, per_device_batch: int, image_px: int, num_filters: int, steps: int,
             reps: int, device: str | None) -> dict:
    """This rank's part of one width: the step timed as the min over
    ``reps`` chains of ``steps`` steps, each closed by a loss fetch."""
    from pytorch_distributed_training_tutorials_tpu_torch.obs.timing import MinOfN
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.data_parallel import DataParallel
    from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh, mesh_device
    from pytorch_distributed_training_tutorials_tpu_torch.train.optim import sgd
    from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import (
        TrainState,
        _init_weights,
        make_train_step,
    )

    dp = DataParallel(create_mesh(device=device))
    model = _model(num_filters)
    _init_weights(model, 0, mesh_device(dp.mesh))
    state = dp.shard_state(TrainState.create(model=model, tx=sgd(1e-2, momentum=0.9)))
    global_batch = per_device_batch * width
    x, y = make_batch(global_batch, image_px)
    batch = dp.shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
    step = make_train_step(loss="cross_entropy", has_batch_stats=True)
    calls, nbytes = _count_all_reduces(lambda: float(step(state, batch)[1]["loss"]))

    def run():
        for _ in range(steps):
            _, m = step(state, batch)
        float(m["loss"])

    best = MinOfN(n=reps).measure(run).best_s
    return {"step_time_s": best / steps, "global_batch": global_batch,
            "all_reduce_calls": calls, "all_reduce_bytes": nbytes}


def _width_worker(rank: int, width: int, coordinator: str, cfg: dict, out_path: str) -> None:
    from pytorch_distributed_training_tutorials_tpu_torch.parallel import distributed

    distributed.init(coordinator, num_processes=width, process_id=rank, device=cfg["device"])
    try:
        result = _measure(width, **cfg)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(result, f)
    finally:
        distributed.shutdown()


def _available(device) -> int:
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else (os.cpu_count() or 1)


def sweep(widths=None, *, per_device_batch: int = 64, image_px: int = 28, num_filters: int = 64,
          steps: int = 10, reps: int = 3, device: str | None = None) -> list[ScalePoint]:
    """images/s per device at each data-parallel width (default: powers of
    two up to the cards there are; on the CPU, up to the cores), each
    width its own world of processes."""
    from pytorch_distributed_training_tutorials_tpu_torch.launch import coordinator_for_spawn, spawn

    available = _available(device)
    if not widths:
        widths = [1 << i for i in range(available.bit_length()) if 1 << i <= available]
    widths = sorted(set(widths))
    if widths[-1] > available:
        raise ValueError(f"width {widths[-1]} exceeds {available} available devices")
    cfg = {"per_device_batch": per_device_batch, "image_px": image_px,
           "num_filters": num_filters, "steps": steps, "reps": reps, "device": device}
    points: list[ScalePoint] = []
    base = None
    with tempfile.TemporaryDirectory() as tmp:
        for width in widths:
            out = os.path.join(tmp, f"width{width}.json")
            spawn(_width_worker, width, (width, coordinator_for_spawn(), cfg, out))
            with open(out) as f:
                r = json.load(f)
            per_chip = r["global_batch"] / r["step_time_s"] / width
            base = per_chip if base is None else base
            points.append(ScalePoint(
                num_chips=width, per_device_batch=per_device_batch,
                global_batch=r["global_batch"], step_time_s=r["step_time_s"],
                images_per_sec=r["global_batch"] / r["step_time_s"],
                images_per_sec_per_chip=per_chip, efficiency=per_chip / base,
                all_reduce_calls=r["all_reduce_calls"], all_reduce_bytes=r["all_reduce_bytes"]))
    return points


def report(points: list[ScalePoint], *, workload: str | None = None,
           device: str | None = None) -> dict:
    """The sweep as one JSON-ready summary."""
    dev = resolve_device(device)
    return {
        "metric": "ddp_weak_scaling_efficiency",
        "workload": workload or "resnet18 synthetic images, cross-entropy, sgd+momentum",
        "backend": "nccl" if dev.type == "cuda" else "gloo",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "points": [asdict(p) for p in points],
        "efficiency_at_max_width": points[-1].efficiency if points else None,
    }


def predict_link_efficiency(allreduce_bytes: int, *, chips: int, step_compute_s: float,
                            link_bytes_per_s: float) -> dict:
    """A ring all-reduce's cost at ``chips`` wide: a PREDICTION, labelled.

    A ring moves ``2 (D - 1) / D`` x the payload through each device's
    links (reduce-scatter, then all-gather) at ``link_bytes_per_s``.
    ``efficiency_no_overlap`` exposes the whole all-reduce after the step
    (the floor); ``efficiency_full_overlap`` hides it under the backward's
    2/3 of ``step_compute_s`` but for any residue (the ceiling). Both the
    bandwidth and the step time are the caller's, measured or stated."""
    ring = 2.0 * (chips - 1) / chips
    t_comm = ring * allreduce_bytes / link_bytes_per_s
    no_overlap = step_compute_s / (step_compute_s + t_comm)
    exposed = max(0.0, t_comm - (2.0 / 3.0) * step_compute_s)
    return {
        "prediction": True,
        "chips": chips,
        "allreduce_payload_bytes": int(allreduce_bytes),
        "link_bytes_per_s_assumed": link_bytes_per_s,
        "ring_allreduce_s": t_comm,
        "step_compute_s": step_compute_s,
        "efficiency_no_overlap": no_overlap,
        "efficiency_full_overlap": step_compute_s / (step_compute_s + exposed),
    }


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="*", default=None,
                    help="world sizes (default: powers of 2 up to the devices)")
    ap.add_argument("--per_device_batch", type=int, default=64)
    ap.add_argument("--image_px", type=int, default=28)
    ap.add_argument("--num_filters", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="JSON path")
    ap.add_argument("--predict_chips", type=int, default=None,
                    help="also predict a ring all-reduce's efficiency at this width")
    ap.add_argument("--predict_step_ms", type=float, default=None,
                    help="the step time the prediction stands on (required with it)")
    ap.add_argument("--link_bytes_per_s", type=float, default=None,
                    help="the link bandwidth the prediction assumes (required with it)")
    args = ap.parse_args(argv)
    predict = (args.predict_chips, args.predict_step_ms, args.link_bytes_per_s)
    if any(v is not None for v in predict) and None in predict:
        ap.error("--predict_chips, --predict_step_ms and --link_bytes_per_s go together")
    points = sweep(args.widths, per_device_batch=args.per_device_batch, image_px=args.image_px,
                   num_filters=args.num_filters, device=args.device)
    rep = report(points, device=args.device, workload=(
        f"resnet18 (width {args.num_filters}) synthetic {args.image_px}x{args.image_px}, "
        "cross-entropy, sgd+momentum"))
    rep["collectives"] = collective_footprint(_model(args.num_filters))
    if args.predict_chips is not None:
        rep["link_prediction"] = predict_link_efficiency(
            rep["collectives"]["total"]["bytes"], chips=args.predict_chips,
            step_compute_s=args.predict_step_ms / 1e3, link_bytes_per_s=args.link_bytes_per_s)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
