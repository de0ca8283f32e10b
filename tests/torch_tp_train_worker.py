"""Worker bodies for the tensor-parallel training tests
(``tests/test_torch_tp_fused_loss.py``, ``test_torch_tp_train.py``,
``test_torch_tp_train_dp.py``), run on every rank of a gloo world that
:func:`pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel.spawn_tp`
starts: module-level functions (the spawn start method pickles them by
name) in a module that imports torch, numpy and the port only, so the
ranks start without JAX. Each builds its mesh over the world
(``{"model": 2}`` or ``{"data": 2, "model": 2}``), reads the operands the
parent converted from the JAX package out of a work directory, runs every
case of its file and returns what the parent compares."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_training_tutorials_tpu_torch.data import (
    ArrayDataset,
    ChunkedStreamingLoader,
    DeviceResidentLoader,
    ShardedLoader,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    bind_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_loss import (
    fused_cross_entropy_tp,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import create_mesh
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
    shard_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.train import trainer as ttrainer
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw
from pytorch_distributed_training_tutorials_tpu_torch.utils.chaos import ChaosConfig

LR = 3e-4


def _strategy(axes: dict) -> TensorParallel:
    torch.set_num_threads(1)
    return TensorParallel(create_mesh(axes, device="cpu"))


def fused_ce_case(world_tp, workdir: str, axes: dict) -> dict:
    """``fused_cross_entropy_tp`` on the operands of ``workdir/fce.pt`` (h
    (N, D), W (D, V), y (N,)): this rank's vocab shard of W, its data
    coordinate's block of rows; the backward of the rows' share of the
    global mean (``loss.sum() / N``), dW then summed over the data axis —
    what the JAX op's ``psum`` over ``data`` is, so dW's data sum happens
    once, here."""
    tp = _strategy(axes)
    ops = torch.load(os.path.join(workdir, "fce.pt"))
    h, w, y = ops["h"], ops["w"], ops["y"]
    n, v = h.shape[0], w.shape[1]
    vl, rows = v // tp.tp_size, n // tp.num_devices
    lo = tp.data_rank * rows
    hl = h[lo:lo + rows].clone().requires_grad_(True)
    wl = w[:, tp.rank * vl:(tp.rank + 1) * vl].contiguous().requires_grad_(True)
    loss = fused_cross_entropy_tp(hl, wl, y[lo:lo + rows], tp, vocab_size=v,
                                  block_n=16, block_v=8)
    (loss.sum() / n).backward()
    dw = wl.grad.clone()
    if tp.data_group is not None:
        dist.all_reduce(dw, group=tp.data_group)
    return {"rank": tp.rank, "data_rank": tp.data_rank, "rows": (lo, lo + rows),
            "loss": loss.detach(), "dh": hl.grad, "dw": dw,
            "collectives": dict(tp.collectives), "errors": _refusals(tp, h, w, y)}


def _refusals(tp, h, w, y) -> list:
    """The messages of the op's ValueErrors on a group of ``tp_size`` > 1:
    a vocabulary the group does not divide, a W that is not the rank's
    shard, hidden and targets that do not match; none issues a
    collective."""
    v, vl = w.shape[1], w.shape[1] // tp.tp_size
    shard = w[:, :vl].contiguous()
    calls = [(h, shard, y, v + 1), (h, w, y, v), (h[:-1], shard, y, v)]
    out = []
    for hh, ww, yy, vocab in calls:
        try:
            fused_cross_entropy_tp(hh, ww, yy, tp, vocab_size=vocab)
        except ValueError as e:
            out.append(str(e))
    return out


def _whole(workdir: str):
    saved = torch.load(os.path.join(workdir, "train.pt"))
    return saved, TransformerConfig(**saved["spec"])


def _trainer(tp, saved, cfg, loss: str, **options):
    """A ``Trainer`` over the strategy's mesh, its model rebuilt as this
    rank's shard and started from the rank's shard of the bridged JAX
    weights (``saved["params"]``)."""
    x, y = saved["x"], saved["y"]
    loader = ShardedLoader(ArrayDataset((x.numpy(), y.numpy())), x.shape[0], tp.mesh,
                           batch_mode="global",
                           shuffle=False)
    trainer = ttrainer.Trainer(TransformerLM(cfg), loader, adamw(LR, weight_decay=0.01),
                               strategy=tp, loss=loss, quiet=True, **options)
    start = shard_params(saved["params"], tp.rank, tp.tp_size, head_dim=cfg.head_dim)
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            p.copy_(start[name])
    return trainer


def _run(tp, saved, cfg, loss: str, steps: int, **options) -> dict:
    trainer = _trainer(tp, saved, cfg, loss, **options)
    tp.reset_collectives()
    trainer.train(steps)
    out = {
        "losses": [e["loss"] for e in trainer.metrics.step_events()],
        "collectives": dict(tp.collectives),
        "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
        "step": int(trainer.state.step), "skipped": trainer.steps_skipped,
    }
    out["eval"] = trainer.evaluate()
    return out


def _grads(model, loss: str, x, y, plant_double_dh: bool = False) -> dict:
    """One loss's value and gradients by name. ``plant_double_dh``: a
    Megatron ``f`` in front of the fused head as well — the fault of
    summing dh twice (the op sums it already)."""
    if loss == "fused_cross_entropy":
        hidden = model(x, return_hidden=True)
        if plant_double_dh:
            hidden = model.lay.tp.copy_to(hidden)
        value = ttrainer._fused_ce_loss(model, hidden, y)
    else:
        value = ttrainer._compute_loss("cross_entropy", model(x), y)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(value, [p for _, p in model.named_parameters()])
    return {"loss": value.detach(), "grads": dict(zip(names, grads))}


def train_case(world_tp, workdir: str, steps: int) -> dict:
    """World 2, ``{"model": 2}``: the TP forward's gathered logits, one
    step's gradients under both losses (and with a planted double dh sum)
    and their collectives; the skip flag's agreement when only rank 1's
    shard gradients are non-finite; then ``steps`` Trainer steps under
    each loss from the bridged weights."""
    tp = _strategy({"model": 2})
    saved, cfg = _whole(workdir)
    model = TransformerLM(dataclasses.replace(cfg, int8_mesh=tp))
    bind_params(model, shard_params(saved["params"], tp.rank, 2, head_dim=cfg.head_dim))
    x, y = saved["x"], saved["y"]
    out = {"rank": tp.rank}
    tp.reset_collectives()
    out["logits"] = model(x).detach()  # autograd on: f before the head, the gather
    out["forward_collectives"] = dict(tp.collectives)
    for loss in ("cross_entropy", "fused_cross_entropy"):
        tp.reset_collectives()
        out[loss] = _grads(model, loss, x, y)
        out[loss]["collectives"] = dict(tp.collectives)
    out["planted_double_dh"] = _grads(model, "fused_cross_entropy", x, y, plant_double_dh=True)
    out["flag"] = _flag_case(tp, model)
    for loss in ("cross_entropy", "fused_cross_entropy"):
        out[f"train_{loss}"] = _run(tp, saved, cfg, loss, steps)
    return out


def _flag_case(tp, model) -> dict:
    """The guarded update with one NaN in rank 1's shard gradients only:
    every rank's flag is 0 after the model group's MIN, and every rank's
    parameters and optimizer state stay bitwise."""
    state = tp.shard_state(ttrainer.TrainState.create(model=model,
                                                      tx=adamw(LR, weight_decay=0.01)))
    before = [p.detach().clone() for p in state.params]
    grads = [torch.full_like(p, 0.01) for p in state.params]
    if tp.rank == 1:
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        grads[names.index("blocks.0.attn.q_proj.weight")][0, 0] = float("nan")
    tp.reset_collectives()
    state, metrics = ttrainer._apply_update(state, grads, torch.tensor(1.0),
                                            skip_nonfinite=True)
    return {"skipped": int(metrics["skipped"]), "step": int(state.step),
            "count": int(state.opt_state.count),
            "unchanged": all(torch.equal(a, b) for a, b in zip(before, state.params)),
            "collectives": dict(tp.collectives)}


def train_dp_case(world_tp, workdir: str, steps: int) -> dict:
    """World 4, ``{"data": 2, "model": 2}``: ``steps`` Trainer steps under
    each loss; the guarded run with a chaos NaN gradient at its last step against
    a clean run one step shorter (the same batch every step, so an elided
    step leaves the state bitwise the shorter run's); and the rows each
    loader hands this rank."""
    axes = {"data": 2, "model": 2}
    tp = _strategy(axes)
    saved, cfg = _whole(workdir)
    out = {"rank": tp.rank, "data_rank": tp.data_rank, "num_devices": tp.num_devices,
           "mesh_shape": tp.mesh_shape}
    for loss in ("cross_entropy", "fused_cross_entropy"):
        out[f"train_{loss}"] = _run(tp, saved, cfg, loss, steps)
    # the last step's gradients poisoned (the injector keys on the state's
    # step, which a skip freezes: a later step would re-fire)
    out["chaos"] = _run(tp, saved, cfg, "fused_cross_entropy", steps, skip_nonfinite=True,
                        chaos=ChaosConfig(nan_grad_step=steps - 1))
    out["clean_shorter"] = _run(tp, saved, cfg, "fused_cross_entropy", steps - 1,
                                skip_nonfinite=True)
    out["loaders"] = _loader_rows(tp)
    return out


def _loader_rows(tp) -> dict:
    """The first epoch's rows of the three loaders on this rank: a
    dataset whose row i holds i."""
    ds = ArrayDataset((np.arange(32, dtype=np.int64)[:, None],))
    kinds = {
        "sharded": ShardedLoader(ds, 4, tp.mesh, shuffle=True, seed=3),
        "resident": DeviceResidentLoader(ds, 4, tp.mesh, shuffle=True, seed=3),
        "streaming": ChunkedStreamingLoader(ds, 4, tp.mesh, shuffle=True, seed=3,
                                            steps_per_chunk=2),
    }
    out = {}
    for name, loader in kinds.items():
        loader.set_epoch(0)
        if name == "streaming":
            rows = [loader.chunk_step(c, i) for c in loader.iter_chunks()
                    for i in range(c[0].shape[0])]
        else:
            rows = list(loader)
        out[name] = torch.cat([r.reshape(-1) for r in rows]).tolist()
    return out
