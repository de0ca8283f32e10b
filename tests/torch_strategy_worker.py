"""Worker bodies for the data x pipeline and FSDP tests
(``tests/test_torch_gpipe_dp.py``, ``test_torch_fsdp.py``,
``test_torch_hybrid_fsdp.py``), run on every rank of a gloo world that
:func:`pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel.spawn_tp`
starts (its strategy argument unused): module-level functions in a module
that imports torch, numpy and the port only, so the ranks start without
JAX. Each reads what the parent converted from the JAX package out of a
work directory, runs its file's cases and returns what the parent
compares."""

from __future__ import annotations

import os

import torch
from torch.nn.utils import parametrize

from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    MLP,
    TransformerConfig,
    TransformerLM,
    resnet18,
)
from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import BatchNorm
from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
    FSDP,
    DataParallel,
    GPipe,
    HybridFSDP,
    create_mesh,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.fsdp import param_names
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import shard_params
from pytorch_distributed_training_tutorials_tpu_torch.train import trainer as ttrainer
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw, sgd

LM_LR = 3e-4


def _load(workdir: str, name: str) -> dict:
    torch.set_num_threads(1)
    return torch.load(os.path.join(workdir, name))


def gpipe_dp_case(world_tp, workdir: str) -> dict:
    """World 4, ``{"data": 4, "stage": 2}`` (both stages on the CPU): one
    GPipe step of the float64-compute ResNet-18 from the bridged JAX
    weights on the global batch; the microbatch refusal at this width."""
    saved = _load(workdir, "gpipe.pt")
    model = resnet18(num_classes=10, stem="cifar", num_filters=saved["nf"],
                     dtype=torch.float64)
    model.load_state_dict(saved["state"])
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mean, m.var = m.mean.double(), m.var.double()
    mesh = create_mesh({"data": 4, "stage": 2}, device="cpu", stage_devices=["cpu", "cpu"])
    pipe = GPipe(model, mesh, num_microbatches=saved["m"], loss="mse", optimizer=sgd(saved["lr"]))
    out = {"dp": (pipe.dp_size, pipe.dp_rank),
           "loss": float(pipe.train_step(saved["x"], saved["y"])),
           "state": {k: v.clone() for k, v in model.state_dict().items()}}
    pipe.num_microbatches = 8  # microbatches of 2 rows over 4 data ranks
    try:
        pipe.train_step(saved["x"], saved["y"])
    except ValueError as e:
        out["refusal"] = str(e)
    return out


# -- FSDP ---------------------------------------------------------------------


def _mlp(saved, features) -> MLP:
    m = MLP(features=features, in_dim=saved["x"].shape[1])
    m.load_state_dict(saved[f"mlp{len(features)}"])
    return m


def _steps(strategy, model, x, y, steps: int, **step_kw) -> dict:
    """``steps`` train steps of ``model`` under ``strategy`` on the global
    batch (x, y), Adam (AdamW without decay) 1e-3: losses, the parameters
    as the model sees them (gathered), the collectives a step."""
    state = strategy.shard_state(ttrainer.TrainState.create(model=model,
                                                            tx=adamw(1e-3, weight_decay=0.0)))
    step = ttrainer.make_train_step("cross_entropy", **step_kw)
    losses = []
    if hasattr(strategy, "reset_collectives"):
        strategy.reset_collectives()
    for _ in range(steps):
        state, metrics = step(state, strategy.shard_batch((x, y)))
        losses.append(float(metrics["loss"]))
    out = {"losses": losses, "collectives": dict(getattr(strategy, "collectives", {}))}
    out["params"] = {n: _read(model, n).detach().clone() for n in param_names(model)}
    out["shapes"] = {n: tuple(p.shape) for n, p in zip(param_names(model), model.parameters())}
    out["moments"] = [tuple(m.shape) for m in state.opt_state.mu]
    return out


def _read(model, name: str) -> torch.Tensor:
    prefix, _, leaf = name.rpartition(".")
    return getattr(model.get_submodule(prefix), leaf)


def _dropped_reduce_scatter(fsdp: FSDP) -> None:
    """The planted fault: the gradient's reduce-scatter skipped — each
    rank keeps its block of its own gradient."""
    def local_block(grad, dim):
        n = grad.shape[dim] // fsdp.num_devices
        return grad.narrow(dim, fsdp.rank * n, n).contiguous()

    fsdp.reduce_scatter_mean = local_block


def _flag_case(mesh, saved) -> dict:
    """The guarded update with one NaN in rank 1's shard gradient only:
    both ranks' flags are 0 after the data group's MIN, and every
    parameter stays bitwise."""
    fsdp = FSDP(mesh, min_size=64)
    model = _mlp(saved, (64, 4))
    state = fsdp.shard_state(ttrainer.TrainState.create(model=model, tx=adamw(1e-3)))
    before = [p.detach().clone() for p in state.params]
    grads = [torch.full_like(p, 0.01) for p in state.params]
    if fsdp.rank == 1:
        grads[0].view(-1)[0] = float("nan")  # a sharded leaf (denses.0's bias or weight)
    state, metrics = ttrainer._apply_update(state, grads, torch.tensor(1.0), skip_nonfinite=True)
    return {"skipped": int(metrics["skipped"]), "step": int(state.step),
            "unchanged": all(torch.equal(a, b) for a, b in zip(before, state.params)),
            "flag_min": fsdp.collectives.get("flag_min", 0)}


def fsdp_case(world_tp, workdir: str, steps: int) -> dict:
    """World 2, ``{"data": 2}``: the placement plans of an MLP with a
    (64, 64) kernel and of a ResNet-18; ``steps`` steps of the MLP under
    FSDP, under DataParallel and under FSDP with its reduce-scatter
    dropped; the skip flag's agreement; a Trainer run and its refusals."""
    saved = _load(workdir, "fsdp.pt")
    mesh = create_mesh(device="cpu")
    fsdp = FSDP(mesh, min_size=64)
    out = {"rank": fsdp.rank, "route": fsdp.route, "num_devices": fsdp.num_devices}
    r18 = resnet18(num_classes=10, stem="cifar", num_filters=16, in_channels=1)
    out["plans"] = {
        "mlp3": {n: fsdp.leaf_plan(_mlp(saved, (64, 64, 4)), n) for n in
                 param_names(_mlp(saved, (64, 64, 4)))},
        "resnet18": {n: FSDP(mesh).leaf_plan(r18, n) for n in param_names(r18)},
    }
    x, y = saved["x"], saved["y"]
    out["fsdp"] = _steps(fsdp, _mlp(saved, (64, 4)), x, y, steps)
    out["audit"] = fsdp.audit(_mlp(saved, (64, 4)))
    out["variable_shardings"] = fsdp.variable_shardings(_mlp(saved, (64, 4)))
    out["dp"] = _steps(DataParallel(mesh), _mlp(saved, (64, 4)), x, y, steps)
    planted = FSDP(mesh, min_size=64)
    _dropped_reduce_scatter(planted)
    out["planted"] = _steps(planted, _mlp(saved, (64, 4)), x, y, steps)
    out["flag"] = _flag_case(mesh, saved)
    out["trainer"] = _trainer_case(mesh, saved, workdir)
    return out


def _trainer_case(mesh, saved, workdir: str) -> dict:
    """``Trainer(strategy=FSDP)`` on the class-separable set: first and
    last epoch losses, the kernel's shape after training, and a
    checkpoint's round trip (saved, the shard overwritten, restored)."""
    fsdp = FSDP(mesh, min_size=64)
    loader = ShardedLoader(ArrayDataset((saved["train_x"].numpy(), saved["train_y"].numpy())), 8,
                           mesh)
    trainer = ttrainer.Trainer(MLP(features=(64, 4), in_dim=16), loader,
                               adamw(1e-3, weight_decay=0.0), strategy=fsdp,
                               loss="cross_entropy", quiet=True)
    first = trainer._run_epoch(0)["loss"]
    trainer.epoch = 1
    last = trainer.train(5)["loss"]
    refusals = []
    kernel = trainer.model.denses[0].parametrizations.weight.original
    before = kernel.detach().clone()
    try:
        trainer.save(os.path.join(workdir, "trainer_ckpt"))
        with torch.no_grad():
            kernel.zero_()
        trainer.restore(os.path.join(workdir, "trainer_ckpt"))
    except NotImplementedError as e:
        refusals.append(str(e))
    return {"first": first, "last": last, "kernel_shard": tuple(kernel.shape),
            "moment": tuple(trainer.state.opt_state.mu[0].shape), "refusals": refusals,
            "restored": torch.equal(kernel, before), "sharded": fsdp.sharded}


# -- HybridFSDP -----------------------------------------------------------------


def hybrid_case(world_tp, workdir: str, steps: int) -> dict:
    """World 4, ``{"data": 2, "model": 2}``: the hybrid plan of every
    leaf, the physical shard of ``gate_proj``, then ``steps`` Trainer
    steps from the bridged JAX weights (the rank's tensor-parallel shard
    assigned through the gathers)."""
    saved = _load(workdir, "hybrid.pt")
    cfg = TransformerConfig(**saved["spec"])
    mesh = create_mesh({"data": 2, "model": 2}, device="cpu")
    from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import TP_RULES

    strategy = HybridFSDP(mesh, TP_RULES, min_size=saved["min_size"])
    x, y = saved["x"], saved["y"]
    loader = ShardedLoader(ArrayDataset((x.numpy(), y.numpy())), x.shape[0], mesh,
                           batch_mode="global", shuffle=False)
    trainer = ttrainer.Trainer(TransformerLM(cfg), loader, adamw(LM_LR, weight_decay=0.01),
                               strategy=strategy, loss="cross_entropy", quiet=True)
    tp = strategy.tp
    start = shard_params(saved["params"], tp.rank, tp.tp_size, head_dim=cfg.head_dim)
    with torch.no_grad():
        for name in param_names(trainer.model):
            prefix, _, leaf = name.rpartition(".")
            module = trainer.model.get_submodule(prefix)
            if parametrize.is_parametrized(module, leaf):
                setattr(module, leaf, start[name])  # the rank's shard, through right_inverse
            else:
                getattr(module, leaf).copy_(start[name])
    gate = trainer.model.blocks[0].mlp.gate_proj
    out = {"rank": tp.rank, "data_rank": tp.data_rank, "route": strategy.route,
           "plans": dict(strategy.plan), "audit": strategy.audit(trainer.model),
           "gate_shard": tuple(gate.parametrizations.weight.original.shape),
           "gate_moment": None}
    names = param_names(trainer.model)
    out["variable_shardings"] = strategy.variable_shardings(trainer.model)
    try:
        strategy.spec_for((64, 256))
    except NotImplementedError as e:
        out["spec_for"] = str(e)
    out["gate_moment"] = tuple(
        trainer.state.opt_state.mu[[i for i, n in enumerate(names)
                                    if n == "blocks.0.mlp.gate_proj.weight"][0]].shape)
    strategy.reset_collectives()
    tp.reset_collectives()
    trainer.train(steps)
    out["train"] = {"losses": [e["loss"] for e in trainer.metrics.step_events()],
                    "params": {n: _read(trainer.model, n).detach().clone() for n in names},
                    "step": int(trainer.state.step)}
    out["fsdp_collectives"] = dict(strategy.collectives)
    out["tp_collectives"] = dict(tp.collectives)
    out["train"]["eval"] = trainer.evaluate()
    # the placements at chip_smoke.py's train_lm_hybrid_fsdp config (the
    # model on the meta device: shapes only)
    big = TransformerLM(TransformerConfig(**saved["chip_cfg"]))
    chip = HybridFSDP(mesh, TP_RULES)
    out["chip_plans"] = {n: chip.leaf_plan(big, n) for n in param_names(big)}
    return out
