"""Worker bodies for the tests of the port's examples and FSDP checkpoints
(``tests/test_torch_fsdp_ckpt.py``, ``test_torch_examples_train.py``,
``test_torch_examples_train_world4.py``), run on every rank of a gloo
world that
:func:`pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel.spawn_tp`
starts: module-level functions in a module that imports torch, numpy and
the port only, so the ranks start without JAX."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os

import torch

from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.data import mnist as port_mnist
from pytorch_distributed_training_tutorials_tpu_torch.examples import (
    train_llm_3d,
    train_resnet_mnist,
)
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    MLP,
    TransformerConfig,
    TransformerLM,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
    FSDP,
    DataParallel,
    PipelinedTransformerLM,
    TensorParallel,
    create_mesh,
    shard_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.fsdp import param_names
from pytorch_distributed_training_tutorials_tpu_torch.train import Trainer, adamw, sgd
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import SGD, SGDState

RESNET_ROWS = 256
RESNET_TEST_ROWS = 64


# -- FSDP checkpoints ----------------------------------------------------------


@dataclasses.dataclass
class _TallyState(SGDState):
    """SGD's state and a list field that is not per-parameter although it
    has a parameter's count of entries: one (2,) tally each."""

    tally: list[torch.Tensor] = dataclasses.field(default_factory=list)


class _TallySGD(SGD):
    def init(self, params):
        return _TallyState(trace=super().init(params).trace,
                           tally=[torch.zeros(2) for _ in params])

    def update_(self, params, grads, state, ok=None):
        super().update_(params, grads, state, ok)
        for i, t in enumerate(state.tally):
            t.add_(torch.tensor([1.0, float(i)]))


def _mlp_trainer(saved, strategy, opt="adamw", **kw):
    mesh = create_mesh(device="cpu")
    loader = ShardedLoader(ArrayDataset((saved["x"].numpy(), saved["y"].numpy())), 8, mesh)
    tx = {"adamw": lambda: adamw(1e-2, weight_decay=0.0),
          "sgd": lambda: sgd(1e-2, momentum=0.9),
          "tally": lambda: _TallySGD(lr=1e-2, momentum=0.9)}[opt]()
    return Trainer(MLP(features=(64, 4), in_dim=16), loader, tx,
                   strategy=strategy(mesh) if strategy else None, loss="cross_entropy",
                   quiet=True, **kw)


def _shards(trainer) -> dict:
    """The rank's parameters (shards under FSDP) and optimizer moments,
    each moment under its parameter's unsharded name."""
    opt, model = trainer.state.opt_state, trainer.state.model
    names = [n for n, p in zip(param_names(model), model.parameters()) if p.requires_grad]
    moments = {k: {n: t.clone() for n, t in zip(names, getattr(opt, k))}
               for k in ("mu", "nu", "trace", "tally")
               if isinstance(getattr(opt, k, None), list)}
    return {"model": {k: v.clone() for k, v in trainer.model.state_dict().items()},
            "moments": moments, "step": int(trainer.state.step), "epoch": trainer.epoch}


def fsdp_ckpt_case(world_tp, workdir: str) -> dict:
    """World 2, ``{"data": 2}``: FSDP save -> overwrite -> restore for AdamW
    and SGD-momentum states, and for an SGD state with a list field that
    is not per-parameter (``_TallySGD``); a DataParallel checkpoint (written at world 1
    by the parent) restored under FSDP; an FSDP checkpoint restored under
    DataParallel in the world; a loss-spike rollback under FSDP; the
    tensor-parallel refusal."""
    torch.set_num_threads(1)
    saved = torch.load(os.path.join(workdir, "data.pt"))
    fsdp = lambda mesh: FSDP(mesh, min_size=64)  # noqa: E731
    out = {"rank": world_tp.rank}
    for opt in ("adamw", "sgd", "tally"):
        t = _mlp_trainer(saved, fsdp, opt)
        t.train(1)
        path = os.path.join(workdir, f"fsdp_{opt}")
        t.save(path)
        before = _shards(t)
        t.train(2)  # move on, then go back
        t.restore(path)
        out[opt] = {"before": before, "after": _shards(t),
                    "collectives": dict(t.strategy.collectives)}
    # the world-1 DataParallel checkpoint into an FSDP state
    t = _mlp_trainer(saved, fsdp)
    t.restore(os.path.join(workdir, "dp_world1"))
    out["from_dp"] = _shards(t)
    out["plan"] = {n: p.dim for n, p in t.strategy.plan.items()}
    # the FSDP checkpoint into a DataParallel state in the same world
    d = _mlp_trainer(saved, lambda mesh: DataParallel(mesh))
    d.restore(os.path.join(workdir, "fsdp_adamw"))
    out["to_dp"] = _shards(d)
    # rollback: a spike restores the latest save and keeps the data position
    r = _mlp_trainer(saved, fsdp, rollback_spike_factor=10.0)
    r.train(1)
    r.save(os.path.join(workdir, "fsdp_rollback"))
    saved_state = _shards(r)
    r.train(2)
    for _ in range(2):  # rollback_patience spikes in a row
        r._monitor_loss(float("inf"))
    out["rollback"] = {"saved": saved_state, "after": _shards(r), "rollbacks": r.rollbacks}
    # tensor parallelism: its checkpoints stay refused
    cfg = TransformerConfig(vocab_size=32, d_model=32, n_layers=1, n_heads=2, max_seq_len=16)
    mesh = create_mesh({"data": 1, "model": 2}, device="cpu")
    ds = ArrayDataset((saved["tok_x"].numpy(), saved["tok_y"].numpy()))
    tp = Trainer(TransformerLM(cfg), ShardedLoader(ds, 4, mesh), adamw(1e-3),
                 strategy=TensorParallel(mesh), loss="cross_entropy", quiet=True)
    try:
        tp.save(os.path.join(workdir, "tp"))
    except NotImplementedError as e:
        out["tp_refusal"] = str(e)
    return out


# -- the training examples -----------------------------------------------------


def _bind(trainer, whole: dict) -> None:
    """Start ``trainer`` from a whole state dict: the rank's stage, or its
    tensor-parallel shard."""
    model = trainer.model
    if isinstance(model, PipelinedTransformerLM):
        start = model.stage_params(whole)
    else:
        tp = trainer.strategy
        start = shard_params(whole, tp.rank, tp.tp_size, head_dim=model.cfg.head_dim)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(start[name])


def llm_first_step(mode: str, workdir: str, batch_size: int = 8) -> dict:
    """The twin's trainer at ``mode`` from the bridged weights: its first
    step's loss and the global rows of that step."""
    whole = torch.load(os.path.join(workdir, "llm.pt"))
    args = train_llm_3d.build_parser().parse_args(
        ["--mode", mode, "--device", "cpu", "--batch_size", str(batch_size)])
    trainer = train_llm_3d.build(args)
    _bind(trainer, whole)
    loader = trainer.loader
    loader.set_epoch(0)
    rows = loader._epoch_index_matrix()[:, :loader.per_device_batch].reshape(-1)
    batch = next(iter(loader))
    _, m = trainer.train_step(trainer.state, batch)
    return {"loss": float(m["loss"]), "rows": rows.tolist(),
            "axes": train_llm_3d.mesh_axes(mode, torch.distributed.get_world_size())}


_SLICES: dict = {}


def _small_mnist(split: str):
    """A 256-row slice of the training split, 64 rows of the test split
    (made once a process)."""
    if split not in _SLICES:
        rows = RESNET_ROWS if split == "train" else RESNET_TEST_ROWS
        _SLICES[split] = ArrayDataset(tuple(a[:rows] for a in port_mnist(split, raw=True).arrays))
    return _SLICES[split]


def resnet_resume(workdir: str) -> dict:
    """``train_resnet_mnist --fsdp --ckpt`` on a 256-row slice of the
    surrogate: one epoch, then again to two (resumed from the first)."""
    train_resnet_mnist.mnist = _small_mnist
    ckpt = os.path.join(workdir, "resnet_ckpt")
    outs = []
    for epochs in (1, 2):
        args = train_resnet_mnist.build_parser().parse_args(
            ["--device", "cpu", "--fsdp", "--ckpt", ckpt, "--batch_size", "64",
             "--max_epochs", str(epochs)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = train_resnet_mnist.run(args)
        outs.append({"resumed_at": r["resumed_at"], "epoch": r["epoch"], "eval": r["eval"],
                     "stdout": buf.getvalue()})
    return {"runs": outs}


def examples_case(world_tp, workdir: str) -> dict:
    torch.set_num_threads(1)
    return {"pp": llm_first_step("pp", workdir), "resnet": resnet_resume(workdir)}


def examples_world4_case(world_tp, workdir: str) -> dict:
    torch.set_num_threads(1)
    return {mode: llm_first_step(mode, workdir) for mode in ("pp", "tp_sp")}
