"""Worker bodies for the sequence-, pipeline- and expert-parallel tests
(``tests/test_torch_seq_parallel.py``, ``test_torch_seq_tp.py``,
``test_torch_pipeline_spmd.py``, ``test_torch_moe_ep.py``), run on every
rank of a gloo world that
:func:`pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel.spawn_tp`
starts (its strategy argument unused): module-level functions in a module
that imports torch, numpy and the port only, so the ranks start without
JAX. Each builds its mesh over the world, reads the operands the parent
converted from the JAX package out of a work directory, runs its file's
cases and returns what the parent compares."""

from __future__ import annotations

import os

import torch

from pytorch_distributed_training_tutorials_tpu_torch.data import ArrayDataset, ShardedLoader
from pytorch_distributed_training_tutorials_tpu_torch.models import (
    MOE_RULES,
    TP_RULES,
    TransformerConfig,
    TransformerLM,
    bind_params,
    ep_rules,
    generate,
    moe_dropped,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel import (
    PipelinedTransformerLM,
    PipelineParallel,
    TensorParallel,
    create_mesh,
    make_ring_attention,
    make_ulysses_attention,
    shard_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.pipeline_spmd import (
    expected_messages,
)
from pytorch_distributed_training_tutorials_tpu_torch.train import trainer as ttrainer
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import adamw

LR = 3e-4
AUX = 0.01


def _load(workdir: str, name: str) -> dict:
    torch.set_num_threads(1)
    return torch.load(os.path.join(workdir, name))


def rank_params(whole: dict, tp: TensorParallel, head_dim: int) -> dict:
    """This rank's entries of a whole state dict under ``tp``: its
    tensor-parallel shard, then its block of the stacked experts."""
    out = shard_params(whole, tp.rank, tp.tp_size, head_dim=head_dim)
    if tp.ep_size > 1:
        out = shard_params(out, tp.ep_rank, tp.ep_size, head_dim=1, rules=MOE_RULES)
    return out


def _trainer(model, mesh, strategy, saved, *, batch_spec=None, aux_loss_weight=0.0):
    """A ``Trainer`` on the saved batch (one step an epoch), started from
    the bridged JAX weights (``saved["params"]``): the rank's entries."""
    x, y = saved["x"], saved["y"]
    loader = ShardedLoader(ArrayDataset((x.numpy(), y.numpy())), x.shape[0], mesh,
                           batch_mode="global", shuffle=False, batch_spec=batch_spec)
    trainer = ttrainer.Trainer(model, loader, adamw(LR, weight_decay=0.01), strategy=strategy,
                               loss="cross_entropy", quiet=True,
                               aux_loss_weight=aux_loss_weight)
    if isinstance(trainer.model, PipelinedTransformerLM):
        start = trainer.model.stage_params(saved["params"])
    else:
        start = rank_params(saved["params"], strategy, trainer.model.cfg.head_dim)
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            p.copy_(start[name])
    return trainer


def _train(trainer, steps: int) -> dict:
    trainer.train(steps)
    return {"losses": [e["loss"] for e in trainer.metrics.step_events()],
            "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
            "step": int(trainer.state.step), "eval": trainer.evaluate()}


def _grads(model, x, y, aux_loss_weight: float = 0.0) -> dict:
    """One objective's value and gradients by name (the Trainer's loss)."""
    value = ttrainer._make_loss_fn("cross_entropy", aux_loss_weight=aux_loss_weight)(
        model, (x, y))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(value, [p for p in model.parameters() if p.requires_grad])
    return {"loss": value.detach(), "grads": dict(zip(names, grads))}


def _block(t: torch.Tensor, r: int, n: int, dim: int = 1) -> torch.Tensor:
    k = t.shape[dim] // n
    return t.narrow(dim, r * k, k).contiguous()


def _attention_case(mesh, fn, q, k, v) -> dict:
    """The rank's block of ``fn`` on its blocks of q, k, v and the
    gradients of the global mean of ``out ** 2`` (the JAX tests' loss)."""
    r, n = fn.seq_shard.rank, fn.seq_shard.size
    ql, kl, vl = (_block(t, r, n).requires_grad_(True) for t in (q, k, v))
    out = fn(ql, kl, vl)
    ((out ** 2).sum() / (q.numel())).backward()
    return {"out": out.detach(), "grads": (ql.grad, kl.grad, vl.grad),
            "collectives": dict(fn.seq_shard.collectives)}


def seq_case(world_tp, workdir: str, steps: int) -> dict:
    """World 2, ``{"seq": 2}``: ring attention at two hop blocks and
    Ulysses on the rank's blocks of q, k, v; Ulysses' refusal of a head
    count the seq axis does not divide; the loader's (B, S/n) blocks; for
    each schedule one step's gradients, the same with the RoPE offset
    planted at 0, and ``steps`` Trainer steps over data x seq; greedy
    generation from a prompt the seq axis does not divide."""
    saved = _load(workdir, "seq.pt")
    mesh = create_mesh({"seq": 2}, device="cpu")
    r = mesh.get_local_rank("seq")
    q, k, v = saved["q"], saved["k"], saved["v"]
    out = {"rank": r, "attention": {}}
    for name, fn in (("ring_8", make_ring_attention(mesh, hop_block=8)),
                     ("ring_16", make_ring_attention(mesh, hop_block=16)),
                     ("ulysses", make_ulysses_attention(mesh))):
        out["attention"][name] = _attention_case(mesh, fn, q, k, v)
    try:
        make_ulysses_attention(mesh)(*(_block(t, r, 2)[:, :, :3] for t in (q, k, v)))
    except ValueError as e:
        out["ulysses_refusal"] = str(e)
    ds = ArrayDataset((saved["x"].numpy(), saved["y"].numpy()))
    xb, yb = next(iter(ShardedLoader(ds, saved["x"].shape[0], mesh, batch_mode="global",
                                     shuffle=False, batch_spec=("data", "seq"))))
    out["loader"] = (xb, yb)
    x, y = _block(saved["x"], r, 2), _block(saved["y"], r, 2)
    for name, make in (("ring", make_ring_attention), ("ulysses", make_ulysses_attention)):
        fn = make(mesh)
        cfg = TransformerConfig(**saved["spec"], attention_fn=fn)
        tp = TensorParallel(mesh, [], seq_axis="seq")
        model = TransformerLM(dataclass_replace(cfg, int8_mesh=tp))
        bind_params(model, {k_: t.clone() for k_, t in saved["params"].items()})
        fn.seq_shard.reset_collectives()
        out[name] = _grads(model, x, y)
        out[name]["collectives"] = dict(fn.seq_shard.collectives)
        fn.seq_shard.position_offset = lambda s_local: 0  # the planted fault
        out[name]["planted_offset_0"] = _grads(model, x, y)
        del fn.seq_shard.position_offset
        trainer = _trainer(TransformerLM(cfg), mesh, tp, saved, batch_spec=("data", "seq"))
        tp.reset_collectives()
        fn.seq_shard.reset_collectives()
        out[name]["train"] = _train(trainer, steps)
        out[name]["train"]["collectives"] = dict(tp.collectives)
        out[name]["train"]["attention_collectives"] = dict(fn.seq_shard.collectives)
    cfg = TransformerConfig(**saved["spec"], attention_fn=make_ring_attention(mesh))
    out["generate"] = generate(TransformerLM(cfg), saved["params"], saved["prompt"],
                               saved["new"], device="cpu")
    return out


def dataclass_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def seq_tp_case(world_tp, workdir: str, steps: int) -> dict:
    """World 4, ``{"seq": 2, "model": 2}`` (the ``tp_sp`` mode of the JAX
    ``examples/train_llm_3d.py``): ring attention over the rank's heads,
    ``TensorParallel(mesh, TP_RULES, seq_axis="seq")``, ``steps`` Trainer
    steps on (B, S/2) blocks; the rank's mesh coordinates."""
    saved = _load(workdir, "seq_tp.pt")
    mesh = create_mesh({"seq": 2, "model": 2}, device="cpu")
    fn = make_ring_attention(mesh)
    tp = TensorParallel(mesh, TP_RULES, seq_axis="seq")
    cfg = TransformerConfig(**saved["spec"], attention_fn=fn)
    trainer = _trainer(TransformerLM(cfg), mesh, tp, saved, batch_spec=("data", "seq"))
    tp.reset_collectives()
    fn.seq_shard.reset_collectives()
    out = _train(trainer, steps)
    out.update(rank=torch.distributed.get_rank(), seq_rank=tp.seq_rank, model_rank=tp.rank,
               mesh_shape=tp.mesh_shape, collectives=dict(tp.collectives),
               attention_collectives=dict(fn.seq_shard.collectives))
    return out


def pipeline_case(world_tp, workdir: str, steps: int) -> dict:
    """World 2, ``create_mesh({"data": 1, "stage": 2}, stage_ranks=True)``:
    the pipelined forward's logits at M 1, 2 and 4, one step's gradients
    at M 2 with the messages it sent against the schedule's count, the
    strategy's gradient sync (the embedding's stage sum), ``steps``
    ``Trainer`` steps under ``PipelineParallel``, and the refusals."""
    saved = _load(workdir, "pipeline.pt")
    mesh = create_mesh({"data": 1, "stage": 2}, device="cpu", stage_ranks=True)
    cfg = TransformerConfig(**saved["spec"])
    x, y = saved["x"], saved["y"]
    out = {"logits": {}}
    for m in (1, 2, 4):
        model = PipelinedTransformerLM(cfg, mesh, num_microbatches=m)
        bind_params(model, model.stage_params({k: t.clone() for k, t in saved["params"].items()}))
        with torch.no_grad():
            out["logits"][m] = model(x)
    out["stage"], out["layers"] = model.stages.stage, list(model.layers)
    model.stages.reset_collectives()
    model = PipelinedTransformerLM(cfg, mesh, num_microbatches=2)
    bind_params(model, model.stage_params({k: t.clone() for k, t in saved["params"].items()}))
    out["grads"] = _grads(model, x, y)
    out["messages"] = dict(model.stages.collectives)
    out["expected_messages"] = expected_messages(model.stages.stage, 2, 2)
    strategy = PipelineParallel(mesh, num_microbatches=2)
    state = strategy.shard_state(ttrainer.TrainState.create(model=model, tx=adamw(LR)))
    synced = [g.clone() for g in out["grads"]["grads"].values()] + [out["grads"]["loss"].clone()]
    state.grad_sync(synced)
    out["synced"] = dict(zip(out["grads"]["grads"], synced))
    out["sync_collectives"] = dict(strategy.stages.collectives)
    trainer = _trainer(PipelinedTransformerLM(cfg, mesh, num_microbatches=2), mesh,
                       PipelineParallel(mesh, num_microbatches=2), saved)
    out["train"] = _train(trainer, steps)
    out["refusals"] = _pipeline_refusals(cfg, mesh, x)
    return out


def _pipeline_refusals(cfg, mesh, x) -> list:
    """The ValueErrors of the JAX module's refusals: a layer count the
    stages do not divide, MoE blocks, a batch the microbatches do not
    divide, a sequence over ``max_seq_len``."""
    calls = [
        lambda: PipelinedTransformerLM(dataclass_replace(cfg, n_layers=3), mesh,
                                       num_microbatches=2),
        lambda: PipelinedTransformerLM(dataclass_replace(cfg, moe_experts=4), mesh,
                                       num_microbatches=2),
        lambda: PipelinedTransformerLM(cfg, mesh, num_microbatches=4, device="cpu")(x[:3]),
        lambda: PipelinedTransformerLM(cfg, mesh, num_microbatches=1, device="cpu")(
            torch.zeros((2, cfg.max_seq_len + 1), dtype=torch.int64)),
    ]
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def moe_ep_case(world_tp, workdir: str, steps: int) -> dict:
    """World 2, ``{"expert": 2}`` with ``ep_rules()``: the rank's shard
    shapes, one step's gradients of the objective with the aux loss (and
    with the aux loss counted twice, the planted fault), the dropped
    counts of that forward and the expert group's collectives, then
    ``steps`` Trainer steps with ``aux_loss_weight``."""
    saved = _load(workdir, "moe_ep.pt")
    mesh = create_mesh({"expert": 2}, device="cpu")
    tp = TensorParallel(mesh, ep_rules())
    cfg = TransformerConfig(**saved["spec"])
    model = TransformerLM(dataclass_replace(cfg, int8_mesh=tp))
    bind_params(model, rank_params(saved["params"], tp, cfg.head_dim))
    out = {"ep_rank": tp.ep_rank, "ep_size": tp.ep_size,
           "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}
    tp.reset_collectives()
    out["step"] = _grads(model, saved["x"], saved["y"], AUX)
    out["step"]["collectives"] = dict(tp.expert.collectives)
    out["dropped"] = [int(d) for d in moe_dropped(model)]
    out["planted_aux_twice"] = _grads(model, saved["x"], saved["y"], 2 * AUX)
    trainer = _trainer(TransformerLM(cfg), mesh, TensorParallel(mesh, ep_rules()), saved,
                       aux_loss_weight=AUX)
    trainer.strategy.reset_collectives()
    out["train"] = _train(trainer, steps)
    out["train"]["collectives"] = dict(trainer.strategy.expert.collectives)
    return out
