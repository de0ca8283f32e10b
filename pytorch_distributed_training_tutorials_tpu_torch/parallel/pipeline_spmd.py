"""Single-program pipeline parallelism over ranks: GPipe with point-to-point
hops, one stage a rank.

Port of the JAX package's ``parallel/pipeline_spmd.py``. The JAX module
shards a ``scan_layers`` stack over the ``stage`` axis of a ``{"data": D,
"stage": S}`` mesh and runs a fill/drain schedule of ``M + S - 1`` ticks
inside ``shard_map``, the hop a ``ppermute``. The port runs the same
program on each of ``D * S`` ranks (``create_mesh({"data": D, "stage":
S}, stage_ranks=True)``): stage rank ``s`` holds layers ``[s * L / S,
(s + 1) * L / S)`` as modules, named as the unpipelined
:class:`..models.transformer.TransformerLM` names them, and the hop to the
next stage is a send on the stage group. Stage ``s`` runs microbatch ``m``
at tick ``s + m``: it receives ``m`` from stage ``s - 1`` (stage 0 takes
it from the embedding), runs its layers and sends the result on; the last
stage keeps the outputs.

Autograd carries the backward across the hops:

- :class:`_Recv` (forward: receive microbatch ``m``; backward: send its
  gradient back) takes the stage's own embedding rows of ``m`` as its
  input and ignores them — the JAX ``where(s == 0, inject, state)`` —
  so the gradient of those rows is an exact 0 and the embedding is in
  every stage's graph;
- :class:`_Send` (forward: send; backward: receive the gradient of what
  it sent) returns a scalar token that joins the stage's output, so the
  backward reaches it;
- the last stage's outputs are broadcast over the stage group
  (:class:`_Broadcast`, the JAX ``psum`` over ``stage``), and every stage
  computes the final norm, the head and the loss on them, as every JAX
  stage does. The broadcast's backward passes the last stage its own
  gradient and the others zeros: the loss counts once, not ``S`` times.

Every rank's backward visits its microbatches last to first (autograd
runs the most recent node first), so the gradient hops pair up in the
same order on both sides; each message is tagged with its microbatch
and direction besides. On a gloo group a CUDA tensor is staged through
host memory explicitly (gloo sends no CUDA tensor), counted ``"staged"``
(:class:`.collective.Messages`).

Replicated leaves end with the unpipelined gradient on every stage rank:
the final norm and the head compute whole gradients on every stage; the
embedding's is stage 0's alone (the others' are exact zeros) and
:class:`PipelineParallel` sums it over the stage group. The data axis
averages every gradient, as in :class:`.data_parallel.DataParallel`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from pytorch_distributed_training_tutorials_tpu_torch.parallel.collective import (
    Messages,
    all_reduce_mean_,
    bucket_plan,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.data_parallel import DataParallel
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    STAGE_AXIS,
    axis_rank,
    axis_size,
)


class StageGroup(Messages):
    """The stage axis of one rank: ``size`` stages, this rank's ``stage``,
    the group (None for one stage), and the messages it sent and received
    by kind (:class:`.collective.Messages`: ``"send"`` and ``"recv"`` to
    and from a stage, ``"broadcast"``, ``"stage_sum"``, ``"flag_min"``,
    and ``"staged"`` for each send or receive staged through host memory;
    gloo takes CUDA tensors for the broadcast and the all_reduce itself)."""

    def __init__(self, mesh, stage_axis: str = STAGE_AXIS):
        names = tuple(mesh.mesh_dim_names or ())
        if stage_axis not in names:
            raise ValueError(f"mesh has no {stage_axis!r} axis: {names}")
        self.size = axis_size(mesh, stage_axis)
        self.stage = axis_rank(mesh, stage_axis) if self.size > 1 else 0
        super().__init__(mesh.get_group(stage_axis) if self.size > 1 else None)

    def broadcast_(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """``x`` overwritten with stage ``stage``'s bytes (in place)."""
        self.count("broadcast")
        dist.broadcast(x, self.peer(stage), group=self.group)
        return x

    def reduce_(self, x: torch.Tensor, op, kind: str) -> torch.Tensor:
        self.count(kind)
        dist.all_reduce(x, op=op, group=self.group)
        return x


class _Recv(torch.autograd.Function):
    """Microbatch ``m`` from the previous stage; its gradient sent back.
    ``inject`` (the stage's own embedding rows of ``m``) is ignored and
    gets a zero gradient."""

    @staticmethod
    def forward(ctx, inject, stages, m: int, backward_tag: int):
        ctx.stages, ctx.tag = stages, backward_tag
        return stages.recv(inject.shape, inject.dtype, inject.device, stages.stage - 1, m)

    @staticmethod
    def backward(ctx, grad):
        ctx.stages.send(grad, ctx.stages.stage - 1, ctx.tag)
        return torch.zeros_like(grad), None, None, None


class _Send(torch.autograd.Function):
    """Microbatch ``m`` to the next stage; a scalar token out, whose
    backward receives the gradient of what was sent."""

    @staticmethod
    def forward(ctx, y, stages, m: int, backward_tag: int):
        ctx.stages, ctx.tag, ctx.like = stages, backward_tag, (y.shape, y.dtype, y.device)
        stages.send(y, stages.stage + 1, m)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _token_grad):
        return ctx.stages.recv(*ctx.like, ctx.stages.stage + 1, ctx.tag), None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs on every stage; the backward hands the
    last stage its own gradient and every other stage zeros."""

    @staticmethod
    def forward(ctx, y, stages):
        ctx.last = stages.stage == stages.size - 1
        return stages.broadcast_(y.clone(), stages.size - 1)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else torch.zeros_like(grad)), None


def spmd_pipeline(stage_fn, mesh, *, num_microbatches: int, stage_axis: str = STAGE_AXIS):
    """Wrap ``stage_fn`` (this rank's stage: ``x -> y`` of ``x``'s shape and
    type, its parameters the caller's) in the GPipe schedule over
    ``mesh[stage_axis]``. Returns ``fn(x_mb) -> y_mb``: ``x_mb`` is ``(M,
    rows, ...)`` (stage 0's is used; the others' are the hops' ignored
    inputs) and ``y_mb`` the whole ``S``-stage composition of every
    microbatch, the same bytes on every stage. ``fn.stages`` is the
    :class:`StageGroup`; ``fn.ticks`` the schedule's ``M + S - 1``. The
    rows are the rank's (its data coordinate's)."""
    stages = StageGroup(mesh, stage_axis)
    n, m_total = stages.size, num_microbatches

    def pipeline(x_mb: torch.Tensor) -> torch.Tensor:
        if x_mb.shape[0] != m_total:
            raise ValueError(f"{x_mb.shape[0]} microbatches for a schedule of {m_total}")
        if n == 1:
            return torch.stack([stage_fn(x) for x in x_mb.unbind(0)])
        s = stages.stage
        outs, tokens = [], []
        for m in range(m_total):  # stage s runs microbatch m at tick s + m
            x = x_mb[m] if s == 0 else _Recv.apply(x_mb[m], stages, m, m_total + m)
            y = stage_fn(x)
            if s == n - 1:
                outs.append(y)
            else:
                tokens.append(_Send.apply(y, stages, m, m_total + m))
        y_mb = torch.stack(outs) if s == n - 1 else (
            x_mb.new_zeros(x_mb.shape) + torch.stack(tokens).sum())
        return _Broadcast.apply(y_mb, stages)

    pipeline.stages = stages
    pipeline.ticks = m_total + n - 1
    return pipeline


def expected_messages(stage: int, num_stages: int, num_microbatches: int) -> dict:
    """The schedule's own count of one forward and backward on ``stage``:
    a send and a receive of each microbatch across each hop it touches
    (forward out, its gradient back in; and the reverse on the receiving
    side), and one broadcast of the outputs."""
    if num_stages == 1:
        return {}
    first, last = stage == 0, stage == num_stages - 1
    hops = (0 if first else 1) + (0 if last else 1)
    return {"send": hops * num_microbatches, "recv": hops * num_microbatches, "broadcast": 1}


def _check_cfg(cfg, stages: int) -> None:
    """The JAX refusals: MoE blocks (their aux losses do not thread the
    pipeline) and a layer count the stages do not divide."""
    if cfg.moe_experts:
        raise ValueError("PipelinedTransformerLM supports dense blocks only (MoE aux losses "
                         "do not thread the pipeline schedule)")
    if cfg.n_layers % stages:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by {stages} pipeline stages")
    if cfg.quantized or cfg.int8_mesh is not None or cfg.lora_adapters:
        raise ValueError("PipelinedTransformerLM trains a float model of one rank a stage "
                         "(no int8 weights, tensor parallelism or LoRA inside a stage)")


class PipelinedTransformerLM(nn.Module):
    """dp x pp transformer LM: the parameters and numerics of
    :class:`..models.transformer.TransformerLM`, the layer stack run as a
    GPipe schedule over the stage ranks (module docstring)::

        mesh = create_mesh({"data": D, "stage": S}, stage_ranks=True)
        model = PipelinedTransformerLM(cfg, mesh, num_microbatches=4)
        Trainer(model, loader, opt, strategy=PipelineParallel(mesh, num_microbatches=4))

    This rank holds the embedding, the final norm and the head (replicated)
    and its stage's blocks (``blocks.<i>`` for its global layer indices
    ``i``, so a whole state dict's entries bind by name:
    :meth:`stage_params`). Built on the ``meta`` device by default, as the
    unpipelined model. Refuses MoE blocks and ``n_layers % S`` at
    construction, and a batch that ``M`` does not divide or a sequence
    over ``max_seq_len`` at the call (ValueError, as the JAX module)."""

    def __init__(self, cfg, mesh, *, num_microbatches: int, stage_axis: str = STAGE_AXIS,
                 device="meta"):
        super().__init__()
        from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
            Block,
            Dense,
            RMSNorm,
        )

        self.cfg, self.mesh, self.num_microbatches = cfg, mesh, num_microbatches
        self._pipeline = spmd_pipeline(self._stage, mesh, num_microbatches=num_microbatches,
                                       stage_axis=stage_axis)
        self.stages = self._pipeline.stages
        _check_cfg(cfg, self.stages.size)
        per = cfg.n_layers // self.stages.size
        self.layers = range(self.stages.stage * per, (self.stages.stage + 1) * per)
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.blocks = nn.ModuleDict({str(i): Block(cfg, device=device) for i in self.layers})
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device, train=True)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, dtype=cfg.dtype, device=device)

    def stage_params(self, params) -> dict:
        """This stage's entries of a whole ``TransformerLM`` state dict (the
        weight bridge's, or :func:`..models.convert.init_lm`'s)."""
        names = self.state_dict().keys()
        return {k: v for k, v in params.items() if k in names}

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        from torch.utils.checkpoint import checkpoint

        from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
            _remat_context,
        )

        for block in self.blocks.values():
            if self.cfg.remat:
                x = checkpoint(block, x, rope_offset=0, use_reentrant=False,
                               context_fn=_remat_context(self.cfg.remat_policy))
            else:
                x = block(x, rope_offset=0)
        return x

    def forward(self, tokens: torch.Tensor, *, return_hidden: bool = False) -> torch.Tensor:
        cfg, m = self.cfg, self.num_microbatches
        b, s = tokens.shape
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        if s > cfg.max_seq_len:
            raise ValueError(f"sequence length {s} exceeds max_seq_len {cfg.max_seq_len}")
        x = self.tok_emb(tokens).to(cfg.dtype)
        y = self._pipeline(x.reshape(m, b // m, *x.shape[1:])).reshape(x.shape)
        y = self.final_norm(y)
        return y if return_hidden else self.lm_head(y)


class PipelineParallel:
    """dp x pp strategy: each stage's blocks on its stage rank, the
    embedding, final norm and head replicated, batches over ``data``.
    Drop-in for :class:`.data_parallel.DataParallel` in the ``Trainer``
    with a :class:`PipelinedTransformerLM` on the same mesh.
    :meth:`shard_state` broadcasts each stage's parameters over its data
    group and sets the step's gradient sync: the embedding's gradient summed
    over the stage group (stage 0's alone is nonzero), then every gradient
    and the loss averaged over the data group; and the skip flag's MIN
    over the stage group (the stages hold different leaves).
    ``num_microbatches`` is the JAX call's; the model runs the schedule,
    and :meth:`shard_state` refuses a model of another count."""

    def __init__(self, mesh, *, num_microbatches: int = 1, data_axis: str = DATA_AXIS,
                 stage_axis: str = STAGE_AXIS):
        self.mesh = mesh
        self.num_microbatches = num_microbatches
        self.data_axis, self.stage_axis = data_axis, stage_axis
        self._data = DataParallel(mesh, data_axis)
        self.stages = StageGroup(mesh, stage_axis)
        self.collectives: dict[str, int] = {}

    @property
    def num_devices(self) -> int:
        return self._data.num_devices

    @property
    def num_stages(self) -> int:
        return self.stages.size

    @property
    def group(self):
        """The data group (evaluation sums over it)."""
        return self._data.group

    def reset_collectives(self) -> None:
        self.collectives = {}
        self.stages.reset_collectives()

    def variable_shardings(self, model) -> dict:
        """Each state-dict entry's placement: ``"stage"`` for a stage's
        block leaves, ``"replicated"`` for the rest."""
        return {n: ("stage" if n.startswith("blocks.") else "replicated")
                for n in model.state_dict()}

    def shard_state(self, state):
        model_m = getattr(state.model, "num_microbatches", self.num_microbatches)
        if model_m != self.num_microbatches:
            raise ValueError(f"PipelineParallel(num_microbatches={self.num_microbatches}) "
                             f"beside a model of {model_m} microbatches")
        state = self._data.shard_state(state)
        names = [n for n, p in state.model.named_parameters() if p.requires_grad]
        emb = names.index("tok_emb.weight") if "tok_emb.weight" in names else None
        data_sync = state.grad_sync

        def grad_sync(tensors: list[torch.Tensor]) -> None:
            if emb is not None and self.stages.group is not None:
                self.stages.reduce_(tensors[emb], dist.ReduceOp.SUM, "stage_sum")
            if data_sync is not None:
                self.collectives["data_all_reduce"] = (self.collectives.get("data_all_reduce", 0)
                                                       + len(bucket_plan(tensors)))
                all_reduce_mean_(tensors, self._data.group, self.num_devices)

        needed = self.stages.group is not None or data_sync is not None
        state.grad_sync = grad_sync if needed else None
        if self.stages.group is not None:
            state.flag_sync = lambda ok: self.stages.reduce_(ok, dist.ReduceOp.MIN, "flag_min")
        return state

    def shard_batch(self, batch):
        """This rank's rows of a global batch (its data coordinate's block;
        every stage of it the same rows)."""
        return self._data.shard_batch(batch)
