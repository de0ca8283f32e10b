"""Inter-layer (pipeline) model parallelism: the 03 lesson, in PyTorch.

Port of the JAX package's ``parallel/pipeline.py``. The reference's
semantics (SURVEY.md C14/C15):

- ``ToyModel``: ``net1`` on one device, ``net2`` on the next, the hop an
  explicit ``x.to(device)`` in the forward (``03.model_parallel.ipynb:440-450``)
  and a train step whose backward crosses it (``:532-542``);
- ``ModelParallelResNet50``: the stem to layer group 2 on one device, the
  rest and ``fc`` on the next, one batch flowing stage 0 -> stage 1 with
  no microbatch interleave (``:807-834``): stage 0 idles while stage 1
  computes, which is what the reference's comparison with one device
  (C17) measures.

A stage is the part of the model its ``stage_partition`` names, its
parameters and buffers moved to the stage's device, and a call of the
model's ``stage{i}`` method. :class:`ManualPipeline` hops with
``x.to(device)``, the reference's own form, and autograd carries the
backward across the hop (the copy's gradient is a copy back). The JAX
stage backward rematerializes its forward under ``jax.vjp`` (its
separately compiled programs ship no residuals); the port takes **no
remat**: each stage keeps its activations from the forward to the
backward, as the reference does. That is a memory choice; the numbers are
the same.

:class:`GPipe` runs the same stages over ``num_microbatches``: every
microbatch's forward, then every backward, then one averaged update a
stage. Each stage's input is a leaf (``detach().requires_grad_()``), so
each stage's backward is its own call and the cotangent hops back with
``.to(device)`` — the structure of the JAX ``_bwd_mid`` / ``_bwd_last``
walk, and what a schedule over several cards needs. Over the data axis of
a :class:`..parallel.mesh.StageMesh` (a world of D processes, each
holding every stage) the parameters are broadcast from data-rank 0, the
gradients and the loss averaged over the data group, and BatchNorm's sums
taken over it, as :class:`..parallel.data_parallel.DataParallel` does.

Parameters are partitioned, not replicated: each device holds only its
stage's (:func:`partition_variables`), and the stage counts sum to the
unsplit model's (25,557,032 for ResNet-50).
"""

from __future__ import annotations

import inspect
from collections.abc import Callable, Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn

from pytorch_distributed_training_tutorials_tpu_torch.parallel.collective import all_reduce_mean_
from pytorch_distributed_training_tutorials_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    StageMesh,
    axis_rank,
    axis_size,
)


def partition_variables(state: Mapping[str, torch.Tensor], partition: Callable[[str], int],
                        num_stages: int) -> list[dict[str, torch.Tensor]]:
    """Split a state dict (parameters and buffers) into one dict a stage
    by ``partition(name) -> stage`` (the models' ``stage_partition``); a
    stage out of range raises ``ValueError``."""
    out: list[dict[str, torch.Tensor]] = [{} for _ in range(num_stages)]
    for name, t in state.items():
        s = partition(name)
        if not 0 <= s < num_stages:
            raise ValueError(f"partition({name!r}) -> {s} out of range")
        out[s][name] = t
    return out


def _stage_methods(model: nn.Module) -> list[Callable]:
    """The model's declared cut: ``stage0``, ``stage1``, ... in order."""
    fns = []
    while hasattr(model, f"stage{len(fns)}"):
        fns.append(getattr(model, f"stage{len(fns)}"))
    if len(fns) < 2 or not hasattr(model, "stage_partition"):
        raise ValueError(f"{type(model).__name__} declares no stage cut (stage0, stage1 and "
                         "stage_partition)")
    return fns


def _norm_stats(model: nn.Module) -> list[torch.Tensor]:
    """The running statistics of the model's BatchNorms (the modules with
    a ``sync_group``), in module order."""
    return [b for m in model.modules() if hasattr(m, "sync_group") for b in m.buffers(recurse=False)]


class ManualPipeline:
    """N sequential stages on N devices with explicit activation hops::

        pipe = ManualPipeline.from_module(model, devices=["cuda:0", "cuda:1"],
                                          loss="mse", optimizer=sgd(1e-3))
        out = pipe.forward(x)         # eval mode: BatchNorm's running averages
        loss = pipe.train_step(x, y)  # the backward crosses the hop back

    ``model`` declares its cut (``stage0``, ``stage1``, ``stage_partition``:
    ``ToyModel``, the ResNets) and keeps its weights: stage i's parameters
    and buffers move to ``devices[i]``. ``loss``: "mse" or
    "cross_entropy" (integer or one-hot targets). ``optimizer`` (the port's
    ``sgd`` / ``adamw`` or ``fused_adamw``): each stage has its own state,
    so a fused AdamW launches once a stage a step."""

    def __init__(self, model: nn.Module, devices: Sequence, *, loss: str = "mse",
                 optimizer=None):
        fns = _stage_methods(model)
        if len(devices) < len(fns):
            raise ValueError(f"{len(fns)} stages but only {len(devices)} devices")
        if loss not in ("mse", "cross_entropy"):
            raise ValueError(f"unknown loss {loss!r}")
        self.model = model
        self.num_stages = len(fns)
        self.devices = [torch.device(d) for d in devices[: self.num_stages]]
        self.loss_name = loss
        self._fns = fns
        self._takes_train = ["train" in inspect.signature(f).parameters for f in fns]
        # each stage's variables on its device: the .to(f"cuda:{i}") of
        # the reference (03.model_parallel.ipynb:812-827)
        parts = partition_variables(model.state_dict(), model.stage_partition, self.num_stages)
        model.load_state_dict({name: t.to(self.devices[s]) for s, part in enumerate(parts)
                               for name, t in part.items()}, assign=True)
        self.stage_params = [[p for name, p in model.named_parameters() if name in part]
                             for part in parts]
        self.tx = optimizer
        self.opt_states = (None if optimizer is None
                           else [optimizer.init(ps) for ps in self.stage_params])

    @classmethod
    def from_module(cls, model: nn.Module, *, devices, seed: int = 0, **kwargs):
        """The ``from_linen`` twin: random weights from ``seed`` (the flax
        initializers' distributions, :func:`..models.convert.init_params`,
        drawn on the first stage's device), then the pipeline. The port's
        modules are built with their widths, so no sample input is needed
        to shape them. ``devices``: a list, or for :class:`GPipe` the
        mesh."""
        from pytorch_distributed_training_tutorials_tpu_torch.models.convert import init_params

        first = devices.stage_devices[0] if isinstance(devices, StageMesh) else devices[0]
        model.load_state_dict(init_params(model, seed, first), assign=True)
        return cls(model, devices, **kwargs)

    def _stage(self, i: int, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self._fns[i](x, train=train) if self._takes_train[i] else self._fns[i](x)

    def _loss(self, out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import _compute_loss

        return _compute_loss(self.loss_name, out, y)

    @torch.no_grad()
    def forward(self, x) -> torch.Tensor:
        """Inference forward in eval mode (BatchNorm's running averages):
        stage i, the hop ``x.to(devices[i + 1])`` (the reference's
        ``x.to("cuda:1")``, ``03.model_parallel.ipynb:831``), stage i + 1."""
        x = torch.as_tensor(x)
        for i in range(self.num_stages):
            x = self._stage(i, x.to(self.devices[i]), train=False)
        return x

    def _apply_stage(self, i: int, grads: list[torch.Tensor]) -> None:
        self.tx.update_(self.stage_params[i], grads, self.opt_states[i])

    def train_step(self, x, y) -> torch.Tensor:
        """One optimizer step across all stages (reference ``:532-542``):
        the forward hops device to device, one backward through the hops
        (``torch.autograd.grad``), then each stage's update. BatchNorm's
        statistics update in the forward, once a step. Returns the loss (a
        device tensor on the last stage's device)."""
        if self.tx is None:
            raise ValueError("construct with optimizer=... to train")
        from pytorch_distributed_training_tutorials_tpu_torch.train.trainer import _laid_out_like

        a = torch.as_tensor(x)
        for i in range(self.num_stages):
            a = self._stage(i, a.to(self.devices[i]), train=True)
        loss = self._loss(a, torch.as_tensor(y).to(self.devices[-1]))
        params = [p for ps in self.stage_params for p in ps]
        grads = _laid_out_like(torch.autograd.grad(loss, params), params)
        lo = 0
        for i, ps in enumerate(self.stage_params):
            self._apply_stage(i, grads[lo:lo + len(ps)])
            lo += len(ps)
        return loss.detach()

    def stage_param_counts(self) -> list[int]:
        """Parameters a stage (their sum is the unsplit model's count: the
        25,557,032 check of the reference's cells 20/22)."""
        return [sum(p.numel() for p in ps) for ps in self.stage_params]

    def placement_audit(self) -> list[str]:
        """Device audit lines, the twin of 03's placement audit (cell 4)."""
        return [f"stage {i}: {n:,} params on {d}"
                for i, (n, d) in enumerate(zip(self.stage_param_counts(), self.devices))]


class GPipe(ManualPipeline):
    """Microbatched data x pipeline parallelism over a
    :class:`..parallel.mesh.StageMesh` (``create_mesh({"data": D, "stage":
    S}, stage_devices=...)``), for heterogeneous stages (the ResNet cut).

    ``train_step(x, y)`` takes the GLOBAL batch, as the JAX one does:
    microbatch k is rows ``[k * b/m, (k + 1) * b/m)``, of which this rank
    takes its data coordinate's block. Every microbatch runs forward
    through every stage, then every microbatch's backward runs stage by
    stage (``n * m`` stage forwards, ``n * m`` stage backwards), then each
    stage applies one update (``n``) with the gradients averaged over the
    microbatches and the data group: plain gradient accumulation. BatchNorm
    takes every microbatch's statistics from the step's starting ones and
    keeps their mean (the JAX step averages its microbatches' new
    statistics); the port's norms update their buffers in place on every
    forward, so the step restores the start before each microbatch —
    without that, m microbatches would compound the momentum m times.

    The schedule is Python-driven: each stage call is a run of eager
    launches, and stage programs on different cards can overlap only
    through the streams' asynchrony. Build with ``GPipe.from_module(model,
    devices=mesh, num_microbatches=M, ...)``: the mesh rides the
    ``devices`` slot."""

    def __init__(self, model: nn.Module, mesh: StageMesh, *, num_microbatches: int,
                 data_axis: str = DATA_AXIS, **kwargs):
        if not isinstance(mesh, StageMesh):
            raise TypeError("GPipe places stages on a StageMesh (create_mesh with a 'stage' "
                            f"axis); got {type(mesh).__name__}")
        if num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        super().__init__(model, mesh.stage_devices, **kwargs)
        self.mesh = mesh
        self.num_microbatches = num_microbatches
        self.dp_size = axis_size(mesh, data_axis)
        self.dp_rank = axis_rank(mesh, data_axis)
        self.group = mesh.get_group(data_axis) if self.dp_size > 1 else None
        if self.group is not None:
            src = dist.get_global_rank(self.group, 0)
            with torch.no_grad():
                for t in list(model.parameters()) + list(model.buffers()):
                    dist.broadcast(t, src, group=self.group)
        for m in model.modules():
            if hasattr(m, "sync_group"):
                m.sync_group = self.group

    def _microbatches(self, arr) -> list[torch.Tensor]:
        """This rank's block of each microbatch of the global batch."""
        arr = torch.as_tensor(arr)
        m, b = self.num_microbatches, arr.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        mbs = b // m
        if mbs % self.dp_size:
            raise ValueError(f"microbatch {mbs} rows not divisible by dp width {self.dp_size}")
        rows = mbs // self.dp_size
        lo = self.dp_rank * rows
        return [arr[k * mbs + lo:k * mbs + lo + rows] for k in range(m)]

    def _stage_forward(self, i: int, a: torch.Tensor) -> torch.Tensor:
        return self._stage(i, a, train=True)

    def _stage_backward(self, i: int, out: torch.Tensor, ct, inp: torch.Tensor,
                        acc: list[torch.Tensor]):
        """One stage's backward of one microbatch: its parameters'
        gradients added into ``acc``; the cotangent of its input (a leaf),
        hopped to the previous stage's device (None for stage 0, whose
        input is the batch)."""
        params = self.stage_params[i]
        wrt = params + ([inp] if i > 0 else [])
        grads = torch.autograd.grad(out, wrt, grad_outputs=ct)
        torch._foreach_add_(acc, grads[:len(params)])
        return grads[-1].to(self.devices[i - 1]) if i > 0 else None

    def _restore_stats(self, stats: list[torch.Tensor], start: list[torch.Tensor]) -> None:
        with torch.no_grad():
            for s, s0 in zip(stats, start):
                s.copy_(s0)

    def train_step(self, x, y) -> torch.Tensor:
        """One optimizer step: the fill (every microbatch's forward), the
        drain (every microbatch's backward), one averaged update a stage.
        Returns the mean of the microbatches' losses, averaged over the
        data group."""
        if self.tx is None:
            raise ValueError("construct with optimizer=... to train")
        n, m = self.num_stages, self.num_microbatches
        xs, ys = self._microbatches(x), self._microbatches(y)
        stats = _norm_stats(self.model)
        start = [s.clone() for s in stats]
        stats_acc = [torch.zeros_like(s, dtype=torch.promote_types(s.dtype, torch.float32))
                     for s in stats]
        inputs = [[None] * m for _ in range(n)]
        outs = [[None] * m for _ in range(n)]
        for k in range(m):
            self._restore_stats(stats, start)
            a = xs[k]
            for i in range(n):
                a = a.to(self.devices[i])
                if i > 0:
                    a = a.detach().requires_grad_()
                inputs[i][k] = a
                a = outs[i][k] = self._stage_forward(i, a)
            with torch.no_grad():
                torch._foreach_add_(stats_acc, stats)
        grad_acc = [[torch.zeros_like(p) for p in ps] for ps in self.stage_params]
        losses = []
        for k in range(m):
            loss = self._loss(outs[-1][k], ys[k].to(self.devices[-1]))
            losses.append(loss.detach())
            ct = None
            for i in range(n - 1, -1, -1):
                ct = self._stage_backward(i, loss if i == n - 1 else outs[i][k], ct,
                                          inputs[i][k], grad_acc[i])
                outs[i][k] = inputs[i][k] = None  # this microbatch's activations go
        inv = 1.0 / m
        with torch.no_grad():
            for s, acc in zip(stats, stats_acc):
                s.copy_((acc * inv).to(s.dtype))
        loss = torch.stack(losses).mean()
        for i in range(n):
            torch._foreach_mul_(grad_acc[i], inv)
            if self.group is not None:
                all_reduce_mean_(grad_acc[i], self.group, self.dp_size)
            self._apply_stage(i, grad_acc[i])
        if self.group is not None:
            all_reduce_mean_([loss], self.group, self.dp_size)
        return loss
