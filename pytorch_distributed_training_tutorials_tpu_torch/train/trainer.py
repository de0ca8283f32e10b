"""The train step and the ``Trainer`` of the PyTorch port.

Port of ``pytorch_distributed_training_tutorials_tpu/train/trainer.py``:
the step builders (:class:`TrainState`, :func:`make_train_step`,
:func:`make_eval_step`) and the :class:`Trainer` (epoch loop, evaluation,
checkpoints). PyTorch runs eagerly, so there is no ``jit``:
``make_train_step`` returns the step function itself, and it updates the
state IN PLACE — parameters, optimizer state, BatchNorm statistics and the
step counter — and returns the same state object. The loss stays a device
tensor, so a step does no host sync.

Gradients come from ``torch.autograd.grad`` (nothing accumulates in
``.grad``); a data-parallel state (:meth:`..parallel.DataParallel.
shard_state`) then averages them, and the loss, over the data axis
(``TrainState.grad_sync``) — the all-reduce XLA inserts in the JAX step.

``loss="fused_cross_entropy"`` is the logits-free loss: the model returns
its final hidden states (``return_hidden=True``) and
:func:`..ops.fused_loss.fused_cross_entropy` streams them against the
lm_head weight. A model with BatchNorm (``has_batch_stats``) runs its
forward with ``train=True`` in the step and ``train=False`` in eval.

The guardrails are the JAX trainer's. ``skip_nonfinite``: after the
gradient average, a device flag says whether the loss and every gradient
element are finite (each leaf's largest ``|g|``: a 2-norm of large finite
gradients would overflow and skip a healthy step); the optimizer takes the
flag (``update_(..., ok=)``), so a skipped step leaves the parameters, the
optimizer state (AdamW's count included) and ``step`` bitwise unchanged,
and BatchNorm's statistics, written in the forward, are selected back from
a copy taken before it. The flag is data: no host sync, and the step's
``"skipped"`` scalar rides the epoch's one batched drain. ``chaos``
(:class:`..utils.chaos.ChaosConfig`) injects the faults the guard is tested
against. ``rollback_spike_factor``: a host monitor of the loss restores the
latest ``save()`` and continues when the loss spikes; it costs a loss fetch
a step (a chunk on the chunked path).

Tensor parallelism: ``Trainer(TransformerLM(cfg), loader, opt,
strategy=TensorParallel(create_mesh({"data": d, "model": tp})))``, the JAX
call without its rules (the port's model knows its Megatron split). The
Trainer rebuilds a whole model (``cfg.int8_mesh`` None) as this rank's
shard — ``cfg.int8_mesh`` set to the strategy — or takes one already
built on the same strategy. Every rank draws the whole model's weights
from ``seed`` and keeps its shard (:func:`..models.convert.init_lm`), so
step 0 is the single-device model's. ``loss="fused_cross_entropy"`` then
runs :func:`..ops.fused_loss.fused_cross_entropy_tp` on the rank's vocab
shard; ``"cross_entropy"`` the gathered logits. The data axis averages
the gradients (each data coordinate holds its own rows, every model rank
of it the same ones), and the skip flag is the model group's MIN, so the
ranks, which each see only their shards' gradients, skip together.
Replicated leaves (embedding, norms) get the same gradient bytes on every
model rank and stay bitwise equal. Checkpoints (``save``, ``restore``,
rollback) of a tensor-parallel state raise ``NotImplementedError``.

FSDP: ``Trainer(model, loader, opt, strategy=FSDP(mesh))`` shards every
large parameter and its optimizer moments over the data axis (each rank
holds its shard; the forward gathers, the backward reduce-scatters),
BatchNorm synced over ``data`` as under ``DataParallel``;
``strategy=HybridFSDP(mesh, TP_RULES)`` on a ``{"data": d, "model": tp}``
mesh builds the model as the rank's tensor-parallel shard (on the
strategy's ``tp``) and shards over ``data`` what the rules leave whole.
Checkpoints of a sharded state raise ``NotImplementedError`` too.

``model_kwargs`` (e.g. ``{"adapter_ids": tenant}`` for a LoRA fine-tune)
are forwarded to every model call, evaluation's too. An optimizer with a
``mask`` (``fused_adamw(mask=lora_param_mask)``) freezes the leaves it
marks False when the state is created: they get no gradient, no moments
and no update, the eager counterpart of XLA dropping an unused gradient.
``aux_loss_weight`` adds that multiple of the MoE layers' load-balancing
losses (each :class:`..models.moe.MoEFFN`'s ``aux_loss`` of the step's
forward, :func:`..models.moe.moe_aux_loss`) to the objective, as the JAX
step adds its sown ``"losses"``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
import time
from collections.abc import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pytorch_distributed_training_tutorials_tpu_torch.adapters.lora import resolve_mask
from pytorch_distributed_training_tutorials_tpu_torch.data.loader import to_device
from pytorch_distributed_training_tutorials_tpu_torch.models.convert import init_lm, init_params
from pytorch_distributed_training_tutorials_tpu_torch.models.moe import moe_aux_loss
from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import BatchNorm
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    TransformerLM,
    bind_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs.metrics import MetricsLogger
from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_loss import (
    fused_cross_entropy,
    fused_cross_entropy_tp,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.data_parallel import DataParallel
from pytorch_distributed_training_tutorials_tpu_torch.parallel.distributed import is_primary
from pytorch_distributed_training_tutorials_tpu_torch.parallel.fsdp import FSDP, HybridFSDP
from pytorch_distributed_training_tutorials_tpu_torch.parallel.pipeline_spmd import (
    PipelinedTransformerLM,
)
from pytorch_distributed_training_tutorials_tpu_torch.parallel.tensor_parallel import (
    TensorParallel,
)
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import keep_where
from pytorch_distributed_training_tutorials_tpu_torch.utils import chaos as chaos_lib
from pytorch_distributed_training_tutorials_tpu_torch.utils.logging import epoch_line

@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer
    and its state, the step count as a device tensor, ``grad_sync``, the
    data-parallel average of the gradients (None on one device), and
    ``flag_sync``, the tensor-parallel agreement on the skip flag (in
    place; None without a model group). The step mutates all of them in
    place."""

    step: torch.Tensor
    model: nn.Module
    tx: object
    opt_state: object
    grad_sync: Callable[[list[torch.Tensor]], None] | None = None
    flag_sync: Callable[[torch.Tensor], torch.Tensor] | None = None

    @classmethod
    def create(cls, *, model: nn.Module, tx) -> "TrainState":
        """The state of ``model`` under ``tx``; an optimizer ``mask``
        freezes the parameters it marks False (``requires_grad`` off)."""
        mask = getattr(tx, "mask", None)
        if mask is not None:
            keep = resolve_mask(mask, model)
            for name, p in model.named_parameters():
                if not keep[name]:
                    p.requires_grad_(False)
        params = [p for p in model.parameters() if p.requires_grad]
        dev = params[0].device
        return cls(
            step=torch.zeros((), dtype=torch.int64, device=dev),
            model=model, tx=tx, opt_state=tx.init(params),
        )

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for p in self.model.parameters() if p.requires_grad]


def batch_stats(model: nn.Module) -> list[torch.Tensor]:
    """The BatchNorm running statistics of ``model`` (its ``batch_stats``
    collection in the JAX package), in module order."""
    return [b for m in model.modules() if isinstance(m, BatchNorm) for b in (m.mean, m.var)]


def _compute_loss(loss: str, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The objective in optax's terms, in the logits' dtype:
    ``cross_entropy`` with integer targets is
    ``softmax_cross_entropy_with_integer_labels`` (logsumexp minus the
    target logit), with one-hot or soft targets (same rank as the logits)
    ``softmax_cross_entropy``; ``mse`` is the mean squared error."""
    if loss == "cross_entropy":
        if targets.ndim == logits.ndim:
            return _soft_ce(logits, targets).mean()
        return _integer_ce(logits, targets).mean()
    if loss == "mse":
        return torch.mean((logits - targets) ** 2)
    raise ValueError(f"unknown loss {loss!r}")


def _integer_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    label = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - label


def _soft_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(-1)


def _fused_ce_loss(model: nn.Module, hidden: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean logits-free cross entropy: the final hidden states streamed
    against the model's own lm_head weight, cast to the activations' type
    (the cast its ``Dense`` applies before the matmul); a vocab-split
    head (tensor parallel) through :func:`fused_cross_entropy_tp` on the
    rank's shard."""
    head = getattr(model, "lm_head", None)
    if head is None:
        raise ValueError(
            'loss="fused_cross_entropy" needs a model with an lm_head whose '
            "forward supports return_hidden=True (models.transformer.TransformerLM)"
        )
    w = head.weight.to(hidden.dtype)
    lay = getattr(model, "lay", None)
    if lay is not None and lay.split_vocab:
        return fused_cross_entropy_tp(hidden, w, targets, lay.tp,
                                      vocab_size=model.cfg.vocab_size).mean()
    return fused_cross_entropy(hidden, w, targets).mean()


def _make_loss_fn(loss: str, has_batch_stats: bool = False,
                  aux_loss_weight: float = 0.0, model_kwargs: dict | None = None):
    """The training objective: ``loss_fn(model, batch) -> loss``. With
    ``has_batch_stats`` the forward runs in train mode and updates the
    model's BatchNorm statistics in place. ``aux_loss_weight`` adds that
    multiple of the MoE layers' load-balancing losses of this forward
    (:func:`..models.moe.moe_aux_loss`, each layer's ``aux_loss``)."""
    kwargs = {"train": True} if has_batch_stats else {}
    kwargs.update(model_kwargs or {})

    def with_aux(model: nn.Module, value: torch.Tensor) -> torch.Tensor:
        return value + aux_loss_weight * moe_aux_loss(model) if aux_loss_weight else value

    if loss == "fused_cross_entropy":
        def fused_loss_fn(model: nn.Module, batch) -> torch.Tensor:
            x, y = batch
            return with_aux(model, _fused_ce_loss(model, model(x, return_hidden=True, **kwargs),
                                                  y))

        return fused_loss_fn

    def loss_fn(model: nn.Module, batch) -> torch.Tensor:
        x, y = batch
        return with_aux(model, _compute_loss(loss, model(x, **kwargs), y))

    return loss_fn


def _laid_out_like(grads, params: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each gradient in its parameter's memory layout. cuDNN returns a
    conv weight's gradient channels-last when the activations are (the
    ResNets' NHWC input); the parameters stay in the default layout, and
    the fused AdamW kernel takes p, g, m and v of one layout."""
    return [g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)
            for g, p in zip(grads, params)]


def finite_flag(loss_val: torch.Tensor, grads: list[torch.Tensor]) -> torch.Tensor:
    """1 (a 0-dim int32 device tensor) when the loss and every gradient
    element are finite, else 0. Each leaf's largest ``|g|`` is exact and
    carries NaN and inf; a 2-norm would overflow to inf on large finite
    gradients."""
    peaks = torch.stack(torch._foreach_norm(grads, ord=math.inf)).float()
    return torch.isfinite(torch.cat([peaks, loss_val.float().reshape(1)])).all().to(torch.int32)


def _apply_update(state: TrainState, grads: list[torch.Tensor], loss_val: torch.Tensor,
                  skip_nonfinite: bool = False, chaos=None,
                  stats_before: list[torch.Tensor] | None = None):
    """The optimizer tail: gradients and loss averaged over the data axis
    (data parallel), the update in place, ``step += 1`` on the device.

    ``chaos`` poisons the averaged gradients at its ``nan_grad_step``.
    ``skip_nonfinite`` computes the finite flag on the averaged values,
    which every data rank holds alike; a tensor-parallel state's
    ``flag_sync`` then takes the model group's MIN (each model rank sees
    its shards only), so all ranks agree; the update takes the flag,
    BatchNorm's statistics go back to ``stats_before`` where it is 0,
    ``step`` advances by it, and the metrics gain ``"skipped"`` (a device
    scalar)."""
    loss_val = loss_val.detach()
    if state.grad_sync is not None:
        loss_val = loss_val.clone()
        state.grad_sync([*grads, loss_val])
    if chaos is not None and chaos.poisons_grads:
        grads = chaos_lib.poison_grads(grads, state.step, chaos.nan_grad_step)
    metrics = {"loss": loss_val}
    if not skip_nonfinite:
        state.tx.update_(state.params, grads, state.opt_state)
        state.step += 1
        return state, metrics
    ok = finite_flag(loss_val, grads)
    if state.flag_sync is not None:
        ok = state.flag_sync(ok)
    state.tx.update_(state.params, grads, state.opt_state, ok=ok)
    if stats_before:
        keep_where(ok, batch_stats(state.model), stats_before)
    state.step += ok
    metrics["skipped"] = 1 - ok
    return state, metrics


def _train_step_fn(loss: str = "cross_entropy", has_batch_stats: bool = False,
                   aux_loss_weight: float = 0.0, model_kwargs: dict | None = None,
                   skip_nonfinite: bool = False, chaos=None):
    """The raw train step: ``step_fn(state, batch) -> (state, metrics)``,
    forward, backward (``torch.autograd.grad``), the gradient all-reduce
    where the state is data parallel, and the update, all in place."""
    loss_fn = _make_loss_fn(loss, has_batch_stats, aux_loss_weight, model_kwargs)
    keep_stats = skip_nonfinite and has_batch_stats

    def step_fn(state: TrainState, batch):
        params = state.params
        stats_before = [s.clone() for s in batch_stats(state.model)] if keep_stats else None
        loss_val = loss_fn(state.model, batch)
        grads = _laid_out_like(torch.autograd.grad(loss_val, params), params)
        return _apply_update(state, grads, loss_val, skip_nonfinite, chaos, stats_before)

    return step_fn


def _accum_step_fn(n: int, loss: str, has_batch_stats: bool, aux_loss_weight: float,
                   model_kwargs: dict | None, skip_nonfinite: bool = False, chaos=None):
    """Gradient accumulation over ``n`` strided microbatches (rows
    ``m::n``), as the JAX step's ``lax.scan``: the gradients and losses
    summed from zero and scaled by ``1 / n``; every microbatch's forward
    starts from the step's BatchNorm statistics, and the new statistics
    are the mean of the microbatches' (float32, then cast back). The guard
    checks the averaged gradients: one poisoned microbatch skips the
    step."""
    loss_fn = _make_loss_fn(loss, has_batch_stats, aux_loss_weight, model_kwargs)

    def step_fn(state: TrainState, batch):
        b = batch[0].shape[0]
        if b % n:
            raise ValueError(f"batch dim 0 ({b}) not divisible by grad_accum_steps ({n})")
        params = state.params
        stats = batch_stats(state.model) if has_batch_stats else []
        old = [s.clone() for s in stats]
        s_sum = [torch.zeros_like(s, dtype=torch.float32) for s in stats]
        g_sum = [torch.zeros_like(p) for p in params]
        l_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for m in range(n):
            with torch.no_grad():
                for s, o in zip(stats, old):
                    s.copy_(o)
            loss_val = loss_fn(state.model, tuple(a[m::n] for a in batch))
            grads = torch.autograd.grad(loss_val, params)
            torch._foreach_add_(g_sum, grads)
            with torch.no_grad():
                torch._foreach_add_(s_sum, stats)
            l_sum = l_sum + loss_val.detach()
        inv = 1.0 / n
        with torch.no_grad():
            for s, acc in zip(stats, s_sum):
                s.copy_((acc * inv).to(s.dtype))
        return _apply_update(state, torch._foreach_mul(g_sum, inv), l_sum * inv,
                             skip_nonfinite, chaos, old if skip_nonfinite else None)

    return step_fn


def make_train_step(loss: str = "cross_entropy", has_batch_stats: bool = False,
                    aux_loss_weight: float = 0.0, grad_accum_steps: int = 1,
                    model_kwargs: dict | None = None, skip_nonfinite: bool = False,
                    chaos=None):
    """The train step (eager: no compile, no donation — the state is
    updated in place). ``grad_accum_steps > 1`` splits the batch into that
    many strided microbatches before one optimizer update.
    ``skip_nonfinite`` turns on the skip-step guard and ``chaos`` injects
    its faults (:func:`_apply_update`)."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if grad_accum_steps == 1:
        return _train_step_fn(loss, has_batch_stats, aux_loss_weight, model_kwargs,
                              skip_nonfinite=skip_nonfinite, chaos=chaos)
    return _accum_step_fn(grad_accum_steps, loss, has_batch_stats, aux_loss_weight,
                          model_kwargs, skip_nonfinite=skip_nonfinite, chaos=chaos)


def make_eval_step(loss: str = "cross_entropy", has_batch_stats: bool = False,
                   model_kwargs: dict | None = None):
    """Eval step: per batch (summed per-sample loss, correct count, sample
    count), each row weighted by ``mask`` (0 for the wrap-padded rows).
    ``correct`` counts argmax hits for integer-label cross entropy and is 0
    otherwise. A ``fused_cross_entropy`` trainer evaluates through the
    logits (the same objective). ``model_kwargs`` go to the forward."""
    if loss == "fused_cross_entropy":
        loss = "cross_entropy"
    kwargs = {"train": False} if has_batch_stats else {}
    kwargs.update(model_kwargs or {})

    @torch.no_grad()
    def eval_fn(state: TrainState, batch, mask: torch.Tensor):
        x, y = batch
        logits = state.model(x, **kwargs)
        mask = mask.float()
        if loss == "cross_entropy" and y.ndim < logits.ndim:
            mask_rows = mask.reshape(mask.shape[0], *([1] * (y.ndim - 1)))
            loss_sum = (_integer_ce(logits, y) * mask_rows).sum()
            correct = ((torch.argmax(logits, -1) == y) * mask_rows).sum().to(torch.int32)
            count = (torch.ones_like(y, dtype=torch.float32) * mask_rows).sum()
        else:
            if loss == "mse":
                feat_axes = tuple(range(1, y.ndim))
                per_sample = ((logits - y) ** 2).mean(dim=feat_axes) if feat_axes else (logits - y) ** 2
            else:
                per_sample = _soft_ce(logits, y)
            mask_rows = mask.reshape(mask.shape[0], *([1] * (per_sample.ndim - 1)))
            loss_sum = (per_sample * mask_rows).sum()
            correct = torch.zeros((), dtype=torch.int32, device=x.device)
            count = (torch.ones_like(per_sample) * mask_rows).sum()
        return loss_sum, correct, count

    return eval_fn


def _tp_model(model: TransformerLM, tp: TensorParallel) -> TransformerLM:
    """The rank's model of a tensor-parallel trainer: a whole model
    rebuilt (on the meta device, its weights drawn after) with
    ``cfg.int8_mesh`` set to ``tp``, or one already built on ``tp``."""
    if model.cfg.int8_mesh is None:
        return TransformerLM(dataclasses.replace(model.cfg, int8_mesh=tp))
    if model.cfg.int8_mesh is not tp:
        raise ValueError("strategy differs from the model's cfg.int8_mesh")
    return model


def _init_weights(model: nn.Module, seed: int, device: torch.device) -> None:
    """Random weights from ``seed`` on ``device``, bound into ``model``
    (a pipeline stage binds its entries of the whole model's draw)."""
    if isinstance(model, TransformerLM):
        bind_params(model, init_lm(model.cfg, seed, device))
    elif isinstance(model, PipelinedTransformerLM):
        bind_params(model, model.stage_params(init_lm(model.cfg, seed, device)))
    else:
        model.load_state_dict(init_params(model, seed, device), assign=True)


class Trainer:
    """Epoch and batch loop over a sharded, chunked-streaming or
    device-resident loader::

        trainer = Trainer(model, loader, sgd(0.05, momentum=0.9))
        trainer.train(max_epochs)

    The model's weights are drawn from ``seed`` (the distributions of the
    flax initializers) on the loader's device, and the strategy
    (``DataParallel`` over the loader's mesh by default) broadcasts them
    from rank 0. Each epoch fetches its losses once, in one batched copy
    at its end (``MetricsLogger``); nothing inside an epoch syncs with the
    host, guard on or off, unless ``rollback_spike_factor`` asks for its
    loss fetches. ``host_syncs`` counts the trainer's fetches.

    A loader with ``iter_chunks`` (:class:`..data.ChunkedStreamingLoader`)
    trains chunk by chunk (:meth:`_run_epoch_chunked`), the next chunk's
    upload overlapping the steps.

    ``model_kwargs`` go to every forward, and an optimizer ``mask``
    freezes the parameters it leaves out (the module docstring).

    Guardrails (the module docstring): ``skip_nonfinite``, ``chaos``, and
    ``rollback_spike_factor`` with ``rollback_patience`` and
    ``rollback_ema``: when the monitored loss exceeds factor x its EMA (or
    is not finite) for ``rollback_patience`` consecutive observations,
    the latest ``save()`` is restored and training continues from the
    current data position.

    ``flight`` (a :class:`..obs.flight.FlightRecorder`, None: off) gets a
    ``step_skipped`` event for each skipped step when the metrics logger
    drains, and a ``rollback`` event at each rollback; neither adds a host
    sync.

    ``sentry`` (a :class:`..obs.sentry.ContractSentry`, None: off): at each
    epoch's start its phase becomes ``"epoch N"`` (native loads are
    attributed to it) and the train state — parameters, buffers, optimizer
    state — is walked once for leaves off the loader's device (the
    re-upload probe). No sync, no change to the step."""

    def __init__(self, model: nn.Module, train_loader, optimizer, *, strategy=None,
                 loss: str = "cross_entropy", aux_loss_weight: float = 0.0,
                 grad_accum_steps: int = 1, seed: int = 0, quiet: bool = False,
                 skip_nonfinite: bool = False, chaos=None,
                 rollback_spike_factor: float | None = None, rollback_patience: int = 2,
                 rollback_ema: float = 0.9, model_kwargs: dict | None = None, flight=None,
                 sentry=None):
        if rollback_spike_factor is not None and rollback_spike_factor <= 1:
            raise ValueError(f"rollback_spike_factor must be > 1 (None = off), got "
                             f"{rollback_spike_factor}")
        if rollback_patience < 1:
            raise ValueError(f"rollback_patience must be >= 1, got {rollback_patience}")
        if not 0.0 <= rollback_ema < 1.0:
            raise ValueError(f"rollback_ema must be in [0, 1), got {rollback_ema}")
        self.loader = train_loader
        self.strategy = strategy if strategy is not None else DataParallel(train_loader.mesh)
        tp = self.strategy.tp if isinstance(self.strategy, HybridFSDP) else self.strategy
        if isinstance(tp, TensorParallel) and isinstance(model, TransformerLM):
            model = _tp_model(model, tp)
        self.model = model
        self.device = train_loader.device
        _init_weights(model, seed, self.device)
        self.state = self.strategy.shard_state(TrainState.create(model=model, tx=optimizer))
        self.has_batch_stats = bool(batch_stats(model))
        if grad_accum_steps > 1:
            if getattr(train_loader, "device_arrays", None) is not None:
                raise ValueError(
                    "grad_accum_steps applies to the per-step path; the "
                    "device-resident epoch scan already amortizes memory — use "
                    "a streaming ShardedLoader for gradient accumulation"
                )
            if train_loader.global_batch % grad_accum_steps:
                raise ValueError(f"global batch ({train_loader.global_batch}) not "
                                 f"divisible by grad_accum_steps ({grad_accum_steps})")
            if self.strategy.num_devices > 1 and train_loader.per_device_batch % grad_accum_steps:
                # the JAX step's strided split of the GLOBAL batch equals each
                # rank's strided split of its own rows only when the
                # per-device batch divides
                raise ValueError(f"per-device batch ({train_loader.per_device_batch}) not "
                                 f"divisible by grad_accum_steps ({grad_accum_steps})")
        self.grad_accum_steps = grad_accum_steps
        self.chaos = chaos
        self.model_kwargs = dict(model_kwargs or {})
        self.train_step = make_train_step(loss=loss, has_batch_stats=self.has_batch_stats,
                                          aux_loss_weight=aux_loss_weight,
                                          grad_accum_steps=grad_accum_steps,
                                          model_kwargs=self.model_kwargs,
                                          skip_nonfinite=skip_nonfinite, chaos=chaos)
        self.metrics = MetricsLogger(quiet=quiet, flight=flight)
        self._flight = flight
        self._sentry = sentry
        self.loss_name = loss
        self.last_epoch_metrics: dict = {}
        self.epoch = 0  # next epoch to run; advanced by train(), restored
        self._own_syncs = 0
        self._eval_step = None
        self._rb_factor = rollback_spike_factor
        self._rb_patience = rollback_patience
        self._rb_decay = rollback_ema
        self._rb_ema = None  # EMA of healthy monitored losses
        self._rb_strikes = 0  # consecutive spike observations
        self._monitor_steps = 0  # monotonic host counter, never replays
        self._dispatches = 0  # monotonic step-dispatch counter (batch chaos)
        self.rollbacks = 0
        self._last_ckpt = None  # latest save() target (rollback restores it)

    @property
    def host_syncs(self) -> int:
        """Host fetches so far: the metrics drains and the trainer's own
        (evaluation, checkpoints, the rollback monitor's loss fetches)."""
        return self.metrics.host_fetches + self._own_syncs

    def _step(self, batch, steps: int) -> torch.Tensor:
        """Dispatch one step (the batch poisoned first where ``chaos``
        says) and log its loss and skip flag, un-fetched."""
        if not isinstance(batch, tuple):
            batch = (batch,)
        self._dispatches += 1
        if self.chaos is not None and self.chaos.poisons_batch:
            batch = chaos_lib.maybe_poison_batch(self.chaos, self._dispatches, batch)
        self.state, metrics = self.train_step(self.state, batch)
        extra = {"skipped": metrics["skipped"]} if "skipped" in metrics else None
        self.metrics.log_step(steps, metrics["loss"], extra=extra)
        return metrics["loss"]

    def _monitored(self, loss: torch.Tensor) -> bool:
        """Rollback on: fetch ``loss`` (counted) and feed the monitor;
        True when it rolled back."""
        if self._rb_factor is None:
            return False
        self._own_syncs += 1
        return self._monitor_loss(float(loss))

    def _epoch_metrics(self, epoch: int, steps: int, t0: float) -> dict:
        self.metrics.flush()  # the epoch's one fetch: every step's loss and flag
        dt = time.perf_counter() - t0
        loss = self.metrics.step_events()[-1]["loss"] if steps else float("nan")
        m = {
            "epoch": epoch, "loss": loss, "steps": steps,
            "steps_per_sec": steps / dt if dt > 0 else float("inf"),
            "samples_per_sec": steps * self.loader.global_batch / dt if dt > 0 else float("inf"),
        }
        self.metrics.log_epoch(m)
        return m

    def _run_epoch(self, epoch: int) -> dict:
        loader = self.loader
        if getattr(loader, "iter_chunks", None) is not None and self.grad_accum_steps == 1:
            # gradient accumulation composes with the per-step path only
            return self._run_epoch_chunked(epoch)
        loader.set_epoch(epoch)
        self.metrics.say(epoch_line(self.strategy.num_devices, epoch,
                                    loader.per_device_batch, len(loader)))
        t0 = time.perf_counter()
        steps = 0
        for batch in loader:
            steps += 1
            self._monitored(self._step(batch, steps))
        return self._epoch_metrics(epoch, steps, t0)

    def _run_epoch_chunked(self, epoch: int) -> dict:
        """The epoch from prefetched multi-step chunks
        (:meth:`..data.ChunkedStreamingLoader.iter_chunks`): each chunk's
        steps dispatch one by one, eagerly, while the next chunk's gather
        and upload run in the loader's thread. The rollback monitor reads
        each chunk's last loss and abandons the epoch's rest when it rolls
        back."""
        loader = self.loader
        loader.set_epoch(epoch)
        self.metrics.say(epoch_line(self.strategy.num_devices, epoch,
                                    loader.per_device_batch, len(loader)))
        t0 = time.perf_counter()
        steps = 0
        chunks = loader.iter_chunks()
        try:
            for chunk in chunks:
                for i in range(chunk[0].shape[0]):
                    steps += 1
                    loss = self._step(loader.chunk_step(chunk, i), steps)
                if self._monitored(loss):
                    break  # rolled back: abandon the rest of this epoch
        finally:
            chunks.close()
        return self._epoch_metrics(epoch, steps, t0)

    def train(self, max_epochs: int) -> dict:
        """Run up to epoch ``max_epochs``, starting from ``self.epoch`` (a
        restored trainer continues where it left off)."""
        if self.epoch >= max_epochs:
            self.metrics.say(f"train: already at epoch {self.epoch} >= {max_epochs}, "
                             "nothing to run")
            self.last_epoch_metrics = {
                "epoch": self.epoch, "loss": float("nan"), "steps": 0,
                "steps_per_sec": 0.0, "samples_per_sec": 0.0, "skipped": True,
            }
            return self.last_epoch_metrics
        for epoch in range(self.epoch, max_epochs):
            if self._sentry is not None:
                self._sentry.set_phase(f"epoch {epoch}")
                self._sentry.check_args(self.state, label="train_state", device=self.device)
            self.last_epoch_metrics = self._run_epoch(epoch)
            self.epoch = epoch + 1
        return self.last_epoch_metrics

    # -- loss-spike rollback ---------------------------------------------
    def _monitor_loss(self, loss_value: float) -> bool:
        """Feed one host-float loss to the spike monitor; True when it
        rolled back. A spike is a value above ``rollback_spike_factor`` x
        the EMA of healthy observations, or a non-finite one;
        ``rollback_patience`` consecutive spikes trigger. Spikes never
        enter the EMA, and the monitor's host step counter is monotonic
        across rollbacks, so a chaos spike keyed to it cannot fire
        again after the restore."""
        self._monitor_steps += 1
        if self.chaos is not None:
            loss_value = chaos_lib.host_spike_loss(loss_value, self._monitor_steps, self.chaos)
        spike = not math.isfinite(loss_value) or (
            self._rb_ema is not None and loss_value > self._rb_factor * self._rb_ema)
        if spike:
            self._rb_strikes += 1
            if self._rb_strikes >= self._rb_patience:
                self._do_rollback(loss_value)
                return True
            return False
        self._rb_strikes = 0
        d = self._rb_decay
        self._rb_ema = loss_value if self._rb_ema is None else d * self._rb_ema + (1.0 - d) * loss_value
        return False

    def _do_rollback(self, loss_value: float) -> None:
        """Restore the latest ``save()`` target and continue: the train
        state rolls back, the data position (``self.epoch``) does not (the
        batches behind the spike are skipped, not replayed); the monitor
        resets."""
        if self._last_ckpt is None:
            raise RuntimeError(
                "loss-spike rollback triggered but no checkpoint exists — "
                "call save() at least once (e.g. per epoch) when "
                "rollback_spike_factor is set"
            )
        epoch_now = self.epoch
        self.restore(self._last_ckpt)
        self.epoch = epoch_now  # keep the data position (skip, don't replay)
        self.rollbacks += 1
        self._rb_strikes = 0
        self._rb_ema = None
        if self._flight is not None:
            self._flight.rollback(step=self._monitor_steps, loss=loss_value)
        self.metrics.say(
            f"  rollback #{self.rollbacks}: loss {loss_value:.4g} spiked "
            f">{self._rb_factor:g}x EMA for {self._rb_patience} obs — "
            f"restored {self._last_ckpt}"
        )

    @property
    def steps_skipped(self) -> int:
        """Skip-step elisions so far (``skip_nonfinite``). Drains the
        metrics logger (its one batched fetch, if anything is pending)."""
        self.metrics.flush()
        return int(sum(e.get("skipped", 0) for e in self.metrics.step_events()))

    # -- checkpoint / resume ----------------------------------------------
    def _state_tree(self) -> dict:
        opt = self.state.opt_state
        return {
            "step": self.state.step,
            "model": self.state.model.state_dict(),
            "opt_state": {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)},
            "epoch": self.epoch,
        }

    def _check_checkpointable(self) -> None:
        if isinstance(self.strategy, TensorParallel) and self.strategy.tp_size > 1:
            raise NotImplementedError(
                "checkpoints of a tensor-parallel train state (each model rank holds "
                "its own shards) are not supported by the PyTorch port")
        if isinstance(self.strategy, FSDP) and self.strategy.sharded:
            raise NotImplementedError(
                "checkpoints of an FSDP-sharded train state (each rank holds its own "
                "shards) are not supported by the PyTorch port")

    def _write(self, target: str) -> None:
        """Rank 0 writes ``target/state.pt`` (the state is replicated)."""
        if is_primary():
            os.makedirs(target)
            torch.save(self._state_tree(), os.path.join(target, "state.pt"))

    def save(self, path, keep: int | None = None) -> None:
        """Checkpoint of the parameters, BatchNorm statistics, optimizer
        state, step and epoch (``torch.save`` of one dict in a directory),
        ATOMIC either way: a crash mid-save never corrupts the latest
        restore target.

        ``keep=None``: ``path`` is one checkpoint, overwritten atomically —
        written to ``path + ".tmp"``, the previous one parked at ``path +
        ".old"`` while the new one renames into place, then deleted
        (:meth:`restore` falls back to ``.old`` when ``path`` is missing).
        ``keep=K``: ``path`` is a rotation directory of
        ``ckpt-{step:08d}`` children, each written to a tmp name and
        renamed; all but the newest K are pruned. Rank 0 writes; every rank
        waits for it."""
        self._check_checkpointable()
        path = os.path.abspath(os.fspath(path))
        primary = is_primary()
        if keep is not None:
            if keep < 1:
                raise ValueError(f"keep must be >= 1 (None = single), got {keep}")
            self._own_syncs += 1
            target = os.path.join(path, f"ckpt-{int(self.state.step):08d}")
            if primary:
                os.makedirs(path, exist_ok=True)
                tmp = target + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)  # stale crash residue
                self._write(tmp)
                if os.path.exists(target):
                    shutil.rmtree(target)  # re-save at the same step
                os.rename(tmp, target)
                kids = sorted(d for d in os.listdir(path)
                              if d.startswith("ckpt-") and not d.endswith(".tmp"))
                for d in kids[:-keep]:
                    shutil.rmtree(os.path.join(path, d))
        elif primary:
            tmp, old = path + ".tmp", path + ".old"
            for stale in (tmp, old):
                if os.path.exists(stale):
                    shutil.rmtree(stale)  # crash residue from a prior save
            self._write(tmp)
            if os.path.exists(path):
                os.rename(path, old)
            os.rename(tmp, path)
            if os.path.exists(old):
                shutil.rmtree(old)
        if dist.is_initialized():
            dist.barrier()
        self._last_ckpt = path

    @staticmethod
    def _resolve_ckpt(path) -> str:
        """A rotation directory resolves to its newest ``ckpt-*`` child; a
        missing single-checkpoint path falls back to its ``.old`` copy."""
        path = os.path.abspath(os.fspath(path))
        if os.path.isdir(path):
            kids = sorted(d for d in os.listdir(path)
                          if d.startswith("ckpt-") and not d.endswith(".tmp"))
            if kids:
                return os.path.join(path, kids[-1])
        if not os.path.exists(path) and os.path.exists(path + ".old"):
            return path + ".old"
        return path

    def restore(self, path) -> None:
        """Restore in place (the same tensors the optimizer holds): a plain
        checkpoint, a ``save(keep=K)`` rotation directory (newest child),
        or a crash-windowed single path (``.old``).

        A checkpoint whose optimizer state kept its count on the host (an
        int, and a ``count`` in SGD's state) loads too: the int fills the
        device count, a field the current state lacks is dropped, and
        AdamW's ``calls`` starts from that count, so the bias-correction
        table grows to cover it on the next update."""
        self._check_checkpointable()
        tree = torch.load(os.path.join(self._resolve_ckpt(path), "state.pt"),
                          map_location=self.device, weights_only=True)
        self.state.model.load_state_dict(tree["model"])
        opt = self.state.opt_state
        saved = tree["opt_state"]
        with torch.no_grad():
            self.state.step.copy_(tree["step"])
            for name, value in saved.items():
                if not hasattr(opt, name):
                    continue
                current = getattr(opt, name)
                if isinstance(current, list):
                    for dst, src in zip(current, value):
                        dst.copy_(src)
                elif isinstance(current, torch.Tensor) and not isinstance(value, torch.Tensor):
                    current.fill_(value)  # a host count into the device count
                elif isinstance(current, torch.Tensor) and current.shape == value.shape:
                    current.copy_(value)  # AdamW's count: the same tensor
                else:
                    setattr(opt, name, value)
            if hasattr(opt, "calls") and "calls" not in saved:
                opt.calls = int(saved["count"])
        self.epoch = int(tree["epoch"])

    # -- evaluation -------------------------------------------------------
    def evaluate(self, eval_loader=None) -> dict:
        """Mean loss and accuracy (integer-label classification; 0.0
        otherwise) over ``eval_loader`` (default: the training loader),
        wrap-padded rows masked out (``valid_mask``), summed over the data
        axis; one host fetch. ``"samples"`` counts label positions."""
        loader = eval_loader if eval_loader is not None else self.loader
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.loss_name, self.has_batch_stats,
                                             self.model_kwargs)
        masks: dict = {}  # padding lives in the tail steps: upload each distinct mask once
        totals = []
        for step, batch in enumerate(loader):
            if not isinstance(batch, tuple) or len(batch) != 2:
                raise ValueError("evaluate() requires (x, y) batches")
            rows = batch[0].shape[0]
            m = (loader.local_valid_mask(step) if hasattr(loader, "local_valid_mask")
                 else np.ones((rows,), bool)).astype(np.float32)
            if m.tobytes() not in masks:
                masks[m.tobytes()] = to_device(m, batch[0].device)
            loss_sum, correct, count = self._eval_step(self.state, batch, masks[m.tobytes()])
            totals.append(torch.stack([loss_sum.double(), correct.double(), count.double()]))
        total = torch.stack(totals).sum(0)
        # the data group (a TensorParallel's own group is its model group;
        # its seq group holds the other blocks of each row's positions)
        if isinstance(self.strategy, TensorParallel):
            groups = (self.strategy.data_group, self.strategy.seq_group)
        else:
            groups = (self.strategy.group,)
        for group in groups:
            if group is not None:
                dist.all_reduce(total, group=group)
        loss_sum, correct, seen = total.tolist()
        self._own_syncs += 1
        seen = int(seen)
        return {"loss": loss_sum / max(seen, 1), "accuracy": int(correct) / max(seen, 1),
                "samples": seen}

