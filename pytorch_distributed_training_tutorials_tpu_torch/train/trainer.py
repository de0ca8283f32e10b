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
``skip_nonfinite``, ``chaos`` and loss-spike rollback (ROADMAP A10),
``aux_loss_weight`` (A14) and ``model_kwargs`` (the LoRA bank, A13) raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from collections.abc import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pytorch_distributed_training_tutorials_tpu_torch.data.loader import to_device
from pytorch_distributed_training_tutorials_tpu_torch.models.convert import init_lm, init_params
from pytorch_distributed_training_tutorials_tpu_torch.models.resnet import BatchNorm
from pytorch_distributed_training_tutorials_tpu_torch.models.transformer import (
    TransformerLM,
    bind_params,
)
from pytorch_distributed_training_tutorials_tpu_torch.obs.metrics import MetricsLogger
from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_loss import fused_cross_entropy
from pytorch_distributed_training_tutorials_tpu_torch.parallel.data_parallel import DataParallel
from pytorch_distributed_training_tutorials_tpu_torch.parallel.distributed import is_primary
from pytorch_distributed_training_tutorials_tpu_torch.utils.logging import epoch_line

_GUARDRAILS = "the trainer guardrails slice (ROADMAP A10)"
_MOE = "the MoE slice (ROADMAP A14)"
_LORA = "the LoRA-bank slice (ROADMAP A13)"


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not supported by the PyTorch port yet; it arrives with "
        f"{slice_name}"
    )


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer
    and its state, the step count as a device tensor, and ``grad_sync``,
    the data-parallel average of the gradients (None on one device). The
    step mutates all of them in place."""

    step: torch.Tensor
    model: nn.Module
    tx: object
    opt_state: object
    grad_sync: Callable[[list[torch.Tensor]], None] | None = None

    @classmethod
    def create(cls, *, model: nn.Module, tx) -> "TrainState":
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
    (the cast its ``Dense`` applies before the matmul)."""
    head = getattr(model, "lm_head", None)
    if head is None:
        raise ValueError(
            'loss="fused_cross_entropy" needs a model with an lm_head whose '
            "forward supports return_hidden=True (models.transformer.TransformerLM)"
        )
    return fused_cross_entropy(hidden, head.weight.to(hidden.dtype), targets).mean()


def _make_loss_fn(loss: str, has_batch_stats: bool = False,
                  aux_loss_weight: float = 0.0, model_kwargs: dict | None = None):
    """The training objective: ``loss_fn(model, batch) -> loss``. With
    ``has_batch_stats`` the forward runs in train mode and updates the
    model's BatchNorm statistics in place."""
    if aux_loss_weight:
        raise _later("aux_loss_weight", _MOE)
    if model_kwargs:
        raise _later("model_kwargs", _LORA)
    kwargs = {"train": True} if has_batch_stats else {}
    if loss == "fused_cross_entropy":
        def fused_loss_fn(model: nn.Module, batch) -> torch.Tensor:
            x, y = batch
            return _fused_ce_loss(model, model(x, return_hidden=True, **kwargs), y)

        return fused_loss_fn

    def loss_fn(model: nn.Module, batch) -> torch.Tensor:
        x, y = batch
        return _compute_loss(loss, model(x, **kwargs), y)

    return loss_fn


def _laid_out_like(grads, params: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each gradient in its parameter's memory layout. cuDNN returns a
    conv weight's gradient channels-last when the activations are (the
    ResNets' NHWC input); the parameters stay in the default layout, and
    the fused AdamW kernel takes p, g, m and v of one layout."""
    return [g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)
            for g, p in zip(grads, params)]


def _apply_update(state: TrainState, grads: list[torch.Tensor], loss_val: torch.Tensor):
    """The optimizer tail: gradients and loss averaged over the data axis
    (data parallel), the update in place, ``step += 1`` on the device."""
    loss_val = loss_val.detach()
    if state.grad_sync is not None:
        loss_val = loss_val.clone()
        state.grad_sync([*grads, loss_val])
    state.tx.update_(state.params, grads, state.opt_state)
    state.step += 1
    return state, {"loss": loss_val}


def _train_step_fn(loss: str = "cross_entropy", has_batch_stats: bool = False,
                   aux_loss_weight: float = 0.0, model_kwargs: dict | None = None,
                   skip_nonfinite: bool = False, chaos=None):
    """The raw train step: ``step_fn(state, batch) -> (state, metrics)``,
    forward, backward (``torch.autograd.grad``), the gradient all-reduce
    where the state is data parallel, and the update, all in place."""
    loss_fn = _make_loss_fn(loss, has_batch_stats, aux_loss_weight, model_kwargs)
    if skip_nonfinite:
        raise _later("skip_nonfinite", _GUARDRAILS)
    if chaos is not None:
        raise _later("chaos", _GUARDRAILS)

    def step_fn(state: TrainState, batch):
        params = state.params
        loss_val = loss_fn(state.model, batch)
        grads = _laid_out_like(torch.autograd.grad(loss_val, params), params)
        return _apply_update(state, grads, loss_val)

    return step_fn


def _accum_step_fn(n: int, loss: str, has_batch_stats: bool, aux_loss_weight: float,
                   model_kwargs: dict | None):
    """Gradient accumulation over ``n`` strided microbatches (rows
    ``m::n``), as the JAX step's ``lax.scan``: the gradients and losses
    summed from zero and scaled by ``1 / n``; every microbatch's forward
    starts from the step's BatchNorm statistics, and the new statistics
    are the mean of the microbatches' (float32, then cast back)."""
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
        return _apply_update(state, torch._foreach_mul(g_sum, inv), l_sum * inv)

    return step_fn


def make_train_step(loss: str = "cross_entropy", has_batch_stats: bool = False,
                    aux_loss_weight: float = 0.0, grad_accum_steps: int = 1,
                    model_kwargs: dict | None = None, skip_nonfinite: bool = False,
                    chaos=None):
    """The train step (eager: no compile, no donation — the state is
    updated in place). ``grad_accum_steps > 1`` splits the batch into that
    many strided microbatches before one optimizer update."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if grad_accum_steps == 1:
        return _train_step_fn(loss, has_batch_stats, aux_loss_weight, model_kwargs,
                              skip_nonfinite=skip_nonfinite, chaos=chaos)
    if skip_nonfinite:
        raise _later("skip_nonfinite", _GUARDRAILS)
    if chaos is not None:
        raise _later("chaos", _GUARDRAILS)
    return _accum_step_fn(grad_accum_steps, loss, has_batch_stats, aux_loss_weight,
                          model_kwargs)


def make_eval_step(loss: str = "cross_entropy", has_batch_stats: bool = False):
    """Eval step: per batch (summed per-sample loss, correct count, sample
    count), each row weighted by ``mask`` (0 for the wrap-padded rows).
    ``correct`` counts argmax hits for integer-label cross entropy and is 0
    otherwise. A ``fused_cross_entropy`` trainer evaluates through the
    logits (the same objective)."""
    if loss == "fused_cross_entropy":
        loss = "cross_entropy"

    @torch.no_grad()
    def eval_fn(state: TrainState, batch, mask: torch.Tensor):
        x, y = batch
        logits = state.model(x, train=False) if has_batch_stats else state.model(x)
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


def _init_weights(model: nn.Module, seed: int, device: torch.device) -> None:
    """Random weights from ``seed`` on ``device``, bound into ``model``."""
    if isinstance(model, TransformerLM):
        bind_params(model, init_lm(model.cfg, seed, device))
    else:
        model.load_state_dict(init_params(model, seed, device), assign=True)


class Trainer:
    """Epoch and batch loop over a sharded or device-resident loader::

        trainer = Trainer(model, loader, sgd(0.05, momentum=0.9))
        trainer.train(max_epochs)

    The model's weights are drawn from ``seed`` (the distributions of the
    flax initializers) on the loader's device, and the strategy
    (``DataParallel`` over the loader's mesh by default) broadcasts them
    from rank 0. Each epoch fetches its losses once, in one batched copy
    at its end (``MetricsLogger``); nothing inside an epoch syncs with the
    host. ``host_syncs`` counts the trainer's fetches."""

    def __init__(self, model: nn.Module, train_loader, optimizer, *, strategy=None,
                 loss: str = "cross_entropy", aux_loss_weight: float = 0.0,
                 grad_accum_steps: int = 1, seed: int = 0, quiet: bool = False,
                 skip_nonfinite: bool = False, chaos=None,
                 rollback_spike_factor: float | None = None):
        if skip_nonfinite:
            raise _later("skip_nonfinite", _GUARDRAILS)
        if chaos is not None:
            raise _later("chaos", _GUARDRAILS)
        if rollback_spike_factor is not None:
            raise _later("loss-spike rollback", _GUARDRAILS)
        if aux_loss_weight:
            raise _later("aux_loss_weight", _MOE)
        self.model = model
        self.loader = train_loader
        self.strategy = strategy if strategy is not None else DataParallel(train_loader.mesh)
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
        self.train_step = make_train_step(loss=loss, has_batch_stats=self.has_batch_stats,
                                          grad_accum_steps=grad_accum_steps)
        self.metrics = MetricsLogger(quiet=quiet)
        self.loss_name = loss
        self.last_epoch_metrics: dict = {}
        self.epoch = 0  # next epoch to run; advanced by train(), restored
        self._own_syncs = 0
        self._eval_step = None

    @property
    def host_syncs(self) -> int:
        """Host fetches so far: the metrics drains and the trainer's own
        (evaluation, checkpoints)."""
        return self.metrics.host_fetches + self._own_syncs

    def _run_epoch(self, epoch: int) -> dict:
        loader = self.loader
        loader.set_epoch(epoch)
        self.metrics.say(epoch_line(self.strategy.num_devices, epoch,
                                    loader.per_device_batch, len(loader)))
        t0 = time.perf_counter()
        steps = 0
        for batch in loader:
            if not isinstance(batch, tuple):
                batch = (batch,)
            self.state, metrics = self.train_step(self.state, batch)
            steps += 1
            self.metrics.log_step(steps, metrics["loss"])
        self.metrics.flush()  # the epoch's one fetch: every step's loss
        dt = time.perf_counter() - t0
        loss = self.metrics.step_events()[-1]["loss"] if steps else float("nan")
        m = {
            "epoch": epoch, "loss": loss, "steps": steps,
            "steps_per_sec": steps / dt if dt > 0 else float("inf"),
            "samples_per_sec": steps * loader.global_batch / dt if dt > 0 else float("inf"),
        }
        self.metrics.log_epoch(m)
        return m

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
            self.last_epoch_metrics = self._run_epoch(epoch)
            self.epoch = epoch + 1
        return self.last_epoch_metrics

    # -- checkpoint / resume ----------------------------------------------
    def _state_tree(self) -> dict:
        opt = self.state.opt_state
        return {
            "step": self.state.step,
            "model": self.state.model.state_dict(),
            "opt_state": {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)},
            "epoch": self.epoch,
        }

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
        or a crash-windowed single path (``.old``)."""
        tree = torch.load(os.path.join(self._resolve_ckpt(path), "state.pt"),
                          map_location=self.device, weights_only=True)
        self.state.model.load_state_dict(tree["model"])
        opt = self.state.opt_state
        with torch.no_grad():
            self.state.step.copy_(tree["step"])
            for name, value in tree["opt_state"].items():
                current = getattr(opt, name)
                if isinstance(current, list):
                    for dst, src in zip(current, value):
                        dst.copy_(src)
                else:
                    setattr(opt, name, value)
        self.epoch = int(tree["epoch"])

    # -- evaluation -------------------------------------------------------
    def evaluate(self, eval_loader=None) -> dict:
        """Mean loss and accuracy (integer-label classification; 0.0
        otherwise) over ``eval_loader`` (default: the training loader),
        wrap-padded rows masked out (``valid_mask``), summed over the data
        axis; one host fetch. ``"samples"`` counts label positions."""
        loader = eval_loader if eval_loader is not None else self.loader
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.loss_name, self.has_batch_stats)
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
        group = self.strategy.group
        if group is not None:
            dist.all_reduce(total, group=group)
        loss_sum, correct, seen = total.tolist()
        self._own_syncs += 1
        seen = int(seen)
        return {"loss": loss_sum / max(seen, 1), "accuracy": int(correct) / max(seen, 1),
                "samples": seen}

