"""The LM train step of the PyTorch port.

Port of the step builders of ``pytorch_distributed_training_tutorials_tpu/
train/trainer.py``: :class:`TrainState`, :func:`_compute_loss`,
:func:`_make_loss_fn`, :func:`_apply_update`, :func:`_train_step_fn` and
:func:`make_train_step`. PyTorch runs eagerly, so there is no ``jit``:
``make_train_step`` returns the step function itself.

The step updates the state IN PLACE — parameters, AdamW moments and the
step counter — and returns the same state object (the JAX step returns a
new, donated state). The loss stays a device tensor, so a step does no
host sync.

``loss="fused_cross_entropy"`` is the logits-free loss: the model returns
its final hidden states (``return_hidden=True``) and
:func:`..ops.fused_loss.fused_cross_entropy` streams them against the
lm_head weight. ``skip_nonfinite``, ``chaos``, ``aux_loss_weight``,
``model_kwargs``, ``has_batch_stats``, gradient accumulation and the
``Trainer`` class arrive with the DDP slice; asking for them raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pytorch_distributed_training_tutorials_tpu_torch.ops.fused_loss import fused_cross_entropy
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import AdamW, AdamWState

_DDP_SLICE = "the DDP trainer slice"


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not supported by the PyTorch port yet; it arrives with "
        f"{slice_name}"
    )


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer and its state, and the
    step count as a device tensor. The step mutates all of them in place."""

    step: torch.Tensor
    model: nn.Module
    tx: AdamW
    opt_state: AdamWState

    @classmethod
    def create(cls, *, model: nn.Module, tx: AdamW) -> "TrainState":
        params = [p for p in model.parameters() if p.requires_grad]
        dev = params[0].device
        return cls(
            step=torch.zeros((), dtype=torch.int64, device=dev),
            model=model, tx=tx, opt_state=tx.init(params),
        )

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for p in self.model.parameters() if p.requires_grad]


def _compute_loss(loss: str, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The objective in optax's terms, in the logits' dtype:
    ``cross_entropy`` with integer targets is
    ``softmax_cross_entropy_with_integer_labels`` (logsumexp minus the
    target logit), with one-hot or soft targets (same rank as the logits)
    ``softmax_cross_entropy``; ``mse`` is the mean squared error."""
    if loss == "cross_entropy":
        if targets.ndim == logits.ndim:
            return -(targets * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
        label = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - label).mean()
    if loss == "mse":
        return torch.mean((logits - targets) ** 2)
    raise ValueError(f"unknown loss {loss!r}")


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
    """The training objective: ``loss_fn(model, batch) -> loss``."""
    if has_batch_stats:
        raise _later("has_batch_stats (BatchNorm statistics)", _DDP_SLICE)
    if aux_loss_weight:
        raise _later("aux_loss_weight", _DDP_SLICE)
    if model_kwargs:
        raise _later("model_kwargs", _DDP_SLICE)
    if loss == "fused_cross_entropy":
        def fused_loss_fn(model: nn.Module, batch) -> torch.Tensor:
            x, y = batch
            return _fused_ce_loss(model, model(x, return_hidden=True), y)

        return fused_loss_fn

    def loss_fn(model: nn.Module, batch) -> torch.Tensor:
        x, y = batch
        return _compute_loss(loss, model(x), y)

    return loss_fn


def _apply_update(state: TrainState, grads: list[torch.Tensor], loss_val: torch.Tensor):
    """The optimizer tail: AdamW in place, ``step += 1`` on the device."""
    state.tx.update_(state.params, grads, state.opt_state)
    state.step += 1
    return state, {"loss": loss_val.detach()}


def _train_step_fn(loss: str = "cross_entropy", has_batch_stats: bool = False,
                   aux_loss_weight: float = 0.0, model_kwargs: dict | None = None,
                   skip_nonfinite: bool = False, chaos=None):
    """The raw train step: ``step_fn(state, batch) -> (state, metrics)``,
    forward, backward (``torch.autograd.grad``, nothing accumulates in
    ``.grad``) and the AdamW update, all in place."""
    loss_fn = _make_loss_fn(loss, has_batch_stats, aux_loss_weight, model_kwargs)
    if skip_nonfinite:
        raise _later("skip_nonfinite", _DDP_SLICE)
    if chaos is not None:
        raise _later("chaos", _DDP_SLICE)

    def step_fn(state: TrainState, batch):
        params = state.params
        loss_val = loss_fn(state.model, batch)
        grads = list(torch.autograd.grad(loss_val, params))
        return _apply_update(state, grads, loss_val)

    return step_fn


def make_train_step(loss: str = "cross_entropy", has_batch_stats: bool = False,
                    aux_loss_weight: float = 0.0, grad_accum_steps: int = 1,
                    model_kwargs: dict | None = None, skip_nonfinite: bool = False,
                    chaos=None):
    """The train step (PyTorch runs eagerly: no compile, no donation — the
    state is updated in place)."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if grad_accum_steps > 1:
        raise _later("grad_accum_steps > 1", _DDP_SLICE)
    return _train_step_fn(loss, has_batch_stats, aux_loss_weight, model_kwargs,
                          skip_nonfinite=skip_nonfinite, chaos=chaos)
