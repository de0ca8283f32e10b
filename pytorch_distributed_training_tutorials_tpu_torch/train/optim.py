"""AdamW and SGD in optax's order, as plain foreach torch ops.

``adamw`` mirrors ``optax.adamw`` (the optimizer of the JAX package's
``bench/lm_headline.py``): ``scale_by_adam`` — ``m = (1-b1) g + b1 m``,
``v = (1-b2) g^2 + b2 v``, the bias corrections ``1 - b^t`` in float32,
``m_hat / (sqrt(v_hat) + eps)`` — then ``+ weight_decay * p`` on every
leaf, then ``* -lr``, then ``p += u``. ``m_hat`` and ``v_hat`` multiply by
the float32 reciprocal of the bias correction (what PyTorch's CUDA
``_foreach_div`` by a scalar computes; optax divides, which differs in the
last bit), so the update is the same on every device. It is not ``torch.optim.AdamW``,
which decays ``p`` first and rounds differently. This is the plain twin
that the fused AdamW kernel (:mod:`..ops.fused_optim`) is held to, bitwise.

The update is IN PLACE: parameters and moments are overwritten (JAX
returns new trees). The step count is a device tensor (optax's ``count``)
and the bias corrections are read from a device table of the host's
float32 values indexed by it (:class:`AdamWState`), so a step does no host
sync and the corrections are bitwise what the host computes.

``mask`` (set through ``ops.fused_optim.fused_adamw(mask=...)``, the JAX
package's ``optax.masked`` with a hard zero on the rest) restricts the
update to the leaves it marks True: ``init`` and ``update_`` given the
parameters as a name -> tensor mapping select those leaves, so the others
get no moment buffers and no update; given a list, the list is taken as
the trainable leaves already (what ``TrainState`` passes after freezing
the others).

``update_(..., ok=flag)`` is the skip-step guard's form (the trainer's
``skip_nonfinite``): ``flag`` is a 0-dim int32 device tensor, and where it
is 0 the parameters and the optimizer state come out bitwise unchanged,
the count included. Without it (``ok=None``) the update is the unguarded
one, bitwise the same arithmetic.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from pytorch_distributed_training_tutorials_tpu_torch.adapters.lora import resolve_mask

# leaves per foreach call: bounds the temporaries of one update (m / bias
# correction, its denominator, the decay term) to a few leaves' worth. At
# the 760m train step on an H100 one pass over all 219 leaves peaked at
# 24.2 GB against 17.6 GB in chunks, at the same step time (PERF.md)
_CHUNK = 16


# rows of a new bias-correction table; it doubles when the step count
# could reach its end
_TABLE_ROWS = 1024


@dataclasses.dataclass
class AdamWState:
    """optax's ``count``, ``mu`` and ``nu``, and the bias-correction table:
    ``table[t]`` holds ``inverse_bias_corrections(t)`` (host float32 values)
    for every count ``t`` the state can reach; ``calls`` (host) counts
    updates so far, an upper bound of ``count``, and grows the table before
    the count could pass its end."""

    count: torch.Tensor  # int32, 0-dim, on the parameters' device
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    table: torch.Tensor  # (rows, 2) float32 on the same device
    calls: int = 0


def keep_where(ok: torch.Tensor, new: list[torch.Tensor], old: list[torch.Tensor]) -> None:
    """``new[i] = old[i]`` where the 0-dim flag ``ok`` is 0, in place: a
    select, so either side's bits pass through unchanged."""
    flag = ok.bool()
    for n, o in zip(new, old):
        torch.where(flag, n, o, out=n)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    mask: object = None  # name -> bool, or a callable of the named params

    def select(self, params, grads=None):
        """The leaves this optimizer updates, and their gradients: a list
        as given; from a name -> tensor mapping the leaves ``mask`` marks
        True (every leaf without a mask), ``grads`` a mapping by name or a
        list in ``params``' order."""
        if not isinstance(params, Mapping):
            return list(params), None if grads is None else list(grads)
        keep = (resolve_mask(self.mask, params) if self.mask is not None
                else dict.fromkeys(params, True))
        names = [n for n in params if keep[n]]
        if grads is not None and not isinstance(grads, Mapping):
            grads = dict(zip(params, grads))
        return ([params[n] for n in names],
                None if grads is None else [grads[n] for n in names])

    def init(self, params) -> AdamWState:
        params, _ = self.select(params)
        dev = params[0].device
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
            table=self._table(_TABLE_ROWS, dev),
        )

    def inverse_bias_corrections(self, count: int) -> tuple[float, float]:
        """``1 / (1 - decay ** count)`` for both moments: optax's bias
        correction in float32, then its float32 reciprocal."""
        f32 = np.float32
        return (float(f32(1.0) / (f32(1.0) - f32(self.b1) ** f32(count))),
                float(f32(1.0) / (f32(1.0) - f32(self.b2) ** f32(count))))

    def _table(self, rows: int, device: torch.device) -> torch.Tensor:
        """Rows 0 .. rows-1 of the device table (row 0, which no applied
        update reads, holds 1.0)."""
        host = np.ones((rows, 2), dtype=np.float32)
        for t in range(1, rows):
            host[t] = self.inverse_bias_corrections(t)
        t = torch.from_numpy(host)
        return t.to(device) if device.type != "cuda" else t.pin_memory().to(device, non_blocking=True)

    def advance_(self, state: AdamWState, ok: torch.Tensor | None) -> None:
        """The count advanced on the device (by ``ok``, else 1); the table
        grows first, doubling, if the count could reach its end."""
        state.calls += 1
        rows = state.table.shape[0]
        if state.calls >= rows:
            while rows <= state.calls:
                rows *= 2
            state.table = self._table(rows, state.table.device)
        state.count.add_(1 if ok is None else ok)

    @torch.no_grad()
    def update_(self, params, grads, state: AdamWState,
                ok: torch.Tensor | None = None) -> None:
        """One AdamW step, parameters and moments updated in place; with
        ``ok`` 0 everything stays bitwise as it was."""
        params, grads = self.select(params, grads)
        kept = None
        if ok is not None:
            kept = [x.clone() for x in (*params, *state.mu, *state.nu)]
        self.advance_(state, ok)
        inv1, inv2 = state.table.index_select(0, state.count.reshape(1))[0]  # 0-dim views
        for lo in range(0, len(params), _CHUNK):
            p = params[lo:lo + _CHUNK]
            g = grads[lo:lo + _CHUNK]
            mu = state.mu[lo:lo + _CHUNK]
            nu = state.nu[lo:lo + _CHUNK]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1.0 - self.b2)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(nu, g2)
            del g2
            u = torch._foreach_mul(mu, inv1)
            den = torch._foreach_mul(nu, inv2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(u, den)
            del den
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(u, -self.lr)
            torch._foreach_add_(p, u)
        if kept is not None:
            keep_where(ok, [*params, *state.mu, *state.nu], kept)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with its defaults (no mask, no nesterov)."""
    return AdamW(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


@dataclasses.dataclass
class SGDState:
    """optax's ``TraceState``: the momentum trace (None without momentum)."""

    trace: list[torch.Tensor] | None


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd``: with ``momentum``, optax's ``trace`` — ``trace = g +
    momentum * trace``, the update the trace itself — then ``* -lr`` and
    ``p += u``, in place."""

    lr: float
    momentum: float | None = None

    def init(self, params: list[torch.Tensor]) -> SGDState:
        trace = None if self.momentum is None else [torch.zeros_like(p) for p in params]
        return SGDState(trace=trace)

    @torch.no_grad()
    def update_(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                state: SGDState, ok: torch.Tensor | None = None) -> None:
        """One SGD step, parameters and the trace updated in place; with
        ``ok`` 0 both stay bitwise as they were."""
        trace = state.trace or []
        kept = None if ok is None else [x.clone() for x in (*params, *trace)]
        u = list(grads)
        if state.trace is not None:
            torch._foreach_mul_(state.trace, self.momentum)
            torch._foreach_add_(state.trace, grads)
            u = state.trace
        torch._foreach_add_(params, torch._foreach_mul(u, -self.lr))
        if kept is not None:
            keep_where(ok, [*params, *trace], kept)


def sgd(learning_rate: float, momentum: float | None = None) -> SGD:
    """``optax.sgd`` without nesterov or a schedule."""
    if callable(learning_rate):
        raise TypeError("sgd takes a static float learning rate")
    return SGD(lr=float(learning_rate), momentum=momentum)
