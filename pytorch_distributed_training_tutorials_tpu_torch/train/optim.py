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
returns new trees). The step count is a host integer, so a step does no
host sync.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# leaves per foreach call: bounds the temporaries of one update (m / bias
# correction, its denominator, the decay term) to a few leaves' worth. At
# the 760m train step on an H100 one pass over all 219 leaves peaked at
# 24.2 GB against 17.6 GB in chunks, at the same step time (PERF.md)
_CHUNK = 16


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: list[torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0,
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
        )

    def inverse_bias_corrections(self, count: int) -> tuple[float, float]:
        """``1 / (1 - decay ** count)`` for both moments: optax's bias
        correction in float32, then its float32 reciprocal."""
        f32 = np.float32
        return (float(f32(1.0) / (f32(1.0) - f32(self.b1) ** f32(count))),
                float(f32(1.0) / (f32(1.0) - f32(self.b2) ** f32(count))))

    @torch.no_grad()
    def update_(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                state: AdamWState) -> None:
        """One AdamW step, parameters and moments updated in place."""
        state.count += 1
        inv1, inv2 = self.inverse_bias_corrections(state.count)
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


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with its defaults (no mask, no nesterov)."""
    return AdamW(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


@dataclasses.dataclass
class SGDState:
    count: int
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
        return SGDState(count=0, trace=trace)

    @torch.no_grad()
    def update_(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                state: SGDState) -> None:
        """One SGD step, parameters and the trace updated in place."""
        state.count += 1
        u = list(grads)
        if state.trace is not None:
            torch._foreach_mul_(state.trace, self.momentum)
            torch._foreach_add_(state.trace, grads)
            u = state.trace
        torch._foreach_add_(params, torch._foreach_mul(u, -self.lr))


def sgd(learning_rate: float, momentum: float | None = None) -> SGD:
    """``optax.sgd`` without nesterov or a schedule."""
    if callable(learning_rate):
        raise TypeError("sgd takes a static float learning rate")
    return SGD(lr=float(learning_rate), momentum=momentum)
