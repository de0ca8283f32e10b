"""Fused AdamW: the optimizer update as one kernel pass over every leaf.

Port of ``pytorch_distributed_training_tutorials_tpu/ops/fused_optim.py``.
:func:`fused_adamw` returns a :class:`FusedAdamW`, the duck type of
:class:`..train.optim.AdamW` (``init(params)``, ``update_(params, grads,
state)``), so it plugs into ``TrainState.create`` unchanged. Its update is
optax.adamw's arithmetic in the order of the port's plain foreach AdamW
(``train/optim.py``, the plain version this kernel is held to, bitwise):
a CPU tensor runs that plain version; CUDA tensors launch
``adamw_kernel`` of ``csrc/fused_adamw.cu`` — all leaves in one launch
(up to 512 leaves per launch), m, v and p updated in place, u rounded to
f32 before ``p + u`` as optax's ``update`` then ``apply_updates`` round
it. The kernel reads the step count and the bias corrections from the
state's device tensors, and the skip-step guard's flag ``ok`` (a 0-dim
int32 device tensor): where it is 0 no block stores anything, so p, m, v
and the count stay bitwise unchanged without a copy or a host sync.
Float32 contiguous leaves only; it raises on anything else and when
a launch fails, and never falls back. ``fused_adamw.launches`` counts
kernel launches; CPU calls add none.

``mask=`` (the JAX package's, e.g. ``adapters.lora.lora_param_mask``)
restricts the update to the leaves it marks True: the rest get a hard
zero update (they are not touched) and no moment buffers, and the kernel
launches once a step over the trainable leaves only
(:meth:`..train.optim.AdamW.select`; ``TrainState`` freezes the rest, so
they get no gradient either).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pytorch_distributed_training_tutorials_tpu_torch.ops import _build
from pytorch_distributed_training_tutorials_tpu_torch.train.optim import AdamW, AdamWState


def _route(params, grads, state: AdamWState) -> bool:
    """True to launch the kernel (CUDA), False to run the plain version
    (CPU); raises on any other device or on leaves it cannot take."""
    groups = (params, grads, state.mu, state.nu)
    if len({len(x) for x in groups}) != 1:
        raise ValueError("fused_adamw: params, grads and moments differ in leaf count")
    leaves = [x for grp in groups for x in grp]
    devices = {x.device for x in leaves}
    if len(devices) > 1:
        raise ValueError(f"fused_adamw leaves on different devices: {devices}")
    if not leaves or next(iter(devices)).type == "cpu":
        return False
    if next(iter(devices)).type != "cuda":
        raise ValueError(f"fused_adamw runs on cpu or cuda, got {devices}")
    dev = next(iter(devices))
    if (state.count.dtype, state.count.device, state.table.dtype, state.table.device) != (
            torch.int32, dev, torch.float32, dev) or not state.table.is_contiguous():
        raise ValueError("fused_adamw: the state's count (int32) and bias-correction table "
                         "(float32, contiguous) must lie on the leaves' device")
    for p, g, m, v in zip(*groups):
        for x in (g, m, v):
            if x.shape != p.shape:
                raise ValueError(f"fused_adamw: leaf shapes differ: {tuple(p.shape)} vs {tuple(x.shape)}")
        for x in (p, g, m, v):
            if x.dtype != torch.float32:
                raise TypeError(f"fused_adamw kernel takes float32 leaves, got {x.dtype}")
            if not x.is_contiguous():
                raise ValueError("fused_adamw kernel takes contiguous leaves")
    return True


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))


@dataclasses.dataclass(frozen=True)
class FusedAdamW(AdamW):
    """:class:`..train.optim.AdamW` whose update is one kernel launch on
    the card (the plain foreach version on the CPU)."""

    @torch.no_grad()
    def update_(self, params, grads, state: AdamWState,
                ok: torch.Tensor | None = None) -> None:
        """One AdamW step, parameters and moments updated in place; with
        ``ok`` 0 everything stays bitwise as it was."""
        params, grads = self.select(params, grads)
        if not _route(params, grads, state):
            return super().update_(params, grads, state, ok)
        if ok is not None and (ok.dtype != torch.int32 or ok.numel() != 1
                               or ok.device != params[0].device):
            raise ValueError("fused_adamw: ok must be one int32 element on the leaves' device")
        self.advance_(state, ok)  # the count by ok; the kernel reads its table row
        n = len(params)
        sizes = (ctypes.c_longlong * n)(*(p.numel() for p in params))
        launched = ctypes.c_int(0)
        lib = _build.library("fused_adamw")
        dev = params[0].device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fused_adamw_launch(
                _pointers(grads), _pointers(state.mu),
                _pointers(state.nu), _pointers(params), sizes, n,
                self.b1, 1.0 - self.b1, self.b2, 1.0 - self.b2, self.eps,
                self.weight_decay, -self.lr,
                ctypes.c_void_p(None if ok is None else ok.data_ptr()),
                ctypes.c_void_p(state.count.data_ptr()),
                ctypes.c_void_p(state.table.data_ptr()),
                ctypes.c_void_p(stream), ctypes.byref(launched),
            )
        fused_adamw.launches += launched.value
        if rc != 0:
            raise RuntimeError(f"fused_adamw kernel launch failed: CUDA error {rc}")


def fused_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 1e-4, *,
                mask=None) -> FusedAdamW:
    """``optax.adamw`` with its defaults (no nesterov), the update fused
    into one kernel pass on the card. ``mask`` (a name -> bool mapping, or
    a callable that returns one from the named parameters) restricts the
    update to the True leaves, as the JAX ``fused_adamw(mask=)``."""
    if callable(learning_rate):
        raise TypeError(
            "fused_adamw takes a static float learning_rate (it is passed to "
            "the kernel as a scalar); use train.optim.adamw for schedules"
        )
    return FusedAdamW(lr=float(learning_rate), b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, mask=mask)


# kernel launches on the card (CPU calls add none)
fused_adamw.launches = 0
