"""Linear and MLP models: port of the JAX package's ``models/mlp.py``.

flax infers a layer's input width from the first batch; a torch module
is built with its widths, so :class:`MLP` takes ``in_dim``. ``dtype`` is
the compute type: parameters stay float32 and are cast at the matmul, as
``nn.Dense(dtype=...)`` casts them. Dense layers sit in ``denses`` in
flax's creation order (``Dense_0``, ``Dense_1``, ... in the JAX tree; the
weight bridge :func:`..models.convert.from_jax_params` maps them).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    """flax ``nn.Dense``: ``x @ W + b`` computed in ``dtype``; the weight is
    stored (out, in), torch's layout (the JAX kernel is (in, out))."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class LinearRegressor(nn.Module):
    """``Linear(20, 1)``: the DDP scripts' model."""

    def __init__(self, in_dim: int = 20, out_dim: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.denses = nn.ModuleList([Linear(in_dim, out_dim, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.denses[0](x)


class SampleModel(nn.Module):
    """``Linear(32, 2)``; ``debug_shapes`` prints each forward's input
    shape — in the port that is this process's block of the batch."""

    def __init__(self, in_dim: int = 32, out_dim: int = 2, debug_shapes: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.debug_shapes = debug_shapes
        self.denses = nn.ModuleList([Linear(in_dim, out_dim, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.debug_shapes:
            print(f"SampleModel forward: input shape {list(x.shape)}", flush=True)
        return self.denses[0](x)


class MLP(nn.Module):
    """Dense layers of ``features`` widths with ReLU between them."""

    def __init__(self, features: Sequence[int] = (128, 1), in_dim: int = 20,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_dim, *features]
        self.denses = nn.ModuleList(
            [Linear(a, b, dtype=dtype) for a, b in zip(widths[:-1], widths[1:])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, dense in enumerate(self.denses):
            x = dense(x)
            if i < len(self.denses) - 1:
                x = torch.relu(x)
        return x


class ToyModel(nn.Module):
    """``Linear(10000, 10) -> ReLU -> Linear(10, 5)`` with its 2-stage cut
    (``stage0``: net1, ``stage1``: net2)."""

    def __init__(self, in_dim: int = 10000, hidden: int = 10, out_dim: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net1 = Linear(in_dim, hidden, dtype=dtype)
        self.net2 = Linear(hidden, out_dim, dtype=dtype)

    def stage0(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.net1(x))

    def stage1(self, x: torch.Tensor) -> torch.Tensor:
        return self.net2(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stage1(self.stage0(x))

    def stage_partition(self, name: str) -> int:
        """Param name -> stage: net1 on stage 0, net2 on stage 1."""
        return 0 if name.split(".")[0] == "net1" else 1
