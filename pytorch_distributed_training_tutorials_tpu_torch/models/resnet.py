"""ResNets: port of the JAX package's ``models/resnet.py`` (flax), layer for
layer, with the same parameter count (ResNet-50: 25,557,032) and the same
2-stage cut (``stage0`` / ``stage1`` after layer group ``split_after``).

What the port keeps of flax's semantics:

- **SAME padding.** flax pads ``SAME`` from the input size: a 3x3
  stride-2 conv pads (0, 1) on an even input (28 -> 14, 14 -> 7) and
  (1, 1) on an odd one (7 -> 4). :class:`Conv` computes the pads per call
  (torch's ``padding=1`` would be wrong on even inputs).
- **BatchNorm** (:class:`BatchNorm`, momentum 0.9, eps 1e-5): the batch
  statistics in (at least) float32 as flax's ``_compute_stats`` with
  ``use_fast_variance`` takes them, ``mean = E[x]``, ``var = max(0,
  E[x^2] - E[x]^2)``; the running variance takes this biased ``var``; the
  output ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32,
  cast to ``dtype``. With ``sync_group`` set (by
  :meth:`..parallel.DataParallel.shard_state`) the sums are taken over the
  whole data axis, as XLA takes them over the sharded global batch.
- **dtype.** Parameters stay float32; convolutions and the dense head cast
  input and weight to ``dtype`` (bf16 on the headline), as flax's
  ``dtype=`` does; the norm's statistics stay float32, its output is
  ``dtype``.
- **Layout.** The model takes NHWC images, as the loaders hold them, and
  computes in NCHW: ``x.permute(0, 3, 1, 2)`` of an NHWC tensor is
  channels-last in memory, so cuDNN keeps that format through the net.
  The global average pool is over H and W.

A block's convolutions and norms sit in ``convs`` and ``norms`` in
flax's creation order (``Conv_i`` / ``BatchNorm_i`` in the JAX tree),
layer group i's block j in ``layer_groups[i][j]`` (``layer_groups_i_j``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_training_tutorials_tpu_torch.models.mlp import Linear
from pytorch_distributed_training_tutorials_tpu_torch.parallel.collective import all_reduce_sum


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)`` on NCHW: weight OIHW (float32),
    ``SAME`` padding unless ``padding`` gives (low, high) per axis."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, *,
                 padding: tuple[tuple[int, int], tuple[int, int]] | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding is None:
            (t, b), (l, r) = (same_pads(x.shape[-2], self.kernel, self.stride),
                              same_pads(x.shape[-1], self.kernel, self.stride))
        else:
            (t, b), (l, r) = self.padding
        x = x.to(self.dtype)
        if (t, l) == (b, r):
            pad = (t, l)
        else:  # asymmetric: pad explicitly
            x = F.pad(x, (l, r, t, b))
            pad = (0, 0)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over N, H, W of an
    NCHW tensor (see the module docstring)."""

    def __init__(self, features: int, *, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.sync_group = None  # the data group when the batch is split across processes

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            c = x.shape[1]
            sums = torch.cat([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))])
            count = float(x.numel() // c)
            if self.sync_group is not None:
                sums = all_reduce_sum(sums, self.sync_group)
                count *= torch.distributed.get_world_size(self.sync_group)
            mean, mean_sq = (sums / count).split(c)
            var = torch.clamp_min(mean_sq - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class BasicBlock(nn.Module):
    """Two 3x3 convs and the identity shortcut (ResNet-18/34); a 1x1
    projection where the shape changes."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        convs = [Conv(in_ch, filters, 3, strides, dtype=dtype), Conv(filters, filters, 3, dtype=dtype)]
        self.project = strides != 1 or in_ch != filters
        if self.project:
            convs.append(Conv(in_ch, filters, 1, strides, dtype=dtype))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList([BatchNorm(filters, dtype=dtype) for _ in convs])

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        c, n = self.convs, self.norms
        y = torch.relu(n[0](c[0](x), train))
        y = n[1](c[1](y), train)
        residual = n[2](c[2](x), train) if self.project else x
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) bottleneck (ResNet-50)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = filters * self.expansion
        convs = [Conv(in_ch, filters, 1, dtype=dtype), Conv(filters, filters, 3, strides, dtype=dtype),
                 Conv(filters, out, 1, dtype=dtype)]
        self.project = strides != 1 or in_ch != out
        if self.project:
            convs.append(Conv(in_ch, out, 1, strides, dtype=dtype))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList([BatchNorm(conv.weight.shape[0], dtype=dtype) for conv in convs])

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        c, n = self.convs, self.norms
        y = torch.relu(n[0](c[0](x), train))
        y = torch.relu(n[1](c[1](y), train))
        y = n[2](c[2](y), train)
        residual = n[3](c[3](x), train) if self.project else x
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """The torchvision-architecture ResNet of the JAX package, with its
    declared 2-stage cut after layer group ``split_after``.

    ``stem="imagenet"``: 7x7 stride-2 conv padded (3, 3) and a 3x3
    stride-2 max pool padded (1, 1); ``stem="cifar"``: one 3x3 conv (SAME),
    no pool. ``in_channels`` is the images' channel count (flax infers it
    from the first batch: 1 for MNIST, 3 for CIFAR-10)."""

    def __init__(self, stage_sizes, block_cls, num_classes: int = 1000, num_filters: int = 64,
                 stem: str = "imagenet", split_after: int = 2,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem {stem!r}")
        self.stem, self.split_after, self.dtype = stem, split_after, dtype
        if stem == "imagenet":
            self.conv1 = Conv(in_channels, num_filters, 7, 2, padding=((3, 3), (3, 3)), dtype=dtype)
        else:
            self.conv1 = Conv(in_channels, num_filters, 3, 1, dtype=dtype)
        self.bn1 = BatchNorm(num_filters, dtype=dtype)
        groups, ch = [], num_filters
        for i, size in enumerate(stage_sizes):
            group = []
            for j in range(size):
                filters = num_filters * 2 ** i
                group.append(block_cls(ch, filters, 2 if i > 0 and j == 0 else 1, dtype=dtype))
                ch = filters * block_cls.expansion
            groups.append(nn.ModuleList(group))
        self.layer_groups = nn.ModuleList(groups)
        self.fc = Linear(ch, num_classes, dtype=dtype)

    def stage0(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """NHWC images -> the stem and layer groups before ``split_after``
        (NCHW features)."""
        x = torch.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2)), train))
        if self.stem == "imagenet":
            x = F.max_pool2d(x, 3, 2, padding=1)
        for group in self.layer_groups[: self.split_after]:
            for block in group:
                x = block(x, train)
        return x

    def stage1(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """The remaining layer groups, the global average pool and ``fc``."""
        for group in self.layer_groups[self.split_after:]:
            for block in group:
                x = block(x, train)
        return self.fc(x.mean(dim=(2, 3)))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.stage1(self.stage0(x, train), train)

    def stage_partition(self, name: str) -> int:
        """Parameter or buffer name -> stage: the stem and the layer groups
        before ``split_after`` on stage 0, the rest and ``fc`` on 1."""
        parts = name.split(".")
        if parts[0] in ("conv1", "bn1"):
            return 0
        if parts[0] == "fc":
            return 1
        if parts[0] == "layer_groups":
            return 0 if int(parts[1]) < self.split_after else 1
        raise ValueError(f"unknown param key {name!r}")


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck, **kw)
