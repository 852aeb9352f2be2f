"""Factorized 3D-ResNet (port of fastvision_tpu/models/video/resnet3d.py).

  - `Bottleneck3D`: 1x1x1 -> spatial 1x3x3 (the H / W stride) -> temporal
    3x1x1 (the T stride) -> 1x1x1 expanded x4; the downsample takes the
    full stride;
  - `BasicBlock3D`: two full 3x3x3 convs, the stride on the first
    (resnet18_3d / resnet34_3d are not factorized);
  - stem: a (1, 7, 7) stride-(1, 2, 2) conv + BN + ReLU, a (1, 3, 3)
    stride-(1, 2, 2) max pool with -inf padding (0, 1, 1); stage strides
    (2, 2, 2) from stage 2 on; a global mean over T, H and W; ``fc``.

Every conv pads ``k // 2`` on both sides of each dim, without a bias, and
is followed by BN (`nn.layers.BatchNorm3d`). The JAX package adds a
downsample where the residual's shape differs from the block's output,
which it sees while tracing; here a block has one where its stride is not 1
or its width changes, which is the same choice for every factory.

The ``state_dict`` keys are the reference's (``conv1.0`` / ``conv1.1``,
``res{2..5}.{j}.conv1`` / ``bn1``, ``conv2_spatial`` / ``bn2_spatial``,
``conv2_temporal`` / ``bn2_temporal``, ``conv3`` / ``bn3``,
``downsample.{0,1}``, ``fc``), so the JAX package's
``resnet3d_from_reference`` + ``apply_import`` load this model's weights.

Input: NDHWC clips [B, T, H, W, 3] -> logits [B, num_classes].
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import BatchNorm3d, init_weights_


def conv3d(cin: int, cout: int, kernel: tuple, stride: tuple = (1, 1, 1),
           bias: bool = False) -> nn.Conv3d:
    """A Conv3d with symmetric ``k // 2`` padding per dim."""
    return nn.Conv3d(cin, cout, kernel, stride, padding=tuple(k // 2 for k in kernel), bias=bias)


class Conv(nn.Module):
    """A Conv3d under ``.conv``, the module-wrapped naming of the
    reference's SlowFast and C3D."""

    def __init__(self, cin: int, cout: int, kernel: tuple, stride: tuple = (1, 1, 1),
                 bias: bool = False):
        super().__init__()
        self.conv = conv3d(cin, cout, kernel, stride, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """The stems' (1, 3, 3) / (1, 2, 2) max pool, -inf padding (0, 1, 1)."""
    return F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


def _downsample(cin: int, cout: int, stride: tuple) -> nn.Module | None:
    if stride == (1, 1, 1) and cin == cout:
        return None
    return nn.Sequential(conv3d(cin, cout, (1, 1, 1), stride), BatchNorm3d(cout))


class BasicBlock3D(nn.Module):
    """Two full 3x3x3 convs + shortcut."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: tuple = (1, 1, 1)):
        super().__init__()
        self.conv1, self.bn1 = conv3d(cin, features, (3, 3, 3), stride), BatchNorm3d(features)
        self.conv2, self.bn2 = conv3d(features, features, (3, 3, 3)), BatchNorm3d(features)
        self.downsample = _downsample(cin, features, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Bottleneck3D(nn.Module):
    """1x1x1 -> spatial 1x3x3 -> temporal 3x1x1 -> 1x1x1 (x4) + shortcut."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: tuple = (1, 1, 1)):
        super().__init__()
        st, sh, sw = stride
        out = features * self.expansion
        self.conv1, self.bn1 = conv3d(cin, features, (1, 1, 1)), BatchNorm3d(features)
        self.conv2_spatial = conv3d(features, features, (1, 3, 3), (1, sh, sw))
        self.bn2_spatial = BatchNorm3d(features)
        self.conv2_temporal = conv3d(features, features, (3, 1, 1), (st, 1, 1))
        self.bn2_temporal = BatchNorm3d(features)
        self.conv3, self.bn3 = conv3d(features, out, (1, 1, 1)), BatchNorm3d(out)
        self.downsample = _downsample(cin, out, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2_spatial(self.conv2_spatial(y)))
        y = F.relu(self.bn2_temporal(self.conv2_temporal(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet3D(nn.Module):
    """``generator`` seeds the initial weights: convs and ``fc``
    lecun-normal (flax's default for ``Conv`` and ``Dense``)."""

    def __init__(self, block_cls: type, stage_sizes: Sequence[int], num_classes: int = 400,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = nn.Sequential(conv3d(3, 64, (1, 7, 7), (1, 2, 2)), BatchNorm3d(64))
        cin = 64
        for i, n_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(n_blocks):
                stride = (2, 2, 2) if (i > 0 and j == 0) else (1, 1, 1)
                blocks.append(block_cls(cin, 64 * 2**i, stride))
                cin = 64 * 2**i * block_cls.expansion
            setattr(self, f"res{i + 2}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(cin, num_classes)
        init_weights_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = stem_pool(F.relu(self.conv1(x.permute(0, 4, 1, 2, 3))))
        for i in range(self.num_stages):
            x = getattr(self, f"res{i + 2}")(x)
        return self.fc(x.mean(dim=(2, 3, 4)))


resnet18_3d = partial(ResNet3D, BasicBlock3D, (2, 2, 2, 2))
resnet34_3d = partial(ResNet3D, BasicBlock3D, (3, 4, 6, 3))
resnet50_3d = partial(ResNet3D, Bottleneck3D, (3, 4, 6, 3))
resnet101_3d = partial(ResNet3D, Bottleneck3D, (3, 4, 23, 3))
resnet152_3d = partial(ResNet3D, Bottleneck3D, (3, 8, 36, 3))
