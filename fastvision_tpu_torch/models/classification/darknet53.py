"""Darknet-53 backbone (port of fastvision_tpu/models/classification/darknet53.py).

Residual stages (1, 2, 8, 8, 4) of widths 64 * 2**i after a 32-wide stem,
each stage opened by a stride-2 3x3 ConvBN. The forward returns
[P5, P4, P3] (strides 32, 16, 8; channels 1024, 512, 256), NCHW like every
module inside the detector. Module names follow the reference demo's torch
checkpoints (``conv0``, ``conv{i}``, ``res{i}.{j}.conv{1,2}``). The
classification top is not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...nn.layers import ConvBN


class DarkResidual(nn.Module):
    """1x1 squeeze -> 3x3 expand + skip."""

    def __init__(self, features: int, act: str = "silu"):
        super().__init__()
        self.conv1 = ConvBN(features, features // 2, 1, 1, act=act)
        self.conv2 = ConvBN(features // 2, features, 3, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.conv1(x))


class Darknet53(nn.Module):
    """``stage_sizes`` sets the residual blocks per stage (tests build
    shallow nets with it); widths never change."""

    strides_per_level = (32, 16, 8)
    channels_per_level = (1024, 512, 256)

    def __init__(self, act: str = "silu", stage_sizes: Sequence[int] = (1, 2, 8, 8, 4)):
        super().__init__()
        if len(stage_sizes) != 5:
            raise ValueError(f"Darknet53 has 5 stages, got stage_sizes={stage_sizes}")
        self.stage_sizes = tuple(stage_sizes)
        self.conv0 = ConvBN(3, 32, 3, 1, act=act)
        prev = 32
        for i, n_blocks in enumerate(self.stage_sizes):
            features = 64 * 2**i
            setattr(self, f"conv{i + 1}", ConvBN(prev, features, 3, 2, act=act))
            setattr(self, f"res{i + 1}",
                    nn.Sequential(*(DarkResidual(features, act) for _ in range(n_blocks))))
            prev = features

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.conv0(x)
        feats = []
        for i in range(1, 6):
            x = getattr(self, f"res{i}")(getattr(self, f"conv{i}")(x))
            feats.append(x)
        return [feats[4], feats[3], feats[2]]  # P5(32), P4(16), P3(8)
