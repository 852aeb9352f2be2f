"""Darknet-53 backbone (port of fastvision_tpu/models/classification/darknet53.py).

Residual stages (1, 2, 8, 8, 4) of widths 64 * 2**i after a 32-wide stem,
each stage opened by a stride-2 3x3 ConvBN. The forward returns
[P5, P4, P3] (strides 32, 16, 8; channels 1024, 512, 256), NCHW like every
module inside the detector. Module names follow the reference demo's torch
checkpoints (``conv0``, ``conv{i}``, ``res{i}.{j}.conv{1,2}``, ``fc``).

`darknet53()` is the classifier (``including_top=True``): NHWC images
[B, H, W, 3] -> global average pool of P5 -> ``fc`` logits.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...nn.layers import Carried, ConvBN, float_of, global_avg_pool, init_weights_


class DarkResidual(nn.Module):
    """1x1 squeeze -> 3x3 expand + skip. The skip is added after conv2's
    activation, by conv2 itself (in its int8 kernel's epilogue where it runs
    on one); int8, conv1 hands its output to conv2 in int8 only."""

    def __init__(self, features: int, act: str = "silu"):
        super().__init__()
        self.conv1 = ConvBN(features, features // 2, 1, 1, act=act)
        self.conv2 = ConvBN(features // 2, features, 3, 1, act=act)

    def forward(self, x: torch.Tensor | Carried) -> torch.Tensor | Carried:
        return self.conv2(self.conv1(x), residual=x)

    def int8_edges(self) -> list[tuple[str, str, bool]]:
        return [("conv1", "conv2", False)]


class Darknet53(nn.Module):
    """``stage_sizes`` sets the residual blocks per stage (tests build
    shallow nets with it); widths never change."""

    strides_per_level = (32, 16, 8)
    channels_per_level = (1024, 512, 256)

    def __init__(self, act: str = "silu", stage_sizes: Sequence[int] = (1, 2, 8, 8, 4),
                 including_top: bool = False, num_classes: int = 1000,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.including_top = including_top
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
        if including_top:
            self.fc = nn.Linear(prev, num_classes)
            init_weights_(self, generator)

    def forward(self, x: torch.Tensor):
        """[P5, P4, P3] (or the classifier's logits). P5 as its conv hands it
        on: a `Carried` where a model that holds this backbone links it to
        its next conv (YOLOv3's neck), else a float tensor, as P4 and P3."""
        if self.including_top:
            x = x.permute(0, 3, 1, 2)
        x = self.conv0(x)
        feats = []
        for i in range(1, 6):
            x = getattr(self, f"res{i}")(getattr(self, f"conv{i}")(x))
            feats.append(x)
        if self.including_top:
            return self.fc(global_avg_pool(x))
        return [feats[4], float_of(feats[3]), float_of(feats[2])]  # P5(32), P4(16), P3(8)

    @property
    def last_conv(self) -> str:
        """The ConvBN whose output is P5: the last block's conv2."""
        n = self.stage_sizes[4]
        return f"res5.{n - 1}.conv2" if n else "conv5"

    def int8_edges(self) -> list[tuple[str, str, bool]]:
        """Each stage's downsample conv and each block's conv2 hand their
        output to the next block's conv1 in int8 beside the float (the float
        is that block's skip). A stage's last output goes on to the next
        stage's downsample conv beside the float where the float is a
        returned level (stages 3 and 4), else in int8 only (stages 1 and 2;
        every stage in the classifier, which reads only the last)."""
        edges, prev = [], None
        for i, n_blocks in enumerate(self.stage_sizes, 1):
            if prev is not None:
                edges.append((prev, f"conv{i}", not self.including_top and i - 1 >= 3))
            prev = f"conv{i}"
            for j in range(n_blocks):
                edges.append((prev, f"res{i}.{j}.conv1", True))
                prev = f"res{i}.{j}.conv2"
        return edges


def darknet53(num_classes: int = 1000, **kwargs) -> Darknet53:
    """The Darknet-53 classifier (the JAX package's ``darknet53`` factory)."""
    return Darknet53(num_classes=num_classes, including_top=True, **kwargs)
