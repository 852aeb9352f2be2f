"""YOLOv3: Darknet-53 + top-down FPN neck + 1x1 heads (port of
fastvision_tpu/models/detection/yolov3.py).

Public contract, as in the JAX package: the model takes NHWC images
[B, H, W, 3] and returns per-level raw heads [B, H, W, A, 5 + C], deepest
level (stride 32) first. Inside, ``x.permute(0, 3, 1, 2)`` of an NHWC tensor
is a free NCHW view in ``channels_last`` memory; the head's A * (5 + C)
channels (channel = a * (5 + C) + k) are permuted back to the JAX layout.

Module names are the reference demo's torch names (``backbone.*``,
``neck.neck_{small,medium,large}.{k}``, ``neck.neck_out_*``,
``neck.up_sampling_{small,medium}.0``, ``head.head_out_*``), the exact
inverse of ``fastvision_tpu/models/import_torch.py::yolov3_from_torch``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...nn.layers import Carried, ConvBN, float_of, init_weights_
from ..classification.darknet53 import Darknet53

LEVELS = ("small", "medium", "large")  # strides 32, 16, 8


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor."""
    return nn.functional.interpolate(x, scale_factor=2, mode="nearest")


class Upsample2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x(x)


class YoloBlock(nn.Sequential):
    """The 5-conv (1-3-1-3-1) refinement block; int8, each conv hands its
    output to the next in int8 only."""

    def __init__(self, in_features: int, features: int, act: str):
        f = features
        super().__init__(
            ConvBN(in_features, f, 1, act=act), ConvBN(f, f * 2, 3, act=act),
            ConvBN(f * 2, f, 1, act=act), ConvBN(f, f * 2, 3, act=act),
            ConvBN(f * 2, f, 1, act=act),
        )

    def forward(self, x: torch.Tensor | Carried) -> torch.Tensor | Carried:
        for conv in self:
            x = conv(x)
        return x

    def int8_edges(self) -> list[tuple[str, str, bool]]:
        return [(str(i), str(i + 1), False) for i in range(len(self) - 1)]


class YOLOv3Neck(nn.Module):
    """Top-down FPN over [P5, P4, P3]: per level a YoloBlock on
    ``cat([x, up(lateral(carry))])`` and a 3x3 ConvBN out. int8, each
    block's last conv hands its output to the level's out conv (and keeps
    the float for the lateral where there is one); the concat and the
    laterals take float inputs."""

    def __init__(self, in_channels: Sequence[int] = (1024, 512, 256),
                 channels: Sequence[int] = (1024, 512, 256), act: str = "silu"):
        super().__init__()
        self.levels = LEVELS[:len(channels)]
        for i, (lvl, cin, ch) in enumerate(zip(LEVELS, in_channels, channels)):
            block_in = cin if i == 0 else cin + ch // 2
            setattr(self, f"neck_{lvl}", YoloBlock(block_in, ch // 2, act))
            setattr(self, f"neck_out_{lvl}", ConvBN(ch // 2, ch, 3, act=act))
            if i + 1 < len(channels):
                setattr(self, f"up_sampling_{lvl}", nn.Sequential(
                    ConvBN(ch // 2, channels[i + 1] // 2, 1, act=act), Upsample2x()))

    def forward(self, feats: Sequence[torch.Tensor | Carried]) -> list[torch.Tensor]:
        outs = []
        carry = None
        for i, (lvl, x) in enumerate(zip(LEVELS, feats)):
            if carry is not None:
                lateral = getattr(self, f"up_sampling_{LEVELS[i - 1]}")(float_of(carry))
                x = torch.cat([x, lateral], dim=1)
            carry = getattr(self, f"neck_{lvl}")(x)
            outs.append(getattr(self, f"neck_out_{lvl}")(carry))
        return outs

    def int8_edges(self) -> list[tuple[str, str, bool]]:
        return [(f"neck_{lvl}.4", f"neck_out_{lvl}", hasattr(self, f"up_sampling_{lvl}"))
                for lvl in self.levels]


class YOLOv3Head(nn.Module):
    """Per-level biased 1x1 conv -> [B, H, W, A, 5 + C]."""

    def __init__(self, channels: Sequence[int] = (1024, 512, 256),
                 num_classes: int = 80, anchors_per_level: int = 3):
        super().__init__()
        self.anchors_per_level = anchors_per_level
        self.no = 5 + num_classes
        for lvl, ch in zip(LEVELS, channels):
            setattr(self, f"head_out_{lvl}",
                    nn.Conv2d(ch, anchors_per_level * self.no, 1, bias=True))

    def forward(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for lvl, x in zip(LEVELS, feats):
            y = getattr(self, f"head_out_{lvl}")(x).permute(0, 2, 3, 1)
            b, h, w, _ = y.shape
            outs.append(y.reshape(b, h, w, self.anchors_per_level, self.no))
        return outs


class YOLOv3(nn.Module):
    """Darknet-53 detector. ``generator`` seeds the initial weights
    (`init_weights_`); ``stage_sizes`` cuts the backbone's depth."""

    def __init__(self, num_classes: int = 80, anchors_per_level: int = 3,
                 channels: Sequence[int] = (1024, 512, 256),
                 strides: Sequence[int] = (32, 16, 8), act: str = "silu",
                 stage_sizes: Sequence[int] = (1, 2, 8, 8, 4),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.backbone = Darknet53(act=act, stage_sizes=stage_sizes)
        self.neck = YOLOv3Neck(Darknet53.channels_per_level, channels, act=act)
        self.head = YOLOv3Head(channels, num_classes, anchors_per_level)
        init_weights_(self, generator)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: NHWC [B, H, W, 3] -> [P5, P4, P3] heads, each [B, H, W, A, 5 + C]."""
        feats = self.backbone(x.permute(0, 3, 1, 2))
        return self.head(self.neck(feats))

    def int8_edges(self) -> list[tuple[str, str, bool]]:
        """P5 to the neck's first conv, in int8 beside the float."""
        return [(f"backbone.{self.backbone.last_conv}", "neck.neck_small.0", True)]
