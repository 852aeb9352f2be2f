"""ResNet / ResNeXt (port of fastvision_tpu/models/classification/resnet.py).

Bottlenecks put the stride on the 3x3 conv (torchvision's v1.5), whose
width is ``int(features * base_width / 64) * groups``; ResNeXt is a
grouped bottleneck. Every conv pads ``k // 2`` on both sides, which at
stride 2 is torch's own padding and not XLA's right-biased SAME; the stem's
3x3 max pool pads 1 with -inf. A block gets a 1x1 projection shortcut
(``downsample``) where its stride or width changes.

Each conv + BN pair (the JAX package's ConvBNs: the stem, every block conv
and the projection) runs through `conv_bn_act` and is listed by
``conv_bn_names()``, so int8 quantization (`infer.quantize`) folds and
runs them as it does the detectors' ConvBNs.

The ``state_dict`` keys are torchvision's (``conv1``, ``bn1``,
``layer{i}.{j}.conv{k}`` / ``bn{k}`` / ``downsample.{0,1}``, ``fc``), so a
torchvision checkpoint loads as it is, and the JAX package's
``resnet_from_torchvision`` + ``apply_import`` load this model's weights
into its flax ResNet.

``including_top=True`` is a classifier: NHWC images [B, H, W, 3] ->
logits [B, num_classes], as the detectors take their input.
``including_top=False`` is a trunk: NCHW in, [C5, C4, C3] out (strides 32,
16, 8), the detection-backbone contract.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import BatchNorm, conv_bn_act, global_avg_pool, init_weights_, max_pool


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, groups=groups, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Module | None:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm(cout))


class _Block(nn.Module):
    """A residual block's conv + BN pairs (``conv{k}`` / ``bn{k}``, then the
    projection) and its shortcut."""

    n_convs = 0

    def conv_bn_names(self) -> list[tuple[str, str]]:
        names = [(f"conv{k}", f"bn{k}") for k in range(1, self.n_convs + 1)]
        return names + ([("downsample.0", "downsample.1")] if self.downsample is not None else [])

    def shortcut(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is None:
            return x
        return conv_bn_act(self.downsample[0], self.downsample[1], x, "none")


class BasicBlock(_Block):
    """3x3 -> 3x3 + shortcut."""

    expansion = 1
    n_convs = 2

    def __init__(self, cin: int, features: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, features, 3, stride), BatchNorm(features)
        self.conv2, self.bn2 = _conv(features, features, 3), BatchNorm(features)
        self.downsample = _downsample(cin, features, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn_act(self.conv1, self.bn1, x, "relu")
        y = conv_bn_act(self.conv2, self.bn2, y, "none")
        return F.relu(y + self.shortcut(x))


class Bottleneck(_Block):
    """1x1 -> grouped 3x3 (the stride) -> 1x1 expanded x4, + shortcut."""

    expansion = 4
    n_convs = 3

    def __init__(self, cin: int, features: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        width = int(features * (base_width / 64.0)) * groups
        out = features * self.expansion
        self.conv1, self.bn1 = _conv(cin, width, 1), BatchNorm(width)
        self.conv2, self.bn2 = _conv(width, width, 3, stride, groups), BatchNorm(width)
        self.conv3, self.bn3 = _conv(width, out, 1), BatchNorm(out)
        self.downsample = _downsample(cin, out, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn_act(self.conv1, self.bn1, x, "relu")
        y = conv_bn_act(self.conv2, self.bn2, y, "relu")
        y = conv_bn_act(self.conv3, self.bn3, y, "none")
        return F.relu(y + self.shortcut(x))


class ResNet(nn.Module):
    """ResNet / ResNeXt. ``generator`` seeds the initial weights: convs
    kaiming-normal fan_out (the JAX package's ConvBN init), ``fc``
    lecun-normal (flax ``Dense``'s default)."""

    def __init__(self, block_cls: type, stage_sizes: Sequence[int], num_classes: int = 1000,
                 including_top: bool = True, groups: int = 1, base_width: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.including_top = including_top
        self.conv1, self.bn1 = _conv(3, 64, 7, 2), BatchNorm(64)
        cin = 64
        for i, n_blocks in enumerate(stage_sizes):
            features = 64 * 2**i
            blocks = []
            for j in range(n_blocks):
                blocks.append(block_cls(cin, features, 2 if (i > 0 and j == 0) else 1,
                                        groups, base_width))
                cin = features * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.channels_per_level = [512 * block_cls.expansion, 256 * block_cls.expansion,
                                   128 * block_cls.expansion]
        self.strides_per_level = [32, 16, 8]
        if including_top:
            self.fc = nn.Linear(cin, num_classes)
        init_weights_(self, generator, he_convs=True)

    def conv_bn_names(self) -> list[tuple[str, str]]:
        return [("conv1", "bn1")]

    def forward(self, x: torch.Tensor):
        if self.including_top:
            x = x.permute(0, 3, 1, 2)
        x = max_pool(conv_bn_act(self.conv1, self.bn1, x, "relu"), 3, 2, padding=1)
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(x)
        if not self.including_top:
            return [feats[3], feats[2], feats[1]]  # C5, C4, C3
        return self.fc(global_avg_pool(x))


resnet18 = partial(ResNet, BasicBlock, (2, 2, 2, 2))
resnet34 = partial(ResNet, BasicBlock, (3, 4, 6, 3))
resnet50 = partial(ResNet, Bottleneck, (3, 4, 6, 3))
resnet101 = partial(ResNet, Bottleneck, (3, 4, 23, 3))
resnet152 = partial(ResNet, Bottleneck, (3, 8, 36, 3))
resnext50_32x4d = partial(ResNet, Bottleneck, (3, 4, 6, 3), groups=32, base_width=4)
resnext101_32x8d = partial(ResNet, Bottleneck, (3, 4, 23, 3), groups=32, base_width=8)
