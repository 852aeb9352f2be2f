"""Plain float32 ResNet-50 v1.5 and softmax cross-entropy, with nothing of
the program imported.

He et al., arXiv:1512.03385, with the stride on the bottleneck's 3x3 conv
(v1.5, as torchvision and NVIDIA's recipe). It takes NHWC images in
[0, 255] as uint8 and standardizes them with ImageNet's mean and std. The
parameter names are the program's state-dict names, so one set of weights
made from the seed loads into both.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, Linear, stage

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        out = 4 * features
        self.conv1, self.bn1 = Conv(cin, features, 1), nn.BatchNorm2d(features)
        self.conv2, self.bn2 = Conv(features, features, 3, stride), nn.BatchNorm2d(features)
        self.conv3, self.bn3 = Conv(features, out, 1), nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(Conv(cin, out, 1, stride), nn.BatchNorm2d(out))
                           if stride != 1 or cin != out else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet50(nn.Module):
    """ResNet-50 v1.5 classifier on ImageNet-standardized NHWC uint8 images."""

    def __init__(self, num_classes: int = 1000, stage_sizes=(3, 4, 6, 3)):
        super().__init__()
        self.conv1, self.bn1 = Conv(3, 64, 7, 2), nn.BatchNorm2d(64)
        cin = 64
        for i, n in enumerate(stage_sizes):
            f = 64 * 2**i
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(cin, f, 2 if i > 0 and j == 0 else 1))
                cin = 4 * f
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = Linear(cin, num_classes)
        self.remat = False

    def forward(self, images: torch.Tensor):
        x = images.float() / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for i in range(1, 5):
            x = stage(getattr(self, f"layer{i}"), x, self.remat)
        return self.fc(x.mean(dim=(2, 3)))


def build(cfg: dict) -> nn.Module:
    """The configuration's model, float32, on the current default device."""
    return ResNet50(cfg["num_classes"], tuple(cfg["stage_sizes"]))


def loss(logits: torch.Tensor, labels: np.ndarray, cfg: dict) -> torch.Tensor:
    """Softmax cross-entropy; labels: [B] classes (`harness.traffic`'s
    'classes')."""
    target = torch.from_numpy(labels).to(logits.device)
    return -torch.log_softmax(logits, dim=-1).gather(1, target[:, None]).mean()
