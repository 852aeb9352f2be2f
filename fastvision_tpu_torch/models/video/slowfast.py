"""SlowFast networks (port of fastvision_tpu/models/video/slowfast.py).

Two pathways over one clip [B, T, H, W, 3]:
  - slow: every alpha-th frame (``x[:, :, ::alpha]`` in NCDHW), full width;
  - fast: every frame, 1 / beta_inv of the width;
  - four laterals, bare (5, 1, 1) convs of stride (alpha, 1, 1) and padding
    (2, 0, 0) (no BN, no activation, no bias), from the fast pathway after
    the stem pool and after each of the first three stages, concatenated
    into the slow pathway's channels: its stage-2 input is 64 + 2 * 64 /
    beta_inv channels, each later stage's its width plus the lateral's;
  - the head averages each pathway over T, H and W and concatenates
    ``[fast, slow]`` in that order before ``fc``.

`SFBottleneck` is the reference's own bottleneck: conv1 (3, 1, 1) when
``temporal_conv1`` else (1, 1, 1), conv2 (1, 3, 3) with the spatial stride,
conv3 (1, 1, 1) to ``features * expansion``, a strided 1x1x1 projection
where the stride or the width changes. ``temporal_conv1`` is set on block 0
only: of the slow pathway's stages 3 and 4 (res4, res5) and of every fast
stage. Time is never strided inside a pathway. Stems: slow (1, 7, 7), fast
(5, 7, 7), both stride (1, 2, 2), then the 3D-ResNet's stem pool.
``expansion`` sizes every block's output.

The ``state_dict`` keys are the reference's
(``{fast,slow}_pathway.conv1.{0,1}``, ``{fast,slow}_pathway.res{2..5}.{j}.
conv{1,2,3}.conv`` / ``bn{1,2,3}`` / ``downsample.0.conv`` /
``downsample.1``, ``fast_pathway.lateral_{pool1,res2,res3,res4}.conv``,
``fc``), so the JAX package's ``slowfast_from_reference`` + ``apply_import``
load this model's weights. The JAX package's ``time_axis`` (the fast
pathway sharded over a mesh's time axis) is not ported (ROADMAP Queue 1,
item 17: time sharding).
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import BatchNorm3d, init_weights_
from .resnet3d import Conv, conv3d, stem_pool


class SFBottleneck(nn.Module):
    def __init__(self, cin: int, features: int, spatial_stride: int = 1,
                 temporal_conv1: bool = False, expansion: int = 4):
        super().__init__()
        out, s = features * expansion, spatial_stride
        self.conv1 = Conv(cin, features, (3 if temporal_conv1 else 1, 1, 1))
        self.bn1 = BatchNorm3d(features)
        self.conv2, self.bn2 = Conv(features, features, (1, 3, 3), (1, s, s)), BatchNorm3d(features)
        self.conv3, self.bn3 = Conv(features, out, (1, 1, 1)), BatchNorm3d(out)
        self.downsample = None
        if s != 1 or cin != out:
            self.downsample = nn.Sequential(Conv(cin, out, (1, 1, 1), (1, s, s)), BatchNorm3d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Pathway(nn.Module):
    """One pathway: ``conv1`` (stem conv + BN) and stages ``res2..res5``;
    the fast one also holds the laterals into the slow one."""

    def __init__(self, stem_t: int, base: int, stage_in: Sequence[int], stage_sizes: Sequence[int],
                 widths: Sequence[int], temporal_from: int, expansion: int):
        super().__init__()
        self.conv1 = nn.Sequential(conv3d(3, base, (stem_t, 7, 7), (1, 2, 2)), BatchNorm3d(base))
        for i, n_blocks in enumerate(stage_sizes):
            cin, blocks = stage_in[i], []
            for j in range(n_blocks):
                blocks.append(SFBottleneck(cin, widths[i], 2 if (i > 0 and j == 0) else 1,
                                           temporal_conv1=j == 0 and i >= temporal_from,
                                           expansion=expansion))
                cin = widths[i] * expansion
            setattr(self, f"res{i + 2}", nn.Sequential(*blocks))


class SlowFast(nn.Module):
    """``generator`` seeds the initial weights: convs and ``fc``
    lecun-normal (flax's default for ``Conv`` and ``Dense``)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 400, alpha: int = 8,
                 beta_inv: int = 8, expansion: int = 4,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.alpha, self.num_stages = alpha, len(stage_sizes)
        fast_base = max(64 // beta_inv, 1)
        slow_w = [64 * 2**i for i in range(self.num_stages)]
        fast_w = [max(w // beta_inv, 1) for w in slow_w]
        # each lateral carries twice the fast pathway's channels at its point
        lateral = [2 * fast_base] + [2 * w * expansion for w in fast_w[:-1]]
        slow_in = [64 + lateral[0]] + [w * expansion + lat
                                       for w, lat in zip(slow_w[:-1], lateral[1:])]
        fast_in = [fast_base] + [w * expansion for w in fast_w[:-1]]
        self.slow_pathway = Pathway(1, 64, slow_in, stage_sizes, slow_w, 2, expansion)
        self.fast_pathway = Pathway(5, fast_base, fast_in, stage_sizes, fast_w, 0, expansion)
        fast_ch = [fast_base] + [w * expansion for w in fast_w[:-1]]
        for k, (name, c, lat) in enumerate(zip(("pool1", "res2", "res3", "res4"), fast_ch,
                                               lateral)):
            if k < self.num_stages:
                setattr(self.fast_pathway, f"lateral_{name}",
                        Conv(c, lat, (5, 1, 1), (alpha, 1, 1)))  # padding (2, 0, 0)
        self.fc = nn.Linear(fast_w[-1] * expansion + slow_w[-1] * expansion, num_classes)
        init_weights_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        sp, fp = self.slow_pathway, self.fast_pathway
        slow = stem_pool(F.relu(sp.conv1(x[:, :, :: self.alpha])))
        fast = stem_pool(F.relu(fp.conv1(x)))
        slow = torch.cat([slow, fp.lateral_pool1(fast)], dim=1)
        for i in range(self.num_stages):
            slow = getattr(sp, f"res{i + 2}")(slow)
            fast = getattr(fp, f"res{i + 2}")(fast)
            if i < self.num_stages - 1:
                slow = torch.cat([slow, getattr(fp, f"lateral_res{i + 2}")(fast)], dim=1)
        return self.fc(torch.cat([fast.mean(dim=(2, 3, 4)), slow.mean(dim=(2, 3, 4))], dim=1))


# the reference builds every variant from its own bottleneck (its resnet34
# reuses [3, 4, 6, 3])
slowfast_resnet18 = partial(SlowFast, (2, 2, 2, 2))
slowfast_resnet34 = partial(SlowFast, (3, 4, 6, 3))
slowfast_resnet50 = partial(SlowFast, (3, 4, 6, 3))
slowfast_resnet101 = partial(SlowFast, (3, 4, 23, 3))
slowfast_resnet152 = partial(SlowFast, (3, 8, 36, 3))
