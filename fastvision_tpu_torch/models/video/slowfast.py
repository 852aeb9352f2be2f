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
load this model's weights.

Time-axis sharding (``time_axis='time'``, the JAX package's switch): over a
mesh with a ``time`` axis of n ranks (`core.mesh.create_mesh`), each rank
takes its T/n consecutive frames of the clip (every rank of the axis is
given the whole clip) and runs both pathways on them: the slow one on its
every alpha-th frame, which are the slow pathway's frames of that part
since T/n is a multiple of alpha. Every temporal conv (the fast stem's
kernel 5, the kernel-3 ``conv1`` of the blocks that have one in either
pathway, the laterals' kernel 5 of stride alpha) drops its time padding and
reads ``k // 2`` frames from each neighbour first
(`parallel.time_shard.halo_exchange_time`: zeros past the clip's ends,
which is the padding): a lateral's output frame j reads fast frames
``alpha * j - 2 ... alpha * j + 2``, inside this rank's frames and their
halo of 2. The head's means over T become sums over the rank's frames,
summed over the axis (`time_sum`) and divided by the whole clip's T, so
every rank of the axis gets the whole clip's logits. The JAX package
shards only the fast pathway (GSPMD pads and exchanges for it) and leaves
the slow one to GSPMD unconstrained; the port shards both, so that every
BN normalizes over the data and time ranks alike (`nn.layers`) and every
parameter before the pooled sum gets a partial gradient per time rank
(summed by data parallelism over the data and time axes). T must be a
multiple of ``mesh_time * alpha``; a clip that is not raises (the JAX
package pads it). The weights, and the ``state_dict``, are the
unsharded model's.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.distributed import axis
from ...nn.layers import BatchNorm3d, init_weights_
from ...parallel.time_shard import halo_exchange_time, time_sum
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


class _TimeHalo:
    """A temporal conv's forward pre-hook under time sharding: its input
    extended by ``halo`` frames from each neighbour (dim 2 of NCDHW)."""

    def __init__(self, axis_name: str, halo: int):
        self.axis_name, self.halo = axis_name, halo

    def __call__(self, module, args):
        return (halo_exchange_time(args[0], self.axis_name, self.halo, dim=2), *args[1:])


class SlowFast(nn.Module):
    """``generator`` seeds the initial weights: convs and ``fc``
    lecun-normal (flax's default for ``Conv`` and ``Dense``). ``time_axis``:
    the mesh axis the clip's time is sharded over (module docstring)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 400, alpha: int = 8,
                 beta_inv: int = 8, expansion: int = 4,
                 generator: torch.Generator | None = None, time_axis: str | None = None):
        super().__init__()
        self.alpha, self.num_stages, self.time_axis = alpha, len(stage_sizes), time_axis
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
        if time_axis is not None:
            for m in self.modules():
                if isinstance(m, nn.Conv3d) and m.kernel_size[0] > 1:
                    m.padding = (0, *m.padding[1:])
                    m.register_forward_pre_hook(_TimeHalo(time_axis, m.kernel_size[0] // 2))

    def _time_shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's frames of an NCDHW clip (dim 2) under time sharding."""
        ax, t = axis(self.time_axis), x.shape[2]
        if t % (ax.size * self.alpha):
            raise ValueError(
                f"time sharding: a clip of {t} frames does not split into {ax.size} parts of a "
                f"multiple of alpha={self.alpha} frames (T must be a multiple of "
                f"mesh_time * alpha = {ax.size * self.alpha})")
        n = t // ax.size
        return x[:, :, ax.index * n:(ax.index + 1) * n]

    def _pool(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        """The mean over T, H and W of the whole clip's ``frames`` frames."""
        if self.time_axis is None:
            return x.mean(dim=(2, 3, 4))
        return time_sum(x.mean(dim=(3, 4)).sum(dim=2) / frames, self.time_axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        t = x.shape[2]
        if self.time_axis is not None:
            x = self._time_shard(x)
        sp, fp = self.slow_pathway, self.fast_pathway
        slow = stem_pool(F.relu(sp.conv1(x[:, :, :: self.alpha])))
        fast = stem_pool(F.relu(fp.conv1(x)))
        slow = torch.cat([slow, fp.lateral_pool1(fast)], dim=1)
        for i in range(self.num_stages):
            slow = getattr(sp, f"res{i + 2}")(slow)
            fast = getattr(fp, f"res{i + 2}")(fast)
            if i < self.num_stages - 1:
                slow = torch.cat([slow, getattr(fp, f"lateral_res{i + 2}")(fast)], dim=1)
        slow_t = -(-t // self.alpha)  # the whole clip's slow frames
        return self.fc(torch.cat([self._pool(fast, t), self._pool(slow, slow_t)], dim=1))


# the reference builds every variant from its own bottleneck (its resnet34
# reuses [3, 4, 6, 3])
slowfast_resnet18 = partial(SlowFast, (2, 2, 2, 2))
slowfast_resnet34 = partial(SlowFast, (3, 4, 6, 3))
slowfast_resnet50 = partial(SlowFast, (3, 4, 6, 3))
slowfast_resnet101 = partial(SlowFast, (3, 4, 23, 3))
slowfast_resnet152 = partial(SlowFast, (3, 8, 36, 3))
