"""Layers the plain reference models share, float32 with nothing of the
program imported.

``fp8`` computes a conv or linear layer one precision below the
configurations' bfloat16, on per-tensor scales, as fp8 training does:
float8 e4m3 inputs and weights forward, float8 e5m2 output gradients
backward. Run under bfloat16 autocast (`reference.train`), it is the
control: the configuration's step with its GEMMs in the lower precision.
``remat`` on a model recomputes each stage in the backward (`stage`), so a
float32 training step at the timed batch fits beside what is left on the
card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` at a per-tensor scale that maps
    its largest magnitude to the type's largest value."""
    xf = x.float()
    scale = xf.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return ((xf / scale).to(dtype).float() * scale).to(x.dtype)


class _Low(torch.autograd.Function):
    """Forward: e4m3 rounding; backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x):
        return _round(x.detach(), torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _LowGrad(torch.autograd.Function):
    """Forward: identity; backward: e5m2 rounding of the gradient."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class Conv(nn.Conv2d):
    """nn.Conv2d padding ``k // 2``; in fp8 when ``fp8``."""

    fp8 = False

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = False):
        super().__init__(cin, cout, k, stride, padding=k // 2, bias=bias)

    def forward(self, x):
        if self.fp8:
            return _LowGrad.apply(F.conv2d(_Low.apply(x), _Low.apply(self.weight), self.bias,
                                           self.stride, self.padding))
        return super().forward(x)


class Linear(nn.Linear):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return _LowGrad.apply(F.linear(_Low.apply(x), _Low.apply(self.weight), self.bias))
        return super().forward(x)


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, act: str = "silu"):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = act

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.silu(y) if self.act == "silu" else F.relu(y) if self.act == "relu" else y


def stage(module: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``module(x)``, recomputed in the backward when ``remat``."""
    return checkpoint(module, x, use_reentrant=False) if remat else module(x)


def set_fp8(model: nn.Module, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, (Conv, Linear)):
            m.fp8 = on
