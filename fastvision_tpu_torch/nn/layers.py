"""NN building blocks: conv + BN + activation (port of fastvision_tpu/nn/layers.py).

The modules work on NCHW tensors, as torch modules do; the detector keeps
them in ``channels_last`` memory, which is NHWC in memory and the layout
cuDNN prefers on Hopper. Conventions carried over from the JAX package:

  - symmetric ``k // 2`` padding (at stride 2 this is torch's own pad=1 and
    not XLA's right-biased SAME, so imported weights stay exact);
  - a conv bias only when there is no BN;
  - BN eps 1e-5 and torch momentum 0.1, which is flax momentum 0.9;
  - kaiming-normal fan_out conv init, BN scale 1 and shift 0.

The int8 quantized forward and its calibration hooks are not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "none": lambda x: x,
}


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with the JAX package's defaults (eps 1e-5; momentum 0.1
    in torch's new-fraction convention == flax's 0.9). Statistics stay
    float32 under autocast."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)


class ConvBN(nn.Module):
    """Conv2d + BatchNorm + activation, the detector's basic block.

    State-dict names: ``conv.weight`` (+ ``conv.bias`` without BN) and
    ``bn.{weight,bias,running_mean,running_var}``, the reference demo's
    torch naming."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 strides: int = 1, groups: int = 1, use_bn: bool = True,
                 use_bias: bool | None = None, act: str = "silu"):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"unknown activation {act!r}; one of {sorted(ACTIVATIONS)}")
        bias = use_bias if use_bias is not None else not use_bn
        self.conv = nn.Conv2d(in_features, features, kernel_size, strides,
                              padding=kernel_size // 2, groups=groups, bias=bias)
        self.bn = BatchNorm(features) if use_bn else nn.Identity()
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ACTIVATIONS[self.act](self.bn(self.conv(x)))


def init_weights_(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Re-initialise every conv and BN below ``module`` from ``generator``:
    ConvBN convs kaiming-normal fan_out (the JAX package's
    ``variance_scaling(2, fan_out, normal)``), other convs lecun-normal
    (flax's default: truncated normal, variance 1 / fan_in), biases 0, BN
    scale 1, shift 0, running statistics reset."""
    convbn_convs = {id(m.conv) for m in module.modules() if isinstance(m, ConvBN)}
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                if id(m) in convbn_convs:
                    nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                            nonlinearity="relu", generator=generator)
                else:
                    fan_in = m.weight[0].numel()
                    # flax truncates at 2 std and rescales to keep the variance
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module
