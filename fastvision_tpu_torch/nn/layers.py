"""NN building blocks: conv + BN + activation (port of fastvision_tpu/nn/layers.py).

The modules work on NCHW tensors (NCDHW for the video zoo's), as torch
modules do; the entry points keep them in ``channels_last`` memory
(``channels_last_3d`` for a model with 3-D convs, `memory_format_for`),
which is NHWC (NDHWC) in memory and the layout cuDNN prefers on Hopper.
Conventions carried over from the JAX package:

  - symmetric ``k // 2`` padding (at stride 2 this is torch's own pad=1 and
    not XLA's right-biased SAME, so imported weights stay exact);
  - a conv bias only when there is no BN;
  - BN eps 1e-5 and torch momentum 0.1, which is flax momentum 0.9;
  - kaiming-normal fan_out conv init, BN scale 1 and shift 0.

`max_pool` is flax's ``max_pool`` (VALID windows, or explicit -inf
padding); `init_weights_` also gives ``nn.Linear`` flax ``Dense``'s init,
and `Dense` is the JAX package's he-normal ``Dense``. `global_avg_pool` and
`adaptive_avg_pool` are the JAX package's pools on NCHW tensors. The int8
quantized forward and its calibration hooks are not ported yet.
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


def memory_format_for(model: nn.Module) -> torch.memory_format:
    """The memory format an entry point moves ``model`` into: ``channels_last_3d``
    when it has a 5-D (Conv3d) weight, ``channels_last`` otherwise (torch
    refuses ``channels_last`` on a 5-D tensor)."""
    if any(p.dim() == 5 for p in model.parameters()):
        return torch.channels_last_3d
    return torch.channels_last


class _FlaxRunningStats:
    """The forward of `BatchNorm` and `BatchNorm3d`: JAX package defaults
    (eps 1e-5; momentum 0.1 in torch's new-fraction convention == flax's
    0.9) and flax's running statistics. Statistics stay float32 under
    autocast.

    In train mode the batch is normalized with its own (biased) statistics,
    as torch and flax both do, and the running statistics move by
    ``new = (1 - momentum) * old + momentum * batch`` with the BIASED batch
    variance, as flax does; torch alone folds in the unbiased one
    (n / (n - 1) larger, n = B * H * W, or B * T * H * W)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        if m is None:  # torch's cumulative average over the batches seen
            self.num_batches_tracked.add_(1)
            m = 1.0 / int(self.num_batches_tracked)
        # torch moves a copy by (1 - m) * old + m * unbiased (autograd may
        # keep the tensor it was given, so that one is not written again)
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True, m, self.eps)
        with torch.no_grad():
            # (1 - m) * old + m * biased == var * (n - 1) / n + old * (1 - m) / n
            self.running_var.mul_((1.0 - m) / n).add_(var, alpha=(n - 1) / n)
        return y


class BatchNorm(_FlaxRunningStats, nn.BatchNorm2d):
    """BatchNorm2d with the JAX package's defaults and running statistics
    (`_FlaxRunningStats`)."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)


class BatchNorm3d(_FlaxRunningStats, nn.BatchNorm3d):
    """BatchNorm3d over NCDHW clips, as `BatchNorm` (the video zoo's)."""

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


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2, padding: int = 0) -> torch.Tensor:
    """NCHW max pool (flax ``max_pool``): VALID windows, where a trailing row
    or column that fills no window is dropped; ``padding`` pads each side
    with -inf first, as flax's explicit ``((p, p), (p, p))`` does."""
    return F.max_pool2d(x, window, stride, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NC."""
    return x.mean(dim=(2, 3))


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """NCHW average pool to ``out_hw``, as the JAX package computes it: the
    mean of equal blocks when H and W divide, else a VALID window pool of
    window ceil(H / oh) and stride max(H // oh, 1) cut to ``out_hw``. The
    second is not torch's ``adaptive_avg_pool2d``, whose windows vary."""
    n, c, h, w = x.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    window = (-(-h // oh), -(-w // ow))
    stride = (max(h // oh, 1), max(w // ow, 1))
    return F.avg_pool2d(x, window, stride)[:, :, :oh, :ow]


class Dense(nn.Linear):
    """The JAX package's ``Dense``: a biased Linear whose weight is
    he-normal (variance 2 / fan_in, not truncated), its bias 0."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__(in_features, features)
        with torch.no_grad():
            nn.init.kaiming_normal_(self.weight, mode="fan_in", nonlinearity="relu",
                                    generator=generator)
            nn.init.zeros_(self.bias)


def _trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator | None) -> None:
    """Normal(0, std) truncated to [-2 std, 2 std] in place: values outside
    are drawn again, only those (``nn.init.trunc_normal_`` redraws the whole
    tensor each round, seconds for a 100M-element Linear on the CPU)."""
    flat = w.view(-1).normal_(0.0, std, generator=generator)
    idx = (flat.abs() > 2 * std).nonzero().squeeze(1)
    while idx.numel():
        vals = torch.empty(idx.numel(), dtype=w.dtype, device=w.device).normal_(
            0.0, std, generator=generator)
        ok = vals.abs() <= 2 * std
        flat[idx[ok]] = vals[ok]
        idx = idx[~ok]


def init_weights_(module: nn.Module, generator: torch.Generator | None = None,
                  he_convs: bool = False) -> nn.Module:
    """Re-initialise every conv, linear and BN below ``module`` from
    ``generator``: ConvBN convs (every conv with ``he_convs``, for modules
    whose convs are the JAX package's ConvBN convs under other names)
    kaiming-normal fan_out (the JAX package's ``variance_scaling(2,
    fan_out, normal)``), `Dense` he-normal fan_in, other convs and linears
    lecun-normal (flax's default for ``Conv`` and ``Dense``: truncated
    normal, variance 1 / fan_in), biases 0, BN scale 1, shift 0, running
    statistics reset. 3-D convs and BN are treated as 2-D ones."""
    convs = (nn.Conv2d, nn.Conv3d)
    convbn_convs = {id(m.conv) for m in module.modules() if isinstance(m, ConvBN)}
    if he_convs:
        convbn_convs |= {id(m) for m in module.modules() if isinstance(m, convs)}
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (*convs, nn.Linear)):
                if isinstance(m, Dense):
                    nn.init.kaiming_normal_(m.weight, mode="fan_in", nonlinearity="relu",
                                            generator=generator)
                elif id(m) in convbn_convs:
                    nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                            nonlinearity="relu", generator=generator)
                else:
                    fan_in = m.weight[0].numel()
                    # flax truncates at 2 std and rescales to keep the variance
                    _trunc_normal_(m.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                                   generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.reset_parameters()
    return module
