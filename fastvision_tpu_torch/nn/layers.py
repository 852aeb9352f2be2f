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
`adaptive_avg_pool` are the JAX package's pools on NCHW tensors.

int8 inference (w8a8 post-training quantization, `infer.quantize`): every
conv + BN pair of `conv_bn_pairs` (each `ConvBN`, and the torchvision-named
pairs of the ResNet) may carry an `Int8Conv` as its conv's ``quant``
submodule: the BN-folded int8 kernel, its per-channel scales, the
calibrated input scale and the folded bias, as non-persistent buffers (they
move with the model and stay out of its ``state_dict``). `conv_bn_act` runs
the pair: in eval mode through the `Int8Conv` where there is one, else (and
always in train mode) through the float conv and BN. A model may declare
which conv hands its output to which (``int8_edges``, read by
`infer.quantize.link_int8`): a linked `Int8Conv` writes its consumer's
int8 input itself and hands it on as a `Carried`; a residual passed to
`conv_bn_act` is added after the activation, in the conv's epilogue where
the card's kernel takes it.
"""
from __future__ import annotations

import math
from typing import Iterator, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..core.distributed import batch_axis
from ..ops.int8 import (ACTIVATIONS, add_residual, gemm_weight, implicit_gemm_eligible,
                        quantized_conv)


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
    (n / (n - 1) larger, n = B * H * W, or B * T * H * W).

    Inside `core.distributed.data_parallel` with more than one rank on the
    batch axis (data x time), a train-mode forward normalizes over the
    global batch and clip (`GlobalBatchNorm`) and every rank moves its
    running statistics by the same global ones."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if batch_axis().size > 1:
            return self._global_forward(x)
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


    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.momentum
        if m is None:
            self.num_batches_tracked.add_(1)
            m = 1.0 / int(self.num_batches_tracked)
        y, mean, var = GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y


def _bn_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a layout the card's BN kernels take: channels_last (3-D)
    as it is, anything else made contiguous (SyncBatchNorm's rule)."""
    if (t.is_contiguous(memory_format=torch.channels_last)
            or t.is_contiguous(memory_format=torch.channels_last_3d)):
        return t
    return t.contiguous()


def _bn_stats(x: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of this rank's ``x``, float32
    (float64 for a float64 ``x``): one fused pass on the card
    (``batch_norm_stats``), torch's ``var_mean`` on the CPU."""
    if x.is_cuda:
        mean, invstd = torch.batch_norm_stats(x, eps)
        return mean, (invstd.pow(-2) - eps).clamp(min=0.0)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    var, mean = torch.var_mean(x.to(acc), [0, *range(2, x.dim())], correction=0)
    return mean, var


def _bn_elemt(x, weight, bias, mean, invstd, eps):
    """``(x - mean) * invstd * weight + bias`` in ``x``'s dtype."""
    if x.is_cuda:
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
    if weight is not None:
        y = y * weight.to(mean.dtype).view(shape)
    if bias is not None:
        y = y + bias.to(mean.dtype).view(shape)
    return y.to(x.dtype)


def _bn_backward_reduce(dy, x, mean, invstd, weight, needs):
    """-> (``sum(dy)``, ``sum(dy * (x - mean))``, weight grad, bias grad)
    of this rank's share, per channel (the grads None where ``needs`` says
    no)."""
    if x.is_cuda:
        return torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight, *needs)
    dims = [0, *range(2, x.dim())]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    g = dy.to(mean.dtype)
    sum_dy = g.sum(dims)
    sum_dy_xmu = (g * (x.to(mean.dtype) - mean.view(shape))).sum(dims)
    gw = (sum_dy_xmu * invstd).to(weight.dtype) if needs[1] else None
    gb = sum_dy.to(weight.dtype) if needs[2] else None
    return sum_dy, sum_dy_xmu, gw, gb


def _bn_backward_elemt(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count):
    """The input gradient from the global ``sum_dy`` and ``sum_dy_xmu`` over
    ``count`` elements per channel (an int32 tensor [1])."""
    if x.is_cuda:
        return torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sum_dy,
                                               sum_dy_xmu, count)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    n = float(count.sum())
    w = weight.to(mean.dtype) if weight is not None else torch.ones_like(mean)
    dx = (dy.to(mean.dtype) - (sum_dy / n).view(shape)
          - (x.to(mean.dtype) - mean.view(shape)) * (invstd * invstd * sum_dy_xmu / n).view(shape))
    return (dx * (w * invstd).view(shape)).to(x.dtype)


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BN over a batch split across the ranks of
    `core.distributed.data_parallel` (its batch axis: the data ranks, and
    the time ranks of a time-sharded clip, `core.distributed.batch_axis`):
    the per-channel count, sum and sum of squares are all-reduced in one
    call and the batch is normalized with the global mean and flax's
    one-pass biased variance ``E[x^2] - E[x]^2``
    (clamped at 0); the backward all-reduces ``sum(dy)`` and
    ``sum(dy * (x - mean))`` the same way. The passes over the tensor are
    the card's native BN kernels that ``SyncBatchNorm`` runs (one fused
    statistics pass, one normalize pass; one reduce and one elementwise
    pass back), or their plain equivalents on the CPU. Statistics in
    float32 (float64 for a float64 input); the output in the input's dtype.
    The weight and bias gradients are this rank's share: data parallelism
    averages them over the ranks, as it does the upstream gradients ``dy``,
    so every gradient is the global batch's. -> (y, mean, biased var), the
    last two without gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x = _bn_layout(x)
        mean_r, var_r = _bn_stats(x, eps)
        # filled on the device: a copy from the host would wait for the card
        n = torch.full((1,), x.numel() // x.shape[1], dtype=mean_r.dtype, device=x.device)
        stats = torch.cat([n, mean_r * n, (var_r + mean_r * mean_r) * n])
        group = batch_axis().group
        dist.all_reduce(stats, group=group)
        c = x.shape[1]
        count = stats[0]
        mean = stats[1:1 + c] / count
        var = (stats[1 + c:] / count - mean * mean).clamp(min=0.0)
        invstd = torch.rsqrt(var + eps)
        y = _bn_elemt(x, weight, bias, mean, invstd, eps)
        ctx.save_for_backward(x, weight, mean, invstd,
                              count.round().to(torch.int32).view(1))
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, count = ctx.saved_tensors
        dy = _bn_layout(dy)
        needs = (ctx.needs_input_grad[0], weight is not None and ctx.needs_input_grad[1],
                 weight is not None and ctx.needs_input_grad[2])
        sum_dy, sum_dy_xmu, dw, db = _bn_backward_reduce(dy, x, mean, invstd, weight, needs)
        dx = None
        if needs[0]:
            sums = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(sums, group=ctx.group)
            c = x.shape[1]
            w = weight.to(mean.dtype) if weight is not None else None
            dx = _bn_backward_elemt(dy, x, mean, invstd, w, sums[:c], sums[c:], count)
        return dx, dw, db, None


class BatchNorm(_FlaxRunningStats, nn.BatchNorm2d):
    """BatchNorm2d with the JAX package's defaults and running statistics
    (`_FlaxRunningStats`)."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)


class BatchNorm3d(_FlaxRunningStats, nn.BatchNorm3d):
    """BatchNorm3d over NCDHW clips, as `BatchNorm` (the video zoo's)."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)


class Carried(NamedTuple):
    """An activation as a linked `Int8Conv` hands it on: ``value`` the float
    tensor [B, C, H, W] (channels_last), None where only int8 convs read it;
    ``q`` its int8 copy (same shape and memory) at the input scale of
    ``to``, the `Int8Conv` it was written for; ``dtype`` the float type the
    producer computed in. Only ``to`` reads ``q``; every other reader takes
    ``value`` (`float_of`)."""
    value: torch.Tensor | None
    q: torch.Tensor
    to: nn.Module
    dtype: torch.dtype


def float_of(x: torch.Tensor | Carried) -> torch.Tensor:
    """A module's input as a float tensor: ``x``, or a `Carried`'s ``value``."""
    if not isinstance(x, Carried):
        return x
    if x.value is None:
        raise RuntimeError("a float reader got an activation handed on in int8 only: its "
                           "producer's link (infer.quantize.link_int8) drops the float output")
    return x.value


class Int8Conv(nn.Module):
    """The quantized state of one conv + BN pair and its eval forward (the
    JAX package's ``quant`` collection of a ConvBN and its
    ``_quantized_forward``): ``w_q`` the BN-folded OIHW int8 kernel,
    ``w_scale`` [N] its per-output-channel scales, ``in_scale`` the input's
    scale, ``bias`` [N] the folded bias (float32 each), and derived from them
    ``scale = in_scale * w_scale`` and the card route's weight matrix
    ``w_mat`` (`ops.int8.gemm_weight`). All are non-persistent buffers.

    ``link`` (set by `infer.quantize.link_int8`, None otherwise): ``(the
    consuming Int8Conv, keep_float)``. A linked conv writes its consumer's
    int8 input from its own epilogue, at the consumer's ``in_scale``, and
    returns a `Carried` (its float output too where ``keep_float``), so the
    consumer runs no quantize pass. The link is structural and fixed at
    install time; nothing carries over from one call to the next."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, in_scale: torch.Tensor,
                 bias: torch.Tensor, stride: int, padding: int, groups: int):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        w_scale = w_scale.float()
        in_scale = torch.as_tensor(in_scale, dtype=torch.float32, device=w_scale.device)
        for name, t in (("w_q", w_q.to(torch.int8)), ("w_scale", w_scale),
                        ("in_scale", in_scale.reshape(())), ("bias", bias.float()),
                        ("scale", in_scale * w_scale), ("w_mat", gemm_weight(w_q, groups))):
            self.register_buffer(name, t.contiguous(), persistent=False)
        self.link: tuple[Int8Conv, bool] | None = None

    @property
    def on_implicit_gemm(self) -> bool:
        """Whether the card runs this conv on ``int8_conv`` (the dispatch by
        shape, `ops.int8.implicit_gemm_eligible`)."""
        n, cg, k, _ = self.w_q.shape
        return implicit_gemm_eligible(cg * self.groups, n, k, self.stride, self.padding,
                                      self.groups)

    def forward(self, x: torch.Tensor | Carried, act: str,
                residual: torch.Tensor | Carried | None = None) -> torch.Tensor | Carried:
        """x [B, C, H, W] float, or a `Carried` (its int8 copy read where it
        was written for this conv) -> ``act`` of the dequantized int8 conv,
        plus ``residual`` where one is given (Darknet's skip, added after the
        activation), in the dtype the float conv would return (autocast's,
        where it is on); a `Carried` where the conv is linked."""
        xq = x.q if isinstance(x, Carried) and x.to is self else None
        inp = float_of(x) if xq is None else xq
        dev = inp.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
        to, keep = self.link if self.link is not None and not self.link[0].training \
            else (None, True)
        with torch.autocast(dev, enabled=False):
            y, q = quantized_conv(inp, self.in_scale, self.w_q, self.w_mat, self.scale,
                                  self.bias, self.stride, self.padding, self.groups, act, dtype,
                                  None if residual is None else float_of(residual),
                                  None if to is None else to.in_scale, keep)
        return y if q is None else Carried(y, q, to, dtype)


def conv_bn_act(conv: nn.Conv2d, bn: nn.Module, x: torch.Tensor | Carried, act: str,
                residual: torch.Tensor | Carried | None = None) -> torch.Tensor | Carried:
    """``act(bn(conv(x)))``, plus ``residual`` where one is given (added
    after the activation); in eval mode the conv's `Int8Conv`
    (``conv.quant``) instead, where it has one, which may hand its output on
    as a `Carried`."""
    quant = conv._modules.get("quant")
    if quant is not None and not conv.training:
        return quant(x, act, residual)
    y = ACTIVATIONS[act](bn(conv(float_of(x))))
    return y if residual is None else add_residual(float_of(residual), y)


def conv_bn_pairs(model: nn.Module) -> Iterator[tuple[str, nn.Conv2d, nn.Module | None]]:
    """The conv + BN pairs that int8 quantization folds, in module order:
    (the conv's module name, the conv, its BN or None for a BN-free
    `ConvBN`). Each `ConvBN`, and each (conv, BN) name pair that a module
    lists in its ``conv_bn_names()`` (the ResNet's torchvision-named ones)."""
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, ConvBN):
            yield prefix + "conv", m.conv, m.bn if isinstance(m.bn, nn.BatchNorm2d) else None
        elif hasattr(m, "conv_bn_names"):
            for c, b in m.conv_bn_names():
                yield prefix + c, m.get_submodule(c), m.get_submodule(b)


def record_input_range(store: dict, x: torch.Tensor) -> None:
    """Calibration: fold the input's absmax and the 99.9th percentile of
    |x| into ``store`` (running maxima, from 0), as the JAX package's ConvBN
    sows them: |x| flattened in NHWC order, subsampled with the step
    ``max(1, size // 65536)``, linear-interpolated quantile."""
    ax = x.detach().float().abs()
    f = ax.permute(0, 2, 3, 1).reshape(-1)
    f = f[::max(1, f.numel() // 65536)]
    for key, v in (("amax", ax.max()), ("q999", torch.quantile(f, 0.999))):
        store[key] = torch.maximum(store.get(key, torch.zeros_like(v)), v)


class ConvBN(nn.Module):
    """Conv2d + BatchNorm + activation, the detector's basic block.

    State-dict names: ``conv.weight`` (+ ``conv.bias`` without BN) and
    ``bn.{weight,bias,running_mean,running_var}``, the reference demo's
    torch naming. Quantized, its eval forward is the conv's `Int8Conv`."""

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

    def forward(self, x: torch.Tensor | Carried,
                residual: torch.Tensor | Carried | None = None) -> torch.Tensor | Carried:
        return conv_bn_act(self.conv, self.bn, x, self.act, residual)


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
    if w.is_meta:  # no values to redraw
        return
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
