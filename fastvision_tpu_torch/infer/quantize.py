"""Post-training int8 quantization (w8a8) of conv + BN models (port of
fastvision_tpu/infer/quantize.py).

Every conv + BN pair of `nn.layers.conv_bn_pairs` (each 2-D `ConvBN`, and
the ResNet's torchvision-named pairs) whose conv gets an `nn.layers.Int8Conv`
runs its eval forward as an int8 x int8 -> int32 conv (`ops.int8`) and
dequantizes into the activation; everything else (YOLOv3's pred convs, the
Faster R-CNN RPN and heads, residual adds, upsample and concat, decode,
NMS) stays float. The float parameters stay in place: ``train()`` mode runs
them, and the quantized model's ``state_dict`` has the float model's keys.

The scheme (the JAX package's, number for number):

  - BN folded into the conv: ``inv = gamma / sqrt(var + eps)``,
    ``W' = W * inv``, ``b' = beta - mean * inv`` (+ ``conv_bias * inv``);
    a BN-free `ConvBN` keeps its conv bias (or zeros) as ``b'``;
  - weights: per-output-channel symmetric int8,
    ``w_scale = max(amax_c / 127, 1e-12)``, ``w_q = clip(round(W' / w_scale), +-127)``;
    computed in float32 numpy on the host, one operation at a time, rounding
    half to even, as the JAX package computes them;
  - activations: one scale per tensor, ``in_scale = amax / 127`` (divided in
    float64, then cast to float32), ``amax`` the input's absmax over the
    calibration batches, or with ``percentile=True`` its 99.9th percentile
    of |x| (``q999``).

Where a model declares which conv feeds which (``int8_edges``: Darknet-53's
blocks and stages, YOLOv3's neck), `link_int8` links the pairs that both
run on the card's implicit-GEMM kernel: the producer's epilogue writes the
consumer's int8 input (and adds Darknet's residual), so the consumer runs
no quantize pass. The linked forward gives the same bytes as the unlinked
one.

Usage::

    calib = calibrate(model, batches)           # {conv name: {amax, q999}}
    quantize_variables(model, calib)            # installs the int8 state in place
    quantize_model(model, batches)              # both in one call

A model with no 2-D conv + BN pair (the video zoo's 3-D nets, ViT) raises
"no ConvBN+BN blocks found to quantize".
"""
from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.layers import Int8Conv, conv_bn_pairs, record_input_range
from ..models.import_jax import jax_module_path, jax_paths

BN_EPS = 1e-5  # nn/layers.py::BatchNorm's default


@torch.inference_mode()
def calibrate(model: nn.Module, batches: Iterable) -> dict[str, dict[str, torch.Tensor]]:
    """Run eval forwards of ``model`` over ``batches`` (model inputs, e.g.
    normalized float32 image batches), in float32 without autocast,
    recording each conv + BN pair's input absmax and 99.9th percentile of
    |x| (maxed over the batches). -> {conv module name: {"amax", "q999"}},
    float32 scalars on the CPU. A pair whose conv already runs int8 records
    nothing (its float conv does not run)."""
    calib: dict[str, dict] = {}
    hooks = []
    for name, conv, _ in conv_bn_pairs(model):
        store = calib.setdefault(name, {})
        hooks.append(conv.register_forward_pre_hook(
            lambda _m, args, store=store: record_input_range(store, args[0])))
    was_training = model.training
    model.eval()
    n = 0
    try:
        for x in batches:
            with torch.autocast(x.device.type, enabled=False):
                model(x)
            n += 1
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    if not n:
        raise ValueError("calibrate() needs at least one batch")
    return {k: {key: v.float().cpu() for key, v in s.items()} for k, s in calib.items() if s}


def fold_and_quantize(conv: nn.Conv2d, bn: nn.Module | None,
                      eps: float = BN_EPS) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pair's BN fold and weight quantization on the host, in float32
    numpy, as the JAX package computes them (torch's CPU ``sqrt`` is not
    correctly rounded on every build, numpy's is) -> (w_q OIHW int8,
    w_scale [N], bias [N])."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    w = host(conv.weight)
    n = w.shape[0]
    conv_bias = None if conv.bias is None else host(conv.bias)
    if bn is not None:
        gamma, beta, mean, var = map(host, (bn.weight, bn.bias, bn.running_mean,
                                            bn.running_var))
        inv = gamma / np.sqrt(var + eps)
        w = w * inv[:, None, None, None]
        bias = beta - mean * inv
        if conv_bias is not None:
            bias = bias + conv_bias * inv
    else:
        bias = conv_bias if conv_bias is not None else np.zeros(n, np.float32)
    w_amax = np.abs(w).reshape(n, -1).max(axis=1)
    w_scale = np.maximum(w_amax / 127.0, 1e-12).astype(np.float32)
    w_q = np.clip(np.round(w / w_scale[:, None, None, None]), -127, 127).astype(np.int8)
    return (torch.from_numpy(w_q), torch.from_numpy(w_scale),
            torch.from_numpy(bias.astype(np.float32)))


def install_quant(model: nn.Module, state: Mapping[str, Mapping[str, torch.Tensor]]) -> int:
    """Put ``state`` ({conv module name: {w_q, w_scale, in_scale, bias}}) on
    the model's pairs as `Int8Conv`s, on each conv's device; every other
    pair's int8 state is removed; then the link plan is built anew
    (`link_int8`). Every route to an int8 model comes through here. -> the
    number of quantized convs."""
    pairs = {name: conv for name, conv, _ in conv_bn_pairs(model)}
    unknown = sorted(set(state) - set(pairs))
    if unknown:
        raise KeyError(f"int8 state for convs the model does not have: {unknown}")
    for name, conv in pairs.items():
        if "quant" in conv._modules:
            del conv.quant
        q = state.get(name)
        if q is not None:
            dev = conv.weight.device
            conv.quant = Int8Conv(*(torch.as_tensor(q[k]).to(dev) for k in (
                "w_q", "w_scale", "in_scale", "bias")), conv.stride[0], conv.padding[0],
                conv.groups).train(conv.training)
    link_int8(model)
    return len(state)


def link_int8(model: nn.Module, enabled: bool = True) -> list[tuple[str, str, bool]]:
    """Build the link plan of ``model``'s int8 convs (with ``enabled=False``,
    clear it): each edge a module declares (``int8_edges()``: ``(producer,
    consumer, keep_float)``, names of its `ConvBN`s) links the producer's
    `Int8Conv` to the consumer's where both are quantized and both run on
    the implicit GEMM (`Int8Conv.on_implicit_gemm`): the producer's kernel
    then writes the consumer's int8 input, and no quantize pass runs on it.
    A float conv at either end (a ``skip``) leaves the edge unlinked. The
    plan depends on the structure and the shapes alone, so it is the same on
    the CPU and on the card. -> the edges linked, [(producer, consumer,
    keep_float)] by module name."""
    for m in model.modules():
        if isinstance(m, Int8Conv):
            m.link = None
    plan: list[tuple[str, str, bool]] = []
    if not enabled:
        return plan
    for name, mod in model.named_modules():
        declare = getattr(mod, "int8_edges", None)
        if declare is None:
            continue
        prefix = f"{name}." if name else ""
        for producer, consumer, keep_float in declare():
            p, c = (mod.get_submodule(n).conv._modules.get("quant") for n in (producer, consumer))
            if p is None or c is None or not (p.on_implicit_gemm and c.on_implicit_gemm):
                continue
            if p.link is not None:
                raise ValueError(f"{prefix + producer} is declared to feed two int8 convs")
            p.link = (c, keep_float)
            plan.append((prefix + producer, prefix + consumer, keep_float))
    return plan


def quantize_variables(model: nn.Module, calib: Mapping[str, Mapping[str, torch.Tensor]],
                       skip: Sequence[str] = (), eps: float = BN_EPS,
                       percentile: bool = False) -> nn.Module:
    """``model`` + `calibrate`'s tree -> ``model``, its int8 state installed
    in place on every conv + BN pair that no ``skip`` substring matches. A
    substring matches a pair when it is in the pair's "/"-joined module path
    (``backbone/conv0/conv``) or in the JAX package's path of the same layer
    (``backbone/stem``, `models.import_jax.jax_paths`), so a JAX ``skip``
    list skips the same layers here.

    ``percentile=True`` scales the activations by the calibrated 99.9th
    percentile of |x| instead of the absmax: rare outliers then do not
    widen the int8 grid. The float parameters stay untouched."""
    jax = jax_paths(model) if skip else {}
    state = {}
    for name, conv, bn in conv_bn_pairs(model):
        path = name.replace(".", "/")
        jax_path = jax_module_path(jax, name) or ""
        if any(k in path or k in jax_path for k in skip):
            continue
        c = calib.get(name, {})
        if "amax" not in c:
            if bn is not None:
                raise ValueError(f"no calibration absmax for ConvBN at {path!r} — was "
                                 "calibrate() run with the same model structure?")
            continue  # a BN-free pair that was not calibrated: left float, as in JAX
        w_q, w_scale, bias = fold_and_quantize(conv, bn, eps)
        a_key = "q999" if percentile and "q999" in c else "amax"
        in_scale = torch.tensor(max(float(c[a_key]) / 127.0, 1e-12), dtype=torch.float32)
        state[name] = {"w_q": w_q, "w_scale": w_scale, "in_scale": in_scale, "bias": bias}
    if not state:
        raise ValueError("no ConvBN+BN blocks found to quantize")
    install_quant(model, state)
    return model


def quantize_model(model: nn.Module, batches: Iterable, skip: Sequence[str] = (),
                   percentile: bool = False) -> nn.Module:
    """`calibrate` + `quantize_variables` in one call; ``batches`` are model
    inputs."""
    return quantize_variables(model, calibrate(model, batches), skip=skip,
                              percentile=percentile)


def quant_state(model: nn.Module) -> dict[str, dict[str, torch.Tensor]]:
    """The model's installed int8 state: {conv module name: {w_q, w_scale,
    in_scale, bias}} (the tensors themselves, on the model's device)."""
    return {name: {k: getattr(conv.quant, k) for k in ("w_q", "w_scale", "in_scale", "bias")}
            for name, conv, _ in conv_bn_pairs(model) if "quant" in conv._modules}
