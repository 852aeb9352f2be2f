"""Weight bridge: the JAX package's flax variables -> this port's
state_dicts, for YOLOv3, Faster R-CNN, the classification zoo (ResNet /
ResNeXt, VGG with its top, the Darknet-53 classifier, ViT) and the video
zoo (C3D, the 3D-ResNet, SlowFast).

Takes the variables as nested dicts of numpy arrays (what
``jax.device_get(variables)`` returns), so this module needs no JAX. The
mapping is the inverse of ``fastvision_tpu/models/import_torch.py``:

  - conv kernel HWIO -> OIHW (``transpose(3, 2, 0, 1)``);
  - ``.../bn/bn/{scale,bias}`` (params) and ``.../bn/bn/{mean,var}``
    (batch_stats) -> ``bn.{weight,bias,running_mean,running_var}``;
  - ``head/pred{i}/{kernel,bias}`` -> ``head.head_out_{lvl}.{weight,bias}``;
  - Dense kernel [in, out] -> Linear weight [out, in]. The Faster R-CNN
    head's and VGG's fc1 take a map flattened in (h, w, c) order in both
    packages, so their rows need no re-interleave;
  - ViT attention: flax's q / k / v kernels [dim, heads, head_dim] -> one
    ``qkv`` weight [3 dim, dim], its out kernel [heads, head_dim, dim] ->
    ``proj`` [dim, dim];
  - video: conv kernels DHWIO -> OIDHW (``transpose(4, 3, 0, 1, 2)``), a
    ConvBN3D's ``bn/{scale,bias}`` and ``bn/{mean,var}`` -> the BN's
    weights and running statistics, under the reference's names (see
    `models.video`). C3D's fc6 rows are re-interleaved from the JAX
    package's (t, h, w, c) flatten to the port's (c, t, h, w).

Depths are read from the variables, so shallow nets bridge too.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .detection.yolov3 import LEVELS


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))  # a C-contiguous copy


def _bn(out: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    bn, st = params["bn"]["bn"], stats["bn"]["bn"]
    out[f"{prefix}.weight"] = _t(bn["scale"])
    out[f"{prefix}.bias"] = _t(bn["bias"])
    out[f"{prefix}.running_mean"] = _t(st["mean"])
    out[f"{prefix}.running_var"] = _t(st["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _convbn(out: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    conv = params["conv"]
    out[f"{prefix}.conv.weight"] = _t(np.transpose(conv["kernel"], (3, 2, 0, 1)))
    if "bias" in conv:
        out[f"{prefix}.conv.bias"] = _t(conv["bias"])
    if "bn" in params:
        _bn(out, f"{prefix}.bn", params, stats)


def darknet53_state_dict_from_jax(variables: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """Variables of the JAX ``Darknet53`` (without its top) -> a state_dict
    for this port's ``Darknet53``, keys prefixed with ``prefix``."""
    bp, bs = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    _convbn(out, f"{prefix}conv0", bp["stem"], bs["stem"])
    for i in range(1, 6):
        _convbn(out, f"{prefix}conv{i}", bp[f"down{i}"], bs[f"down{i}"])
        j = 0
        while f"stage{i}_block{j}" in bp:
            blk = f"stage{i}_block{j}"
            for k in (0, 1):
                _convbn(out, f"{prefix}res{i}.{j}.conv{k + 1}",
                        bp[blk][f"ConvBN_{k}"], bs[blk][f"ConvBN_{k}"])
            j += 1
    return out


def yolov3_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of the JAX ``YOLOv3`` -> a
    state_dict for this port's ``YOLOv3`` (``load_state_dict(strict=True)``)."""
    params, stats = variables["params"], variables["batch_stats"]
    out = darknet53_state_dict_from_jax(
        {"params": params["backbone"], "batch_stats": stats["backbone"]}, "backbone.")

    npar, nst = params["neck"], stats["neck"]
    for li, lvl in enumerate(LEVELS):
        for k in range(5):
            _convbn(out, f"neck.neck_{lvl}.{k}", npar[f"block{li}"][f"ConvBN_{k}"],
                    nst[f"block{li}"][f"ConvBN_{k}"])
        _convbn(out, f"neck.neck_out_{lvl}", npar[f"out{li}"], nst[f"out{li}"])
        if f"lateral{li + 1}" in npar:
            _convbn(out, f"neck.up_sampling_{lvl}.0", npar[f"lateral{li + 1}"],
                    nst[f"lateral{li + 1}"])

    for li, lvl in enumerate(LEVELS):
        pred = params["head"][f"pred{li}"]
        out[f"head.head_out_{lvl}.weight"] = _t(np.transpose(pred["kernel"], (3, 2, 0, 1)))
        out[f"head.head_out_{lvl}.bias"] = _t(pred["bias"])
    return out


def _dense(out: dict, prefix: str, params: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(np.transpose(params["kernel"]))
    out[f"{prefix}.bias"] = _t(params["bias"])


def faster_rcnn_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """{'params': ...} of the JAX ``FasterRCNN`` -> a state_dict for this
    port's ``FasterRCNN`` (``load_state_dict(strict=True)``)."""
    params = variables["params"]
    out: dict[str, torch.Tensor] = {}
    bp = params["backbone"]
    i = 0
    while f"conv{i}" in bp:
        _convbn(out, f"backbone.conv{i}", bp[f"conv{i}"], {})
        i += 1
    for name in ("conv", "cls", "reg"):
        rp = params["rpn"][name]
        out[f"rpn.{name}.weight"] = _t(np.transpose(rp["kernel"], (3, 2, 0, 1)))
        out[f"rpn.{name}.bias"] = _t(rp["bias"])
    for name in ("fc1", "fc2", "cls", "reg"):
        _dense(out, f"head.{name}", params["head"][name])
    return out


def _conv_bn(out: dict, conv: str, bn: str, params: Mapping, stats: Mapping) -> None:
    """A JAX ConvBN -> torchvision-style separate ``conv`` / ``bn`` names."""
    out[f"{conv}.weight"] = _t(np.transpose(params["conv"]["kernel"], (3, 2, 0, 1)))
    _bn(out, bn, params, stats)


def resnet_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Variables of the JAX ``ResNet`` (ResNeXt too) -> a state_dict for
    this port's ``ResNet`` in torchvision's names."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    _conv_bn(out, "conv1", "bn1", p["stem"], s["stem"])
    for i in range(1, 5):
        j = 0
        while f"stage{i}_block{j}" in p:
            blk, pre = f"stage{i}_block{j}", f"layer{i}.{j}"
            k = 0
            while f"ConvBN_{k}" in p[blk]:
                _conv_bn(out, f"{pre}.conv{k + 1}", f"{pre}.bn{k + 1}", p[blk][f"ConvBN_{k}"],
                         s[blk][f"ConvBN_{k}"])
                k += 1
            if "downsample" in p[blk]:
                _conv_bn(out, f"{pre}.downsample.0", f"{pre}.downsample.1",
                         p[blk]["downsample"], s[blk]["downsample"])
            j += 1
    if "fc" in p:
        _dense(out, "fc", p["fc"])
    return out


def vgg_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Variables of the JAX ``VGG`` (with or without BN and its top) -> a
    state_dict for this port's ``VGG``."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out: dict[str, torch.Tensor] = {}
    i = 0
    while f"conv{i}" in p:
        _convbn(out, f"conv{i}", p[f"conv{i}"], s.get(f"conv{i}", {}))
        i += 1
    for name in ("fc1", "fc2", "fc3"):
        if name in p:
            _dense(out, name, p[name])
    return out


def darknet53_classifier_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Variables of the JAX ``Darknet53`` classifier -> a state_dict for
    `classification.darknet53`."""
    out = darknet53_state_dict_from_jax(variables)
    _dense(out, "fc", variables["params"]["fc"])
    return out


def vit_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Variables of the JAX ``ViT`` -> a state_dict for this port's ``ViT``."""
    p = variables["params"]
    out = {"patch_embed.weight": _t(np.transpose(p["patch_embed"]["kernel"], (3, 2, 0, 1))),
           "patch_embed.bias": _t(p["patch_embed"]["bias"]),
           "cls_token": _t(p["cls_token"]), "pos_embed": _t(p["pos_embed"])}

    def norm(prefix, params):
        out[f"{prefix}.weight"] = _t(params["scale"])
        out[f"{prefix}.bias"] = _t(params["bias"])

    i = 0
    while f"block{i}" in p:
        blk, pre = p[f"block{i}"], f"blocks.{i}"
        norm(f"{pre}.norm1", blk["norm1"])
        norm(f"{pre}.norm2", blk["norm2"])
        attn = blk["attn"]
        dim = attn["query"]["kernel"].shape[0]
        qkv = [np.reshape(attn[n]["kernel"], (dim, dim)).T for n in ("query", "key", "value")]
        out[f"{pre}.attn.qkv.weight"] = _t(np.concatenate(qkv))
        out[f"{pre}.attn.qkv.bias"] = _t(np.concatenate(
            [np.reshape(attn[n]["bias"], -1) for n in ("query", "key", "value")]))
        out[f"{pre}.attn.proj.weight"] = _t(np.reshape(attn["out"]["kernel"], (dim, dim)).T)
        out[f"{pre}.attn.proj.bias"] = _t(attn["out"]["bias"])
        _dense(out, f"{pre}.mlp.fc1", blk["fc1"])
        _dense(out, f"{pre}.mlp.fc2", blk["fc2"])
        i += 1
    norm("norm", p["norm"])
    if "head" in p:
        _dense(out, "head", p["head"])
    return out


def _conv3d(out: dict, prefix: str, conv: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(np.transpose(conv["kernel"], (4, 3, 0, 1, 2)))
    if "bias" in conv:
        out[f"{prefix}.bias"] = _t(conv["bias"])


def _bn3d(out: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _convbn3d(out: dict, conv: str, bn: str, params: Mapping, stats: Mapping) -> None:
    """A JAX ConvBN3D -> separate ``conv`` / ``bn`` names."""
    _conv3d(out, conv, params["conv"])
    _bn3d(out, bn, params["bn"], stats["bn"])


def c3d_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Variables of the JAX ``C3D`` (``c3d`` or ``c3d_bn``) -> a state_dict
    for this port's ``C3D``."""
    from .video.c3d import PLAN

    p, s = variables["params"], variables.get("batch_stats", {})
    bn = "bn" in p["conv1a"]
    names = iter(["conv1a", "conv2a", "conv3a", "conv3b", "conv4a", "conv4b", "conv5a", "conv5b"])
    out: dict[str, torch.Tensor] = {}
    for li, (widths, _, _) in enumerate(PLAN, start=1):
        n = 0
        for _ in widths:  # conv [, BN], ReLU per conv in the layer's Sequential
            name = next(names)
            _conv3d(out, f"layer{li}.{n}.conv", p[name]["conv"])
            if bn:
                _bn3d(out, f"layer{li}.{n + 1}", p[name]["bn"], s[name]["bn"])
            n += 3 if bn else 2
    k6 = np.asarray(p["fc6"]["kernel"])  # [(t, h, w, c), out]
    w6 = k6.T.reshape(-1, 1, 4, 4, 512).transpose(0, 4, 1, 2, 3)
    out["classifier.0.weight"] = _t(w6.reshape(w6.shape[0], -1))
    out["classifier.0.bias"] = _t(p["fc6"]["bias"])
    _dense(out, "classifier.3", p["fc7"])
    _dense(out, "classifier.6", p["fc8"])
    return out


def resnet3d_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Variables of the JAX ``ResNet3D`` -> a state_dict for this port's
    ``ResNet3D`` in the reference's names."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    _convbn3d(out, "conv1.0", "conv1.1", p["stem"], s["stem"])
    for i in range(1, 5):
        j = 0
        while f"stage{i}_block{j}" in p:
            blk, pre = f"stage{i}_block{j}", f"res{i + 1}.{j}"
            for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("conv2_spatial", "bn2_spatial"),
                             ("conv2_temporal", "bn2_temporal"), ("conv3", "bn3")):
                if conv in p[blk]:
                    _convbn3d(out, f"{pre}.{conv}", f"{pre}.{bn}", p[blk][conv], s[blk][conv])
            if "downsample" in p[blk]:
                _convbn3d(out, f"{pre}.downsample.0", f"{pre}.downsample.1",
                          p[blk]["downsample"], s[blk]["downsample"])
            j += 1
    _dense(out, "fc", p["fc"])
    return out


def slowfast_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Variables of the JAX ``SlowFast`` -> a state_dict for this port's
    ``SlowFast`` in the reference's names."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    for ours in ("slow", "fast"):
        path = f"{ours}_pathway"
        _convbn3d(out, f"{path}.conv1.0", f"{path}.conv1.1", p[f"{ours}_stem"], s[f"{ours}_stem"])
        for i in range(1, 5):
            j = 0
            while f"{ours}_s{i}_b{j}" in p:
                blk, pre = f"{ours}_s{i}_b{j}", f"{path}.res{i + 1}.{j}"
                for k in (1, 2, 3):
                    _convbn3d(out, f"{pre}.conv{k}.conv", f"{pre}.bn{k}", p[blk][f"conv{k}"],
                              s[blk][f"conv{k}"])
                if "downsample" in p[blk]:
                    _convbn3d(out, f"{pre}.downsample.0.conv", f"{pre}.downsample.1",
                              p[blk]["downsample"], s[blk]["downsample"])
                j += 1
    for ours, ref in (("lateral_stem", "lateral_pool1"), ("lateral_s1", "lateral_res2"),
                      ("lateral_s2", "lateral_res3"), ("lateral_s3", "lateral_res4")):
        if ours in p:
            _conv3d(out, f"fast_pathway.{ref}.conv", p[ours]["conv"])
    _dense(out, "fc", p["fc"])
    return out
