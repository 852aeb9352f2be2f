"""Weight bridge: the JAX package's flax YOLOv3 and Faster R-CNN variables ->
this port's state_dicts.

Takes the variables as nested dicts of numpy arrays (what
``jax.device_get(variables)`` returns), so this module needs no JAX. The
mapping is the inverse of ``fastvision_tpu/models/import_torch.py::
yolov3_from_torch``:

  - conv kernel HWIO -> OIHW (``transpose(3, 2, 0, 1)``);
  - ``.../bn/bn/{scale,bias}`` (params) and ``.../bn/bn/{mean,var}``
    (batch_stats) -> ``bn.{weight,bias,running_mean,running_var}``;
  - ``head/pred{i}/{kernel,bias}`` -> ``head.head_out_{lvl}.{weight,bias}``;
  - Dense kernel [in, out] -> Linear weight [out, in]. The Faster R-CNN
    head's fc1 takes RoI features flattened in (h, w, c) order in both
    packages, so its rows need no re-interleave.

The backbone's depth is read from the variables, so shallow nets bridge too.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .detection.yolov3 import LEVELS


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))  # a C-contiguous copy


def _convbn(out: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    conv = params["conv"]
    out[f"{prefix}.conv.weight"] = _t(np.transpose(conv["kernel"], (3, 2, 0, 1)))
    if "bias" in conv:
        out[f"{prefix}.conv.bias"] = _t(conv["bias"])
    if "bn" in params:
        bn, st = params["bn"]["bn"], stats["bn"]["bn"]
        out[f"{prefix}.bn.weight"] = _t(bn["scale"])
        out[f"{prefix}.bn.bias"] = _t(bn["bias"])
        out[f"{prefix}.bn.running_mean"] = _t(st["mean"])
        out[f"{prefix}.bn.running_var"] = _t(st["var"])
        out[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)


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
