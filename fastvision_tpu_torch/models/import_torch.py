"""Reference-checkpoint import into the port's detectors (the port's
counterpart of fastvision_tpu/models/import_torch.py): `state_dict_for_port`
routes a checkpoint by its key scheme; backbone classifiers (a reference
Darknet-53, a torchvision or reference VGG16) map onto the detectors'
trunks, and a reference Faster R-CNN maps as below.

Use a reference Faster R-CNN with ``FasterRCNN(reference_compat=True)``. Its mapping:

  - ``backbone.vgg{1..5}.{n}`` biased convs, in order -> ``backbone.conv{i}.conv``
    (13 convs for VGG16; both sides drop the last pool);
  - ``rpn.conv3x3`` -> ``rpn.conv``, ``rpn.regressor`` -> ``rpn.reg``;
  - ``rpn.classifier`` (two softmax logits per anchor, channel 2a = bg,
    2a + 1 = fg) -> the single sigmoid logit ``rpn.cls`` as fg - bg
    (sigmoid(fg - bg) == softmax(fg): same scores and NMS order);
  - ``fast.module_after_roi.{0,3}`` (or ``backbone.classifier.{0,3}``) ->
    ``head.fc1`` / ``head.fc2``; fc1's input columns are re-interleaved
    from the reference's (C, 7, 7) RoI flatten to the port's (7, 7, C);
  - ``fast.classifier`` -> ``head.cls`` (class 0 = background on both
    sides); ``fast.regressor`` ((C + 1) * 4 rows, a background box first)
    -> ``head.reg`` without its 4 background rows.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def frcnn_state_dict_from_reference(torch_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Reference ``Faster_Rcnn`` state_dict (tensors or numpy arrays) -> a
    state_dict for this port's ``FasterRCNN``."""
    s = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
         for k, v in torch_state.items()}
    out: dict[str, torch.Tensor] = {}
    i = 0
    for stage in range(1, 6):
        convs = sorted(int(k.split(".")[2]) for k, v in s.items()
                       if k.startswith(f"backbone.vgg{stage}.") and k.endswith(".weight")
                       and v.ndim == 4)
        for n in convs:
            out[f"backbone.conv{i}.conv.weight"] = _t(s[f"backbone.vgg{stage}.{n}.weight"])
            out[f"backbone.conv{i}.conv.bias"] = _t(s[f"backbone.vgg{stage}.{n}.bias"])
            i += 1
    for src, dst in (("rpn.conv3x3", "rpn.conv"), ("rpn.regressor", "rpn.reg")):
        out[f"{dst}.weight"] = _t(s[f"{src}.weight"])
        out[f"{dst}.bias"] = _t(s[f"{src}.bias"])
    w2, b2 = s["rpn.classifier.weight"], s["rpn.classifier.bias"]
    out["rpn.cls.weight"] = _t(w2[1::2] - w2[0::2])
    out["rpn.cls.bias"] = _t(b2[1::2] - b2[0::2])

    pre = ("fast.module_after_roi" if "fast.module_after_roi.0.weight" in s
           else "backbone.classifier")
    w1 = s[f"{pre}.0.weight"]  # [hidden, 512 * 7 * 7], input columns in (c, h, w) order
    w1 = w1.reshape(w1.shape[0], 512, 7, 7).transpose(0, 2, 3, 1)
    out["head.fc1.weight"] = _t(w1.reshape(w1.shape[0], -1))
    out["head.fc1.bias"] = _t(s[f"{pre}.0.bias"])
    out["head.fc2.weight"] = _t(s[f"{pre}.3.weight"])
    out["head.fc2.bias"] = _t(s[f"{pre}.3.bias"])
    out["head.cls.weight"] = _t(s["fast.classifier.weight"])
    out["head.cls.bias"] = _t(s["fast.classifier.bias"])
    out["head.reg.weight"] = _t(s["fast.regressor.weight"][4:])
    out["head.reg.bias"] = _t(s["fast.regressor.bias"][4:])
    return out


def darknet53_state_dict_from_reference(torch_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference's Darknet-53 classifier (``conv0..conv5``,
    ``res{1..5}.{j}.conv{1,2}``, each ``.conv`` + ``.bn``) -> the port's
    YOLOv3 backbone: the same names under ``backbone.``. The classifier top
    ``fc`` has no counterpart in the detector and is dropped."""
    return {"backbone." + k: torch.as_tensor(v) for k, v in torch_state.items()
            if not k.startswith("fc.")}


def vgg16_state_dict_for_frcnn(torch_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A VGG16 classifier, torchvision's (``features.N``) or the reference's
    (``vgg{1..5}.N``), -> the port's ``FasterRCNN``, as the reference starts
    its Faster R-CNN from one: the 13 convs in order -> ``backbone.conv{i}.conv``
    (batch-norm layers, which the detector's trunk has not, are dropped);
    ``classifier.0`` / ``classifier.3`` -> ``head.fc1`` / ``head.fc2``, fc1's
    input columns re-interleaved from (C, 7, 7) to (7, 7, C); the 1000-way
    ``classifier.6`` is dropped."""
    s = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
         for k, v in torch_state.items()}

    def convs(prefix: str) -> list[str]:  # "<prefix>N" of the rank-4 weights, by N
        n = sorted(int(k[len(prefix):].split(".")[0]) for k, v in s.items()
                   if k.startswith(prefix) and k.endswith(".weight") and v.ndim == 4)
        return [f"{prefix}{i}" for i in n]

    layers = (convs("features.") if "features.0.weight" in s
              else [c for stage in range(1, 6) for c in convs(f"vgg{stage}.")])
    out: dict[str, torch.Tensor] = {}
    for i, name in enumerate(layers):
        out[f"backbone.conv{i}.conv.weight"] = _t(s[f"{name}.weight"])
        out[f"backbone.conv{i}.conv.bias"] = _t(s[f"{name}.bias"])
    if "classifier.0.weight" in s:
        w1 = s["classifier.0.weight"]
        w1 = w1.reshape(w1.shape[0], 512, 7, 7).transpose(0, 2, 3, 1)
        out["head.fc1.weight"] = _t(w1.reshape(w1.shape[0], -1))
        out["head.fc1.bias"] = _t(s["classifier.0.bias"])
    if "classifier.3.weight" in s:
        out["head.fc2.weight"] = _t(s["classifier.3.weight"])
        out["head.fc2.bias"] = _t(s["classifier.3.bias"])
    return out


def state_dict_for_port(torch_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Route a torch checkpoint to the port's detector names by its key
    scheme (the detectors' part of the JAX package's ``detect_and_import``):
    the reference demo's YOLOv3 naming, which is the port's own, and the
    port's Faster R-CNN pass as they are; a reference Faster R-CNN, a
    reference Darknet-53 classifier and a torchvision or reference VGG16 are
    renamed. Raises ValueError, with the first keys, on any other scheme."""
    s = torch_state
    if "backbone.conv0.conv.weight" in s or "head.head_out_small.weight" in s:
        return {k: torch.as_tensor(v) for k, v in s.items()}
    if "rpn.conv3x3.weight" in s:
        return frcnn_state_dict_from_reference(s)
    if "conv0.conv.weight" in s:
        return darknet53_state_dict_from_reference(s)
    if "features.0.weight" in s or "vgg1.0.weight" in s:
        return vgg16_state_dict_for_frcnn(s)
    raise ValueError(f"unrecognized torch checkpoint naming scheme; first keys: {sorted(s)[:6]}")
