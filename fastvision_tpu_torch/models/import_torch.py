"""Reference-checkpoint import into the port's models (the port's
counterpart of fastvision_tpu/models/import_torch.py): `state_dict_for_port`
routes a checkpoint by its key scheme, for a detector (``task='detect'``),
a classifier (``task='cls'``) or a video model (``task='video'``).

Detectors: backbone classifiers (a reference Darknet-53, a torchvision or
reference VGG16) map onto the detectors' trunks, and a reference Faster
R-CNN maps as below. Classifiers: the port's ResNet uses torchvision's
names and its Darknet-53 the reference's, so those load as they are; a
reference ResNet (``conv1.{0,1}``, ``res2..res5``) is renamed to
torchvision's, and a torchvision or reference VGG to the port's ``conv{i}``
/ ``fc{1,2,3}``, fc1's input columns re-interleaved from the torch (C, 7, 7)
flatten to the port's (7, 7, C).

Video models: the port's 3D-ResNet and SlowFast use the reference's names
and load its checkpoints as they are; a reference C3D's convs are taken in
order within each ``layer{i}`` (``c3d_state_dict_from_reference``).

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


def _numpy(torch_state: Mapping[str, Any]) -> dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in torch_state.items()}


def _fc1_chw_to_hwc(w1: np.ndarray) -> np.ndarray:
    """A Linear weight [out, C * 7 * 7] that reads a (c, h, w) flatten ->
    the same Linear for an (h, w, c) flatten."""
    w1 = w1.reshape(w1.shape[0], -1, 7, 7).transpose(0, 2, 3, 1)
    return w1.reshape(w1.shape[0], -1)


def frcnn_state_dict_from_reference(torch_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Reference ``Faster_Rcnn`` state_dict (tensors or numpy arrays) -> a
    state_dict for this port's ``FasterRCNN``."""
    s = _numpy(torch_state)
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
    out["head.fc1.weight"] = _t(_fc1_chw_to_hwc(s[f"{pre}.0.weight"]))
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


def vgg_state_dict_from_torch(torch_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A VGG classifier, torchvision's (``features.N``) or the reference's
    (``vgg{1..5}.N``), -> the port's ``VGG``: the convs in order ->
    ``conv{i}.conv`` (a batch-norm layer right after a conv -> ``conv{i}.bn``);
    ``classifier.{0,3,6}`` -> ``fc1`` / ``fc2`` / ``fc3``, fc1's input
    columns re-interleaved from (C, 7, 7) to (7, 7, C)."""
    s = _numpy(torch_state)

    def convs(prefix: str) -> list[tuple[str, str]]:  # ("<prefix>N", "<prefix>N+1") by N
        n = sorted(int(k[len(prefix):].split(".")[0]) for k, v in s.items()
                   if k.startswith(prefix) and k.endswith(".weight") and v.ndim == 4)
        return [(f"{prefix}{i}", f"{prefix}{i + 1}") for i in n]

    layers = (convs("features.") if "features.0.weight" in s
              else [c for stage in range(1, 6) for c in convs(f"vgg{stage}.")])
    out: dict[str, torch.Tensor] = {}
    for i, (conv, bn) in enumerate(layers):
        out[f"conv{i}.conv.weight"] = _t(s[f"{conv}.weight"])
        out[f"conv{i}.conv.bias"] = _t(s[f"{conv}.bias"])
        if f"{bn}.running_mean" in s:
            for name in ("weight", "bias", "running_mean", "running_var"):
                out[f"conv{i}.bn.{name}"] = _t(s[f"{bn}.{name}"])
    for src, dst in (("classifier.0", "fc1"), ("classifier.3", "fc2"), ("classifier.6", "fc3")):
        if f"{src}.weight" in s:
            w = s[f"{src}.weight"]
            out[f"{dst}.weight"] = _t(_fc1_chw_to_hwc(w) if dst == "fc1" else w)
            out[f"{dst}.bias"] = _t(s[f"{src}.bias"])
    return out


def vgg16_state_dict_for_frcnn(torch_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A VGG16 classifier (`vgg_state_dict_from_torch`'s schemes) -> the
    port's ``FasterRCNN``, as the reference starts its Faster R-CNN from
    one: the 13 convs -> ``backbone.conv{i}.conv`` (batch-norm layers, which
    the detector's trunk has not, are dropped); ``fc1`` / ``fc2`` ->
    ``head.fc1`` / ``head.fc2``; the 1000-way ``fc3`` is dropped."""
    return {("backbone." if k.startswith("conv") else "head.") + k: v
            for k, v in vgg_state_dict_from_torch(torch_state).items()
            if ".conv." in k or k.startswith(("fc1.", "fc2."))}


def resnet_state_dict_from_reference(torch_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference's ResNet / ResNeXt (stem ``conv1.0`` conv + ``conv1.1``
    BN, stages ``res2..res5``) -> torchvision's names, the port's."""
    out = {}
    for k, v in torch_state.items():
        if k.startswith("conv1.0."):
            k = "conv1." + k[len("conv1.0."):]
        elif k.startswith("conv1.1."):
            k = "bn1." + k[len("conv1.1."):]
        elif k.startswith("res"):
            k = f"layer{int(k[3]) - 1}." + k.split(".", 1)[1]
        out[k] = torch.as_tensor(v)
    return out


def c3d_state_dict_from_reference(torch_state: Mapping[str, Any],
                                  batch_norm: bool) -> dict[str, torch.Tensor]:
    """A reference C3D (``layer{1..5}.{n}.conv`` convs, a BatchNorm3d right
    after each in ``c3d_bn``, ``classifier.{0,3,6}``) -> the port's ``C3D``
    (``c3d_bn`` with ``batch_norm``): each layer's convs in order to the
    port's Sequential positions. A conv bias before BN is folded into the
    BN's running mean (BN(x + b) == BN'(x) with mean' = mean - b), as the
    JAX package's importer does: the port's BN convs have no bias. The
    classifier reads the same (c, t, h, w) flatten and passes as it is."""
    s = _numpy(torch_state)
    out: dict[str, torch.Tensor] = {}
    for li in range(1, 6):
        convs = sorted(int(k.split(".")[1]) for k in s
                       if k.startswith(f"layer{li}.") and k.endswith(".conv.weight"))
        for i, n in enumerate(convs):
            m = 3 * i if batch_norm else 2 * i  # conv [, BN], ReLU per conv in the port
            out[f"layer{li}.{m}.conv.weight"] = _t(s[f"layer{li}.{n}.conv.weight"])
            bias = s.get(f"layer{li}.{n}.conv.bias")
            bn = f"layer{li}.{n + 1}"
            if batch_norm:
                for name in ("weight", "bias", "running_mean", "running_var"):
                    out[f"layer{li}.{m + 1}.{name}"] = _t(s[f"{bn}.{name}"])
                if f"{bn}.num_batches_tracked" in s:
                    out[f"layer{li}.{m + 1}.num_batches_tracked"] = torch.as_tensor(
                        s[f"{bn}.num_batches_tracked"])
                if bias is not None:
                    out[f"layer{li}.{m + 1}.running_mean"] -= _t(bias)
            elif bias is not None:
                out[f"layer{li}.{m}.conv.bias"] = _t(bias)
    for k in ("0", "3", "6"):
        for name in ("weight", "bias"):
            out[f"classifier.{k}.{name}"] = _t(s[f"classifier.{k}.{name}"])
    return out


def state_dict_for_port(torch_state: Mapping[str, Any],
                        task: str = "detect") -> dict[str, torch.Tensor]:
    """Route a torch checkpoint to the port's names by its key scheme (the
    JAX package's ``detect_and_import``) for a detector (``task='detect'``),
    a classifier (``'cls'``) or a video model (``'video'``).

    detect: the reference demo's YOLOv3 naming, which is the port's own,
    and the port's Faster R-CNN pass as they are; a reference Faster R-CNN,
    a reference Darknet-53 classifier and a torchvision or reference VGG16
    are renamed. Raises ValueError, with the first keys, on any other scheme.
    cls: a reference ResNet and a torchvision or reference VGG are renamed;
    anything else (torchvision ResNet / ResNeXt, the reference Darknet-53,
    the port's own checkpoints) passes as it is.
    video: a SlowFast (``fast_pathway.conv1.0``) or 3D-ResNet (a 5-D
    ``conv1.0``), the reference's or the port's, passes as it is; a C3D
    (a 5-D ``layer1.0.conv``) is renamed for ``c3d_bn`` when it has BN
    layers, else for ``c3d``. Raises ValueError on any other scheme."""
    s = torch_state
    if task == "video":
        if "fast_pathway.conv1.0.weight" in s or (
                "conv1.0.weight" in s and s["conv1.0.weight"].ndim == 5):
            return {k: torch.as_tensor(v) for k, v in s.items()}
        if "layer1.0.conv.weight" in s and s["layer1.0.conv.weight"].ndim == 5:
            return c3d_state_dict_from_reference(s, "layer1.1.running_mean" in s)
        raise ValueError("unrecognized video checkpoint naming scheme; first keys: "
                         f"{sorted(s)[:6]}")
    if task == "cls":
        if "conv1.0.weight" in s:
            return resnet_state_dict_from_reference(s)
        if "features.0.weight" in s or "vgg1.0.weight" in s:
            return vgg_state_dict_from_torch(s)
        return {k: torch.as_tensor(v) for k, v in s.items()}
    if "backbone.conv0.conv.weight" in s or "head.head_out_small.weight" in s:
        return {k: torch.as_tensor(v) for k, v in s.items()}
    if "rpn.conv3x3.weight" in s:
        return frcnn_state_dict_from_reference(s)
    if "conv0.conv.weight" in s:
        return darknet53_state_dict_from_reference(s)
    if "features.0.weight" in s or "vgg1.0.weight" in s:
        return vgg16_state_dict_for_frcnn(s)
    raise ValueError(f"unrecognized torch checkpoint naming scheme; first keys: {sorted(s)[:6]}")
