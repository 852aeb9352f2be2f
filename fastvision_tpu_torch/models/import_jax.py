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

`quant_state_from_jax` carries the int8 state of a quantized model (the
JAX package's ``quant`` collection: ``w_q`` HWIO int8 -> OIHW, ``w_scale``,
``in_scale``, ``bias``), or its calibration tree (``amax``, ``q999``),
through the same bridges, keyed by the port's conv module names, for
`infer.quantize.install_quant` (YOLOv3 / Darknet-53, VGG / Faster R-CNN,
ResNet / ResNeXt).

`jax_paths` runs the same bridges backwards: for a port model it gives each
``state_dict`` key the JAX variable path it is read from (e.g.
``backbone.conv0.conv.weight`` <- ``params/backbone/stem/conv/kernel``), so
that options naming JAX paths (``quantize(skip=)``, ``model.freeze``) match
the same layers in both packages.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

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


def _quant(out: dict, conv: str, params: Mapping) -> None:
    """A ConvBN's int8 (or calibration) leaves, merged into its params by
    `quant_state_from_jax`, -> ``{conv}.quant.*`` entries."""
    for k, v in params.get("quant", {}).items():
        out[f"{conv}.quant.{k}"] = (
            torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(v, np.int8),
                                                               (3, 2, 0, 1))))
            if k == "w_q" else _t(v))


def _convbn(out: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    conv = params["conv"]
    out[f"{prefix}.conv.weight"] = _t(np.transpose(conv["kernel"], (3, 2, 0, 1)))
    if "bias" in conv:
        out[f"{prefix}.conv.bias"] = _t(conv["bias"])
    if "bn" in params:
        _bn(out, f"{prefix}.bn", params, stats)
    _quant(out, f"{prefix}.conv", params)


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
    _quant(out, conv, params)


def _merge_leaves(params: Mapping, tree: Mapping) -> Mapping:
    """``params`` with each ConvBN's leaves of ``tree`` (a collection that
    mirrors the module tree: ``quant``, ``quant_calib``) under its "quant" key."""
    if not isinstance(tree, Mapping) or not isinstance(params, Mapping):
        return params
    if tree and not any(isinstance(v, Mapping) for v in tree.values()):
        return {**params, "quant": tree}
    return {k: _merge_leaves(v, tree.get(k, {})) for k, v in params.items()}


def quant_state_from_jax(variables: Mapping, state_dict_from_jax,
                         collection: str = "quant") -> dict[str, dict[str, torch.Tensor]]:
    """The ``collection`` of the JAX package's variables (``quant`` from its
    ``quantize_variables``, or a ``calibrate`` tree put there) -> {the port's
    conv module name: {leaf: tensor}}, through the model's bridge
    ``state_dict_from_jax`` (e.g. `yolov3_state_dict_from_jax`). ``w_q``
    becomes OIHW int8, every other leaf a float32 tensor."""
    merged = {**variables, "params": _merge_leaves(variables["params"],
                                                   variables.get(collection, {}))}
    out: dict[str, dict[str, torch.Tensor]] = {}
    for key, v in state_dict_from_jax(merged).items():
        if ".quant." in key:
            name, leaf = key.split(".quant.")
            out.setdefault(name, {})[leaf] = v
    return out


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


# ---------------------------------------------------------------------------
# The bridges run backwards: which JAX variable each port key is read from
# ---------------------------------------------------------------------------
class _Probe(Mapping):
    """A stand-in for the JAX variables that a bridge reads. Every key exists
    when indexed; ``key in probe`` is answered from `_Trace.answers` (the
    search's current guess of the tree's shape). Read as a leaf, a probe is
    a one-element float32 array holding its leaf number, so each tensor the
    bridge builds carries the numbers of the leaves it was made from."""

    def __init__(self, trace: "_Trace", path: tuple):
        self._trace, self._path = trace, path

    def __getitem__(self, key):
        return _Probe(self._trace, self._path + (key,))

    def get(self, key, default=None):
        return self[key]

    def __contains__(self, key) -> bool:
        return self._trace.answer(self._path + (key,))

    def __iter__(self):
        return iter(())

    def __len__(self) -> int:
        return 0

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        self._trace.leaves.append("/".join(map(str, self._path)))
        return np.full(1, len(self._trace.leaves), np.float32)

    def transpose(self, *axes):
        return self

    def reshape(self, *shape, **kw):
        return self

    T = property(lambda self: self)
    shape = (1, 1, 1, 1)


class _Trace:
    """One run of a bridge over a `_Probe`: the ``in`` queries it asked, in
    order (a query not in ``answers`` is answered False and added), and the
    leaves it read."""

    def __init__(self, answers: dict):
        self.answers, self.asked, self.leaves = answers, [], []

    def answer(self, query: tuple) -> bool:
        self.asked.append(query)
        return self.answers.setdefault(query, False)


def _run(bridge: Callable, answers: dict, port_keys: frozenset):
    """-> ({port key: its JAX leaf paths} or None when the guess is wrong: the
    bridge failed or built a key the model lacks, the queries asked)."""
    trace = _Trace(answers)
    try:
        out = bridge(_Probe(trace, ()))
    except (KeyError, TypeError, ValueError, AttributeError, IndexError):
        return None, trace.asked  # a wrong guess fails in the bridge's own way
    if not set(out) <= port_keys:
        return None, trace.asked
    paths = {k: tuple(trace.leaves[int(i) - 1] for i in v.reshape(-1).tolist())
             for k, v in out.items() if v.is_floating_point()}
    return paths, list(dict.fromkeys(trace.asked))


def _flip(bridge: Callable, answers: dict, query: tuple, n: int, port_keys: frozenset,
          depth: int):
    """``answers`` with ``query`` True, when that builds more than ``n`` of
    the model's keys; a query that builds nothing by itself (a block whose
    convs are asked for inside it) is given ``depth`` more of the queries it
    opens. -> (answers, paths, asked) or None."""
    trial = {**answers, query: True}
    paths, asked = _run(bridge, trial, port_keys)
    if paths is None:
        return None
    if len(paths) > n:
        return trial, paths, asked
    for q in asked if depth else ():
        if q not in answers and q != query:
            found = _flip(bridge, trial, q, n, port_keys, depth - 1)
            if found:
                return found
    return None


def _search(bridge: Callable, port_keys: frozenset) -> dict | None:
    """Find the JAX tree's shape that the bridge maps onto ``port_keys``:
    start with every ``in`` query False, then turn each query True, in the
    order asked, where that builds more of the model's keys and none it
    lacks. -> {port key: JAX leaf paths}, or None if the bridge builds a
    key the model lacks whatever the answers."""
    answers: dict = {}
    best, asked = _run(bridge, answers, port_keys)
    if best is None:
        return None
    tried = set()
    while True:
        query = next((q for q in asked if not answers[q] and q not in tried), None)
        if query is None:
            return best
        tried.add(query)
        found = _flip(bridge, answers, query, len(best), port_keys, depth=2)
        if found:
            answers, best, asked = found


BRIDGES = (yolov3_state_dict_from_jax, faster_rcnn_state_dict_from_jax,
           resnet_state_dict_from_jax, vgg_state_dict_from_jax,
           darknet53_classifier_state_dict_from_jax, darknet53_state_dict_from_jax,
           vit_state_dict_from_jax, c3d_state_dict_from_jax, resnet3d_state_dict_from_jax,
           slowfast_state_dict_from_jax)


@functools.lru_cache(maxsize=16)
def _paths_for(port_keys: frozenset) -> dict:
    found = [p for p in (_search(b, port_keys) for b in BRIDGES) if p]
    return max(found, key=len) if found else {}


def jax_paths(model: nn.Module) -> dict[str, tuple[str, ...]]:
    """Each ``state_dict`` key of ``model`` -> the "/"-joined paths of the
    JAX package's variables that its bridge (the one of `BRIDGES` that
    builds the most of the model's keys) reads it from, e.g.
    ``backbone.conv0.conv.weight`` -> ``("params/backbone/stem/conv/kernel",)``;
    ViT's ``qkv`` weight has three. Found by running the bridges over
    stand-in variables, so the names come from the bridges alone. Keys no
    bridge builds (``num_batches_tracked``), and every key of a model no
    bridge maps, have no entry (C3D's: its bridge reshapes fc6 by the
    kernel's values, which a stand-in does not have)."""
    return _paths_for(frozenset(model.state_dict()))


def jax_module_path(paths: Mapping[str, tuple[str, ...]], conv: str) -> str | None:
    """The JAX ConvBN path (``backbone/stem``) of the port conv module named
    ``conv`` (``backbone.conv0.conv``), from `jax_paths`: its kernel's path
    without ``params/`` and ``/conv/kernel``; None when it has none."""
    for p in paths.get(f"{conv}.weight", ()):
        if p.startswith("params/") and p.endswith("/conv/kernel"):
            return p[len("params/"):-len("/conv/kernel")]
    return None
