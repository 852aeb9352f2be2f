"""Options that name layers by path select the same layers in both packages.

``quantize_variables(skip=)`` and ``model.freeze`` (``trainable_mask``) take
substrings of parameter paths. The JAX package matches them against its
flax paths (``backbone/stem``), the port against its module names
(``backbone.conv0.conv``) and, through `models.import_jax.jax_paths`, against
the JAX path of the same layer. So one list, run through both packages on
the CPU, must quantize or freeze the same layers: YOLOv3 (4 classes, 64
px), Faster R-CNN and a ResNet.

Which port layer a JAX leaf is, is read here from the model's bridge run on
marked variables (`quant_state_from_jax` for the quantized convs, a 0/1
fill of the parameters for the frozen leaves), not from `jax_paths`.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.core.checkpoint as jck
import fastvision_tpu.infer.quantize as jq
import fastvision_tpu_torch.core.checkpoint as tck
import fastvision_tpu_torch.infer.quantize as tq
from fastvision_tpu.models import classification as jz
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu_torch.models import FasterRCNN, YOLOv3, import_jax, quant_state_from_jax
from fastvision_tpu_torch.models import classification as tz
from fastvision_tpu_torch.nn.layers import conv_bn_pairs

jfr = importlib.import_module("fastvision_tpu.models.detection.faster_rcnn")
tfr = importlib.import_module("fastvision_tpu_torch.models.detection.faster_rcnn")
SIZE = 64
FRCNN_CFG = dict(num_classes=3, image_size=SIZE, rpn_pre_nms_train=32, rpn_post_nms_train=8,
                 rpn_pre_nms_eval=32, rpn_post_nms_eval=8, roi_pos=2, roi_neg=6)
SKIPS = [("stem",)]  # the lists ROADMAP measured; "rpn/conv" tells the two apart on FRCNN
FREEZES = [["backbone/stem"], ["stem"], ["neck/out0"], ["backbone"], ["rpn/conv"]]


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


def _yolo():
    jm = JaxYOLOv3(num_classes=4,
                   backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
    return (jm, YOLOv3(num_classes=4, stage_sizes=(1, 1, 1, 1, 1)),
            import_jax.yolov3_state_dict_from_jax, (jnp.zeros((1, SIZE, SIZE, 3)),))


def _frcnn():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfr, "FastHead", functools.partial(tfr.FastHead, hidden=64))
        tm = FasterRCNN(**FRCNN_CFG)
    return (jfr.FasterRCNN(**FRCNN_CFG), tm, import_jax.faster_rcnn_state_dict_from_jax,
            (jnp.zeros((1, SIZE, SIZE, 3)), jnp.asarray([[[0, 10, 10, 40, 40]]], jnp.float32)))


def _resnet():
    return (jz.ResNet(jz.resnet.Bottleneck, (1, 1, 1, 1), num_classes=10),
            tz.ResNet(tz.Bottleneck, (1, 1, 1, 1), num_classes=10),
            import_jax.resnet_state_dict_from_jax, (jnp.zeros((1, SIZE, SIZE, 3)),))


MODELS = {"yolov3": _yolo, "faster_rcnn": _frcnn, "resnet": _resnet}


@pytest.fixture(scope="module")
def built():
    """name -> (JAX variables, JAX calibration tree, the port model carrying
    the same weights, the bridge). Shapes from ``jax.eval_shape``: nothing
    compiles; weights and calibration are seeded numbers."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jfr, "FastHead", functools.partial(jfr.FastHead, hidden=64))
    rng = np.random.default_rng(0)
    for name, make in MODELS.items():
        jm, tm, bridge, args = make()
        rngs = {"params": jax.random.key(0), "sampling": jax.random.key(1),
                "dropout": jax.random.key(2)}
        shapes = jax.eval_shape(lambda: jm.init(rngs, *args, train=name == "faster_rcnn"))
        v = {c: jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
                             shapes[c]) for c in ("params", "batch_stats") if c in shapes}
        calib_shapes = jax.eval_shape(
            lambda: jm.apply(v, args[0], train=False, mutable=["quant_calib"])[1])
        calib = jax.tree.map(lambda s: np.ones(s.shape, np.float32),
                             calib_shapes["quant_calib"])
        tm.load_state_dict(bridge(v), strict=True)
        out[name] = (v, calib, tm.eval(), bridge)
    mp.undo()
    return out


def _port_calib(model):
    one = torch.tensor(1.0)
    return {name: {"amax": one, "q999": one} for name, _, _ in conv_bn_pairs(model)}


@pytest.mark.parametrize("skip", SKIPS, ids=lambda s: "-".join(s))
@pytest.mark.parametrize("name", list(MODELS))
def test_quantize_skip_quantizes_the_same_layers(built, name, skip):
    v, calib, tm, bridge = built[name]
    want = sorted(quant_state_from_jax(jq.quantize_variables(v, calib, skip=skip), bridge))
    tq.quantize_variables(tm, _port_calib(tm), skip=skip)
    got = sorted(tq.quant_state(tm))
    tq.install_quant(tm, {})
    n_pairs = sum(1 for _ in conv_bn_pairs(tm))
    assert got == want and len(got) >= 3
    # "stem" names a layer of YOLOv3 and the ResNet in JAX's paths only
    assert len(got) == n_pairs - (name != "faster_rcnn")


@pytest.mark.parametrize("freeze", FREEZES, ids=lambda f: "-".join(f).replace("/", "."))
@pytest.mark.parametrize("name", list(MODELS))
def test_freeze_freezes_the_same_leaves(built, name, freeze):
    v, _, tm, bridge = built[name]
    mask = jck.trainable_mask(v["params"], freeze)
    marked = {**v, "params": jax.tree.map(lambda p, t: np.full(p.shape, 0.0 if t else 1.0,
                                                              np.float32), v["params"], mask)}
    want = sorted(k for k, t in bridge(marked).items()
                  if k in dict(tm.named_parameters()) and bool(t.all()))
    n_jax = sum(not t for t in jax.tree.leaves(mask))
    got = sorted(k for k, t in tck.trainable_mask(tm, freeze).items() if not t)
    assert got == want and len(got) == n_jax


def test_jax_paths_of_the_bridges():
    """The paths read back from the bridges, spot-checked, and a model no
    bridge maps gets none."""
    paths = import_jax.jax_paths(YOLOv3(num_classes=4, stage_sizes=(1, 1, 1, 1, 1)))
    assert paths["backbone.conv0.conv.weight"] == ("params/backbone/stem/conv/kernel",)
    assert paths["neck.neck_out_small.bn.running_var"] == ("batch_stats/neck/out0/bn/bn/var",)
    assert paths["head.head_out_small.bias"] == ("params/head/pred0/bias",)
    assert "backbone.conv0.bn.num_batches_tracked" not in paths
    assert import_jax.jax_module_path(paths, "backbone.res1.0.conv2.conv") == \
        "backbone/stage1_block0/ConvBN_1"
    res = import_jax.jax_paths(tz.ResNet(tz.Bottleneck, (1, 1, 1, 1), num_classes=10))
    assert res["layer2.0.downsample.0.weight"] == ("params/stage2_block0/downsample/conv/kernel",)
    assert import_jax.jax_paths(torch.nn.Linear(3, 4)) == {}
