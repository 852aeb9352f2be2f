"""The port's int8 w8a8 post-training quantization against the JAX package's
(fastvision_tpu/infer/quantize.py and the ConvBN int8 forward), on the CPU.

- The int8 conv: the card route (int8 patches + ``torch._int_mm``, which
  runs on the CPU too), the plain version (float64 conv) and JAX's
  ``lax.conv_general_dilated(..., preferred_element_type=int32)`` give
  bit-equal int32 accumulators on `testing.INT8_CONV_CASES`.
- ``quantize_variables`` from the same float weights and the same
  calibration tree (JAX's, carried across by `models.quant_state_from_jax`)
  is bit-equal to JAX's (w_q, w_scale, bias, in_scale) on a small YOLOv3, a
  small ResNeXt (32 groups), a BN-free VGG and a small Faster R-CNN;
  ``calibrate`` on the same inputs gives amax and q999 within 1e-5
  relative (torch.quantile and jnp.quantile interpolate in float32 in their
  own order; the float convs before a layer differ by ~1e-7).
- With the int8 state carried across, the whole quantized YOLOv3's heads
  agree with JAX's within 1e-3 of their std (the int32 sums are exact on
  both sides; the float pred convs and the float epilogue's rounding are
  not bit-equal between the packages, and a flipped rounding of an
  activation moves a value by one int8 step), and the Detector's boxes as
  the float path's parity tests hold them. ``Detector.quantize`` on both
  sides gives the same int8 weights, in_scales within 1e-5 relative and the
  same boxes as sets (`test_detector_quantize_matches_jax` says why not
  one by one).
- Each case of tests/test_quantize.py has its counterpart here, and the
  CLI's ``eval --int8`` / ``serve --int8``.
"""
import copy
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import fastvision_tpu.infer.quantize as jq
import fastvision_tpu_torch.cli as cli
import fastvision_tpu_torch.infer.quantize as tq
from fastvision_tpu.infer import Detector as JaxDetector
from fastvision_tpu.models import classification as jz
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu.nn.layers import ConvBN as JaxConvBN
from fastvision_tpu_torch.infer import Detector
from fastvision_tpu_torch.models import FasterRCNN, YOLOv3, import_jax, quant_state_from_jax
from fastvision_tpu_torch.models import classification as tz
from fastvision_tpu_torch.nn.layers import ConvBN
from fastvision_tpu_torch.ops import int8 as ti
from fastvision_tpu_torch.testing import INT8_CONV_CASES, int8_conv_case, write_detection_dataset
from test_torch_models import _randomize_bn

jfr = importlib.import_module("fastvision_tpu.models.detection.faster_rcnn")
tfr = importlib.import_module("fastvision_tpu_torch.models.detection.faster_rcnn")
torch.set_num_threads(2)
C, SIZE = 3, 64
ANCHORS = (np.array([[[32, 32], [40, 24], [24, 40]]] * 3, np.float32)
           / np.array([1, 1.6, 2.5], np.float32)[:, None, None])
LEAVES = ("w_q", "w_scale", "in_scale", "bias")
FRCNN_CFG = dict(num_classes=3, image_size=SIZE, rpn_pre_nms_train=32, rpn_post_nms_train=8,
                 rpn_pre_nms_eval=32, rpn_post_nms_eval=8, roi_pos=2, roi_neg=6)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / b.std())


# ---------------------------------------------------------------- the int8 conv
def _jax_conv(x, w, stride, padding, groups):
    y = lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)),
        (stride, stride), ((padding, padding), (padding, padding)),
        feature_group_count=groups, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("case", INT8_CONV_CASES, ids=[c[0] for c in INT8_CONV_CASES])
def test_int8_conv_routes_bit_equal_to_jax(case):
    name, _, _, _, _, n, k, stride, groups = case
    x, w = int8_conv_case(case)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    mat = ti.gemm_weight(wt, groups)
    assert mat.shape[0] % 8 == 0 and mat.shape[1] % 8 == 0 and mat.shape[1] >= k * k * x.shape[1]
    card = ti.int8_conv2d_gemm(xt.contiguous(memory_format=torch.channels_last), mat, n, k,
                               stride, k // 2)
    plain = ti.int8_conv2d_plain(xt, wt, stride, k // 2, groups)
    want = _jax_conv(x, w, stride, k // 2, groups)
    assert card.dtype == plain.dtype == torch.int32 and card.shape == want.shape
    np.testing.assert_array_equal(card.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert np.abs(want).max() > 2 ** 15  # past int16: the sums need the int32 accumulator
    # on CPU tensors the dispatcher takes the plain version
    np.testing.assert_array_equal(ti.int8_conv2d(xt, wt, stride, k // 2, groups).numpy(), want)


def test_int8_conv_refuses_float_inputs():
    x, w = int8_conv_case(INT8_CONV_CASES[0])
    with pytest.raises(TypeError, match="int8"):
        ti.int8_conv2d(torch.from_numpy(x).float(), torch.from_numpy(w))


def test_quantize_activation_and_epilogue_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 3, (2, 5, 4, 6)).astype(np.float32))
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 1e4]  # halves round to even; the tail clips
    s = np.float32(0.5)
    got = ti.quantize_activation(torch.from_numpy(x), torch.tensor(s))
    want = np.clip(np.round(np.asarray(jnp.asarray(x) / s)), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 0, :4].tolist() == [1, 3, -5, 127]
    acc = rng.integers(-2 ** 28, 2 ** 28, (2, 5, 4, 6)).astype(np.int32)
    scale, bias = rng.uniform(1e-6, 1e-4, 5).astype(np.float32), rng.normal(0, 1, 5).astype(
        np.float32)
    acc2 = acc.transpose(0, 2, 3, 1).reshape(-1, 5)
    y = ti.epilogue(torch.from_numpy(acc2), 5, torch.from_numpy(scale), torch.from_numpy(bias),
                    "leaky_relu", torch.float32)
    ja = np.asarray(jax.nn.leaky_relu(jnp.asarray(acc2).astype(jnp.float32) * scale + bias, 0.1))
    np.testing.assert_array_equal(y.numpy(), ja)
    # the patches of a float input: quantized, then gathered as the int8 ones
    xn = torch.from_numpy(x).permute(0, 2, 3, 1)
    got = ti.quantize_patches(xn, torch.tensor(s), 3, 2, 1, 48)
    want = ti.conv_patches(ti.quantize_activation(xn, torch.tensor(s)), 3, 2, 1, 48)
    assert got.shape == (2 * 2 * 3, 48) and torch.equal(got, want)
    assert not got[:, 45:].any()  # zero past K = 9 * 5


# ---------------------------------------------------------------- models on both sides
def _random_variables(jm, seed, *args, **kw):
    """He-normal kernels, small biases and BN drawn away from identity for
    the JAX model ``jm`` (shapes from ``jax.eval_shape``: no compile)."""
    rngs = {"params": jax.random.key(0), "sampling": jax.random.key(1),
            "dropout": jax.random.key(2)}
    shapes = jax.eval_shape(lambda: jm.init(rngs, *args, **kw))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key == "kernel":
            return rng.normal(0, np.sqrt(2.0 / np.prod(s.shape[:-1])), s.shape).astype(np.float32)
        return rng.normal(0, 0.05, s.shape).astype(np.float32)

    v = {c: jax.tree_util.tree_map_with_path(leaf, shapes[c])
         for c in ("params", "batch_stats") if c in shapes}
    return _randomize_bn(v, seed + 1) if "batch_stats" in v else v


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


def _yolo_pair():
    jm = JaxYOLOv3(num_classes=C,
                   backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
    return jm, YOLOv3(num_classes=C, stage_sizes=(1, 1, 1, 1, 1)), import_jax.yolov3_state_dict_from_jax


def _resnext_pair():
    kw = dict(num_classes=10, groups=32, base_width=4)
    return (jz.ResNet(jz.resnet.Bottleneck, (1, 1, 1, 1), **kw),
            tz.ResNet(tz.Bottleneck, (1, 1, 1, 1), **kw), import_jax.resnet_state_dict_from_jax)


def _vgg_pair():
    cfg = (8, "M", 16, 16, "M")
    return (jz.VGG(cfg, batch_norm=False, including_top=False),
            tz.VGG(cfg, batch_norm=False, including_top=False), import_jax.vgg_state_dict_from_jax)


def _frcnn_pair():
    """Both with a 64-wide head MLP (the 4096-wide one is 0.4 GB); the JAX
    model builds its head when it runs: `built` patches it meanwhile."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfr, "FastHead", functools.partial(tfr.FastHead, hidden=64))
        return (jfr.FasterRCNN(**FRCNN_CFG), FasterRCNN(**FRCNN_CFG),
                import_jax.faster_rcnn_state_dict_from_jax)


PAIRS = {"yolov3": _yolo_pair, "resnext": _resnext_pair, "vgg_bn_free": _vgg_pair,
         "faster_rcnn": _frcnn_pair}


@pytest.fixture(scope="module")
def built():
    """name -> (JAX model, variables, the port's float model with the same
    weights, bridge, NHWC input, the port's input, JAX's calibration tree)."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jfr, "FastHead", functools.partial(jfr.FastHead, hidden=64))
    for i, (name, make) in enumerate(PAIRS.items()):
        jm, tm, bridge = make()
        x = np.random.default_rng(10 + i).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
        if name == "faster_rcnn":
            labels = jnp.asarray([[[0, 10, 10, 40, 40]]], jnp.float32)
            v = _random_variables(jm, 20 + i, jnp.zeros((1, SIZE, SIZE, 3)), labels, train=True)
        else:
            v = _random_variables(jm, 20 + i, jnp.zeros((1, SIZE, SIZE, 3)), train=False)
        tm.load_state_dict(bridge(v), strict=True)
        tm.eval()
        tx = torch.from_numpy(x)
        if name == "vgg_bn_free":  # the port's trunk takes NCHW
            tx = tx.permute(0, 3, 1, 2)
        calib = jq.calibrate(jm, v, [jnp.asarray(x)])
        out[name] = (jm, v, tm, bridge, x, tx, calib)
    mp.undo()
    return out


@pytest.mark.parametrize("percentile", [False, True], ids=["absmax", "percentile"])
@pytest.mark.parametrize("name", list(PAIRS))
def test_quantize_variables_bit_equal_to_jax(built, name, percentile):
    jm, v, tm, bridge, _, _, calib = built[name]
    want = quant_state_from_jax(jq.quantize_variables(v, calib, percentile=percentile), bridge)
    port_calib = quant_state_from_jax({**v, "quant_calib": calib}, bridge, "quant_calib")
    model = copy.deepcopy(tm)
    tq.quantize_variables(model, port_calib, percentile=percentile)
    got = tq.quant_state(model)
    assert sorted(got) == sorted(want) and len(got) >= 3
    for conv, leaves in want.items():
        for leaf in LEAVES:
            g, w = got[conv][leaf], leaves[leaf]
            assert g.dtype == w.dtype and g.shape == w.shape, (conv, leaf)
            assert torch.equal(g, w), (conv, leaf, float((g.double() - w.double()).abs().max()))
    if name == "faster_rcnn":  # the backbone quantizes, the RPN's plain conv does not
        assert all(k.startswith("backbone.") for k in got)
        assert len(got) == len(model.backbone.cfg) - model.backbone.cfg.count("M")


@pytest.mark.parametrize("name", list(PAIRS))
def test_calibrate_matches_jax(built, name):
    _, v, tm, bridge, _, tx, calib = built[name]
    want = quant_state_from_jax({**v, "quant_calib": calib}, bridge, "quant_calib")
    got = tq.calibrate(tm, [tx])
    assert sorted(got) == sorted(want)
    for conv in want:
        for key in ("amax", "q999"):
            g, w = float(got[conv][key]), float(want[conv][key])
            assert abs(g - w) <= 1e-5 * abs(w), (conv, key, g, w)
    # running maxima over batches: a second, scaled batch raises every amax
    two = tq.calibrate(tm, [tx, tx * 3])
    assert all(float(two[k]["amax"]) >= float(got[k]["amax"]) for k in got)


def test_whole_quantized_yolov3_matches_jax(built):
    jm, v, tm, bridge, x, tx, calib = built["yolov3"]
    qv = jq.quantize_variables(v, calib)
    model = copy.deepcopy(tm)
    tq.install_quant(model, quant_state_from_jax(qv, bridge))
    with torch.no_grad():
        got = [h.numpy() for h in model(tx)]
    want = jm.apply(qv, jnp.asarray(x), train=False)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2, 4).reshape(g.shape) if w.shape != g.shape \
            else np.asarray(w)
        assert _rel(g, w) <= 1e-3
    # and the int8 model is not the float one
    with torch.no_grad():
        flt = [h.numpy() for h in tm(tx)]
    assert max(_rel(g, f) for g, f in zip(got, flt)) > 1e-3


def same_results(got, want, box_tol=1e-2, score_tol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g["boxes"]) == len(w["boxes"]) > 0
        np.testing.assert_array_equal(g["classes"], np.asarray(w["classes"]))
        assert np.abs(g["boxes"] - np.asarray(w["boxes"])).max() <= box_tol
        assert np.abs(g["scores"] - np.asarray(w["scores"])).max() <= score_tol


def _images(n=3, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((64, 64), (48, 64), (64, 40))[:n]]


def test_quantized_detector_predict_batch_matches_jax(built):
    jm, v, tm, bridge, *_ , calib = built["yolov3"]
    qv = jq.quantize_variables(v, calib)
    model = copy.deepcopy(tm)
    tq.install_quant(model, quant_state_from_jax(qv, bridge))
    kw = dict(input_size=SIZE, batch_size=2, conf_thres=0.05)
    tdet = Detector(model, ANCHORS, device="cpu", dtype=torch.float32, **kw)
    jdet = JaxDetector(jm, qv, ANCHORS, dtype=jnp.float32, **kw)
    same_results(tdet.predict_batch(_images()), jdet.predict_batch(_images()))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_detection_dataset(str(tmp_path_factory.mktemp("quantize")), 4,
                                   sizes=((64, 64), (48, 64), (64, 40)), seed=3, num_classes=C)


def test_detector_quantize_matches_jax(built, root):
    """Both packages calibrate their own float models on the same files.
    The fold and the weights are bit-equal; each in_scale is within 1e-5
    relative (the float forwards that calibrate differ by ~1e-7, so most
    in_scales differ in their last bit, 3e-6 at most here). A last-bit scale
    flips a few roundings, which this random-weight net amplifies, and NMS
    over ~230 near-tied boxes an image reorders: the boxes are held as sets,
    counts within 3% and >= 75% of each side's boxes matched by one of the
    same class at IoU > 0.9 on the other."""
    from fastvision_tpu_torch.ops import box_iou_matrix

    jm, v, tm, bridge, *_ = built["yolov3"]
    kw = dict(input_size=SIZE, batch_size=2, conf_thres=0.05)
    tdet = Detector(copy.deepcopy(tm), ANCHORS, device="cpu", dtype=torch.float32, **kw)
    jdet = JaxDetector(jm, v, ANCHORS, dtype=jnp.float32, **kw)
    images = sorted(os.path.join(root, "val", "images", f)
                    for f in os.listdir(os.path.join(root, "val", "images")))
    tdet.quantize(images[:2])
    jdet.quantize(images[:2])
    got, want = tq.quant_state(tdet.model), quant_state_from_jax(jdet.variables, bridge)
    assert sorted(got) == sorted(want) and len(got) == 36
    for conv, leaves in want.items():
        for leaf in ("w_q", "w_scale", "bias"):
            assert torch.equal(got[conv][leaf], leaves[leaf]), (conv, leaf)
        g, w = float(got[conv]["in_scale"]), float(leaves["in_scale"])
        assert abs(g - w) <= 1e-5 * w, (conv, g, w)
    for g, w in zip(tdet.predict_batch(images), jdet.predict_batch(images)):
        wb = np.asarray(w["boxes"])
        assert abs(len(g["boxes"]) - len(wb)) <= 0.03 * len(wb) and len(wb) > 0
        hit = ((box_iou_matrix(torch.from_numpy(g["boxes"]), torch.from_numpy(wb)).numpy() > 0.9)
               & (g["classes"][:, None] == np.asarray(w["classes"])[None, :]))
        assert hit.any(1).mean() >= 0.75 and hit.any(0).mean() >= 0.75


# ---------------------------------------------------------------- tests/test_quantize.py
def _randomized_convbn(seed, features=16, kernel_size=3, cin=8, act="silu", use_bn=True):
    """The port's ConvBN with non-trivial BN (folding is tested) and its input."""
    g = torch.Generator().manual_seed(seed)
    m = ConvBN(cin, features, kernel_size, act=act, use_bn=use_bn)
    if use_bn:
        with torch.no_grad():
            m.bn.weight.copy_(torch.rand(features, generator=g) * 1.5 + 0.5)
            m.bn.bias.copy_(torch.randn(features, generator=g) * 0.3)
            m.bn.running_mean.copy_(torch.randn(features, generator=g) * 0.2)
            m.bn.running_var.copy_(torch.rand(features, generator=g) * 1.2 + 0.3)
    return m.eval(), torch.randn(2, cin, 16, 16, generator=g)


def _err(out, ref) -> float:
    return float((out - ref).abs().max() / (ref.abs().max() + 1e-9))


def _corr(a, b) -> float:
    return float(np.corrcoef(a.detach().numpy().ravel(), b.detach().numpy().ravel())[0, 1])


@torch.no_grad()
def test_single_convbn_int8_close_to_float_and_to_jax():
    m, x = _randomized_convbn(1)
    ref = m(x)
    tq.quantize_model(m, [x])
    out = m(x)
    assert _err(out, ref) < 0.05 and _corr(ref, out) > 0.999
    # the JAX ConvBN with the port's weights and the port's int8 state
    jm = JaxConvBN(16, kernel_size=3, act="silu")
    sd = {f"m.{k}": v.numpy() for k, v in m.state_dict().items()}
    jv = {"params": {"conv": {"kernel": sd["m.conv.weight"].transpose(2, 3, 1, 0)},
                     "bn": {"bn": {"scale": sd["m.bn.weight"], "bias": sd["m.bn.bias"]}}},
          "batch_stats": {"bn": {"bn": {"mean": sd["m.bn.running_mean"],
                                        "var": sd["m.bn.running_var"]}}}}
    q = tq.quant_state(m)["conv"]
    jv["quant"] = {"w_q": q["w_q"].numpy().transpose(2, 3, 1, 0), "w_scale": q["w_scale"].numpy(),
                   "in_scale": q["in_scale"].numpy(), "bias": q["bias"].numpy()}
    want = np.asarray(jm.apply(jv, jnp.asarray(x.permute(0, 2, 3, 1).numpy()), train=False))
    assert np.abs(out.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-5 * np.abs(want).max()


@torch.no_grad()
def test_quant_path_actually_int8():
    """A huge in_scale quantizes every input to 0: the output is act(bias)."""
    m, x = _randomized_convbn(2)
    tq.quantize_model(m, [x])
    m.conv.quant.in_scale.fill_(1e9)
    out = m(x)
    expect = torch.nn.functional.silu(m.conv.quant.bias.view(1, -1, 1, 1).expand_as(out))
    assert torch.allclose(out, expect, atol=1e-5)


def test_train_mode_ignores_quant():
    m, x = _randomized_convbn(3)
    ref_model = copy.deepcopy(m)
    tq.quantize_model(m, [x])
    m.train(), ref_model.train()
    assert torch.allclose(m(x), ref_model(x), rtol=1e-6)
    assert torch.equal(m.bn.running_mean, ref_model.bn.running_mean)  # BN stats moved alike


@torch.no_grad()
def test_stacked_convbn_error_bounded():
    stack = torch.nn.Sequential()
    stack.add_module("c1", ConvBN(3, 16, 3))
    stack.add_module("c2", ConvBN(16, 32, 3, strides=2))
    stack.add_module("c3", ConvBN(32, 32, 1))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    _adapt_bn(stack, x)
    ref = stack(x)
    tq.quantize_model(stack, [x])
    assert sorted(tq.quant_state(stack)) == ["c1.conv", "c2.conv", "c3.conv"]
    out = stack(x)
    assert _err(out, ref) < 0.08 and _corr(ref, out) > 0.995


def _adapt_bn(model, x, passes=25):
    """Running BN statistics converged onto x's (momentum 0.1: ~8% residual
    after 25 passes), as in the JAX test: quantization assumes statistics
    that match the data."""
    model.train()
    with torch.no_grad():
        for _ in range(passes):
            model(x)
    model.eval()


def test_skip_filters_paths_and_quantized_state_dict_loads_into_float():
    stack = torch.nn.Sequential()
    stack.add_module("stem", ConvBN(3, 8, 3))
    stack.add_module("body", ConvBN(8, 8, 3))
    x = torch.randn(1, 3, 8, 8, generator=torch.Generator().manual_seed(5))
    tq.quantize_model(stack, [x], skip=("stem",))
    assert sorted(tq.quant_state(stack)) == ["body.conv"]
    # the int8 state stays out of the state_dict: it loads into a float model
    sd = stack.state_dict()
    assert not any("quant" in k for k in sd)
    fresh = torch.nn.Sequential()
    fresh.add_module("stem", ConvBN(3, 8, 3))
    fresh.add_module("body", ConvBN(8, 8, 3))
    fresh.load_state_dict(sd, strict=True)
    # re-quantizing replaces the whole state: nothing skipped now
    tq.quantize_variables(stack, tq.calibrate(fresh, [x]))
    assert sorted(tq.quant_state(stack)) == ["body.conv", "stem.conv"]


def test_missing_calibration_raises():
    m, x = _randomized_convbn(6)
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate(m, [])
    with pytest.raises(ValueError, match="no calibration absmax for ConvBN at 'conv'"):
        tq.quantize_variables(m, {"amax_wrong": {"amax": torch.tensor(1.0)}})
    with pytest.raises(KeyError, match="does not have"):
        tq.install_quant(m, {"nope.conv": {}})


@torch.no_grad()
def test_bn_free_convbn_quantizes():
    m, x = _randomized_convbn(11, act="relu", use_bn=False)
    ref = m(x)
    tq.quantize_model(m, [x])
    assert torch.equal(tq.quant_state(m)["conv"]["bias"], m.conv.bias)  # nothing to fold
    assert _err(m(x), ref) < 0.05
    # a BN-free ConvBN that was not calibrated stays float, as in JAX
    with pytest.raises(ValueError, match="no ConvBN"):
        tq.quantize_variables(copy.deepcopy(m), {})


@torch.no_grad()
def test_faster_rcnn_quantizes_backbone_not_rpn():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfr, "FastHead", functools.partial(tfr.FastHead, hidden=64))
        model = FasterRCNN(**FRCNN_CFG).eval()
    x = torch.zeros(1, SIZE, SIZE, 3)
    tq.quantize_model(model, [x])
    names = sorted(tq.quant_state(model))
    assert names and all(n.startswith("backbone.") for n in names)
    assert "quant" not in model.rpn.conv._modules
    out = model(x)
    assert all(bool(torch.isfinite(t).all()) for t in out if t.is_floating_point())


def test_detector_quantize_in_place():
    model = YOLOv3(num_classes=4, generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(9))
    _adapt_bn(model, x, passes=10)
    anchors = (np.asarray(ANCHORS) * 2).astype(np.float32)
    det = Detector(model, anchors, input_size=128, batch_size=1, conf_thres=0.01,
                   dtype=torch.float32, device="cpu")
    img = np.random.default_rng(2).integers(0, 255, (160, 200, 3), np.uint8)
    before = det.predict_image(img)
    det.quantize([img])
    assert len(tq.quant_state(det.model)) == 72  # Darknet-53's 52 + the neck's 20
    after = det.predict_image(img)
    assert np.isfinite(after["boxes"]).all()
    assert abs(len(before["boxes"]) - len(after["boxes"])) <= max(5, len(before["boxes"]) // 2)


@torch.no_grad()
def test_yolov3_full_quantization_runs(built):
    tm, tx = built["yolov3"][2], built["yolov3"][5]
    model = copy.deepcopy(tm)
    tq.quantize_model(model, [tx])
    assert len(tq.quant_state(model)) == 36  # one block a stage: 16 + the neck's 20
    ref, out = tm(tx), model(tx)
    for r, o in zip(ref, out):
        assert o.shape == r.shape and bool(torch.isfinite(o).all())
    assert _corr(ref[0], out[0]) > 0.98


@torch.no_grad()
def test_percentile_calibration_clips_outliers():
    m, x = _randomized_convbn(5)
    x_out = x.clone()
    x_out[0, 0, 0, 0] = 500.0
    calib = tq.calibrate(m, [x_out])
    q_abs, q_pct = copy.deepcopy(m), copy.deepcopy(m)
    tq.quantize_variables(q_abs, calib)
    tq.quantize_variables(q_pct, calib, percentile=True)
    s_abs, s_pct = (float(q.conv.quant.in_scale) for q in (q_abs, q_pct))
    assert s_pct < s_abs / 10
    ref = m(x)
    assert float((q_pct(x) - ref).abs().mean()) < float((q_abs(x) - ref).abs().mean())


@pytest.mark.parametrize("name", ["slowfast", "vit"])
def test_models_without_2d_convbn_refuse_in_both_packages(name):
    from fastvision_tpu.models import video as jvid
    from fastvision_tpu_torch.models import video as tvid

    if name == "slowfast":
        jm = jvid.SlowFast((1, 1, 1, 1), alpha=4, beta_inv=4, expansion=1, num_classes=5)
        tm = tvid.SlowFast((1, 1, 1, 1), alpha=4, beta_inv=4, expansion=1, num_classes=5)
        x = jnp.zeros((1, 8, 32, 32, 3))
    else:
        jm = jz.ViT(patch=16, dim=32, depth=1, heads=2, num_classes=5)
        tm = tz.ViT(patch=16, dim=32, depth=1, heads=2, num_classes=5, image_size=32)
        x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x, train=False))
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    with pytest.raises(ValueError, match="no ConvBN\\+BN blocks found"):
        jq.quantize_variables(v, {})
    assert list(tq.calibrate(tm.eval(), [torch.zeros(x.shape)])) == []
    with pytest.raises(ValueError, match="no ConvBN\\+BN blocks found"):
        tq.quantize_variables(tm, {})


def test_int8_output_dtype_follows_autocast():
    m, x = _randomized_convbn(7)
    tq.quantize_model(m, [x])
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        y = m(x)
    assert y.dtype == torch.bfloat16
    with torch.no_grad():
        assert m(x).dtype == torch.float32
        assert float((y.float() - m(x)).abs().max()) <= 0.02 * float(m(x).abs().max())


# ---------------------------------------------------------------- CLI
def _small_yolo(cfg):
    return YOLOv3(num_classes=cfg.model.num_classes, channels=(128, 64, 32),
                  stage_sizes=(1, 1, 1, 1, 1),
                  generator=torch.Generator().manual_seed(cfg.train.seed))


@pytest.mark.parametrize("percentile", [False, True], ids=["absmax", "percentile"])
def test_cli_eval_int8_reaches_detector_quantize(root, monkeypatch, capsys, percentile):
    monkeypatch.setattr(cli, "_build_yolo", _small_yolo)
    calls = []
    real = Detector.quantize

    def recording(self, images, skip=(), percentile=False):
        calls.append((len(images), percentile))
        real(self, images, skip, percentile)
        calls.append(len(tq.quant_state(self.model)))

    monkeypatch.setattr(Detector, "quantize", recording)
    argv = ["eval", "--int8", f"data.data_root={root}", f"data.input_size={SIZE}",
            f"model.num_classes={C}", "data.num_workers=0", "train.bf16=false", "--device", "cpu"]
    res = cli.main(argv + (["--int8-percentile"] if percentile else []))
    assert calls == [(4, percentile), 36] and res["images"] == 4
    kind = "99.9th-percentile" if percentile else "absmax"
    assert f"int8: quantized with 4 calibration images ({kind})" in capsys.readouterr().out


def test_cli_serve_int8_calib_dir(root, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cli, "_build_yolo", _small_yolo)
    served = []
    serving = importlib.import_module("fastvision_tpu_torch.infer.serving")
    monkeypatch.setattr(serving, "serve", lambda service, **kw: served.append(service))
    common = [f"data.input_size={SIZE}", f"model.num_classes={C}", "train.bf16=false",
              "--device", "cpu"]
    cli.main(["serve", "--int8", "--calib-dir", os.path.join(root, "val", "images"), *common])
    (service,) = served
    assert len(tq.quant_state(service.detector.model)) == 36
    assert "int8: quantized with 4 calibration images" in capsys.readouterr().out
    res = service.detector.predict_batch(_images(2))
    assert len(res) == 2 and all(np.isfinite(r["boxes"]).all() for r in res)
    # without --calib-dir: the val split of the config's dataset
    cli.main(["serve", "--int8", f"data.data_root={root}", *common])
    assert len(served) == 2 and "(absmax)" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="contains no images"):
        cli.main(["serve", "--int8", "--calib-dir", str(empty), *common])
    with pytest.raises(SystemExit, match="int8 serving needs calibration images"):
        cli.main(["serve", "--int8", f"data.data_root={tmp_path / 'none'}", *common])


@pytest.mark.parametrize("task", ["cls", "video"])
def test_cli_eval_int8_refuses_classifiers_and_export_int8_stays_unported(task):
    with pytest.raises(SystemExit, match=f"eval --task {task}: --int8 quantizes the detector"):
        cli.main(["eval", "--task", task, "--int8", "--device", "cpu"])
    with pytest.raises(SystemExit, match="export --int8 is detector-only"):
        cli.main(["export", "--task", task, "--int8", "--out", "x.pt2"])
