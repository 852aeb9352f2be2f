"""The port's Faster R-CNN against the JAX package's on the CPU, float32:
a small configuration of the full-width model (3 classes, 128 px, anchor
scales (2, 4, 6), small pre / post-NMS K, as tests/test_faster_rcnn.py
builds it), the JAX model initialised once per module and its weights
bridged with `faster_rcnn_state_dict_from_jax`.

The JAX side's random draws are recorded into the port's: the sampler's
U(0, 1) priorities by monkeypatching the JAX module's `random_sample_mask`
(one draw per call, the same for every image of the batch, since the
sampler runs under ``vmap``), the head's dropout masks by
``flax.linen.intercept_methods`` on ``nn.Dropout``. Nothing in the JAX
package changes.

Tolerances: proposals 1e-4 px from the same RPN outputs, 1e-3 px through
the backbone (the deltas' float32 rounding times anchors up to 96 px); logits, boxes and losses float32 rounding
through 13 convs and the 4096-wide MLP (max|d| <= 1e-4 of the output's std,
losses rtol 1e-5); postprocessed boxes 1e-3 px with the same valid count
and classes; mAP equal to 1e-6; after one SGD step every tensor within
1e-4 of its std or 2e-3 of its largest update (VGG has no BN, so the
gradient noise is far below the YOLOv3 step's).
"""
import importlib
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

import fastvision_tpu.data as jd
import fastvision_tpu.train as jt
import fastvision_tpu_torch.train as tt
from fastvision_tpu.models.import_torch import frcnn_from_reference
from fastvision_tpu_torch.data import DetectionDataset, DetectionLoader
from fastvision_tpu_torch.models import (
    FasterRCNN,
    faster_rcnn_state_dict_from_jax,
    frcnn_state_dict_from_reference,
)
from fastvision_tpu_torch.testing import SyntheticDetectionDataset

jfr = importlib.import_module("fastvision_tpu.models.detection.faster_rcnn")
tfr = importlib.import_module("fastvision_tpu_torch.models.detection.faster_rcnn")
torch.set_num_threads(2)
C, S, B = 3, 128, 2
CFG = dict(num_classes=C, image_size=S, anchor_scales=(2, 4, 6), rpn_pre_nms_train=128,
           rpn_post_nms_train=32, rpn_pre_nms_eval=128, rpn_post_nms_eval=16,
           roi_pos=4, roi_neg=12)
LABELS = np.array([[[0, 20, 20, 80, 90], [2, 60, 60, 120, 120], [-1, 0, 0, 0, 0]],
                   [[1, 10, 50, 60, 110], [-1, 0, 0, 0, 0], [0, 70, 10, 118, 64]]], np.float32)


@pytest.fixture(scope="module")
def variables():
    model = jfr.FasterRCNN(**CFG)
    init = jax.jit(lambda key: model.init(
        {"params": key, "sampling": jax.random.key(1), "dropout": jax.random.key(2)},
        jnp.zeros((B, S, S, 3)), jnp.asarray(LABELS), train=True))
    return jax.device_get(init(jax.random.key(0)))


@pytest.fixture(scope="module")
def port_model(variables):
    """The default-configuration port model, for tests that do not change it."""
    return _port(variables).eval()


def _port(variables, **kw):
    model = FasterRCNN(**{**CFG, **kw})
    model.load_state_dict(faster_rcnn_state_dict_from_jax(variables), strict=True)
    return model


def _images(seed, b=B):
    return np.random.default_rng(seed).normal(0, 1, (b, S, S, 3)).astype(np.float32)


def _assert_close_std(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * float(want.std()), (
        float(np.abs(got - want).max()), float(want.std()))


class Recorder:
    """Feeds the JAX sampler and dropout fixed draws and keeps them for the
    port: U(0, 1) per `random_sample_mask` call, keep masks per Dropout."""

    def __init__(self, seed, keep_shape=None, rate=0.5):
        self.rng = np.random.default_rng(seed)
        self.keep_shape, self.rate = keep_shape, rate
        self.uniforms, self.keeps = [], []

    def sampler(self, rng, mask, k):
        u = self.rng.uniform(size=mask.shape).astype(np.float32)
        self.uniforms.append(u)
        priority = mask.astype(jnp.float32) + u
        _, idx = jax.lax.top_k(priority, k)
        return idx, mask[idx].astype(jnp.float32)

    def dropout(self, next_fun, args, kwargs, context):
        if not isinstance(context.module, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = self.rng.uniform(size=x.shape) < 1.0 - self.rate
        self.keeps.append(keep)
        return jnp.where(keep, x / (1.0 - self.rate), 0.0)

    def draws(self, b=B):
        u = [torch.from_numpy(np.broadcast_to(a, (b,) + a.shape).copy()) for a in self.uniforms]
        return (*u, *(torch.from_numpy(k) for k in self.keeps))


def test_bridge_loads_every_tensor(port_model):
    sd = port_model.state_dict()
    assert len(sd) == 13 * 2 + 3 * 2 + 4 * 2
    assert sd["head.fc1.weight"].shape == (4096, 7 * 7 * 512)
    assert sd["rpn.reg.weight"].shape == (36, 512, 1, 1)


@pytest.mark.parametrize("compat", [False, True], ids=["default", "reference_compat"])
def test_filter_proposals_matches_jax(compat):
    rng = np.random.default_rng(11)
    base = tfr.make_base_anchors((2, 4, 6))
    anchors = tfr.anchor_grid(8, 8, 16, base, offset=0.0 if compat else 0.5)
    k = anchors.shape[0]
    obj = rng.normal(0, 1, (B, k)).astype(np.float32)
    obj[:, :20] = obj[0, 20]  # exact ties
    obj[:, 20:60] = 5.0  # top-scored tiny boxes: filtered by min size unless compat
    deltas = rng.normal(0, 0.5, (B, k, 4)).astype(np.float32)
    deltas[:, 20:60, 2:] = -6.0
    kw = dict(image_size=S, pre_nms_top_n=200, post_nms_top_n=200, nms_thresh=0.7,
              min_size=-1.0 if compat else 1.0,
              clip_max=(7 * 16, 7 * 16) if compat else None, wh_from_dw=compat)
    want = jfr.filter_proposals(jnp.asarray(anchors.numpy()), jnp.asarray(obj),
                                jnp.asarray(deltas), **kw)
    got = tfr.filter_proposals(anchors, torch.from_numpy(obj), torch.from_numpy(deltas), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(got[2].sum()) < got[2].numel()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("compat", [False, True], ids=["default", "reference_compat"])
def test_eval_forward_matches_jax(variables, port_model, compat):
    x = _images(12)
    want = jfr.FasterRCNN(**CFG, reference_compat=compat).apply(variables, jnp.asarray(x))
    model = _port(variables, reference_compat=True).eval() if compat else port_model
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    cls_logits, boxes, proposals, valid = (t.numpy() for t in got)
    np.testing.assert_array_equal(valid, np.asarray(want[3]))
    np.testing.assert_allclose(proposals, np.asarray(want[2]), rtol=0, atol=1e-3)
    _assert_close_std(cls_logits, want[0])
    _assert_close_std(boxes, want[1])
    assert cls_logits.shape == (B, CFG["rpn_post_nms_eval"], C + 1)


def test_postprocess_matches_jax(variables):
    cls_logits, boxes, _, valid = jfr.FasterRCNN(**CFG).apply(variables, jnp.asarray(_images(13)))
    cls_logits = np.asarray(cls_logits) * 4.0  # spread the scores over the threshold
    boxes, valid = np.array(boxes), np.array(valid)
    for thr, max_det in ((0.05, 100), (0.2, 7)):
        want = jfr.fastrcnn_postprocess(jnp.asarray(cls_logits), boxes, valid, thr, 0.3, max_det)
        got = tfr.fastrcnn_postprocess(torch.from_numpy(cls_logits), torch.from_numpy(boxes),
                                       torch.from_numpy(valid), thr, 0.3, max_det)
        assert int(got.valid.sum()) == int(np.asarray(want.valid).sum()) > 0
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-3)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5,
                                   atol=1e-7)


@pytest.fixture(scope="module")
def val_root(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("frcnn_val")
    ds = SyntheticDetectionDataset(6, C, seed=3, sizes=((S, S),), max_objects=3)
    os.makedirs(root / "val" / "images")
    os.makedirs(root / "val" / "labels")
    for i in range(len(ds)):
        img, lab, _ = ds[i]
        cv2.imwrite(str(root / "val" / "images" / f"im{i}.png"), img[..., ::-1])
        (root / "val" / "labels" / f"im{i}.txt").write_text(
            "".join(f"{int(r[0])} {r[1]} {r[2]} {r[3]} {r[4]}\n" for r in lab))
    return str(root)


def test_eval_step_map_matches_jax(variables, val_root):
    model = jfr.FasterRCNN(**{**CFG, "rpn_post_nms_eval": 128})
    jstate = jt.TrainState.create(variables, jt.build_optimizer("sgd", variables["params"]))
    jeval = jt.detection_evaluator(jt.make_frcnn_eval_step(model, score_thresh=0.0, max_det=50))
    want = jeval(jstate, jd.DetectionLoader(jd.DetectionDataset(val_root, "val"), S, 3,
                                            max_boxes=4, train=False))
    port = _port(variables, rpn_post_nms_eval=128)
    state = tt.TrainState.create(port, tt.build_optimizer("sgd", port), "cpu")
    evaluate = tt.detection_evaluator(tt.make_frcnn_eval_step(score_thresh=0.0, max_det=50))
    got = evaluate(state, DetectionLoader(DetectionDataset(val_root, "val"), S, 3, max_boxes=4,
                                          train=False))
    assert want["map50"] > 0
    assert got["map50"] == pytest.approx(want["map50"], abs=1e-6)
    assert got["map"] == pytest.approx(want["map"], abs=1e-6)


def _rpn_inputs(seed):
    rng = np.random.default_rng(seed)
    anchors = tfr.anchor_grid(8, 8, 16, tfr.make_base_anchors((2, 4, 6)))
    k = anchors.shape[0]
    obj = rng.normal(0, 1, (B, k)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (B, k, 4)).astype(np.float32)
    return anchors, obj, deltas


def test_rpn_loss_matches_jax(monkeypatch):
    anchors, obj, deltas = _rpn_inputs(14)
    rec = Recorder(15)
    monkeypatch.setattr(jfr, "random_sample_mask", rec.sampler)
    want = jfr.rpn_loss(jax.random.key(0), jnp.asarray(anchors.numpy()), jnp.asarray(obj),
                        jnp.asarray(deltas), jnp.asarray(LABELS))
    assert len(rec.uniforms) == 2
    got = tfr.rpn_loss(rec.draws(), anchors, torch.from_numpy(obj), torch.from_numpy(deltas),
                       torch.from_numpy(LABELS))
    for g, w in zip(got, want):
        assert float(w) > 0
        assert float(g) == pytest.approx(float(w), rel=1e-5)


def test_rpn_loss_padded_gt_marks_no_anchor():
    """Padded GT rows (all IoUs -1, argmax anchor 0) must not touch anchor
    0's positive flag: only valid GTs mark their best anchor, so padding
    anywhere in the rows leaves both losses unchanged."""
    anchors, obj, deltas = _rpn_inputs(16)
    compact = torch.from_numpy(LABELS[:, [0, 1]].copy())
    compact[1, 1] = torch.from_numpy(LABELS[1, 2])  # both images: 2 valid GTs
    pad = torch.full((B, 1, 5), -1.0)
    padded = torch.cat([pad, compact[:, :1], pad, pad, compact[:, 1:], pad], dim=1)
    u = (torch.rand(B, anchors.shape[0], generator=torch.Generator().manual_seed(0)),
         torch.rand(B, anchors.shape[0], generator=torch.Generator().manual_seed(1)))
    args = (anchors, torch.from_numpy(obj), torch.from_numpy(deltas))
    for want, got in zip(tfr.rpn_loss(u, *args, compact), tfr.rpn_loss(u, *args, padded)):
        assert float(want) > 0 and float(got) == float(want)


def test_sample_rois_matches_jax(monkeypatch):
    rng = np.random.default_rng(17)
    props = np.concatenate([rng.uniform(0, 90, (B, 40, 2)),
                            rng.uniform(0, 90, (B, 40, 2)) + 30], -1).astype(np.float32)
    props[:, :6] = LABELS[:, :1, 1:5] + rng.normal(0, 2, (B, 6, 4))  # some positives
    pvalid = rng.uniform(size=(B, 40)) < 0.9
    rec = Recorder(18)
    monkeypatch.setattr(jfr, "random_sample_mask", rec.sampler)
    want = jfr.sample_rois(jax.random.key(0), jnp.asarray(props), jnp.asarray(pvalid),
                           jnp.asarray(LABELS), num_pos=4, num_neg=12)
    got = tfr.sample_rois(rec.draws(), torch.from_numpy(props), torch.from_numpy(pvalid),
                          torch.from_numpy(LABELS), num_pos=4, num_neg=12)
    assert float(got[3].sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    lab = np.full((B, 4, 5), -1, np.float32)
    lab[:, :2, 0] = rng.integers(0, C, (B, 2))
    lab[:, :2, 1:3] = rng.uniform(0.3, 0.7, (B, 2, 2))
    lab[:, :2, 3:5] = rng.uniform(0.2, 0.5, (B, 2, 2))
    return {"images": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8), "labels": lab}


def test_train_step_matches_jax(variables, monkeypatch):
    """One SGD step of each package's own step function (the recipe of
    cli.py::_train_faster_rcnn: clip 10, decay 5e-4), from the same weights
    with the same samples and dropout masks."""
    model = jfr.FasterRCNN(**CFG)
    tx = jt.build_optimizer("sgd", variables["params"], momentum=0.9, grad_clip_norm=10.0)
    rec = Recorder(19)
    monkeypatch.setattr(jfr, "random_sample_mask", rec.sampler)
    batch = _train_batch(20)
    with fnn.intercept_methods(rec.dropout):
        jstate, jm = jt.make_frcnn_train_step(model, tx, seed=0)(
            jt.TrainState.create(variables, tx), batch, 1e-2)
    assert len(rec.uniforms) == 4 and len(rec.keeps) == 2

    port = _port(variables)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    state = tt.TrainState.create(port, tt.build_optimizer(
        "sgd", port, momentum=0.9, grad_clip_norm=10.0), "cpu")
    state, m = tt.make_frcnn_train_step(seed=0)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1e-2, draws=tfr.Draws(*rec.draws()))
    assert state.step == 1
    for k in ("rpn_cls", "rpn_reg", "cls", "reg", "loss"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    want = faster_rcnn_state_dict_from_jax(jax.device_get({"params": jstate.params}))
    for k, w in want.items():
        d = float((port.state_dict()[k] - w).abs().max())
        moved = float((w - start[k]).abs().max())
        assert moved > 0, k
        assert d <= 1e-4 * float(w.std()) or d <= 2e-3 * moved, (k, d, float(w.std()), moved)


def test_train_step_draws_repeat_per_step(variables):
    """The step's generator is seeded from (seed, step): a step taken again
    at the same step count repeats its draws, the next step draws anew."""
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(21).items()}
    port = _port(variables)
    state = tt.TrainState.create(port, tt.build_optimizer("sgd", port), "cpu")
    step = tt.make_frcnn_train_step(seed=3)
    first, second = (float(step(state, batch, 0.0)[1]["loss"]) for _ in range(2))
    state.step = 0
    again = float(step(state, batch, 0.0)[1]["loss"])
    assert first == again != second


def test_reference_import_matches_jax_bridge():
    """The reference demo's state_dict (synthetic, reference shapes with a
    narrow MLP) through the port's importer equals the JAX importer followed
    by the flax bridge, fc1's (C, 7, 7) -> (7, 7, C) re-interleave included."""
    rng = np.random.default_rng(22)
    ref, chans = {}, [3, 4, 4, 5, 5, 6, 6, 6, 7, 7, 7, 512, 512, 512]
    n = 0
    for stage, convs in enumerate((2, 2, 3, 3, 3), start=1):
        for j in range(convs):  # Conv2d at even slots, ReLU / pool between
            ref[f"backbone.vgg{stage}.{2 * j}.weight"] = rng.normal(
                size=(chans[n + 1], chans[n], 3, 3)).astype(np.float32)
            ref[f"backbone.vgg{stage}.{2 * j}.bias"] = rng.normal(size=chans[n + 1]).astype(
                np.float32)
            n += 1
    hidden, a = 16, 9
    ref.update({
        "rpn.conv3x3.weight": rng.normal(size=(512, 512, 3, 3)).astype(np.float32),
        "rpn.conv3x3.bias": rng.normal(size=512).astype(np.float32),
        "rpn.classifier.weight": rng.normal(size=(2 * a, 512, 1, 1)).astype(np.float32),
        "rpn.classifier.bias": rng.normal(size=2 * a).astype(np.float32),
        "rpn.regressor.weight": rng.normal(size=(4 * a, 512, 1, 1)).astype(np.float32),
        "rpn.regressor.bias": rng.normal(size=4 * a).astype(np.float32),
        "fast.module_after_roi.0.weight": rng.normal(size=(hidden, 512 * 49)).astype(np.float32),
        "fast.module_after_roi.0.bias": rng.normal(size=hidden).astype(np.float32),
        "fast.module_after_roi.3.weight": rng.normal(size=(hidden, hidden)).astype(np.float32),
        "fast.module_after_roi.3.bias": rng.normal(size=hidden).astype(np.float32),
        "fast.classifier.weight": rng.normal(size=(C + 1, hidden)).astype(np.float32),
        "fast.classifier.bias": rng.normal(size=C + 1).astype(np.float32),
        "fast.regressor.weight": rng.normal(size=((C + 1) * 4, hidden)).astype(np.float32),
        "fast.regressor.bias": rng.normal(size=(C + 1) * 4).astype(np.float32),
    })
    got = frcnn_state_dict_from_reference(ref)
    want = faster_rcnn_state_dict_from_jax(
        {"params": unflatten_dict(frcnn_from_reference(ref)["params"], sep="/")})
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # fc1 on RoI features that vary over channels: the reference's (C, 7, 7)
    # flatten against the port's (7, 7, C)
    feats = torch.from_numpy(rng.normal(size=(5, 512, 7, 7)).astype(np.float32))
    ref_fc1 = feats.reshape(5, -1) @ torch.from_numpy(ref["fast.module_after_roi.0.weight"]).T
    port_fc1 = feats.permute(0, 2, 3, 1).reshape(5, -1) @ got["head.fc1.weight"].T
    torch.testing.assert_close(port_fc1, ref_fc1, rtol=1e-4, atol=1e-3)
    # sigmoid(fg - bg) == softmax over (bg, fg)
    x = torch.from_numpy(rng.normal(size=(1, 512, 2, 2)).astype(np.float32))
    logits2 = torch.nn.functional.conv2d(x, torch.from_numpy(ref["rpn.classifier.weight"]),
                                         torch.from_numpy(ref["rpn.classifier.bias"]))
    one = torch.nn.functional.conv2d(x, got["rpn.cls.weight"], got["rpn.cls.bias"])
    soft = torch.softmax(logits2.reshape(1, a, 2, 2, 2), dim=2)[:, :, 1]
    torch.testing.assert_close(torch.sigmoid(one), soft, rtol=1e-4, atol=1e-5)


def test_train_forward_needs_labels_and_randomness(port_model):
    model = port_model.train()
    x = torch.from_numpy(_images(23))
    try:
        with pytest.raises(ValueError, match="labels"):
            model(x)
        with pytest.raises(ValueError, match="generator"):
            model(x, torch.from_numpy(LABELS))
    finally:
        model.eval()
    with pytest.raises(ValueError, match="roi_backend"):
        FasterRCNN(**CFG, roi_backend="pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.TrainState.create(model, tt.build_optimizer("sgd", model))
