"""Faster R-CNN building blocks of the port against the JAX package on the
CPU, float32, same seeded numpy inputs: the box coder, both RoI-align forms
(and against each other), anchors, the stochastic sampler, the losses the
model trains with, VGG's max pool and the Dense initializer.

Tolerances: elementwise formulas in the JAX package's operation order agree
to float32 rounding (rtol 1e-5: ``exp`` / ``log`` differ by an ulp between
the libraries); RoI-align sums 2 x 2 samples x 4 corners, or H + W terms in
the matmul form, so 1e-5 of the features' std; the two forms against each
other 1e-4, the JAX package's own bound (tests/test_faster_rcnn.py).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.ops.box_coder as jbc
import fastvision_tpu.train.losses as jl
import fastvision_tpu_torch.ops.box_coder as tbc
import fastvision_tpu_torch.train.losses as tl
from fastvision_tpu.nn.layers import max_pool as jax_max_pool
from fastvision_tpu.ops import roi_align as jax_roi_align
from fastvision_tpu.ops.roi_align import roi_align_mxu as jax_roi_align_mxu
from fastvision_tpu.ops.roi_align import roi_align_single as jax_roi_align_single
from fastvision_tpu_torch.models.classification import VGG, VGGClassifier
from fastvision_tpu_torch.models.classification.vgg import CFGS
from fastvision_tpu_torch.nn import init_weights_, max_pool
from fastvision_tpu.ops.nms import suppression_mask as jax_suppression_mask
from fastvision_tpu_torch.ops import roi_align, roi_align_mxu, roi_align_single, suppression_mask
from fastvision_tpu_torch.testing import nms_case, rpn_nms_case

# the packages' `faster_rcnn` factories shadow their modules' names
jfr = importlib.import_module("fastvision_tpu.models.detection.faster_rcnn")
tfr = importlib.import_module("fastvision_tpu_torch.models.detection.faster_rcnn")
torch.set_num_threads(2)
BOX_STD = (0.1, 0.1, 0.2, 0.2)


def _boxes(rng, shape, lo=0.0, hi=400.0, wmin=1.0, wmax=150.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(wmin, wmax, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), BOX_STD], ids=["unit", "box_std"])
def test_encode_boxes_matches_jax(weights):
    rng = np.random.default_rng(0)
    ref, tgt = _boxes(rng, (3, 50)), _boxes(rng, (3, 50))
    tgt[0, :5, 2:] = tgt[0, :5, :2]  # zero-size targets hit the eps clamp
    want = np.asarray(jbc.encode_boxes(jnp.asarray(ref), jnp.asarray(tgt), weights))
    got = tbc.encode_boxes(torch.from_numpy(ref), torch.from_numpy(tgt), weights).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wh_from_dw", [False, True])
@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), BOX_STD], ids=["unit", "box_std"])
def test_decode_boxes_matches_jax(weights, wh_from_dw):
    rng = np.random.default_rng(1)
    ref = _boxes(rng, (2, 60))
    deltas = rng.normal(0, 2.0, (2, 60, 4)).astype(np.float32)  # some past the exp clip
    want = np.asarray(jbc.decode_boxes(jnp.asarray(ref), jnp.asarray(deltas), weights,
                                       wh_from_dw=wh_from_dw))
    got = tbc.decode_boxes(torch.from_numpy(ref), torch.from_numpy(deltas), weights,
                           wh_from_dw=wh_from_dw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    back = tbc.decode_boxes(torch.from_numpy(ref), tbc.encode_boxes(
        torch.from_numpy(ref), torch.from_numpy(got), weights), weights).numpy()
    if not wh_from_dw:
        np.testing.assert_allclose(back, got, rtol=1e-4, atol=1e-2)


def _roi_inputs(seed, b=2, h=24, w=20, c=8, n=6):
    rng = np.random.default_rng(seed)
    feat = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    boxes = _boxes(rng, (b, n), lo=-20.0, hi=300.0, wmin=0.0, wmax=200.0)  # some out of bounds
    return feat, boxes


FORMS = {"roi_align": (jax_roi_align, roi_align), "roi_align_mxu": (jax_roi_align_mxu, roi_align_mxu)}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_roi_align_matches_jax(form):
    feat, boxes = _roi_inputs(2)
    jax_fn, port_fn = FORMS[form]
    want = np.asarray(jax_fn(jnp.asarray(feat), jnp.asarray(boxes), 7, 1 / 16, 2))
    got = port_fn(torch.from_numpy(feat), torch.from_numpy(boxes), 7, 1 / 16, 2)
    assert got.shape == (2, 6, 7, 7, 8) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * feat.std()


def test_roi_align_single_matches_jax():
    feat, boxes = _roi_inputs(3, b=1)
    want = np.asarray(jax_roi_align_single(jnp.asarray(feat[0]), jnp.asarray(boxes[0]), 5, 1 / 8, 2))
    got = roi_align_single(torch.from_numpy(feat[0]), torch.from_numpy(boxes[0]), 5, 1 / 8, 2)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * feat.std()


def test_roi_align_forms_agree_in_bounds():
    rng = np.random.default_rng(4)
    feat = torch.from_numpy(rng.normal(0, 1, (2, 24, 20, 8)).astype(np.float32))
    boxes = torch.from_numpy(_boxes(rng, (2, 6), lo=0.0, hi=250.0, wmin=20.0, wmax=60.0))
    gather = roi_align(feat, boxes)
    mxu = roi_align_mxu(feat, boxes)
    torch.testing.assert_close(mxu, gather, rtol=1e-4, atol=1e-4)


def test_roi_align_mxu_is_float32_under_bf16_features():
    feat, boxes = _roi_inputs(5)
    f32 = roi_align_mxu(torch.from_numpy(feat), torch.from_numpy(boxes))
    bf = torch.from_numpy(feat).bfloat16()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = roi_align_mxu(bf, torch.from_numpy(boxes))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, roi_align_mxu(bf.float(), torch.from_numpy(boxes)))
    assert float((got - f32).abs().max()) <= 1e-2 * float(f32.std())


@pytest.mark.parametrize("offset", [0.5, 0.0])
def test_anchors_match_jax(offset):
    base_j = jfr.make_base_anchors((2, 4, 6), (0.5, 1.0, 2.0), 16)
    base_t = tfr.make_base_anchors((2, 4, 6), (0.5, 1.0, 2.0), 16)
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    want = np.asarray(jfr.anchor_grid(5, 7, 16, base_j, offset=offset))
    got = tfr.anchor_grid(5, 7, 16, base_t, offset=offset)
    assert got.shape == (5 * 7 * 9, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_sample_mask_matches_jax():
    """Fed the JAX function's own U(0, 1) draws, the port picks the same
    indices and weights, including when there are fewer candidates than k."""
    rng = np.random.default_rng(6)
    for k, p_true in ((8, 0.3), (8, 0.02), (30, 0.5)):
        mask = rng.uniform(size=200) < p_true
        key = jax.random.key(k)
        want_idx, want_w = jfr.random_sample_mask(key, jnp.asarray(mask), k)
        u = np.asarray(jax.random.uniform(key, mask.shape))
        idx, w = tfr.random_sample_mask(torch.from_numpy(u), torch.from_numpy(mask), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
    # batched: each row samples its own mask
    masks = rng.uniform(size=(3, 50)) < 0.3
    us = rng.uniform(size=(3, 50)).astype(np.float32)
    idx, w = tfr.random_sample_mask(torch.from_numpy(us), torch.from_numpy(masks), 5)
    for i in range(3):
        i1, w1 = tfr.random_sample_mask(torch.from_numpy(us[i]), torch.from_numpy(masks[i]), 5)
        assert torch.equal(idx[i], i1) and torch.equal(w[i], w1)


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    return {
        "logits": rng.normal(0, 2, (40, 5)).astype(np.float32),
        "labels": rng.integers(0, 5, 40).astype(np.int32),
        "probs": rng.dirichlet(np.ones(5), 40).astype(np.float32),
        "logit1": rng.normal(0, 2, 40).astype(np.float32),
        "target1": (rng.uniform(size=40) < 0.4).astype(np.float32),
        "weights": (rng.uniform(size=40) < 0.7).astype(np.float32),
        "pred4": rng.normal(0, 1, (40, 4)).astype(np.float32),
        "tgt4": rng.normal(0, 1, (40, 4)).astype(np.float32),
    }


LOSS_CASES = {
    "cross_entropy": lambda m, d, kw: m.cross_entropy(d["logits"], d["labels"], **kw),
    "soft_cross_entropy": lambda m, d, kw: m.soft_cross_entropy(d["logits"], d["probs"], **kw),
    "focal_loss": lambda m, d, kw: m.focal_loss(d["logits"], d["labels"], **kw),
    "binary_focal_loss": lambda m, d, kw: m.binary_focal_loss(d["logit1"], d["target1"], **kw),
    "binary_focal_loss_alpha": lambda m, d, kw: m.binary_focal_loss(
        d["logit1"], d["target1"], alpha=0.25, **kw),
    "smooth_l1": lambda m, d, kw: m.smooth_l1(d["pred4"], d["tgt4"], **kw),
    "smooth_l1_rpn_beta": lambda m, d, kw: m.smooth_l1(d["pred4"], d["tgt4"], beta=1 / 9, **kw),
    "smooth_l1_1d": lambda m, d, kw: m.smooth_l1(d["pred4"][:, 0], d["tgt4"][:, 0], **kw),
}


@pytest.mark.parametrize("reduction", ["mean", "weighted_mean", "sum", "none"])
@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name, reduction):
    d = _loss_inputs(7)
    kw = {"reduction": "mean" if reduction == "weighted_mean" else reduction}
    jkw, tkw = dict(kw), dict(kw)
    if reduction == "weighted_mean":
        jkw["weights"] = jnp.asarray(d["weights"])
        tkw["weights"] = torch.from_numpy(d["weights"])
    want = np.asarray(LOSS_CASES[name](jl, {k: jnp.asarray(v) for k, v in d.items()}, jkw))
    got = LOSS_CASES[name](tl, {k: torch.from_numpy(v) for k, v in d.items()}, tkw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [(16, 16), (15, 9)])
def test_max_pool_matches_flax(hw):
    x = np.random.default_rng(8).normal(size=(2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jax_max_pool(jnp.asarray(x)))
    got = max_pool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vgg_trunk_shapes_and_top():
    vgg = VGG(CFGS["vgg16"], including_top=False, drop_last_pool=True)
    assert vgg.out_channels == 512
    assert sum(1 for k in vgg.state_dict() if k.endswith("conv.weight")) == 13
    out = vgg(torch.zeros(1, 3, 64, 48))
    assert out.shape == (1, 512, 4, 3)  # four pools: stride 16
    top = VGG((8, "M"), num_classes=10).eval()  # the classifier top: NHWC in, logits out
    assert top(torch.zeros(1, 16, 16, 3)).shape == (1, 10) and top.fc1.in_features == 8 * 7 * 7


def test_init_weights_linear_is_flax_dense_init():
    """Dense: lecun normal truncated at 2 std (flax's default), bias 0,
    repeatable from the generator."""
    head = VGGClassifier(400, hidden=300)
    init_weights_(head, torch.Generator().manual_seed(0))
    w = head.fc1.weight.detach()
    assert float(w.abs().max()) <= 2 * (1 / 400) ** 0.5 / 0.87962566103423978 + 1e-7
    assert float(w.std()) == pytest.approx((1 / 400) ** 0.5, rel=0.02)
    assert float(head.fc1.bias.detach().abs().max()) == 0.0
    again = init_weights_(VGGClassifier(400, hidden=300), torch.Generator().manual_seed(0))
    assert torch.equal(again.fc2.weight, head.fc2.weight)
    x = torch.randn(2, 400)
    keep = [torch.rand(2, 300) < 0.5, torch.rand(2, 300) < 0.5]
    y = head(x, keep)
    assert bool((y[~keep[1]] == 0).all())


@pytest.mark.parametrize("case", ["rpn", "head"])
def test_suppression_mask_on_frcnn_inputs_matches_jax(case):
    """The port's CPU path (the kernel's plain version) on Faster R-CNN's two
    NMS regimes, against the JAX package's XLA suppression_mask: the RPN's
    dense class-agnostic 512-px boxes at IoU 0.7, the head's 20-class
    offset boxes at IoU 0.3. Keep masks equal."""
    if case == "rpn":
        boxes, scores = rpn_nms_case(30, 2, 300)
        thr = 0.7
    else:
        boxes, scores = nms_case(31, 2, 400, 0.3, num_classes=20, clusters=30, ties=False,
                                 on_threshold=False)
        thr = 0.3
    got = suppression_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr)
    for i in range(2):
        want = np.asarray(jax_suppression_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thr))
        np.testing.assert_array_equal(got[i].numpy(), want)
    assert 0 < int(got.sum()) < got.numel()
