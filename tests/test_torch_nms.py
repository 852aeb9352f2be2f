"""Port NMS vs the JAX package.

Tolerances:
  - suppression masks: EXACT equality with both the JAX package's XLA
    ``suppression_mask`` and its Pallas kernel ``suppression_mask_pallas``
    (in interpret mode, as tests/test_nms_pallas.py runs it on the CPU);
  - non_max_suppression / batched_non_max_suppression on shared
    predictions: keep sets, classes and valid masks exact; boxes and scores
    atol 1e-6 (the same float32 arithmetic in the same order).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.ops.nms  # noqa: F401  (the package re-exports a function `nms`)
import fastvision_tpu_torch.ops.nms  # noqa: F401
from fastvision_tpu.ops.nms_pallas import suppression_mask_pallas
from fastvision_tpu_torch.ops.box import xywh2xyxy
from fastvision_tpu_torch.ops.nms_kernel import suppression_mask_cuda, suppression_mask_plain
from fastvision_tpu_torch.testing import nms_case

torch.set_num_threads(2)
jnms = sys.modules["fastvision_tpu.ops.nms"]
tnms = sys.modules["fastvision_tpu_torch.ops.nms"]

CASES = [
    pytest.param(dict(), id="all"),
    pytest.param(dict(ties=False, neg_inf_tail=False, on_threshold=False), id="random"),
    pytest.param(dict(class_offset=None), id="no_offset"),
    pytest.param(dict(ties=True, neg_inf_tail=False, class_offset=None, on_threshold=False),
                 id="ties"),
    pytest.param(dict(ties=False, neg_inf_tail=True, class_offset=None, on_threshold=False),
                 id="neg_inf_tail"),
    pytest.param(dict(ties=False, neg_inf_tail=False, on_threshold=True), id="on_threshold"),
]


@pytest.mark.parametrize("iou_thres", [0.45, 0.6])
@pytest.mark.parametrize("k", [1, 64, 256])
@pytest.mark.parametrize("flags", CASES)
def test_plain_mask_equals_jax_xla(k, iou_thres, flags):
    boxes, scores = nms_case(k, 3, k, iou_thres, **flags)
    got = suppression_mask_plain(torch.from_numpy(boxes), torch.from_numpy(scores), iou_thres)
    want = jax.vmap(lambda b, s: jnms.suppression_mask(b, s, iou_thres))(
        jnp.asarray(boxes), jnp.asarray(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 64, 256])
def test_plain_mask_equals_pallas_interpret(k):
    boxes, scores = nms_case(100 + k, 2, k, 0.45)
    got = suppression_mask_plain(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45)
    for i in range(2):
        want = suppression_mask_pallas(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.45,
                                       interpret=True)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_suppression_mask_dispatch_and_checks():
    boxes, scores = nms_case(7, 2, 40)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    before = suppression_mask_cuda.launches
    # CPU tensors take the plain version; a single image [K, 4] works too
    np.testing.assert_array_equal(tnms.suppression_mask(b, s, 0.45).numpy(),
                                  suppression_mask_plain(b, s, 0.45).numpy())
    np.testing.assert_array_equal(tnms.suppression_mask(b[1], s[1], 0.45).numpy(),
                                  suppression_mask_plain(b, s, 0.45)[1].numpy())
    assert suppression_mask_cuda.launches == before
    # the kernel wrapper never accepts CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        suppression_mask_cuda(b, s, 0.45)
    with pytest.raises(ValueError, match="unsupported device"):
        tnms.suppression_mask(b.to("meta"), s.to("meta"), 0.45)


def _predictions(seed, b, n, c, tie_rows=0):
    """Raw [B, N, 5+C] rows (xywh pixels, sigmoided obj/cls); the first
    ``tie_rows`` rows of each image repeat row 0's scores exactly, as cells
    inside letterbox padding do."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 96, (b, n, 2))
    wh = rng.uniform(4, 60, (b, n, 2))
    scores = rng.uniform(0, 1, (b, n, 1 + c))
    pred = np.concatenate([xy, wh, scores], -1).astype(np.float32)
    if tie_rows:
        pred[:, 1:tie_rows, 4:] = pred[:, :1, 4:]
    return pred


def _assert_same_detections(got, want):
    for name in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("score_mode", ["obj_cls", "obj"])
@pytest.mark.parametrize("class_agnostic", [False, True])
def test_non_max_suppression_matches_jax(score_mode, class_agnostic):
    pred = _predictions(1, 1, 500, 6, tie_rows=40)[0]
    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=100, pre_nms_top_k=256,
              class_agnostic=class_agnostic, score_mode=score_mode)
    got = tnms.non_max_suppression(torch.from_numpy(pred), **kw)
    want = jnms.non_max_suppression(jnp.asarray(pred), **kw)
    assert int(got.valid.sum()) > 5
    _assert_same_detections(got, want)


@pytest.mark.parametrize("box_format", ["xywh", "xyxy"])
def test_batched_non_max_suppression_matches_jax(box_format):
    pred = _predictions(2, 3, 400, 5, tie_rows=30)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=60, pre_nms_top_k=300,
              box_format=box_format, class_offset=jnms.class_offset_for(300.0))
    got = tnms.batched_non_max_suppression(torch.from_numpy(pred), **kw)
    want = jnms.batched_non_max_suppression(jnp.asarray(pred), **kw)
    _assert_same_detections(got, want)


def test_nms_keep_mask_matches_jax():
    pred = _predictions(3, 1, 120, 1)[0]
    boxes = xywh2xyxy(torch.from_numpy(pred[:, :4]))
    scores = torch.from_numpy(pred[:, 4].copy())
    scores[::7] = scores[0]  # ties across the sort
    for max_out in (None, 10):
        got = tnms.nms(boxes, scores, 0.5, max_out=max_out)
        want = jnms.nms(jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()), 0.5,
                        max_out=max_out)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_keeps_index_order_for_ties():
    x = torch.tensor([[0.5, 0.9, 0.5, float("-inf"), 0.9, 0.5, float("-inf")]])
    vals, idx = tnms._top_k(x, 7)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_class_offset_for_matches_jax():
    for bound in (0.0, 1248.0, 5000.0):
        assert tnms.class_offset_for(bound) == jnms.class_offset_for(bound)
    assert tnms.CLASS_OFFSET == jnms.CLASS_OFFSET


def test_non_max_suppression_rejects_batches():
    with pytest.raises(ValueError):
        tnms.non_max_suppression(torch.zeros(2, 10, 7))
    with pytest.raises(ValueError):
        tnms.batched_non_max_suppression(torch.zeros(10, 7))
