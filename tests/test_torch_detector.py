"""The slice as a whole: the port's Detector vs the JAX package's Detector.

Same weights (bridged), float32 on both sides, seeded noise images whose
long side equals ``input_size`` (letterbox pads but does not resize, so the
two letterbox resamplers do not enter). Tolerance: the same number of
boxes and the same classes; boxes atol 0.1 px (the tolerance of
tests/test_e2e_box_parity.py); scores rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvision_tpu.infer import Detector as JaxDetector
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu_torch.infer import Detector
from fastvision_tpu_torch.models import YOLOv3, yolov3_state_dict_from_jax
from fastvision_tpu_torch.ops.nms_kernel import suppression_mask_cuda

torch.set_num_threads(2)
SIZE = 96
ANCHORS = np.asarray(
    [[[60, 50], [70, 60], [80, 70]],
     [[40, 35], [50, 40], [55, 45]],
     [[20, 18], [28, 24], [34, 30]]],
    np.float32,
)


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


@pytest.fixture(scope="module")
def models():
    jm = JaxYOLOv3(num_classes=4,
                   backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
    variables = jax.device_get(jm.init(jax.random.key(3), jnp.zeros((1, SIZE, SIZE, 3))))
    variables = {c: variables[c] for c in ("params", "batch_stats")}
    tm = YOLOv3(num_classes=4, stage_sizes=(1, 1, 1, 1, 1))
    tm.load_state_dict(yolov3_state_dict_from_jax(variables))
    return jm, variables, tm


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
            for hw in ((SIZE, SIZE), (SIZE, 60), (50, SIZE))]


def test_detector_matches_jax(models):
    jm, variables, tm = models
    kw = dict(input_size=SIZE, batch_size=4, conf_thres=0.3)
    jdet = JaxDetector(jm, variables, ANCHORS, dtype=jnp.float32, **kw)
    tdet = Detector(tm, ANCHORS, device="cpu", dtype=torch.float32, **kw)
    imgs = _images(0)
    want = jdet.predict_batch(imgs)
    got = tdet.predict_batch(imgs)
    assert len(got) == len(want) == 3
    assert sum(len(r["boxes"]) for r in got) > 10
    for g, w in zip(got, want):
        assert set(g) == {"boxes", "scores", "classes"}
        assert len(g["boxes"]) == len(w["boxes"])
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=0.1, rtol=0)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4, atol=0)


def test_detector_buckets_and_chunks(models):
    """Padding to a bucket or chunking beyond batch_size changes no result."""
    _, _, tm = models
    kw = dict(input_size=SIZE, conf_thres=0.3, device="cpu", dtype=torch.float32)
    plain = Detector(tm, ANCHORS, batch_size=3, **kw)
    bucketed = Detector(tm, ANCHORS, batch_size=2, batch_buckets=(1, 5, 0), **kw)
    assert bucketed.batch_buckets == (1, 2)
    imgs = _images(1)
    want = plain.predict_batch(imgs)
    got = bucketed.predict_batch(imgs)  # chunks of 2 + 1 (bucket 1)
    single = bucketed.predict_image(imgs[2])
    for g, w in zip(got + [single], want + [want[2]]):
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4)
    for r, im in zip(got, imgs):
        h, w = im.shape[:2]
        assert np.isfinite(r["boxes"]).all()
        assert (r["boxes"][:, [0, 2]] <= w).all() and (r["boxes"][:, [1, 3]] <= h).all()
        assert (r["boxes"] >= 0).all()
    assert suppression_mask_cuda.launches == 0  # CPU tensors never reach the kernel


def test_detector_bf16_autocast_runs_on_cpu(models):
    _, _, tm = models
    det = Detector(tm, ANCHORS, input_size=SIZE, batch_size=2, device="cpu")
    assert det.dtype == torch.bfloat16
    pred = det.predecode(torch.zeros(2, SIZE, SIZE, 3, dtype=torch.uint8))
    assert pred.dtype == torch.bfloat16 and pred.shape == (2, 3 * (9 + 36 + 144), 9)
    out = det.predict_batch(_images(2))
    assert all(np.isfinite(r["boxes"]).all() for r in out)


def test_detector_without_device_needs_cuda(models):
    _, _, tm = models
    if torch.cuda.is_available():
        assert Detector(tm, ANCHORS, input_size=SIZE).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Detector(tm, ANCHORS, input_size=SIZE)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Detector(tm, ANCHORS, input_size=SIZE, device="cuda")
