"""Card-only tests of the PyTorch port: the CUDA NMS kernel against its plain
PyTorch version, and the Detector's kernel path against its CPU path.

Every test here is marked ``gpu`` and skips without a CUDA card. This file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py imports JAX.)

The kernel's cases cover K up to ``MAX_K`` (8192) and clustered inputs
(near-copies of a few objects, heavy suppression, as trained weights give).

Tolerance: keep masks and Detections bit-equal. The kernel rounds every
float32 intermediate as the plain version does (no FMA contraction, IEEE
division), and everything around it is the same PyTorch code on both sides.
"""
import numpy as np
import pytest
import torch

from fastvision_tpu_torch.infer import Detector
from fastvision_tpu_torch.models import YOLOv3
from fastvision_tpu_torch.ops import COCO_ANCHORS, batched_non_max_suppression, nms_candidates
from fastvision_tpu_torch.ops.nms import suppression_mask
from fastvision_tpu_torch.ops.nms_kernel import (
    MAX_K,
    suppression_mask_cuda,
    suppression_mask_plain,
)
from fastvision_tpu_torch.testing import nms_case

torch.set_num_threads(2)
pytestmark = pytest.mark.gpu


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("iou_thres", [0.45, 0.6])
@pytest.mark.parametrize("b,k", [(1, 1), (1, 37), (8, 64), (8, 1024), (256, 1024), (3, MAX_K),
                                 (2, 2049), (2, 4096), (1, 8192), (4, 1000)])
@pytest.mark.parametrize("flags", [
    dict(), dict(ties=False, neg_inf_tail=False, on_threshold=False),
    dict(class_offset=None), dict(clusters=20),
], ids=["stress", "random", "no_offset", "clustered"])
def test_kernel_mask_equals_plain(b, k, iou_thres, flags):
    dev = _cuda()
    boxes, scores = nms_case(b * 7919 + k, b, k, iou_thres, **flags)
    boxes, scores = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    before = suppression_mask_cuda.launches
    got = suppression_mask_cuda(boxes, scores, iou_thres)
    torch.cuda.synchronize()
    assert suppression_mask_cuda.launches == before + 1
    want = suppression_mask_plain(boxes, scores, iou_thres)
    assert got.dtype == torch.bool and got.shape == (b, k)
    assert torch.equal(got, want), int((got != want).sum())


def test_kernel_wrapper_rejects_what_it_does_not_take():
    dev = _cuda()
    boxes, scores = (torch.from_numpy(a).to(dev) for a in nms_case(0, 2, 64))
    with pytest.raises(TypeError):
        suppression_mask_cuda(boxes.double(), scores, 0.45)
    with pytest.raises(ValueError, match="contiguous"):
        suppression_mask_cuda(boxes.transpose(0, 1).contiguous().transpose(0, 1), scores, 0.45)
    with pytest.raises(ValueError):
        suppression_mask_cuda(boxes[..., :3].contiguous(), scores, 0.45)
    with pytest.raises(ValueError, match="K <="):
        suppression_mask_cuda(torch.zeros(1, MAX_K + 1, 4, device=dev),
                              torch.zeros(1, MAX_K + 1, device=dev), 0.45)
    # boxes at an offset that is not a multiple of 16 bytes
    odd = torch.empty(boxes.numel() + 1, device=dev)[1:].view_as(boxes).copy_(boxes)
    with pytest.raises(ValueError, match="aligned"):
        suppression_mask_cuda(odd, scores, 0.45)
    # the dispatcher makes its inputs contiguous and aligned, and takes single images
    keep = suppression_mask(boxes[0], scores[0], 0.45)
    assert torch.equal(keep, suppression_mask_plain(boxes, scores, 0.45)[0])
    assert torch.equal(suppression_mask(odd, scores, 0.45),
                       suppression_mask_plain(boxes, scores, 0.45))


def test_detector_kernel_path_equals_cpu_path():
    """A shallow model at 96 px: the predictions decoded on the card go
    through NMS on the card (kernel) and on the CPU (plain version)."""
    dev = _cuda()
    g = torch.Generator().manual_seed(5)
    model = YOLOv3(num_classes=80, stage_sizes=(1, 1, 1, 1, 1), generator=g)
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    det = Detector(model, anchors, input_size=96, batch_size=4, device=dev)
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
            for hw in ((96, 96), (120, 80), (50, 96), (200, 300))]
    before = suppression_mask_cuda.launches
    out = det.predict_batch(imgs)
    assert suppression_mask_cuda.launches == before + 1
    for r, im in zip(out, imgs):
        h, w = im.shape[:2]
        assert np.isfinite(r["boxes"]).all() and (r["boxes"] >= 0).all()
        assert (r["boxes"][:, [0, 2]] <= w).all() and (r["boxes"][:, [1, 3]] <= h).all()

    batch = torch.from_numpy(np.stack([np.full((96, 96, 3), v, np.uint8) for v in (0, 60, 114, 255)]))
    pred = det.predecode(batch.to(dev)).float()
    kw = dict(conf_thres=0.05, iou_thres=0.45, max_det=300, class_offset=det.class_offset)
    on_card = batched_non_max_suppression(pred, **kw)
    on_cpu = batched_non_max_suppression(pred.cpu(), **kw)
    assert int(on_card.valid.sum()) > 0
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    # and the kernel's own input, as batched_non_max_suppression builds it
    _, nms_boxes, scores, _ = nms_candidates(pred, conf_thres=0.05, pre_nms_top_k=256,
                                             class_offset=det.class_offset)
    before = suppression_mask_cuda.launches
    keep = suppression_mask(nms_boxes, scores, 0.45)  # a K-slice view: made contiguous
    assert suppression_mask_cuda.launches == before + 1
    assert torch.equal(keep.cpu(), suppression_mask_plain(nms_boxes.cpu(), scores.cpu(), 0.45))
