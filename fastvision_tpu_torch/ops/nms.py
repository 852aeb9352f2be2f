"""Fixed-size, class-offset greedy NMS on torch tensors.

Port of fastvision_tpu/ops/nms.py, batched over images by a leading batch
dimension instead of ``vmap``:

  1. confidence mask -> masked scores (invalid candidates score -inf),
  2. top-K pre-NMS candidates by a STABLE descending sort (``lax.top_k``
     puts the lower index first among equal values; ``torch.topk`` does not
     promise that, and exact ties are real: cells whose receptive field lies
     wholly inside letterbox padding give bit-identical scores),
  3. class-aware suppression via the class-offset trick,
  4. greedy suppression (`suppression_mask`): the hand-written CUDA kernel
     for CUDA tensors, its plain PyTorch version for CPU tensors,
  5. fixed ``max_det`` outputs + validity mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .box import xywh2xyxy
from .nms_kernel import suppression_mask_cuda, suppression_mask_plain

# Default per-class coordinate offset (the JAX package's constant). It must
# exceed every box coordinate magnitude or classes' regions overlap; derive a
# larger one with `class_offset_for` for large coordinate spaces.
CLASS_OFFSET = 4096.0


def class_offset_for(coord_bound: float) -> float:
    """Smallest safe per-class offset for coordinates in (-coord_bound,
    coord_bound), never below CLASS_OFFSET."""
    return float(max(CLASS_OFFSET, coord_bound + 1.0))


class Detections(NamedTuple):
    """Fixed-size NMS output. Padded entries have valid == False."""

    boxes: torch.Tensor  # [..., max_det, 4] xyxy
    scores: torch.Tensor  # [..., max_det]
    classes: torch.Tensor  # [..., max_det] int32
    valid: torch.Tensor  # [..., max_det] bool


def suppression_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thres: float) -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted boxes.

    boxes [K, 4] or [B, K, 4] xyxy sorted by descending score; scores [K] or
    [B, K] (entries at -inf are never kept and suppress nothing). Returns
    bool [K] / [B, K]. CUDA tensors go to the kernel, CPU tensors to the
    plain version; there is no other route."""
    single = boxes.ndim == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    if boxes.device.type == "cuda":
        keep = suppression_mask_cuda(boxes.contiguous(), scores.contiguous(), iou_thres)
    elif boxes.device.type == "cpu":
        keep = suppression_mask_plain(boxes, scores, iou_thres)
    else:
        raise ValueError(f"suppression_mask: unsupported device {boxes.device}")
    return keep[0] if single else keep


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, lower index first among
    equal values (a stable sort keeps index order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.45,
        max_out: int | None = None) -> torch.Tensor:
    """Class-agnostic NMS for one image: keep mask [N] aligned with the inputs."""
    order = torch.argsort(-scores, stable=True)
    keep_sorted = suppression_mask(boxes[order], scores[order], iou_thres)
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    if max_out is not None and max_out < boxes.shape[0]:
        surv_scores = torch.where(keep, scores, float("-inf"))
        thresh = _top_k(surv_scores, max_out)[0][-1]
        keep = keep & (surv_scores >= thresh)
    return keep


def nms_candidates(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    pre_nms_top_k: int = 1024,
    class_agnostic: bool = False,
    box_format: str = "xywh",
    class_offset: float = CLASS_OFFSET,
    score_mode: str = "obj_cls",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top-K candidates of [B, N, 5 + C] predictions, in descending
    score order: (boxes [B, K, 4] float32 xyxy, class-offset boxes to
    suppress over, scores [B, K] float32 with -inf for the invalid ones,
    classes [B, K] int32). The last three are `suppression_mask`'s input."""
    if prediction.ndim != 3:
        raise ValueError(
            f"batched_non_max_suppression expects [B, N, 5+C], got shape "
            f"{tuple(prediction.shape)}")
    n, width = prediction.shape[1:]
    num_classes = width - 5
    obj = prediction[..., 4]
    cls_scores = prediction[..., 5:] * obj[..., None]
    scores_all = obj if score_mode == "obj" else cls_scores.amax(dim=-1)
    classes_all = cls_scores.argmax(dim=-1).to(torch.int32)
    valid = obj > conf_thres

    masked_scores = torch.where(valid, scores_all, float("-inf"))
    k = min(pre_nms_top_k, n)
    top_scores, top_idx = _top_k(masked_scores, k)
    top_scores = top_scores.float()
    boxes = torch.gather(prediction[..., :4], 1,
                         top_idx[..., None].expand(-1, -1, 4)).float()
    if box_format == "xywh":
        boxes = xywh2xyxy(boxes)
    top_classes = torch.gather(classes_all, 1, top_idx)

    if class_agnostic or num_classes == 1:
        nms_boxes = boxes
    else:
        nms_boxes = boxes + (top_classes.to(boxes.dtype) * class_offset)[..., None]
    return boxes, nms_boxes, top_scores, top_classes


def batched_non_max_suppression(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    pre_nms_top_k: int = 1024,
    class_agnostic: bool = False,
    box_format: str = "xywh",
    class_offset: float = CLASS_OFFSET,
    score_mode: str = "obj_cls",
) -> Detections:
    """Batch NMS: [B, N, 5 + C] rows (box[4], objectness, class scores[C])
    -> Detections with a leading batch dim.

    score_mode 'obj_cls' ranks and reports obj * max(cls); 'obj' ranks and
    reports raw objectness. Class = argmax(obj * cls) in both modes (the
    first maximum, as in JAX). With bf16 predictions everything after the
    top-K gather runs in float32."""
    boxes, nms_boxes, top_scores, top_classes = nms_candidates(
        prediction, conf_thres, pre_nms_top_k, class_agnostic, box_format,
        class_offset, score_mode)
    k = top_scores.shape[-1]
    keep = suppression_mask(nms_boxes, top_scores, iou_thres)
    final_scores = torch.where(keep, top_scores, float("-inf"))
    out_scores, out_idx = _top_k(final_scores, min(max_det, k))
    out_valid = out_scores > float("-inf")
    out_boxes = torch.gather(boxes, 1, out_idx[..., None].expand(-1, -1, 4))
    return Detections(
        boxes=torch.where(out_valid[..., None], out_boxes, 0.0),
        scores=torch.where(out_valid, out_scores, 0.0),
        classes=torch.where(out_valid, torch.gather(top_classes, 1, out_idx), -1),
        valid=out_valid,
    )


def non_max_suppression(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    pre_nms_top_k: int = 1024,
    class_agnostic: bool = False,
    box_format: str = "xywh",
    class_offset: float = CLASS_OFFSET,
    score_mode: str = "obj_cls",
) -> Detections:
    """Single-image NMS over raw predictions [N, 5 + C]: the batched
    function on a batch of one."""
    if prediction.ndim != 2:
        raise ValueError(
            f"non_max_suppression expects [N, 5+C] for one image, got shape "
            f"{tuple(prediction.shape)}; use batched_non_max_suppression for batches")
    det = batched_non_max_suppression(
        prediction[None], conf_thres, iou_thres, max_det, pre_nms_top_k,
        class_agnostic, box_format, class_offset, score_mode)
    return Detections(*(t[0] for t in det))
