"""Box geometry, IoU and NMS on torch tensors (port of fastvision_tpu.ops)."""
from .anchors import COCO_ANCHORS
from .box import box_area, clip_boxes, xywh2xyxy, xywhn2xyxy, xyxy2xywh, xyxy2xywhn
from .grid import grid
from .iou import box_iou, box_iou_matrix, cal_iou, cal_iou_batch, wh_iou, wh_iou_matrix
from .nms import (
    CLASS_OFFSET,
    Detections,
    batched_non_max_suppression,
    class_offset_for,
    nms,
    nms_candidates,
    non_max_suppression,
    suppression_mask,
)

__all__ = [
    "COCO_ANCHORS", "box_area", "clip_boxes", "xywh2xyxy", "xywhn2xyxy",
    "xyxy2xywh", "xyxy2xywhn", "grid", "box_iou", "box_iou_matrix", "cal_iou",
    "cal_iou_batch", "wh_iou", "wh_iou_matrix", "CLASS_OFFSET", "Detections",
    "batched_non_max_suppression", "class_offset_for", "nms", "nms_candidates",
    "non_max_suppression", "suppression_mask",
]
