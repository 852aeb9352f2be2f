"""Box geometry, IoU and NMS on torch tensors (port of fastvision_tpu.ops)."""
from .anchors import COCO_ANCHORS
from .box import box_area, clip_boxes, xywh2xyxy, xywhn2xyxy, xyxy2xywh, xyxy2xywhn
from .box_coder import decode_boxes, encode_boxes
from .grid import grid
from .iou import box_iou, box_iou_matrix, cal_iou, cal_iou_batch, wh_iou, wh_iou_matrix
from .map import (
    MAPResult,
    MeanAveragePrecision,
    compute_ap,
    match_predictions,
    match_predictions_device,
)
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
from .one_hot import one_hot
from .roi_align import roi_align, roi_align_mxu, roi_align_single

__all__ = [
    "COCO_ANCHORS", "box_area", "clip_boxes", "xywh2xyxy", "xywhn2xyxy",
    "xyxy2xywh", "xyxy2xywhn", "grid", "box_iou", "box_iou_matrix", "cal_iou",
    "cal_iou_batch", "wh_iou", "wh_iou_matrix", "CLASS_OFFSET", "Detections",
    "batched_non_max_suppression", "class_offset_for", "nms", "nms_candidates",
    "non_max_suppression", "suppression_mask", "MAPResult", "MeanAveragePrecision",
    "compute_ap", "match_predictions", "match_predictions_device", "one_hot", "decode_boxes", "encode_boxes",
    "roi_align", "roi_align_mxu", "roi_align_single",
]
