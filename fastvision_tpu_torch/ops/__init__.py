"""Box geometry, IoU, NMS, mAP and accuracy on torch tensors (port of
fastvision_tpu.ops)."""
from .accuracy import Accuracy, accuracy
from .anchors import COCO_ANCHORS, AnchorGenerator, kmeans_anchors
from .box import box_area, clip_boxes, xywh2xyxy, xywhn2xyxy, xyxy2xywh, xyxy2xywhn
from .box_coder import decode_boxes, encode_boxes
from .grid import grid
from .image import (
    hflip_boxes_xywhn,
    hflip_images,
    letterbox_batch,
    letterbox_single,
    pack_canvas,
)
from .iou import box_iou, box_iou_matrix, cal_iou, cal_iou_batch, wh_iou, wh_iou_matrix
from .map import (
    CalculateMAP,
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
    multilabel_candidates,
    nms,
    nms_candidates,
    non_max_suppression,
    non_max_suppression_multilabel,
    suppression_mask,
)
from .one_hot import one_hot
from .roi_align import roi_align, roi_align_mxu, roi_align_single

__all__ = [
    "Accuracy", "accuracy", "COCO_ANCHORS", "AnchorGenerator", "kmeans_anchors", "box_area", "clip_boxes", "xywh2xyxy", "xywhn2xyxy",
    "xyxy2xywh", "xyxy2xywhn", "grid", "hflip_boxes_xywhn", "hflip_images", "letterbox_batch",
    "letterbox_single", "pack_canvas", "box_iou", "box_iou_matrix", "cal_iou",
    "cal_iou_batch", "wh_iou", "wh_iou_matrix", "CLASS_OFFSET", "Detections",
    "batched_non_max_suppression", "class_offset_for", "multilabel_candidates", "nms",
    "nms_candidates", "non_max_suppression", "non_max_suppression_multilabel", "suppression_mask", "CalculateMAP", "MAPResult", "MeanAveragePrecision",
    "compute_ap", "match_predictions", "match_predictions_device", "one_hot", "decode_boxes",
    "encode_boxes",
    "roi_align", "roi_align_mxu", "roi_align_single",
]
