from .faster_rcnn import (
    BOX_STD,
    Draws,
    FasterRCNN,
    FastHead,
    RPNHead,
    anchor_grid,
    detection_candidates,
    fastrcnn_postprocess,
    faster_rcnn,
    filter_proposals,
    make_base_anchors,
    make_draws,
    proposal_candidates,
    random_sample_mask,
    rpn_loss,
    sample_rois,
    select_detections,
    select_proposals,
)
from .yolov3 import YOLOv3, YOLOv3Head, YOLOv3Neck, upsample2x

__all__ = [
    "BOX_STD", "Draws", "FasterRCNN", "FastHead", "RPNHead", "anchor_grid",
    "detection_candidates", "fastrcnn_postprocess", "faster_rcnn", "filter_proposals",
    "make_base_anchors", "make_draws", "proposal_candidates", "random_sample_mask",
    "rpn_loss", "sample_rois", "select_detections", "select_proposals",
    "YOLOv3", "YOLOv3Head", "YOLOv3Neck", "upsample2x",
]
