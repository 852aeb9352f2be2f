from .classification import VGG, Darknet53
from .detection import FasterRCNN, YOLOv3, faster_rcnn
from .import_jax import (
    darknet53_state_dict_from_jax,
    faster_rcnn_state_dict_from_jax,
    yolov3_state_dict_from_jax,
)
from .import_torch import frcnn_state_dict_from_reference

__all__ = ["VGG", "Darknet53", "FasterRCNN", "YOLOv3", "faster_rcnn",
           "darknet53_state_dict_from_jax", "faster_rcnn_state_dict_from_jax",
           "yolov3_state_dict_from_jax", "frcnn_state_dict_from_reference"]
