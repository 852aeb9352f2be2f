from .classification import VGG, Darknet53, ResNet, ViT
from .detection import FasterRCNN, YOLOv3, faster_rcnn
from .import_jax import (
    c3d_state_dict_from_jax,
    darknet53_classifier_state_dict_from_jax,
    darknet53_state_dict_from_jax,
    faster_rcnn_state_dict_from_jax,
    resnet3d_state_dict_from_jax,
    resnet_state_dict_from_jax,
    slowfast_state_dict_from_jax,
    vgg_state_dict_from_jax,
    vit_state_dict_from_jax,
    yolov3_state_dict_from_jax,
)
from .import_torch import (
    c3d_state_dict_from_reference,
    frcnn_state_dict_from_reference,
    state_dict_for_port,
)

__all__ = ["VGG", "Darknet53", "ResNet", "ViT", "FasterRCNN", "YOLOv3", "faster_rcnn",
           "c3d_state_dict_from_jax", "darknet53_classifier_state_dict_from_jax",
           "darknet53_state_dict_from_jax", "faster_rcnn_state_dict_from_jax",
           "resnet3d_state_dict_from_jax", "resnet_state_dict_from_jax",
           "slowfast_state_dict_from_jax", "vgg_state_dict_from_jax", "vit_state_dict_from_jax",
           "yolov3_state_dict_from_jax", "c3d_state_dict_from_reference",
           "frcnn_state_dict_from_reference", "state_dict_for_port"]
