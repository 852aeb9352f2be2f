from .classification import Darknet53
from .detection import YOLOv3
from .import_jax import darknet53_state_dict_from_jax, yolov3_state_dict_from_jax

__all__ = ["Darknet53", "YOLOv3", "darknet53_state_dict_from_jax", "yolov3_state_dict_from_jax"]
