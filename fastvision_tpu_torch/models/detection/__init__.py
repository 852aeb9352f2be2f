from .yolov3 import YOLOv3, YOLOv3Head, YOLOv3Neck, upsample2x

__all__ = ["YOLOv3", "YOLOv3Head", "YOLOv3Neck", "upsample2x"]
