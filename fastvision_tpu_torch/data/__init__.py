from .augment import Augmentation, HorizontalFlip, Op, VerticalFlip
from .dataset import (
    IMG_EXTS,
    DetectionDataset,
    boxes_to_normalized_xywh,
    imread_rgb,
    letterbox,
    pad_labels,
    read_label_file,
)
from .pipeline import DetectionLoader, normalize_images, prefetch_to_device

__all__ = [
    "Augmentation", "HorizontalFlip", "Op", "VerticalFlip", "IMG_EXTS", "DetectionDataset",
    "boxes_to_normalized_xywh", "imread_rgb", "letterbox", "pad_labels", "read_label_file",
    "DetectionLoader", "normalize_images", "prefetch_to_device",
]
