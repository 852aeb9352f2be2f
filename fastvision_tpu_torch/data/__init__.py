from .augment import (
    Augmentation,
    HorizontalFlip,
    HSVJitter,
    Op,
    VerticalFlip,
    build_augmentation,
    hsv_to_rgb,
    rgb_to_hsv,
)
from .dataset import (
    IMG_EXTS,
    ClassificationDataset,
    DetectionDataset,
    boxes_to_normalized_xywh,
    imread_rgb,
    imwrite_rgb,
    letterbox,
    pad_labels,
    read_bmp,
    read_label_file,
    write_bmp,
)
from .mosaic import mosaic4
from .decode_pool import DecodePool
from .pipeline import (
    ClassificationLoader,
    DetectionLoader,
    normalize_images,
    parse_worker_backend,
    prefetch_to_device,
)

__all__ = [
    "Augmentation", "HorizontalFlip", "HSVJitter", "Op", "VerticalFlip", "build_augmentation",
    "hsv_to_rgb", "rgb_to_hsv", "IMG_EXTS", "ClassificationDataset", "DetectionDataset",
    "boxes_to_normalized_xywh", "imread_rgb", "imwrite_rgb", "letterbox", "pad_labels", "read_bmp", "read_label_file",
    "write_bmp", "mosaic4", "DecodePool", "ClassificationLoader", "DetectionLoader",
    "normalize_images", "parse_worker_backend", "prefetch_to_device",
]
