from .augment import (
    BGR2RGB,
    IMAGENET_MEAN,
    IMAGENET_STD,
    OP_REGISTRY,
    Augmentation,
    Blur,
    CenterCrop,
    ChannelShuffle,
    HistEqualize,
    HorizontalFlip,
    HSVJitter,
    Jitter,
    Normalization,
    Op,
    Padding,
    RandomCrop,
    Resize,
    ResizeByMax,
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
from .class_names import categories_for, make_descriptor
from .converters import (
    coco_80_to_91_ids,
    coco_90_to_80_map,
    coco_to_fastvision,
    voc_to_fastvision,
)
from .mosaic import mosaic4
from .decode_pool import DecodePool
from .video_dataset import VideoClipLoader, VideoFolderDataset
from .video_sampler import load_clip, sample_clip_from_array, sample_indices
from .pipeline import (
    ClassificationLoader,
    DetectionLoader,
    host_shard_order,
    normalize_images,
    parse_worker_backend,
    prefetch_to_device,
    resolve_host_shard,
)

__all__ = [
    "BGR2RGB", "IMAGENET_MEAN", "IMAGENET_STD", "OP_REGISTRY", "Augmentation", "Blur",
    "CenterCrop", "ChannelShuffle", "HistEqualize", "HorizontalFlip", "HSVJitter", "Jitter",
    "Normalization", "Op", "Padding", "RandomCrop", "Resize", "ResizeByMax", "VerticalFlip",
    "build_augmentation", "hsv_to_rgb", "rgb_to_hsv", "IMG_EXTS", "ClassificationDataset", "DetectionDataset",
    "boxes_to_normalized_xywh", "imread_rgb", "imwrite_rgb", "letterbox", "pad_labels", "read_bmp", "read_label_file",
    "write_bmp", "mosaic4", "DecodePool", "ClassificationLoader", "DetectionLoader",
    "host_shard_order", "normalize_images", "parse_worker_backend", "prefetch_to_device",
    "resolve_host_shard", "VideoClipLoader",
    "VideoFolderDataset", "load_clip", "sample_clip_from_array", "sample_indices",
    "categories_for", "make_descriptor", "coco_80_to_91_ids", "coco_90_to_80_map",
    "coco_to_fastvision", "voc_to_fastvision",
]
