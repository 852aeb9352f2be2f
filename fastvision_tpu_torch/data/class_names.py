"""Class-name lists of common datasets (port of
fastvision_tpu/data/class_names.py): COCO, VOC and CIFAR-10 as constants;
ImageNet, Kinetics-400, UCF-101 and Sports-1M as package data under
``descriptors/*.yaml``, read at first use by `categories_for` (with
PyYAML). `make_descriptor` builds, and writes as YAML, a config for one of
them."""
from __future__ import annotations

import functools
import os

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

CIFAR10_CLASSES = (
    "airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse",
    "ship", "truck",
)

# name -> (num_classes, categories, or None for a list under descriptors/<name>.yaml)
DATASETS = {
    "coco": (80, COCO_CLASSES),
    "voc": (20, VOC_CLASSES),
    "cifar10": (10, CIFAR10_CLASSES),
    "imagenet": (1000, None),
    "kinetics400": (400, None),
    "ucf101": (101, None),
    "sports1m": (487, None),
}

def categories_for(name: str) -> tuple:
    """The full category list of a dataset of `DATASETS`."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASETS)}")
    num_classes, categories = DATASETS[name]
    return categories if categories is not None else _descriptor_categories(name, num_classes)


@functools.cache
def _descriptor_categories(name: str, num_classes: int) -> tuple:
    import yaml

    path = os.path.join(os.path.dirname(__file__), "descriptors", f"{name}.yaml")
    with open(path, encoding="utf-8") as f:
        cats = tuple(yaml.safe_load(f)["categories"])
    if len(cats) != num_classes:
        raise ValueError(f"{path}: {len(cats)} categories != num_classes {num_classes}")
    return cats


def make_descriptor(name: str, data_root: str, out_path: str | None = None,
                    input_size: int = 416) -> dict:
    """A config tree ({"data": ..., "model": ...}) for a dataset of
    `DATASETS` at ``data_root``, written as YAML to ``out_path`` where one
    is given."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASETS)}")
    num_classes, _ = DATASETS[name]
    desc = {
        "data": {
            "data_root": data_root,
            "train_dir": "train",
            "val_dir": "val",
            "test_dir": "test",
            "num_classes": num_classes,
            "categories": list(categories_for(name)),
            "input_size": input_size,
        },
        "model": {"num_classes": num_classes},
    }
    if out_path:
        import yaml

        with open(out_path, "w") as f:
            yaml.safe_dump(desc, f, sort_keys=False)
    return desc
