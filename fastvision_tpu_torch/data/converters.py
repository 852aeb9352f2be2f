"""Dataset converters into the fastvision layout (port of
fastvision_tpu/data/converters.py): ``<out>/<split>/{images,labels}``, one
``labels/<stem>.txt`` an image with lines ``class x1 y1 x2 y2`` (pixels,
0-based classes). Images are symlinked (``copy_images=False``) or copied."""
from __future__ import annotations

import json
import os
import shutil
import xml.etree.ElementTree as ET
from typing import Sequence

from .class_names import VOC_CLASSES

_COCO_MISSING_IDS = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}


def _place(src: str, dst: str, copy: bool) -> None:
    if os.path.exists(dst):
        return
    if copy:
        shutil.copyfile(src, dst)
    else:
        os.symlink(os.path.abspath(src), dst)


def coco_80_to_91_ids() -> list[int]:
    """The 80 contiguous class indices -> COCO annotation category ids
    (1..90 with gaps), as the official evaluator expects them."""
    return [cid for cid in range(1, 91) if cid not in _COCO_MISSING_IDS]


def coco_90_to_80_map() -> dict[int, int]:
    """COCO annotation category ids (1..90, with gaps) -> the contiguous
    0..79: the inverse of `coco_80_to_91_ids`."""
    return {cid: i for i, cid in enumerate(coco_80_to_91_ids())}


def coco_to_fastvision(ann_json: str, images_dir: str, out_dir: str, split: str = "train",
                       copy_images: bool = False) -> int:
    """COCO instances JSON -> the fastvision layout under ``out_dir/split``;
    crowd boxes, unknown categories and empty boxes are left out, images
    missing from ``images_dir`` skipped. -> the number of images written."""
    with open(ann_json) as f:
        coco = json.load(f)
    cat_map = coco_90_to_80_map()
    img_out = os.path.join(out_dir, split, "images")
    lab_out = os.path.join(out_dir, split, "labels")
    os.makedirs(img_out, exist_ok=True)
    os.makedirs(lab_out, exist_ok=True)

    by_image: dict[int, list] = {}
    for ann in coco.get("annotations", []):
        if ann.get("iscrowd"):
            continue
        x, y, w, h = ann["bbox"]  # COCO xywh (top-left)
        cls = cat_map.get(ann["category_id"])
        if cls is None or w <= 0 or h <= 0:
            continue
        by_image.setdefault(ann["image_id"], []).append((cls, x, y, x + w, y + h))

    count = 0
    for info in coco["images"]:
        stem = os.path.splitext(info["file_name"])[0]
        src = os.path.join(images_dir, info["file_name"])
        if not os.path.exists(src):
            continue
        _place(src, os.path.join(img_out, info["file_name"]), copy_images)
        with open(os.path.join(lab_out, stem + ".txt"), "w") as f:
            for cls, x1, y1, x2, y2 in by_image.get(info["id"], []):
                f.write(f"{cls} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f}\n")
        count += 1
    return count


def voc_to_fastvision(voc_root: str, out_dir: str, image_set: str = "train",
                      year: str = "2012", split: str | None = None, copy_images: bool = False,
                      classes: Sequence[str] = VOC_CLASSES) -> int:
    """VOC XML + ImageSets (``voc_root`` = ``VOCdevkit/VOC<year>``) -> the
    fastvision layout under ``out_dir/(split or image_set)``; difficult
    objects and unknown names are left out, coordinates made 0-based. ->
    the number of images written."""
    split = split or image_set
    cls_idx = {name: i for i, name in enumerate(classes)}
    with open(os.path.join(voc_root, "ImageSets", "Main", image_set + ".txt")) as f:
        ids = [line.split()[0] for line in f if line.strip()]

    img_out = os.path.join(out_dir, split, "images")
    lab_out = os.path.join(out_dir, split, "labels")
    os.makedirs(img_out, exist_ok=True)
    os.makedirs(lab_out, exist_ok=True)

    count = 0
    for stem in ids:
        src = os.path.join(voc_root, "JPEGImages", stem + ".jpg")
        xml_path = os.path.join(voc_root, "Annotations", stem + ".xml")
        if not (os.path.exists(src) and os.path.exists(xml_path)):
            continue
        rows = []
        for obj in ET.parse(xml_path).getroot().iter("object"):
            name = obj.findtext("name")
            if name not in cls_idx or obj.findtext("difficult") == "1":
                continue
            bb = obj.find("bndbox")
            x1, y1, x2, y2 = (float(bb.findtext(t)) - 1  # VOC is 1-based
                              for t in ("xmin", "ymin", "xmax", "ymax"))
            rows.append(f"{cls_idx[name]} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f}")
        _place(src, os.path.join(img_out, stem + ".jpg"), copy_images)
        with open(os.path.join(lab_out, stem + ".txt"), "w") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))
        count += 1
    return count
