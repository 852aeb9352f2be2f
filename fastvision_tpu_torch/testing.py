"""Seeded inputs shared by the CPU tests, the card tests and ``chip_smoke.py``.

`nms_case` stresses the exactness of greedy NMS suppression, so every place
that holds the CUDA kernel against its plain version draws the same kinds of
cases: class-offset coordinates, exact score ties, -inf tails, pairs built
to sit on the IoU threshold and, as a trained detector gives, clusters of
near-copies of a few objects (heavy suppression).

`rpn_nms_case` draws the other regime, Faster R-CNN's RPN: dense,
class-agnostic boxes in a 512-px image at IoU 0.7.

`SyntheticDetectionDataset` is an in-memory detection dataset to train and
validate on where no image files can be written or decoded (no cv2);
`write_detection_dataset` writes its samples to disk as ``.bmp`` files,
which the port reads without cv2, in the layout `DetectionDataset` reads.
`write_classification_dataset` writes a folder-per-class ``.bmp`` tree,
the layout `ClassificationDataset` reads; `write_video_dataset` a
folder-per-class tree of clips stored as directories of ``.bmp`` frames,
the layout `VideoFolderDataset` reads.
"""
from __future__ import annotations

import os

import numpy as np


def nms_case(seed: int, b: int, k: int, iou_thres: float = 0.45, *, ties: bool = True,
             neg_inf_tail: bool = True, class_offset: float | None = 4096.0,
             on_threshold: bool = True, num_classes: int = 80,
             clusters: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """-> (boxes [b, k, 4] float32 xyxy, scores [b, k] float32), each image's
    scores sorted descending (the suppression contract).

    ties: scores quantized to a few levels, so runs of equal scores occur.
    neg_inf_tail: the last quarter of each image scores -inf (invalid).
    class_offset: boxes shifted by class * offset, classes 0..num_classes-1,
      as the class-aware NMS does before suppression (None: no shift).
    on_threshold: every other box is a copy of its predecessor narrowed to
      ``iou_thres`` of its width, so the pair's IoU is the threshold up to
      float32 rounding.
    clusters: each image holds this many objects (one class each), and each
      candidate is a copy of one object's box jittered by ~5% of its size,
      scored by the object's peak score falling off with the jitter, so most
      candidates are suppressed by their cluster's best (None: independent
      uniform boxes)."""
    rng = np.random.default_rng(seed)
    cls = None
    if clusters:
        boxes, cls, scores = _clustered(rng, b, k, clusters, num_classes)
    else:
        xy = rng.uniform(0, 400, (b, k, 2))
        wh = rng.uniform(4, 120, (b, k, 2))
        boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    if on_threshold and k > 1:
        src = boxes[:, 0:-1:2]
        partner = src.copy()
        partner[..., 2] = src[..., 0] + (src[..., 2] - src[..., 0]) * np.float32(iou_thres)
        boxes[:, 1::2] = partner
    if class_offset is not None:
        if cls is None:
            cls = rng.integers(0, num_classes, (b, k, 1)).astype(np.float32)
        if on_threshold and k > 1:
            cls[:, 1::2] = cls[:, 0:-1:2]  # a pair shares its class
        boxes = (boxes + cls * np.float32(class_offset)).astype(np.float32)
    if not clusters:
        scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    if ties:
        scores = (np.round(scores * 8) / 8).astype(np.float32)
    scores = -np.sort(-scores, axis=-1, kind="stable")
    if neg_inf_tail:
        scores[:, k - k // 4:] = -np.inf
    return boxes, np.ascontiguousarray(scores)


def rpn_nms_case(seed: int, b: int, k: int, image_size: int = 512,
                 stride: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """Inputs of the Faster R-CNN RPN's proposal NMS -> (boxes [b, k, 4]
    float32 xyxy, scores [b, k] float32 sorted descending): k of the
    (image_size / stride)^2 x 9 anchors (scales 8, 16, 32 x stride, ratios
    0.5, 1, 2) decoded with N(0, 0.2) deltas and clipped to the image, so
    large boxes overlap densely, as the RPN's do. No class offset; the
    lowest 2% score -inf, as min-size-filtered proposals do."""
    rng = np.random.default_rng(seed)
    cells = image_size // stride
    sizes = np.array([[s * stride / r**0.5, s * stride * r**0.5]
                      for r in (0.5, 1.0, 2.0) for s in (8, 16, 32)])  # [9, (w, h)]
    pick = rng.integers(0, cells * cells * 9, (b, k))
    cy, cx = ((pick // 9) // cells + 0.5) * stride, ((pick // 9) % cells + 0.5) * stride
    wh = sizes[pick % 9] * np.exp(np.clip(rng.normal(0, 0.2, (b, k, 2)), -4, 4))
    ctr = np.stack([cx, cy], -1) + rng.normal(0, 0.2, (b, k, 2)) * sizes[pick % 9]
    boxes = np.clip(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1), 0, image_size)
    scores = -np.sort(-rng.normal(0, 2, (b, k)), axis=-1).astype(np.float32)
    scores[:, k - k // 50:] = -np.inf
    return boxes.astype(np.float32), np.ascontiguousarray(scores)


def _clustered(rng: np.random.Generator, b: int, k: int, n: int, num_classes: int,
               jitter: float = 0.05) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """k candidates around n objects per image -> (boxes [b, k, 4] float32,
    classes [b, k, 1] float32, scores [b, k] float32), sorted together by
    descending score."""
    obj = rng.integers(0, n, (b, k))
    xy = rng.uniform(0, 400, (b, n, 2))
    wh = rng.uniform(16, 160, (b, n, 2))
    obj_cls = rng.integers(0, num_classes, (b, n)).astype(np.float32)
    peak = rng.uniform(0.3, 1.0, (b, n))
    noise = rng.normal(0, jitter, (b, k, 4))
    size = np.take_along_axis(wh, obj[..., None], axis=1)
    x1y1 = np.take_along_axis(xy, obj[..., None], axis=1) + noise[..., :2] * size
    boxes = np.concatenate([x1y1, x1y1 + size * (1 + noise[..., 2:])], axis=-1)
    falloff = np.exp(-0.5 * (noise ** 2).sum(-1) / (4 * jitter ** 2))
    scores = np.take_along_axis(peak, obj, axis=1) * falloff
    order = np.argsort(-scores, axis=-1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], axis=1).astype(np.float32)
    cls = np.take_along_axis(obj_cls, np.take_along_axis(obj, order, axis=1), axis=1)
    scores = np.take_along_axis(scores, order, axis=1).astype(np.float32)
    return boxes, cls[..., None], scores


class SyntheticDetectionDataset:
    """Seeded in-memory detection samples with the ``DetectionDataset``
    interface: ``ds[i]`` -> (uint8 RGB image [H, W, 3], pixel-xyxy labels
    [n, 5] float32 (cls, x1, y1, x2, y2), id).

    Each image is uniform noise at one of ``sizes`` (cycled by index) with
    1 to ``max_objects`` filled rectangles, each in its class's colour, so
    the classes can be learnt from colour and the boxes from the edges.
    Sample ``i`` depends only on (seed, i)."""

    def __init__(self, n: int, num_classes: int = 80, seed: int = 0,
                 sizes=((416, 416), (480, 640), (640, 360), (375, 500), (300, 200)),
                 max_objects: int = 4):
        self.n = n
        self.num_classes = num_classes
        self.seed = seed
        self.sizes = tuple(tuple(s) for s in sizes)
        self.max_objects = max_objects
        self.colours = np.random.default_rng(seed).integers(0, 256, (num_classes, 3), np.uint8)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int):
        if not 0 <= idx < self.n:
            raise IndexError(idx)
        rng = np.random.default_rng((self.seed, idx))
        h, w = self.sizes[idx % len(self.sizes)]
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        labels = []
        for _ in range(int(rng.integers(1, self.max_objects + 1))):
            c = int(rng.integers(0, self.num_classes))
            bw, bh = int(rng.uniform(0.1, 0.5) * w), int(rng.uniform(0.1, 0.5) * h)
            x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            image[y1 : y1 + bh, x1 : x1 + bw] = self.colours[c]
            labels.append([c, x1, y1, x1 + bw, y1 + bh])
        return image, np.asarray(labels, np.float32).reshape(-1, 5), f"synthetic_{idx}"


def write_detection_dataset(root: str, n: int,
                            sizes=((416, 416), (480, 640), (640, 360), (375, 500), (300, 200)),
                            seed: int = 0, splits=("train", "val"), num_classes: int = 80,
                            max_objects: int = 4) -> str:
    """Write ``n`` `SyntheticDetectionDataset` samples per split as
    ``<root>/<split>/images/<id>.bmp`` + ``labels/<id>.txt`` (one ``cls x1
    y1 x2 y2`` line per box, pixels). The splits are consecutive slices of
    one seeded dataset, so they share its class colours. -> root."""
    from .data.dataset import write_bmp

    ds = SyntheticDetectionDataset(n * len(splits), num_classes, seed, sizes, max_objects)
    for k, split in enumerate(splits):
        images, labels = (os.path.join(root, split, d) for d in ("images", "labels"))
        os.makedirs(images, exist_ok=True)
        os.makedirs(labels, exist_ok=True)
        for i in range(k * n, (k + 1) * n):
            image, lab, _ = ds[i]
            stem = f"{split}_{i:06d}"
            write_bmp(os.path.join(images, stem + ".bmp"), image)
            with open(os.path.join(labels, stem + ".txt"), "w") as f:
                f.writelines(f"{int(r[0])} {r[1]:g} {r[2]:g} {r[3]:g} {r[4]:g}\n" for r in lab)
    return root


def write_classification_dataset(root: str, n: int, num_classes: int = 10,
                                 sizes=((224, 224), (240, 320), (320, 180), (150, 200),
                                        (300, 260)),
                                 seed: int = 0, splits=("train", "val")) -> str:
    """Write ``n`` images per split as ``<root>/<split>/class_<c>/<id>.bmp``,
    image i of class i % num_classes and of size ``sizes[i % len(sizes)]``:
    noise over its class's colour, so that a classifier can learn the
    classes. -> root."""
    from .data.dataset import write_bmp

    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (num_classes, 3))
    for split in splits:
        for c in range(num_classes):
            os.makedirs(os.path.join(root, split, f"class_{c:03d}"), exist_ok=True)
        for i in range(n):
            c, (h, w) = i % num_classes, sizes[i % len(sizes)]
            noise = rng.integers(0, 128, (h, w, 3))
            write_bmp(os.path.join(root, split, f"class_{c:03d}", f"{split}_{i:06d}.bmp"),
                      (noise + colours[c] // 2).astype(np.uint8))
    return root


def write_video_dataset(root: str, n, num_classes: int = 4, frames: int = 40,
                        hw: tuple[int, int] = (240, 320), seed: int = 0,
                        splits=("train", "val")) -> str:
    """Write ``n`` clips per split (an int, or one count per split) as
    ``<root>/<split>/class_<c>/<split>_<i>/f<t>.bmp``: clip i of class
    i % num_classes, ``frames`` frames of ``hw``, each noise over its
    class's colour with a bright bar that moves across the frames, so that
    a model can learn the classes. -> root."""
    from .data.dataset import write_bmp

    counts = (n,) * len(splits) if isinstance(n, int) else tuple(n)
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 192, (num_classes, 3))
    h, w = hw
    for split, count in zip(splits, counts):
        for i in range(count):
            c = i % num_classes
            d = os.path.join(root, split, f"class_{c:03d}", f"{split}_{i:06d}")
            os.makedirs(d, exist_ok=True)
            clip = rng.integers(0, 64, (frames, h, w, 3), dtype=np.uint8) + colours[c].astype(
                np.uint8)
            for t in range(frames):
                x = (t * w) // frames
                clip[t, :, x : x + w // 16] = 255
                write_bmp(os.path.join(d, f"f{t:04d}.bmp"), clip[t])
    return root


def state_max_rel_diff(got: dict, want: dict, start: dict) -> dict:
    """Worst floating-point tensors of two state_dicts trained from the same
    ``start``, as {"kernels": (err, name), "others": (err, name)}: for
    kernels (rank > 1) err = max|got - want| / std(want); for the rest
    (biases, BN scale and shift, running statistics, which start as
    constants, so that their std is made by the updates alone) err =
    max|got - want| / max(std(want), max|want - start|)."""
    worst = {"kernels": (0.0, ""), "others": (0.0, "")}
    for k, w in want.items():
        if not w.is_floating_point() or w.numel() < 2:
            continue
        w = w.double()
        d = float((got[k].double().cpu() - w).abs().max())
        kind = "kernels" if w.ndim > 1 else "others"
        scale = float(w.std())
        if kind == "others":
            scale = max(scale, float((w - start[k].double()).abs().max()))
        if scale and d / scale > worst[kind][0]:
            worst[kind] = (d / scale, k)
    return worst
