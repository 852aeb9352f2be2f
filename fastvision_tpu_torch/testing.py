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

`INT8_CONV_CASES` and `int8_conv_case` are the shapes and seeded inputs on
which the int8 conv's card route, its plain version (and on the CPU the JAX
package's int32 conv) are held bit-equal; `INT8_IMPLICIT_CASES` the edge
cases of the implicit-GEMM kernel (``csrc/int8_conv.cu``), drawn by the
same function.
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


# (id, batch, Cin, H, W, N, kernel, stride, groups) of the int8 conv's
# exactness checks: 1x1 and 3x3 at stride 1 and 2, the ResNet's 7x7 stem,
# Cin = 3 (K = 27, padded to 32), K and N not multiples of 8, ResNeXt's 32
# groups of 4 channels, a map with fewer than 17 output pixels
INT8_CONV_CASES = (
    ("1x1", 2, 16, 9, 7, 24, 1, 1, 1),
    ("1x1_s2", 2, 16, 9, 7, 32, 1, 2, 1),
    ("1x1_k12", 2, 12, 5, 5, 8, 1, 1, 1),
    ("3x3", 2, 8, 9, 7, 16, 3, 1, 1),
    ("3x3_s2", 2, 8, 10, 10, 16, 3, 2, 1),
    ("7x7_stem", 2, 3, 20, 18, 16, 7, 2, 1),
    ("cin3", 2, 3, 12, 12, 32, 3, 1, 1),
    ("n12", 2, 8, 7, 7, 12, 3, 1, 1),
    ("groups32", 1, 128, 6, 5, 128, 3, 1, 32),
    ("groups32_s2", 2, 128, 6, 6, 256, 3, 2, 32),
    ("tiny_map", 1, 16, 3, 3, 16, 3, 2, 1),
)


# the implicit-GEMM kernel's edge cases, in INT8_CONV_CASES' layout (groups
# 1): a partial last tile of rows (B = 1 at 13 x 13: M = 169) with N = 1024;
# N = 32; C = 1024 at 3 x 3 (K = 9216); stride 2 at 3 x 3 and at 1 x 1
# (ResNet-50's downsample); C = 32 and C = 96 (32-byte chunks of K), N = 40
# and N = 200 (partial tiles of columns); N = 8 at stride 2 on odd H and W
# (M = 168); "saturated": every value +-127, two output channels reaching
# the largest accumulators, +-127^2 * 9216 ~ +-1.5e8
INT8_IMPLICIT_CASES = (
    ("m169_n1024", 1, 512, 13, 13, 1024, 3, 1, 1),
    ("n32", 2, 64, 20, 18, 32, 1, 1, 1),
    ("c1024_3x3", 1, 1024, 13, 13, 512, 3, 1, 1),
    ("s2_3x3", 2, 32, 33, 31, 64, 3, 2, 1),
    ("s2_1x1", 2, 256, 14, 14, 512, 1, 2, 1),
    ("c32_n40", 2, 32, 9, 7, 40, 3, 1, 1),
    ("c96_n200", 1, 96, 11, 12, 200, 3, 1, 1),
    ("n8_s2_odd", 3, 64, 15, 13, 8, 3, 2, 1),
    ("saturated", 1, 1024, 5, 6, 64, 3, 1, 1),
)


def int8_conv_case(case: tuple, extreme: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """-> (activations int8 [B, Cin, H, W], OIHW weights int8 [N, Cin /
    groups, k, k]) for an `INT8_CONV_CASES` or `INT8_IMPLICIT_CASES` entry,
    seeded by its id; ``extreme``: a quarter of the values at +-127, the
    largest sums (the id "saturated": every value, signs aligned so that
    output channels 0 and 1 sum to +-127^2 * K inside the halo)."""
    name, b, cin, h, w, n, k, _, groups = case
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.integers(-127, 128, (b, cin, h, w)).astype(np.int8)
    wq = rng.integers(-127, 128, (n, cin // groups, k, k)).astype(np.int8)
    if name == "saturated":  # output channels 0 and 1 meet the input's signs: +-127^2 * K
        sign = np.where(rng.random(cin) < 0.5, 127, -127).astype(np.int8)
        x[:] = sign[None, :, None, None]
        wq[:] = np.where(rng.random(wq.shape) < 0.5, 127, -127)
        wq[0], wq[1] = sign[:, None, None], -sign[:, None, None]
    elif extreme:
        for a in (x, wq):
            sel = rng.random(a.shape) < 0.25
            a[sel] = np.where(rng.random(a.shape) < 0.5, 127, -127)[sel]
    return x, wq


def quantize_tie_cases(seed: int = 0, n_scales: int = 24) -> tuple[np.ndarray, np.ndarray]:
    """Activation values at and around the half-integer multiples of a
    scale, where a quantize that rounds v / scale in any way but the IEEE
    division's could pick the other integer: for each scale (powers of two,
    thirds, YOLOv3-like 0.0217 and log-uniform draws in [1e-3, 10]) the
    float32 values nearest (j + 1/2) * scale for j in [-130, 129] and 1 to
    4 ulps either side, and the integer multiples. -> (values float32
    [n_scales, V], scales float32 [n_scales])."""
    rng = np.random.default_rng(seed)
    fixed = [2.0 ** -7, 1.0 / 3.0, 0.1, 0.0217, 0.75]
    scales = np.array(fixed + list(10.0 ** rng.uniform(-3, 1, n_scales - len(fixed))),
                      np.float32)
    j = np.arange(-130, 130, dtype=np.float64)
    rows = []
    for s in scales.astype(np.float64):
        mids = ((j + 0.5) * s).astype(np.float32)
        near = [mids]
        up, down = mids, mids
        for _ in range(4):
            up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(-np.inf))
            near += [up, down]
        rows.append(np.concatenate(near + [(j * s).astype(np.float32)]))
    return np.stack(rows), scales


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


def blurred_noise(h: int, w: int, seed: int, ksize: int = 7) -> np.ndarray:
    """Seeded uniform noise [h, w, 3] uint8 under a ``ksize`` Gaussian blur
    (sigma as cv2 picks it for sigma 0): ``bench.py``'s COCO-like JPEG
    content, in numpy."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8).astype(np.float32)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float32) - (ksize - 1) / 2
    k = np.exp(-x * x / (2 * sigma * sigma))
    k /= k.sum()
    r = ksize // 2
    for axis in (0, 1):
        pad = [(r, r) if a == axis else (0, 0) for a in range(3)]
        p = np.pad(img, pad, mode="reflect")
        n = img.shape[axis]
        img = sum(k[i] * np.take(p, np.arange(i, i + n), axis=axis) for i in range(ksize))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def with_exif_orientation(jpeg: bytes, orientation: int) -> bytes:
    """A JPEG with an EXIF APP1 segment carrying ``orientation`` after SOI."""
    return jpeg[:2] + _exif_app1(orientation, False) + jpeg[2:]


ENCODINGS = ("baseline", "arithmetic", "lossless", "bmp")


def _jpeg_sample(args):
    path, h, w, seed, quality, orientation, encoding = args
    img = blurred_noise(h, w, seed)
    i = int(os.path.basename(path).split(".")[0])
    if encoding == "bmp":
        from .data.dataset import write_bmp

        return write_bmp(path, img)
    if encoding == "lossless":
        data = encode_lossless_jpeg(img, 1 + i % 7, 0, 8)
    else:
        data = encode_progressive_jpeg(img, *standard_jpeg_tables(quality), progressive=i % 2 == 1,
                                       arithmetic=True) if encoding == "arithmetic" \
            else encode_baseline_jpeg(img, *standard_jpeg_tables(quality))
    with open(path, "wb") as f:
        f.write(with_exif_orientation(data, orientation) if orientation > 1 else data)


def write_jpeg_detection_dataset(root: str, shapes, split: str = "val", seed: int = 0,
                                 num_classes: int = 80, quality: int = 90, orientations=None,
                                 workers: int = 0, encoding: str = "baseline") -> str:
    """Write one baseline 4:2:0 JPEG (`encode_baseline_jpeg` with libjpeg's
    tables at ``quality``; no cv2) of `blurred_noise` per (h, w) of
    ``shapes`` as ``<root>/<split>/images/<i>.jpg``, with 1-4 random boxes
    in ``labels/<i>.txt`` (pixels of the image as shown: an EXIF
    ``orientations[i]`` of 5-8 turns it to w x h). ``workers`` > 1 encodes
    in that many forked processes. ``encoding`` writes the same images
    otherwise: "arithmetic" codes the same quantized coefficients with the
    arithmetic coder (sequential at even i, progressive at odd: the baseline
    files' pixels), "lossless" as lossless JPEG (RGB-coded, predictor 1 + i
    % 7, a restart every 8 rows: the source's pixels), "bmp" as ``<i>.bmp``
    (no orientation). -> root."""
    if encoding not in ENCODINGS:
        raise ValueError(f"encoding must be one of {ENCODINGS}, got {encoding!r}")
    images, labels = (os.path.join(root, split, d) for d in ("images", "labels"))
    os.makedirs(images, exist_ok=True)
    os.makedirs(labels, exist_ok=True)
    orientations = list(orientations or [1] * len(shapes))
    rng = np.random.default_rng(seed)
    jobs = []
    for i, (h, w) in enumerate(shapes):
        o = orientations[i]
        if encoding == "bmp" and o > 1:
            raise ValueError("a BMP file carries no orientation")
        ext = ".bmp" if encoding == "bmp" else ".jpg"
        jobs.append((os.path.join(images, f"{i:05d}{ext}"), h, w, seed * 100003 + i, quality, o,
                     encoding))
        sh, sw = (w, h) if o >= 5 else (h, w)
        with open(os.path.join(labels, f"{i:05d}.txt"), "w") as f:
            for _ in range(int(rng.integers(1, 5))):
                bw, bh = rng.uniform(0.1, 0.5) * sw, rng.uniform(0.1, 0.5) * sh
                x1, y1 = rng.uniform(0, sw - bw), rng.uniform(0, sh - bh)
                f.write(f"{int(rng.integers(num_classes))} {x1:.2f} {y1:.2f} "
                        f"{x1 + bw:.2f} {y1 + bh:.2f}\n")
    if workers > 1:
        import multiprocessing

        with multiprocessing.get_context("fork").Pool(workers) as pool:
            pool.map(_jpeg_sample, jobs, chunksize=1 if encoding == "arithmetic" else 4)
    else:
        for job in jobs:
            _jpeg_sample(job)
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


# ---------------------------------------------------------------------------
# Image codec fixtures: files that cv2 and PIL write on a machine that has
# them, beside cv2's decodes, so that the port's decoder (data/codec.py) is
# held to cv2 where cv2 is absent.

ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
          34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
          37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
FULL_SIZE_HW = ((480, 640), (640, 480), (375, 500), (720, 1280))


def jpeg_tables(buf: bytes) -> tuple[dict, dict]:
    """The DQT and DHT tables of a JPEG stream, up to its first scan:
    ({id: 64 values in natural order}, {(class, id): (counts[16], symbols)})."""
    dqt, dht, pos = {}, {}, 2
    while pos + 4 <= len(buf) and buf[pos] == 0xFF and buf[pos + 1] != 0xDA:
        marker, length = buf[pos + 1], int.from_bytes(buf[pos + 2:pos + 4], "big")
        seg, pos = buf[pos + 4:pos + 2 + length], pos + 2 + length
        while marker == 0xDB and seg:
            wide, tq = seg[0] >> 4, seg[0] & 15
            vals = np.frombuffer(seg[1:1 + 64 * (wide + 1)], ">u2" if wide else np.uint8)
            q = np.zeros(64, np.int64)
            q[list(ZIGZAG)] = vals
            dqt[tq], seg = q, seg[1 + 64 * (wide + 1):]
        while marker == 0xC4 and seg:
            counts = list(seg[1:17])
            dht[(seg[0] >> 4, seg[0] & 15)] = (counts, bytes(seg[17:17 + sum(counts)]))
            seg = seg[17 + sum(counts):]
    return dqt, dht


# JPEG Annex K: the quantization tables at quality 50 (natural order) and the
# typical Huffman tables, as libjpeg (and so cv2) writes them without
# optimization
_ANNEX_K_LUMA_Q50 = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
    56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
    104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_ANNEX_K_CHROMA_Q50 = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
                               + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38)
_ANNEX_K_HUFFMAN = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16171819"
        "1a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a7374757677"
        "78797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
        "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1"
        "1718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a73747576"
        "7778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4"
        "c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


def standard_jpeg_tables(quality: int = 90) -> tuple[dict, dict]:
    """The tables libjpeg writes at ``quality`` (Annex K, scaled by
    jpeg_quality_scaling, clamped to 1..255) in `jpeg_tables`' form, so
    `encode_baseline_jpeg` runs where cv2 is absent."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    dqt = {i: np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)
           for i, base in enumerate((_ANNEX_K_LUMA_Q50, _ANNEX_K_CHROMA_Q50))}
    return dqt, dict(_ANNEX_K_HUFFMAN)


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, length: int) -> None:
        self.acc, self.n = (self.acc << length) | code, self.n + length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 255
            self.out += b"\xff\x00" if byte == 255 else bytes((byte,))
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:  # pad the last byte with 1-bits
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes((0xFF, marker)) + (len(body) + 2).to_bytes(2, "big") + body


def _jpeg_coefficients(rgb: np.ndarray, dqt: dict, sampling=(2, 2), qt16: bool = False):
    """The quantized DCT coefficients `encode_baseline_jpeg` codes: -> (h,
    w, components {id, hv, zz [block rows, block columns, 64] zigzag, bw,
    bh: the component's own block grid}, MCUs across, MCUs down,
    quantization tables, each component's table id)."""
    h, w = rgb.shape[:2]
    f = rgb.astype(np.float64)
    if rgb.ndim == 2:
        planes, factors = [f], [(1, 1)]
    elif rgb.shape[2] == 4:  # CMYK -> YCCK (libjpeg's cmyk_ycck_convert): YCbCr of 255 - CMY, K
        r, g, b = 255 - f[..., 0], 255 - f[..., 1], 255 - f[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128, f[..., 3]]
        factors = [tuple(sampling), (1, 1), (1, 1), tuple(sampling)]
    else:
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        factors = [tuple(sampling), (1, 1), (1, 1)]
    hmax, vmax = factors[0]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    k = np.arange(8)
    dct = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    dct[0] /= np.sqrt(2)
    qts = {0: dqt[0] * (3 if qt16 else 1), 1: dqt[1]}
    tq = [0, 1, 1, 0]
    comps = []
    for ci, ((hc, vc), p) in enumerate(zip(factors, planes)):
        fx, fy = hmax // hc, vmax // vc
        p = np.pad(p, ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w)), mode="edge")
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean((1, 3)) - 128
        blocks = p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", dct, blocks, dct).reshape(*blocks.shape[:2], 64)
        q = np.clip(np.round(coef / qts[tq[ci]]), -1023, 1023).astype(np.int64)
        comps.append({"id": ci + 1, "hv": (hc, vc), "zz": q[..., list(ZIGZAG)],
                      "bw": -(-(-(-w * hc // hmax)) // 8), "bh": -(-(-(-h * vc // vmax)) // 8)})
    return h, w, comps, mcux, mcuy, qts, tq


def encode_baseline_jpeg(rgb: np.ndarray, dqt: dict, dht: dict, sampling=(2, 2),
                         interleaved: bool = True, restart: int = 0, qt16: bool = False,
                         redefine: bool = False) -> bytes:
    """A minimal baseline JPEG encoder for the features cv2's encoder does
    not write: non-interleaved scans (one per component), 16-bit
    quantization tables (``qt16``: the luma table x 3, stored at 16 bits),
    restart intervals in either kind of scan, and tables redefined between
    scans (``redefine``: Huffman table 0 switches to the chroma tables and
    quantization table 0 is overwritten after the luma scan, which a decoder
    must have latched). ``dqt`` / ``dht`` come from `jpeg_tables` of a cv2
    JPEG; ``rgb`` [H, W, 3] (YCbCr, 3 components) or [H, W] (1 component)."""
    h, w, comps, mcux, mcuy, qts, tq = _jpeg_coefficients(rgb, dqt, sampling, qt16)

    def codes(table):
        counts, symbols = table
        out, code, i = {}, 0, 0
        for length, n in enumerate(counts, 1):
            for _ in range(n):
                out[symbols[i]] = (code, length)
                code, i = code + 1, i + 1
            code <<= 1
        return out

    def dqt_seg(tid, values):
        wide = int(values.max()) > 255 or (qt16 and tid == 0)
        body = bytes(((1 if wide else 0) << 4 | tid,)) + (
            values[list(ZIGZAG)].astype(">u2").tobytes() if wide
            else values[list(ZIGZAG)].astype(np.uint8).tobytes())
        return _segment(0xDB, body)

    def dht_seg(tc, th, table):
        return _segment(0xC4, bytes((tc << 4 | th,)) + bytes(table[0]) + table[1])

    def scan(members, tables):
        bits, preds, count = _BitWriter(), [0] * len(members), 0
        if len(members) == 1:
            c = members[0]
            units = [[(0, c["zz"][by, bx])] for by in range(c["bh"]) for bx in range(c["bw"])]
        else:
            units = [[(i, c["zz"][my * c["hv"][1] + y, mx * c["hv"][0] + x])
                      for i, c in enumerate(members)
                      for y in range(c["hv"][1]) for x in range(c["hv"][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        for unit in units:
            if restart and count and count % restart == 0:
                bits.flush()
                bits.out += bytes((0xFF, 0xD0 + (count // restart - 1) % 8))
                preds = [0] * len(members)
            count += 1
            for i, z in unit:
                dc, ac = tables[i]
                diff = int(z[0]) - preds[i]
                preds[i] = int(z[0])
                cat = abs(diff).bit_length()
                bits.put(*dc[cat])
                if cat:
                    bits.put(diff if diff > 0 else diff + (1 << cat) - 1, cat)
                last = 0  # zigzag index of the last nonzero coefficient coded
                for k in np.flatnonzero(z[1:]) + 1:
                    run, v, last = int(k) - last - 1, int(z[k]), int(k)
                    while run > 15:
                        bits.put(*ac[0xF0])
                        run -= 16
                    cat = abs(v).bit_length()
                    bits.put(*ac[(run << 4) | cat])
                    bits.put(v if v > 0 else v + (1 << cat) - 1, cat)
                if last != 63:  # trailing zeros
                    bits.put(*ac[0x00])
        bits.flush()
        ids = b"".join(bytes((c["id"], th << 4 | th)) for c, th in zip(members, sel))
        return _segment(0xDA, bytes((len(members),)) + ids + b"\x00\x3f\x00") + bytes(bits.out)

    luma = (codes(dht[(0, 0)]), codes(dht[(1, 0)]))
    chroma = (codes(dht[(0, 1)]), codes(dht[(1, 1)])) if len(comps) > 1 else luma
    out = bytearray(b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    for tid in sorted({tq[i] for i in range(len(comps))}):
        out += dqt_seg(tid, qts[tid])
    out += _segment(0xC0, bytes((8,)) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                    + bytes((len(comps),)) + b"".join(
                        bytes((c["id"], c["hv"][0] << 4 | c["hv"][1], tq[i]))
                        for i, c in enumerate(comps)))
    for tc in (0, 1):
        for th in ((0, 1) if len(comps) > 1 else (0,)):
            out += dht_seg(tc, th, dht[(tc, th)])
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    if interleaved:
        sel = [0, 1, 1][:len(comps)]
        out += scan(comps, [luma, chroma, chroma][:len(comps)])
    else:
        for i, c in enumerate(comps):
            sel = [0] if redefine else [min(i, 1)]
            if redefine and i == 1:  # table 0 becomes the chroma tables; qt 0 is overwritten
                out += dht_seg(0, 0, dht[(0, 1)]) + dht_seg(1, 0, dht[(1, 1)])
                out += dqt_seg(0, np.full(64, 77, np.int64))
            out += scan([c], [luma if i == 0 else chroma])
    return bytes(out + b"\xff\xd9")


# the progressive scan scripts of libjpeg's jpeg_simple_progression:
# (components, Ss, Se, Ah, Al); components index the frame's
_SCRIPT_YCC = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
               ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
               ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
               ((0,), 1, 63, 1, 0))


def _script_other(n: int) -> tuple:
    """jpeg_simple_progression's all-purpose script for ``n`` components."""
    every = tuple(range(n))
    return ((every, 0, 0, 0, 1), *(((c,), 1, 5, 0, 2) for c in every),
            *(((c,), 6, 63, 0, 2) for c in every), *(((c,), 1, 63, 2, 1) for c in every),
            (every, 0, 0, 1, 0), *(((c,), 1, 63, 1, 0) for c in every))


def _code_arrays(table) -> tuple[np.ndarray, np.ndarray]:
    """A DHT table (counts[16], symbols) -> (code [256], length [256])."""
    counts, symbols = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, i = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[i]], len_of[symbols[i]] = code, length
            code, i = code + 1, i + 1
        code <<= 1
    return code_of, len_of


def _bit_length(a: np.ndarray) -> np.ndarray:
    a = np.abs(a)
    return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1, 0)


def _pack_bits(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Entropy-coded bytes of items (code, length) in order, MSB first, the
    last byte padded with 1-bits, 0xFF stuffed with 0x00."""
    total = int(lengths.sum())
    item = np.repeat(np.arange(len(lengths)), lengths)
    pos = np.arange(total) - (np.cumsum(lengths) - lengths)[item]
    bits = (codes[item] >> (lengths[item] - 1 - pos)) & 1
    out = np.packbits(np.concatenate([bits, np.ones(-total % 8, np.int64)]).astype(np.uint8))
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def _scan_items(z: np.ndarray, comp: np.ndarray, ss: int, se: int, ah: int, al: int,
                dc_tabs, ac_tabs, interval: np.ndarray):
    """The (sort key, code, length) items of one scan over blocks ``z`` [N,
    64] (zigzag, in scan order) of components ``comp`` [N]; a DC and an AC
    part (ss = 0, se = 63) make a sequential scan. EOB runs are of one
    block. ``interval`` [N]: each block's restart interval (DC predictions
    reset there). Keys order items by (block, position, part, position of
    a refined coefficient)."""
    n = len(z)
    keys, codes, lens = [], [], []

    def key(b, k, sub, old=0):
        return ((np.asarray(b, np.int64) * 80 + k) * 16 + sub) * 64 + old

    def add(k, c, ln):
        keys.append(np.asarray(k, np.int64).ravel())
        codes.append(np.asarray(c, np.int64).ravel())
        lens.append(np.asarray(ln, np.int64).ravel())

    blocks = np.arange(n)
    if ss == 0 and ah == 0:  # DC first (or the DC of a sequential scan)
        dc = z[:, 0] >> al
        diff = dc.copy()
        for c in np.unique(comp):
            at = np.flatnonzero(comp == c)
            prev = np.concatenate([[0], dc[at[:-1]]])
            prev[np.concatenate([[True], interval[at[1:]] != interval[at[:-1]]])] = 0
            diff[at] = dc[at] - prev
        cat = _bit_length(diff)
        dcode = np.stack([_code_arrays(t)[0] for t in dc_tabs])[comp, cat]
        dlen = np.stack([_code_arrays(t)[1] for t in dc_tabs])[comp, cat]
        add(key(blocks, 0, 0), dcode, dlen)
        add(key(blocks, 0, 1), np.where(diff > 0, diff, diff + (1 << cat) - 1) & ((1 << cat) - 1), cat)
    elif ss == 0:  # DC refinement: one bit a block
        add(key(blocks, 0, 0), (z[:, 0] >> al) & 1, np.ones(n, np.int64))
    if se == 0:
        return keys, codes, lens
    lo = max(ss, 1)
    acode = np.stack([_code_arrays(t)[0] for t in ac_tabs])
    alen = np.stack([_code_arrays(t)[1] for t in ac_tabs])
    v = z[:, lo:se + 1]
    a = np.abs(v) >> al
    band = se - lo + 1
    if ah == 0:  # AC first (or the AC of a sequential scan)
        bi, ji = np.nonzero(a)
        prev = np.concatenate([[-1], ji[:-1]])
        prev[np.concatenate([[True], bi[1:] != bi[:-1]])] = -1
        run = ji - prev - 1
        size = _bit_length(a[bi, ji])
        c = comp[bi]
        zrl = np.repeat(np.arange(len(bi)), run // 16)
        nth = np.arange(len(zrl)) - np.searchsorted(zrl, zrl)
        add(key(bi[zrl], lo + ji[zrl], nth), acode[c[zrl], 0xF0], alen[c[zrl], 0xF0])
        sym = ((run % 16) << 4) | size
        add(key(bi, lo + ji, 8), acode[c, sym], alen[c, sym])
        val = np.where(v[bi, ji] > 0, a[bi, ji], (1 << size) - 1 - a[bi, ji])
        add(key(bi, lo + ji, 9), val, size)
        last = np.full(n, -1)
        np.maximum.at(last, bi, ji)
        eob = np.flatnonzero(last < band - 1)
        add(key(eob, 64, 0), acode[comp[eob], 0], alen[comp[eob], 0])
        return keys, codes, lens
    # AC refinement: newly nonzero coefficients (|v| >> al == 1) coded with
    # their zero runs, correction bits of the ones already nonzero flushed
    # after the next ZRL, new coefficient or EOB (libjpeg's encode_mcu_AC_refine)
    new, old, zero = a == 1, a > 1, a == 0
    jj = np.arange(band)
    last_new = np.where(new.any(1), band - 1 - np.argmax(new[:, ::-1], 1), -1)
    zc = np.cumsum(zero, 1) - zero  # zeros before each position
    base = np.maximum.accumulate(np.where(new, zc, 0), 1)
    base = np.concatenate([np.zeros((n, 1), np.int64), base[:, :-1]], 1)  # at the last new before
    g = (zc - base) // 16  # ZRLs due before this position, in its run
    nz = (new | old) & (jj[None] <= last_new[:, None])
    bi, ji = np.nonzero(nz)
    prev = np.concatenate([[-1], ji[:-1]])
    prev[np.concatenate([[True], bi[1:] != bi[:-1]])] = -1
    gprev = np.where((prev >= 0) & old[bi, np.maximum(prev, 0)], g[bi, np.maximum(prev, 0)], 0)
    nzrl = g[bi, ji] - gprev
    c = comp[bi]
    zrl = np.repeat(np.arange(len(bi)), nzrl)
    nth = np.arange(len(zrl)) - np.searchsorted(zrl, zrl)
    add(key(bi[zrl], lo + ji[zrl], 2 * nth), acode[c[zrl], 0xF0], alen[c[zrl], 0xF0])
    isnew = new[bi, ji]
    bn, jn, cn = bi[isnew], ji[isnew], c[isnew]
    sym = (((zc - base)[bn, jn] % 16) << 4) | 1
    add(key(bn, lo + jn, 8), acode[cn, sym], alen[cn, sym])
    add(key(bn, lo + jn, 9), (v[bn, jn] >= 0).astype(np.int64), np.ones(len(bn), np.int64))
    eob = np.flatnonzero(last_new < band - 1)
    add(key(eob, 64, 0), acode[comp[eob], 0], alen[comp[eob], 0])
    # flush events: a position with ZRLs (flush after the first) or a new coefficient
    ev = (nzrl > 0) | isnew
    ev_key = np.append(bi[ev] * 80 + ji[ev], 1 << 62)  # a sentinel past every block
    ev_sub = np.append(np.where(nzrl[ev] > 0, 1, 10), 1)
    bo, jo = np.nonzero(old)
    at = np.searchsorted(ev_key, bo * 80 + jo, side="right")
    hit = ev_key[at] < (bo + 1) * 80
    fk = np.where(hit, ev_key[at] - bo * 80, 64 - lo)
    fsub = np.where(hit, ev_sub[at], 1)
    add(key(bo, lo + fk, fsub, lo + jo), a[bo, jo] & 1, np.ones(len(bo), np.int64))
    return keys, codes, lens


# T.81 Table D.2 (libjpeg's jaricom.c): per state (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS); the last state is the fixed 0.5 estimate
_ARITH_STATES = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
_QE = tuple(q for q, *_ in _ARITH_STATES)
_NEXT_LPS = tuple(lps | sw << 7 for _, lps, _, sw in _ARITH_STATES)  # the switch flips the MPS
_NEXT_MPS = tuple(mps for _, _, mps, _ in _ARITH_STATES)
_DC_BINS, _AC_BINS = 64, 256  # statistics bins per table (jcarith.c)
_FIXED_BIN = 4 * _DC_BINS + 4 * _AC_BINS  # the fixed 0.5 estimate's bin after the tables'


class _ArithCoder:
    """jcarith.c's coder (T.81 Annex D.1): `encode` one binary decision
    with the adaptive estimate ``stats[i]``; `finish` terminates the
    interval ("Pacman" termination: trailing zero bytes dropped)."""

    def __init__(self, out: bytearray):
        self.out = out
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit_pending(self, byte: int) -> None:
        if self.zc:
            self.out += bytes(self.zc)
            self.zc = 0
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _flush_stack(self) -> None:
        if self.sc:
            if self.zc:
                self.out += bytes(self.zc)
                self.zc = 0
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _byte_out(self, temp: int) -> None:
        if temp > 0xFF:  # a carry over every stacked 0xFF byte
            if self.buffer >= 0:
                self._emit_pending(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_pending(self.buffer)
            self._flush_stack()
            self.buffer = temp & 0xFF

    def encode(self, stats: bytearray, i: int, val: int) -> None:
        sv = stats[i]
        state = sv & 0x7F
        qe = _QE[state]
        a = self.a - qe
        if val != sv >> 7:  # the less probable symbol
            if a >= qe:
                self.c += a
                a = qe
            stats[i] = (sv & 0x80) ^ _NEXT_LPS[state]
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:  # conditional exchange
                self.c += a
                a = qe
            stats[i] = (sv & 0x80) ^ _NEXT_MPS[state]
        c, ct = self.c, self.ct
        while a < 0x8000:  # renormalization (D.1.6)
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                self._byte_out(c >> 19)
                c &= 0x7FFFF
                ct = 8
        self.a, self.c, self.ct = a, c, ct

    def finish(self) -> None:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        c = self.c << self.ct
        if c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_pending(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_pending(self.buffer)
            self._flush_stack()
        if c & 0x7FFF800:
            self._emit_pending((c >> 19) & 0xFF)
            if c & 0x7F800:
                self.out.append((c >> 11) & 0xFF)
                if (c >> 11) & 0xFF == 0xFF:
                    self.out.append(0)


def _arith_dc(enc: _ArithCoder, st: bytearray, base: int, ctx: list, last: list, i: int,
              m: int, lu: tuple) -> None:
    """One DC value (F.1.4.1 / F.1.4.4.1: jcarith.c's encode_mcu_DC_first)."""
    s = base + ctx[i]
    v = m - last[i]
    if v == 0:
        enc.encode(st, s, 0)
        ctx[i] = 0
        return
    last[i] = m
    enc.encode(st, s, 1)
    if v > 0:
        enc.encode(st, s + 1, 0)
        s += 2
        ctx[i] = 4
    else:
        v = -v
        enc.encode(st, s + 1, 1)
        s += 3
        ctx[i] = 8
    m = 0
    v -= 1
    if v:
        enc.encode(st, s, 1)
        m, v2, s = 1, v >> 1, base + 20
        while v2:
            enc.encode(st, s, 1)
            m, v2, s = m << 1, v2 >> 1, s + 1
    enc.encode(st, s, 0)
    if m < (1 << lu[0]) >> 1:
        ctx[i] = 0
    elif m > (1 << lu[1]) >> 1:
        ctx[i] += 8
    s += 14
    m >>= 1
    while m:
        enc.encode(st, s, 1 if m & v else 0)
        m >>= 1


def _arith_ac(enc: _ArithCoder, st: bytearray, base: int, z: list, ss: int, se: int, al: int,
              kx: int) -> None:
    """One block's band ss..se at point transform al (F.1.4.2 / G.1.3.2:
    jcarith.c's encode_mcu_AC_first; 1..63 at al 0 is the sequential AC)."""
    ke = next((k for k in range(se, 0, -1) if abs(z[k]) >> al), 0)
    k = ss
    while k <= ke:
        s = base + 3 * (k - 1)
        enc.encode(st, s, 0)  # not the end of the block
        while True:
            v = abs(z[k]) >> al
            if v:
                enc.encode(st, s + 1, 1)
                enc.encode(st, _FIXED_BIN, 1 if z[k] < 0 else 0)
                break
            enc.encode(st, s + 1, 0)
            s += 3
            k += 1
        s += 2
        m = 0
        v -= 1
        if v:
            enc.encode(st, s, 1)
            m, v2 = 1, v >> 1
            if v2:
                enc.encode(st, s, 1)
                m, v2, s = 2, v2 >> 1, base + (189 if k <= kx else 217)
                while v2:
                    enc.encode(st, s, 1)
                    m, v2, s = m << 1, v2 >> 1, s + 1
        enc.encode(st, s, 0)
        s += 14
        m >>= 1
        while m:
            enc.encode(st, s, 1 if m & v else 0)
            m >>= 1
        k += 1
    if k <= se:
        enc.encode(st, base + 3 * (k - 1), 1)


def _arith_ac_refine(enc: _ArithCoder, st: bytearray, base: int, z: list, ss: int, se: int,
                     ah: int, al: int) -> None:
    """G.1.3.3 (jcarith.c's encode_mcu_AC_refine): past the previous
    stage's last nonzero coefficient an end-of-block decision comes first;
    a coefficient already nonzero sends its bit al, a new one its sign."""
    ke = next((k for k in range(se, 0, -1) if abs(z[k]) >> al), 0)
    kex = next((k for k in range(ke, 0, -1) if abs(z[k]) >> ah), 0)
    k = ss
    while k <= ke:
        s = base + 3 * (k - 1)
        if k > kex:
            enc.encode(st, s, 0)
        while True:
            v = abs(z[k]) >> al
            if v:
                if v >> 1:
                    enc.encode(st, s + 2, v & 1)
                else:
                    enc.encode(st, s + 1, 1)
                    enc.encode(st, _FIXED_BIN, 1 if z[k] < 0 else 0)
                break
            enc.encode(st, s + 1, 0)
            s += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, base + 3 * (k - 1), 1)


def _arith_scan(z: np.ndarray, comp: np.ndarray, interval: np.ndarray, ss: int, se: int, ah: int,
                al: int, tables: list, progressive: bool, conditioning: tuple) -> bytes:
    """The entropy-coded data of one arithmetic scan over blocks ``z`` [N,
    64] (zigzag, scan order) of members ``comp`` [N] (``tables[i]``: the
    member's table pair), a restart marker where ``interval`` changes; the
    statistics and DC predictions start over in each interval (jcarith.c's
    emit_restart)."""
    lu, kx = conditioning[:2], conditioning[2]
    out = bytearray()
    rows, comps, ivals = z.tolist(), comp.tolist(), interval.tolist()
    enc = st = None
    for b, (zb, i, iv) in enumerate(zip(rows, comps, ivals)):
        if b == 0 or iv != ivals[b - 1]:
            if enc is not None:
                enc.finish()
                out += bytes((0xFF, 0xD0 + (iv - 1) % 8))
            enc, st = _ArithCoder(out), bytearray(_FIXED_BIN + 1)
            st[_FIXED_BIN] = 113
            ctx, last = [0] * len(tables), [0] * len(tables)
        dc_base, ac_base = tables[i][0] * _DC_BINS, 4 * _DC_BINS + tables[i][1] * _AC_BINS
        if not progressive:
            _arith_dc(enc, st, dc_base, ctx, last, i, zb[0], lu)
            _arith_ac(enc, st, ac_base, zb, 1, 63, 0, kx)
        elif ss == 0 and ah == 0:
            _arith_dc(enc, st, dc_base, ctx, last, i, zb[0] >> al, lu)
        elif ss == 0:
            enc.encode(st, _FIXED_BIN, (zb[0] >> al) & 1)
        elif ah == 0:
            _arith_ac(enc, st, ac_base, zb, ss, se, al, kx)
        else:
            _arith_ac_refine(enc, st, ac_base, zb, ss, se, ah, al)
    enc.finish()
    return bytes(out)


def encode_progressive_jpeg(rgb: np.ndarray, dqt: dict, dht: dict, sampling=(2, 2),
                            restart: int = 0, script: str = "full", tables: bool = True,
                            progressive: bool = True, arithmetic: bool = False,
                            conditioning: tuple | None = None) -> bytes:
    """A progressive JPEG (SOF2) of the quantized coefficients
    `encode_baseline_jpeg` codes (`_jpeg_coefficients`): libjpeg's
    jpeg_simple_progression script (spectral selection, successive
    approximation, an interleaved DC scan), EOB runs of one block, so that
    the standard tables (`standard_jpeg_tables`) code every symbol.
    ``script='al1'`` stops before the last refinement of every coefficient
    (a decoder then block-smooths); ``tables=False`` leaves the DHT segments
    out (a decoder installs the standard ones, the Motion-JPEG convention);
    ``progressive=False`` writes the same coefficients as one sequential
    interleaved scan (SOF0), the twin that decodes to the same pixels.
    ``rgb`` [H, W, 3] is coded as YCbCr, [H, W] as gray, and [H, W, 4]
    (CMYK) as YCCK (Adobe transform 2, K sampled as luma).
    ``arithmetic=True`` codes the same coefficients with jcarith.c's
    arithmetic coder instead (SOF10, or SOF9 with ``progressive=False``; no
    DHT): ``conditioning`` (L, U, Kx) is written in a DAC segment before
    every scan as libjpeg writes one, and None writes none (the decoder's
    defaults 0, 1, 5 apply). Huffman coding is numpy throughout (a 640 x 480
    image in ~0.1 s); the arithmetic coder runs one Python call a decision."""
    h, w, comps, mcux, mcuy, qts, tq = _jpeg_coefficients(rgb, dqt, sampling)
    ncomp = len(comps)
    tsel = [0, 1, 1, 0][:ncomp]
    dc_tabs = [dht[(0, t)] for t in tsel]
    ac_tabs = [dht[(1, t)] for t in tsel]
    if not tables and not arithmetic:
        assert all(dht[k] == _ANNEX_K_HUFFMAN[k] for k in dht if k[1] in tsel), "standard tables"

    def scan(members, ss, se, ah, al):
        if len(members) == 1:
            c = comps[members[0]]
            z = c["zz"][:c["bh"], :c["bw"]].reshape(-1, 64)
            comp = np.zeros(len(z), np.int64)
            unit = np.arange(len(z))
        else:  # MCU order: each component's h x v blocks in turn
            parts = []
            for i in members:
                c = comps[i]
                hc, vc = c["hv"]
                zz = c["zz"].reshape(mcuy, vc, mcux, hc, 64).transpose(0, 2, 1, 3, 4)
                parts.append(zz.reshape(mcuy * mcux, vc * hc, 64))
            z = np.concatenate(parts, 1).reshape(-1, 64)
            comp = np.concatenate([np.full(p.shape[1], k) for k, p in enumerate(parts)])
            comp = np.tile(comp, mcuy * mcux)
            unit = np.repeat(np.arange(mcuy * mcux), sum(p.shape[1] for p in parts))
        interval = unit // restart if restart else np.zeros(len(z), np.int64)
        sel = b"".join(bytes((comps[i]["id"], (tsel[i] << 4 if ss == 0 else 0)
                              | (tsel[i] if se or not progressive else 0))) for i in members)
        header = _segment(0xDA, bytes((len(members),)) + sel + bytes((ss, se, ah << 4 | al)))
        if arithmetic:
            data = _arith_scan(z, comp, interval, ss, se, ah, al,
                               [(tsel[i], tsel[i]) for i in members], progressive,
                               conditioning or (0, 1, 5))
            if conditioning is None:
                return header + data
            used = sorted({(0, tsel[i]) for i in members if ss == 0 and ah == 0}
                          | {(1, tsel[i]) for i in members if se})
            dac = b"".join(bytes((tc << 4 | t, (conditioning[0] | conditioning[1] << 4) if tc == 0
                                  else conditioning[2])) for tc, t in used)
            return (_segment(0xCC, dac) if dac else b"") + header + data
        keys, codes, lens = _scan_items(
            z, comp, ss, se, ah, al, [dc_tabs[i] for i in members], [ac_tabs[i] for i in members],
            interval)
        keys, codes, lens = (np.concatenate(x) for x in (keys, codes, lens))
        order = np.argsort(keys, kind="stable")
        codes, lens = codes[order], lens[order]
        # each item's restart interval, from its block (the key's leading part)
        item_interval = interval[keys[order] // (80 * 16 * 64)]
        data = bytearray()
        cuts = np.flatnonzero(np.diff(item_interval)) + 1
        for k, (a, b) in enumerate(zip(np.concatenate([[0], cuts]),
                                       np.concatenate([cuts, [len(codes)]]))):
            if k:
                data += bytes((0xFF, 0xD0 + (k - 1) % 8))
            data += _pack_bits(codes[a:b], lens[a:b])
        return header + bytes(data)

    out = bytearray(b"\xff\xd8" + (
        _segment(0xEE, b"Adobe" + (100).to_bytes(2, "big") + bytes(4) + bytes((2,)))  # YCCK
        if ncomp == 4 else _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")))
    for tid in sorted(set(tq[:ncomp])):
        values = qts[tid]
        out += _segment(0xDB, bytes((tid,)) + values[list(ZIGZAG)].astype(np.uint8).tobytes())
    sof = (0xCA if progressive else 0xC9) if arithmetic else (0xC2 if progressive else 0xC0)
    out += _segment(sof,
                    bytes((8,)) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes((ncomp,))
                    + b"".join(bytes((c["id"], c["hv"][0] << 4 | c["hv"][1], tq[i]))
                               for i, c in enumerate(comps)))
    if tables and not arithmetic:
        for tc in (0, 1):
            for th in sorted(set(tsel)):
                table = dht[(tc, th)]
                out += _segment(0xC4, bytes((tc << 4 | th,)) + bytes(table[0]) + table[1])
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    if not progressive:
        out += scan(list(range(ncomp)), 0, 63, 0, 0)
    else:
        for members, ss, se, ah, al in (_SCRIPT_YCC if ncomp == 3 else _script_other(ncomp)):
            if script == "al1" and al == 0:
                continue
            out += scan(list(members), ss, se, ah, al)
    return bytes(out + b"\xff\xd9")


# a DC table for lossless difference categories 0-16 (lengths 2, 3 x 5, 4 ... 14)
_LOSSLESS_HUFFMAN = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0], bytes(range(17)))


def lossless_differences(samples: np.ndarray, predictor: int, pt: int = 0,
                         restart_rows: int = 0, precision: int = 8) -> np.ndarray:
    """The differences a lossless JPEG codes for ``samples`` [H, W, C]
    uint8 (T.81 H.1.2, as libjpeg's jclossls.c forms them): each sample >>
    ``pt`` less its prediction. The first row of the image and of each
    restart interval (``restart_rows`` rows) predicts its first sample
    from 2^(precision - 1 - pt) and the rest from the left; every other row
    its first sample from above and the rest with ``predictor`` (1-7).
    -> int64 [H, W, C]."""
    x = samples.astype(np.int64) >> pt
    h = x.shape[0]
    ra = np.zeros_like(x)
    rb = np.zeros_like(x)
    rc = np.zeros_like(x)
    ra[:, 1:], rb[1:], rc[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    first = np.zeros(h, bool)
    first[::restart_rows or h] = True
    pred[first] = ra[first]
    pred[first, 0] = 1 << (precision - 1 - pt)
    return x - pred


def lossless_jpeg(diffs: np.ndarray, predictor: int, pt: int = 0, restart_rows: int = 0,
                  cmyk: bool = False, markers: bool = True, interleaved: bool = True,
                  precision: int = 8) -> bytes:
    """A lossless JPEG (SOF3, ``precision`` bits, Huffman, 1x1 sampling)
    coding the differences ``diffs`` [H, W, C] (categories 0-16; 16 is
    32768) in one interleaved scan, or one scan per component: RGB-coded (C 3, Adobe
    transform 0, components 'R', 'G', 'B') or CMYK (C 4, 'C', 'M', 'Y',
    'K'); ``markers=False`` leaves the Adobe segment out. ``restart_rows``:
    a restart interval of that many rows."""
    h, w, nc = diffs.shape
    code_of, len_of = _code_arrays(_LOSSLESS_HUFFMAN)
    ids = b"CMYK" if cmyk else b"RGB"

    def scan(d: np.ndarray, members: bytes) -> bytes:  # d [H, W * members]
        cat = np.where(d == 32768, 16, _bit_length(d))
        extra = np.where(d > 0, d, d + (1 << cat) - 1) & ((1 << cat) - 1)
        codes = np.stack([code_of[cat], extra], -1).reshape(h, -1)
        lens = np.stack([len_of[cat], np.where(cat == 16, 0, cat)], -1).reshape(h, -1)
        data = bytearray()
        step = restart_rows or h
        for k, r in enumerate(range(0, h, step)):
            if k:
                data += bytes((0xFF, 0xD0 + (k - 1) % 8))
            data += _pack_bits(codes[r:r + step].ravel(), lens[r:r + step].ravel())
        return _segment(0xDA, bytes((len(members),)) + b"".join(bytes((i, 0)) for i in members)
                        + bytes((predictor, 0, pt))) + bytes(data)

    d = diffs.astype(np.int64)
    scans = [scan(d.reshape(h, w * nc), ids)] if interleaved else [
        scan(d[..., c], ids[c:c + 1]) for c in range(nc)]
    out = bytearray(b"\xff\xd8")
    if markers:
        out += _segment(0xEE, b"Adobe" + (100).to_bytes(2, "big") + bytes(4) + bytes((0,)))
    out += _segment(0xC3, bytes((precision,)) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                    + bytes((nc,))
                    + b"".join(bytes((i, 0x11, 0)) for i in ids))
    out += _segment(0xC4, bytes((0,)) + bytes(_LOSSLESS_HUFFMAN[0]) + _LOSSLESS_HUFFMAN[1])
    if restart_rows:
        out += _segment(0xDD, (restart_rows * w).to_bytes(2, "big"))
    return bytes(out + b"".join(scans) + b"\xff\xd9")


def encode_lossless_jpeg(rgb: np.ndarray, predictor: int, pt: int = 0, restart: int = 0,
                         cmyk: bool = False, precision: int = 8) -> bytes:
    """A lossless JPEG (SOF3) of ``rgb`` [H, W, 3] uint8 (RGB-coded, as
    libjpeg writes JCS_RGB: Adobe transform 0), or with ``cmyk`` of [H, W,
    4] CMYK: predictor 1-7, point transform ``pt`` (the decode is the
    samples with their low ``pt`` bits cleared; at 0 the source exactly), a
    restart every ``restart`` rows (libjpeg takes only whole rows in lossless
    mode), samples of ``precision`` (2-8) bits. Numpy throughout."""
    rgb = np.asarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != (4 if cmyk else 3):
        raise ValueError(f"expected [H, W, {4 if cmyk else 3}] uint8, got {rgb.shape}")
    if restart * rgb.shape[1] > 65535:
        raise ValueError("the restart interval exceeds 65535 samples")
    if not 2 <= precision <= 8 or int(rgb.max(initial=0)) >> precision:
        raise ValueError(f"samples must fit {precision} bits (2-8)")
    return lossless_jpeg(lossless_differences(rgb, predictor, pt, restart, precision), predictor,
                         pt, restart, cmyk, precision=precision)


def _exif_app1(orientation: int, little_endian: bool) -> bytes:
    e = "little" if little_endian else "big"
    tiff = ((b"II" if little_endian else b"MM") + (42).to_bytes(2, e) + (8).to_bytes(4, e)
            + (1).to_bytes(2, e) + (0x0112).to_bytes(2, e) + (3).to_bytes(2, e)
            + (1).to_bytes(4, e) + orientation.to_bytes(2, e) + bytes(2) + bytes(4))
    return _segment(0xE1, b"Exif\x00\x00" + tiff)


def bmp_rle(index: np.ndarray, bits: int, seed: int = 0, *, gaps: bool = True) -> bytes:
    """Palette indices [h, w] (stored row order: the first row is the
    file's first) -> an RLE8 (``bits`` 8) or RLE4 (4) stream with a seeded
    mix of encoded runs, absolute blocks (odd lengths included), end-of-line
    escapes (after a run that fills its row too) and, where ``gaps``, deltas
    and (RLE8) an early end-of-bitmap over the pixels they skip. RLE4 deltas
    stay on their row: cv2 drops an RLE4 delta's dy and reads RLE4's
    end-of-bitmap as an end of line."""
    rng = np.random.default_rng(seed)
    h, w = index.shape
    out = bytearray()
    y = x = 0
    while y < h:
        if gaps and rng.random() < 0.04 and y < h - 1 and x < w:
            dx, dy = int(rng.integers(0, w - x)), int(rng.integers(0, min(3, h - y)))
            dy = dy if bits == 8 else 0
            out += bytes([0, 2, dx, dy])
            x, y = x + dx, y + dy
        if gaps and bits == 8 and y == h - 1 and x > w // 2 and rng.random() < 0.5:
            return bytes(out + b"\x00\x01")  # end of bitmap before the last pixels
        left = w - x
        if left == 0 or (rng.random() < 0.1 and x > 0):
            out += b"\x00\x00"  # end of line
            x, y = 0, y + 1
            continue
        n = int(rng.integers(1, min(left, 60) + 1))
        seg = index[y, x:x + n]
        if n >= 3 and rng.random() < 0.4:  # absolute
            if bits == 8:
                body = bytes(seg)
            else:
                pad = np.append(seg, 0).astype(np.uint8) if n % 2 else seg
                body = bytes((pad[0::2] << 4) | pad[1::2])
            out += bytes([0, n]) + body + (b"\x00" if len(body) % 2 else b"")
        else:  # encoded: the segment's first (and, RLE4, second) index repeated
            a = int(seg[0])
            b = int(seg[1]) if n > 1 and bits == 4 else a
            out += bytes([n, a if bits == 8 else (a << 4) | b])
        x += n
        if x == w and bits == 8 and rng.random() < 0.7:
            out += b"\x00\x00"  # end of line right after a run that fills the row
            x, y = 0, y + 1
    return bytes(out + b"\x00\x01")


def encode_bmp(pixels: np.ndarray, bpp: int, *, palette: np.ndarray | None = None,
               header: int = 40, compression: int = 0, masks=None, top_down: bool = False,
               colors_used: int = 0, data: bytes | None = None) -> bytes:
    """A BMP of ``pixels`` stored as they are: palette indices [h, w] for
    ``bpp`` 1-8, raw 16-bit values [h, w] for 16, BGR(X) bytes [h, w, 3|4]
    for 24 and 32, rows in display order. ``header`` 12 (OS/2 core: 3-byte
    palette entries), 40, or a larger size (52-124: V2-V5, the masks inside
    it); ``compression`` 0 BI_RGB, 1 RLE8, 2 RLE4 (then ``data`` is the
    stream, `bmp_rle`, in stored row order), 3 BI_BITFIELDS (``masks`` (r,
    g, b), also written after the header, where cv2 reads a 16-bit file's).
    ``palette`` [n, 3] RGB; ``colors_used`` is written as biClrUsed."""
    h, w = pixels.shape[:2]
    stored = pixels if top_down else pixels[::-1]
    if data is None:
        stride = ((w * bpp + 7) // 8 + 3) & ~3
        rows = np.zeros((h, stride), np.uint8)
        if bpp <= 8:
            per = 8 // bpp
            idx = np.zeros((h, -(-w // per) * per), np.uint8)
            idx[:, :w] = stored
            packed = np.zeros((h, idx.shape[1] // per), np.uint8)
            for k in range(per):
                packed |= (idx[:, k::per] << (8 - bpp * (k + 1))).astype(np.uint8)
            rows[:, :packed.shape[1]] = packed
        elif bpp == 16:
            rows[:, :2 * w] = stored.astype("<u2").view(np.uint8).reshape(h, 2 * w)
        else:
            rows[:, :w * bpp // 8] = stored.reshape(h, -1)
        data = rows.tobytes()
    le = lambda v, n=4: int(v).to_bytes(n, "little", signed=v < 0)  # noqa: E731
    if header == 12:
        info = le(12) + le(w, 2) + le(h, 2) + le(1, 2) + le(bpp, 2)
    else:
        info = (le(header) + le(w) + le(-h if top_down else h) + le(1, 2) + le(bpp, 2)
                + le(compression) + le(len(data)) + le(2835) + le(2835) + le(colors_used) + le(0))
        if header > 40:  # V2 - V5: masks, alpha mask, colour space and the rest zero
            inner = b"".join(le(m) for m in (masks or (0, 0, 0))) + le(0) + b"sRGB"
            info += (inner + bytes(header))[:header - 40]
    extra = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)[:, ::-1]  # RGB -> BGR
        if header != 12:
            pal = np.concatenate([pal, np.zeros((len(pal), 1), np.uint8)], 1)
        extra = pal.tobytes()
    elif compression == 3:
        extra = b"".join(le(m) for m in masks)
    offset = 14 + len(info) + len(extra)
    return b"BM" + le(offset + len(data)) + bytes(4) + le(offset) + info + extra + data


def png_with_exif(png: bytes, orientation: int, after_idat: bool = False) -> bytes:
    """A PNG with an eXIf chunk (little-endian TIFF, IFD0 orientation)
    before its first IDAT, or after its last."""
    import zlib

    tiff = _exif_app1(orientation, True)[10:]
    crc = zlib.crc32(b"eXIf" + tiff).to_bytes(4, "big")
    chunk = len(tiff).to_bytes(4, "big") + b"eXIf" + tiff + crc
    at = png.rindex(b"IEND") - 4 if after_idat else png.index(b"IDAT") - 4
    return png[:at] + chunk + png[at:]


def _flip_scan_bits(jpeg: bytes, seed: int, n: int) -> bytes:
    """``n`` seeded bit flips in the first scan's entropy-coded data (never
    making or breaking a 0xFF byte)."""
    rng = np.random.default_rng(seed)
    out = bytearray(jpeg)
    sos = jpeg.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(jpeg[sos + 2:sos + 4], "big")
    end = jpeg.index(b"\xff", start + 16)
    while jpeg[end + 1] == 0x00 or 0xD0 <= jpeg[end + 1] <= 0xD7:
        end = jpeg.index(b"\xff", end + 2)
    done = 0
    while done < n:
        at = int(rng.integers(start + 4, end - 1))
        new = out[at] ^ (1 << int(rng.integers(8)))
        if 0xFF in (out[at], new, out[at - 1], out[at + 1]):
            continue
        out[at] = new
        done += 1
    return bytes(out)


def cv2_parity_images(seed: int = 0) -> list[tuple[str, str, bytes]]:
    """32 small files, one for each decode departure closed against cv2 and
    each format handed to it: (file name, kind, bytes); kind is "jpeg",
    "bmp", "png" (the port's decoders) or "cv2" (decoded through cv2).
    JPEG: cut at half its length (sequential, with restarts, arithmetic),
    without its EOI, bad Huffman codes (sequential and progressive), a bad
    arithmetic code, restart markers out of place or dropped (Huffman and
    arithmetic), a frame marker and extraneous bytes inside the scan. BMP:
    cv2's gray writer (8 bits, a palette), 1- and 4-bit palettes, an 8-bit
    V4 top-down file, RLE8 and RLE4 with deltas, 16-bit 555 and 565, the
    OS/2 core header, a V5 32-bit file with RGBA masks. PNG: eXIf
    orientations before and after the image data. Through cv2: WebP (lossy,
    lossless), TIFF, AVIF, JPEG 2000, GIF and PPM. Needs cv2."""
    import cv2

    rng = np.random.default_rng(seed)
    scene = [_scene(72, 96, seed * 31 + k) for k in range(8)]

    def jpg(img, *params):
        return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90, *params])[1].tobytes()

    base, rst = jpg(scene[0]), jpg(scene[1], cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    prog = jpg(scene[2], cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    dqt, dht = standard_jpeg_tables(90)
    arith = encode_progressive_jpeg(scene[3], dqt, dht, progressive=False, arithmetic=True)
    arith_rst = encode_progressive_jpeg(scene[4], dqt, dht, progressive=False, arithmetic=True,
                                        restart=2)
    sos = rst.index(b"\xff\xda")
    r0 = rst.index(b"\xff\xd0", sos)
    a0 = arith_rst.index(b"\xff\xd0", arith_rst.index(b"\xff\xda"))
    r2 = rst.index(b"\xff\xd2", sos)
    mid = (sos + len(rst)) // 2
    files = [
        ("jpeg_cut_half.jpg", base[:len(base) // 2]),
        ("jpeg_rst_cut_60.jpg", rst[:len(rst) * 3 // 5]),
        ("jpeg_no_eoi.jpg", jpg(scene[5])[:-2]),
        ("jpeg_bad_huffman.jpg", _flip_scan_bits(base, seed + 1, 3)),
        ("jpeg_prog_bad_huffman.jpg", _flip_scan_bits(prog, seed + 2, 2)),
        ("jpeg_rst_out_of_place.jpg", rst[:r0 + 1] + b"\xd3" + rst[r0 + 2:]),
        ("jpeg_rst_dropped.jpg", rst[:r2] + rst[r2 + 2:]),
        ("jpeg_frame_marker_in_scan.jpg", rst[:mid] + b"\xff\xc2" + rst[mid:]),
        ("jpeg_extraneous_bytes.jpg", rst[:r0] + bytes(range(1, 40)) + rst[r0:]),
        ("arith_cut_half.jpg", arith[:len(arith) // 2]),
        ("arith_bad_code.jpg", _flip_scan_bits(arith, seed + 3, 1)),
        ("arith_rst_out_of_place.jpg", arith_rst[:a0 + 1] + b"\xd3" + arith_rst[a0 + 2:]),
    ]
    out = [(name, "jpeg", data) for name, data in files]
    pal = lambda n: rng.integers(0, 256, (n, 3), dtype=np.uint8)  # noqa: E731
    idx = lambda n, h=40, w=52: rng.integers(0, n, (h, w)).astype(np.uint8)  # noqa: E731
    blocky = (rng.integers(0, 16, (40, 13)).repeat(4, 1)[:, :50]).astype(np.uint8)
    bmps = [
        ("bmp_gray8_cv2.bmp", cv2.imencode(".bmp", scene[6][..., 1])[1].tobytes()),
        ("bmp_pal1.bmp", encode_bmp(idx(2), 1, palette=pal(2))),
        ("bmp_pal4.bmp", encode_bmp(idx(16), 4, palette=pal(16))),
        ("bmp_pal8_v4_topdown.bmp", encode_bmp(idx(200), 8, palette=pal(200), header=108,
                                               top_down=True, colors_used=200)),
        ("bmp_rle8.bmp", encode_bmp(blocky, 8, palette=pal(256), compression=1,
                                    data=bmp_rle(blocky[::-1], 8, seed + 4))),
        ("bmp_rle4.bmp", encode_bmp(blocky, 4, palette=pal(16), compression=2,
                                    data=bmp_rle(blocky[::-1], 4, seed + 5))),
        ("bmp_555.bmp", encode_bmp(rng.integers(0, 1 << 15, (33, 47)).astype(np.uint16), 16)),
        ("bmp_565.bmp", encode_bmp(rng.integers(0, 1 << 16, (33, 47)).astype(np.uint16), 16,
                                   compression=3, masks=(0xF800, 0x7E0, 0x1F))),
        ("bmp_os2_pal8.bmp", encode_bmp(idx(256), 8, palette=pal(256), header=12)),
        ("bmp_v5_rgba_masks.bmp", encode_bmp(rng.integers(0, 256, (29, 31, 4), dtype=np.uint8), 32,
                                             header=124, compression=3,
                                             masks=(0xFF, 0xFF00, 0xFF0000))),
    ]
    out += [(name, "bmp", data) for name, data in bmps]
    png = lambda img: cv2.imencode(".png", img)[1].tobytes()  # noqa: E731
    out += [("png_exif6.png", "png", png_with_exif(png(scene[7][:30, :41]), 6)),
            ("png_exif8_after_idat.png", "png", png_with_exif(png(scene[6]), 8, after_idat=True)),
            ("png_exif3_gray16.png", "png", png_with_exif(png(
                (scene[5][..., 0].astype(np.uint16) * 257)), 3))]
    enc = lambda ext, *p: cv2.imencode(ext, scene[0], list(p))[1].tobytes()  # noqa: E731
    out += [("webp_lossy.webp", "cv2", enc(".webp", cv2.IMWRITE_WEBP_QUALITY, 80)),
            ("webp_lossless.webp", "cv2", enc(".webp", cv2.IMWRITE_WEBP_QUALITY, 101)),
            ("tiff.tiff", "cv2", enc(".tiff")), ("avif.avif", "cv2", enc(".avif")),
            ("jpeg2000.jp2", "cv2", enc(".jp2")), ("gif.gif", "cv2", enc(".gif")),
            ("ppm.ppm", "cv2", enc(".ppm"))]
    return out


def _png_filter(row: np.ndarray, prior: np.ndarray, bpp: int, ftype: int) -> bytes:
    """One scanline filtered with PNG filter ``ftype`` (0-4) against the
    previous scanline of its pass (zeros for the first)."""
    x, b = row.astype(np.int64), prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]]) if len(x) > bpp else np.zeros_like(x)
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]]) if len(b) > bpp else np.zeros_like(b)
    if ftype == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = (np.zeros_like(x), a, b, (a + b) >> 1)[ftype]
    return bytes((ftype,)) + ((x - pred) & 255).astype(np.uint8).tobytes()


def _png(pixels: np.ndarray, ctype: int, depth: int, palette=None, interlace: int = 0,
         filters=(0,)) -> bytes:
    """A PNG of already packed rows [H, row bytes] (samples MSB first below
    8 bits, big-endian at 16). ``interlace=1`` writes Adam7: the pixels of
    each of the 7 passes repacked into rows of their own, a pass without
    pixels written as nothing. ``filters`` cycles over each pass's rows."""
    import zlib

    from .data.codec import ADAM7

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bits = channels * depth
    h, width = pixels.shape[0], pixels.shape[1] * 8 // bits
    bpp = max(1, bits // 8)
    if bits < 8:  # one sample a pixel: unpack, so that passes can pick pixels
        shifts = np.arange(8 - depth, -1, -depth)
        units = ((pixels[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :width]
    else:
        units = pixels.reshape(h, width, bits // 8)

    def packed(sub):  # pixels [ph, pw(, bytes)] -> rows [ph, row bytes]
        if bits >= 8:
            return sub.reshape(sub.shape[0], -1).astype(np.uint8)
        pw = sub.shape[1]
        padded = np.zeros((sub.shape[0], -(-pw * depth // 8) * 8 // depth), np.int64)
        padded[:, :pw] = sub
        grouped = padded.reshape(sub.shape[0], -1, 8 // depth)
        return (grouped << np.arange(8 - depth, -1, -depth)).sum(-1).astype(np.uint8)

    passes = [units] if not interlace else [units[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
    raw = []
    for sub in passes:
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = packed(sub)
        prior = np.zeros(rows.shape[1], np.uint8)
        for y in range(rows.shape[0]):
            raw.append(_png_filter(rows[y], prior, bpp, filters[y % len(filters)]))
            prior = rows[y]

    def chunk(kind, body):
        return (len(body).to_bytes(4, "big") + kind + body
                + zlib.crc32(kind + body).to_bytes(4, "big"))

    ihdr = (width.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes((depth, ctype, 0, 0, interlace)))
    plte = chunk(b"PLTE", palette.tobytes()) if palette is not None else b""
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + plte
            + chunk(b"IDAT", zlib.compress(b"".join(raw))) + chunk(b"IEND", b""))


def mjpeg_avi(frames, width: int, height: int, fps: float = 25.0, *,
              header_frames: int | None = None, index: bool = True, junk: bool = False,
              rec_lists: bool = False) -> bytes:
    """A minimal Motion-JPEG AVI (RIFF ``AVI `` / ``LIST hdrl`` with ``avih``
    and one ``vids`` / ``MJPG`` stream / ``LIST movi`` of ``00dc`` chunks /
    ``idx1``, offsets from the ``movi`` fourcc) around JPEG ``frames``; an
    empty frame is a zero-length chunk (a dropped frame). ``header_frames``
    is the count ``avih`` and ``strh`` claim (default: the frames written);
    ``index=False`` leaves ``idx1`` out; ``junk`` adds ``JUNK`` chunks
    inside ``movi``; ``rec_lists`` wraps each frame in a ``LIST rec ``."""
    import struct

    def chunk(fcc: bytes, body: bytes) -> bytes:
        return fcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    def lst(kind: bytes, body: bytes) -> bytes:
        return chunk(b"LIST", kind + body)

    n = len(frames) if header_frames is None else header_frames
    scale, rate = (1, int(fps)) if float(fps).is_integer() else (1000, int(round(fps * 1000)))
    largest = max((len(f) for f in frames), default=0)
    avih = struct.pack("<14I", int(round(1e6 / fps)), 0, 0, 0x10, n, 0, 1, largest, width,
                       height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0, scale, rate, 0, n,
                       largest, 0xFFFFFFFF, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                       width * height * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh)
                                                  + chunk(b"strf", strf)))
    movi, entries = bytearray(b"movi"), []
    for i, f in enumerate(frames):
        if junk and i % 2:
            movi += chunk(b"JUNK", bytes(6))
        if rec_lists:
            entries.append((b"rec ", 0, len(movi), 4 + 8 + len(f)))
            movi += lst(b"rec ", chunk(b"00dc", f))
            entries[-1] = (b"00dc", 0x10, len(movi) - 8 - len(f) - (len(f) & 1), len(f))
        else:
            entries.append((b"00dc", 0x10, len(movi), len(f)))
            movi += chunk(b"00dc", f)
    body = b"AVI " + hdrl + chunk(b"LIST", bytes(movi))
    if index:
        body += chunk(b"idx1", b"".join(struct.pack("<4sIII", *e) for e in entries))
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _scene(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth seeded content with shapes: gradients, filled rectangles and
    discs of random colours, mild noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([rng.uniform(40, 200) + rng.uniform(-60, 60) * np.sin(
        x / rng.uniform(30, 200) + rng.uniform(0, 6)) * np.cos(y / rng.uniform(30, 200))
        for _ in range(3)], -1)
    for _ in range(int(rng.integers(4, 9))):
        colour = rng.uniform(0, 255, 3)
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        sx, sy = rng.uniform(0.05, 0.3) * w, rng.uniform(0.05, 0.3) * h
        if rng.random() < 0.5:
            mask = (np.abs(x - cx) < sx / 2) & (np.abs(y - cy) < sy / 2)
        else:
            mask = ((x - cx) / sx) ** 2 + ((y - cy) / sy) ** 2 < 0.25
        img[mask] = colour
    img += rng.normal(0, 2, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _strip_dht(jpeg: bytes) -> bytes:
    """A JPEG with its DHT segments removed (before the first scan)."""
    out, pos = bytearray(jpeg[:2]), 2
    while jpeg[pos + 1] != 0xDA:
        end = pos + 2 + int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        if jpeg[pos + 1] != 0xC4:
            out += jpeg[pos:end]
        pos = end
    return bytes(out + jpeg[pos:])


def _empty_avi_chunk(avi: bytes, k: int) -> bytes:
    """An MJPEG AVI with its ``k``-th ``00dc`` chunk made zero-length (a
    dropped frame): the RIFF and movi sizes and the idx1 entries follow."""
    import struct

    movi = next(i for i in range(len(avi)) if avi[i:i + 4] == b"LIST" and avi[i + 8:i + 12] == b"movi")
    pos, n = movi + 12, 0
    while True:
        size = struct.unpack_from("<I", avi, pos + 4)[0]
        if avi[pos:pos + 4] == b"00dc":
            if n == k:
                break
            n += 1
        pos += 8 + size + (size & 1)
    cut = size + (size & 1)
    out = bytearray(avi[:pos + 4] + struct.pack("<I", 0) + avi[pos + 8 + cut:])
    for at in (4, movi + 4):
        struct.pack_into("<I", out, at, struct.unpack_from("<I", out, at)[0] - cut)
    idx = out.index(b"idx1", pos)
    for e in range(struct.unpack_from("<I", out, idx + 4)[0] // 16):
        p = idx + 8 + 16 * e
        off = struct.unpack_from("<I", out, p + 8)[0]
        if movi + 8 + off == pos:
            struct.pack_into("<I", out, p + 12, 0)
        elif movi + 8 + off > pos:
            struct.pack_into("<I", out, p + 8, off - cut)
    return bytes(out)


def _video_oracle(path: str) -> dict:
    """What cv2 says of an AVI fixture: the frame count, the count
    `count_real_frames` gives, the frames a read loop gets, and each frame's
    ``cv2.imdecode`` (RGB) shape and sha256 from its demuxed bytes."""
    import hashlib

    import cv2

    from .data.avi import MJPEGAvi

    cap = cv2.VideoCapture(path)
    header = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.set(cv2.CAP_PROP_POS_FRAMES, max(header - 1, 0))
    real = header if cap.read()[0] else None
    cap.release()
    cap, walked = cv2.VideoCapture(path), 0
    while cap.read()[0]:
        walked += 1
    cap.release()
    if real is None:
        real = walked
    avi = MJPEGAvi(path)
    frames = [cv2.imdecode(np.frombuffer(avi.frame_bytes(i), np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
              for i in range(len(avi._frames))]
    return {"frame_count": header, "real_frames": real, "read_loop_frames": walked,
            "fps": float(cv2.VideoCapture(path).get(cv2.CAP_PROP_FPS)),
            "frame_shape": list(frames[0].shape),
            "frames_sha256": [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest()
                              for f in frames]}


def _decode_leftover_fixtures(seed: int, jpg, sampling) -> tuple[list, list]:
    """The corpus's progressive, CMYK / YCCK, table-less, Adam7 and Motion-JPEG
    AVI files: -> ([(name, bytes, features)], [(name, bytes, features, raises
    or None)] of the ones to add to ``raising``), drawn from their own seed."""
    import io

    import cv2
    from PIL import Image

    rng = np.random.default_rng(seed + 1)
    q, s, prog = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_PROGRESSIVE
    rst = cv2.IMWRITE_JPEG_RST_INTERVAL
    files, raising = [], []
    for i, (samp, restart, hw) in enumerate((("420", 0, (45, 61)), ("420", 2, (37, 50)),
                                            ("422", 0, (41, 57)), ("422", 1, (29, 70)),
                                            ("444", 0, (33, 47)), ("444", 3, (26, 39)))):
        files.append((f"prog_cv2_{samp}{'_rst' if restart else ''}_{hw[0]}x{hw[1]}.jpg",
                      jpg(_scene(*hw, seed + 200 + i), q, 85, s, sampling[samp], prog, 1,
                          rst, restart),
                      f"cv2 progressive {samp}" + (f", restart {restart}" if restart else "")))
    for restart in (0, 2):
        files.append((f"prog_cv2_gray{'_rst' if restart else ''}.jpg",
                      jpg(_scene(38, 53, seed + 210 + restart)[..., 1], q, 80, prog, 1, rst, restart),
                      "cv2 progressive gray" + (", restart 2" if restart else "")))
    for sub, name in ((0, "444"), (1, "422"), (2, "420")):
        bio = io.BytesIO()
        Image.fromarray(_scene(43, 59, seed + 220 + sub)).save(
            bio, "JPEG", quality=80, progressive=True, subsampling=sub,
            restart_marker_blocks=3 if sub == 1 else 0)
        files.append((f"prog_pil_{name}.jpg", bio.getvalue(),
                      f"PIL progressive {name}" + (", restart 3 blocks" if sub == 1 else "")))
    bio = io.BytesIO()
    Image.fromarray(_scene(31, 45, seed + 223)[..., 0], "L").save(bio, "JPEG", progressive=True)
    files.append(("prog_pil_gray.jpg", bio.getvalue(), "PIL progressive gray"))
    for i, (h, w) in enumerate(FULL_SIZE_HW):
        files.append((f"prog_full_{h}x{w}.jpg",
                      jpg(_scene(h, w, seed + 100 + i), q, 90, s, sampling["420"], prog, 1),
                      "full size, cv2 progressive 4:2:0 q90"))
    dqt, dht = standard_jpeg_tables(85)
    scene = _scene(47, 66, seed + 230)
    files.append(("prog_own_al1.jpg", encode_progressive_jpeg(scene, dqt, dht, script="al1"),
                  "own encoder: progressive script stopping at Al = 1 (block smoothing)"))
    files.append(("prog_own_full.jpg", encode_progressive_jpeg(scene, dqt, dht),
                  "own encoder: the same coefficients, complete script"))
    files.append(("prog_own_422_rst.jpg",
                  encode_progressive_jpeg(scene, dqt, dht, sampling=(2, 1), restart=4),
                  "own encoder: progressive 4:2:2, restart 4, EOB runs of 1"))
    cv_prog = jpg(_scene(52, 44, seed + 231), q, 85, s, sampling["420"], prog, 1)
    dc_only, pos = bytearray(cv_prog[:2]), 2
    while cv_prog[pos + 1] != 0xD9:  # keep the DC scans only: no AC coefficient is ever coded
        end = pos + 2 + int.from_bytes(cv_prog[pos + 2:pos + 4], "big")
        ac = cv_prog[pos + 1] == 0xDA and cv_prog[pos + 5 + 2 * cv_prog[pos + 4]] != 0  # Ss != 0
        if cv_prog[pos + 1] == 0xDA:  # the entropy-coded data runs to the next marker
            while cv_prog[end] != 0xFF or cv_prog[end + 1] in (0, *range(0xD0, 0xD8)):
                end += 1
        if not ac:
            dc_only += cv_prog[pos:end]
        pos = end
    files.append(("prog_cv2_dc_only.jpg", bytes(dc_only + b"\xff\xd9"),
                  "cv2 progressive with its AC scans removed (DC interpolation)"))
    cmyk = np.concatenate([_scene(35, 49, seed + 240), _scene(35, 49, seed + 241)[..., :1]], -1)
    for progressive in (False, True):
        bio = io.BytesIO()
        Image.fromarray(cmyk, "CMYK").save(bio, "JPEG", quality=85, progressive=progressive)
        files.append((f"cmyk_pil{'_progressive' if progressive else ''}.jpg", bio.getvalue(),
                      "PIL CMYK (Adobe, inverted)" + (", progressive" if progressive else "")))
        files.append((f"ycck_own{'_progressive' if progressive else ''}.jpg",
                      encode_progressive_jpeg(cmyk, dqt, dht, progressive=progressive),
                      "own encoder: YCCK (Adobe transform 2) 4:2:0"
                      + (", progressive" if progressive else "")))
    files.append(("tableless_cv2_420.jpg",
                  _strip_dht(jpg(_scene(39, 58, seed + 250), q, 75, s, sampling["420"])),
                  "cv2 baseline 4:2:0 without its DHT segments"))
    files.append(("tableless_cv2_gray.jpg", _strip_dht(jpg(_scene(30, 41, seed + 251)[..., 2], q, 75)),
                  "cv2 baseline gray without its DHT segments"))
    files.append(("tableless_own_422_rst.jpg",
                  encode_progressive_jpeg(scene, dqt, dht, sampling=(2, 1), restart=3, tables=False,
                                          progressive=False),
                  "own encoder: sequential 4:2:2, restart 3, no DHT"))
    raising.append(("tableless_progressive.jpg", encode_progressive_jpeg(scene, dqt, dht, tables=False),
                    "must raise: progressive without DHT (libjpeg installs no tables there)",
                    "undefined Huffman table"))
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
                          (6, (8, 16))):
        channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        for depth in depths:
            h, w = 11, 13
            rows = rng.integers(0, 256, (h, -(-w * channels * depth // 8)), dtype=np.uint8)
            pal = rng.integers(0, 256, (2 ** depth, 3), dtype=np.uint8) if ctype == 3 else None
            kind = {0: "gray", 2: "rgb", 3: "palette", 4: "gray_alpha", 6: "rgba"}[ctype]
            files.append((f"png_adam7_{kind}{depth}.png",
                          _png(rows, ctype, depth, pal, interlace=1, filters=(1, 2, 3, 4, 0)),
                          f"PNG {kind} {depth}-bit, Adam7, filters 1-4 and 0 in turn"))
    frames = [_scene(32, 48, seed + 260 + t) for t in range(6)]
    cv_avi = _cv2_mjpeg_avi(frames, 10.0)
    files.append(("video_cv2_mjpg.avi", cv_avi, "cv2 MJPG AVI, 6 frames 32 x 48, 10 fps"))
    files.append(("video_cv2_dropped.avi", _empty_avi_chunk(cv_avi, 2),
                  "the cv2 MJPG AVI with its third frame chunk zero-length (a dropped frame)"))
    own = [encode_progressive_jpeg(f, dqt, dht, progressive=False, tables=bool(t % 2))
           for t, f in enumerate(frames)]
    files.append(("video_header_over.avi", mjpeg_avi(own, 48, 32, 25.0, header_frames=9),
                  "own MJPEG AVI: 6 frames (half without DHT), headers claim 9"))
    files.append(("video_header_under.avi", mjpeg_avi(own, 48, 32, 12.5, header_frames=4,
                                                      index=False, junk=True),
                  "own MJPEG AVI: 6 frames (half without DHT), headers claim 4, no idx1, JUNK"))
    return files + [(n, b, f) for n, b, f, _ in raising], raising


def _cv2_mjpeg_avi(frames: list, fps: float) -> bytes:
    """The bytes cv2's MJPG ``VideoWriter`` writes for RGB ``frames``."""
    import tempfile

    import cv2

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clip.avi")
        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
        for f in frames:
            writer.write(np.ascontiguousarray(f[..., ::-1]))
        writer.release()
        with open(path, "rb") as f:
            return f.read()


def write_codec_fixtures(out_dir: str, seed: int = 0) -> dict:
    """Write the codec corpus into ``out_dir`` with cv2 and PIL (which must be
    installed): about 40 small files (at most 96 x 128) that cover the JPEG
    decoder's features and the PNG types, files that must raise, and
    `FULL_SIZE_HW` JPEGs at COCO's sizes (4:2:0, quality 90, smooth seeded
    scenes), the serving traffic on the card. Beside them
    ``cv2_decodes.npz`` (cv2's RGB decode of each small file) and
    ``manifest.json``: one entry per file with its features, and for the
    full-size files the shape and sha256 of cv2's decode; files that must
    raise carry the message they raise with. -> the manifest."""
    import hashlib
    import io
    import json

    import cv2
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    files: list[tuple[str, bytes, str]] = []  # (name, bytes, features)
    raising: dict[str, str] = {}

    def jpg(img, *params):
        return cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img, list(params))[1].tobytes()

    sampling = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    q, s = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    for i, (hw, samp, quality, extra) in enumerate((
            ((67, 93), "420", 90, ()), ((41, 57), "420", 50, ()), ((45, 63), "420", 100, ()),
            ((45, 77), "422", 90, ()), ((53, 35), "440", 90, ()), ((33, 71), "444", 95, ()),
            ((58, 97), "411", 75, ()), ((71, 69), "420", 90, (cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
            ((47, 83), "422", 50, (cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
            ((77, 99), "420", 90, (cv2.IMWRITE_JPEG_RST_INTERVAL, 2)),
            ((29, 37), "444", 100, (cv2.IMWRITE_JPEG_RST_INTERVAL, 1, cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
            ((1, 1), "420", 90, ()), ((9, 3), "420", 90, ()), ((15, 17), "422", 90, ()))):
        img = (rng.integers(0, 256, hw + (3,), dtype=np.uint8) if i in (1, 2, 5, 10)
               else _scene(*hw, seed + i))
        files.append((f"cv2_{samp}_q{quality}_{hw[0]}x{hw[1]}_{i}.jpg",
                      jpg(img, q, quality, s, sampling[samp], *extra),
                      f"cv2 baseline {samp} q{quality}" + (" optimized/restart" if extra else "")))
    files.append(("cv2_gray_q90_37x59.jpg", jpg(rng.integers(0, 256, (37, 59), dtype=np.uint8), q, 90),
                  "1 component"))
    files.append(("cv2_gray_rst_50x40.jpg", jpg(_scene(50, 40, seed + 20)[..., 0], q, 60,
                                                cv2.IMWRITE_JPEG_RST_INTERVAL, 3), "1 component, restarts"))
    base = jpg(_scene(37, 53, seed + 21), q, 90, s, sampling["420"])
    for o in range(1, 9):
        files.append((f"exif_orientation_{o}.jpg", base[:2] + _exif_app1(o, o % 2 == 0) + base[2:],
                      f"EXIF orientation {o}, {'II' if o % 2 == 0 else 'MM'}"))
    app0_end = 4 + int.from_bytes(base[4:6], "big")
    bare = base[:2] + base[app0_end:]  # the JFIF marker removed
    for t in (0, 1):
        adobe = _segment(0xEE, b"Adobe" + (100).to_bytes(2, "big") + bytes(4) + bytes((t,)))
        files.append((f"adobe_transform_{t}.jpg", bare[:2] + adobe + bare[2:],
                      f"Adobe APP14 transform {t}"))
    rgb_ids = bytearray(bare)
    for marker, first in ((b"\xff\xc0", 10), (b"\xff\xda", 5)):
        at = bytes(rgb_ids).find(marker)
        for k in range(3):
            rgb_ids[at + first + (3 if marker == b"\xff\xc0" else 2) * k] = b"RGB"[k]
    files.append(("component_ids_rgb.jpg", bytes(rgb_ids), "components named R, G, B, no JFIF"))

    scene = _scene(53, 75, seed + 30)
    dqt, dht = jpeg_tables(jpg(scene, q, 80))
    for name, kw in (("noninterleaved_420", dict(interleaved=False)),
                     ("noninterleaved_420_redefined_tables", dict(interleaved=False, redefine=True)),
                     ("noninterleaved_422_restart", dict(interleaved=False, sampling=(2, 1), restart=5)),
                     ("qt16_420_restart", dict(qt16=True, restart=4)),
                     ("qt16_noninterleaved_444", dict(qt16=True, interleaved=False, sampling=(1, 1)))):
        files.append((f"enc_{name}.jpg", encode_baseline_jpeg(scene, dqt, dht, **kw),
                      "own encoder: " + name.replace("_", " ")))
    bio = io.BytesIO()
    Image.fromarray(scene).save(bio, "JPEG", quality=85, progressive=True)
    files.append(("progressive.jpg", bio.getvalue(), "PIL progressive 4:2:0"))
    whole = jpg(_scene(64, 96, seed + 31), q, 90)
    files.append(("truncated.jpg", whole[: len(whole) * 2 // 3], "must raise: truncated"))
    raising["truncated.jpg"] = "truncated JPEG data"

    def png_cv(img):
        return cv2.imencode(".png", img[..., ::-1] if img.ndim == 3 and img.shape[2] in (3, 4)
                            else img)[1].tobytes()

    def png_pil(img, **kw):
        b = io.BytesIO()
        img.save(b, "PNG", **kw)
        return b.getvalue()

    hw, small = (41, 67), (19, 27)  # noise content at the small size
    files += [
        ("png_rgb8.png", png_cv(_scene(*hw, seed + 40)), "PNG RGB 8-bit"),
        ("png_rgb16.png", png_cv(rng.integers(0, 65536, small + (3,), dtype=np.uint16)), "PNG RGB 16-bit"),
        ("png_rgba8.png", png_cv(rng.integers(0, 256, small + (4,), dtype=np.uint8)), "PNG RGBA 8-bit"),
        ("png_rgba16.png", png_cv(rng.integers(0, 65536, small + (4,), dtype=np.uint16)), "PNG RGBA 16-bit"),
        ("png_gray8.png", png_cv(_scene(*hw, seed + 41)[..., 1]), "PNG gray 8-bit"),
        ("png_gray16.png", png_cv(rng.integers(0, 65536, small, dtype=np.uint16)), "PNG gray 16-bit"),
        ("png_gray_alpha8.png", png_pil(Image.fromarray(rng.integers(0, 256, small + (2,), dtype=np.uint8), "LA")),
         "PNG gray + alpha 8-bit"),
        ("png_gray1.png", png_pil(Image.fromarray(rng.integers(0, 2, hw).astype(bool))), "PNG gray 1-bit"),
    ]
    for depth in (2, 4):
        packed = rng.integers(0, 256, (hw[0], hw[1] * depth // 8 + 1), dtype=np.uint8)
        files.append((f"png_gray{depth}.png", _png(packed, 0, depth), f"PNG gray {depth}-bit"))
    for depth in (1, 2, 4, 8):
        pal = Image.fromarray(rng.integers(0, 2 ** depth, hw, dtype=np.uint8), "P")
        pal.putpalette(rng.integers(0, 256, 3 * 2 ** depth).tolist())
        files.append((f"png_palette{depth}.png", png_pil(pal, bits=depth), f"PNG palette {depth}-bit"))
    files.append(("png_interlaced.png", _png(rng.integers(0, 256, (8, 8), dtype=np.uint8), 0, 8,
                                              interlace=1), "PNG gray 8-bit, Adam7"))

    for i, (h, w) in enumerate(FULL_SIZE_HW):
        files.append((f"full_{h}x{w}.jpg", jpg(_scene(h, w, seed + 100 + i), q, 90, s, sampling["420"]),
                      "full size, 4:2:0 q90"))
    more, must_raise = _decode_leftover_fixtures(seed, jpg, sampling)
    files += more
    raising.update({name: why for name, _, _, why in must_raise})

    decodes, manifest = {}, {"files": []}
    for name, data, features in files:
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        entry = {"file": name, "features": features, "bytes": len(data)}
        if name in raising:
            entry["raises"] = raising[name]
        elif name.endswith(".avi"):
            entry["video"] = _video_oracle(os.path.join(out_dir, name))
        else:
            bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            if bgr is None:
                raise RuntimeError(f"cv2 cannot decode its own fixture {name}")
            rgb = np.ascontiguousarray(bgr[..., ::-1])
            entry["shape"] = list(rgb.shape)
            entry["sha256"] = hashlib.sha256(rgb.tobytes()).hexdigest()
            if "full_" not in name:
                decodes[name] = rgb
        manifest["files"].append(entry)
    np.savez_compressed(os.path.join(out_dir, "cv2_decodes.npz"), **decodes)
    manifest["written_with"] = {"cv2": cv2.__version__, "PIL": Image.__version__}
    path = os.path.join(out_dir, "manifest.json")
    if os.path.exists(path):  # the oracles' entry is written with the oracles
        with open(path) as f:
            old = json.load(f)
        if "oracles" in old:
            manifest["oracles"] = old["oracles"]
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest
