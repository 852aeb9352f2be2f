"""Host image reading, letterbox, label files and the detection dataset (port
of fastvision_tpu/data/dataset.py).

The on-disk format: ``<root>/{train,val,test}/images/<id>.jpg`` and
``labels/<id>.txt``, one ``category_idx xmin ymin xmax ymax`` line per box in
original pixels, classes 0-based.

The resize is ``torch.nn.functional.interpolate(mode='bilinear',
align_corners=False, antialias=False)`` on host tensors, rounded back to
uint8: the same sampling as cv2's ``INTER_LINEAR``, within +-1 per pixel
(cv2 rounds with fixed-point weights). ``.bmp`` files (uncompressed 24- and
32-bit) are read and written with numpy; other image files go to cv2, which
must then be installed.

Not ported yet: the reduced-size JPEG decode (``decode_size``,
``imread_rgb_scaled``), ``sample_i420`` and ``ClassificationDataset``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def read_bmp(path: str) -> np.ndarray:
    """An uncompressed 24- or 32-bit BMP (BI_RGB, or BI_BITFIELDS with the
    BGRX masks cv2 writes) -> RGB uint8 HWC, rows bottom-up or top-down,
    each padded to 4 bytes. Anything else raises ValueError."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 54 or buf[:2] != b"BM":
        raise ValueError(f"not a BMP file: {path}")
    offset = int.from_bytes(buf[10:14], "little")
    header = int.from_bytes(buf[14:18], "little")
    width = int.from_bytes(buf[18:22], "little", signed=True)
    height = int.from_bytes(buf[22:26], "little", signed=True)
    bpp = int.from_bytes(buf[28:30], "little")
    compression = int.from_bytes(buf[30:34], "little")
    bgrx_masks = (0x00FF0000, 0x0000FF00, 0x000000FF)
    if compression == 3 and bpp == 32 and tuple(
            int.from_bytes(buf[54 + 4 * i:58 + 4 * i], "little") for i in range(3)) == bgrx_masks:
        compression = 0  # the same bytes as BI_RGB
    if header < 40 or bpp not in (24, 32) or compression != 0 or width <= 0 or height == 0:
        raise ValueError(f"unsupported BMP (header {header}, {bpp} bpp, compression "
                         f"{compression}, {width} x {height}): {path}")
    rows, stride = abs(height), (bpp * width + 31) // 32 * 4
    if len(buf) < offset + rows * stride:
        raise ValueError(f"truncated BMP: {path}")
    px = np.frombuffer(buf, np.uint8, rows * stride, offset).reshape(rows, stride)
    px = px[:, : width * bpp // 8].reshape(rows, width, bpp // 8)[..., 2::-1]  # BGR(X) -> RGB
    return np.ascontiguousarray(px[::-1] if height > 0 else px)  # height > 0: bottom-up


def write_bmp(path: str, image: np.ndarray) -> None:
    """RGB uint8 HWC -> an uncompressed 24-bit bottom-up BMP."""
    image = np.asarray(image, np.uint8)
    h, w = image.shape[:2]
    stride = (24 * w + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : 3 * w] = image[::-1, :, ::-1].reshape(h, 3 * w)
    size = 54 + rows.nbytes
    header = (b"BM" + size.to_bytes(4, "little") + bytes(4) + (54).to_bytes(4, "little")
              + (40).to_bytes(4, "little") + w.to_bytes(4, "little", signed=True)
              + h.to_bytes(4, "little", signed=True) + (1).to_bytes(2, "little")
              + (24).to_bytes(2, "little") + bytes(4) + rows.nbytes.to_bytes(4, "little")
              + (2835).to_bytes(4, "little") * 2 + bytes(8))
    with open(path, "wb") as f:
        f.write(header + rows.tobytes())


def imread_rgb(path: str) -> np.ndarray:
    """Decode an image file -> RGB uint8 HWC. ``.bmp`` is read with numpy;
    other files need cv2 (ImportError without it)."""
    if path.lower().endswith(".bmp"):
        return read_bmp(path)
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot decode image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imwrite_rgb(path: str, image: np.ndarray) -> None:
    """Write RGB uint8 HWC: ``.bmp`` with numpy, other files with cv2."""
    if path.lower().endswith(".bmp"):
        return write_bmp(path, image)
    import cv2

    if not cv2.imwrite(path, cv2.cvtColor(np.ascontiguousarray(image), cv2.COLOR_RGB2BGR)):
        raise OSError(f"cannot write image: {path}")


def resize_bilinear(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """HWC array -> (height, width), bilinear with half-pixel centres."""
    t = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float()
    out = F.interpolate(t, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=False)[0].permute(1, 2, 0)
    if image.dtype == np.uint8:
        return out.round().clamp(0, 255).to(torch.uint8).numpy()
    return out.numpy().astype(image.dtype)


def letterbox(image: np.ndarray, size: int, pad_value: int = 114,
              position: str = "center") -> tuple[np.ndarray, float, tuple[int, int]]:
    """Aspect-preserving resize + pad to (size, size).
    Returns (image, scale, (pad_left, pad_top))."""
    h, w = image.shape[:2]
    scale = size / max(h, w)
    nh, nw = round(h * scale), round(w * scale)
    if (nh, nw) != (h, w):
        image = resize_bilinear(image, nh, nw)
    if position == "center":
        top = (size - nh) // 2
        left = (size - nw) // 2
    else:  # 'lefttop'
        top, left = 0, 0
    out = np.full((size, size, image.shape[2]), pad_value, image.dtype)
    out[top : top + nh, left : left + nw] = image
    return out, scale, (left, top)


def read_label_file(path: str) -> np.ndarray:
    """labels/<id>.txt -> [N, 5] float32 (cls, x1, y1, x2, y2) pixels; a
    missing file is an image without boxes."""
    if not os.path.exists(path):
        return np.zeros((0, 5), np.float32)
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 5:
                rows.append([float(v) for v in parts[:5]])
    return np.asarray(rows, np.float32).reshape(-1, 5)


def boxes_to_normalized_xywh(boxes_xyxy: np.ndarray, height: int, width: int) -> np.ndarray:
    """Pixel xyxy -> normalized xywh (the label tensor format)."""
    out = np.empty_like(boxes_xyxy)
    out[:, 0] = (boxes_xyxy[:, 0] + boxes_xyxy[:, 2]) / 2 / width
    out[:, 1] = (boxes_xyxy[:, 1] + boxes_xyxy[:, 3]) / 2 / height
    out[:, 2] = (boxes_xyxy[:, 2] - boxes_xyxy[:, 0]) / width
    out[:, 3] = (boxes_xyxy[:, 3] - boxes_xyxy[:, 1]) / height
    return out


def pad_labels(cls: np.ndarray, xywhn: np.ndarray, max_boxes: int) -> np.ndarray:
    """-> [max_boxes, 5] (class, cx, cy, w, h), class == -1 padding."""
    out = np.full((max_boxes, 5), -1, np.float32)
    n = min(len(cls), max_boxes)
    if n:
        out[:n, 0] = cls[:n]
        out[:n, 1:5] = xywhn[:n]
    return out


class DetectionDataset:
    """Detection samples from disk: (RGB uint8 image, [N, 5] pixel-xyxy
    labels, id). Decoding needs cv2 except for ``.bmp``. The id scan is cached to
    ``<split_dir>/.samples.json`` when ``cache=True``."""

    def __init__(self, root: str, split: str = "train", cache: bool = False,
                 decode_size: int | None = None):
        if decode_size:
            raise NotImplementedError(
                "decode_size (reduced-size JPEG decode) is not ported yet "
                "(ROADMAP Queue 1, item 11)")
        self.dir = os.path.join(root, split)
        self.images_dir = os.path.join(self.dir, "images")
        self.labels_dir = os.path.join(self.dir, "labels")
        self.ids = self._scan(cache)

    def _scan(self, cache: bool) -> list[str]:
        cache_path = os.path.join(self.dir, ".samples.json")
        if cache and os.path.exists(cache_path):
            with open(cache_path) as f:
                return json.load(f)
        ids = sorted(
            os.path.splitext(name)[0]
            for name in os.listdir(self.images_dir)
            if name.lower().endswith(IMG_EXTS)
        )
        if cache:
            with open(cache_path, "w") as f:
                json.dump(ids, f)
        return ids

    def __len__(self) -> int:
        return len(self.ids)

    def image_path(self, idx: int) -> str:
        base = os.path.join(self.images_dir, self.ids[idx])
        for ext in IMG_EXTS:
            if os.path.exists(base + ext):
                return base + ext
        raise FileNotFoundError(base)

    def __getitem__(self, idx: int):
        labels = read_label_file(os.path.join(self.labels_dir, self.ids[idx] + ".txt"))
        return imread_rgb(self.image_path(idx)), labels, self.ids[idx]
