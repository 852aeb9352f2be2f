"""Host image reading, letterbox, label files and the detection dataset (port
of fastvision_tpu/data/dataset.py).

The on-disk format: ``<root>/{train,val,test}/images/<id>.jpg`` and
``labels/<id>.txt``, one ``category_idx xmin ymin xmax ymax`` line per box in
original pixels, classes 0-based.

The resize is ``torch.nn.functional.interpolate(mode='bilinear',
align_corners=False, antialias=False)`` on host tensors, rounded back to
uint8: the same sampling as cv2's ``INTER_LINEAR``, within +-1 per pixel
(cv2 rounds with fixed-point weights). Its float kernel rounds a few pixels
differently on one intra-op thread and on several, so the loaders run all
their host work on one thread (`pipeline._PooledLoader`). Image files are
read as ``cv2.imread`` reads them: JPEG (Huffman- or arithmetic-coded,
sequential, progressive or lossless; a truncated or corrupt file decoded as
libjpeg's stdio source decodes it), PNG and BMP by the port's own decoders
(`codec.decode_image`'s file route, bit-equal to cv2's ``IMREAD_COLOR``),
so no reader needs cv2 for them; any other format through ``cv2.imread``
where cv2 imports (`codec.cv2_decode`). ``imwrite_rgb`` writes ``.bmp``
with numpy and other formats with cv2.

`imread_rgb_scaled` decodes an oversized JPEG at 1/2, 1/4 or 1/8 in the DCT
domain (`codec.decode_jpeg_reduced`, cv2's ``IMREAD_REDUCED_COLOR_*``), and
`DetectionDataset.sample_i420` runs the fused JPEG -> letterboxed I420
decode (`codec.decode_jpeg_i420`). Both report the original size in the
EXIF-oriented frame the pixels are in; the JAX package reports the SOF
header's size there and its fused decode ignores the orientation (ROADMAP
Queue 3).
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .codec import decode_bmp, decode_image, decode_jpeg_i420, decode_jpeg_reduced, jpeg_size

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def read_bmp(path: str) -> np.ndarray:
    """A BMP file -> RGB uint8 HWC (`codec.decode_bmp`: every kind cv2
    reads). Anything else raises ValueError."""
    with open(path, "rb") as f:
        return decode_bmp(f.read(), path)


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
    """Decode an image file -> RGB uint8 HWC as ``cv2.imread(path,
    IMREAD_COLOR)`` + BGR -> RGB (`codec.decode_image`'s file route: the
    format told apart by its bytes; JPEG, PNG and BMP without cv2). A file
    cv2 gives no image for raises ValueError naming the file; a format
    only cv2 decodes, where cv2 cannot be imported, NotImplementedError."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data, path)
    except ValueError as e:
        raise ValueError(f"cannot decode image {path}: {e}") from None


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


# SOF markers that carry frame dimensions (all but DHT C4, JPG C8 and DAC CC)
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def jpeg_dimensions(path: str, max_header: int = 262144) -> tuple[int, int] | None:
    """(height, width) from the JPEG SOF header without decoding pixels (the
    stored frame: no EXIF orientation). None for a non-JPEG file or a header
    longer than ``max_header`` bytes."""
    with open(path, "rb") as f:
        data = f.read(max_header)
    if data[:2] != b"\xff\xd8":
        return None
    i, n = 2, len(data)
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker in _JPEG_SOF:
            return (int.from_bytes(data[i + 5 : i + 7], "big"),
                    int.from_bytes(data[i + 7 : i + 9], "big"))
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:  # standalone markers
            i += 2
            continue
        i += 2 + int.from_bytes(data[i + 2 : i + 4], "big")
    return None


def imread_rgb_scaled(path: str, target_size: int) -> tuple[np.ndarray, tuple[int, int]]:
    """Read an image, decoding a JPEG at 1/2, 1/4 or 1/8 in the DCT domain
    when its long side is at least 2x, 4x, 8x ``target_size``
    (the largest such f; cv2's ``IMREAD_REDUCED_COLOR_*`` pixels, which
    are full size for a lossless JPEG). -> (RGB image, possibly reduced to
    ceil(side / f); the original (h, w) in the image's EXIF-oriented frame).
    A reduced decode that fails falls back to the full one, as the JAX
    package's does. Other files: `imread_rgb`, whose shape is the original
    (an EXIF-turned PNG's turned shape)."""
    dims = jpeg_dimensions(path) if path.lower().endswith((".jpg", ".jpeg")) else None
    if dims is not None:
        factor = next((f for f in (8, 4, 2) if max(dims) >= f * target_size), 1)
        if factor > 1:
            with open(path, "rb") as f:
                data = f.read()
            try:
                return decode_jpeg_reduced(data, factor, "file"), jpeg_size(data)
            except ValueError:
                pass  # cv2.imread gave no reduced image: the full decode decides
    img = imread_rgb(path)
    return img, img.shape[:2]


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


def _rescale_labels(labels: np.ndarray, decoded_hw, orig_hw) -> np.ndarray:
    """Pixel-xyxy labels of the original image -> the decoded (reduced) one's."""
    (dh, dw), (oh, ow) = decoded_hw, orig_hw
    if (dh, dw) != (oh, ow) and len(labels):
        labels = labels.copy()
        labels[:, [1, 3]] *= dw / ow
        labels[:, [2, 4]] *= dh / oh
    return labels


class DetectionDataset:
    """Detection samples from disk: (RGB uint8 image, [N, 5] pixel-xyxy
    labels, id), decoded by `imread_rgb`. The id scan is cached to
    ``<split_dir>/.samples.json`` when ``cache=True``.

    ``decode_size``: a JPEG at least 2x larger than it is decoded reduced
    (`imread_rgb_scaled`) and its labels rescaled into the reduced image's
    pixels, so everything downstream stays consistent, only cheaper."""

    def __init__(self, root: str, split: str = "train", cache: bool = False,
                 decode_size: int | None = None):
        self.dir = os.path.join(root, split)
        self.images_dir = os.path.join(self.dir, "images")
        self.labels_dir = os.path.join(self.dir, "labels")
        self.decode_size = decode_size
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
        if self.decode_size:
            image, orig_hw = imread_rgb_scaled(self.image_path(idx), self.decode_size)
            labels = _rescale_labels(labels, image.shape[:2], orig_hw)
        else:
            image = imread_rgb(self.image_path(idx))
        return image, labels, self.ids[idx]

    def sample_i420(self, idx: int, input_size: int, pad_value: int = 114):
        """The fused JPEG -> letterboxed packed-I420 sample
        (`codec.decode_jpeg_i420`), with ``decode_size``'s reduction and
        its label rescale. -> (packed [S*3/2, S] uint8, labels [N, 5] in
        decoded pixels, id, scale, (pad_left, pad_top), (decoded_h,
        decoded_w)), or None where the JAX package takes its plain chain
        (not a JPEG file, an RGB-coded JPEG, other sampling)."""
        path = self.image_path(idx)
        if not path.lower().endswith((".jpg", ".jpeg")):
            return None
        with open(path, "rb") as f:
            data = f.read()
        try:
            r = decode_jpeg_i420(data, input_size, pad_value, reduce_target=self.decode_size or 0)
        except ValueError as e:
            raise ValueError(f"cannot decode image {path}: {e}") from None
        if r is None:
            return None
        packed, _, pad, orig_hw, (dh, dw) = r
        # the scale in float64, so the label arithmetic is the letterbox path's
        scale = input_size / max(dh, dw)
        labels = read_label_file(os.path.join(self.labels_dir, self.ids[idx] + ".txt"))
        return (packed, _rescale_labels(labels, (dh, dw), orig_hw), self.ids[idx], scale, pad,
                (dh, dw))


class ClassificationDataset:
    """Folder-per-class layout: ``<root>/<split>/<class_name>/<image>``.
    Class indices follow the sorted folder names, or ``categories`` (the
    dataset descriptor's order). -> (RGB uint8 image, class index), decoded
    by `imread_rgb`."""

    def __init__(self, root: str, split: str = "train",
                 categories: Sequence[str] | None = None):
        self.dir = os.path.join(root, split)
        self.class_names = list(categories or sorted(
            d for d in os.listdir(self.dir) if os.path.isdir(os.path.join(self.dir, d))))
        self.samples: list[tuple[str, int]] = []
        for ci, name in enumerate(self.class_names):
            cdir = os.path.join(self.dir, name)
            if os.path.isdir(cdir):
                self.samples += [(os.path.join(cdir, f), ci) for f in sorted(os.listdir(cdir))
                                 if f.lower().endswith(IMG_EXTS)]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        return imread_rgb(path), label
