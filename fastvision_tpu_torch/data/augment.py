"""Host-side augmentation with per-op probability and decision replay (port of
fastvision_tpu/data/augment.py, numpy-only ops).

Every op draws its decisions from an explicit ``np.random.Generator`` and
records them; `Augmentation.replay` applies the recorded decisions again.
The calls on the generator are those of the JAX package in the same order,
so one seed gives the same augmentations in both packages. Labels ride
along as [N, 5] pixel xyxy (cls, x1, y1, x2, y2).

The JAX package does its colour, resize and blur work with cv2; the port
has its own numpy code, held against cv2 for uint8 images:

- `HSVJitter`: RGB -> HSV equals cv2's for every colour; HSV -> RGB is
  within 1 of it (cv2 truncates in its vector path and rounds in its scalar
  one);
- `Resize`, `ResizeByMax`, `Jitter`: `dataset.resize_bilinear`, within 1 of
  ``cv2.INTER_LINEAR``;
- `HistEqualize`: ``COLOR_RGB2YUV`` / ``COLOR_YUV2RGB`` in cv2's 14-bit fixed
  point (equal for every colour) around CLAHE on Y with cv2's tiles, clip,
  redistribution and float32 interpolation (`clahe`), equal to cv2's;
- `Blur`: the median equals ``cv2.medianBlur`` (replicated border); the box
  filter is ``cv2.blur`` (reflect-101 border, exact sums rounded to
  nearest: equal for odd sizes) and the Gaussian ``cv2.GaussianBlur(k, k, 0)``
  with cv2's 8-bit fixed-point kernel (8 fraction bits, equal).

Every other op is numpy in both packages and byte-equal.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .dataset import resize_bilinear

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_HSV_SHIFT = 12
# cv2's division tables: round((255 << 12) / v) and round((180 << 12) / (6 d))
_SDIV = np.concatenate([[0], np.round((255 << _HSV_SHIFT) / np.arange(1, 256))]).astype(np.int64)
_HDIV = np.concatenate([[0], np.round((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256)))]
                       ).astype(np.int64)
# cv2's HSV -> RGB sectors: which of (v, p, q, t) each of (b, g, r) takes
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
# cv2's 8-bit YUV coefficients, 14 fraction bits: Y from R, G, B; U, V from
# B - Y, R - Y; and back: R from V, G from U and V, B from U
_YUV_SHIFT = 14
_R2Y, _G2Y, _B2Y, _B2U, _R2V = 4899, 9617, 1868, 8061, 14369
_V2R, _V2G, _U2G, _U2B = 18678, -9519, -6472, 33292
# cv2's 8-bit Gaussian kernels for ksize <= 7 and sigma 0, in 1/256
_SMALL_GAUSSIAN = {1: (256,), 3: (64, 128, 64), 5: (16, 64, 96, 64, 16),
                   7: (8, 28, 56, 72, 56, 28, 8)}


class Op:
    """Base op: subclasses implement sample(rng, image) -> decision dict and
    apply(image, labels, decision) -> (image, labels)."""

    def __init__(self, p: float = 1.0):
        self.p = p

    def sample(self, rng: np.random.Generator, image: np.ndarray) -> dict:
        return {}

    def apply(self, image, labels, decision):
        raise NotImplementedError


def _scaled(labels, sx: float, sy: float):
    if labels is not None and len(labels):
        labels = labels.copy()
        labels[:, [1, 3]] *= sx
        labels[:, [2, 4]] *= sy
    return labels


class BGR2RGB(Op):
    def apply(self, image, labels, decision):
        return image[..., ::-1], labels


class Resize(Op):
    """Exact resize to (size, size) or (h, w); labels scaled."""

    def __init__(self, size, p: float = 1.0):
        super().__init__(p)
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def apply(self, image, labels, decision):
        h, w = image.shape[:2]
        nh, nw = self.size
        return resize_bilinear(image, nh, nw), _scaled(labels, nw / w, nh / h)


class ResizeByMax(Op):
    """Long side -> size, aspect preserved."""

    def __init__(self, size: int, p: float = 1.0):
        super().__init__(p)
        self.size = size

    def apply(self, image, labels, decision):
        h, w = image.shape[:2]
        scale = self.size / max(h, w)
        image = resize_bilinear(image, round(h * scale), round(w * scale))
        if labels is not None and len(labels):
            labels = labels.copy()
            labels[:, 1:5] *= scale
        return image, labels


class Jitter(Op):
    """Random scale jitter of both axes by (1 +- ratio)."""

    def __init__(self, ratio: float = 0.3, p: float = 1.0):
        super().__init__(p)
        self.ratio = ratio

    def sample(self, rng, image):
        return {
            "sx": 1 + rng.uniform(-self.ratio, self.ratio),
            "sy": 1 + rng.uniform(-self.ratio, self.ratio),
        }

    def apply(self, image, labels, decision):
        h, w = image.shape[:2]
        nw, nh = max(round(w * decision["sx"]), 1), max(round(h * decision["sy"]), 1)
        return resize_bilinear(image, nh, nw), _scaled(labels, nw / w, nh / h)


class Padding(Op):
    """Pad to (size, size) (or the image's longer side, if larger), centred
    or at the top left."""

    def __init__(self, size: int, pad_value: int = 114, position: str = "center", p: float = 1.0):
        super().__init__(p)
        self.size = size
        self.pad_value = pad_value
        self.position = position

    def apply(self, image, labels, decision):
        h, w = image.shape[:2]
        size = max(self.size, h, w)
        if self.position == "center":
            top, left = (size - h) // 2, (size - w) // 2
        else:
            top, left = 0, 0
        out = np.full((size, size, image.shape[2]), self.pad_value, image.dtype)
        out[top : top + h, left : left + w] = image
        if labels is not None and len(labels):
            labels = labels.copy()
            labels[:, [1, 3]] += left
            labels[:, [2, 4]] += top
        return out, labels


class _CropBase(Op):
    def __init__(self, size: int, p: float = 1.0):
        super().__init__(p)
        self.size = size

    def _crop(self, image, labels, top, left):
        ch = cw = self.size
        image = image[top : top + ch, left : left + cw]
        if labels is not None and len(labels):
            labels = labels.copy()
            labels[:, [1, 3]] = np.clip(labels[:, [1, 3]] - left, 0, image.shape[1])
            labels[:, [2, 4]] = np.clip(labels[:, [2, 4]] - top, 0, image.shape[0])
            # boxes left with 1 px or less on either side are dropped
            keep = (labels[:, 3] - labels[:, 1] > 1) & (labels[:, 4] - labels[:, 2] > 1)
            labels = labels[keep]
        return image, labels


class CenterCrop(_CropBase):
    def apply(self, image, labels, decision):
        h, w = image.shape[:2]
        return self._crop(image, labels, max((h - self.size) // 2, 0), max((w - self.size) // 2, 0))


class RandomCrop(_CropBase):
    def sample(self, rng, image):
        h, w = image.shape[:2]
        return {
            "top": int(rng.integers(0, max(h - self.size, 0) + 1)),
            "left": int(rng.integers(0, max(w - self.size, 0) + 1)),
        }

    def apply(self, image, labels, decision):
        return self._crop(image, labels, decision["top"], decision["left"])


class HorizontalFlip(Op):
    def apply(self, image, labels, decision):
        w = image.shape[1]
        image = image[:, ::-1]
        if labels is not None and len(labels):
            labels = labels.copy()
            x1 = labels[:, 1].copy()
            labels[:, 1] = w - labels[:, 3]
            labels[:, 3] = w - x1
        return image, labels


class VerticalFlip(Op):
    def apply(self, image, labels, decision):
        h = image.shape[0]
        image = image[::-1]
        if labels is not None and len(labels):
            labels = labels.copy()
            y1 = labels[:, 2].copy()
            labels[:, 2] = h - labels[:, 4]
            labels[:, 4] = h - y1
        return image, labels


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
    """RGB uint8 -> HSV uint8, H in [0, 180): cv2's ``COLOR_RGB2HSV`` for
    8-bit images, with its fixed-point arithmetic."""
    rgb = image.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = rgb.max(-1)
    diff = v - rgb.min(-1)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """HSV uint8 (H in [0, 180)) -> RGB uint8: cv2's ``COLOR_HSV2RGB`` for
    8-bit images, in float32, truncated to uint8 as cv2's vector path does
    (its scalar path rounds: +-1 per channel)."""
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    h = np.where(h >= 6, h - 6, h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return np.clip(bgr[..., ::-1] * np.float32(255.0), 0, 255).astype(np.uint8)


class HSVJitter(Op):
    """Random hue / saturation / value gains (the JAX package's draws)."""

    def __init__(self, h_gain=0.015, s_gain=0.7, v_gain=0.4, p: float = 1.0):
        super().__init__(p)
        self.gains = (h_gain, s_gain, v_gain)

    def sample(self, rng, image):
        return {"r": (rng.uniform(-1, 1, 3) * np.asarray(self.gains) + 1).tolist()}

    def apply(self, image, labels, decision):
        r = np.asarray(decision["r"], np.float32)
        hsv = rgb_to_hsv(image).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] * r[0]) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] * r[1], 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] * r[2], 0, 255)
        return hsv_to_rgb(hsv.astype(np.uint8)), labels


def _descale(x: np.ndarray) -> np.ndarray:
    return (x + (1 << (_YUV_SHIFT - 1))) >> _YUV_SHIFT


def rgb_to_yuv(image: np.ndarray) -> np.ndarray:
    """RGB uint8 -> YUV uint8: cv2's ``COLOR_RGB2YUV`` for 8-bit images."""
    rgb = image.astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = _descale(r * _R2Y + g * _G2Y + b * _B2Y)
    half = 128 << _YUV_SHIFT
    u = _descale((b - y) * _B2U + half)
    v = _descale((r - y) * _R2V + half)
    return np.clip(np.stack([y, u, v], -1), 0, 255).astype(np.uint8)


def yuv_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """YUV uint8 -> RGB uint8: cv2's ``COLOR_YUV2RGB`` for 8-bit images."""
    x = yuv.astype(np.int32)
    y, u, v = x[..., 0], x[..., 1] - 128, x[..., 2] - 128
    r = y + _descale(v * _V2R)
    g = y + _descale(u * _U2G + v * _V2G)
    b = y + _descale(u * _U2B)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def uint8_only(image: np.ndarray, what: str) -> None:
    """Raises for a non-uint8 image where ``what`` needs uint8."""
    if image.dtype != np.uint8:
        raise ValueError(f"{what} takes uint8 images, got {image.dtype} (an augmentation "
                         "ending in 'normalization' gives float32)")


def clahe(gray: np.ndarray, clip_limit: float = 2.0, tiles: tuple[int, int] = (8, 8)
          ) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization of a uint8 [H, W]
    image: cv2's ``createCLAHE(clipLimit, tileGridSize=tiles).apply``.

    An image whose sides are not both multiples of the grid is padded
    (reflect-101) at the bottom and right by ``tiles - side % tiles`` on
    both axes, as cv2 pads it, for the histograms only. Each tile's
    histogram is clipped at ``max(int(clip_limit * area / 256), 1)``, the
    excess spread evenly and its remainder one count every
    ``max(256 // remainder, 1)`` bins; the LUT is the cumulative histogram
    times 255 / area in float32, rounded half to even. Each pixel blends the
    LUTs of its four nearest tile centres in float32."""
    uint8_only(gray, "clahe")
    gx, gy = tiles
    h, w = gray.shape
    src = gray
    if h % gy or w % gx:
        src = np.pad(gray, ((0, gy - h % gy), (0, gx - w % gx)), mode="reflect")
    th, tw = src.shape[0] // gy, src.shape[1] // gx
    area = th * tw
    tile_of = src.reshape(gy, th, gx, tw).transpose(0, 2, 1, 3).reshape(gy * gx, area)
    offsets = (np.arange(gy * gx, dtype=np.int64) * 256)[:, None]
    hist = np.bincount((tile_of + offsets).ravel(), minlength=gy * gx * 256)
    hist = hist.reshape(gy * gx, 256).astype(np.int64)
    if clip_limit > 0:
        limit = max(int(clip_limit * area / 256), 1)
        clipped = np.maximum(hist - limit, 0).sum(1)
        hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
        for t, rest in enumerate(clipped % 256):
            if rest:
                hist[t, np.arange(0, 256, max(256 // int(rest), 1))[:rest]] += 1
    lut_scale = np.float32(255.0) / np.float32(area)
    lut = np.rint(np.cumsum(hist, 1).astype(np.float32) * lut_scale)
    lut = np.clip(lut, 0, 255).astype(np.float32).reshape(gy, gx, 256)

    def axis(n: int, size: int, tiles_n: int):
        f = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(size)) - np.float32(0.5)
        lo = np.floor(f).astype(np.int64)
        frac = f - lo.astype(np.float32)
        return (np.maximum(lo, 0), np.minimum(lo + 1, tiles_n - 1), frac,
                np.float32(1.0) - frac)

    x1, x2, xa, xa1 = axis(w, tw, gx)
    y1, y2, ya, ya1 = axis(h, th, gy)
    v = gray.astype(np.int64)
    top = lut[y1[:, None], x1[None, :], v] * xa1 + lut[y1[:, None], x2[None, :], v] * xa
    bottom = lut[y2[:, None], x1[None, :], v] * xa1 + lut[y2[:, None], x2[None, :], v] * xa
    out = top * ya1[:, None] + bottom * ya[:, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class HistEqualize(Op):
    """CLAHE on the luminance channel (8 x 8 tiles)."""

    def __init__(self, clip_limit: float = 2.0, p: float = 1.0):
        super().__init__(p)
        self.clip_limit = clip_limit

    def apply(self, image, labels, decision):
        uint8_only(image, "hist_equalize")
        yuv = rgb_to_yuv(image)
        yuv[..., 0] = clahe(yuv[..., 0], self.clip_limit)
        return yuv_to_rgb(yuv), labels


def _reflect101(x: np.ndarray, before: int, after: int, axis: int) -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (before, after)
    return np.pad(x, pad, mode="reflect")


def _window_sum(x: np.ndarray, taps, axis: int) -> np.ndarray:
    """sum_j taps[j] * x[i + j - k // 2] along ``axis``, reflect-101 border."""
    k = len(taps)
    p = _reflect101(x, k // 2, k - 1 - k // 2, axis)
    n = x.shape[axis]
    return sum(t * np.take(p, np.arange(j, j + n), axis=axis) for j, t in enumerate(taps))


def box_blur(image: np.ndarray, ksize: int) -> np.ndarray:
    """Normalized k x k box filter, reflect-101 border: ``cv2.blur``. uint8:
    the exact window sums rounded to nearest (cv2's result for odd k)."""
    acc = np.int32 if image.dtype == np.uint8 else np.float64
    ones = (1,) * ksize
    s = _window_sum(_window_sum(image.astype(acc), ones, 1), ones, 0)
    if image.dtype == np.uint8:
        return np.clip(np.rint(s / (ksize * ksize)), 0, 255).astype(np.uint8)
    return (s / (ksize * ksize)).astype(image.dtype)


def gaussian_kernel_8bit(ksize: int) -> np.ndarray:
    """cv2's fixed-point Gaussian kernel for 8-bit images at sigma 0 (sigma
    = 0.3 ((k - 1) / 2 - 1) + 0.8), in units of 1/256: its table for k <= 7,
    else the normalized Gaussian rounded from the outside in with the error
    carried over, the centre taking what is left of 256."""
    if ksize in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[ksize], np.int64)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    g = np.exp(-x * x / (2 * sigma * sigma))
    g = g / g.sum()
    out = np.zeros(ksize, np.int64)
    err = 0.0
    for i in range(ksize // 2):
        adj = g[i] * 256 + err
        out[i] = out[ksize - 1 - i] = int(np.rint(adj))
        err = adj - out[i]
    out[ksize // 2] = 256 - 2 * out[: ksize // 2].sum()
    return out


def gaussian_blur(image: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.GaussianBlur(image, (k, k), 0)``, reflect-101 border. uint8:
    cv2's fixed-point path (rows, then columns, in integers; the sum
    rounded at 16 fraction bits); float images: the same kernel in float64."""
    kern = gaussian_kernel_8bit(ksize)
    if image.dtype == np.uint8:
        s = _window_sum(_window_sum(image.astype(np.int32), kern, 1), kern, 0)
        return np.clip((s + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
    kern = kern / 256.0
    return _window_sum(_window_sum(image.astype(np.float64), kern, 1), kern, 0).astype(image.dtype)


def _batcher_pairs(n: int) -> list[tuple[int, int]]:
    """Batcher's odd-even merge sorting network on n = 2^m wires."""
    pairs, p = [], 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _median_network(n: int) -> list[tuple[int, int]]:
    """The comparators of a sorting network on n wires (padded to a power of
    two) that the middle output depends on."""
    need, kept = {n // 2}, []
    for a, b in reversed(_batcher_pairs(1 << (n - 1).bit_length())):
        if a in need or b in need:
            kept.append((a, b))
            need |= {a, b}
    return kept[::-1]


def median_blur(image: np.ndarray, ksize: int) -> np.ndarray:
    """k x k median per channel, border replicated: ``cv2.medianBlur``.
    The k^2 shifted planes go through a sorting network's min / max pairs
    (the padding wires stand for +inf and cost nothing)."""
    a = ksize // 2
    h, w = image.shape[:2]
    p = np.pad(image, ((a, a), (a, a)) + ((0, 0),) * (image.ndim - 2), mode="edge")
    n = ksize * ksize
    wires = [p[i : i + h, j : j + w] for i in range(ksize) for j in range(ksize)]
    wires += [None] * ((1 << (n - 1).bit_length()) - n)
    for i, j in _median_network(n):
        lo, hi = wires[i], wires[j]
        if hi is None:
            continue
        wires[i], wires[j] = (hi, None) if lo is None else (np.minimum(lo, hi), np.maximum(lo, hi))
    return np.ascontiguousarray(wires[n // 2])


class Blur(Op):
    """Box (``kind='box'``), Gaussian or median blur of odd size ``ksize``."""

    def __init__(self, ksize: int = 3, kind: str = "box", p: float = 1.0):
        super().__init__(p)
        self.ksize = ksize
        self.kind = kind

    def apply(self, image, labels, decision):
        if self.kind == "median":
            return median_blur(image, self.ksize), labels
        if self.kind == "gaussian":
            return gaussian_blur(image, self.ksize), labels
        return box_blur(image, self.ksize), labels


class ChannelShuffle(Op):
    def sample(self, rng, image):
        return {"perm": rng.permutation(3).tolist()}

    def apply(self, image, labels, decision):
        return image[..., decision["perm"]], labels


class Normalization(Op):
    """uint8 -> float32 ImageNet-normalized (the loaders then emit float32
    batches; the train steps normalize uint8 on the device instead)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD, p: float = 1.0):
        super().__init__(p)
        self.mean, self.std = np.asarray(mean, np.float32), np.asarray(std, np.float32)

    def apply(self, image, labels, decision):
        img = image.astype(np.float32) / 255.0
        return (img - self.mean) / self.std, labels


class Augmentation:
    """Composable pipeline with per-op probability and decision replay.

    >>> aug = Augmentation([HorizontalFlip(p=.5), VerticalFlip(p=.5)])
    >>> img1, lab1 = aug(img1, lab1, rng)
    >>> img2, lab2 = aug.replay(img2, lab2)   # identical decisions
    """

    def __init__(self, ops: Sequence[Op], mode: str = "detect"):
        self.ops = list(ops)
        self.mode = mode
        self._last: list[dict | None] = []

    def __call__(self, image, labels=None, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        self._last = []
        for op in self.ops:
            if rng.uniform() < op.p:
                decision = op.sample(rng, image)
                image, labels = op.apply(image, labels, decision)
                self._last.append(decision)
            else:
                self._last.append(None)
        return image, labels

    def replay(self, image, labels=None):
        """Apply the previous call's exact decisions."""
        if not self._last:
            raise RuntimeError("replay() before any __call__")
        for op, decision in zip(self.ops, self._last):
            if decision is not None:
                image, labels = op.apply(image, labels, decision)
        return image, labels


OP_REGISTRY: dict[str, type] = {
    "bgr2rgb": BGR2RGB,
    "resize": Resize,
    "resize_by_max": ResizeByMax,
    "jitter": Jitter,
    "padding": Padding,
    "center_crop": CenterCrop,
    "random_crop": RandomCrop,
    "hflip": HorizontalFlip,
    "vflip": VerticalFlip,
    "hsv": HSVJitter,
    "hist_equalize": HistEqualize,
    "blur": Blur,
    "channel_shuffle": ChannelShuffle,
    "normalization": Normalization,
}


def build_augmentation(specs, mode: str = "detect") -> "Augmentation | None":
    """An Augmentation from config specs: ``'name'`` / ``'name:p'`` strings
    or ``{op: name, **kwargs}`` dicts (constructor arguments), e.g. in YAML::

        data:
          augment:
            - hflip:0.5
            - {op: hsv, p: 0.5, s_gain: 0.6}
            - {op: jitter, ratio: 0.3}

    None for an empty list (callers keep their default recipe)."""
    if not specs:
        return None
    ops = []
    for spec in specs:
        if isinstance(spec, str):
            name, _, p = spec.partition(":")
            kw = {"p": float(p)} if p else {}
        elif isinstance(spec, dict):
            kw = dict(spec)
            name = kw.pop("op", None)
            if not name:
                raise ValueError(f"augment spec {spec!r} needs an 'op' key")
        else:
            raise ValueError(f"augment spec must be a string or dict, got {spec!r}")
        cls = OP_REGISTRY.get(str(name).lower())
        if cls is None:
            raise ValueError(f"unknown augment op {name!r} (available: {sorted(OP_REGISTRY)})")
        ops.append(cls(**kw))
    return Augmentation(ops, mode=mode)
