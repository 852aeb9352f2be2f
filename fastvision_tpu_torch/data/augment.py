"""Host-side augmentation with per-op probability and decision replay (port of
fastvision_tpu/data/augment.py, numpy-only ops).

Every op draws its decisions from an explicit ``np.random.Generator`` and
records them; `Augmentation.replay` applies the recorded decisions again.
The calls on the generator are those of the JAX package in the same order,
so one seed gives the same augmentations in both packages. Labels ride
along as [N, 5] pixel xyxy (cls, x1, y1, x2, y2).

`HSVJitter` converts to HSV and back in numpy with cv2's 8-bit definitions
(H in [0, 180), fixed-point RGB -> HSV, float HSV -> RGB), so it needs no
cv2: RGB -> HSV equals cv2's for every colour; HSV -> RGB is within 1 of it
(cv2 truncates in its vector path and rounds in its scalar one).

Not ported yet (ROADMAP Queue 1, item 11): Resize, ResizeByMax, Jitter,
HistEqualize, Blur, Padding, the crops, ChannelShuffle, Normalization.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

_HSV_SHIFT = 12
# cv2's division tables: round((255 << 12) / v) and round((180 << 12) / (6 d))
_SDIV = np.concatenate([[0], np.round((255 << _HSV_SHIFT) / np.arange(1, 256))]).astype(np.int64)
_HDIV = np.concatenate([[0], np.round((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256)))]
                       ).astype(np.int64)
# cv2's HSV -> RGB sectors: which of (v, p, q, t) each of (b, g, r) takes
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


class Op:
    """Base op: subclasses implement sample(rng, image) -> decision dict and
    apply(image, labels, decision) -> (image, labels)."""

    def __init__(self, p: float = 1.0):
        self.p = p

    def sample(self, rng: np.random.Generator, image: np.ndarray) -> dict:
        return {}

    def apply(self, image, labels, decision):
        raise NotImplementedError


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
    "hflip": HorizontalFlip,
    "vflip": VerticalFlip,
    "hsv": HSVJitter,
}
# the JAX package's other ops, not ported yet
_NOT_PORTED_OPS = ("bgr2rgb", "resize", "resize_by_max", "jitter", "padding", "center_crop",
                   "random_crop", "hist_equalize", "blur", "channel_shuffle", "normalization")


def build_augmentation(specs, mode: str = "detect") -> "Augmentation | None":
    """An Augmentation from config specs: ``'name'`` / ``'name:p'`` strings
    or ``{op: name, **kwargs}`` dicts (constructor arguments). None for an
    empty list (callers keep their default recipe). Ops the port does not
    have raise NotImplementedError."""
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
        name = str(name).lower()
        if name in _NOT_PORTED_OPS:
            raise NotImplementedError(
                f"augment op {name!r} is not ported yet (ROADMAP Queue 1, item 11); "
                f"the port has {sorted(OP_REGISTRY)}")
        cls = OP_REGISTRY.get(name)
        if cls is None:
            raise ValueError(f"unknown augment op {name!r} (available: {sorted(OP_REGISTRY)})")
        ops.append(cls(**kw))
    return Augmentation(ops, mode=mode)
