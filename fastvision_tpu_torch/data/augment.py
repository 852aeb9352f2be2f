"""Host-side augmentation with per-op probability and decision replay (port of
fastvision_tpu/data/augment.py, numpy-only ops).

Every op draws its decisions from an explicit ``np.random.Generator`` and
records them; `Augmentation.replay` applies the recorded decisions again.
The calls on the generator are those of the JAX package in the same order,
so one seed gives the same augmentations in both packages. Labels ride
along as [N, 5] pixel xyxy (cls, x1, y1, x2, y2).

Not ported yet (they need cv2): Resize, ResizeByMax, Jitter, HSVJitter,
HistEqualize, Blur; nor Padding, the crops, ChannelShuffle, Normalization,
``build_augmentation`` and mosaic.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


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
