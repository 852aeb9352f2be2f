"""The one generator of the benchmark's inputs, driven by a traffic file.

A training mix is a pool of ``pool`` host batches of ``batch`` uint8 NHWC
images at the configuration's input size, cycled: noise with filled
rectangles. The mix's ``labels`` says what the rectangles are: 'boxes',
the images' detection labels (the count per image from ``boxes.count``,
the sides from ``boxes.side``, classes uniform), padded to the
configuration's ``max_boxes`` with class -1; 'classes', ``rects``
rectangles an image (sides from ``side``) and one uniform class label an
image. Pixels are drawn on the card from the seed, the counts and boxes on
the host from the seed; the same seed gives the same pool.
"""
from __future__ import annotations

import numpy as np
import torch

PIXEL_SALT = 0x5EED  # the pixel stream's seed is the run's seed xor this


def _counts(rng: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """Boxes per image: a lognormal draw (``median``, ``sigma``) floored and
    cut to [0, ``max``] (COCO's heavy tail)."""
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.floor(x), 0, spec["max"]).astype(np.int64)


def _boxes(rng: np.random.Generator, n: int, side: dict) -> np.ndarray:
    """[n, 4] normalized (cx, cy, w, h), sides log-uniform in [min, max],
    each box inside the image."""
    wh = np.exp(rng.uniform(np.log(side["min"]), np.log(side["max"]), (n, 2)))
    c = wh / 2 + rng.uniform(0, 1, (n, 2)) * (1 - wh)
    return np.concatenate([c, wh], axis=1).astype(np.float32)


def _paint(images: torch.Tensor, boxes: list[np.ndarray], rng: np.random.Generator) -> None:
    """Fills each image's boxes (normalized cxcywh) with a colour, in place."""
    n, h, w, _ = images.shape
    colours = torch.from_numpy(rng.integers(0, 256, (256, 3), dtype=np.uint8)).to(images.device)
    for i, bx in enumerate(boxes):
        for k, (cx, cy, bw, bh) in enumerate(bx):
            x1, x2 = int((cx - bw / 2) * w), max(int((cx + bw / 2) * w), int((cx - bw / 2) * w) + 1)
            y1, y2 = int((cy - bh / 2) * h), max(int((cy + bh / 2) * h), int((cy - bh / 2) * h) + 1)
            images[i, y1:y2, x1:x2] = colours[(i + k) % 256]


def _pixels(seed: int, shape: tuple, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed ^ PIXEL_SALT)
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)


def _box_labels(cfg: dict, traffic: dict, n: int, rng: np.random.Generator):
    spec = traffic["boxes"]
    counts = _counts(rng, n, spec["count"])
    boxes = [_boxes(rng, int(c), spec["side"]) for c in counts]
    labels = np.full((n, cfg["max_boxes"], 5), -1.0, np.float32)
    labels[..., 1:] = 0.0
    for i, bx in enumerate(boxes):
        labels[i, : len(bx), 0] = rng.integers(0, cfg["num_classes"], len(bx))
        labels[i, : len(bx), 1:] = bx
    return boxes, labels


def _class_labels(cfg: dict, traffic: dict, n: int, rng: np.random.Generator):
    boxes = [_boxes(rng, traffic["rects"], traffic["side"]) for _ in range(n)]
    return boxes, rng.integers(0, cfg["num_classes"], n).astype(np.int64)


LABELS = {"boxes": _box_labels, "classes": _class_labels}


def train_pool(cfg: dict, traffic: dict, seed: int, device: torch.device) -> list[dict]:
    """-> ``pool`` host batches {'images' [B, S, S, 3] uint8, 'labels'}."""
    b, pool, s = traffic["batch"], traffic["pool"], cfg["input_size"]
    n = b * pool
    rng = np.random.default_rng(seed)
    images = _pixels(seed, (n, s, s, 3), device)
    boxes, labels = LABELS[traffic["labels"]](cfg, traffic, n, rng)
    _paint(images, boxes, rng)
    host = images.cpu().numpy()
    return [{"images": host[i * b:(i + 1) * b], "labels": labels[i * b:(i + 1) * b]}
            for i in range(pool)]
