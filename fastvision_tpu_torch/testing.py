"""Seeded inputs that stress the exactness of greedy NMS suppression.

Shared by the CPU tests, the card tests and ``chip_smoke.py``, so every
place that holds the CUDA kernel against its plain version draws the same
kinds of cases: class-offset coordinates, exact score ties, -inf tails and
pairs built to sit on the IoU threshold.
"""
from __future__ import annotations

import numpy as np


def nms_case(seed: int, b: int, k: int, iou_thres: float = 0.45, *, ties: bool = True,
             neg_inf_tail: bool = True, class_offset: float | None = 4096.0,
             on_threshold: bool = True, num_classes: int = 80) -> tuple[np.ndarray, np.ndarray]:
    """-> (boxes [b, k, 4] float32 xyxy, scores [b, k] float32), each image's
    scores sorted descending (the suppression contract).

    ties: scores quantized to a few levels, so runs of equal scores occur.
    neg_inf_tail: the last quarter of each image scores -inf (invalid).
    class_offset: boxes shifted by class * offset, classes 0..num_classes-1,
      as the class-aware NMS does before suppression (None: no shift).
    on_threshold: every other box is a copy of its predecessor narrowed to
      ``iou_thres`` of its width, so the pair's IoU is the threshold up to
      float32 rounding."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 400, (b, k, 2))
    wh = rng.uniform(4, 120, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    if on_threshold and k > 1:
        src = boxes[:, 0:-1:2]
        partner = src.copy()
        partner[..., 2] = src[..., 0] + (src[..., 2] - src[..., 0]) * np.float32(iou_thres)
        boxes[:, 1::2] = partner
    if class_offset is not None:
        cls = rng.integers(0, num_classes, (b, k, 1)).astype(np.float32)
        if on_threshold and k > 1:
            cls[:, 1::2] = cls[:, 0:-1:2]  # a pair shares its class
        boxes = (boxes + cls * np.float32(class_offset)).astype(np.float32)
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    if ties:
        scores = (np.round(scores * 8) / 8).astype(np.float32)
    scores = -np.sort(-scores, axis=-1, kind="stable")
    if neg_inf_tail:
        scores[:, k - k // 4:] = -np.inf
    return boxes, np.ascontiguousarray(scores)
