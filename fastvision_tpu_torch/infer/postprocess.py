"""Inference postprocessing: letterboxed-space boxes -> original image pixels
(port of fastvision_tpu/infer/postprocess.py; the demo-exact pre-NMS
unscale is not ported yet)."""
from __future__ import annotations

import numpy as np


def scale_coords(boxes_xyxy, scale, pad: tuple[int, int],
                 orig_hw: tuple[int, int]) -> np.ndarray:
    """Boxes in letterboxed input space -> original-image pixels, clipped.
    ``scale`` is a scalar or an (sx, sy) pair."""
    boxes = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4).copy()
    px, py = pad
    sx, sy = (scale, scale) if np.isscalar(scale) else scale
    boxes[:, [0, 2]] = (boxes[:, [0, 2]] - px) / sx
    boxes[:, [1, 3]] = (boxes[:, [1, 3]] - py) / sy
    h, w = orig_hw
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
    return boxes


def detections_to_original(det, meta: dict, index: int | None = None) -> dict:
    """ops.nms.Detections (+ batch index) + preprocess meta -> numpy
    {boxes, scores, classes} in original-image pixels, padding stripped."""
    fields = [np.asarray(t.cpu()) for t in (det.boxes, det.scores, det.classes, det.valid)]
    if index is not None:
        fields = [f[index] for f in fields]
    boxes, scores, classes, valid = fields
    boxes = scale_coords(boxes[valid], meta["scale"], meta["pad"], meta["orig_hw"])
    return {"boxes": boxes, "scores": scores[valid], "classes": classes[valid]}
