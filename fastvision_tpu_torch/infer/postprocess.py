"""Inference postprocessing: letterboxed-space boxes -> original image pixels,
and the reference demo's unscale before NMS (port of
fastvision_tpu/infer/postprocess.py)."""
from __future__ import annotations

import numpy as np
import torch


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


def reference_demo_unscale(pred: torch.Tensor, ratio, pad_left, pad_top, ori_w, ori_h,
                           min_wh: float = 5.0) -> torch.Tensor:
    """The yolov3_u demo's unscale to ORIGINAL pixels, before NMS, on the
    device: (cx, cy) unpadded and divided by ``ratio``, clamped to [0, ori -
    1]; (w, h) divided by ``ratio``, clamped to [0, ori]; boxes with w or h
    <= ``min_wh`` original pixels dropped (objectness -1, so the confidence
    filter removes them at fixed shapes); corners clamped to [0, ori - 1].

    pred: [..., N, 5 + C] xywh; the other arguments scalars or tensors of
    pred's leading shape (one per image). -> [..., N, 5 + C] rows (x1, y1,
    x2, y2, obj, cls...), for NMS with box_format='xyxy', score_mode='obj'."""
    def per_image(v):
        return torch.as_tensor(v, dtype=pred.dtype, device=pred.device)[..., None]

    ratio, pad_left, pad_top = per_image(ratio), per_image(pad_left), per_image(pad_top)
    ori_w, ori_h = per_image(ori_w), per_image(ori_h)

    def clip(x, hi):
        return torch.minimum(torch.clamp(x, min=0.0), hi)

    cx = clip((pred[..., 0] - pad_left) / ratio, ori_w - 1)
    cy = clip((pred[..., 1] - pad_top) / ratio, ori_h - 1)
    w = clip(pred[..., 2] / ratio, ori_w)
    h = clip(pred[..., 3] / ratio, ori_h)
    keep = (w > min_wh) & (h > min_wh)
    x1, y1 = clip(cx - w / 2, ori_w - 1), clip(cy - h / 2, ori_h - 1)
    x2, y2 = clip(cx + w / 2, ori_w - 1), clip(cy + h / 2, ori_h - 1)
    obj = torch.where(keep, pred[..., 4], torch.full_like(pred[..., 4], -1.0))
    return torch.cat([torch.stack([x1, y1, x2, y2, obj], dim=-1), pred[..., 5:]], dim=-1)


def detections_to_original(det, meta: dict, index: int | None = None) -> dict:
    """ops.nms.Detections (+ batch index) + preprocess meta -> numpy
    {boxes, scores, classes} in original-image pixels, padding stripped."""
    fields = [np.asarray(t.cpu()) for t in (det.boxes, det.scores, det.classes, det.valid)]
    if index is not None:
        fields = [f[index] for f in fields]
    boxes, scores, classes, valid = fields
    boxes = scale_coords(boxes[valid], meta["scale"], meta["pad"], meta["orig_hw"])
    return {"boxes": boxes, "scores": scores[valid], "classes": classes[valid]}
