"""IoU family: paired and all-pairs IoU / GIoU / DIoU / CIoU, plus wh-IoU.

Port of fastvision_tpu/ops/iou.py, with its penalty-sign fixes (GIoU
subtracts the enclosing-area penalty, DIoU subtracts the centre-distance
term). The IoU keeps the reference's operation order exactly:
``union = area1 + area2 - inter + eps`` then ``inter / union``, with
``eps = 1e-7``; greedy NMS is bit-exact against the JAX package only with
this order.
"""
from __future__ import annotations

import math

import torch

from .box import xywh2xyxy

_EPS = 1e-7


def _to_xyxy(box: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "xyxy":
        return box
    if fmt == "xywh":
        return xywh2xyxy(box)
    raise ValueError("fmt must be 'xyxy' or 'xywh'")


def box_iou(box1, box2, *, kind: str = "iou", fmt: str = "xyxy", eps: float = _EPS):
    """Elementwise (broadcast) IoU-family between ``[..., 4]`` boxes -> ``[...]``.

    kind: 'iou' | 'giou' | 'diou' | 'ciou'; fmt: 'xyxy' or 'xywh'."""
    b1 = _to_xyxy(torch.as_tensor(box1, dtype=torch.float32), fmt)
    b2 = _to_xyxy(torch.as_tensor(box2, dtype=torch.float32), fmt)
    x11, y11, x12, y12 = b1.unbind(-1)
    x21, y21, x22, y22 = b2.unbind(-1)

    iw = (torch.minimum(x12, x22) - torch.maximum(x11, x21)).clamp(min=0)
    ih = (torch.minimum(y12, y22) - torch.maximum(y11, y21)).clamp(min=0)
    inter = iw * ih
    area1 = (x12 - x11) * (y12 - y11)
    area2 = (x22 - x21) * (y22 - y21)
    union = area1 + area2 - inter + eps
    iou = inter / union
    if kind == "iou":
        return iou

    # smallest enclosing box
    cw = torch.maximum(x12, x22) - torch.minimum(x11, x21)
    ch = torch.maximum(y12, y22) - torch.minimum(y11, y21)
    if kind == "giou":
        c_area = cw * ch + eps
        return iou - (c_area - (union - eps)) / c_area

    c2 = cw**2 + ch**2 + eps
    rho2 = ((x21 + x22) - (x11 + x12)) ** 2 / 4 + ((y21 + y22) - (y11 + y12)) ** 2 / 4
    if kind == "diou":
        return iou - rho2 / c2

    if kind == "ciou":
        w1, h1 = x12 - x11, y12 - y11
        w2, h2 = x22 - x21, y22 - y21
        v = (4 / math.pi**2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
        alpha = (v / (v - iou + (1 + eps))).detach()
        return iou - (rho2 / c2 + alpha * v)

    raise ValueError(f"unknown kind: {kind!r}")


def box_iou_matrix(box1, box2, *, kind: str = "iou", fmt: str = "xyxy", eps: float = _EPS):
    """All-pairs IoU-family: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    box1 = torch.as_tensor(box1)
    box2 = torch.as_tensor(box2)
    return box_iou(box1[..., :, None, :], box2[..., None, :, :], kind=kind, fmt=fmt, eps=eps)


def wh_iou(wh1, wh2, eps: float = _EPS):
    """Elementwise IoU of zero-anchored (w, h) boxes: [..., 2] -> [...]."""
    wh1 = torch.as_tensor(wh1, dtype=torch.float32)
    wh2 = torch.as_tensor(wh2, dtype=torch.float32)
    inter = torch.minimum(wh1[..., 0], wh2[..., 0]) * torch.minimum(wh1[..., 1], wh2[..., 1])
    union = wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1] - inter + eps
    return inter / union


def wh_iou_matrix(wh1, wh2, eps: float = _EPS):
    """All-pairs wh-IoU: [N, 2] x [M, 2] -> [N, M]."""
    wh1 = torch.as_tensor(wh1)
    wh2 = torch.as_tensor(wh2)
    return wh_iou(wh1[..., :, None, :], wh2[..., None, :, :], eps=eps)


def cal_iou(box1, box2, mode: str = "xyxy", eps: float = _EPS):
    if mode == "wh":
        return wh_iou(box1, box2, eps=eps)
    return box_iou(box1, box2, kind="iou", fmt=mode, eps=eps)


def cal_iou_batch(box1, box2, mode: str = "xyxy", eps: float = _EPS):
    if mode == "wh":
        return wh_iou_matrix(box1, box2, eps=eps)
    return box_iou_matrix(box1, box2, kind="iou", fmt=mode, eps=eps)
