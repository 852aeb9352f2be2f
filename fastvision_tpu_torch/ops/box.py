"""Box coordinate conversions over ``[..., 4]`` tensors.

Port of fastvision_tpu/ops/box.py; same formulas in the same operation
order, so float32 results agree bit for bit on the CPU.
"""
from __future__ import annotations

import torch


def xywh2xyxy(xywh: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = xywh.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy2xywh(xyxy: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = xyxy.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def xyxy2xywhn(xyxy: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Pixel (x1, y1, x2, y2) -> normalized (cx, cy, w, h) in [0, 1]."""
    xywh = xyxy2xywh(xyxy)
    scale = torch.tensor([width, height, width, height], dtype=xywh.dtype,
                         device=xywh.device)
    return xywh / scale


def xywhn2xyxy(xywhn: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Normalized (cx, cy, w, h) -> pixel (x1, y1, x2, y2). Inverse of xyxy2xywhn."""
    scale = torch.tensor([width, height, width, height], dtype=xywhn.dtype,
                         device=xywhn.device)
    return xywh2xyxy(xywhn * scale)


def clip_boxes(xyxy: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Clip xyxy boxes into [0, width] x [0, height]."""
    x1, y1, x2, y2 = xyxy.unbind(-1)
    return torch.stack([x1.clamp(0, width), y1.clamp(0, height),
                        x2.clamp(0, width), y2.clamp(0, height)], dim=-1)


def box_area(xyxy: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, shape [...]."""
    x1, y1, x2, y2 = xyxy.unbind(-1)
    return (x2 - x1) * (y2 - y1)
