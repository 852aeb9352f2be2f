"""Box delta encoding/decoding for two-stage detectors (port of
fastvision_tpu/ops/box_coder.py).

Standard (dx, dy, dw, dh) parameterization between reference boxes
(anchors / proposals) and targets, with per-coordinate normalization
weights; the Fast head's targets use std (0.1, 0.1, 0.2, 0.2). Same
formulas in the same operation order as the JAX package.
"""
from __future__ import annotations

import torch

_EPS = 1e-7


def _centre_size(xyxy: torch.Tensor):
    cx = (xyxy[..., 0] + xyxy[..., 2]) / 2
    cy = (xyxy[..., 1] + xyxy[..., 3]) / 2
    w = (xyxy[..., 2] - xyxy[..., 0]).clamp(min=_EPS)
    h = (xyxy[..., 3] - xyxy[..., 1]).clamp(min=_EPS)
    return cx, cy, w, h


def encode_boxes(reference_xyxy: torch.Tensor, target_xyxy: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """xyxy reference + target -> normalized deltas [..., 4]."""
    rx, ry, rw, rh = _centre_size(reference_xyxy)
    tx, ty, tw, th = _centre_size(target_xyxy)
    wx, wy, ww, wh = weights
    return torch.stack([(tx - rx) / rw / wx, (ty - ry) / rh / wy,
                        torch.log(tw / rw) / ww, torch.log(th / rh) / wh], dim=-1)


def decode_boxes(reference_xyxy: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0), clip_exp: float = 4.0,
                 wh_from_dw: bool = False) -> torch.Tensor:
    """Deltas back to xyxy, exp clamped to [-clip_exp, clip_exp].

    ``wh_from_dw=True`` decodes h from the dw channel too, as the reference
    demo does (its checkpoints never learn a usable dh); imported reference
    checkpoints need it, the port's own training uses the 4-channel decode."""
    rx, ry, rw, rh = _centre_size(reference_xyxy)
    wx, wy, ww, wh = weights
    cx = deltas[..., 0] * wx * rw + rx
    cy = deltas[..., 1] * wy * rh + ry
    dh = deltas[..., 2] * ww if wh_from_dw else deltas[..., 3] * wh
    w = torch.exp((deltas[..., 2] * ww).clamp(-clip_exp, clip_exp)) * rw
    h = torch.exp(dh.clamp(-clip_exp, clip_exp)) * rh
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
