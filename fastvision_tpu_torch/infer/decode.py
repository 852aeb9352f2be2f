"""YOLO head decoding: raw per-level heads -> image-space boxes (port of
fastvision_tpu/infer/decode.py).

  - v5: xy = (2 * sig(t) - 0.5 + grid) * stride, wh = (2 * sig(t))^2 * anchor
  - v3: xy = (sig(t) + grid) * stride,           wh = exp(t) * anchor

Anchors are input-image pixels, [L, A, 2], level order matching the heads
(deepest first). Decode runs in the heads' dtype. Rows come out in
(h, w, a) order, as in JAX: NMS tie order depends on it.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops.grid import grid


def decode_level(head: torch.Tensor, anchors, stride: int, style: str = "v5") -> torch.Tensor:
    """One level [B, H, W, A, 5+C] raw logits -> [B, H*W*A, 5+C] with xywh
    pixels and sigmoided obj/cls scores."""
    b, h, w, a, no = head.shape
    offsets = grid(h, w, mode="xy", dtype=head.dtype, device=head.device)[None, :, :, None, :]
    anchors = torch.as_tensor(anchors).to(head.device, head.dtype).reshape(1, 1, 1, a, 2)

    if style == "v5":
        sig = torch.sigmoid(head)
        xy = (sig[..., 0:2] * 2.0 - 0.5 + offsets) * stride
        wh = (sig[..., 2:4] * 2.0) ** 2 * anchors
        rest = sig[..., 4:]
    elif style == "v3":
        xy = (torch.sigmoid(head[..., 0:2]) + offsets) * stride
        wh = torch.exp(head[..., 2:4]) * anchors
        rest = torch.sigmoid(head[..., 4:])
    else:
        raise ValueError("style must be 'v5' or 'v3'")

    return torch.cat([xy, wh, rest], dim=-1).reshape(b, h * w * a, no)


def decode_predictions(heads: Sequence[torch.Tensor], anchors, strides: Sequence[int] = (32, 16, 8),
                       style: str = "v5") -> torch.Tensor:
    """All levels -> [B, sum(H*W*A), 5+C]; feed to
    ops.nms.batched_non_max_suppression (box_format='xywh')."""
    return torch.cat(
        [decode_level(h, anchors[i], strides[i], style) for i, h in enumerate(heads)], dim=1)
