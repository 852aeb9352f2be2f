"""Host image reading and letterbox (port of fastvision_tpu/data/dataset.py's
``imread_rgb`` and ``letterbox``).

The resize is ``torch.nn.functional.interpolate(mode='bilinear',
align_corners=False, antialias=False)`` on host tensors, rounded back to
uint8: the same sampling as cv2's ``INTER_LINEAR``, within +-1 per pixel
(cv2 rounds with fixed-point weights). cv2 is used only to decode files,
where it is installed.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def imread_rgb(path: str) -> np.ndarray:
    """Decode an image file -> RGB uint8 HWC. Needs cv2 (ImportError without
    it); callers with arrays need nothing."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot decode image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def resize_bilinear(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """HWC array -> (height, width), bilinear with half-pixel centres."""
    t = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float()
    out = F.interpolate(t, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=False)[0].permute(1, 2, 0)
    if image.dtype == np.uint8:
        return out.round().clamp(0, 255).to(torch.uint8).numpy()
    return out.numpy().astype(image.dtype)


def letterbox(image: np.ndarray, size: int, pad_value: int = 114,
              position: str = "center") -> tuple[np.ndarray, float, tuple[int, int]]:
    """Aspect-preserving resize + pad to (size, size).
    Returns (image, scale, (pad_left, pad_top))."""
    h, w = image.shape[:2]
    scale = size / max(h, w)
    nh, nw = round(h * scale), round(w * scale)
    if (nh, nw) != (h, w):
        image = resize_bilinear(image, nh, nw)
    if position == "center":
        top = (size - nh) // 2
        left = (size - nw) // 2
    else:  # 'lefttop'
        top, left = 0, 0
    out = np.full((size, size, image.shape[2]), pad_value, image.dtype)
    out[top : top + nh, left : left + nw] = image
    return out, scale, (left, top)
