"""Box drawing (port of fastvision_tpu/viz/draw.py).

Rectangle + label with the label above the box (inside it when clipped at
the top) and a per-class colour palette, drawn with cv2 where it is
installed. Without cv2 the boxes are drawn with numpy and the labels are
left out (cv2 renders the text).
"""
from __future__ import annotations

import numpy as np

# 20-colour palette, per class index
_PALETTE = [
    (255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29),
    (207, 210, 49), (72, 249, 10), (146, 204, 23), (61, 219, 134),
    (26, 147, 52), (0, 212, 187), (44, 153, 168), (0, 194, 255),
    (52, 69, 147), (100, 115, 255), (0, 24, 236), (132, 56, 255),
    (82, 0, 133), (203, 56, 255), (255, 149, 200), (255, 55, 199),
]


def get_color(class_idx: int) -> tuple[int, int, int]:
    return _PALETTE[int(class_idx) % len(_PALETTE)]


def _rectangle_np(image: np.ndarray, x1: int, y1: int, x2: int, y2: int, color,
                  thickness: int) -> None:
    """A ``thickness``-pixel outline centred on the box's edges (cv2
    draws thick lines with rounded joins; this one is square)."""
    h, w = image.shape[:2]
    a, b = thickness // 2, (thickness + 1) // 2
    for ys, xs in ((slice(y1 - a, y1 + b), slice(x1 - a, x2 + b)),
                   (slice(y2 - a, y2 + b), slice(x1 - a, x2 + b)),
                   (slice(y1 - a, y2 + b), slice(x1 - a, x1 + b)),
                   (slice(y1 - a, y2 + b), slice(x2 - a, x2 + b))):
        ys = slice(min(max(ys.start, 0), h), min(max(ys.stop, 0), h))
        xs = slice(min(max(xs.start, 0), w), min(max(xs.stop, 0), w))
        image[ys, xs] = color


def draw_box_label(
    image: np.ndarray,
    box_xyxy,
    label: str = "",
    color: tuple[int, int, int] | None = None,
    class_idx: int = 0,
    thickness: int = 2,
) -> np.ndarray:
    """Draw one box + label onto an RGB uint8 image (in place) and return it."""
    color = color or get_color(class_idx)
    x1, y1, x2, y2 = (int(v) for v in np.asarray(box_xyxy).reshape(4))
    try:
        import cv2
    except ImportError:
        _rectangle_np(image, x1, y1, x2, y2, color, thickness)
        return image
    cv2.rectangle(image, (x1, y1), (x2, y2), color, thickness)
    if label:
        font = cv2.FONT_HERSHEY_SIMPLEX
        fs = max(min(image.shape[:2]) / 1200, 0.4)
        (tw, th), baseline = cv2.getTextSize(label, font, fs, 1)
        ty1 = y1 - th - baseline
        if ty1 < 0:  # clipped at the top: draw inside
            ty1, y_text = y1, y1 + th + baseline
        else:
            y_text = y1 - baseline
        cv2.rectangle(image, (x1, ty1), (x1 + tw, ty1 + th + baseline), color, -1)
        cv2.putText(image, label, (x1, y_text), font, fs, (255, 255, 255), 1, cv2.LINE_AA)
    return image


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    class_names: list[str] | None = None,
) -> np.ndarray:
    """Draw a detection result onto a copy of the image."""
    out = np.ascontiguousarray(image).copy()
    for box, score, cls in zip(boxes, scores, classes):
        name = class_names[int(cls)] if class_names else str(int(cls))
        draw_box_label(out, box, f"{name} {float(score):.2f}", class_idx=int(cls))
    return out
