"""4-image mosaic augmentation (port of fastvision_tpu/data/mosaic.py).

Composites four (image, labels) samples around a random centre of a
(2 size, 2 size) canvas, shifts and clips the labels in pixel xyxy, and
resizes the canvas to (size, size). The generator calls are the JAX
package's, in the same order; the resizes are `dataset.resize_bilinear`
(torch bilinear, cv2's ``INTER_LINEAR`` within +-1 per pixel), as in the
letterbox.
"""
from __future__ import annotations

import numpy as np

from .dataset import resize_bilinear


def mosaic4(
    samples: list[tuple[np.ndarray, np.ndarray]],
    size: int,
    rng: np.random.Generator,
    pad_value: int = 114,
    center_range: tuple[float, float] = (0.5, 1.5),
) -> tuple[np.ndarray, np.ndarray]:
    """samples: four (rgb uint8, [N, 5] cls + xyxy) pairs -> (canvas
    [size, size, 3], labels [M, 5]); boxes narrower or shorter than 2 px on
    the 2x canvas are dropped."""
    if len(samples) != 4:
        raise ValueError(f"mosaic4 takes 4 samples, got {len(samples)}")
    s2 = size * 2
    canvas = np.full((s2, s2, 3), pad_value, np.uint8)
    cx = int(rng.uniform(*center_range) * size)
    cy = int(rng.uniform(*center_range) * size)
    all_labels = []
    for i, (img, labels) in enumerate(samples):
        h, w = img.shape[:2]
        scale = size / max(h, w)
        img = resize_bilinear(img, round(h * scale), round(w * scale))
        h, w = img.shape[:2]
        if i == 0:  # top-left of the centre
            x1, y1, x2, y2 = max(cx - w, 0), max(cy - h, 0), cx, cy
        elif i == 1:  # top-right
            x1, y1, x2, y2 = cx, max(cy - h, 0), min(cx + w, s2), cy
        elif i == 2:  # bottom-left
            x1, y1, x2, y2 = max(cx - w, 0), cy, cx, min(cy + h, s2)
        else:  # bottom-right
            x1, y1, x2, y2 = cx, cy, min(cx + w, s2), min(cy + h, s2)
        cw, ch = x2 - x1, y2 - y1
        if cw <= 0 or ch <= 0:
            continue
        # the source window anchored at the corner that touches the centre
        sx = w - cw if i in (0, 2) else 0
        sy = h - ch if i in (0, 1) else 0
        canvas[y1:y2, x1:x2] = img[sy : sy + ch, sx : sx + cw]
        if labels is not None and len(labels):
            lab = labels.copy().astype(np.float32)
            lab[:, 1:5] *= scale
            lab[:, [1, 3]] += x1 - sx
            lab[:, [2, 4]] += y1 - sy
            all_labels.append(lab)

    if all_labels:
        labels = np.concatenate(all_labels, axis=0)
        labels[:, [1, 3]] = np.clip(labels[:, [1, 3]], 0, s2)
        labels[:, [2, 4]] = np.clip(labels[:, [2, 4]], 0, s2)
        keep = (labels[:, 3] - labels[:, 1] > 2) & (labels[:, 4] - labels[:, 2] > 2)
        labels = labels[keep]
    else:
        labels = np.zeros((0, 5), np.float32)

    canvas = resize_bilinear(canvas, size, size)
    labels[:, 1:5] /= 2.0
    return canvas, labels
