"""Anchor constants (the COCO set of fastvision_tpu/ops/anchors.py)."""
from __future__ import annotations

import numpy as np

# Standard YOLOv3 COCO anchors, input-image pixels at 416, area-ascending.
COCO_ANCHORS = np.array(
    [
        [10, 13], [16, 30], [33, 23],       # P3 / stride 8
        [30, 61], [62, 45], [59, 119],      # P4 / stride 16
        [116, 90], [156, 198], [373, 326],  # P5 / stride 32
    ],
    dtype=np.float32,
)
