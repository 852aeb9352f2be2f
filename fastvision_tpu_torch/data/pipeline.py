"""On-device image normalization (port of
fastvision_tpu/data/pipeline.py::normalize_images, RGB input only; the
packed-I420 branch is not ported yet)."""
from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_images(images: torch.Tensor, dtype=torch.float32,
                     imagenet: bool = False) -> torch.Tensor:
    """uint8 (or float pixel) NHWC [B, H, W, 3] -> ``dtype`` in [0, 1],
    optionally imagenet-standardized. Casts first, then divides in
    ``dtype``, as the JAX package does."""
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(
            f"normalize_images expects RGB NHWC [B, H, W, 3], got {tuple(images.shape)}")
    x = images.to(dtype) / 255.0
    if imagenet:
        mean = torch.as_tensor(IMAGENET_MEAN).to(x.device, dtype)
        std = torch.as_tensor(IMAGENET_STD).to(x.device, dtype)
        x = (x - mean) / std
    return x
