"""Inference preprocessing: letterbox + batch assembly on the host (port of
fastvision_tpu/infer/preprocess.py). The /255 normalize runs on the device
(data.pipeline.normalize_images)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..data.dataset import imread_rgb, imread_rgb_scaled, letterbox


def preprocess_image(image: np.ndarray | str, input_size: int = 416, pad_value: int = 114,
                     fast_decode: bool = False) -> tuple[np.ndarray, dict]:
    """RGB uint8 array (or image path) -> (letterboxed uint8 [S, S, 3], meta)
    with meta = {scale, pad, orig_hw} for unscaling.

    ``fast_decode`` (paths only): a JPEG at least 2x larger than the input
    is decoded reduced (`imread_rgb_scaled`); meta's scale is then a
    per-axis (sx, sy) pair from the ORIGINAL pixels to the letterboxed ones
    (the reduced image rounds h and w apart), so unscaled boxes stay exact."""
    if isinstance(image, str):
        if fast_decode:
            image, orig_hw = imread_rgb_scaled(image, input_size)
        else:
            image = imread_rgb(image)
            orig_hw = image.shape[:2]
    else:
        orig_hw = image.shape[:2]
    rh, rw = image.shape[:2]
    out, scale, pad = letterbox(image, input_size, pad_value)
    if (rh, rw) != tuple(orig_hw):
        nh, nw = round(rh * scale), round(rw * scale)
        scale = (nw / orig_hw[1], nh / orig_hw[0])
    return out, {"scale": scale, "pad": pad, "orig_hw": orig_hw}


def preprocess_batch(images: Sequence[np.ndarray | str], input_size: int = 416,
                     pad_value: int = 114, fast_decode: bool = False
                     ) -> tuple[np.ndarray, list[dict]]:
    """-> (uint8 [B, S, S, 3], metas)."""
    outs, metas = [], []
    for im in images:
        o, m = preprocess_image(im, input_size, pad_value, fast_decode)
        outs.append(o)
        metas.append(m)
    return np.stack(outs), metas
