"""Inference preprocessing: letterbox + batch assembly on the host (port of
fastvision_tpu/infer/preprocess.py; the reduced-JPEG ``fast_decode`` path
is not ported yet). The /255 normalize runs on the device
(data.pipeline.normalize_images)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..data.dataset import imread_rgb, letterbox


def preprocess_image(image: np.ndarray | str, input_size: int = 416,
                     pad_value: int = 114) -> tuple[np.ndarray, dict]:
    """RGB uint8 array (or image path) -> (letterboxed uint8 [S, S, 3], meta)
    with meta = {scale, pad, orig_hw} for unscaling."""
    if isinstance(image, str):
        image = imread_rgb(image)
    orig_hw = image.shape[:2]
    out, scale, pad = letterbox(image, input_size, pad_value)
    return out, {"scale": scale, "pad": pad, "orig_hw": orig_hw}


def preprocess_batch(images: Sequence[np.ndarray | str], input_size: int = 416,
                     pad_value: int = 114) -> tuple[np.ndarray, list[dict]]:
    """-> (uint8 [B, S, S, 3], metas)."""
    outs, metas = [], []
    for im in images:
        o, m = preprocess_image(im, input_size, pad_value)
        outs.append(o)
        metas.append(m)
    return np.stack(outs), metas
