"""Anchors: the COCO set, and anchor generation by IoU-distance k-means over
a dataset's box shapes (port of fastvision_tpu/ops/anchors.py, numpy on
the host as there: a one-off statistics pass, not a hot op).

`kmeans_anchors` gives the JAX package's centers and assignment for the
same boxes and seed (the same numpy Generator draws, in the same order);
`AnchorGenerator` scans datasets of (image, labels) pairs and keeps its
anchors in a JSON cache.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

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


def _wh_iou_matrix_np(wh1: np.ndarray, wh2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """IoU of boxes that share a corner: [N, 2] x [M, 2] widths and heights
    -> [N, M]."""
    inter = np.minimum(wh1[:, None, 0], wh2[None, :, 0]) * np.minimum(
        wh1[:, None, 1], wh2[None, :, 1])
    union = wh1[:, 0:1] * wh1[:, 1:2] + (wh2[:, 0] * wh2[:, 1])[None, :] - inter + eps
    return inter / union


def _kmeanspp_init(wh: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding under the (1 - wh-IoU) metric: each next center is
    drawn with probability proportional to its squared distance from the
    nearest center chosen."""
    centers = np.empty((k, 2), np.float64)
    centers[0] = wh[rng.integers(wh.shape[0])]
    d2 = (1.0 - _wh_iou_matrix_np(wh, centers[:1])[:, 0]) ** 2
    for i in range(1, k):
        p = d2 / max(d2.sum(), 1e-12)
        centers[i] = wh[rng.choice(wh.shape[0], p=p)]
        d_new = (1.0 - _wh_iou_matrix_np(wh, centers[i:i + 1])[:, 0]) ** 2
        d2 = np.minimum(d2, d_new)
    return centers


def kmeans_anchors(wh: np.ndarray, k: int = 9, iters: int = 100, seed: int = 0,
                   init: str = "random") -> tuple[np.ndarray, np.ndarray]:
    """K-means with the (1 - wh-IoU) distance over box sizes ``wh`` [N, 2]
    (any consistent unit). ``init``: 'random' (k boxes drawn uniformly) or
    '++' (k-means++ seeding). -> (centers [k, 2] float64 sorted by area
    ascending, assignment [N] in [0, k))."""
    wh = np.asarray(wh, np.float64).reshape(-1, 2)
    if wh.shape[0] < k:
        raise ValueError(f"need at least k={k} boxes, got {wh.shape[0]}")
    rng = np.random.default_rng(seed)
    if init == "++":
        centers = _kmeanspp_init(wh, k, rng)
    elif init == "random":
        centers = wh[rng.permutation(wh.shape[0])[:k]].copy()
    else:
        raise ValueError(f"init must be 'random' or '++', got {init!r}")
    assign = np.zeros(wh.shape[0], np.int64)
    for _ in range(iters):
        assign = np.argmin(1.0 - _wh_iou_matrix_np(wh, centers), axis=1)
        for ci in range(k):
            members = wh[assign == ci]
            if members.shape[0]:
                centers[ci] = members.mean(axis=0)
    order = np.argsort(centers[:, 0] * centers[:, 1])  # area ascending
    remap = np.empty(k, np.int64)
    remap[order] = np.arange(k)
    return centers[order], remap[assign]


class AnchorGenerator:
    """Dataset scan + `kmeans_anchors` + a JSON cache (``<cache_dir>/
    anchors.json``, read back with ``use_cache``).

    ``datasets``: iterables of (image, labels) pairs or of label arrays,
    label rows [class, x1, y1, x2, y2] in pixels; or pass the sizes
    directly to `get_anchors(wh=...)`."""

    def __init__(self, datasets: Sequence | None = None, k: int = 9, iters: int = 100,
                 cache_dir: str = "./cache", use_cache: bool = False, seed: int = 0,
                 init: str = "random"):
        self.datasets = datasets or []
        self.k = k
        self.iters = iters
        self.cache_path = os.path.join(cache_dir, "anchors.json")
        self.use_cache = use_cache
        self.seed = seed
        self.init = init

    def _scan_wh(self) -> np.ndarray:
        """Every labelled box's (width, height) [N, 2] float32."""
        whs = []
        for ds in self.datasets:
            for item in ds:
                labels = item[1] if isinstance(item, (tuple, list)) else item
                labels = np.asarray(labels, np.float32).reshape(-1, 5)
                whs.append(labels[:, 3:5] - labels[:, 1:3])
        return np.concatenate(whs, axis=0) if whs else np.zeros((0, 2), np.float32)

    def get_anchors(self, wh: np.ndarray | None = None) -> np.ndarray:
        """-> anchors [k, 2] float32, area-ascending (from the cache with
        ``use_cache`` where it exists; written to it otherwise)."""
        if self.use_cache and os.path.exists(self.cache_path):
            with open(self.cache_path) as f:
                return np.asarray(json.load(f), np.float32).reshape(-1, 2)
        if wh is None:
            wh = self._scan_wh()
        centers, _ = kmeans_anchors(wh, k=self.k, iters=self.iters, seed=self.seed,
                                    init=self.init)
        centers = centers.astype(np.float32)
        os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)
        with open(self.cache_path, "w") as f:
            json.dump(centers.tolist(), f)
        return centers
