"""Video frame samplers (port of fastvision_tpu/data/video_sampler.py).

Strategies over a clip of ``total`` frames: consecutive, random, average
stride and random-within-clips (`sample_indices`, draw for draw the JAX
package's for the same ``np.random.Generator``); `sample_clip_from_array`
over pre-decoded frames; `load_clip` and `count_real_frames` over a video
file. Video files are decoded with cv2, imported where it is called: where
cv2 is not installed they raise, naming ROADMAP Queue 1 item 11 (the decode
without cv2), and never return a black clip. Frames are resized with the
loaders' `resize_bilinear` (within +-1 of cv2's resize per pixel).
"""
from __future__ import annotations

import numpy as np

from .dataset import resize_bilinear

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def import_cv2():
    """cv2, or NotImplementedError naming the decode without it."""
    try:
        import cv2
    except ImportError as e:
        raise NotImplementedError(
            "decoding video files (.mp4, .avi, ...) without cv2 is not ported yet (ROADMAP "
            "Queue 1, item 11); use clips stored as directories of .bmp frames") from e
    return cv2


def count_real_frames(path: str) -> int:
    """The frame count, walking the container when its header is wrong."""
    cv2 = import_cv2()
    cap = cv2.VideoCapture(path)
    header = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.set(cv2.CAP_PROP_POS_FRAMES, max(header - 1, 0))  # verify by seeking to the end
    ok, _ = cap.read()
    if ok:
        cap.release()
        return header
    cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def sample_indices(total: int, num_frames: int, strategy: str = "consecutive",
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Frame indices [num_frames] for a clip, clamped into [0, total)."""
    rng = rng or np.random.default_rng()
    if total <= 0:
        return np.zeros(num_frames, np.int64)
    if strategy == "consecutive":
        start = int(rng.integers(0, max(total - num_frames, 0) + 1))
        idx = np.arange(start, start + num_frames)
    elif strategy == "random":
        idx = np.sort(rng.choice(total, size=min(num_frames, total), replace=total < num_frames))
        if len(idx) < num_frames:
            idx = np.resize(idx, num_frames)
    elif strategy == "average":
        stride = max(total // num_frames, 1)
        start = int(rng.integers(0, max(total - stride * num_frames, 0) + 1))
        idx = start + np.arange(num_frames) * stride
    elif strategy == "clip_random":  # num_frames segments, one frame from each
        bounds = np.linspace(0, total, num_frames + 1)
        idx = np.array([int(rng.integers(int(bounds[i]),
                                         max(int(bounds[i + 1]), int(bounds[i]) + 1)))
                        for i in range(num_frames)])
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return np.clip(idx, 0, total - 1).astype(np.int64)


def load_clip(path: str, num_frames: int = 16, strategy: str = "consecutive",
              size: int | None = None, rng: np.random.Generator | None = None,
              verify_frames: bool = False, indices: np.ndarray | None = None) -> np.ndarray:
    """Decode a [T, H, W, 3] RGB uint8 clip from a video file (cv2).
    ``indices`` overrides ``strategy`` with explicit frame positions
    (clamped to the frame count). A frame past the real end repeats the
    last good one (headers over-count); a file of which no frame decodes
    raises ValueError."""
    cv2 = import_cv2()
    total = count_real_frames(path) if verify_frames else None
    cap = cv2.VideoCapture(path)
    if total is None:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        cap.release()
        raise ValueError(f"cannot decode video (no frames): {path}")
    idx = (np.clip(indices, 0, total - 1) if indices is not None
           else sample_indices(total, num_frames, strategy, rng))
    frames, last = [], None
    for i in np.sort(idx):
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, frame = cap.read()
        if not ok:
            if last is None:
                cap.release()
                raise ValueError(f"cannot decode video: {path}")
            frame = last
        else:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if size is not None:
                frame = resize_bilinear(frame, size, size)
        frames.append(frame)
        last = frame
    cap.release()
    return np.stack(frames, axis=0)


def sample_clip_from_array(frames: np.ndarray, num_frames: int = 16,
                           strategy: str = "consecutive",
                           rng: np.random.Generator | None = None) -> np.ndarray:
    """Sampler over pre-decoded frames [T, H, W, C]."""
    return frames[sample_indices(frames.shape[0], num_frames, strategy, rng)]
