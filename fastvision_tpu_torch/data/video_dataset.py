"""Video recognition data (port of fastvision_tpu/data/video_dataset.py).

  - `VideoFolderDataset`: ``<root>/<split>/<class_name>/<clip>``, each clip
    a video file (Motion-JPEG .avi and MPEG-4 Part 2 .avi / .mp4 / .mov read
    without cv2, other videos with cv2; `avi.open_video`) or a directory of
    frame images (JPEG, PNG or BMP, read by `dataset.imread_rgb`); classes
    sorted, or pinned by ``categories``;
  - `VideoClipLoader`: batches {'images' uint8 [B, T, S, S, 3], 'labels'
    int32 [B], 'num_real'} on the worker pools of `pipeline._PooledLoader`.
    Each clip's frame draws come from a numpy Generator seeded by (seed,
    epoch, position), so pooled epochs are byte-equal to serial ones and
    an epoch can start at any batch (``epoch(start_batch=...)``, which
    `train.Fit` resumes with; the JAX package's loader has no such start).

Frames are resized to S x S with `resize_bilinear` (within +-1 of the JAX
package's cv2 resize). Normalization runs on the device inside the step
(`normalize_images` takes NDHWC clips).
"""
from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np

from .dataset import IMG_EXTS, imread_rgb, resize_bilinear
from .pipeline import _PooledLoader, fetch_with_corrupt_policy, resolve_host_shard
from .avi import open_video
from .video_sampler import VIDEO_EXTS, load_clip, sample_indices


class VideoFolderDataset:
    """Folder-per-class clips: video files or frame directories.
    ``categories`` pins the class-index mapping; default is the split's
    sorted folder names. A folder not in ``categories`` raises."""

    def __init__(self, root: str, split: str = "train",
                 categories: Sequence[str] | None = None):
        self.dir = os.path.join(root, split)
        found = sorted(d for d in os.listdir(self.dir) if os.path.isdir(os.path.join(self.dir, d)))
        self.classes = list(categories) if categories else found
        index = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[tuple[str, int]] = []
        for c in found:
            if c not in index:
                raise ValueError(f"split folder {c!r} not in categories {self.classes}")
            cdir = os.path.join(self.dir, c)
            for f in sorted(os.listdir(cdir)):
                p = os.path.join(cdir, f)
                if f.lower().endswith(VIDEO_EXTS) or os.path.isdir(p):
                    self.samples.append((p, index[c]))
        if not self.samples:
            raise ValueError(f"no clips found under {self.dir}")

    def __len__(self) -> int:
        return len(self.samples)

    @staticmethod
    def _frames(path: str) -> list[str]:
        return sorted(f for f in os.listdir(path) if f.lower().endswith(IMG_EXTS))

    def clip_length(self, idx: int) -> int:
        """Frames of clip ``idx``: a frame directory's image count, or a
        video header's frame count (reads clamp to the real one)."""
        path, _ = self.samples[idx]
        if os.path.isdir(path):
            return len(self._frames(path))
        video = open_video(path)
        n = video.frame_count
        video.release()
        return n

    def load_clip(self, idx: int, num_frames: int, strategy: str, size: int,
                  rng: np.random.Generator,
                  indices: np.ndarray | None = None) -> tuple[np.ndarray, int]:
        """-> ([T, size, size, 3] uint8 RGB clip, class index). ``indices``
        overrides the sampling strategy with explicit frame positions
        (clamped to the clip). A frame that does not decode raises
        ValueError: a corrupt clip is never returned black."""
        path, label = self.samples[idx]
        if not os.path.isdir(path):
            return load_clip(path, num_frames, strategy, size, rng, indices=indices), label
        frames = self._frames(path)
        if not frames:
            raise ValueError(f"frame directory has no images: {path}")
        take = (np.clip(indices, 0, len(frames) - 1) if indices is not None
                else sample_indices(len(frames), num_frames, strategy, rng))
        clip = np.empty((len(take), size, size, 3), np.uint8)
        for k, i in enumerate(take):
            fp = os.path.join(path, frames[int(i)])
            try:
                image = imread_rgb(fp)
            except (OSError, ValueError) as e:
                raise ValueError(f"cannot decode frame: {fp}") from e
            clip[k] = resize_bilinear(image, size, size)
        return clip, label


class VideoClipLoader(_PooledLoader):
    """Fixed-shape clip batches for training and evaluation.

    train=True: a seeded shuffle per epoch, each clip's frames drawn by
    ``strategy`` from a Generator seeded by (seed, epoch, position), the
    last partial batch dropped. train=False: dataset order, the ragged last
    batch padded with its last clip and label, ``num_real`` its real count.
    ``num_workers`` / ``worker_backend``: the worker pools of
    `_PooledLoader`; ``on_corrupt='skip'`` substitutes the next clip.
    ``host_shard``: this host's strided share of every epoch
    (`pipeline.resolve_host_shard`); ``batch_size`` stays per host."""

    def __init__(self, dataset: VideoFolderDataset, num_frames: int = 16, size: int = 112,
                 batch_size: int = 8, strategy: str = "average", train: bool = True,
                 seed: int = 0, num_workers: int = 0, worker_backend: str = "thread",
                 on_corrupt: str = "raise", host_shard=None):
        if on_corrupt not in ("raise", "skip"):
            raise ValueError(f"on_corrupt must be 'raise' or 'skip', got {on_corrupt!r}")
        resolve_host_shard(host_shard)
        self.host_shard = host_shard
        self.ds = dataset
        self.num_frames = num_frames
        self.size = size
        self.batch_size = batch_size
        self.strategy = strategy
        self.train = train
        self.seed = seed
        self.on_corrupt = on_corrupt
        self._init_workers(num_workers, worker_backend)

    def __len__(self) -> int:
        n = self._local_len()
        return n // self.batch_size if self.train else -(-n // self.batch_size)

    def _slot_shape(self) -> tuple[int, int, int, int]:
        return (self.num_frames, self.size, self.size, 3)

    def _sample_work(self, item):
        """(position, dataset index, epoch[, frame indices]) -> (uint8
        [T, S, S, 3], label); explicit frame indices take the place of the
        strategy's draws (`windows`)."""
        pos, idx, epoch_idx, *frames = item
        rng = np.random.default_rng((self.seed, epoch_idx, pos))
        indices = frames[0] if frames else None
        return fetch_with_corrupt_policy(
            self.ds, self.on_corrupt,
            lambda j: self.ds.load_clip(j, self.num_frames, self.strategy, self.size, rng,
                                        indices=indices), idx)

    def epoch(self, epoch_idx: int = 0, start_batch: int = 0) -> Iterator[dict]:
        """-> batches {'images', 'labels', 'num_real'}, from batch
        ``start_batch`` of the epoch on (the earlier ones are not loaded)."""
        return ({"images": clips,
                 "labels": np.asarray(labels + labels[-1:] * (self.batch_size - real), np.int32),
                 "num_real": real}
                for clips, labels, real in self._batched(epoch_idx, start_batch))

    def windows(self, jobs: Sequence[tuple[int, np.ndarray]]) -> Iterator[tuple[np.ndarray, int]]:
        """(clip uint8 [T, S, S, 3], label) for each (dataset index, frame
        indices) job, in order, on the loader's workers (the multi-clip
        evaluation's reads). The process backend's clips are views of a
        ring slot, valid until the next one is taken."""
        return self._samples([(pos, int(idx), 0, np.asarray(frames))
                              for pos, (idx, frames) in enumerate(jobs)])

    def __iter__(self):
        return self.epoch(0)
