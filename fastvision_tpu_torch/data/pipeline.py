"""Input pipeline: host decode / augment -> fixed-shape batches -> device
(port of fastvision_tpu/data/pipeline.py, serial RGB path).

  - deterministic per-epoch sampling: the order from a numpy Generator
    seeded by (seed, epoch), each sample's augmentation from one seeded by
    (seed, epoch, position), as in the JAX package;
  - fixed-shape batches: images uint8 [B, S, S, 3] NHWC, labels [B, M, 5]
    normalized xywh with class == -1 padding;
  - `prefetch_to_device`: background threads that load the next batches
    and copy them to the card from pinned memory on a side stream;
  - `normalize_images`: uint8 -> float on the device, inside the step.

Not ported yet: the worker pools (``num_workers`` > 1, thread and process
backends), the native letterbox (``use_native``), packed-I420 output
(``emit='i420'``, ``native_jpeg``), multi-host sharding (``host_shard``),
mosaic, and ``ClassificationLoader``.
"""
from __future__ import annotations

import queue
import threading
import warnings
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from .augment import Augmentation
from .dataset import boxes_to_normalized_xywh, letterbox, pad_labels

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


def fetch_with_corrupt_policy(ds, on_corrupt: str, fn, idx: int):
    """Run per-sample work ``fn(index)`` under a corrupt-file policy: 'raise'
    passes errors through; 'skip' substitutes the next dataset index (up to
    8 tries) with a warning. Only decode-class failures (OSError, ValueError)
    are skipped; anything else is a bug and raises."""
    if on_corrupt == "raise":
        return fn(int(idx))
    n = len(ds)
    last: Exception | None = None
    for k in range(min(8, n)):
        j = (int(idx) + k) % n
        try:
            out = fn(j)
            if k:
                warnings.warn(
                    f"skipped {k} corrupt sample(s) starting at dataset index {int(idx)} "
                    f"({last}); substituted index {j}", stacklevel=2)
            return out
        except (OSError, ValueError) as e:
            last = e
    raise RuntimeError(f"{min(8, n)} consecutive corrupt samples from index {int(idx)}") from last


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, item {item})")


class DetectionLoader:
    """Batches of letterboxed images + padded normalized-xywh labels.

    train=True: a seeded shuffle per epoch and the augmentation pipeline;
    the last partial batch is dropped unless ``drop_last=False``.
    train=False: dataset order, letterbox only, the ragged last batch padded
    (the last image repeated, its labels empty) with ``num_real`` telling
    how many are real, and per-image ``meta`` (id, scale, pad, original hw,
    pixel-space GT) for unscaling and mAP. ``input_size`` may be changed
    between epochs (multi-scale training).
    """

    def __init__(
        self,
        dataset,
        input_size: int = 416,
        batch_size: int = 16,
        max_boxes: int = 120,
        train: bool = True,
        augmentation: Augmentation | None = None,
        mosaic_prob: float = 0.0,
        seed: int = 0,
        drop_last: bool | None = None,
        pad_value: int = 114,
        use_native: bool = False,
        num_workers: int = 0,
        emit: str = "rgb",
        native_jpeg: bool | None = None,
        on_corrupt: str = "raise",
        host_shard=None,
    ):
        if mosaic_prob:
            raise _not_ported("mosaic (data/mosaic.py)", 11)
        if use_native:
            raise _not_ported("the native letterbox (use_native)", 11)
        if num_workers > 1:
            raise _not_ported("the loader's worker pools (num_workers > 1)", 11)
        if emit != "rgb" or native_jpeg:
            raise _not_ported("packed-I420 output (emit='i420', native_jpeg)", 1)
        if host_shard not in (None, ""):
            raise _not_ported("multi-host input sharding (host_shard)", 17)
        if on_corrupt not in ("raise", "skip"):
            raise ValueError(f"on_corrupt must be 'raise' or 'skip', got {on_corrupt!r}")
        self.ds = dataset
        self.input_size = input_size
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.train = train
        self.augmentation = augmentation
        self.seed = seed
        self.drop_last = train if drop_last is None else drop_last
        self.pad_value = pad_value
        self.on_corrupt = on_corrupt

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_raw(self, idx: int, rng: np.random.Generator):
        """Decode + augment one sample; labels stay pixel xyxy. ``rng`` is
        the sample's own, seeded from (seed, epoch, position)."""
        image, labels, sid = fetch_with_corrupt_policy(self.ds, self.on_corrupt,
                                                       self.ds.__getitem__, idx)
        if self.train and self.augmentation is not None:
            image, labels = self.augmentation(image, labels, rng)
        return image, labels, sid

    def _finalize(self, labels, scale, px, py):
        """Pixel-xyxy labels + letterbox transform -> padded normalized xywh."""
        if len(labels):
            lab = labels.copy()
            lab[:, 1:5] = lab[:, 1:5] * scale
            lab[:, [1, 3]] += px
            lab[:, [2, 4]] += py
            xywhn = boxes_to_normalized_xywh(lab[:, 1:5], self.input_size, self.input_size)
            return pad_labels(lab[:, 0], xywhn, self.max_boxes)
        return pad_labels(np.zeros(0), np.zeros((0, 4)), self.max_boxes)

    def epoch(self, epoch_idx: int = 0) -> Iterator[dict]:
        """-> batches {'images', 'labels', 'num_real', 'meta'}."""
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(len(self.ds)) if self.train else np.arange(len(self.ds))
        bs = self.batch_size
        for b in range(len(self)):
            raws = [self._load_raw(int(i), np.random.default_rng((self.seed, epoch_idx, pos)))
                    for pos, i in enumerate(order[b * bs : (b + 1) * bs], start=b * bs)]
            real = len(raws)
            while len(raws) < bs:  # ragged last eval batch
                raws.append(raws[-1])
            outs = [letterbox(r[0], self.input_size, self.pad_value) for r in raws]
            labels, metas = [], []
            for i, ((image, lab, sid), (_, scale, (px, py))) in enumerate(zip(raws, outs)):
                if i < real:
                    labels.append(self._finalize(lab, scale, px, py))
                    metas.append({"id": sid, "scale": scale, "pad": (px, py),
                                  "orig_hw": image.shape[:2], "gt_pixels": lab})
                else:
                    labels.append(np.full((self.max_boxes, 5), -1, np.float32))
            yield {
                "images": np.stack([o[0] for o in outs]),
                "labels": np.stack(labels),
                "num_real": real,
                "meta": metas,
            }

    def __iter__(self):
        return self.epoch(0)


def prefetch_to_device(
    iterator: Iterator[dict],
    device: str | torch.device | None = None,
    buffer_size: int = 2,
    device_keys: tuple[str, ...] = ("images", "labels"),
) -> Iterator[dict]:
    """Two-stage background prefetch + device placement.

    A loader thread pulls host batches from ``iterator``; a transfer thread
    moves ``device_keys`` to ``device`` (None: CUDA, raising without a card).
    On CUDA the copy is from pinned memory, ``non_blocking``, on a side
    stream, so loading batch k + 2, copying batch k + 1 and computing on
    batch k overlap; the consumer's stream waits for the copy's event
    before the batch is handed out. Other keys (meta, num_real) pass
    through. An exception in either thread re-raises in the consumer."""
    dev = resolve_device(device)
    q_host: queue.Queue = queue.Queue(maxsize=buffer_size)
    q_dev: queue.Queue = queue.Queue(maxsize=buffer_size)
    sentinel = object()
    stop = threading.Event()  # the consumer is gone: the threads wind down
    errors: list[BaseException] = []
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def enqueue(q: queue.Queue, item) -> bool:
        while True:
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if stop.is_set():
                    return False

    def to_device(batch: dict):
        out = dict(batch)
        if stream is None:
            for k in device_keys:
                if k in batch:
                    out[k] = torch.as_tensor(batch[k]).to(dev)
            return out, None
        with torch.cuda.stream(stream):
            for k in device_keys:
                if k in batch:
                    host = torch.as_tensor(batch[k])
                    out[k] = host.pin_memory().to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def load_worker():
        try:
            for batch in iterator:
                if stop.is_set() or not enqueue(q_host, batch):
                    return
        except BaseException as e:  # surface in the consumer, don't hang it
            errors.append(e)
        finally:
            enqueue(q_host, sentinel)

    def transfer_worker():
        try:
            while True:
                try:
                    item = q_host.get(timeout=0.1)
                except queue.Empty:
                    if stop.is_set():
                        return
                    continue
                if item is sentinel:
                    return
                if stop.is_set() or not enqueue(q_dev, to_device(item)):
                    return
        except BaseException as e:
            errors.append(e)
        finally:
            enqueue(q_dev, sentinel)

    threads = (threading.Thread(target=load_worker, daemon=True),
               threading.Thread(target=transfer_worker, daemon=True))
    for t in threads:
        t.start()
    try:
        while True:
            item = q_dev.get()
            if item is sentinel:
                break
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(event)
                for k in device_keys:  # memory of the side stream, used on this one
                    if k in batch:
                        batch[k].record_stream(current)
            yield batch
        if errors:
            raise errors[0]
    finally:
        stop.set()
        for q in (q_dev, q_host):
            try:  # drain buffered items so the threads unblock promptly
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
