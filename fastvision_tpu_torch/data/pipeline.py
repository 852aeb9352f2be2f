"""Input pipeline: host decode / augment -> fixed-shape batches -> device
(port of fastvision_tpu/data/pipeline.py).

  - deterministic per-epoch sampling: the order from a numpy Generator
    seeded by (seed, epoch), each sample's mosaic and augmentation from one
    seeded by (seed, epoch, position), as in the JAX package, so an epoch
    can start at any batch (``epoch(start_batch=...)``) and give the
    batches it would have given, on any worker backend;
  - worker pools (``num_workers`` > 1): a thread pool per batch, or forked
    processes writing into shared memory (`decode_pool.DecodePool`);
  - fixed-shape batches: `DetectionLoader` gives images uint8 [B, S, S, 3]
    NHWC, or with ``emit='i420'`` packed YUV 4:2:0 [B, S*3/2, S] (half the
    bytes to the card), and labels [B, M, 5] normalized xywh with class == -1
    padding, `ClassificationLoader` images and int32 labels [B];
  - `prefetch_to_device`: background threads that load the next batches
    and copy them to the card from pinned memory on a side stream;
  - `normalize_images`: uint8 -> float on the device, inside the step (a
    packed I420 batch is colour-decoded there first);
  - multi-host input sharding (``host_shard``, `resolve_host_shard`): each
    rank's loader decodes a disjoint strided 1/P of every epoch, each
    sample seeded by its position in the single-process epoch.
"""
from __future__ import annotations

import queue
import sys
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from ..core.telemetry import span
from ..device import resolve_device
from ..ops.image import i420_packed_to_rgb, rgb_batch_to_i420_packed
from .augment import Augmentation, uint8_only
from .codec import letterbox_batch_native
from .dataset import boxes_to_normalized_xywh, letterbox, pad_labels, resize_bilinear
from .decode_pool import DecodePool
from .mosaic import mosaic4

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_images(images: torch.Tensor, dtype=torch.float32,
                     imagenet: bool = False) -> torch.Tensor:
    """uint8 (or float pixel) NHWC images [B, H, W, 3] or NDHWC clips
    [B, T, H, W, 3] -> ``dtype`` in [0, 1], optionally imagenet-standardized
    over the last axis. Casts first, then divides in ``dtype``, as the JAX
    package does. A rank-3 input is a packed I420 batch [B, S*3/2, S]
    (``DetectionLoader(emit='i420')``), colour-decoded first
    (`ops.image.i420_packed_to_rgb`, in ``dtype``)."""
    if images.ndim == 3:
        if images.shape[-1] == 3:
            raise ValueError(
                f"normalize_images got a single unbatched RGB image {tuple(images.shape)}; "
                "add a batch dimension (images[None]): it takes NHWC [B, H, W, 3], NDHWC "
                "[B, T, H, W, 3] and packed I420 [B, S*3/2, S]")
        images = i420_packed_to_rgb(images, dtype)
    elif images.ndim not in (4, 5) or images.shape[-1] != 3:
        raise ValueError("normalize_images expects RGB NHWC [B, H, W, 3] or NDHWC "
                         f"[B, T, H, W, 3], got {tuple(images.shape)}")
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


def resolve_host_shard(host_shard) -> tuple[int, int]:
    """A loader's ``host_shard`` spec -> ``(index, count)``:

    - ``None`` / ``""``: no sharding, ``(0, 1)``;
    - ``'auto'``: ``(data index, data axis size)`` of the mesh over the
      process group (`core.distributed.axis`; without a mesh the data axis
      is the world), ``(0, 1)`` without a group: the ranks of one data index
      (the model and time axes) read the same share. Loaders resolve it
      when an epoch starts, not when they are built, so a loader built
      before the group forms still shards;
    - ``'i/n'`` or ``(i, n)``: explicit."""
    if host_shard is None or host_shard == "":
        return 0, 1
    if host_shard == "auto":
        from ..core.distributed import axis

        data = axis("data")
        return data.index, data.size
    if isinstance(host_shard, str):
        try:
            index, count = (int(p) for p in host_shard.split("/"))
        except ValueError:
            raise ValueError(
                f"host_shard string must be 'auto' or 'i/n', got {host_shard!r}") from None
    else:
        index, count = (int(p) for p in host_shard)
    if count < 1 or not 0 <= index < count:
        raise ValueError(f"host_shard index {index} not in [0, {count})")
    return index, count


def host_shard_order(order: np.ndarray, index: int, count: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """-> ``(local_order, global_positions)``: host ``index``'s strided slice
    of a global epoch order; the remainder ``len(order) % count`` is dropped
    so every host yields as many batches (the collectives' lockstep).
    ``global_positions[p]`` is local sample ``p``'s position in the
    single-host epoch, which seeds its random draws, so the union of the
    hosts' samples is byte-equal to the single-host epoch's."""
    if count == 1:
        return order, np.arange(len(order))
    n = len(order) - len(order) % count
    gpos = np.arange(index, n, count)
    return order[gpos], gpos


def _host_local_len(n: int, count: int) -> int:
    """Per-host dataset length under host sharding (remainder dropped)."""
    return n if count == 1 else (n - n % count) // count


def parse_worker_backend(worker_backend: str) -> tuple[str, str]:
    """'thread' | 'process' | 'process:fork|forkserver|spawn' -> (backend,
    start method). A bare 'process' forks: the port never imports JAX, whose
    client threads made the JAX package prefer forkserver."""
    backend, _, start = worker_backend.partition(":")
    if backend not in ("thread", "process") or (
            start and (backend != "process" or start not in ("fork", "forkserver", "spawn"))):
        raise ValueError("worker_backend must be 'thread', 'process', or "
                         f"'process:fork|forkserver|spawn', got {worker_backend!r}")
    return backend, start or "fork"


class _PooledLoader:
    """The worker pools the loaders share. ``num_workers`` 0 or 1 is serial;
    above 1, 'thread' maps each batch's samples over a thread pool (the
    resize and the file read release the GIL), 'process' streams the epoch
    through a `DecodePool` of forked workers that write each sample into
    shared memory. Every sample's random draws are seeded by (seed, epoch,
    position), so all backends give byte-equal batches. Subclasses define
    ``_sample_work(item) -> (uint8 image, aux)`` for ``item = (position,
    dataset index, epoch)``."""

    def _init_workers(self, num_workers: int, worker_backend: str) -> None:
        self.worker_backend, self.worker_start_method = parse_worker_backend(worker_backend)
        self.num_workers = num_workers
        self._pool = None
        self._decode_pool = None
        if num_workers > 1 and self.worker_backend == "thread":
            self._pool = ThreadPoolExecutor(max_workers=num_workers)

    def _slot_shape(self) -> tuple[int, int, int]:
        return (self.input_size, self.input_size, 3)

    def _get_decode_pool(self) -> DecodePool:
        # rebuilt when input_size changes (multi-scale training): the forked
        # workers hold a snapshot of this loader, and the slots its shape
        shape = self._slot_shape()
        if self._decode_pool is not None and self._decode_pool.slot_shape != shape:
            self._decode_pool.close()
            self._decode_pool = None
        if self._decode_pool is None:
            self._decode_pool = DecodePool(
                self._sample_work, self.num_workers, shape,
                n_slots=max(4 * self.num_workers, 2 * self.batch_size),
                start_method=self.worker_start_method)
        return self._decode_pool

    def _one_thread_work(self, item):
        """``_sample_work`` on one intra-op thread, as the worker processes
        run it: torch's float resize rounds some pixels differently on one
        thread and on several, and every backend must give the same bytes.
        (With OpenMP the setting is the calling thread's own.)"""
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return self._sample_work(item)
        finally:
            torch.set_num_threads(n)

    def _samples(self, items: list) -> Iterator:
        """``_sample_work`` over ``items`` in order, on the chosen backend.
        The process backend's images are views of a ring slot, valid until
        the next sample is taken."""
        if self.num_workers > 1 and self.worker_backend == "process":
            return self._get_decode_pool().imap(items)
        if self._pool is not None:  # one batch in flight at a time
            bs = self.batch_size
            return (out for i in range(0, len(items), bs)
                    for out in self._pool.map(self._one_thread_work, items[i : i + bs]))
        return map(self._one_thread_work, items)

    @property
    def host_index(self) -> int:
        return resolve_host_shard(self.host_shard)[0]

    @property
    def host_count(self) -> int:
        return resolve_host_shard(self.host_shard)[1]

    def _local_len(self) -> int:
        """Samples this host loads per epoch."""
        return _host_local_len(len(self.ds), self.host_count)

    def _epoch_items(self, epoch_idx: int, start_batch: int) -> list:
        """(position in the single-host epoch, dataset index, epoch) of every
        sample this host loads from its batch ``start_batch`` on: a seeded
        shuffle per epoch for training, the dataset order otherwise, then
        this host's strided share (`host_shard_order`)."""
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(len(self.ds)) if self.train else np.arange(len(self.ds))
        order, gpos = host_shard_order(order, *resolve_host_shard(self.host_shard))
        end = min(len(self) * self.batch_size, len(order))
        return [(int(gpos[pos]), int(order[pos]), epoch_idx)
                for pos in range(start_batch * self.batch_size, end)]

    def _batched(self, epoch_idx: int, start_batch: int) -> Iterator[tuple]:
        """-> (images uint8 [B, S, S, 3], the samples' aux, real count) per
        batch; a ragged last batch repeats its last image up to B. A batch
        holding a float sample (an augmentation ending in 'normalization')
        is float32, as the JAX package's np.stack makes it. A process
        pool is built at this call, in the caller's thread (the loaders'
        ``epoch`` is not a generator function), not in the thread that
        consumes the batches."""
        samples = self._samples(self._epoch_items(epoch_idx, start_batch))

        def batches():
            empty = np.empty((self.batch_size, *self._slot_shape()), np.uint8)
            batch, aux = empty, []
            for image, a in samples:
                if image.dtype != batch.dtype:  # a float sample ('normalization'):
                    batch = batch.astype(np.result_type(batch, image))  # as np.stack
                batch[len(aux)] = image
                aux.append(a)
                if len(aux) == self.batch_size:
                    yield batch.copy(), aux, len(aux)
                    batch, aux = empty, []
            if aux:
                batch[len(aux):] = batch[len(aux) - 1]
                yield batch.copy(), aux, len(aux)

        return batches()

    def close(self) -> None:
        """Stop the worker processes and threads (also done at exit)."""
        if self._decode_pool is not None:
            self._decode_pool.close()
            self._decode_pool = None
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __getstate__(self):
        # forkserver / spawn workers unpickle this loader through
        # _sample_work: the live pools stay behind (workers never use them)
        state = self.__dict__.copy()
        state["_pool"] = None
        state["_decode_pool"] = None
        return state


class DetectionLoader(_PooledLoader):
    """Batches of letterboxed images + padded normalized-xywh labels.

    train=True: a seeded shuffle per epoch, a 4-image mosaic with
    probability ``mosaic_prob``, and the augmentation pipeline; the last
    partial batch is dropped unless ``drop_last=False``.
    train=False: dataset order, letterbox only, the ragged last batch padded
    (the last image repeated, its labels empty) with ``num_real`` telling
    how many are real, and per-image ``meta`` (id, scale, pad, original hw,
    pixel-space GT) for unscaling and mAP. ``input_size`` may be changed
    between epochs (multi-scale training). ``num_workers`` /
    ``worker_backend``: the worker pools of `_PooledLoader`.

    ``emit='i420'`` gives packed I420 images [B, S*3/2, S]: each batch
    converted after letterbox (and mosaic / augmentation) by
    `ops.image.rgb_batch_to_i420_packed`, or, with ``native_jpeg``, each
    JPEG decoded straight to letterboxed I420 by the dataset's
    ``sample_i420`` (`codec.decode_jpeg_i420`). ``native_jpeg=None`` turns
    that on where it applies: emit='i420', train=False, no augmentation or
    mosaic, a dataset with ``sample_i420``. A file it does not take (not a
    JPEG, an RGB-coded JPEG, other sampling) takes the plain chain, as in
    the JAX package; meta's ``i420_fallback`` says which did, and
    `fallbacks` counts them. ``use_native``: the letterbox of
    ``csrc/letterbox.cpp`` (`codec.letterbox_batch_native`) in place of
    `dataset.letterbox`.
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
        worker_backend: str = "thread",
        emit: str = "rgb",
        native_jpeg: bool | None = None,
        on_corrupt: str = "raise",
        host_shard=None,
    ):
        if emit not in ("rgb", "i420"):
            raise ValueError(f"emit must be 'rgb' or 'i420', got {emit!r}")
        eligible = (emit == "i420" and not train and augmentation is None and mosaic_prob == 0
                    and hasattr(dataset, "sample_i420"))
        if native_jpeg is None:
            native_jpeg = eligible
        elif native_jpeg and not eligible:
            raise ValueError("native_jpeg=True needs emit='i420', train=False, no "
                             "augmentation/mosaic, and a dataset with sample_i420")
        if on_corrupt not in ("raise", "skip"):
            raise ValueError(f"on_corrupt must be 'raise' or 'skip', got {on_corrupt!r}")
        resolve_host_shard(host_shard)  # a malformed spec fails here
        self.host_shard = host_shard
        self.ds = dataset
        self.input_size = input_size
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.train = train
        self.augmentation = augmentation
        self.mosaic_prob = mosaic_prob
        self.seed = seed
        self.drop_last = train if drop_last is None else drop_last
        self.pad_value = pad_value
        self.on_corrupt = on_corrupt
        self.emit = emit
        self.native_jpeg = bool(native_jpeg)
        self.use_native = use_native
        self.fallbacks = 0  # native_jpeg samples that took the plain chain
        self._init_workers(num_workers, worker_backend)

    def __len__(self) -> int:
        n = self._local_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _slot_shape(self) -> tuple:
        s = self.input_size
        return (s * 3 // 2, s) if self.native_jpeg else (s, s, 3)

    def _fetch(self, fn, idx: int):
        return fetch_with_corrupt_policy(self.ds, self.on_corrupt, fn, idx)

    def _load_raw(self, idx: int, rng: np.random.Generator):
        """Decode + mosaic + augment one sample; labels stay pixel xyxy.
        ``rng`` is the sample's own, seeded from (seed, epoch, position)."""
        image, labels, sid = self._fetch(self.ds.__getitem__, idx)
        if self.train and self.mosaic_prob > 0 and rng.uniform() < self.mosaic_prob:
            others = rng.integers(0, len(self.ds), 3)
            samples = [(image, labels)] + [
                self._fetch(lambda j: self.ds[j][:2], int(j)) for j in others]
            image, labels = mosaic4(samples, self.input_size, rng, self.pad_value)
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

    def _letterbox(self, image: np.ndarray):
        if self.use_native:
            uint8_only(image, "use_native")  # the JAX package casts unchecked
            out, scales, pads = letterbox_batch_native([image], self.input_size, self.pad_value,
                                                       num_threads=1)
            return out[0], scales[0], (int(pads[0, 0]), int(pads[0, 1]))
        return letterbox(image, self.input_size, self.pad_value)

    def _sample_i420(self, idx: int):
        """One eval sample through the fused JPEG -> I420 decode, or the plain
        chain (decode, letterbox, RGB -> I420) for a file it does not take."""
        r = self.ds.sample_i420(idx, self.input_size, self.pad_value)
        if r is not None:
            packed, lab, sid, scale, (px, py), dhw = r
        else:
            image, lab, sid = self.ds[idx]
            out, scale, (px, py) = self._letterbox(image)
            packed = rgb_batch_to_i420_packed(out[None])[0]
            dhw = image.shape[:2]
        meta = {"id": sid, "scale": scale, "pad": (px, py), "orig_hw": dhw, "gt_pixels": lab,
                "i420_fallback": r is None}
        return packed, (self._finalize(lab, scale, px, py), meta)

    def _sample_work(self, item):
        """(position, dataset index, epoch) -> (letterboxed uint8 [S, S, 3],
        or packed I420 [S*3/2, S] with ``native_jpeg``, (padded labels,
        meta)): one sample's whole host pipeline."""
        pos, idx, epoch_idx = item
        if self.native_jpeg:
            return self._fetch(self._sample_i420, idx)
        image, lab, sid = self._load_raw(idx, np.random.default_rng((self.seed, epoch_idx, pos)))
        out, scale, (px, py) = self._letterbox(image)
        meta = {"id": sid, "scale": scale, "pad": (px, py), "orig_hw": image.shape[:2],
                "gt_pixels": lab}
        return out, (self._finalize(lab, scale, px, py), meta)

    def epoch(self, epoch_idx: int = 0, start_batch: int = 0) -> Iterator[dict]:
        """-> batches {'images', 'labels', 'num_real', 'meta'}, from batch
        ``start_batch`` of the epoch on (the earlier ones are not loaded)."""
        empty = np.full((self.max_boxes, 5), -1, np.float32)

        def batch(images, aux, real):
            metas = [a[1] for a in aux]
            if self.native_jpeg:
                self.fallbacks += sum(m["i420_fallback"] for m in metas)
            elif self.emit == "i420":
                uint8_only(images, "emit='i420'")  # the JAX package casts unchecked
                images = rgb_batch_to_i420_packed(images)
            return {"images": images,
                    "labels": np.stack([a[0] for a in aux] + [empty] * (self.batch_size - real)),
                    "num_real": real, "meta": metas}

        return (batch(*b) for b in self._batched(epoch_idx, start_batch))

    def __iter__(self):
        return self.epoch(0)


class ClassificationLoader(_PooledLoader):
    """Classification batches: images uint8 [B, S, S, 3] (each image resized
    to S x S with the bilinear `resize_bilinear`, within +-1 of the JAX
    package's cv2 resize), labels int32 [B], ``num_real``.

    train=True: a seeded shuffle per epoch, the augmentation pipeline, the
    last partial batch dropped. train=False: dataset order, no augmentation,
    the ragged last batch padded with its last image and label. The
    augmentation's draws are seeded by (seed, epoch, position), so every
    backend and worker count gives byte-equal batches."""

    def __init__(self, dataset, input_size: int = 224, batch_size: int = 32, train: bool = True,
                 augmentation: Augmentation | None = None, seed: int = 0,
                 on_corrupt: str = "raise", num_workers: int = 0,
                 worker_backend: str = "thread", host_shard=None):
        if on_corrupt not in ("raise", "skip"):
            raise ValueError(f"on_corrupt must be 'raise' or 'skip', got {on_corrupt!r}")
        resolve_host_shard(host_shard)
        self.host_shard = host_shard
        self.ds = dataset
        self.input_size = input_size
        self.batch_size = batch_size
        self.train = train
        self.augmentation = augmentation
        self.seed = seed
        self.on_corrupt = on_corrupt
        self._init_workers(num_workers, worker_backend)

    def __len__(self) -> int:
        n = self._local_len()
        return n // self.batch_size if self.train else -(-n // self.batch_size)

    def _sample_work(self, item):
        """(position, dataset index, epoch) -> (uint8 [S, S, 3], label)."""
        pos, idx, epoch_idx = item
        image, label = fetch_with_corrupt_policy(self.ds, self.on_corrupt,
                                                 self.ds.__getitem__, idx)
        if self.train and self.augmentation is not None:
            image, _ = self.augmentation(image, None,
                                         np.random.default_rng((self.seed, epoch_idx, pos)))
        return resize_bilinear(image, self.input_size, self.input_size), label

    def epoch(self, epoch_idx: int = 0, start_batch: int = 0) -> Iterator[dict]:
        """-> batches {'images', 'labels', 'num_real'}, from batch
        ``start_batch`` of the epoch on."""
        return ({"images": images,
                 "labels": np.asarray(labels + labels[-1:] * (self.batch_size - real), np.int32),
                 "num_real": real}
                for images, labels, real in self._batched(epoch_idx, start_batch))

    def __iter__(self):
        return self.epoch(0)


def prefetch_to_device(
    iterator: Iterator[dict],
    device: str | torch.device | None = None,
    buffer_size: int = 2,
    device_keys: tuple[str, ...] = ("images", "labels"),
    mesh=None,
    per_host: bool = False,
) -> Iterator[dict]:
    """Two-stage background prefetch + device placement.

    A loader thread pulls host batches from ``iterator``; a transfer thread
    moves ``device_keys`` to ``device`` (None: CUDA, raising without a card),
    with a ``mesh`` (`core.mesh.Mesh`) this rank's contiguous share of each
    global batch only (`core.mesh.shard_batch`); ``per_host=True`` declares
    the batches host-local already (loaders built with ``host_shard``), and
    needs a mesh.
    On CUDA the copy is from pinned memory, ``non_blocking``, on a side
    stream, so loading batch k + 2, copying batch k + 1 and computing on
    batch k overlap; the consumer's stream waits for the copy's event
    before the batch is handed out. Other keys (meta, num_real) pass
    through. An exception in either thread re-raises in the consumer.
    The consumer's wait for each batch, and the last one for the end, is a
    ``data.wait`` span (`core.telemetry.span`) on the consumer's thread."""
    if per_host and mesh is None:
        raise ValueError("prefetch_to_device(per_host=True) needs the mesh the host-local "
                         "batches are slices of")
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
        if mesh is not None:
            from ..core.mesh import shard_batch

            batch = {**batch, **shard_batch({k: batch[k] for k in device_keys if k in batch},
                                            mesh, per_host)}
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
            # the consumer's wait: the last one finds the iterator done
            with span("data.wait"):
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
        # a loader's next epoch may reuse its worker pool: the thread that
        # read this one must be out of it first (at most one batch away).
        # Not while the interpreter exits: its daemon threads no longer run
        if not sys.is_finalizing():
            for t in threads:
                t.join()
