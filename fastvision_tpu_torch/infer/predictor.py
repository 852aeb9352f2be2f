"""Detector: batched YOLO inference over images, directories and datasets,
and its mAP evaluation (port of fastvision_tpu/infer/predictor.py::Detector,
standard postprocess, RGB input).

The host letterboxes and stacks a uint8 batch; the device normalizes, runs
the model (bf16 autocast by default, float32 parameters and BN statistics),
decodes in the heads' dtype, and runs class-offset greedy NMS in float32,
whose suppression is the hand-written CUDA kernel on the card; the host
unscales the kept boxes to original pixels.

`Detector.evaluate` scores a dataset: by default the host matches each
image's detections in original pixels (and can write COCO results JSON), as
the reference does; ``device_matching=True`` runs the matching on the device
beside the NMS (`ops.map.match_predictions_device`), the JAX package's
default, and the host only accumulates the correct-matrices.
`Detector.evaluate_sweep` scores a grid of (conf, iou) thresholds in one
data pass: each batch is uploaded and run through the model once, and every
grid point runs its NMS on the device-resident predictions.

`VideoClassifier` classifies clips with a model of the video zoo.

Not ported yet: multi_label NMS, packed-I420 input, device letterbox,
fast_decode, TTA, the reference_demo postprocess (ROADMAP Queue 1, item 6)
and quantize (item 15).
"""
from __future__ import annotations

import json
import os
import time
from typing import Iterator, Sequence

import numpy as np
import torch
from torch import nn

from ..data.dataset import IMG_EXTS, resize_bilinear
from ..data.pipeline import (
    DetectionLoader,
    _not_ported,
    normalize_images,
    prefetch_to_device,
)
from ..device import resolve_device
from ..nn.layers import memory_format_for
from ..ops.box import xywhn2xyxy
from ..ops.map import MeanAveragePrecision, match_predictions_device
from ..ops.nms import Detections, batched_non_max_suppression, class_offset_for
from .decode import decode_predictions
from .postprocess import scale_coords
from .preprocess import preprocess_batch

# the reference's published sweep grid of (conf_thres, iou_thres)
REFERENCE_SWEEP = [
    (0.25, 0.65), (0.25, 0.45), (0.25, 0.35), (0.25, 0.25), (0.25, 0.15),
    (0.35, 0.25), (0.45, 0.25), (0.55, 0.25), (0.65, 0.25),
]


def coco_80_to_91_ids() -> list[int]:
    """The 80 contiguous class indices -> COCO annotation category ids
    (1..90 with gaps), as the official evaluator expects them."""
    missing = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}
    return [cid for cid in range(1, 91) if cid not in missing]


def detections_to_coco(image_id, boxes, scores, classes, coco_ids: bool = False) -> list[dict]:
    """One image's detections -> COCO results entries ([{image_id,
    category_id, bbox [x, y, w, h], score}], what pycocotools' loadRes
    reads). Boxes in pixel xyxy; a numeric filename stem becomes an int
    image_id (000000000139 -> 139); ``coco_ids`` maps the 80 contiguous
    classes to the annotation ids 1..90."""
    sid = str(image_id)
    iid = int(sid) if sid.isdigit() else sid
    id_map = coco_80_to_91_ids() if coco_ids else None
    out = []
    for b, sc, c in zip(np.asarray(boxes), np.asarray(scores), np.asarray(classes)):
        x1, y1, x2, y2 = (float(v) for v in b)
        out.append({
            "image_id": iid, "category_id": id_map[int(c)] if id_map else int(c),
            "bbox": [round(x1, 3), round(y1, 3), round(x2 - x1, 3), round(y2 - y1, 3)],
            "score": round(float(sc), 5),
        })
    return out


def _write_metric_rows(metric_file: str, note: str, r) -> None:
    """Append one reference-style mAP table row (header, per-IoU values, mean)."""
    with open(metric_file, "a") as f:
        header = " ".join(f"mAP@{t:.2f}" for t in r.iou_thresholds)
        row = " ".join(f"{v:.4f}" for v in r.map_per_iou)
        f.write(f"# {note}\n{header} | mAP@0.5:0.95\n{row} | {r.map:.4f}\n")


class _Subset:
    """The first ``n`` samples of a dataset."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


class Detector:
    """YOLO-style detector wrapper.

    >>> det = Detector(model, anchors, input_size=416)       # on CUDA
    >>> det = Detector(model, anchors, device="cpu", dtype=torch.float32)
    >>> results = det.predict_batch([rgb_uint8_array, ...])

    ``model`` is a port ``YOLOv3`` that already holds its weights; it is
    moved to ``device`` in ``channels_last`` memory and set to eval mode.
    ``device=None`` means CUDA, and raises where there is no card.
    ``batch_buckets`` are extra batch sizes below ``batch_size``: a request
    of n images pads (repeating the last image) to the smallest bucket >= n.
    """

    def __init__(
        self,
        model: nn.Module,
        anchors,
        input_size: int = 416,
        strides: Sequence[int] = (32, 16, 8),
        decode_style: str = "v5",
        conf_thres: float = 0.25,
        iou_thres: float = 0.45,
        max_det: int = 300,
        batch_size: int = 8,
        normalize: str = "scale",  # 'scale' (/255) or 'imagenet'
        dtype: torch.dtype = torch.bfloat16,
        pad_value: int = 114,
        batch_buckets: Sequence[int] = (),
        class_names: Sequence[str] | None = None,
        postprocess_mode: str = "standard",
        device: str | torch.device | None = None,
    ):
        if postprocess_mode == "reference_demo":
            raise _not_ported("postprocess_mode='reference_demo'", 6)
        if postprocess_mode != "standard":
            raise ValueError(f"postprocess_mode must be 'standard' or 'reference_demo', "
                             f"got {postprocess_mode!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=memory_format_for(model)).eval()
        self.anchors = torch.as_tensor(np.asarray(anchors, np.float32), device=self.device)
        self.input_size = input_size
        self.strides = tuple(strides)
        self.decode_style = decode_style
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.batch_size = batch_size
        buckets = sorted({int(b) for b in batch_buckets if 0 < int(b) < batch_size})
        self.batch_buckets = (*buckets, batch_size)
        self.imagenet = normalize == "imagenet"
        self.dtype = dtype
        self.pad_value = pad_value
        self.class_names = list(class_names) if class_names else None
        self.postprocess_mode = postprocess_mode
        # decoded boxes can spill past the canvas (v5 wh up to 4x anchor)
        self.class_offset = class_offset_for(3.0 * input_size)
        self._match_thresholds = torch.from_numpy(np.linspace(0.5, 0.95, 10).astype(np.float32))

    @torch.inference_mode()
    def predecode(self, images_u8: torch.Tensor) -> torch.Tensor:
        """Device uint8 [B, S, S, 3] -> decoded predictions [B, N, 5 + C]
        (normalize + forward + decode) in the heads' dtype."""
        x = normalize_images(images_u8, self.dtype, imagenet=self.imagenet)
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            heads = self.model(x)
        return decode_predictions(heads, self.anchors, self.strides, self.decode_style)

    @torch.inference_mode()
    def nms(self, pred: torch.Tensor, conf_thres: float | None = None,
            iou_thres: float | None = None) -> Detections:
        """Decoded predictions -> Detections (float32 class-offset NMS) at
        the detector's thresholds, or at the ones given."""
        return batched_non_max_suppression(
            pred.float(), conf_thres=self.conf_thres if conf_thres is None else conf_thres,
            iou_thres=self.iou_thres if iou_thres is None else iou_thres,
            max_det=self.max_det, class_offset=self.class_offset)

    def infer(self, images_u8: torch.Tensor) -> Detections:
        """Device uint8 [B, S, S, 3] -> Detections in input-space pixels."""
        return self.nms(self.predecode(images_u8))

    @torch.inference_mode()
    def infer_match(self, images_u8: torch.Tensor, labels: torch.Tensor,
                    clip_lo: torch.Tensor, clip_hi: torch.Tensor):
        """The device-matched eval step: `infer`, then each image's mAP
        correct-matrix against its padded normalized-xywh labels [B, M, 5].
        Predictions are clipped to the letterbox content region [clip_lo,
        clip_hi] ([B, 2] each, input pixels), the clip the host path applies
        in original pixels; IoU is invariant under the letterbox's uniform
        scale, so input-space matching equals the host's. -> (scores,
        classes, valid, correct [B, D, 10])."""
        det = self.infer(images_u8)
        gt_cls = labels[..., 0]
        boxes = torch.clamp(det.boxes, clip_lo.repeat(1, 2)[:, None, :],
                            clip_hi.repeat(1, 2)[:, None, :])
        size = float(self.input_size)
        correct = match_predictions_device(
            boxes, det.classes.float(), det.valid, xywhn2xyxy(labels[..., 1:5], size, size),
            gt_cls, gt_cls >= 0, self._match_thresholds.to(boxes.device))
        return det.scores, det.classes, det.valid, correct

    def predict_batch(self, images: Sequence[np.ndarray | str]) -> list[dict]:
        """-> list of {boxes, scores, classes} in ORIGINAL image pixels.
        Any n works: smaller batches pad to a bucket, larger ones chunk."""
        n = len(images)
        if n > self.batch_size:
            out = []
            for i in range(0, n, self.batch_size):
                out.extend(self.predict_batch(images[i : i + self.batch_size]))
            return out
        batch, metas = preprocess_batch(images, self.input_size, pad_value=self.pad_value)
        target = next(b for b in self.batch_buckets if b >= n)
        if n < target:
            batch = np.concatenate([batch, np.repeat(batch[-1:], target - n, 0)])
        det = self.infer(torch.from_numpy(batch).to(self.device))
        boxes, scores, classes, valid = (t.cpu().numpy() for t in det)
        out = []
        for i in range(n):
            v = valid[i]
            out.append({
                "boxes": scale_coords(boxes[i][v], metas[i]["scale"], metas[i]["pad"],
                                      metas[i]["orig_hw"]),
                "scores": scores[i][v], "classes": classes[i][v]})
        return out

    def predict_image(self, image: np.ndarray | str) -> dict:
        return self.predict_batch([image])[0]

    def predict_dir(self, directory: str) -> Iterator[tuple[str, dict]]:
        """Batched inference over all images in a directory (needs cv2 to decode)."""
        paths = sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.lower().endswith(IMG_EXTS)
        )
        for i in range(0, len(paths), self.batch_size):
            chunk = paths[i : i + self.batch_size]
            yield from zip(chunk, self.predict_batch(chunk))

    # ------------------------------------------------------------------
    def _loader(self, dataset, max_boxes: int, num_workers: int = 0) -> DetectionLoader:
        return DetectionLoader(dataset, self.input_size, self.batch_size, max_boxes=max_boxes,
                               train=False, drop_last=False, pad_value=self.pad_value,
                               num_workers=num_workers)

    def predict_dataset(self, dataset, fast_decode: bool | None = None,
                        num_workers: int = 0) -> Iterator[tuple[dict, np.ndarray]]:
        """Prefetch-overlapped inference over a DetectionDataset: the host
        loads batch k + 1 on a background thread while the device runs
        batch k. Yields ({boxes, scores, classes, id} in original pixels,
        the image's pixel-xyxy GT [n, 5])."""
        if fast_decode:
            raise _not_ported("fast_decode (reduced JPEG decode)", 6)
        loader = self._loader(dataset, 1, num_workers)
        for batch in prefetch_to_device(loader.epoch(0), device=self.device,
                                        device_keys=("images",)):
            boxes, scores, classes, valid = (t.cpu().numpy() for t in self.infer(batch["images"]))
            for i in range(batch["num_real"]):
                meta, v = batch["meta"][i], valid[i]
                yield ({"boxes": scale_coords(boxes[i][v], meta["scale"], meta["pad"],
                                              meta["orig_hw"]),
                        "scores": scores[i][v], "classes": classes[i][v], "id": meta["id"]},
                       meta["gt_pixels"])

    def _evaluate_device(self, ds, m: MeanAveragePrecision, num_workers: int,
                         max_boxes: int) -> None:
        """Images and padded labels go to the device; one `infer_match` per
        batch returns the correct-matrices; the host strips padding."""
        for batch in prefetch_to_device(self._loader(ds, max_boxes, num_workers).epoch(0),
                                        device=self.device):
            # each image's letterbox content region, in input pixels
            lo = np.zeros((self.batch_size, 2), np.float32)
            hi = np.full((self.batch_size, 2), float(self.input_size), np.float32)
            for i, meta in enumerate(batch["meta"]):
                s = meta["scale"]
                sx, sy = (s, s) if np.isscalar(s) else s
                px, py = meta["pad"]
                oh, ow = meta["orig_hw"]
                lo[i] = (px, py)
                hi[i] = (px + ow * sx, py + oh * sy)
            out = self.infer_match(batch["images"], batch["labels"],
                                   torch.from_numpy(lo).to(self.device),
                                   torch.from_numpy(hi).to(self.device))
            scores, classes, valid, correct = (t.cpu().numpy() for t in out)
            for i in range(batch["num_real"]):
                # the GT classes from the host's meta, cut to what the device saw
                gt_cls = batch["meta"][i]["gt_pixels"][:max_boxes, 0]
                m.update_matched(correct[i], scores[i], classes[i], gt_cls, pred_valid=valid[i])

    def evaluate(self, dataset, metric_file: str | None = None, config_note: str = "",
                 max_images: int | None = None, tta: bool = False,
                 device_matching: bool = False, max_boxes: int = 120,
                 num_workers: int = 0, save_json: str | None = None,
                 coco_ids: bool = False) -> dict:
        """mAP over a DetectionDataset -> {map50, map, images, img_per_sec}.

        The host matches each image's boxes in original pixels, by the
        reference's rule. ``device_matching=True`` matches on the device
        instead (`infer_match`; ``max_boxes`` bounds each image's GT there),
        by the JAX package's default rule, which differs where two
        same-class predictions overlap one GT (`ops.map.match_predictions_device`).
        ``metric_file``: append a reference-style table row. ``save_json``:
        write every detection as COCO results JSON (host matching only),
        with ``coco_ids`` mapping the 80 classes to the annotation ids 1..90.
        ``max_images``: the first n images only."""
        if tta:
            raise _not_ported("test-time augmentation (tta)", 6)
        if save_json and device_matching:
            raise ValueError("save_json needs original-pixel boxes on the host: use "
                             "device_matching=False")
        m = MeanAveragePrecision()
        n = len(dataset) if max_images is None else min(len(dataset), max_images)
        ds = dataset if n == len(dataset) else _Subset(dataset, n)
        t0 = time.perf_counter()
        if device_matching:
            self._evaluate_device(ds, m, num_workers, max_boxes)
        else:
            entries = [] if save_json else None
            for res, lab in self.predict_dataset(ds, num_workers=num_workers):
                m.update(res["boxes"], res["scores"], res["classes"], lab[:, 1:5], lab[:, 0])
                if entries is not None:
                    entries.extend(detections_to_coco(res["id"], res["boxes"], res["scores"],
                                                      res["classes"], coco_ids=coco_ids))
            if save_json:
                with open(save_json, "w") as f:
                    json.dump(entries, f)
        dt = time.perf_counter() - t0
        r = m.compute()
        if metric_file:
            _write_metric_rows(metric_file, config_note, r)
        return {"map50": r.map50, "map": r.map, "images": n, "img_per_sec": n / max(dt, 1e-9)}

    def evaluate_sweep(self, dataset, points: Sequence[tuple[float, float]],
                       metric_file: str | None = None,
                       max_images: int | None = None) -> list[dict]:
        """mAP at each (conf_thres, iou_thres) point of a grid in one data
        pass: each batch is loaded, uploaded and run through the model
        once, then each point's NMS runs on the device-resident predictions
        and its boxes are matched on the host. -> one {conf, iou, map50,
        map, images} per point; ``metric_file`` gets one table row each."""
        points = [(float(c), float(i)) for c, i in points]
        n = len(dataset) if max_images is None else min(len(dataset), max_images)
        ds = dataset if n == len(dataset) else _Subset(dataset, n)
        metrics = [MeanAveragePrecision() for _ in points]
        for batch in prefetch_to_device(self._loader(ds, 1).epoch(0), device=self.device,
                                        device_keys=("images",)):
            pred = self.predecode(batch["images"])
            for m, (conf, iou) in zip(metrics, points):
                det = self.nms(pred, conf, iou)
                boxes, scores, classes, valid = (t.cpu().numpy() for t in det)
                for i in range(batch["num_real"]):
                    meta, v = batch["meta"][i], valid[i]
                    gt = meta["gt_pixels"]
                    m.update(scale_coords(boxes[i][v], meta["scale"], meta["pad"],
                                          meta["orig_hw"]),
                             scores[i][v], classes[i][v], gt[:, 1:5], gt[:, 0])
        results = []
        for m, (conf, iou) in zip(metrics, points):
            r = m.compute()
            results.append({"conf": conf, "iou": iou, "map50": r.map50, "map": r.map,
                            "images": n})
            if metric_file:
                _write_metric_rows(metric_file, f"sweep input_size {self.input_size} "
                                                f"conf_thres {conf} iou_thres {iou}", r)
        return results


class VideoClassifier:
    """Clip-level video recognition with a model of the video zoo (C3D,
    3D-ResNet, SlowFast) that already holds its weights.

    >>> vc = VideoClassifier(model, num_frames=32, size=224, class_names=names)
    >>> vc.predict_clip(frames)  # {'class', 'prob', 'probs'}

    The model is moved to ``device`` (None: CUDA, raising without a card)
    in ``channels_last_3d`` memory and set to eval mode. A clip's frames
    are resized to ``size`` with `resize_bilinear`; the device normalizes
    (imagenet by default), runs the model under ``dtype`` autocast and
    takes the softmax in float32."""

    def __init__(self, model: nn.Module, num_frames: int = 16, size: int = 112,
                 strategy: str = "average", class_names: Sequence[str] | None = None,
                 normalize: str = "imagenet", dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=memory_format_for(model)).eval()
        self.num_frames = num_frames
        self.size = size
        self.strategy = strategy
        self.class_names = list(class_names) if class_names else None
        self.imagenet = normalize == "imagenet"
        self.dtype = dtype

    @torch.inference_mode()
    def probabilities(self, clips_u8: torch.Tensor) -> torch.Tensor:
        """Device uint8 clips [B, T, S, S, 3] -> float32 softmax [B, C]."""
        x = normalize_images(clips_u8, self.dtype, imagenet=self.imagenet)
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            logits = self.model(x)
        return torch.softmax(logits.float(), dim=-1)

    def predict_clip(self, clip: np.ndarray) -> dict:
        """clip: [T, H, W, 3] uint8 -> {'class', 'prob', 'probs'}."""
        frames = np.stack([resize_bilinear(f, self.size, self.size) for f in clip])
        probs = self.probabilities(torch.from_numpy(frames[None]).to(self.device))[0].cpu().numpy()
        idx = int(np.argmax(probs))
        return {"class": self.class_names[idx] if self.class_names else idx,
                "prob": float(probs[idx]), "probs": probs}

    def predict_video(self, path: str, rng: np.random.Generator | None = None) -> dict:
        """A video file (decoded with cv2; ``data.video_sampler.load_clip``)
        -> `predict_clip` of ``num_frames`` frames drawn by ``strategy``."""
        from ..data.video_sampler import load_clip

        return self.predict_clip(load_clip(path, self.num_frames, self.strategy, self.size, rng))
