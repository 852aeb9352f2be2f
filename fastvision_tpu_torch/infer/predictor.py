"""Detector: batched YOLO inference over images, directories and datasets,
and its mAP evaluation (port of fastvision_tpu/infer/predictor.py::Detector).

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

`Detector.predict_video` runs the detector over a video's frames, batch by
batch, with a reader thread decoding ahead (Motion-JPEG and MPEG-4 Part 2
videos without cv2, `data.avi`), and can write an annotated ``mp4v`` video (the port's own
encoder and muxer, `data.mp4`, cv2 or not).
`VideoClassifier` classifies clips with a model of the video zoo.

``multi_label=True`` runs the serving NMS (`ops.nms.non_max_suppression_multilabel`:
every (box, class) pair above the threshold is a candidate) in `infer`,
`infer_match` and `evaluate`.

Input paths, as in the JAX package:

- ``input_format='i420'``: batches go to the card as packed YUV 4:2:0 (1.5
  bytes a pixel, half of RGB) and are colour-decoded there
  (`ops.image.i420_packed_to_rgb`, inside `normalize_images`);
  `predict_dataset` / `evaluate` read JPEGs with the fused JPEG -> I420
  decode (`codec.decode_jpeg_i420`);
- ``device_letterbox``: the host only decodes into a fixed ``canvas_hw``
  canvas and the card letterboxes (`ops.image.letterbox_batch`);
- ``fast_decode``: a JPEG at least 2x larger than the input is decoded at
  1/2, 1/4 or 1/8 (`data.dataset.imread_rgb_scaled`);
- ``tta``: horizontal-flip test-time augmentation, the two orientations'
  boxes merged by a host greedy NMS;
- ``postprocess_mode='reference_demo'``: the yolov3_u demo's chain, each
  image's boxes unscaled to original pixels and filtered (sides >
  ``min_box_px``) before an NMS ranked by objectness.

`Detector.quantize` switches the detector to int8 (w8a8 post-training
quantization, `infer.quantize`) in place: every path above then runs the
model's ConvBN convs as int8 GEMMs on the card, and the NMS kernel as before.
"""
from __future__ import annotations

import copy
import json
import os
import time
from typing import Iterator, Sequence

import numpy as np
import torch
from torch import nn

from ..data.augment import Augmentation, HorizontalFlip
from ..data.avi import open_video
from ..data.converters import coco_80_to_91_ids
from ..data.dataset import IMG_EXTS, imread_rgb, imread_rgb_scaled, resize_bilinear
from ..data.mp4 import VideoWriter
from ..data.pipeline import DetectionLoader, normalize_images, prefetch_to_device
from ..device import resolve_device
from ..nn.layers import memory_format_for
from ..ops.box import xywhn2xyxy
from ..ops.image import letterbox_batch, pack_canvas, rgb_batch_to_i420_packed
from ..ops.map import MeanAveragePrecision, match_predictions_device
from ..ops.nms import (
    Detections,
    batched_non_max_suppression,
    class_offset_for,
    non_max_suppression_multilabel,
)
from .decode import decode_predictions
from .postprocess import reference_demo_unscale, scale_coords
from .preprocess import preprocess_batch

# the reference's published sweep grid of (conf_thres, iou_thres)
REFERENCE_SWEEP = [
    (0.25, 0.65), (0.25, 0.45), (0.25, 0.35), (0.25, 0.25), (0.25, 0.15),
    (0.35, 0.25), (0.45, 0.25), (0.55, 0.25), (0.65, 0.25),
]


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


def _greedy_nms_np(boxes: np.ndarray, scores: np.ndarray, iou_thres: float) -> np.ndarray:
    """Host greedy NMS over a small merged candidate set (TTA); -> the kept
    indices in descending-score order."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        b, r = boxes[i], boxes[rest]
        ix1 = np.maximum(b[0], r[:, 0])
        iy1 = np.maximum(b[1], r[:, 1])
        ix2 = np.minimum(b[2], r[:, 2])
        iy2 = np.minimum(b[3], r[:, 3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        area_b = (b[2] - b[0]) * (b[3] - b[1])
        area_r = (r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])
        iou = inter / np.maximum(area_b + area_r - inter, 1e-9)
        order = rest[iou <= iou_thres]
    return np.asarray(keep, np.int64)


def _merge_tta(boxes, scores, classes, iou_thres: float, max_det: int) -> dict:
    """Both orientations' candidates in ORIGINAL pixels -> one class-aware
    greedy NMS, with the class offset taken from the boxes' magnitude."""
    off = class_offset_for(float(np.abs(boxes).max(initial=0.0)))
    keep = _greedy_nms_np(boxes + classes[:, None].astype(np.float32) * off, scores,
                          iou_thres)[:max_det]
    return {"boxes": boxes[keep], "scores": scores[keep], "classes": classes[keep]}


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
    ``multi_label`` selects the serving NMS (every (box, class) pair a
    candidate), as the JAX package's serving preset does.
    ``input_format`` ('rgb' or 'i420'), ``device_letterbox`` (with the host
    canvas ``canvas_hw``), ``fast_decode`` and ``postprocess_mode``
    ('standard' or 'reference_demo', whose pre-NMS filter drops boxes with a
    side <= ``min_box_px`` original pixels): the input paths of the module
    docstring, with the JAX package's exclusions.
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
        multi_label: bool = False,
        device_letterbox: bool = False,
        canvas_hw: tuple[int, int] = (640, 640),
        input_format: str = "rgb",
        fast_decode: bool = False,
        min_box_px: float = 5.0,
        device: str | torch.device | None = None,
    ):
        if postprocess_mode not in ("standard", "reference_demo"):
            raise ValueError(f"postprocess_mode must be 'standard' or 'reference_demo', "
                             f"got {postprocess_mode!r}")
        if postprocess_mode == "reference_demo" and (
                multi_label or input_format != "rgb" or device_letterbox or fast_decode):
            raise ValueError("postprocess_mode='reference_demo' supports only the plain RGB "
                             "batch path (no multi_label / i420 / device_letterbox / fast_decode)")
        if input_format not in ("rgb", "i420"):
            raise ValueError(f"input_format must be 'rgb' or 'i420', got {input_format!r}")
        if input_format == "i420" and device_letterbox:
            raise ValueError("input_format='i420' and device_letterbox are mutually exclusive")
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
        self.multi_label = multi_label
        self.input_format = input_format
        self.device_letterbox = device_letterbox
        self.canvas_hw = tuple(canvas_hw)
        self.fast_decode = fast_decode
        self.min_box_px = min_box_px
        self.i420_fallbacks = 0  # images predict_dataset read through the plain chain
        # decoded boxes can spill past the canvas (v5 wh up to 4x anchor)
        self.class_offset = class_offset_for(3.0 * input_size)
        self._match_thresholds = torch.from_numpy(np.linspace(0.5, 0.95, 10).astype(np.float32))

    @torch.inference_mode()
    def predecode(self, images: torch.Tensor) -> torch.Tensor:
        """Device uint8 [B, S, S, 3] (float pixels, or a packed I420 batch
        [B, S*3/2, S]) -> decoded predictions [B, N, 5 + C] (normalize +
        forward + decode) in the heads' dtype."""
        x = normalize_images(images, self.dtype, imagenet=self.imagenet)
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            heads = self.model(x)
        return decode_predictions(heads, self.anchors, self.strides, self.decode_style)

    @torch.inference_mode()
    def nms(self, pred: torch.Tensor, conf_thres: float | None = None,
            iou_thres: float | None = None) -> Detections:
        """Decoded predictions -> Detections (float32 class-offset NMS,
        multi-label when the detector is) at the detector's thresholds, or at
        the ones given."""
        fn = non_max_suppression_multilabel if self.multi_label else batched_non_max_suppression
        return fn(pred.float(), conf_thres=self.conf_thres if conf_thres is None else conf_thres,
                  iou_thres=self.iou_thres if iou_thres is None else iou_thres,
                  max_det=self.max_det, class_offset=self.class_offset)

    def infer(self, images: torch.Tensor) -> Detections:
        """Device uint8 [B, S, S, 3], or packed I420 [B, S*3/2, S] ->
        Detections in input-space pixels."""
        return self.nms(self.predecode(images))

    @torch.inference_mode()
    def infer_canvas(self, canvas_u8: torch.Tensor, sizes_hw: torch.Tensor):
        """The device-letterbox program: uint8 canvas [B, Hmax, Wmax, 3] with
        each image's true (h, w) [B, 2] -> (Detections in input pixels,
        scales_xy [B, 2], pads_xy [B, 2]); the letterbox pads with 114 and
        computes in the detector's dtype, as the JAX package's does."""
        images, scales, pads = letterbox_batch(canvas_u8, sizes_hw, self.input_size,
                                               dtype=self.dtype)
        return self.infer(images), scales, pads

    @torch.inference_mode()
    def infer_demo(self, images_u8: torch.Tensor, ratios: torch.Tensor, pads: torch.Tensor,
                   ori_wh: torch.Tensor) -> Detections:
        """The reference_demo program: each image's predictions unscaled to
        its ORIGINAL pixels and filtered (`postprocess.reference_demo_unscale`)
        before an xyxy NMS ranked by objectness. ratios [B], pads [B, 2]
        (left, top), ori_wh [B, 2]. The coordinates are clamped to the
        original image, so the class offset holds for originals up to
        ``class_offset`` pixels (the demo's own constant has the same bound)."""
        pred = reference_demo_unscale(self.predecode(images_u8).float(), ratios, pads[:, 0],
                                      pads[:, 1], ori_wh[:, 0], ori_wh[:, 1],
                                      min_wh=self.min_box_px)
        return batched_non_max_suppression(
            pred, conf_thres=self.conf_thres, iou_thres=self.iou_thres, max_det=self.max_det,
            box_format="xyxy", score_mode="obj", class_offset=self.class_offset)

    @torch.inference_mode()
    def predecode_tta(self, images: torch.Tensor) -> torch.Tensor:
        """The batch and its horizontal mirror in one [2B] forward ->
        decoded predictions [2B, N, 5 + C] (mirror second)."""
        x = normalize_images(images, self.dtype, imagenet=self.imagenet)
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            heads = self.model(torch.cat([x, x.flip(2)], dim=0))
        return decode_predictions(heads, self.anchors, self.strides, self.decode_style)

    def infer_tta(self, images: torch.Tensor) -> Detections:
        """`predecode_tta`, NMS'd per orientation -> Detections [2B]."""
        return self.nms(self.predecode_tta(images))

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

    def _pad_to_bucket(self, *arrays):
        """Repeat the last entry of each array up to the smallest bucket >= n."""
        n = len(arrays[0])
        target = next(b for b in self.batch_buckets if b >= n)
        return [a if n == target else np.concatenate([a, np.repeat(a[-1:], target - n, 0)])
                for a in arrays]

    def predict_batch(self, images: Sequence[np.ndarray | str], tta: bool = False) -> list[dict]:
        """-> list of {boxes, scores, classes} in ORIGINAL image pixels.
        Any n works: smaller batches pad to a bucket, larger ones chunk.
        ``tta``: horizontal-flip test-time augmentation (`_predict_tta`)."""
        if tta:
            return self._predict_tta(images)
        n = len(images)
        if n > self.batch_size:
            out = []
            for i in range(0, n, self.batch_size):
                out.extend(self.predict_batch(images[i : i + self.batch_size]))
            return out
        if self.device_letterbox:
            return self._predict_batch_canvas(images)
        batch, metas = preprocess_batch(images, self.input_size, pad_value=self.pad_value,
                                        fast_decode=self.fast_decode)
        (batch,) = self._pad_to_bucket(batch)
        if self.postprocess_mode == "reference_demo":
            return self._predict_batch_demo(batch, metas, n)
        if self.input_format == "i420":
            batch = rgb_batch_to_i420_packed(batch)
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

    def quantize(self, calib_images: Sequence[np.ndarray | str], skip: Sequence[str] = (),
                 percentile: bool = False) -> None:
        """Switch this detector to int8 (w8a8 PTQ) inference in place.

        ``calib_images`` (a handful of representative images or paths) are
        letterboxed, normalized to float32 and run through the float model
        (no autocast) to calibrate each ConvBN's input scale; the weights are
        BN-folded and quantized per output channel (`infer.quantize`). Later
        calls run the ConvBN convs as int8 x int8 -> int32 GEMMs (the CPU:
        the plain float64 version). ``skip`` and ``percentile``: as in
        `infer.quantize.quantize_variables`."""
        from .quantize import quantize_model

        arrs = [imread_rgb(im) if isinstance(im, str) else im for im in calib_images]
        batch, _ = preprocess_batch(arrs, self.input_size)
        x = normalize_images(torch.from_numpy(batch).to(self.device), torch.float32,
                             imagenet=self.imagenet)
        quantize_model(self.model, [x], skip=skip, percentile=percentile)

    def _demo_inputs(self, metas: list[dict], pad_to: int):
        """reference_demo's per-image (ratio, pads, original (w, h)) tensors,
        padded with (1, (0, 0), (1, 1)) up to ``pad_to``."""
        n = len(metas)
        ratios = np.asarray([float(m["scale"]) for m in metas] + [1.0] * (pad_to - n), np.float32)
        pads = np.asarray([m["pad"] for m in metas] + [(0, 0)] * (pad_to - n), np.float32)
        ori_wh = np.asarray([(m["orig_hw"][1], m["orig_hw"][0]) for m in metas]
                            + [(1, 1)] * (pad_to - n), np.float32)
        return [torch.from_numpy(a).to(self.device) for a in (ratios, pads, ori_wh)]

    def _predict_batch_demo(self, batch: np.ndarray, metas: list[dict], n: int) -> list[dict]:
        """reference_demo: the program returns boxes in ORIGINAL pixels; the
        host only strips the padding."""
        det = self.infer_demo(torch.from_numpy(batch).to(self.device),
                              *self._demo_inputs(metas, batch.shape[0]))
        boxes, scores, classes, valid = (t.cpu().numpy() for t in det)
        return [{"boxes": boxes[i][valid[i]], "scores": scores[i][valid[i]],
                 "classes": classes[i][valid[i]]} for i in range(n)]

    def _predict_batch_canvas(self, images: Sequence[np.ndarray | str]) -> list[dict]:
        """device_letterbox: the host decodes (JPEGs reduced, as fast_decode
        does) into a fixed uint8 canvas; the card letterboxes, normalizes and
        infers (`infer_canvas`)."""
        n = len(images)
        arrs, origs = [], []
        for im in images:
            if isinstance(im, str):
                a, ohw = imread_rgb_scaled(im, self.input_size)
            else:
                a, ohw = im, im.shape[:2]
            arrs.append(a)
            origs.append(ohw)
        canvas, sizes = self._pad_to_bucket(*pack_canvas(arrs, *self.canvas_hw))
        det, scales, pads = self.infer_canvas(torch.from_numpy(canvas).to(self.device),
                                              torch.from_numpy(sizes).to(self.device))
        boxes, scores, classes, valid = (t.cpu().numpy() for t in det)
        scales, pads = scales.cpu().numpy(), pads.cpu().numpy()
        out = []
        for i in range(n):
            oh, ow = origs[i]
            # the card's content -> letterbox scale, chained with the reduced
            # decode's and the canvas pre-shrink's, back to ORIGINAL pixels
            sx = float(scales[i, 0]) * float(sizes[i, 1]) / ow
            sy = float(scales[i, 1]) * float(sizes[i, 0]) / oh
            v = valid[i]
            out.append({"boxes": scale_coords(boxes[i][v], (sx, sy),
                                              (int(pads[i, 0]), int(pads[i, 1])), (oh, ow)),
                        "scores": scores[i][v], "classes": classes[i][v]})
        return out

    def _predict_tta(self, images: Sequence[np.ndarray | str]) -> list[dict]:
        """Horizontal-flip test-time augmentation: predict on the images and
        on their mirrors (a ``HorizontalFlip(p=1)`` `Augmentation`), replay
        the same flip on the mirrors' boxes (a flip is its own inverse), and
        merge both candidate sets with one class-aware greedy NMS."""
        arrs = [imread_rgb(im) if isinstance(im, str) else im for im in images]
        base = self.predict_batch(arrs)
        flipped, augs = [], []
        for a in arrs:
            aug = Augmentation([HorizontalFlip(p=1.0)], mode="detect")
            f, _ = aug(a, labels=np.zeros((0, 5), np.float32))
            flipped.append(f)
            augs.append(aug)
        out = []
        for r, rf, aug, f in zip(base, self.predict_batch(flipped), augs, flipped):
            lab = np.concatenate([rf["classes"][:, None].astype(np.float32),
                                  rf["boxes"].astype(np.float32)], axis=1)
            _, lab_back = aug.replay(f, lab)
            out.append(_merge_tta(
                np.concatenate([r["boxes"], lab_back[:, 1:5]], axis=0),
                np.concatenate([r["scores"], rf["scores"]], axis=0),
                np.concatenate([r["classes"], lab_back[:, 0].astype(r["classes"].dtype)]),
                self.iou_thres, self.max_det))
        return out

    def predict_image(self, image: np.ndarray | str, tta: bool = False) -> dict:
        return self.predict_batch([image], tta=tta)[0]

    def predict_dir(self, directory: str) -> Iterator[tuple[str, dict]]:
        """Batched inference over all images in a directory (JPEG, PNG and
        BMP files, read by `data.dataset.imread_rgb`)."""
        paths = sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.lower().endswith(IMG_EXTS)
        )
        for i in range(0, len(paths), self.batch_size):
            chunk = paths[i : i + self.batch_size]
            yield from zip(chunk, self.predict_batch(chunk))

    # ------------------------------------------------------------------
    def _loader(self, dataset, max_boxes: int, num_workers: int = 0,
                worker_backend: str = "thread", emit: str | None = None) -> DetectionLoader:
        if emit is None:
            emit = "i420" if self.input_format == "i420" else "rgb"
        return DetectionLoader(dataset, self.input_size, self.batch_size, max_boxes=max_boxes,
                               train=False, drop_last=False, pad_value=self.pad_value,
                               num_workers=num_workers, worker_backend=worker_backend, emit=emit)

    def _batches(self, loader: DetectionLoader, device_keys=("images",)) -> Iterator[dict]:
        """The loader's epoch on the device; its fused-decode fallbacks are
        added to ``i420_fallbacks`` and its pools stopped at the end."""
        try:
            yield from prefetch_to_device(loader.epoch(0), device=self.device,
                                          device_keys=device_keys)
        finally:
            self.i420_fallbacks += loader.fallbacks
            loader.close()

    def predict_video(self, video_path: str, out_path: str | None = None,
                      frame_callback=None, max_frames: int | None = None) -> int:
        """Batched frame-loop inference over a video file; -> frames processed.

        A reader thread decodes ahead (`data.avi.open_video`: Motion-JPEG AVIs
        and MPEG-4 Part 2 in AVI / MP4 / MOV without cv2, other codecs with
        cv2) into a queue of at most
        ``2 * batch_size`` RGB frames; the frames run through `predict_batch`
        up to ``batch_size`` at a time, so decode overlaps the device. Per
        frame, in order: ``frame_callback(rgb, result)``, and with
        ``out_path`` the frame with its detections drawn and written by
        `data.mp4.VideoWriter` (the port's MPEG-4 Part 2 intra encoder, on
        its own threads, in an ``mp4v`` ``.mp4``, cv2 or not) at the
        source's fps (25 where it has none). A
        frame that does not decode raises here, after the frames before it
        were processed; the file then holds those frames."""
        import queue
        import threading

        from ..viz import draw_detections

        video = open_video(video_path)
        q: queue.Queue = queue.Queue(maxsize=2 * self.batch_size)
        stop = threading.Event()
        failed: list[BaseException] = []

        def reader():
            try:
                frames, n = video.frames(), 0
                while not stop.is_set() and (max_frames is None or n < max_frames):
                    frame = next(frames, None)
                    if frame is None:
                        break
                    q.put(frame)
                    n += 1
            except BaseException as e:  # re-raised by the consumer, never swallowed
                failed.append(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=reader, daemon=True)
        thread.start()
        writer, count, done = None, 0, False
        try:
            while not done:
                frames = []
                while len(frames) < self.batch_size:
                    item = q.get()
                    if item is None:
                        done = True
                        break
                    frames.append(item)
                if not frames:
                    break
                for rgb, res in zip(frames, self.predict_batch(frames)):
                    if frame_callback is not None:
                        frame_callback(rgb, res)
                    if out_path is not None:
                        drawn = draw_detections(rgb, res["boxes"], res["scores"], res["classes"],
                                                self.class_names)
                        if writer is None:
                            writer = VideoWriter(out_path, video.fps or 25,
                                                 (drawn.shape[1], drawn.shape[0]))
                        writer.write(drawn)
                    count += 1
            if failed:
                raise failed[0]
            if writer is not None:
                writer.close()  # the pending frames written, or an encoder error raised
        finally:
            stop.set()
            try:  # unblock a reader waiting on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=10)
            video.release()
            if writer is not None:
                writer.close()  # after a failure: the frames before it
        return count

    def predict_dataset(self, dataset, fast_decode: bool | None = None, num_workers: int = 0,
                        worker_backend: str = "process") -> Iterator[tuple[dict, np.ndarray]]:
        """Prefetch-overlapped inference over a DetectionDataset: the host
        loads batch k + 1 on a background thread while the device runs
        batch k. Yields ({boxes, scores, classes, id} in original pixels,
        the image's pixel-xyxy GT [n, 5]).

        ``fast_decode`` (default: the detector's) decodes JPEGs at least 2x
        larger than the input reduced (``DetectionDataset.decode_size``), GT
        rescaled with them. With ``input_format='i420'`` the loader sends
        packed I420, JPEGs through the fused decode."""
        if fast_decode is None:
            fast_decode = self.fast_decode
        demo = self.postprocess_mode == "reference_demo"
        if demo and fast_decode:
            raise ValueError("postprocess_mode='reference_demo' needs scalar letterbox "
                             "scales; disable fast_decode")

        def with_fast_decode(ds):
            if getattr(ds, "decode_size", None) is None and hasattr(ds, "images_dir"):
                ds = copy.copy(ds)
                ds.decode_size = self.input_size
            return ds

        if fast_decode:
            dataset = (_Subset(with_fast_decode(dataset.ds), dataset.n)
                       if isinstance(dataset, _Subset) else with_fast_decode(dataset))
        loader = self._loader(dataset, 1, num_workers, worker_backend)
        for batch in self._batches(loader):
            if demo:
                det = self.infer_demo(batch["images"],
                                      *self._demo_inputs(batch["meta"], self.batch_size))
            else:
                det = self.infer(batch["images"])
            boxes, scores, classes, valid = (t.cpu().numpy() for t in det)
            for i in range(batch["num_real"]):
                meta, v = batch["meta"][i], valid[i]
                b = boxes[i][v] if demo else scale_coords(boxes[i][v], meta["scale"],
                                                         meta["pad"], meta["orig_hw"])
                yield ({"boxes": b, "scores": scores[i][v], "classes": classes[i][v],
                        "id": meta["id"]}, meta["gt_pixels"])

    def _evaluate_tta(self, ds, m: MeanAveragePrecision, num_workers: int) -> None:
        """Each batch runs `infer_tta`; the mirror's boxes are mirrored back
        in INPUT space (x -> S - x), both sets unscaled with the one
        letterbox meta and merged with `_predict_tta`'s greedy NMS."""
        B, size = self.batch_size, float(self.input_size)
        for batch in self._batches(self._loader(ds, 1, num_workers)):
            boxes, scores, classes, valid = (t.cpu().numpy()
                                             for t in self.infer_tta(batch["images"]))
            for i in range(batch["num_real"]):
                meta = batch["meta"][i]
                v0, vf = valid[i], valid[B + i]
                fb = boxes[B + i][vf]
                fb = np.stack([size - fb[:, 2], fb[:, 1], size - fb[:, 0], fb[:, 3]], axis=1)
                merged = _merge_tta(
                    scale_coords(np.concatenate([boxes[i][v0], fb]), meta["scale"],
                                 meta["pad"], meta["orig_hw"]),
                    np.concatenate([scores[i][v0], scores[B + i][vf]]),
                    np.concatenate([classes[i][v0], classes[B + i][vf]]),
                    self.iou_thres, self.max_det)
                gt = meta["gt_pixels"]
                m.update(merged["boxes"], merged["scores"], merged["classes"], gt[:, 1:5],
                         gt[:, 0])

    def _evaluate_device(self, ds, m: MeanAveragePrecision, num_workers: int,
                         max_boxes: int) -> None:
        """Images and padded labels go to the device; one `infer_match` per
        batch returns the correct-matrices; the host strips padding."""
        for batch in self._batches(self._loader(ds, max_boxes, num_workers),
                                   device_keys=("images", "labels")):
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
        same-class predictions overlap one GT (`ops.map.match_predictions_device`);
        it takes the standard postprocess without TTA only. ``tta``:
        horizontal-flip test-time augmentation (`_evaluate_tta`).
        ``metric_file``: append a reference-style table row. ``save_json``:
        write every detection as COCO results JSON (host matching, no TTA),
        with ``coco_ids`` mapping the 80 classes to the annotation ids 1..90.
        ``max_images``: the first n images only."""
        if save_json and (tta or device_matching):
            raise ValueError("save_json needs original-pixel boxes on the host: use the "
                             "plain eval path (tta=False, device_matching=False)")
        if device_matching and (tta or self.postprocess_mode != "standard"):
            raise ValueError("device_matching supports the standard postprocess path "
                             "without TTA only")
        m = MeanAveragePrecision()
        n = len(dataset) if max_images is None else min(len(dataset), max_images)
        ds = dataset if n == len(dataset) else _Subset(dataset, n)
        t0 = time.perf_counter()
        if tta:
            self._evaluate_tta(ds, m, num_workers)
        elif device_matching:
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
        pass: each batch is loaded (as RGB, whatever the input format, as in
        the JAX package), uploaded and run through the model once, then each
        point's NMS runs on the device-resident predictions and its boxes
        are matched on the host. -> one {conf, iou, map50, map, images} per
        point; ``metric_file`` gets one table row each."""
        if self.multi_label:
            raise ValueError("evaluate_sweep requires the single-label NMS path "
                             "(multi_label=False)")
        if self.postprocess_mode != "standard":
            raise ValueError("evaluate_sweep supports postprocess_mode='standard' only")
        points = [(float(c), float(i)) for c, i in points]
        n = len(dataset) if max_images is None else min(len(dataset), max_images)
        ds = dataset if n == len(dataset) else _Subset(dataset, n)
        metrics = [MeanAveragePrecision() for _ in points]
        for batch in self._batches(self._loader(ds, 1, emit="rgb")):
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
        """A video file (``data.video_sampler.load_clip``: Motion-JPEG AVIs and
        MPEG-4 Part 2 in AVI / MP4 / MOV without cv2, other codecs with cv2)
        -> `predict_clip` of
        ``num_frames`` frames drawn by ``strategy``."""
        from ..data.video_sampler import load_clip

        return self.predict_clip(load_clip(path, self.num_frames, self.strategy, self.size, rng))
