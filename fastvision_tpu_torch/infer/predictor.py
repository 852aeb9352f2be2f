"""Detector: batched YOLO inference over images and directories (port of
fastvision_tpu/infer/predictor.py::Detector, standard postprocess, RGB input).

The host letterboxes and stacks a uint8 batch; the device normalizes, runs
the model (bf16 autocast by default, float32 parameters and BN statistics),
decodes in the heads' dtype, and runs class-offset greedy NMS in float32,
whose suppression is the hand-written CUDA kernel on the card; the host
unscales the kept boxes to original pixels.

Not ported yet: multi_label NMS, packed-I420 input, device letterbox,
fast_decode, TTA, the reference_demo postprocess, quantize, video,
predict_dataset and the evaluate* methods.
"""
from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np
import torch
from torch import nn

from ..data.dataset import IMG_EXTS
from ..data.pipeline import normalize_images
from ..device import resolve_device
from ..ops.nms import Detections, batched_non_max_suppression, class_offset_for
from .decode import decode_predictions
from .postprocess import scale_coords
from .preprocess import preprocess_batch


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
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
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
        # decoded boxes can spill past the canvas (v5 wh up to 4x anchor)
        self.class_offset = class_offset_for(3.0 * input_size)

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
    def infer(self, images_u8: torch.Tensor) -> Detections:
        """Device uint8 [B, S, S, 3] -> Detections in input-space pixels."""
        pred = self.predecode(images_u8)
        return batched_non_max_suppression(
            pred.float(), conf_thres=self.conf_thres, iou_thres=self.iou_thres,
            max_det=self.max_det, class_offset=self.class_offset)

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
