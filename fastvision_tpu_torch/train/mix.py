"""Classification batch mixing on the device: label smoothing, mixup, cutmix
(port of fastvision_tpu/train/mix.py).

  - the mix runs inside the train step (`make_train_step`'s
    ``batch_transform``), on the uint8 batch already on the card; the mixed
    images are float32 pixels, normalized by the step as uint8 ones are;
  - the partner of each image is the batch reversed along axis 0, as in
    the JAX package;
  - the step's scalar draws (mixup or cutmix, lam, the cutmix window's
    centre) come from a numpy Generator on the host, which the step seeds
    from (``transform_seed``, step), so the card and the CPU see the same
    draws, nothing waits for the card, and a resumed run repeats them.
    (``torch.Generator`` has no Beta sampler; numpy's has.) A test can pass
    the JAX package's draws instead (`MixDraws`);
  - the cutmix window is a mask computed in float32 as the JAX package
    computes it, and the targets blend by its realised area.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.one_hot import one_hot


@dataclasses.dataclass(frozen=True)
class MixDraws:
    """One step's draws: ``mixup`` (True: mixup, False: cutmix), ``lam``
    (the Beta(alpha, alpha) draw) and, for cutmix, the window's centre
    ``cy`` / ``cx`` as fractions of the height and width, in [0, 1)."""

    mixup: bool
    lam: float
    cy: float = 0.0
    cx: float = 0.0


def smooth_labels(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Integer labels -> (smoothed) one-hot: on = 1 - s + s / K, off = s / K."""
    one = one_hot(labels, num_classes, dtype)
    if smoothing <= 0.0:
        return one
    return one * (1.0 - smoothing) + smoothing / num_classes


def mixup(images: torch.Tensor, targets: torch.Tensor, lam: float):
    """Blend images and targets with the reversed batch by ``lam`` (rounded
    to float32, as are 1 - lam and the products). -> (mixed float32 images,
    mixed targets, lam)."""
    lam32 = np.float32(lam)
    a, b = float(lam32), float(np.float32(1.0) - lam32)
    imgs = images.float()
    return imgs * a + imgs.flip(0) * b, targets * a + targets.flip(0) * b, a


def cutmix(images: torch.Tensor, targets: torch.Tensor, lam: float, cy: float, cx: float):
    """Paste a window of the reversed batch into NHWC ``images``: sides
    sqrt(1 - lam) of the image's, centred at (cy * H, cx * W), clipped at
    the borders; targets blend by the REALISED area. -> (mixed float32
    images, mixed targets, lam_adj as a device scalar)."""
    h, w = images.shape[1], images.shape[2]
    # the window's bounds, in float32 as the JAX package computes them, are
    # host scalars: the mask is built on the device and nothing waits for it
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    half_h, half_w = np.float32(h) * ratio / np.float32(2), np.float32(w) * ratio / np.float32(2)
    cy32, cx32 = np.float32(cy) * np.float32(h), np.float32(cx) * np.float32(w)
    rows = torch.arange(h, dtype=torch.float32, device=images.device)
    cols = torch.arange(w, dtype=torch.float32, device=images.device)
    row_in = (rows >= float(cy32 - half_h)) & (rows < float(cy32 + half_h))
    col_in = (cols >= float(cx32 - half_w)) & (cols < float(cx32 + half_w))
    mask = row_in[:, None] & col_in[None, :]  # [H, W] True = the partner's pixel
    # the mean as XLA computes it: the sum times the float32 reciprocal of H W
    lam_adj = 1.0 - mask.float().sum() * float(np.float32(1.0) / np.float32(h * w))
    imgs = images.float()
    mixed = torch.where(mask[None, :, :, None], imgs.flip(0), imgs)
    return mixed, lam_adj * targets + (1.0 - lam_adj) * targets.flip(0), lam_adj


def make_classification_mix(num_classes: int, mixup_alpha: float = 0.0,
                            cutmix_alpha: float = 0.0, smoothing: float = 0.0,
                            switch_prob: float = 0.5):
    """Build ``batch_transform(batch, rng=None, draws=None) -> batch`` for
    `make_train_step`. The batch keeps its integer 'labels' (for accuracy)
    and gains 'soft', the (smoothed, mixed) targets for
    ``soft_cross_entropy``. With both alphas > 0 each step picks mixup with
    ``switch_prob``, else cutmix; with both 0 it is label smoothing alone.
    ``rng``: the step's numpy Generator; ``draws``: given `MixDraws`."""
    if not (mixup_alpha > 0 or cutmix_alpha > 0 or smoothing > 0):
        raise ValueError("enable at least one of mixup/cutmix/smoothing")

    def draw(rng: np.random.Generator) -> MixDraws | None:
        if mixup_alpha > 0 and cutmix_alpha > 0:
            use_mixup = bool(rng.uniform() < switch_prob)
        elif mixup_alpha > 0 or cutmix_alpha > 0:
            use_mixup = mixup_alpha > 0
        else:
            return None
        if use_mixup:
            return MixDraws(True, float(rng.beta(mixup_alpha, mixup_alpha)))
        lam = float(rng.beta(cutmix_alpha, cutmix_alpha))
        cy, cx = rng.uniform(size=2)
        return MixDraws(False, lam, float(cy), float(cx))

    def transform(batch: dict, rng: np.random.Generator | None = None,
                  draws: MixDraws | None = None) -> dict:
        soft = smooth_labels(batch["labels"], num_classes, smoothing)
        images = batch["images"]
        if draws is None:
            draws = draw(rng)
        if draws is not None:
            if draws.mixup:
                images, soft, _ = mixup(images, soft, draws.lam)
            else:
                images, soft, _ = cutmix(images, soft, draws.lam, draws.cy, draws.cx)
        return dict(batch, images=images, soft=soft)

    return transform
