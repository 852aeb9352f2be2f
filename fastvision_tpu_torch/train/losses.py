"""Losses (port of fastvision_tpu/train/losses.py): cross-entropy, soft
cross-entropy, BCE (on logits or probabilities), focal and binary focal, the
IoU-family loss, smooth-L1, the dense YOLOv3 target assignment,
``YOLOv3Loss`` and the per-cell ``YOLOv3LossPerCell``.

Labels arrive padded [B, M, 5] = (class, cx, cy, w, h) with NORMALIZED xywh
and class == -1 marking padding. Targets are built by a dense scatter into
per-image [H * W * A] grids; unmatched candidates go to a sentinel slot past
the end, which is dropped.

Two ground truths can claim the same (cell, anchor) slot. ``index_put_``
and ``scatter_`` leave the winner of duplicate indices undefined, on CUDA per
element, so a box could come from one GT and its class from another. The
port picks the winner explicitly, the candidate with the highest flat index
(GT-major, then anchor, then candidate cell), and gathers its whole row:
box, class and positive flag always come from one GT. XLA's CPU scatter
applies updates in order, so the last (highest) index is also its winner.

Inside `core.distributed.data_parallel` with W > 1 ranks, each holding an
equal share of the global batch, a loss is this rank's share of the global
batch's loss, scaled by W: the denominators that count the batch (the
positives of a masked mean, the weights of a weighted mean, the batch size
that ``YOLOv3Loss`` multiplies by) are the global ones, all-reduced without
gradient, so the ranks' losses average to the global loss and their
gradients, averaged by data parallelism, to its gradient. A plain mean over
the local share is already that.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.distributed import dp_world, global_sum
from ..core.telemetry import span
from ..ops.grid import grid as make_grid
from ..ops.iou import box_iou, box_iou_matrix, wh_iou_matrix
from ..ops.one_hot import one_hot

_EPS = 1e-8


def _reduce(loss: torch.Tensor, weights, reduction: str) -> torch.Tensor:
    if weights is not None:
        loss = loss * weights
    if reduction == "mean":
        if weights is not None:
            total = global_sum(torch.as_tensor(weights, device=loss.device).sum())
            return loss.sum() * dp_world() / (total + _EPS)
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def binary_cross_entropy(preds: torch.Tensor, targets: torch.Tensor, from_logits: bool = True,
                         weights=None, reduction: str = "mean") -> torch.Tensor:
    """Elementwise BCE. On logits in the stable form max(x, 0) - x * t +
    log(1 + exp(-|x|)); ``from_logits=False`` takes probabilities, clipped
    to [1e-8, 1 - 1e-8] in their dtype first (float32: the upper clip is 1)."""
    targets = targets.to(preds.dtype)
    if from_logits:
        loss = preds.clamp(min=0) - preds * targets + torch.log1p(torch.exp(-preds.abs()))
    else:
        p = preds.clamp(_EPS, 1 - _EPS)
        loss = -targets * torch.log(p) - (1 - targets) * torch.log(1 - p)
    return _reduce(loss, weights, reduction)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weights=None,
                  reduction: str = "mean") -> torch.Tensor:
    """Softmax cross-entropy over integer labels [...] and logits [..., C]."""
    target = one_hot(labels, logits.shape[-1], logits.dtype)
    return soft_cross_entropy(logits, target, weights, reduction)


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor, weights=None,
                       reduction: str = "mean") -> torch.Tensor:
    """Cross-entropy against a target distribution [..., C] (one-hot gives
    `cross_entropy`)."""
    logp = torch.log_softmax(logits, dim=-1)
    return _reduce(-(target_probs.to(logp.dtype) * logp).sum(dim=-1), weights, reduction)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0, weights=None, reduction: str = "mean") -> torch.Tensor:
    """Per-class sigmoid focal loss over integer labels, summed over classes."""
    target = one_hot(labels, logits.shape[-1], logits.dtype)
    p = torch.sigmoid(logits)
    ce = binary_cross_entropy(logits, target, reduction="none")
    p_t = p * target + (1 - p) * (1 - target)
    alpha_t = alpha * target + (1 - alpha) * (1 - target)
    return _reduce((alpha_t * (1 - p_t) ** gamma * ce).sum(dim=-1), weights, reduction)


def binary_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float | None = None,
                      gamma: float = 2.0, weights=None, reduction: str = "mean") -> torch.Tensor:
    """Sigmoid focal loss on a single logit (RetinaNet form); ``alpha=None``
    leaves out the class weighting, as the Faster R-CNN RPN trains."""
    targets = targets.to(logits.dtype)
    ce = binary_cross_entropy(logits, targets, reduction="none")
    p = torch.sigmoid(logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = (1 - p_t) ** gamma * ce
    if alpha is not None:
        loss = loss * (alpha * targets + (1 - alpha) * (1 - targets))
    return _reduce(loss, weights, reduction)


def iou_loss(pred_boxes: torch.Tensor, target_boxes: torch.Tensor, kind: str = "ciou",
             fmt: str = "xyxy", weights=None, reduction: str = "mean") -> torch.Tensor:
    """1 - IoU-family (`ops.iou.box_iou`: 'iou', 'giou', 'diou', 'ciou';
    boxes 'xyxy' or 'xywh') between paired boxes [..., 4]."""
    loss = 1.0 - box_iou(pred_boxes, target_boxes, kind=kind, fmt=fmt)
    return _reduce(loss, weights, reduction)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0, weights=None,
              reduction: str = "mean") -> torch.Tensor:
    """Huber / smooth-L1, summed over the last axis when there is more than one."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)
    if loss.ndim > 1:
        loss = loss.sum(dim=-1)
    return _reduce(loss, weights, reduction)


class YoloLossOutput(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    obj: torch.Tensor
    cls: torch.Tensor


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` where ``mask`` (a target: no gradient) is set, over the
    global batch's mask under data parallelism."""
    return (x * mask).sum() * dp_world() / (global_sum(mask.sum().detach()) + _EPS)


def _dense_targets(labels: torch.Tensor, anchors_feat: torch.Tensor, grid_hw: tuple[int, int],
                   ratio_thres: float | None = None, neighbor_cells: bool = False) -> dict:
    """Target assignment for one level.

    labels [B, M, 5] (cls, cxn, cyn, wn, hn), cls < 0 = padding;
    anchors_feat [A, 2] in feature units; grid_hw (H, W).
    ratio_thres: match every anchor whose wh ratio to the GT is below it;
      None: only the best anchor per GT by wh-IoU.
    neighbor_cells: each GT also trains the two nearest neighbour cells
      (offset targets in (-0.5, 1.5); needs the v5 decode).

    Returns dense [B, H, W, A, ...] targets: ``pos`` (float 0/1), ``box``
    (offset_x, offset_y, w_feat, h_feat), ``cls`` (int64), ``anchor``,
    plus ``gt_xywh_feat`` [B, M, 4] and ``gt_valid`` [B, M]."""
    h, w = grid_hw
    b, m, _ = labels.shape
    a = anchors_feat.shape[0]
    dev, dt = labels.device, labels.dtype
    valid = labels[..., 0] >= 0  # [B, M]
    cls_idx = labels[..., 0].to(torch.int32).clamp(min=0)
    scale = torch.tensor([w, h], dtype=dt, device=dev)
    txy = labels[..., 1:3] * scale  # feature coords
    twh = labels[..., 3:5] * scale

    if ratio_thres is not None:
        r = twh[:, :, None, :] / anchors_feat[None, None, :, :]  # [B, M, A, 2]
        match = torch.maximum(r, 1.0 / r).amax(dim=-1) < ratio_thres  # [B, M, A]
    else:
        sim = wh_iou_matrix(twh.reshape(-1, 2), anchors_feat).reshape(b, m, a)
        match = one_hot(sim.argmax(dim=-1), a).bool()
    match = match & valid[..., None]

    # candidate cells: the centre (+ the 2 nearest neighbours when enabled)
    gx0, gy0 = torch.floor(txy[..., 0]), torch.floor(txy[..., 1])  # [B, M]
    fx, fy = txy[..., 0] - gx0, txy[..., 1] - gy0
    if neighbor_cells:
        # ultralytics build_targets: west/east by x-fraction, north/south by y
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        cand_dx = torch.stack([z, -o, o, z, z], dim=-1)  # [B, M, 5]
        cand_dy = torch.stack([z, z, z, -o, o], dim=-1)
        in_x, in_y = txy[..., 0], txy[..., 1]
        cand_ok = torch.stack([
            torch.ones_like(fx, dtype=torch.bool),
            (fx < 0.5) & (in_x > 1.0),  # west
            (fx > 0.5) & (in_x < w - 1.0),  # east
            (fy < 0.5) & (in_y > 1.0),  # north
            (fy > 0.5) & (in_y < h - 1.0),  # south
        ], dim=-1)
    else:
        cand_dx = cand_dy = torch.zeros_like(fx)[..., None]
        cand_ok = torch.ones_like(fx, dtype=torch.bool)[..., None]
    c = cand_ok.shape[-1]

    gx = (gx0[..., None] + cand_dx).clamp(0, w - 1).to(torch.int64)  # [B, M, C]
    gy = (gy0[..., None] + cand_dy).clamp(0, h - 1).to(torch.int64)
    # offset target relative to the candidate cell: in (-0.5, 1.5) for neighbours
    off = torch.stack([txy[..., 0:1] - gx.to(dt), txy[..., 1:2] - gy.to(dt)], dim=-1)

    # (match [B, M, A]) x (candidates [B, M, C]) -> [B, M, A, C]
    match_ac = match[..., :, None] & cand_ok[..., None, :]
    aidx = torch.arange(a, device=dev)[None, None, :, None]
    size = h * w * a
    flat = (gy[:, :, None, :] * w + gx[:, :, None, :]) * a + aidx  # [B, M, A, C]
    flat = torch.where(match_ac, flat, size)  # the sentinel slot, dropped below

    n = m * a * c
    vals = torch.cat([
        off[:, :, None].expand(b, m, a, c, 2).to(torch.float32),
        twh[:, :, None, None].expand(b, m, a, c, 2).to(torch.float32),
        cls_idx[:, :, None, None, None].expand(b, m, a, c, 1).to(torch.float32),
        torch.ones((b, m, a, c, 1), dtype=torch.float32, device=dev),
    ], dim=-1).reshape(b, n, 6)
    # one winner per slot: the highest candidate index, whose whole row is taken
    src = torch.arange(n, device=dev).expand(b, n)
    winner = torch.full((b, size + 1), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce_(1, flat.reshape(b, n), src, "amax")[:, :size]
    hit = winner >= 0
    dense = vals.gather(1, winner.clamp(min=0)[..., None].expand(b, size, 6))
    dense = torch.where(hit[..., None], dense, 0.0).reshape(b, h, w, a, 6)
    return {
        "pos": dense[..., 5],
        "box": dense[..., :4],
        "cls": dense[..., 4].to(torch.int64),
        "anchor": anchors_feat.expand(b, h, w, a, 2),
        "gt_xywh_feat": torch.cat([txy, twh], dim=-1),
        "gt_valid": valid,
    }


class YOLOv3Loss:
    """wh-ratio < ``ratio_thres`` multi-anchor match, CIoU box loss, BCE
    class loss, objectness BCE against the detached IoU at positives; the
    total is scaled by the batch size.

    decode_style 'v3' decodes sigma-xy / exp-wh; 'v5' (default) decodes
    2 * sig - 0.5 / (2 * sig)^2. Heads are taken in float32 whatever the
    model's dtype. Each level's target assignment is a ``loss.targets``
    span (`core.telemetry.span`)."""

    def __init__(
        self,
        anchors,  # [L, A, 2] input-image pixels, deepest level first
        strides: Sequence[int] = (32, 16, 8),
        num_classes: int = 80,
        ratio_box: float = 0.05,
        ratio_conf: float = 1.0,
        ratio_cls: float = 0.5,
        ratio_thres: float = 4.0,
        decode_style: str = "v5",
        level_balance: Sequence[float] | None = None,
        neighbor_cells: bool = False,
    ):
        if decode_style not in ("v5", "v3"):
            raise ValueError("decode_style must be 'v5' or 'v3'")
        self.anchors = np.asarray(anchors, np.float32)
        self.strides = tuple(strides)
        self.num_classes = num_classes
        self.ratio_box = ratio_box
        self.ratio_conf = ratio_conf
        self.ratio_cls = ratio_cls
        self.ratio_thres = ratio_thres
        self.decode_style = decode_style
        self.level_balance = tuple(level_balance) if level_balance else (1.0,) * len(strides)
        self.neighbor_cells = neighbor_cells
        self._anchors_feat: dict[torch.device, torch.Tensor] = {}

    def anchors_feat(self, device: torch.device) -> torch.Tensor:
        """[L, A, 2] anchors in feature units on ``device`` (copied once)."""
        t = self._anchors_feat.get(device)
        if t is None:
            strides = np.asarray(self.strides, np.float32)[:, None, None]
            t = torch.from_numpy(self.anchors / strides).to(device)
            self._anchors_feat[device] = t
        return t

    def _decode_cell(self, head: torch.Tensor, anchors_feat: torch.Tensor):
        """Raw head [..., 4] -> (xy in the cell frame, wh in feature units)."""
        if self.decode_style == "v3":
            pxy = torch.sigmoid(head[..., 0:2])
            pwh = torch.exp(head[..., 2:4].clamp(-9.0, 9.0)) * anchors_feat
        else:
            sig = torch.sigmoid(head[..., 0:4])
            pxy = sig[..., 0:2] * 2.0 - 0.5
            pwh = (sig[..., 2:4] * 2.0) ** 2 * anchors_feat
        return pxy, pwh

    def __call__(self, heads: Sequence[torch.Tensor], labels: torch.Tensor) -> YoloLossOutput:
        """heads: per-level [B, H, W, A, 5 + C]; labels: [B, M, 5] padded."""
        batch = heads[0].shape[0] * dp_world()  # the global batch
        anchors = self.anchors_feat(heads[0].device)
        labels = labels.to(torch.float32)
        loss_box = loss_obj = loss_cls = 0.0
        for li, head in enumerate(heads):
            head = head.float()
            _, h, w, a, _ = head.shape
            with span("loss.targets"):
                t = _dense_targets(labels, anchors[li], (h, w), ratio_thres=self.ratio_thres,
                                   neighbor_cells=self.neighbor_cells)
            pos = t["pos"]

            pxy, pwh = self._decode_cell(head, t["anchor"])
            pred_xywh = torch.cat([pxy, pwh], dim=-1)
            ciou = box_iou(pred_xywh, t["box"], kind="ciou", fmt="xywh")  # [B, H, W, A]
            loss_box = loss_box + _masked_mean(1.0 - ciou, pos)

            # objectness target = the detached IoU at positives
            iou_t = box_iou(pred_xywh, t["box"], kind="iou", fmt="xywh").clamp(0.0, 1.0).detach()
            obj_bce = binary_cross_entropy(head[..., 4], iou_t * pos, reduction="none")
            loss_obj = loss_obj + obj_bce.mean() * self.level_balance[li]

            cls_target = one_hot(t["cls"], self.num_classes)
            cls_bce = binary_cross_entropy(head[..., 5:], cls_target, reduction="none")
            # per-element mean over positives
            loss_cls = loss_cls + _masked_mean(cls_bce.mean(dim=-1), pos)

        total = (self.ratio_box * loss_box + self.ratio_conf * loss_obj
                 + self.ratio_cls * loss_cls) * batch
        return YoloLossOutput(total, self.ratio_box * loss_box * batch,
                              self.ratio_conf * loss_obj * batch,
                              self.ratio_cls * loss_cls * batch)


class YOLOv3LossPerCell:
    """The demo recipe's loss: the best anchor per GT by wh-IoU; the box term
    BCE of the sigmoid-xy offsets plus MSE of log(wh / anchor), the xy part
    weighted by ``lambda_xy`` ('bce_mse'), or CIoU of the decoded boxes
    ('ciou'); objectness BCE over every cell except the negatives whose
    decoded box overlaps a GT above ``ignore_iou_thres`` (the ignore mask);
    class BCE at positives. The parts are per-level means summed over the
    levels, not scaled by the batch. Heads are taken in float32."""

    def __init__(
        self,
        anchors,
        strides: Sequence[int] = (32, 16, 8),
        num_classes: int = 80,
        box_loss: str = "bce_mse",  # 'bce_mse' | 'ciou'
        ignore_iou_thres: float = 0.5,
        lambda_xy: float = 2.0,
        lambda_wh: float = 1.0,
        lambda_conf: float = 1.0,
        lambda_cls: float = 1.0,
    ):
        if box_loss not in ("bce_mse", "ciou"):
            raise ValueError("box_loss must be 'bce_mse' or 'ciou'")
        self.anchors = np.asarray(anchors, np.float32)
        self.strides = tuple(strides)
        self.num_classes = num_classes
        self.box_loss = box_loss
        self.ignore_iou_thres = ignore_iou_thres
        self.lams = (lambda_xy, lambda_wh, lambda_conf, lambda_cls)
        self._anchors_feat: dict[torch.device, torch.Tensor] = {}

    anchors_feat = YOLOv3Loss.anchors_feat

    def _ignore(self, pred_xywh: torch.Tensor, t: dict) -> torch.Tensor:
        """[B, H, W, A] bool: the decoded box overlaps a valid GT above the
        threshold. A comparison: no gradient flows through it."""
        b, h, w, a, _ = pred_xywh.shape
        with torch.no_grad():
            iou = box_iou_matrix(pred_xywh.detach().reshape(b, h * w * a, 4),
                                 t["gt_xywh_feat"], kind="iou", fmt="xywh")  # [B, HWA, M]
            iou = torch.where(t["gt_valid"][:, None, :], iou, 0.0)
            return (iou.amax(dim=-1) > self.ignore_iou_thres).reshape(b, h, w, a)

    def __call__(self, heads: Sequence[torch.Tensor], labels: torch.Tensor) -> YoloLossOutput:
        """heads: per-level [B, H, W, A, 5 + C]; labels: [B, M, 5] padded."""
        lam_xy, lam_wh, lam_conf, lam_cls = self.lams
        anchors = self.anchors_feat(heads[0].device)
        labels = labels.to(torch.float32)
        loss_box = loss_obj = loss_cls = 0.0
        for li, head in enumerate(heads):
            head = head.float()
            b, h, w, a, _ = head.shape
            t = _dense_targets(labels, anchors[li], (h, w), ratio_thres=None)
            pos = t["pos"]

            # decoded predictions in feature units (the v3 decode)
            offsets = make_grid(h, w, "xy", head.dtype, head.device)[None, :, :, None, :]
            pxy_cell = torch.sigmoid(head[..., 0:2])
            pwh = torch.exp(head[..., 2:4].clamp(-9.0, 9.0)) * t["anchor"]
            pred_xywh = torch.cat([pxy_cell + offsets, pwh], dim=-1)

            if self.box_loss == "bce_mse":
                # per-element means over positives
                xy_bce = binary_cross_entropy(head[..., 0:2], t["box"][..., 0:2],
                                              reduction="none")
                loss_box = loss_box + lam_xy * _masked_mean(xy_bce.mean(dim=-1), pos)
                # empty cells: log(eps / anchor) * 0, finite
                t_wh_raw = torch.log(t["box"][..., 2:4].clamp(min=_EPS) / t["anchor"]) * pos[..., None]
                wh_mse = (head[..., 2:4] - t_wh_raw) ** 2
                loss_box = loss_box + lam_wh * _masked_mean(wh_mse.mean(dim=-1), pos)
            else:
                t_xywh_abs = torch.cat([t["box"][..., 0:2] + offsets * pos[..., None],
                                        t["box"][..., 2:4]], dim=-1)
                ciou = box_iou(pred_xywh, t_xywh_abs, kind="ciou", fmt="xywh")
                loss_box = loss_box + _masked_mean(1.0 - ciou, pos)

            obj_weight = torch.where((pos == 0) & self._ignore(pred_xywh, t), 0.0, 1.0)
            obj_bce = binary_cross_entropy(head[..., 4], pos, reduction="none")
            loss_obj = loss_obj + lam_conf * _masked_mean(obj_bce, obj_weight)

            cls_bce = binary_cross_entropy(head[..., 5:], one_hot(t["cls"], self.num_classes),
                                           reduction="none")
            loss_cls = loss_cls + lam_cls * _masked_mean(cls_bce.mean(dim=-1), pos)

        return YoloLossOutput(loss_box + loss_obj + loss_cls, loss_box, loss_obj, loss_cls)
