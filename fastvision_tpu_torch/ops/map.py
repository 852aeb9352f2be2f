"""Mean average precision (mAP) over IoU thresholds (port of
fastvision_tpu/ops/map.py).

Per image, predictions are matched greedily to ground truths of their class
(pairs in descending IoU order, each prediction and each GT used at most
once) at every IoU threshold; AP per class from the PR curve by 101-point
COCO interpolation, the continuous VOC2009 area, or VOC2007's 11 points.
The matching runs on the host in numpy (`match_predictions`) or, batched,
on the tensors' device (`match_predictions_device`, whose correct-matrix
goes to `MeanAveragePrecision.update_matched`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def _box_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """All-pairs IoU for xyxy numpy boxes: [N,4] x [M,4] -> [N,M]."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


def match_predictions(
    pred_boxes: np.ndarray,
    pred_classes: np.ndarray,
    true_boxes: np.ndarray,
    true_classes: np.ndarray,
    iou_thresholds: np.ndarray,
) -> np.ndarray:
    """Correct-matrix for one image: [num_pred, num_thresholds] bool.

    correct[p, t] is True iff prediction p greedily matches some GT of the
    same class at IoU >= iou_thresholds[t] (each GT used at most once, pairs
    taken in descending-IoU order).
    """
    num_pred = pred_boxes.shape[0]
    correct = np.zeros((num_pred, len(iou_thresholds)), dtype=bool)
    if num_pred == 0 or true_boxes.shape[0] == 0:
        return correct
    iou = _box_iou_np(true_boxes, pred_boxes)  # [T, P]
    cls_ok = true_classes[:, None] == pred_classes[None, :]
    iou = np.where(cls_ok, iou, 0.0)
    for ti, thr in enumerate(iou_thresholds):
        t_idx, p_idx = np.nonzero(iou >= thr)
        if t_idx.size == 0:
            continue
        pair_iou = iou[t_idx, p_idx]
        order = np.argsort(-pair_iou)
        t_idx, p_idx = t_idx[order], p_idx[order]
        # unique prediction, then unique target (keep highest-IoU pair)
        keep = np.unique(p_idx, return_index=True)[1]
        t_idx, p_idx = t_idx[keep], p_idx[keep]
        keep = np.unique(t_idx, return_index=True)[1]
        correct[p_idx[keep], ti] = True
    return correct


def match_predictions_device(
    pred_boxes: torch.Tensor,
    pred_classes: torch.Tensor,
    pred_valid: torch.Tensor,
    true_boxes: torch.Tensor,
    true_classes: torch.Tensor,
    true_valid: torch.Tensor,
    iou_thresholds: torch.Tensor,
) -> torch.Tensor:
    """Batched correct-matrix on the tensors' device: [B, P, T] bool.

    The greedy "pairs by IoU descending, unique prediction, unique target"
    matching of `match_predictions` as two argmaxes: each prediction keeps
    its highest-IoU GT of its class (ties: the smallest GT index), then
    each GT keeps, among the predictions pointing at it, the one with the
    highest IoU (ties: the smallest prediction index; ``torch.argmax``
    returns the first maximum). Both winners do not depend on the
    threshold, so correct[p, t] = (best IoU of p >= thr_t) & p won its GT.
    Boxes [B, P | G, 4] xyxy in one coordinate space per image; invalid rows
    are masked; zero-IoU pairs never match (thresholds > 0)."""
    tb, pb = true_boxes, pred_boxes
    tl = torch.maximum(tb[:, :, None, :2], pb[:, None, :, :2])
    br = torch.minimum(tb[:, :, None, 2:], pb[:, None, :, 2:])
    inter = (br - tl).clamp(min=0).prod(-1)  # [B, G, P]
    area_t = (tb[..., 2:] - tb[..., :2]).prod(-1)
    area_p = (pb[..., 2:] - pb[..., :2]).prod(-1)
    iou = inter / (area_t[:, :, None] + area_p[:, None, :] - inter + 1e-7)
    ok = ((true_classes[:, :, None] == pred_classes[:, None, :])
          & true_valid[:, :, None] & pred_valid[:, None, :])
    iou = torch.where(ok, iou, 0.0)
    best_iou = iou.amax(dim=1)  # [B, P]: each prediction's best same-class GT
    best_g = iou.argmax(dim=1)
    g = torch.arange(tb.shape[1], device=iou.device)
    points_at = best_g[:, None, :] == g[None, :, None]  # [B, G, P]
    winner = torch.where(points_at, best_iou[:, None, :], -1.0).argmax(dim=2)  # [B, G]
    p = torch.arange(pb.shape[1], device=iou.device)
    is_winner = winner.gather(1, best_g) == p[None, :]
    eligible = best_iou[..., None] >= iou_thresholds.to(best_iou.dtype)
    return eligible & (is_winner & (best_iou > 0) & pred_valid)[..., None]


def compute_ap(recall: np.ndarray, precision: np.ndarray, method: str = "coco") -> float:
    """AP from a PR curve. Methods: 'coco' (101-pt), 'voc2009', 'voc2007'."""
    m_rec = np.concatenate(([0.0], recall, [1.0]))
    m_pre = np.concatenate(([1.0], precision, [0.0]))
    m_pre = np.flip(np.maximum.accumulate(np.flip(m_pre)))
    if method == "coco":
        x = np.linspace(0, 1, 101)
        trapezoid = getattr(np, "trapezoid", np.trapz)
        return float(trapezoid(np.interp(x, m_rec, m_pre), x))
    if method == "voc2009":
        i = np.nonzero(m_rec[1:] != m_rec[:-1])[0]
        return float(np.sum((m_rec[i + 1] - m_rec[i]) * m_pre[i + 1]))
    if method == "voc2007":
        return float(np.mean([m_pre[m_rec >= t].max() if (m_rec >= t).any() else 0.0
                              for t in np.linspace(0, 1, 11)]))
    raise ValueError(f"unknown AP method {method!r}")


@dataclasses.dataclass
class MAPResult:
    map_per_iou: np.ndarray  # [T] mAP at each IoU threshold
    ap_per_class_per_iou: np.ndarray  # [C_seen, T]
    classes: list  # class ids, aligned with rows above
    precision: np.ndarray  # [C_seen] P at max-F1 conf, IoU thr[0]
    recall: np.ndarray  # [C_seen]
    iou_thresholds: np.ndarray

    @property
    def map50(self) -> float:
        return float(self.map_per_iou[0])

    @property
    def map(self) -> float:
        return float(self.map_per_iou.mean())


class MeanAveragePrecision:
    """Streaming mAP evaluator.

    Usage:
        m = MeanAveragePrecision()
        for image: m.update(det_boxes, det_scores, det_classes, gt_boxes, gt_classes)
        result = m.compute()
    Inputs may be padded fixed-size arrays with a validity mask.
    """

    def __init__(self, iou_thresholds: Sequence[float] | None = None, method: str = "coco"):
        self.iou_thresholds = np.asarray(
            iou_thresholds if iou_thresholds is not None else np.linspace(0.5, 0.95, 10)
        )
        self.method = method
        self.reset()

    def reset(self):
        self._stats: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []  # correct, conf, cls
        self._gt_classes: list[np.ndarray] = []

    def update(
        self,
        pred_boxes,
        pred_scores,
        pred_classes,
        true_boxes,
        true_classes,
        pred_valid=None,
        true_valid=None,
    ):
        """Accumulate one image. Boxes are xyxy in a shared coordinate space."""
        pred_boxes = np.asarray(pred_boxes, np.float32).reshape(-1, 4)
        pred_scores = np.asarray(pred_scores, np.float32).reshape(-1)
        pred_classes = np.asarray(pred_classes).reshape(-1)
        true_boxes = np.asarray(true_boxes, np.float32).reshape(-1, 4)
        true_classes = np.asarray(true_classes).reshape(-1)
        if pred_valid is not None:
            m = np.asarray(pred_valid, bool).reshape(-1)
            pred_boxes, pred_scores, pred_classes = pred_boxes[m], pred_scores[m], pred_classes[m]
        if true_valid is not None:
            m = np.asarray(true_valid, bool).reshape(-1)
            true_boxes, true_classes = true_boxes[m], true_classes[m]
        if true_classes.size:
            self._gt_classes.append(true_classes.copy())
        if pred_scores.size == 0:
            return
        correct = match_predictions(
            pred_boxes, pred_classes, true_boxes, true_classes, self.iou_thresholds
        )
        self._stats.append((correct, pred_scores, pred_classes))

    def update_matched(
        self,
        correct,
        pred_scores,
        pred_classes,
        gt_classes,
        pred_valid=None,
        gt_valid=None,
    ):
        """Accumulate one image whose correct-matrix ([P, T] bool, aligned
        with this evaluator's iou_thresholds) was computed already, e.g. by
        `match_predictions_device`: padding stripped, then stored."""
        correct = np.asarray(correct, bool).reshape(-1, len(self.iou_thresholds))
        pred_scores = np.asarray(pred_scores, np.float32).reshape(-1)
        pred_classes = np.asarray(pred_classes).reshape(-1)
        gt_classes = np.asarray(gt_classes).reshape(-1)
        if pred_valid is not None:
            m = np.asarray(pred_valid, bool).reshape(-1)
            correct, pred_scores, pred_classes = correct[m], pred_scores[m], pred_classes[m]
        if gt_valid is not None:
            gt_classes = gt_classes[np.asarray(gt_valid, bool).reshape(-1)]
        if gt_classes.size:
            self._gt_classes.append(gt_classes.copy())
        if pred_scores.size:
            self._stats.append((correct, pred_scores, pred_classes))

    def compute(self) -> MAPResult:
        nt = len(self.iou_thresholds)
        gt_classes = (
            np.concatenate(self._gt_classes) if self._gt_classes else np.zeros((0,), np.int64)
        )
        seen = np.unique(gt_classes).tolist()
        if not self._stats or not seen:
            z = np.zeros((len(seen), nt))
            return MAPResult(
                np.zeros(nt), z, seen, np.zeros(len(seen)), np.zeros(len(seen)),
                self.iou_thresholds,
            )
        correct = np.concatenate([s[0] for s in self._stats], axis=0)
        conf = np.concatenate([s[1] for s in self._stats], axis=0)
        cls = np.concatenate([s[2] for s in self._stats], axis=0)
        order = np.argsort(-conf)
        correct, conf, cls = correct[order], conf[order], cls[order]

        ap = np.zeros((len(seen), nt))
        prec = np.zeros(len(seen))
        rec = np.zeros(len(seen))
        for ci, c in enumerate(seen):
            total_pos = int(np.sum(gt_classes == c))
            mask = cls == c
            n_pred = int(mask.sum())
            if n_pred == 0 or total_pos == 0:
                continue
            tp_cum = np.cumsum(correct[mask], axis=0)  # [n_pred, nt]
            fp_cum = np.cumsum(~correct[mask], axis=0)
            recall = tp_cum / (total_pos + 1e-16)
            precision = tp_cum / (tp_cum + fp_cum + 1e-16)
            for ti in range(nt):
                ap[ci, ti] = compute_ap(recall[:, ti], precision[:, ti], self.method)
            f1 = 2 * precision[:, 0] * recall[:, 0] / (precision[:, 0] + recall[:, 0] + 1e-16)
            best = int(np.argmax(f1))
            prec[ci], rec[ci] = precision[best, 0], recall[best, 0]

        return MAPResult(ap.mean(axis=0), ap, seen, prec, rec, self.iou_thresholds)


# the reference's class name, as the JAX package keeps it
CalculateMAP = MeanAveragePrecision
