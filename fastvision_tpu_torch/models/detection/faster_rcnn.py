"""Faster R-CNN: VGG16 backbone + RPN + RoI-align Fast head, static shapes
(port of fastvision_tpu/models/detection/faster_rcnn.py).

The JAX package's design carries over: proposal filtering has static pre-
and post-NMS K with invalid proposals flagged; positive / negative sampling
is a stochastic top-k (priority = mask + U(0, 1)); RPN objectness is one
sigmoid logit trained with focal loss; the Fast head regresses per class
with targets normalized by ``BOX_STD``. What the port changes:

  - its functions are batched over a leading image axis instead of
    ``vmap``-ed, so greedy NMS is ONE `suppression_mask` call over [B, K]
    (one CUDA kernel launch) for the RPN and one for the head;
  - every random draw (the samplers' uniforms, the head's dropout masks) is
    a `Draws` made from an explicit ``torch.Generator`` before the
    forward uses it; a caller can pass its own `Draws` instead;
  - ``lax.top_k`` becomes `ops.nms._top_k` (a stable sort: ties, such as
    the -inf scores of min-size-filtered anchors, keep index order);
  - a valid GT's best anchor is marked positive by a scatter that writes
    only valid GTs (padded rows, whose IoUs are all -1, point at anchor 0);
  - under bf16 autocast the losses, proposal scores and postprocess
    softmax run in float32 (the JAX package runs them in the model dtype),
    and RoI-align's matmul form runs in float32 (float64 in a float64 model) as
    in the JAX package.

Modules are NCHW inside; the model takes NHWC images [B, H, W, 3] as the
JAX package does. The head flattens RoI features in (h, w, c) order, the
JAX package's, so flax weights bridge with a plain transpose.

Train (``model.train()``): ``model(images, labels, generator=g)`` -> dict of
losses {rpn_cls, rpn_reg, cls, reg}; labels padded [B, M, 5] = (class, x1,
y1, x2, y2) in input pixels, class -1 = padding.

Over several data-parallel ranks (``draw_shard=(i, n)``, the rank's data
index and the data axis's size) each rank holds images ``i*B .. (i+1)*B``
of a global batch of ``n*B``: it makes (or is given) the `Draws` of the
whole global batch, from the same generator seed on every rank, and keeps
its rows, so its draws are bit-equal to those rows of the one-process
step's. Sampling is per image, so no proposal, score or IoU of another rank
is needed: nothing is gathered. The RPN's per-image mean over this rank's
images, averaged over the ranks by data parallelism, is the global mean;
the head's weighted means take their denominators over the global batch
(`train.losses` under `core.distributed.data_parallel`).
Eval (``model.eval()``): ``model(images)`` -> (class logits [B, P, C + 1],
boxes [B, P, C, 4], proposals [B, P, 4], valid [B, P]); `fastrcnn_postprocess`
turns them into Detections.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import init_weights_
from ...ops.box import clip_boxes
from ...ops.box_coder import decode_boxes, encode_boxes
from ...ops.iou import box_iou_matrix
from ...ops.nms import CLASS_OFFSET, Detections, _top_k, suppression_mask
from ...ops.roi_align import roi_align, roi_align_mxu
from ...train.losses import binary_focal_loss, cross_entropy, smooth_l1
from ..classification.vgg import CFGS, VGG, VGGClassifier

BOX_STD = (0.1, 0.1, 0.2, 0.2)
_EPS = 1e-8


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------
def make_base_anchors(scales: Sequence[float] = (8, 16, 32),
                      ratios: Sequence[float] = (0.5, 1.0, 2.0),
                      stride: int = 16) -> torch.Tensor:
    """[A, 4] float32 xyxy centred at the origin, ratio-major."""
    anchors = []
    for r in ratios:
        for s in scales:
            size = s * stride
            w = size / (r**0.5)
            h = size * (r**0.5)
            anchors.append([-w / 2, -h / 2, w / 2, h / 2])
    return torch.tensor(anchors, dtype=torch.float32)


def anchor_grid(feat_h: int, feat_w: int, stride: int, base: torch.Tensor,
                offset: float = 0.5) -> torch.Tensor:
    """[feat_h * feat_w * A, 4] anchors in image pixels, in (h, w, a) order.
    ``offset=0.5`` centres anchors on cells; the reference centres them on
    integer grid corners (``offset=0.0``, for its checkpoints)."""
    ys = (torch.arange(feat_h, dtype=torch.float32, device=base.device) + offset) * stride
    xs = (torch.arange(feat_w, dtype=torch.float32, device=base.device) + offset) * stride
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    centers = torch.stack([cx, cy, cx, cy], dim=-1)  # [H, W, 4]
    return (centers[:, :, None, :] + base[None, None]).reshape(-1, 4)


# ---------------------------------------------------------------------------
# fixed-size stochastic sampling
# ---------------------------------------------------------------------------
class Draws(NamedTuple):
    """Every random number of one training forward: U(0, 1) priorities of
    the RPN's positive / negative anchors [B, K] and of the RoI sampler's
    positive / negative proposals [B, P], and the head's two dropout keep
    masks [B, num_rois, hidden]."""

    rpn_pos: torch.Tensor
    rpn_neg: torch.Tensor
    roi_pos: torch.Tensor
    roi_neg: torch.Tensor
    keep1: torch.Tensor
    keep2: torch.Tensor


def make_draws(generator: torch.Generator, batch: int, num_anchors: int, num_proposals: int,
               num_rois: int, hidden: int, dropout_rate: float) -> Draws:
    """`Draws` from ``generator``, on its device, in field order."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=generator.device)

    return Draws(u(batch, num_anchors), u(batch, num_anchors),
                 u(batch, num_proposals), u(batch, num_proposals),
                 u(batch, num_rois, hidden) < 1.0 - dropout_rate,
                 u(batch, num_rois, hidden) < 1.0 - dropout_rate)


def random_sample_mask(uniform: torch.Tensor, mask: torch.Tensor, k: int):
    """Pick up to k True entries of each row of ``mask`` [..., K] at random,
    static shape: the top k of mask + ``uniform`` (U(0, 1) draws of mask's
    shape). -> (indices [..., k], weights [..., k] in {0, 1}), weights zero
    where a row had fewer than k candidates."""
    priority = mask.to(torch.float32) + uniform
    idx = _top_k(priority, k)[1]
    return idx, mask.gather(-1, idx).to(torch.float32)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K, D], idx [B, N] -> [B, N, D]."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _per_image_mean(loss: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The JAX package's per-image weighted mean, then the mean over images."""
    return ((loss * weights).sum(-1) / (weights.sum(-1) + _EPS)).mean()


# ---------------------------------------------------------------------------
# RPN
# ---------------------------------------------------------------------------
class RPNHead(nn.Module):
    """3x3 conv + ReLU, then 1x1 objectness (one logit per anchor) and 1x1
    deltas (4 per anchor), flattened in the anchors' (h, w, a) order."""

    def __init__(self, in_channels: int = 512, num_anchors: int = 9, mid_channels: int = 512):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, mid_channels, 3, padding=1)
        self.cls = nn.Conv2d(mid_channels, num_anchors, 1)
        self.reg = nn.Conv2d(mid_channels, num_anchors * 4, 1)

    def forward(self, feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.conv(feat))
        obj = self.cls(x).permute(0, 2, 3, 1)  # NHWC: channel a
        reg = self.reg(x).permute(0, 2, 3, 1)  # NHWC: channel a * 4 + coord
        b = obj.shape[0]
        return obj.reshape(b, -1), reg.reshape(b, -1, 4)


def proposal_candidates(anchors: torch.Tensor, obj_logits: torch.Tensor, deltas: torch.Tensor,
                        image_size: int, pre_nms_top_n: int = 2000, min_size: float = 1.0,
                        clip_max: tuple[float, float] | None = None, wh_from_dw: bool = False):
    """The RPN's NMS input: decode, clip, min-size filter (its rejects score
    -inf), top ``pre_nms_top_n`` by objectness. ``clip_max`` /
    ``wh_from_dw`` / ``min_size < 0`` are the reference-checkpoint semantics.

    anchors [K, 4], obj_logits [B, K], deltas [B, K, 4] -> (boxes [B, pre, 4],
    logits [B, pre]) float32, in descending logit order."""
    boxes = decode_boxes(anchors[None], deltas.float(), wh_from_dw=wh_from_dw)
    cw, ch = clip_max if clip_max is not None else (image_size, image_size)
    boxes = clip_boxes(boxes, ch, cw)
    scores = obj_logits.float()
    if min_size >= 0:
        wh_ok = ((boxes[..., 2] - boxes[..., 0] >= min_size)
                 & (boxes[..., 3] - boxes[..., 1] >= min_size))
        scores = torch.where(wh_ok, scores, float("-inf"))
    top_s, top_i = _top_k(scores, min(pre_nms_top_n, scores.shape[1]))
    return _gather_rows(boxes, top_i), top_s


def select_proposals(boxes: torch.Tensor, scores: torch.Tensor, nms_thresh: float = 0.7,
                     post_nms_top_n: int = 300):
    """Greedy NMS over the candidates (one `suppression_mask` call for the
    batch), then the top ``post_nms_top_n`` kept -> (proposals [B, post, 4],
    sigmoid scores [B, post], valid [B, post])."""
    keep = suppression_mask(boxes, scores, nms_thresh)
    out_s, out_i = _top_k(torch.where(keep, scores, float("-inf")),
                          min(post_nms_top_n, scores.shape[1]))
    return _gather_rows(boxes, out_i), torch.sigmoid(out_s), out_s > float("-inf")


def filter_proposals(anchors: torch.Tensor, obj_logits: torch.Tensor, deltas: torch.Tensor,
                     image_size: int, pre_nms_top_n: int = 2000, post_nms_top_n: int = 300,
                     nms_thresh: float = 0.7, min_size: float = 1.0,
                     clip_max: tuple[float, float] | None = None, wh_from_dw: bool = False):
    """Fixed-size proposal selection for the batch: `proposal_candidates`
    then `select_proposals` -> (proposals [B, post, 4], sigmoid scores
    [B, post], valid [B, post]), float32."""
    boxes, scores = proposal_candidates(anchors, obj_logits, deltas, image_size, pre_nms_top_n,
                                        min_size, clip_max, wh_from_dw)
    return select_proposals(boxes, scores, nms_thresh, post_nms_top_n)


def rpn_loss(draws: tuple[torch.Tensor, torch.Tensor], anchors: torch.Tensor,
             obj_logits: torch.Tensor, deltas: torch.Tensor, labels: torch.Tensor,
             pos_iou: float = 0.7, neg_iou: float = 0.3, num_pos: int = 128,
             num_neg: int = 128, focal_gamma: float = 2.0, focal_alpha: float | None = None):
    """Anchor classification (sigmoid focal) + regression (smooth-L1, beta
    1/9) over sampled anchors; ``draws`` = (U positive, U negative) [B, K].
    Means per image, then over images; float32. -> (cls, reg)."""
    obj_logits, deltas = obj_logits.float(), deltas.float()
    b, k = obj_logits.shape
    gt = labels[..., 1:5].float()
    gt_valid = labels[..., 0] >= 0  # [B, M]
    iou = box_iou_matrix(anchors[None], gt)  # [B, K, M]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)  # the first maximum, as jnp.argmax

    pos = best_iou >= pos_iou
    # every valid GT's best anchor is positive; padded GTs write to a
    # sentinel column past the end, which is dropped
    best_anchor = torch.where(gt_valid, iou.argmax(dim=1), k)  # [B, M]
    pos = torch.cat([pos, torch.zeros_like(pos[:, :1])], dim=1).scatter(1, best_anchor, True)[:, :k]
    neg = (best_iou < neg_iou) & (best_iou >= 0) & ~pos

    pos_idx, pos_w = random_sample_mask(draws[0], pos, num_pos)
    neg_idx, neg_w = random_sample_mask(draws[1], neg, num_neg)
    logit_s = torch.cat([obj_logits.gather(1, pos_idx), obj_logits.gather(1, neg_idx)], dim=1)
    target_s = torch.cat([torch.ones_like(pos_w), torch.zeros_like(neg_w)], dim=1)
    weight_s = torch.cat([pos_w, neg_w], dim=1)
    focal = binary_focal_loss(logit_s, target_s, gamma=focal_gamma, alpha=focal_alpha,
                              reduction="none")
    cls = _per_image_mean(focal, weight_s)

    tgt = encode_boxes(anchors[pos_idx], _gather_rows(gt, best_gt.gather(1, pos_idx)))
    reg = smooth_l1(_gather_rows(deltas, pos_idx), tgt, beta=1.0 / 9, reduction="none")
    return cls, _per_image_mean(reg, pos_w)


# ---------------------------------------------------------------------------
# Fast head
# ---------------------------------------------------------------------------
class FastHead(VGGClassifier):
    """RoI features [B, N, o, o, C] -> the VGG MLP -> (C + 1 logits
    [B, N, C + 1], per-class deltas [B, N, C, 4])."""

    def __init__(self, in_features: int, num_classes: int, hidden: int = 4096,
                 dropout_rate: float = 0.5):
        super().__init__(in_features, hidden, dropout_rate)
        self.num_classes = num_classes
        self.cls = nn.Linear(hidden, num_classes + 1)
        self.reg = nn.Linear(hidden, num_classes * 4)

    def forward(self, roi_feats: torch.Tensor, keep_masks=None):
        b, n = roi_feats.shape[:2]
        x = super().forward(roi_feats.reshape(b, n, -1), keep_masks)  # (h, w, c) flatten
        return self.cls(x), self.reg(x).reshape(b, n, self.num_classes, 4)


def sample_rois(draws: tuple[torch.Tensor, torch.Tensor], proposals: torch.Tensor,
                prop_valid: torch.Tensor, labels: torch.Tensor, pos_iou: float = 0.5,
                num_pos: int = 16, num_neg: int = 48):
    """Per-image positive / negative RoI sampling; ``draws`` = (U positive,
    U negative) [B, P].

    -> rois [B, S, 4], cls_target [B, S] int32 (0 = background),
       reg_target [B, S, 4] (normalized by BOX_STD), pos_w / all_w [B, S]."""
    gt = labels[..., 1:5].float()
    gt_cls = labels[..., 0]
    gt_valid = gt_cls >= 0
    iou = box_iou_matrix(proposals, gt)  # [B, P, M]
    iou = torch.where(gt_valid[:, None, :] & prop_valid[:, :, None], iou, -1.0)
    best_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)
    pos = best_iou >= pos_iou
    neg = (best_iou < pos_iou) & (best_iou >= 0)

    pos_idx, pos_w = random_sample_mask(draws[0], pos, num_pos)
    neg_idx, neg_w = random_sample_mask(draws[1], neg, num_neg)
    idx = torch.cat([pos_idx, neg_idx], dim=1)
    w = torch.cat([pos_w, neg_w], dim=1)
    pw = torch.cat([pos_w, torch.zeros_like(neg_w)], dim=1)

    rois = _gather_rows(proposals, idx)
    matched = best_gt.gather(1, idx)
    cls_t = torch.where(pw > 0, gt_cls.gather(1, matched) + 1, 0.0).to(torch.int32)
    reg_t = encode_boxes(rois, _gather_rows(gt, matched), BOX_STD)
    return rois, cls_t, reg_t, pw, w


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
class FasterRCNN(nn.Module):
    """VGG16 stride-16 backbone + RPN + Fast head, at the JAX package's
    defaults (VOC: 20 classes, 512 px). ``generator`` seeds the initial
    weights (`init_weights_`: the JAX package's initializers).

    ``reference_compat`` selects the reference checkpoint's semantics (for
    weights from `models.import_torch.frcnn_state_dict_from_reference`):
    anchors on integer grid corners, proposals clipped to image_size -
    stride, no min-size filter, h decoded from the dw channel, no final box
    clip."""

    def __init__(self, num_classes: int = 20, image_size: int = 512,
                 anchor_scales: Sequence[float] = (8, 16, 32),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0), stride: int = 16,
                 rpn_pre_nms_train: int = 2000, rpn_post_nms_train: int = 512,
                 rpn_pre_nms_eval: int = 1000, rpn_post_nms_eval: int = 300,
                 rpn_nms_thresh: float = 0.7, roi_pos: int = 16, roi_neg: int = 48,
                 roi_size: int = 7, roi_backend: str = "mxu", reference_compat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if roi_backend not in ("mxu", "gather"):
            raise ValueError(f"roi_backend must be 'mxu' or 'gather', got {roi_backend!r}")
        self.num_classes = num_classes
        self.image_size = image_size
        self.stride = stride
        self.rpn_pre_nms_train, self.rpn_post_nms_train = rpn_pre_nms_train, rpn_post_nms_train
        self.rpn_pre_nms_eval, self.rpn_post_nms_eval = rpn_pre_nms_eval, rpn_post_nms_eval
        self.rpn_nms_thresh = rpn_nms_thresh
        self.roi_pos, self.roi_neg, self.roi_size = roi_pos, roi_neg, roi_size
        self.roi_align = roi_align_mxu if roi_backend == "mxu" else roi_align
        self.reference_compat = reference_compat
        self.backbone = VGG(CFGS["vgg16"], batch_norm=False, including_top=False,
                            drop_last_pool=True)
        self.register_buffer("base_anchors", make_base_anchors(anchor_scales, anchor_ratios,
                                                               stride), persistent=False)
        c = self.backbone.out_channels
        self.rpn = RPNHead(c, self.base_anchors.shape[0], c)
        self.head = FastHead(c * roi_size * roi_size, num_classes)
        self._anchors: dict = {}
        init_weights_(self, generator)

    def anchors(self, feat_h: int, feat_w: int) -> torch.Tensor:
        """The anchor grid of a feat_h x feat_w map, made once per shape and
        device; float32 whatever the model's dtype (a float64 model's
        proposals stay float32, the NMS kernel's input, as in the JAX
        package)."""
        key = (feat_h, feat_w, self.base_anchors.device)
        if key not in self._anchors:
            self._anchors[key] = anchor_grid(feat_h, feat_w, self.stride,
                                             self.base_anchors.float(),
                                             offset=0.0 if self.reference_compat else 0.5)
        return self._anchors[key]

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images [B, H, W, 3] -> the backbone's NCHW feature map."""
        return self.backbone(images.permute(0, 3, 1, 2))

    def propose(self, feat: torch.Tensor):
        """RPN head + proposal selection (train or eval K by the module's
        mode) -> (anchors [K, 4], objectness [B, K], deltas [B, K, 4],
        proposals [B, P, 4], valid [B, P]); the proposals carry no gradient."""
        _, _, fh, fw = feat.shape
        anchors = self.anchors(fh, fw)
        obj, deltas = self.rpn(feat)
        compat, train = self.reference_compat, self.training
        with torch.no_grad():
            proposals, _, valid = filter_proposals(
                anchors, obj.detach(), deltas.detach(), self.image_size,
                self.rpn_pre_nms_train if train else self.rpn_pre_nms_eval,
                self.rpn_post_nms_train if train else self.rpn_post_nms_eval,
                self.rpn_nms_thresh, min_size=-1.0 if compat else 1.0,
                clip_max=((fw - 1) * self.stride, (fh - 1) * self.stride) if compat else None,
                wh_from_dw=compat)
        return anchors, obj, deltas, proposals, valid

    def detect(self, feat: torch.Tensor, proposals: torch.Tensor):
        """Eval head over every proposal: RoI-align, the MLP, per-class box
        decode (clipped unless reference_compat) -> (class logits
        [B, P, C + 1], boxes [B, P, C, 4])."""
        roi_feats = self.roi_align(feat.permute(0, 2, 3, 1), proposals, self.roi_size,
                                   1.0 / self.stride)  # NHWC: free in channels_last memory
        cls_logits, reg_pred = self.head(roi_feats)
        boxes = decode_boxes(proposals[:, :, None, :], reg_pred.float(), BOX_STD,
                             wh_from_dw=self.reference_compat)
        if not self.reference_compat:  # the reference never clips its final boxes
            boxes = clip_boxes(boxes, self.image_size, self.image_size)
        return cls_logits, boxes

    def forward(self, images: torch.Tensor, labels: torch.Tensor | None = None,
                generator: torch.Generator | None = None, draws: Draws | None = None,
                draw_shard: tuple[int, int] = (0, 1)):
        """``draws``: the global batch's (module docstring); ``draw_shard``:
        (this rank's data index, the data axis's size)."""
        train = self.training
        if train and labels is None:
            raise ValueError("the training forward needs labels")
        if train and draws is None and generator is None:
            raise ValueError("the training forward needs a generator (or draws)")
        feat = self.features(images)
        anchors, obj, deltas, proposals, prop_valid = self.propose(feat)
        if not train:
            return (*self.detect(feat, proposals), proposals, prop_valid)

        b, (index, count) = feat.shape[0], draw_shard
        if draws is None:
            draws = make_draws(generator, b * count, anchors.shape[0], proposals.shape[1],
                               self.roi_pos + self.roi_neg, self.head.hidden,
                               self.head.dropout_rate)
        if count > 1:  # this rank's rows of the global batch's draws
            draws = Draws(*(d[index * b:(index + 1) * b] for d in draws))
        rpn_cls, rpn_reg = rpn_loss(draws[:2], anchors, obj, deltas, labels)
        rois, cls_t, reg_t, pos_w, all_w = sample_rois(
            draws[2:4], proposals, prop_valid, labels, num_pos=self.roi_pos,
            num_neg=self.roi_neg)
        roi_feats = self.roi_align(feat.permute(0, 2, 3, 1), rois, self.roi_size,
                                   1.0 / self.stride)
        cls_logits, reg_pred = self.head(roi_feats, keep_masks=draws[4:])
        # per-class regression: the target class's deltas
        fg = (cls_t.long() - 1).clamp(0, self.num_classes - 1)
        reg_sel = reg_pred.gather(2, fg[..., None, None].expand(-1, -1, 1, 4)).squeeze(2)
        cls_loss = cross_entropy(cls_logits.float().reshape(-1, self.num_classes + 1),
                                 cls_t.reshape(-1), weights=all_w.reshape(-1))
        reg_loss = smooth_l1(reg_sel.float().reshape(-1, 4), reg_t.reshape(-1, 4),
                             weights=pos_w.reshape(-1))
        return {"rpn_cls": rpn_cls, "rpn_reg": rpn_reg, "cls": cls_loss, "reg": reg_loss}


def detection_candidates(cls_logits: torch.Tensor, boxes: torch.Tensor,
                         prop_valid: torch.Tensor, score_thresh: float = 0.05,
                         max_det: int = 100):
    """The head's NMS input: foreground scores (softmax in float32) of every
    (proposal, class) pair of a valid proposal, those above
    ``score_thresh``, the top 4 * max_det by score.

    cls_logits [B, P, C + 1], boxes [B, P, C, 4], prop_valid [B, P] ->
    (boxes [B, K, 4], class-offset boxes [B, K, 4], scores [B, K] with -inf
    for the rejected, classes [B, K] int32), in descending score order."""
    b, p, c1 = cls_logits.shape
    c = c1 - 1
    scores = torch.softmax(cls_logits.float(), dim=-1)[..., 1:]  # [B, P, C] foreground
    flat_scores = torch.where(prop_valid[..., None], scores, 0.0).reshape(b, p * c)
    masked = torch.where(flat_scores > score_thresh, flat_scores, float("-inf"))
    top_s, top_i = _top_k(masked, min(4 * max_det, p * c))
    top_b = _gather_rows(boxes.float().reshape(b, p * c, 4), top_i)
    top_c = (top_i % c).to(torch.int32)  # flat index = proposal * C + class
    off_boxes = top_b + (top_c.to(top_b.dtype) * CLASS_OFFSET)[..., None]
    return top_b, off_boxes, top_s, top_c


def select_detections(boxes: torch.Tensor, off_boxes: torch.Tensor, scores: torch.Tensor,
                      classes: torch.Tensor, nms_thresh: float = 0.3,
                      max_det: int = 100) -> Detections:
    """Class-aware greedy NMS over the candidates (one `suppression_mask`
    call for the batch), then the top ``max_det`` kept -> Detections."""
    keep = suppression_mask(off_boxes, scores, nms_thresh)
    out_s, out_i = _top_k(torch.where(keep, scores, float("-inf")),
                          min(max_det, scores.shape[1]))
    valid = out_s > float("-inf")
    return Detections(
        boxes=torch.where(valid[..., None], _gather_rows(boxes, out_i), 0.0),
        scores=torch.where(valid, out_s, 0.0),
        classes=torch.where(valid, classes.gather(1, out_i), -1),
        valid=valid,
    )


def fastrcnn_postprocess(cls_logits: torch.Tensor, boxes: torch.Tensor,
                         prop_valid: torch.Tensor, score_thresh: float = 0.05,
                         nms_thresh: float = 0.3, max_det: int = 100) -> Detections:
    """Per-class scores + class-offset greedy NMS -> fixed-size Detections:
    `detection_candidates` then `select_detections`."""
    return select_detections(*detection_candidates(cls_logits, boxes, prop_valid, score_thresh,
                                                   max_det), nms_thresh, max_det)


def faster_rcnn(num_classes: int = 20, **kw) -> FasterRCNN:
    """Factory (the JAX package's ``faster_rcnn``)."""
    return FasterRCNN(num_classes=num_classes, **kw)
