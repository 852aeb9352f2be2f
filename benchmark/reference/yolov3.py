"""Plain float32 YOLOv3 and its training loss, with nothing of the program
imported.

The model follows Redmon & Farhadi, arXiv:1804.02767, and darknet's
``cfg/yolov3.cfg``: Darknet-53, the top-down neck, a biased 1x1 head per
level. It takes NHWC images in [0, 255] as uint8 and normalizes them
itself. Departures from the paper, which the program shares and the
configuration lists under ``assumed``: the activation is SiLU (darknet:
leaky ReLU 0.1), each 3x3 conv pads ``k // 2`` on both sides, and BN uses
eps 1e-5. The parameter names are the program's state-dict names, so one
set of weights made from the seed loads into both.

The loss is ultralytics' YOLOv5 form, which the configuration states:
multi-anchor wh-ratio match, CIoU box term, objectness BCE against the
detached IoU, class BCE, scaled by the batch size. The target assignment
is a loop over the ground truths, in the order image, box, anchor: a later
box that lands on the same (cell, anchor) slot replaces an earlier one
whole, so box, class and flag come from one box.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, ConvBN, stage

EPS_IOU = 1e-7
EPS_MEAN = 1e-8


class DarkResidual(nn.Module):
    def __init__(self, c: int, act: str):
        super().__init__()
        self.conv1 = ConvBN(c, c // 2, 1, act=act)
        self.conv2 = ConvBN(c // 2, c, 3, act=act)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class Darknet53(nn.Module):
    def __init__(self, stage_sizes, act: str):
        super().__init__()
        self.conv0 = ConvBN(3, 32, 3, act=act)
        prev = 32
        for i, n in enumerate(stage_sizes):
            c = 64 * 2**i
            setattr(self, f"conv{i + 1}", ConvBN(prev, c, 3, 2, act=act))
            setattr(self, f"res{i + 1}", nn.Sequential(*(DarkResidual(c, act) for _ in range(n))))
            prev = c

    def stages(self):
        yield self.conv0
        for i in range(1, 6):
            yield nn.Sequential(getattr(self, f"conv{i}"), getattr(self, f"res{i}"))


class YOLOv3(nn.Module):
    """Darknet-53, the top-down neck (per level a 1-3-1-3-1 block on the
    concat of the level's feature and the upsampled lateral of the level
    above, then a 3x3 conv), and a biased 1x1 head per level. NHWC uint8
    [B, S, S, 3] -> per level [B, H, W, A, 5 + C], stride 32 first."""

    LEVELS = ("small", "medium", "large")

    def __init__(self, num_classes: int, stage_sizes=(1, 2, 8, 8, 4), act: str = "silu",
                 channels=(1024, 512, 256), anchors_per_level: int = 3):
        super().__init__()
        self.backbone = Darknet53(stage_sizes, act)
        self.neck = nn.Module()
        ins = (1024, 512, 256)
        for i, (lvl, cin, ch) in enumerate(zip(self.LEVELS, ins, channels)):
            f = ch // 2
            block_in = cin if i == 0 else cin + f
            setattr(self.neck, f"neck_{lvl}", nn.Sequential(
                ConvBN(block_in, f, 1, act=act), ConvBN(f, 2 * f, 3, act=act),
                ConvBN(2 * f, f, 1, act=act), ConvBN(f, 2 * f, 3, act=act),
                ConvBN(2 * f, f, 1, act=act)))
            setattr(self.neck, f"neck_out_{lvl}", ConvBN(f, ch, 3, act=act))
            if i + 1 < len(channels):
                setattr(self.neck, f"up_sampling_{lvl}",
                        nn.Sequential(ConvBN(f, channels[i + 1] // 2, 1, act=act)))
        self.head = nn.Module()
        self.a, self.no = anchors_per_level, 5 + num_classes
        for lvl, ch in zip(self.LEVELS, channels):
            setattr(self.head, f"head_out_{lvl}", Conv(ch, self.a * self.no, 1, bias=True))
        self.remat = False

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2).float() / 255.0
        feats = []
        for i, block in enumerate(self.backbone.stages()):
            x = stage(block, x, self.remat)
            if i >= 3:
                feats.append(x)
        feats = feats[::-1]  # P5, P4, P3
        outs, carry = [], None
        for i, (lvl, x) in enumerate(zip(self.LEVELS, feats)):
            if carry is not None:
                up = getattr(self.neck, f"up_sampling_{self.LEVELS[i - 1]}")(carry)
                x = torch.cat([x, F.interpolate(up, scale_factor=2, mode="nearest")], dim=1)
            carry = stage(getattr(self.neck, f"neck_{lvl}"), x, self.remat)
            y = getattr(self.head, f"head_out_{lvl}")(getattr(self.neck, f"neck_out_{lvl}")(carry))
            b, _, h, w = y.shape
            outs.append(y.permute(0, 2, 3, 1).reshape(b, h, w, self.a, self.no))
        return outs


def build(cfg: dict) -> nn.Module:
    """The configuration's model, float32, on the current default device."""
    return YOLOv3(cfg["num_classes"], tuple(cfg["stage_sizes"]), cfg["act"],
                  tuple(cfg["channels"]), len(cfg["anchors"][0]))


def _xyxy(b):
    return torch.stack([b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                        b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2], dim=-1)


def iou_ciou(p: torch.Tensor, t: torch.Tensor):
    """(IoU, CIoU) of paired xywh boxes [..., 4] (Zheng et al., 2020)."""
    a, b = _xyxy(p), _xyxy(t)
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = iw * ih
    union = p[..., 2] * p[..., 3] + t[..., 2] * t[..., 3] - inter + EPS_IOU
    iou = inter / union
    cw = torch.maximum(a[..., 2], b[..., 2]) - torch.minimum(a[..., 0], b[..., 0])
    ch = torch.maximum(a[..., 3], b[..., 3]) - torch.minimum(a[..., 1], b[..., 1])
    c2 = cw**2 + ch**2 + EPS_IOU
    rho2 = (t[..., 0] - p[..., 0]) ** 2 + (t[..., 1] - p[..., 1]) ** 2
    v = (4 / math.pi**2) * (torch.atan(t[..., 2] / (t[..., 3] + EPS_IOU))
                            - torch.atan(p[..., 2] / (p[..., 3] + EPS_IOU))) ** 2
    alpha = (v / (v - iou + (1 + EPS_IOU))).detach()
    return iou, iou - (rho2 / c2 + alpha * v)


def yolo_targets(labels: np.ndarray, anchors_feat: np.ndarray, h: int, w: int,
                 ratio_thres: float):
    """labels [B, M, 5] (class, cx, cy, w, h normalized; class < 0 pads) ->
    per slot [B, H, W, A]: positive flag, box (x, y offset in the cell, w, h
    in feature units), class."""
    b, m, _ = labels.shape
    a = len(anchors_feat)
    pos = np.zeros((b, h, w, a), np.float32)
    box = np.zeros((b, h, w, a, 4), np.float32)
    cls = np.zeros((b, h, w, a), np.int64)
    for i in range(b):
        for j in range(m):
            c, cx, cy, bw, bh = (float(v) for v in labels[i, j])
            if c < 0:
                continue
            tx, ty, tw, th = cx * w, cy * h, bw * w, bh * h
            gx = min(max(math.floor(tx), 0), w - 1)
            gy = min(max(math.floor(ty), 0), h - 1)
            for k, (aw, ah) in enumerate(anchors_feat):
                rw, rh = tw / aw, th / ah
                if max(rw, 1 / rw, rh, 1 / rh) >= ratio_thres:
                    continue
                pos[i, gy, gx, k] = 1.0
                box[i, gy, gx, k] = (tx - gx, ty - gy, tw, th)
                cls[i, gy, gx, k] = int(c)
    return pos, box, cls


def _bce(x, t):
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def loss(heads, labels: np.ndarray, cfg: dict) -> torch.Tensor:
    """heads: per level [B, H, W, A, 5 + C] (float32), stride-32 level first;
    labels: [B, M, 5] boxes (`harness.traffic`'s 'boxes')."""
    lc = cfg["loss"]
    dev = heads[0].device
    total_box = total_obj = total_cls = 0.0
    for li, head in enumerate(heads):
        bsz, h, w, a, no = head.shape
        anchors = np.asarray(cfg["anchors"][li], np.float32) / np.float32(cfg["strides"][li])
        pos, box, cls = (torch.from_numpy(t).to(dev) for t in
                         yolo_targets(labels, anchors, h, w, lc["ratio_thres"]))
        sig = torch.sigmoid(head[..., 0:4])
        pwh = (sig[..., 2:4] * 2.0) ** 2 * torch.from_numpy(anchors).to(dev)
        pred = torch.cat([sig[..., 0:2] * 2.0 - 0.5, pwh], dim=-1)
        iou, ciou = iou_ciou(pred, box)
        npos = pos.sum() + EPS_MEAN
        total_box = total_box + ((1.0 - ciou) * pos).sum() / npos
        total_obj = total_obj + _bce(head[..., 4], iou.clamp(0.0, 1.0).detach() * pos).mean()
        onehot = F.one_hot(cls, no - 5).float()
        total_cls = total_cls + (_bce(head[..., 5:], onehot).mean(dim=-1) * pos).sum() / npos
    bsz = heads[0].shape[0]
    return (lc["ratio_box"] * total_box + lc["ratio_conf"] * total_obj
            + lc["ratio_cls"] * total_cls) * bsz
