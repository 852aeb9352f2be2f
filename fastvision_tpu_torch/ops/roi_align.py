"""RoI Align: bilinear region pooling over feature maps (port of
fastvision_tpu/ops/roi_align.py).

Both forms of the JAX package, on NHWC features [B, H, W, C] (the port's
NCHW feature maps in ``channels_last`` memory give this view for free) and
xyxy image-space boxes [B, N, 4], returning [B, N, out, out, C]; torchvision's
``aligned=False`` convention (coordinates scaled by ``spatial_scale``, no
half-pixel shift, RoI sides clamped to >= 1), ``sampling_ratio`` samples per
bin side:

  - `roi_align` (gather form): four corner gathers per sample point;
  - `roi_align_mxu` (matmul form): interpolation and sample averaging are
    linear, so pooling factorizes into per-RoI tent-weight matrices
    Wy [B, N, o, H] and Wx [B, N, o, W] and two batched matrix products.
    Sample coordinates are clipped into the map, which matches the gather
    form for in-bounds boxes.

Both are XLA compositions in the JAX package, not Pallas kernels, so plain
torch is their port. Precision: the matmul form computes its weights and
both products in float32 for float32 or narrower features and boxes (float64
where either is float64), outside autocast, as the JAX package does (float32
boxes make float32 weights, and ``jnp`` promotes bf16 features to them);
callers cast the result where they want bf16.
"""
from __future__ import annotations

import torch


def _bilinear_gather(features: torch.Tensor, bidx: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """features [B, H, W, C]; ys / xs [B, ...] continuous coords -> [B, ..., C]."""
    _, h, w, _ = features.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = (ys - y0)[..., None]
    wx1 = (xs - x0)[..., None]
    y0 = y0.to(torch.int64).clamp(0, h - 1)
    x0 = x0.to(torch.int64).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    return (features[bidx, y0, x0] * (1 - wy1) * (1 - wx1)
            + features[bidx, y0, x1] * (1 - wy1) * wx1
            + features[bidx, y1, x0] * wy1 * (1 - wx1)
            + features[bidx, y1, x1] * wy1 * wx1)


def _sample_offsets(o: int, s: int, device) -> torch.Tensor:
    """[o, s] sample positions in bin units: bin i, sample k at i + (k + .5) / s."""
    bins = torch.arange(o, dtype=torch.float32, device=device)
    samples = (torch.arange(s, dtype=torch.float32, device=device) + 0.5) / s
    return bins[:, None] + samples[None, :]


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int = 7,
              spatial_scale: float = 1.0 / 16, sampling_ratio: int = 2) -> torch.Tensor:
    """Gather form: features [B, H, W, C], boxes [B, N, 4] -> [B, N, o, o, C]."""
    bsz, n = boxes.shape[:2]
    o, s = output_size, sampling_ratio
    scaled = boxes * spatial_scale
    x1, y1, x2, y2 = scaled.unbind(-1)  # [B, N]
    bin_h = (y2 - y1).clamp(min=1.0) / o
    bin_w = (x2 - x1).clamp(min=1.0) / o
    off = _sample_offsets(o, s, boxes.device).to(boxes.dtype)
    ys = y1[..., None, None] + off * bin_h[..., None, None]  # [B, N, o, s]
    xs = x1[..., None, None] + off * bin_w[..., None, None]
    full = (bsz, n, o, s, o, s)
    ys = ys[:, :, :, :, None, None].expand(full)
    xs = xs[:, :, None, None, :, :].expand(full)
    bidx = torch.arange(bsz, device=boxes.device).view(bsz, 1, 1, 1, 1, 1)
    vals = _bilinear_gather(features, bidx, ys, xs)  # [B, N, o, s, o, s, C]
    return vals.mean(dim=(3, 5))


def roi_align_single(features: torch.Tensor, boxes: torch.Tensor, output_size: int = 7,
                     spatial_scale: float = 1.0 / 16, sampling_ratio: int = 2) -> torch.Tensor:
    """One image: features [H, W, C], boxes [N, 4] -> [N, o, o, C]."""
    return roi_align(features[None], boxes[None], output_size, spatial_scale,
                     sampling_ratio)[0]


def _interp_weights(coords: torch.Tensor, extent: int) -> torch.Tensor:
    """coords [..., S] (clipped to [0, extent - 1]) -> [..., extent]: the
    tent weights relu(1 - |y - h|) over every integer row h, averaged over
    the S samples. Bilinear interpolation is linear in the rows, so this is
    exact."""
    grid = torch.arange(extent, dtype=coords.dtype, device=coords.device)
    w = (1.0 - (coords[..., None] - grid).abs()).clamp(min=0.0)
    return w.mean(dim=-2)


def roi_align_mxu(features: torch.Tensor, boxes: torch.Tensor, output_size: int = 7,
                  spatial_scale: float = 1.0 / 16, sampling_ratio: int = 2) -> torch.Tensor:
    """Matmul form: features [B, H, W, C], boxes [B, N, 4] -> float32
    (float64 from float64 inputs) [B, N, o, o, C] as out[b, n, i, j] =
    sum_{h, w} Wy[b, n, i, h] Wx[b, n, j, w] feat[b, h, w]: one batched
    product over H, then one over W."""
    bsz, h, w, c = features.shape
    n = boxes.shape[1]
    o, s = output_size, sampling_ratio
    acc = torch.promote_types(torch.promote_types(boxes.dtype, features.dtype), torch.float32)
    with torch.autocast(features.device.type, enabled=False):
        scaled = boxes.to(acc) * spatial_scale
        x1, y1, x2, y2 = scaled.unbind(-1)
        bh = (y2 - y1).clamp(min=1.0)
        bw = (x2 - x1).clamp(min=1.0)
        off = _sample_offsets(o, s, boxes.device).to(acc).reshape(-1)  # [o * s]
        ys = (y1[..., None] + off * (bh / o)[..., None]).clamp(0, h - 1).reshape(bsz, n, o, s)
        xs = (x1[..., None] + off * (bw / o)[..., None]).clamp(0, w - 1).reshape(bsz, n, o, s)
        wy = _interp_weights(ys, h)  # [B, N, o, H]
        wx = _interp_weights(xs, w)  # [B, N, o, W]
        feat = features.to(acc).reshape(bsz, h, w * c)
        # contract H: [B, N*o, H] @ [B, H, W*C] -> [B*N, o(i), W, C]
        tmp = torch.bmm(wy.reshape(bsz, n * o, h), feat).reshape(bsz * n, o, w, c)
        # contract W, batched over (B*N, i): [o(j), W] @ [W, C] -> [B*N, i, j, C]
        out = torch.matmul(wx.reshape(bsz * n, 1, o, w), tmp)
        return out.reshape(bsz, n, o, o, c)
