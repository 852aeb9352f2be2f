"""Image geometry and colour on the device, in plain torch (port of
fastvision_tpu/ops/image.py): a batched letterbox as two matmuls, the packed
I420 -> RGB decode, horizontal flips; and their host helpers, the canvas
packer and RGB -> I420.

`letterbox_batch` resizes each image of a fixed canvas by its own true size:
bilinear resizing is linear in the image, so one image's resize is
``Wv @ img @ Wu^T`` with [S, Hmax] and [S, Wmax] weight matrices whose rows
hold cv2 ``INTER_LINEAR``'s two taps (half-pixel centres), built from the
image's scale. The geometry is `data.dataset.letterbox`'s: scale = S /
max(h, w), (nh, nw) = round(h * scale), round(w * scale) (half to even),
centred pads. The matmuls run in float32 with TF32 off, as the JAX package
asks XLA for ``Precision.HIGHEST``.

`i420_to_rgb` inverts cv2's ``COLOR_RGB2YUV_I420``: studio-swing BT.601
(Y' = 1.164383 (Y - 16)) with 2x nearest chroma upsampling, in the caller's
dtype (bf16 on the card, as the JAX package computes it), not rounded to
integers. `rgb_batch_to_i420_packed` is OpenCV's fixed-point RGB -> I420,
bit for bit, without cv2: 20-bit coefficients with round-half-up, luma per
pixel, chroma from each 2x2 block's top-left pixel.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


@contextlib.contextmanager
def _no_tf32():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _axis_weights(out_size: int, in_max: int, n_in: torch.Tensor, n_out: torch.Tensor,
                  offset: torch.Tensor) -> torch.Tensor:
    """[B, out_size, in_max] float32 bilinear weights for one axis.

    Output pixel i (content index i - offset) samples input coordinate
    u = (i - offset + 0.5) * (n_in / n_out) - 0.5 with the taps floor(u) and
    floor(u) + 1: cv2 INTER_LINEAR's mapping of an [n_in] signal to [n_out],
    placed at ``offset``. Rows outside [offset, offset + n_out) are zero."""
    f = torch.float32
    i = torch.arange(out_size, dtype=f, device=n_in.device)[None, :]
    ic = i - offset.to(f)[:, None]
    inside = (ic >= 0) & (ic < n_out.to(f)[:, None])
    u = (ic + 0.5) * (n_in.to(f) / n_out.to(f))[:, None] - 0.5
    u = torch.minimum(torch.clamp(u, min=0.0), (n_in.to(f) - 1.0)[:, None])
    u0 = torch.floor(u)
    frac = u - u0
    src = torch.arange(in_max, dtype=f, device=n_in.device)[None, None, :]
    w = ((src == u0[..., None]) * (1.0 - frac[..., None])
         + (src == u0[..., None] + 1.0) * frac[..., None])
    return torch.where(inside[..., None], w, torch.zeros((), dtype=f, device=w.device))


def letterbox_batch(images: torch.Tensor, sizes_hw: torch.Tensor, out_size: int,
                    pad_value: float = 114.0, dtype: torch.dtype = torch.float32):
    """Batched letterbox on the device.

    images: [B, Hmax, Wmax, C] canvas (uint8 or float), each image's content
    in its top-left (h, w) corner; sizes_hw: int [B, 2] true (h, w).
    -> (out [B, S, S, C] ``dtype`` pixels in [0, 255], scales_xy [B, 2]
    float32 (nw / w, nh / h), pads_xy [B, 2] int32 (left, top))."""
    f = torch.float32
    _, hmax, wmax, _ = images.shape
    sizes = sizes_hw.to(images.device)
    h, w = sizes[:, 0], sizes[:, 1]
    scale = out_size / torch.maximum(h, w).to(f)
    nh = torch.round(h.to(f) * scale).to(torch.int32)
    nw = torch.round(w.to(f) * scale).to(torch.int32)
    top = torch.div(out_size - nh, 2, rounding_mode="floor")
    left = torch.div(out_size - nw, 2, rounding_mode="floor")
    wv = _axis_weights(out_size, hmax, h, nh, top)  # [B, S, Hmax]
    wu = _axis_weights(out_size, wmax, w, nw, left)  # [B, S, Wmax]
    img = images.to(f)
    with _no_tf32():
        tmp = torch.einsum("bsh,bhwc->bswc", wv, img)
        out = torch.einsum("btw,bswc->bstc", wu, tmp)
    # the pad region has no weight coverage: fill it with pad_value
    cover = (wv.sum(2) > 0)[:, :, None] & (wu.sum(2) > 0)[:, None, :]
    out = torch.where(cover[..., None], out, torch.tensor(pad_value, dtype=f, device=out.device))
    scales_xy = torch.stack([nw.to(f) / w.to(f), nh.to(f) / h.to(f)], dim=1)
    pads_xy = torch.stack([left, top], dim=1).to(torch.int32)
    return out.to(dtype), scales_xy, pads_xy


def letterbox_single(image: torch.Tensor, size_hw, out_size: int, pad_value: float,
                     dtype: torch.dtype = torch.float32):
    """One image of a fixed canvas -> letterboxed [S, S, C] (`letterbox_batch`
    of a batch of one). image: [Hmax, Wmax, C], its content in the top-left
    (h, w) corner; size_hw: int [2] true (h, w). -> (out [S, S, C]
    ``dtype``, scale_xy [2] float32, pad_xy [2] int32)."""
    sizes = torch.as_tensor(size_hw, device=image.device)[None]
    out, scales, pads = letterbox_batch(image[None], sizes, out_size, pad_value, dtype)
    return out[0], scales[0], pads[0]


def i420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """I420 planes -> RGB [B, S, S, 3] ``dtype`` in [0, 255]: y [B, S, S],
    u and v [B, S/2, S/2] uint8; the inverse of cv2's COLOR_RGB2YUV_I420
    (studio-swing BT.601, 2x nearest chroma upsampling), each operation in
    ``dtype``."""
    def const(x):
        return torch.tensor(x, dtype=dtype, device=y.device)

    def up(c):
        return (c.to(dtype) - 128.0).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    yf = const(1.164383) * (y.to(dtype) - 16.0)
    uf, vf = up(u), up(v)
    r = yf + const(1.596027) * vf
    g = yf - const(0.391762) * uf - const(0.812968) * vf
    b = yf + const(2.017232) * uf
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def i420_packed_to_rgb(buf: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed I420 [B, S*3/2, S] uint8 -> RGB [B, S, S, 3] ``dtype``: S rows of
    Y, then the U plane's (S/2)^2 bytes, then V's, as cv2's RGB2YUV_I420 lays
    them out."""
    b, rows, s = buf.shape
    if rows != (s * 3) // 2 or s % 2:
        raise ValueError(f"not a packed I420 buffer: {tuple(buf.shape)}")
    q = (s // 2) ** 2
    chroma = buf[:, s:, :].reshape(b, -1)
    u = chroma[:, :q].reshape(b, s // 2, s // 2)
    v = chroma[:, q:2 * q].reshape(b, s // 2, s // 2)
    return i420_to_rgb(buf[:, :s, :], u, v, dtype)


# OpenCV's RGB -> YUV (BT.601 studio swing) coefficients, 20 fractional bits
# (modules/imgproc/src/color_yuv.simd.hpp, ITUR_BT_601_*)
_SHIFT = 20
_Y = (269484, 528482, 102760)
_U = (-155188, -305135, 460324)
_V = (460324, -385875, -74448)


def _fixed(coef, r, g, b, offset: int) -> np.ndarray:
    acc = coef[0] * r + coef[1] * g + coef[2] * b + ((1 << (_SHIFT - 1)) + (offset << _SHIFT))
    return np.clip(acc >> _SHIFT, 0, 255).astype(np.uint8)


def rgb_batch_to_i420(batch: np.ndarray):
    """HOST: [B, H, W, 3] uint8 RGB -> (y [B, H, W], u, v [B, H/2, W/2]),
    cv2's COLOR_RGB2YUV_I420 bit for bit. H and W must be even."""
    b, h, w, _ = batch.shape
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even dims, got {(h, w)}")
    rgb = batch.astype(np.int64)
    r, g, bl = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = _fixed(_Y, r, g, bl, 16)
    r0, g0, b0 = r[:, ::2, ::2], g[:, ::2, ::2], bl[:, ::2, ::2]  # each 2x2 block's top-left
    return y, _fixed(_U, r0, g0, b0, 128), _fixed(_V, r0, g0, b0, 128)


def rgb_batch_to_i420_packed(batch: np.ndarray) -> np.ndarray:
    """HOST: [B, S, S, 3] uint8 RGB -> packed I420 [B, S*3/2, S] uint8."""
    y, u, v = rgb_batch_to_i420(batch)
    b, h, w = y.shape
    chroma = np.concatenate([u.reshape(b, -1), v.reshape(b, -1)], axis=1)
    return np.concatenate([y.reshape(b, -1), chroma], axis=1).reshape(b, h * 3 // 2, w)


def hflip_images(images: torch.Tensor) -> torch.Tensor:
    """Horizontal flip, NHWC."""
    return images.flip(2)


def hflip_boxes_xywhn(labels: torch.Tensor) -> torch.Tensor:
    """Flip normalized-xywh labels [..., 5] (class, cx, cy, w, h) to match
    `hflip_images`; padding rows (class == -1) pass through."""
    cx = torch.where(labels[..., 0:1] >= 0, 1.0 - labels[..., 1:2], labels[..., 1:2])
    return torch.cat([labels[..., 0:1], cx, labels[..., 2:5]], dim=-1)


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """[dsize, ssize] weights of cv2 INTER_AREA's shrink along one axis: each
    output pixel averages its source cell [d*scale, (d+1)*scale), edge pixels
    by their fractional cover (OpenCV's computeResizeAreaTab)."""
    scale = ssize / dsize
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(math.floor(f2), ssize - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[dx, s1 - 1] += np.float32((s1 - f1) / cell)
        w[dx, s1:s2] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[dx, s2] += np.float32(min(f2 - s2, 1.0, cell) / cell)
    return w


def _resize_area(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """HOST: shrink a uint8 HWC image to (height, width) with cv2 INTER_AREA's
    cover weights, within +-1 of cv2 (whose integer ratios take a fixed-point
    average)."""
    wy = _area_weights(image.shape[0], height)
    wx = _area_weights(image.shape[1], width)
    out = np.einsum("ph,hwc,qw->pqc", wy, image.astype(np.float64), wx, optimize=True)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def pack_canvas(arrs, hmax: int = 0, wmax: int = 0, pad_value: int = 114):
    """HOST: variable-size uint8 RGB images -> (canvas [B, Hmax, Wmax, 3]
    uint8, each image in its top-left corner, sizes int32 [B, 2]). An image
    larger than the canvas is first shrunk to fit (`_resize_area`, to
    (int(h s), int(w s)) with s = min(Hmax / h, Wmax / w))."""
    hmax = hmax or max(a.shape[0] for a in arrs)
    wmax = wmax or max(a.shape[1] for a in arrs)
    canvas = np.full((len(arrs), hmax, wmax, 3), pad_value, np.uint8)
    sizes = np.zeros((len(arrs), 2), np.int32)
    for i, a in enumerate(arrs):
        h, w = a.shape[:2]
        if h > hmax or w > wmax:
            s = min(hmax / h, wmax / w)
            a = _resize_area(a, int(h * s), int(w * s))
            h, w = a.shape[:2]
        canvas[i, :h, :w] = a
        sizes[i] = (h, w)
    return canvas, sizes
