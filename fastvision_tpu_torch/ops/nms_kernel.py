"""Greedy NMS suppression: the CUDA kernel's wrapper and its plain version.

`suppression_mask_cuda` launches ``csrc/nms.cu``, the Hopper replacement for
``fastvision_tpu/ops/nms_pallas.py::_nms_kernel``. `suppression_mask_plain`
computes the same keep mask with PyTorch operations; the CPU path and the
tests use it, and it is the kernel's yardstick of correctness (keep masks
must be bit-equal).

What bounds the kernel on an H100: phase 1 (the overlap bitmask) does
~K^2/2 IoUs per image at ~14 float32 operations each and moves only ~21
bytes per box, so it is bound by float32 operations (no tensor cores);
phase 2 (the greedy scan) is a K-step dependent chain per image. The design
runs phase 1 over all (image, row tile, column tile) blocks at once, skips
the tiles below the diagonal and the division for disjoint pairs, and keeps
phase 2's chain in shared memory and registers, one warp per image, all
images in parallel. The TPU kernel's one-hot reductions (a workaround for
Mosaic's lack of dynamic scalar reads) have no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from .iou import box_iou_matrix

TILE = 64
MAX_K = 32 * TILE  # the scan keeps one 64-bit removed-set word per lane


def suppression_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                           iou_thres: float) -> torch.Tensor:
    """boxes [B, K, 4] xyxy sorted by descending score, scores [B, K]
    -> bool keep [B, K]; exact greedy semantics of the JAX package's
    ``suppression_mask``, batched."""
    k = boxes.shape[-2]
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    overlap = (box_iou_matrix(boxes, boxes) > iou_thres) & later  # [B, K, K]
    valid = scores > float("-inf")
    keep = torch.zeros_like(valid)
    suppressed = torch.zeros_like(valid)
    for i in range(k):
        keep_i = ~suppressed[:, i] & valid[:, i]
        keep[:, i] = keep_i
        suppressed |= keep_i[:, None] & overlap[:, i]
    return keep


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("nms")
    fn = lib.fv_nms_suppression_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def suppression_mask_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """Launch the CUDA kernel: boxes [B, K, 4] and scores [B, K], float32,
    contiguous, on one CUDA device, K <= 2048 -> bool keep [B, K]. Raises on
    anything else, on a failed build and on a refused launch."""
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(
            f"suppression_mask_cuda needs both tensors on one CUDA device, got "
            f"{boxes.device} and {scores.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"expected float32, got {boxes.dtype} and {scores.dtype}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(
            f"expected boxes [B, K, 4] and scores [B, K], got {tuple(boxes.shape)} "
            f"and {tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    b, k = scores.shape
    if k > MAX_K or b > 65535:
        raise ValueError(f"suppression_mask_cuda takes K <= {MAX_K} and B <= 65535, "
                         f"got B={b}, K={k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    n_words = -(-k // TILE)
    # scratch, freed on return while the scan may still run: the caching
    # allocator hands it out again only in this stream's order
    mask = torch.empty((b, k, n_words), dtype=torch.int64, device=boxes.device)
    lib = _lib()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = lib.fv_nms_suppression_mask(
        boxes.data_ptr(), scores.data_ptr(), mask.data_ptr(), keep.data_ptr(),
        b, k, float(iou_thres), boxes.device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"nms kernel launch failed: {lib.fv_cuda_error_string(err).decode()} ({err})")
    suppression_mask_cuda.launches += 1
    return keep


suppression_mask_cuda.launches = 0  # kernel launches (one mask + one scan each)
