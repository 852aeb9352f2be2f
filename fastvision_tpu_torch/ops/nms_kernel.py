"""Greedy NMS suppression: the CUDA kernel's wrapper and its plain version.

`suppression_mask_cuda` launches ``csrc/nms.cu``, the Hopper replacement for
``fastvision_tpu/ops/nms_pallas.py::_nms_kernel``. `suppression_mask_plain`
computes the same keep mask with PyTorch operations; the CPU path and the
tests use it, and it is the kernel's yardstick of correctness (keep masks
must be bit-equal).

What bounds the kernel on an H100: phase 1 (the overlap bitmask) tests
~K^2/2 pairs per image, two float32 compares for a pair disjoint in x and
~14 operations for the rest, and moves only ~21 bytes per box, so it is
bound by float32 operations (no tensor cores);
phase 2 (the greedy scan) is a K-step dependent chain per image, so at the
main path's small batches its latency sets the time. Phase 1 runs over the
upper-triangle tiles only, tests the x overlap first with two compares
(class offsets make almost every pair disjoint in x) and masks the
diagonal tile afterwards instead of testing j > i per pair; it stores the
bitmask tile by tile, one word per row, so that each 64-row chunk of the
upper triangle is one contiguous block. Phase 2 runs one warp-specialised
block per image: a producer warp stages the chunks with ``cp.async.bulk``
(one copy each) into a 3-stage ring (``mbarrier``s) and builds the valid
flags as bits; the scanning warp loads a chunk's 64 diagonal words into
registers and runs the serial step on them (integer masks, two rows per
step: no branch and no memory access on the chain), while four more warps
OR the kept rows into the removed set, which lives in shared memory, so
any K up to ``MAX_K`` works. The TPU kernel's one-hot reductions (a
workaround for Mosaic's lack of dynamic scalar reads) have no counterpart
here.

The kernel is also the custom op ``fastvision::nms_suppression_mask``
(`nms_suppression_mask`, CUDA only, with a fake that gives bool [B, K]), so
that ``torch.export`` records one node for it where it cannot trace a
``ctypes`` call, and a loaded program launches it (and counts the launch)
as eager code does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from .iou import box_iou_matrix

MAX_K = 8192  # kMaxK in csrc/nms.cu: 3 staged chunks of up to 128 tiles


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
    lib.fv_nms_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fv_nms_scratch_bytes.restype = ctypes.c_longlong
    lib.fv_nms_max_k.argtypes = []
    lib.fv_nms_max_k.restype = ctypes.c_int
    lib.fv_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fv_cuda_error_string.restype = ctypes.c_char_p
    if lib.fv_nms_max_k() != MAX_K:
        raise RuntimeError(f"csrc/nms.cu takes K <= {lib.fv_nms_max_k()}, MAX_K is {MAX_K}")
    return lib


def suppression_mask_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """Launch the CUDA kernel: boxes [B, K, 4] and scores [B, K], float32,
    contiguous, boxes 16-byte aligned, on one CUDA device, K <= MAX_K ->
    bool keep [B, K]. Raises on anything else, on a failed build and on a
    refused launch."""
    device = boxes.device
    if device.type != "cuda" or scores.device != device:
        raise ValueError(
            f"suppression_mask_cuda needs both tensors on one CUDA device, got "
            f"{device} and {scores.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"expected float32, got {boxes.dtype} and {scores.dtype}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(
            f"expected boxes [B, K, 4] and scores [B, K], got {tuple(boxes.shape)} "
            f"and {tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (the kernel reads one float4 per box)")
    b, k = scores.shape
    if k > MAX_K:
        raise ValueError(f"suppression_mask_cuda takes K <= {MAX_K}, got K={k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=device)
    if b == 0 or k == 0:
        return keep
    lib = _lib()
    # scratch (its layout is the kernel's), freed on return while the scan
    # may still run: the caching allocator hands it out again only in this
    # stream's order
    mask = torch.empty(lib.fv_nms_scratch_bytes(b, k), dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.fv_nms_suppression_mask(
        boxes.data_ptr(), scores.data_ptr(), mask.data_ptr(), keep.data_ptr(),
        b, k, float(iou_thres), device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"nms kernel launch failed: {lib.fv_cuda_error_string(err).decode()} ({err})")
    suppression_mask_cuda.launches += 1
    return keep


suppression_mask_cuda.launches = 0  # kernel launches (one mask + one scan each)


@torch.library.custom_op("fastvision::nms_suppression_mask", mutates_args=(), device_types="cuda")
def nms_suppression_mask(boxes: torch.Tensor, scores: torch.Tensor,
                         iou_thres: float) -> torch.Tensor:
    """`suppression_mask_cuda` on any float32 boxes [B, K, 4] and scores
    [B, K] of one CUDA device: made contiguous, and boxes at an offset that
    is not 16-byte aligned (a view) copied, first."""
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads one float4 per box
        boxes = boxes.clone()
    return suppression_mask_cuda(boxes, scores.contiguous(), iou_thres)


@nms_suppression_mask.register_fake
def _(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float) -> torch.Tensor:
    return scores.new_empty(scores.shape, dtype=torch.bool)
