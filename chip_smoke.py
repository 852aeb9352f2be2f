#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fastvision_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, with one CUDA card

Phases, each printing one JSON line ({"phase": ...}); any failure raises and
exits non-zero before a result is printed:

  1. device   the card's name, count and power limit (nvidia-smi);
  2. build    every ``csrc/*.cu`` compiled with nvcc (ptxas register and
              shared-memory report);
  3. kernel   each kernel against its plain PyTorch version on the card over
              seeded cases, clustered (trained-like) ones, K up to MAX_K
              included, and the evaluate paths' B = 32, K = 1024 at every
              IoU threshold of the sweep (keep masks must be bit-equal);
  4. e2e      the port's main path: a full-width YOLOv3 (80 classes, random
              weights from a seed, BN statistics taken from the smoke's own
              images) in ``Detector(input_size=416, batch_size=8)``, one
              ``predict_batch`` of 8 images of assorted sizes with the
              kernels' launch counts reset just before and read just after;
              then float32 heads on the card vs the CPU, and the card's
              decoded predictions through NMS on the card (kernel) vs the
              CPU (plain version);
  5. times    predict_batch images/s at batch 8 and 32 (host letterbox
              included), the device-only program (normalize + forward +
              decode + NMS from device-resident uint8), NMS split into
              candidates, kernel and the rest, and the NMS kernel (per call
              between events: back-to-back wrapper calls, "ms", and one call
              captured as a CUDA graph and replayed, "graph_ms"; the
              profiler's device time per kernel: bitmask, scan, scan ns per
              step) at B = 8 on the main path's own inputs and on clustered
              ones, B = 256 (main path x 32, and stress cases), K = 1024, and
              B = 8 clustered at K = 4096;
  6. train    the training path: one float32 SGD step of a shallow YOLOv3
              (80 classes, 256 px, TF32 off) on the card vs the CPU (its
              own line, "train_card_vs_cpu", before the checks); a
              full-width YOLOv3-416 ``Fit`` in bf16 (SGD nesterov, warmup
              cosine, EMA) for 2 epochs over 64 in-memory images at batch
              32, validated each epoch by ``detection_evaluator`` on 16
              images at batch 8 with the NMS kernel's launch count reset
              before and read after; then 10 steps on one batch (the loss
              must fall);
  7. train_times  the train step's images/s at batch 32, 416, bf16 (1
              warm-up, 8 steps, one sync, as bench.py times it), peak
              device memory, the step split between CUDA events
              (forward, loss, backward, optimizer, EMA), the profiler's
              busy share and top kernels, ``Fit`` images/s over one epoch
              (loader and host letterbox included), the evaluator per
              validation batch (forward, NMS, host mAP), and conv FLOPs per
              image with the share of the dense bf16 peak (``mfu``);
  8. frcnn_kernel  Faster R-CNN (VGG16, 20 classes, 512 px, random weights
              from a seed): the NMS kernel against its plain version,
              bit-equal, on the RPN's own top-K inputs of a full-width bf16
              forward at batch 8 (K = 1000 and 2000, IoU 0.7), on the head's
              class-offset candidates (K = 400, IoU 0.3), and on seeded
              RPN-like and head-like cases;
  9. frcnn_eval  the main path: ``make_frcnn_eval_step`` (bf16) at batch 8,
              the kernel's launches reset before and read after (2: RPN,
              head); float32 card vs CPU at 256 px (TF32 off) on RPN logits
              and deltas, class logits and boxes; proposal and detection
              selection from the card's NMS inputs, on the card (kernel)
              and the CPU (plain), identical;
  10. frcnn_train  one float32 SGD step card vs CPU at 256 px with the same
              samples and dropout masks ("frcnn_train_card_vs_cpu"); the
              JAX package's ``_train_faster_rcnn`` recipe through ``Fit``
              (bf16, batch 8, 2 epochs x 2 steps, SGD, clip 10, step decay)
              validated by ``detection_evaluator`` with the kernel's launches
              counted; 10 steps on one batch (the loss must fall);
  11. frcnn_times  eval images/s at batch 8 (device program from
              device-resident uint8) and its split (backbone, RPN + proposal
              NMS, RoI-align in both forms, head, postprocess NMS); the NMS
              kernel alone in both regimes (ms, graph_ms, bound, plain); the
              train step's images/s at batch 8 (1 warm-up, 8 steps, one
              sync); peak memory, profiles, FLOPs from the layer shapes and
              ``mfu``;
  12. cls_card_vs_cpu  one SGD step of a shallow ResNeXt (groups 32,
              1000 classes, 64 px) with mixup + cutmix + smoothing, the card
              against the CPU in float32 (TF32 off) and in float64, and float32
              forwards of full-width ResNet-50, VGG16, Darknet-53 and
              ViT-B/16 at 224 on 2 images (TF32 off);
  13. cls_train  full-width ResNet-50 (1000 classes, 224, bf16,
              channels_last) through ``Fit`` with SGD momentum and
              ``warmup_cosine_lr``, mixup 0.2 + cutmix 1.0 + smoothing 0.1,
              2 epochs x 2 steps at batch 128 over a BMP folder of 10 classes
              (``testing.write_classification_dataset``) read by
              ``ClassificationLoader(num_workers=4, worker_backend="process")``,
              whose first epoch must be byte-equal to the serial loader's;
              validated by ``classification_evaluator`` (the NMS kernel's
              launches counted: 0); 10 steps on one batch (the loss must
              fall);
  14. cls_times  the train step's images/s at batch 128 (1 warm-up, 8
              steps, one sync), its split between CUDA events, the
              profiler's busy share, peak memory, conv and Linear FLOPs and
              ``mfu``; with 0 and 4 workers, the loader's first epoch (the
              pool's start) and then, steady, the loader alone, ``Fit`` and
              the evaluator images/s; the YOLOv3 ``DetectionLoader`` (mosaic,
              hflip, HSV) alone with 0 and 4 workers over BMP files,
              byte-equal;
  15. video_card_vs_cpu  float32 forwards (TF32 off) of full-width C3D (101
              classes) and 3D-ResNet-50 (400) at 16 x 112 and SlowFast-R50
              (400, alpha 8, beta 1/8) at 32 x 224 on 2 clips, card vs CPU;
              one SGD step of a small SlowFast at 8 x 64, card vs CPU, in
              float32 and float64;
  16. video_train  full-width SlowFast-R50 (32 x 224, bf16,
              channels_last_3d) through ``Fit`` with SGD momentum and
              ``warmup_cosine_lr``, 2 epochs x 2 steps at batch 8 over BMP
              frame directories (``testing.write_video_dataset``: 16 + 8
              clips of 40 frames at 240 x 320, 4 classes) read by
              ``VideoClipLoader(num_workers=4, worker_backend="process")``,
              whose first epoch must be byte-equal to the serial loader's;
              validated by ``video_multiclip_evaluator(n_clips=4)`` (the NMS
              kernel's launches counted: 0); 10 steps on one batch (the loss
              must fall);
  17. video_times  the train step's clips/s at batch 8 (1 warm-up, 8 steps,
              one sync), its split between CUDA events, the profiler's busy
              share and top kernels, peak memory, Conv3d and Linear FLOPs and
              ``mfu``; with 0 and 4 workers the loader's first epoch, then,
              steady, the loader alone, ``Fit`` and the evaluator clips/s;
              ``VideoClassifier.predict_clip`` latency; C3D and 3D-ResNet-50
              train steps at 16 x 112, batch 32;
  18. ckpt_resume  checkpoint, preemption and resume at full width, for the
              YOLOv3-416 ``Fit`` of the train phase (bf16, EMA) and the
              Faster R-CNN-512 one of the frcnn_train phase, under
              ``torch.use_deterministic_algorithms(True, warn_only=True)``:
              run 1 trains 2 epochs with ``ckpt_dir``; run 2 is cut by
              ``request_preempt`` after the first step of epoch 2; run 3, a
              new ``Fit(resume=True)``, restores a state bit-equal to the
              one saved (model, optimizer, EMA), at the saved epoch and
              steps, and finishes; its final state must equal run 1's bit
              for bit where no op warned of a missing deterministic
              implementation, else its weights are held to the stated
              tolerance. Bytes on disk per checkpoint, the save's host copy
              (the step loop's stall), ``wait()``, restore seconds; the free
              disk space first;
  19. evaluate  ``Detector(input_size=416, batch_size=32)`` with run 1's
              EMA weights over 64 images of assorted sizes labelled with
              the detector's own jittered detections (so that mAP is not
              0): the kernel against its plain version, bit-equal, on the
              first batch's predictions at every grid point's thresholds;
              ``evaluate`` with device and with host matching (equal
              mAP wherever the two matching rules agree; the device's mAP
              equal to the host's boxes scored under the device's rule
              always), ``evaluate_sweep`` over the reference's 9 points
              and 2 at conf 0.001 against as many per-point ``evaluate``s
              (equal rows), images/s and kernel launches of each;
  20. cli     ``fastvision_tpu_torch.cli.main`` in-process over BMP files
              from ``testing.write_detection_dataset``, on the config's
              worker pools: ``train`` YOLOv3-416 with the default recipe
              (mosaic 0.5, hflip, HSV) for 2 epochs, ``train --resume`` to 3,
              ``eval --ckpt ... --sweep``, and ``train model.name=faster_rcnn``
              at 512 for 1 epoch; ``train-cls`` ResNet-50-224 over the
              cls_train folder for 1 epoch, ``--resume`` to 2, ``eval --task
              cls --ckpt``; ``train-video`` SlowFast-R50 (32 x 224) over the
              video_train clips for 1 epoch, ``--resume`` to 2, ``eval --task
              video --ckpt`` with 4 clips a video (its accuracy equal to the
              run's last validation); epoch images/s with decode and
              augmentation, launches per command (0 for the classification
              and video ones); then the run's total seconds.

The line before the last is {"kernels": [...]}, one entry per kernel of the
port, with its launches on every path (the classification and video paths
counted and required at 0: they run no NMS); the last line is {"ok": true,
"device": {...}}. Without a CUDA card the script exits 1 at once.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from fastvision_tpu_torch import cuda_build
from fastvision_tpu_torch.core import MetricLogger, restore_inference_weights
from fastvision_tpu_torch.data import (
    Augmentation,
    ClassificationDataset,
    ClassificationLoader,
    DetectionDataset,
    DetectionLoader,
    HorizontalFlip,
    HSVJitter,
    VideoClipLoader,
    VideoFolderDataset,
    normalize_images,
)
from fastvision_tpu_torch.infer import (
    REFERENCE_SWEEP,
    Detector,
    VideoClassifier,
    decode_predictions,
    preprocess_batch,
    scale_coords,
)
from fastvision_tpu_torch.models import FasterRCNN, YOLOv3
from fastvision_tpu_torch.models.classification import (
    Bottleneck,
    ResNet,
    darknet53,
    resnet50,
    vgg16,
    vit_base_patch16,
)
from fastvision_tpu_torch.models.detection import (
    detection_candidates,
    fastrcnn_postprocess,
    make_draws,
    proposal_candidates,
    select_detections,
    select_proposals,
)
from fastvision_tpu_torch.models.video import SlowFast, c3d, resnet50_3d, slowfast_resnet50
from fastvision_tpu_torch.ops import (
    COCO_ANCHORS,
    MeanAveragePrecision,
    batched_non_max_suppression,
    match_predictions,
    match_predictions_device,
    nms_candidates,
    roi_align,
    roi_align_mxu,
)
from fastvision_tpu_torch.ops.nms_kernel import (
    MAX_K,
    suppression_mask_cuda,
    suppression_mask_plain,
)
from fastvision_tpu_torch.testing import (
    SyntheticDetectionDataset,
    nms_case,
    rpn_nms_case,
    state_max_rel_diff,
    write_classification_dataset,
    write_detection_dataset,
    write_video_dataset,
)
from fastvision_tpu_torch.train import (
    Fit,
    TrainState,
    YOLOv3Loss,
    build_optimizer,
    classification_evaluator,
    constant_lr,
    cross_entropy,
    detection_evaluator,
    ema_update,
    labels_to_pixel_xyxy,
    make_classification_mix,
    make_eval_step,
    make_frcnn_eval_step,
    make_frcnn_train_step,
    make_train_step,
    set_lr,
    soft_cross_entropy,
    step_decay_lr,
    video_multiclip_evaluator,
    warmup_cosine_lr,
)

SEED = 0
INPUT_SIZE = 416
NUM_CLASSES = 80
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12  # dense tensor cores
# float32 operations per box pair of the IoU test: 2 min, 2 max, 2 sub and
# 2 clamps for the overlap, 1 mul, add-sub-add for the union, 1 div, 1 compare;
# a pair disjoint in x is decided by 2 compares (x1_j < x2_i and x1_i < x2_j)
NMS_OPS_PER_PAIR = 14
NMS_OPS_PER_X_DISJOINT_PAIR = 2
BATCH_NORMS = (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)
CONVS = (torch.nn.Conv2d, torch.nn.Conv3d)
SIZES = ((416, 416), (480, 640), (640, 360), (200, 300),
         (375, 500), (720, 1280), (300, 200), (416, 240))
EVAL_IMAGES, EVAL_BATCH = 64, 32
# the evaluate phase's grid: the reference sweep and two low-confidence points
EVAL_POINTS = REFERENCE_SWEEP + [(0.001, 0.45), (0.001, 0.65)]
SWEEP_IOUS = sorted({iou for _, iou in EVAL_POINTS})


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **data) -> None:
    print(json.dumps({"phase": phase, **data}), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` between CUDA events, warmed up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` captured once as a CUDA graph
    and replayed: the device's time per call, launch gaps included, without
    the host's Python and launch cost (which exceeds a small kernel's)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps=reps, warmup=10)


def host_s(fn, reps: int, warmup: int = 1) -> float:
    """Mean host seconds per call of ``fn`` (which ends in a device sync)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def no_tf32():
    """float32 convs and matmuls without TF32, for comparisons with the CPU."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms(True, warn_only=True) and cuDNN's
    deterministic algorithms; yields the list that collects PyTorch's
    warnings for the ops that ran without a deterministic implementation
    (empty: every op of the block was deterministic). cuBLAS needs
    CUBLAS_WORKSPACE_CONFIG from before its first call (main sets it).
    Uninitialised memory is not filled (PyTorch's NaN fill of every
    ``torch.empty`` doubles the checkpoint's host copy and adds a kernel
    per allocation): an op that read such memory would show as runs that
    differ, which the caller checks."""
    from torch.utils import deterministic as fill

    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             fill.fill_uninitialized_memory)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        fill.fill_uninitialized_memory = False
        found: list[str] = []
        try:
            yield found
        finally:
            torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[2:4]
            fill.fill_uninitialized_memory = flags[4]
            found.extend(sorted({str(w.message)[:200] for w in caught
                                 if "deterministic" in str(w.message)}))


def _is_range(ev) -> bool:
    """A record_function range mirrored on the device timeline (e.g.
    "Optimizer.step#SGD.step"): it spans kernels counted already. Older
    profilers do not flag them; there the '#' tells them from kernels,
    whose names hold '#' only in lambda numbering ("{lambda()#1}")."""
    return bool(getattr(ev, "is_user_annotation", False)) or (
        "#" in ev.key and "lambda" not in ev.key)


def device_profile(fn, reps: int, top: int = 8) -> dict:
    """torch.profiler over ``reps`` calls of ``fn``: wall and device-kernel
    milliseconds per call, the device's busy share of the wall time, and
    the ``top`` kernels by device time (ms per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels, launches = {}, 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type.name == "CUDA" and not _is_range(ev):
            kernels[ev.key[:90]] = us / 1e3 / reps
            launches += ev.count
    busy_ms = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else None,
            "device_ops_per_call": launches / reps, "top_kernels_ms": dict(ranked)}


def nms_bound(boxes: torch.Tensor, scores: torch.Tensor,
              keep: torch.Tensor) -> tuple[float, str, dict]:
    """Least time for greedy suppression of this data on an H100: each kept
    box tested against every later valid box (NMS_OPS_PER_PAIR float32
    operations for a pair that overlaps in x, NMS_OPS_PER_X_DISJOINT_PAIR for
    one disjoint in x, which IoU > thr >= 0 cannot pass; plus 3 per valid box
    for its area) over the float32 peak, against boxes and scores read once
    and the keep mask written once over the memory rate."""
    b, k = scores.shape
    valid = scores > float("-inf")
    later = torch.ones(k, k, dtype=torch.bool, device=scores.device).triu(1)
    pairs = torch.zeros((), dtype=torch.int64, device=scores.device)
    x_pairs = torch.zeros_like(pairs)
    for i in range(b):  # one image at a time: [K, K] at most
        x1, x2 = boxes[i, :, 0], boxes[i, :, 2]
        p = later & keep[i, :, None] & valid[i, None, :]  # (kept i, later valid j)
        pairs += p.sum()
        x_pairs += (p & (x1[None, :] < x2[:, None]) & (x1[:, None] < x2[None, :])).sum()
    pairs, x_pairs = int(pairs), int(x_pairs)
    ops = (NMS_OPS_PER_PAIR * x_pairs + NMS_OPS_PER_X_DISJOINT_PAIR * (pairs - x_pairs)
           + 3 * int(valid.sum()))
    n_bytes = b * k * (4 * 4 + 4 + 1)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_S
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return 1e3 * max(t_ops, t_bytes), bound_by, {
        "pairs": pairs, "x_overlap_pairs": x_pairs, "ops": ops, "bytes": n_bytes}


def images(seed: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, SIZES[i % len(SIZES)] + (3,), dtype=np.uint8) for i in range(n)]


def calibrate_bn_(model: torch.nn.Module, x: torch.Tensor) -> None:
    """Random weights leave BN's statistics at (0, 1), so activations drift
    through 75 layers; set them from one float32 batch so the heads give
    scores in a realistic range and NMS gets real work."""
    for m in model.modules():
        if isinstance(m, BATCH_NORMS):
            m.reset_running_stats()
            m.momentum = None  # cumulative average: one batch sets the stats
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()


def phase_device() -> dict:
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    emit("device", name=name, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return {"kind": name, "count": count, "smi": smi}


def phase_build() -> None:
    t0 = time.perf_counter()
    builds = cuda_build.build_all()
    report = []
    for b in builds:
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        report.append({"source": f"csrc/{b.name}.cu", "nvcc_s": round(b.seconds, 3),
                       "ptxas": ptxas})
    emit("build", seconds=round(time.perf_counter() - t0, 3), builds=report)


def kernel_cases():
    """(group, seed, B, K, iou_thres, nms_case flags) of phase_kernel: 48
    stress and random cases, clustered (trained-like, heavy suppression)
    ones, K above 2048 up to the kernel's MAX_K, and the evaluate paths'
    B = 32, K = 1024 at each IoU threshold of the reference sweep."""
    stress = dict()  # class offsets, ties, -inf tail, on-threshold pairs
    plain = dict(ties=False, neg_inf_tail=False, on_threshold=False)
    clustered = dict(plain, clusters=20)
    for b in (1, 8, 256):
        for k in (1, 37, 64, 1024):
            for thr in (0.45, 0.6):
                for flags in (stress, plain):
                    yield "base", SEED + 1000 * b + k, b, k, thr, flags
    for b in (1, 8, 256):
        for k in (64, 1024):
            for thr in (0.45, 0.6):
                yield "clustered", SEED + 7 + 1000 * b + k, b, k, thr, clustered
    for b, k in ((2, 2049), (2, 4096), (1, MAX_K)):
        for flags in (stress, clustered):
            yield "large_k", SEED + 11 + k, b, k, 0.45, flags
    # the evaluate paths' batch and candidates at the sweep's IoU thresholds
    for thr in SWEEP_IOUS:
        for flags in (stress, clustered):
            yield "sweep", SEED + 13 + int(100 * thr), EVAL_BATCH, 1024, thr, flags


def phase_kernel(dev: torch.device) -> dict:
    """Kernel vs plain over seeded cases; returns the totals."""
    cases = mismatches = max_abs = 0
    groups: dict = {}
    for group, seed, b, k, thr, flags in kernel_cases():
        boxes, scores = nms_case(seed, b, k, thr, **flags)
        boxes = torch.from_numpy(boxes).to(dev)
        scores = torch.from_numpy(scores).to(dev)
        got = suppression_mask_cuda(boxes, scores, thr)
        want = suppression_mask_plain(boxes, scores, thr)
        diff = (got.to(torch.int8) - want.to(torch.int8)).abs()
        g = groups.setdefault(group, {"cases": 0, "mismatches": 0, "kept": 0, "boxes": 0})
        g["cases"] += 1
        g["mismatches"] += int(diff.sum())
        g["kept"] += int(want.sum())
        g["boxes"] += b * k
        mismatches += int(diff.sum())
        max_abs = max(max_abs, int(diff.max()))
        cases += 1
    torch.cuda.synchronize()
    emit("kernel", name="nms_suppression_mask", cases=cases, mismatches=mismatches,
         max_abs_err=max_abs, tolerance="bit-equal", max_k=MAX_K, groups=groups,
         launches=suppression_mask_cuda.launches)
    check(mismatches == 0, f"nms kernel disagrees with its plain version: {mismatches} flags")
    return {"mismatches": mismatches, "max_abs_err": max_abs}


def phase_e2e(dev: torch.device) -> dict:
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()  # deepest level first
    model = YOLOv3(num_classes=NUM_CLASSES, generator=torch.Generator().manual_seed(SEED))
    imgs = images(SEED, 8)
    batch, _ = preprocess_batch(imgs, INPUT_SIZE)
    x32 = normalize_images(torch.from_numpy(batch), torch.float32)
    calibrate_bn_(model.to(dev), x32.to(dev))
    det = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=8)
    check(det.device.type == "cuda", f"Detector picked {det.device}")

    # --- the main path, counted
    suppression_mask_cuda.launches = 0
    t0 = time.perf_counter()
    results = det.predict_batch(imgs)
    first_call_s = time.perf_counter() - t0
    launches = suppression_mask_cuda.launches
    check(launches >= 1, "the main path never launched the nms kernel")
    n_boxes = [len(r["boxes"]) for r in results]
    for r, im in zip(results, imgs):
        h, w = im.shape[:2]
        bx = r["boxes"]
        check(np.isfinite(bx).all() and np.isfinite(r["scores"]).all(), "non-finite output")
        check((bx >= 0).all() and (bx[:, [0, 2]] <= w).all() and (bx[:, [1, 3]] <= h).all(),
              "a box lies outside its image")
        check(((r["classes"] >= 0) & (r["classes"] < NUM_CLASSES)).all(), "class out of range")
    check(sum(n_boxes) > 0, "no detections at all: NMS got no work")

    # --- float32 heads on the card vs the CPU, two images
    cpu_model = copy.deepcopy(det.model).cpu()
    with no_tf32(), torch.inference_mode():
        heads_dev = [h.float().cpu() for h in det.model(x32[:2].to(dev))]
        heads_cpu = cpu_model(x32[:2])
    head_rel = [float((a - b).abs().max() / b.std()) for a, b in zip(heads_dev, heads_cpu)]
    check(max(head_rel) <= 1e-3, f"fp32 heads card vs cpu: max|d|/std {head_rel} > 1e-3")

    # --- the card's decoded predictions: NMS on the card (kernel) vs the CPU (plain)
    u8 = torch.from_numpy(batch).to(dev)
    pred = det.predecode(u8).float()
    kw = dict(conf_thres=det.conf_thres, iou_thres=det.iou_thres, max_det=det.max_det,
              class_offset=det.class_offset)
    on_card = batched_non_max_suppression(pred, **kw)
    on_cpu = batched_non_max_suppression(pred.cpu(), **kw)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    check(same, "Detections from the kernel path differ from the plain CPU path")
    _, nms_boxes, top_scores, _ = nms_candidates(
        pred, conf_thres=det.conf_thres, class_offset=det.class_offset)
    nms_boxes, top_scores = nms_boxes.contiguous(), top_scores.contiguous()  # the K-slice is a view
    keep = suppression_mask_cuda(nms_boxes, top_scores, det.iou_thres)
    main_mismatches = int((keep != suppression_mask_plain(nms_boxes, top_scores, det.iou_thres)).sum())
    check(main_mismatches == 0, f"nms kernel vs plain on the main path's inputs: {main_mismatches}")
    emit("e2e", model="YOLOv3 Darknet-53, 80 classes, full width and depth",
         input_size=INPUT_SIZE, batch=8, image_hw=[list(s) for s in SIZES],
         launches=launches, boxes_per_image=n_boxes, first_call_s=round(first_call_s, 3),
         head_max_abs_over_std=head_rel, head_tolerance=1e-3,
         nms_card_equals_cpu=same, kernel_mismatches_on_main_path_inputs=main_mismatches,
         valid_candidates=int((top_scores > float("-inf")).sum()),
         candidates_shape=list(top_scores.shape))
    return {"det": det, "model": model, "anchors": anchors, "launches": launches,
            "nms_boxes": nms_boxes, "top_scores": top_scores}


def phase_times(dev: torch.device, e2e: dict, smi: str) -> dict:
    det8, anchors = e2e["det"], e2e["anchors"]
    det32 = Detector(e2e["model"], anchors, input_size=INPUT_SIZE, batch_size=32)
    out: dict = {}
    for bs, det in ((8, det8), (32, det32)):
        imgs = images(SEED + bs, bs)
        s = host_s(lambda: det.predict_batch(imgs), reps=5)
        pre_s = host_s(lambda: preprocess_batch(imgs, INPUT_SIZE), reps=3)
        u8 = torch.from_numpy(preprocess_batch(imgs, INPUT_SIZE)[0]).to(dev)
        torch.cuda.reset_peak_memory_stats()
        prog_ms = cuda_ms(lambda: det.infer(u8), reps=10)
        peak = torch.cuda.max_memory_allocated()
        pred = det.predecode(u8).float()
        fwd_ms = cuda_ms(lambda: det.predecode(u8), reps=10)
        nms_ms = cuda_ms(lambda: batched_non_max_suppression(
            pred, conf_thres=det.conf_thres, iou_thres=det.iou_thres, max_det=det.max_det,
            class_offset=det.class_offset), reps=20)
        # its parts: candidates (confidence mask, sort, top-K, gathers), the
        # kernel on their output, and the rest (gathers of max_det outputs)
        def cand(pred=pred, det=det):
            return nms_candidates(pred, conf_thres=det.conf_thres, class_offset=det.class_offset)

        cand_ms = cuda_ms(cand, reps=20)
        _, nb, ns, _ = cand()
        nb, ns = nb.contiguous(), ns.contiguous()
        kernel_ms = cuda_ms(lambda: suppression_mask_cuda(nb, ns, det.iou_thres), reps=20)
        out[f"bs{bs}"] = {
            "predict_batch_img_s": bs / s, "predict_batch_ms": 1e3 * s,
            "host_letterbox_ms": 1e3 * pre_s,
            "device_program_ms": prog_ms, "device_program_img_s": bs / (prog_ms / 1e3),
            "normalize_forward_decode_ms": fwd_ms, "nms_total_ms": nms_ms,
            "nms_split_ms": {"candidates_sort_topk_gathers": cand_ms, "kernel": kernel_ms,
                             "rest": nms_ms - cand_ms - kernel_ms},
            "peak_device_mib": peak / 2**20,
            "device_program_profile": device_profile(lambda: det.infer(u8), 5),
        }

    # the NMS kernel alone: the main path's own inputs (B = 8), clustered
    # (trained-like) inputs, B = 256, and K = 4096
    thr = det8.iou_thres
    boxes8, scores8 = e2e["nms_boxes"], e2e["top_scores"]
    tiled = [t.repeat(32, *([1] * (t.ndim - 1))).contiguous() for t in (boxes8, scores8)]
    clustered = dict(ties=False, neg_inf_tail=False, on_threshold=False, clusters=20)

    def case(b, k, **flags):
        return tuple(torch.from_numpy(a).to(dev) for a in nms_case(SEED, b, k, thr, **flags))

    kern: dict = {}
    for tag, (bx, sc), with_plain in (
            ("B8_main_path", (boxes8, scores8), True),
            ("B8_clustered", case(8, 1024, **clustered), False),
            ("B256_main_path_x32", tiled, True),
            ("B256_stress", case(256, 1024), False),
            ("B8_K4096_clustered", case(8, 4096, **clustered), False)):
        keep = suppression_mask_cuda(bx, sc, thr)
        bound_ms, bound_by, work = nms_bound(bx, sc, keep)
        prof = device_profile(lambda: suppression_mask_cuda(bx, sc, thr), 20)
        split = {name: sum(v for key, v in prof["top_kernels_ms"].items() if name in key)
                 for name in ("overlap_mask_kernel", "greedy_scan_kernel")}
        kern[tag] = {
            "shape": list(sc.shape),
            "ms": cuda_ms(lambda: suppression_mask_cuda(bx, sc, thr), reps=200, warmup=10),
            "graph_ms": graph_ms(lambda: suppression_mask_cuda(bx, sc, thr), reps=200),
            "device_ms": prof["device_ms"], "bitmask_ms": split["overlap_mask_kernel"],
            "scan_ms": split["greedy_scan_kernel"],
            "scan_ns_per_step": 1e6 * split["greedy_scan_kernel"] / sc.shape[1],
            "plain_ms": (cuda_ms(lambda: suppression_mask_plain(bx, sc, thr), reps=3, warmup=1)
                         if with_plain else None),
            "bound_ms": bound_ms, "bound_by": bound_by, "kept": int(keep.sum()),
            "valid": int((sc > float("-inf")).sum()), **work,
        }
    out["nms_kernel"] = kern
    out["clocks_power"] = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    emit("times", card=smi, **out)
    return out


TRAIN_BATCH = 32  # bench.py's train config: batch 32 at 416, bf16
TRAIN_IMAGES = 64  # per epoch of the smoke's Fit: 2 steps
VAL_IMAGES, VAL_BATCH = 16, 8


def conv_flops_per_image(model: torch.nn.Module, size: int) -> float:
    """Forward multiply-adds x 2 of every convolution at ``size``, counted
    from the layer shapes (one image, eval mode, on the model's device)."""
    total = 0

    def hook(m, _, out):
        nonlocal total
        total += 2 * math.prod(m.kernel_size) * m.in_channels // m.groups * out[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, CONVS)]
    was_training = model.training
    try:
        model.eval()
        with torch.inference_mode():
            model(torch.zeros(1, size, size, 3, device=next(model.parameters()).device))
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return float(total)


def train_parts(anchors: np.ndarray, num_classes: int = NUM_CLASSES):
    """The training recipe of examples/train_yolov3.py: YOLOv3Loss, the
    v5 decode + NMS for validation."""
    loss = YOLOv3Loss(anchors, num_classes=num_classes)
    anchors_t = torch.from_numpy(anchors)

    def loss_fn(heads, batch):
        out = loss(heads, batch["labels"])
        return out.total, {"box": out.box, "obj": out.obj, "cls": out.cls}

    def postprocess(heads, batch):
        pred = decode_predictions(heads, anchors_t.to(heads[0].device))
        return batched_non_max_suppression(pred.float(), conf_thres=0.001, max_det=300)

    return loss_fn, postprocess


def device_batch_of(loader, dev: torch.device) -> dict:
    batch = next(iter(loader))
    return {k: torch.from_numpy(batch[k]).to(dev) for k in ("images", "labels")}


def phase_train(dev: torch.device) -> dict:
    """Training path: one fp32 step card vs CPU, a full-width bf16 Fit with
    validation through the NMS kernel, and a learning check."""
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    loss_fn, postprocess = train_parts(anchors)

    # --- 1. one float32 SGD step, TF32 off: the card against the CPU
    small = YOLOv3(num_classes=NUM_CLASSES, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(SEED))
    small_cpu = copy.deepcopy(small)
    start = {k: v.clone() for k, v in small.state_dict().items()}
    batch = next(iter(DetectionLoader(SyntheticDetectionDataset(4, NUM_CLASSES, seed=SEED + 1),
                                      256, 4, max_boxes=16, seed=SEED)))
    step32 = make_train_step(loss_fn)
    with no_tf32():
        card = TrainState.create(small, build_optimizer("sgd", small), dev)
        cpu = TrainState.create(small_cpu, build_optimizer("sgd", small_cpu), "cpu")
        _, m_card = step32(card, {k: torch.from_numpy(batch[k]).to(dev)
                                  for k in ("images", "labels")}, 1e-2)
        _, m_cpu = step32(cpu, {k: torch.from_numpy(batch[k]) for k in ("images", "labels")},
                          1e-2)
        torch.cuda.synchronize()
    # tolerances: see tests/test_torch_gpu.py::test_train_step_on_card_equals_cpu
    card_vs_cpu = {"model": "YOLOv3 stage_sizes (1,1,1,1,1), 80 classes, 256 px, batch 4, "
                            "float32, TF32 off, one SGD step at lr 1e-2",
                   "loss_rel": abs(float(m_card["loss"]) / float(m_cpu["loss"]) - 1),
                   "grad_norm_rel": abs(float(m_card["grad_norm"]) / float(m_cpu["grad_norm"]) - 1),
                   "state_max_rel": state_max_rel_diff(small.state_dict(),
                                                       small_cpu.state_dict(), start),
                   "tolerances": {"loss_rel": 1e-4, "kernels": 1e-3, "others": 1e-2}}
    emit("train_card_vs_cpu", **card_vs_cpu)
    check(card_vs_cpu["loss_rel"] <= 1e-4, f"train step card vs cpu: {card_vs_cpu}")
    check(card_vs_cpu["state_max_rel"]["kernels"][0] <= 1e-3
          and card_vs_cpu["state_max_rel"]["others"][0] <= 1e-2,
          f"train step card vs cpu: {card_vs_cpu}")
    del small, small_cpu, card, cpu

    # --- 2. full-width Fit in bf16, validation counted through the NMS kernel
    model = YOLOv3(num_classes=NUM_CLASSES, generator=torch.Generator().manual_seed(SEED))
    train_loader = DetectionLoader(SyntheticDetectionDataset(TRAIN_IMAGES, NUM_CLASSES, seed=SEED),
                                   INPUT_SIZE, TRAIN_BATCH, max_boxes=32, seed=SEED)
    val_loader = DetectionLoader(SyntheticDetectionDataset(VAL_IMAGES, NUM_CLASSES, seed=SEED + 2),
                                 INPUT_SIZE, VAL_BATCH, max_boxes=32, train=False)
    evaluate = detection_evaluator(make_eval_step(postprocess, dtype=torch.bfloat16))
    val_launches = []

    def counted_evaluator(state, loader):
        suppression_mask_cuda.launches = 0
        out = evaluate(state, loader)
        torch.cuda.synchronize()
        val_launches.append(suppression_mask_cuda.launches)
        return out

    records = []

    class Log:
        def log(self, step, **kw):
            records.append({"step": step, **kw})

    epochs = 2
    fit = Fit(model, loss_fn, build_optimizer("sgd", model, weight_decay=5e-4, momentum=0.937),
              train_loader, val_loader, epochs=epochs,
              schedule=warmup_cosine_lr(1e-2, 1e-4, epochs * len(train_loader), warmup_steps=1),
              evaluator=counted_evaluator, ema_decay=0.9999, dtype=torch.bfloat16,
              metric_key="map50", metric_mode="max", logger=Log())
    check(fit.device == dev, f"Fit picked {fit.device}")
    t0 = time.perf_counter()
    fit.run()
    fit_s = time.perf_counter() - t0
    per_epoch = [r for r in records if "train_loss" in r]
    check(len(per_epoch) == epochs and fit.global_step == epochs * len(train_loader),
          f"Fit ran {fit.global_step} steps over {len(per_epoch)} epochs")
    check(all(np.isfinite(r["train_loss"]) for r in per_epoch), f"train loss {per_epoch}")
    check(all(0.0 <= r["map50"] <= 1.0 and 0.0 <= r["map"] <= 1.0 for r in per_epoch),
          f"map out of range: {per_epoch}")
    check(len(val_launches) == epochs and min(val_launches) > 0,
          f"validation launched the nms kernel {val_launches} times")

    # --- 3. learning check: 10 steps on one fixed batch
    step = make_train_step(loss_fn, dtype=torch.bfloat16)
    fixed = device_batch_of(train_loader, dev)
    losses = []
    for _ in range(10):
        _, m = step(fit.state, fixed, 1e-2)
        losses.append(m["loss"])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    check(losses[-1] < losses[0], f"loss did not fall over 10 steps on one batch: {losses}")
    emit("train", fit={"model": "YOLOv3 Darknet-53, 80 classes, full width and depth, bf16 autocast",
              "input_size": INPUT_SIZE, "batch": TRAIN_BATCH, "train_images": TRAIN_IMAGES,
              "val_images": VAL_IMAGES, "val_batch": VAL_BATCH, "epochs": epochs,
              "global_step": fit.global_step, "seconds_first_run": fit_s,
              "per_epoch": per_epoch, "val_nms_launches": val_launches},
         learning_check_losses=losses)
    return {"fit": fit, "loss_fn": loss_fn, "postprocess": postprocess,
            "val_loader": val_loader, "val_launches": sum(val_launches)}


def phase_train_times(dev: torch.device, train: dict, smi: str) -> dict:
    """Train readings at batch 32, 416, bf16 (bench.py's train config)."""
    fit, loss_fn = train["fit"], train["loss_fn"]
    state, model = fit.state, fit.state.model
    step = make_train_step(loss_fn, dtype=torch.bfloat16)
    batch = device_batch_of(fit.train_loader, dev)
    out: dict = {"card": smi}

    # step img/s as bench.py times it: 1 warm-up, 8 steps, one sync
    torch.cuda.reset_peak_memory_stats()
    float(step(state, batch, 1e-3)[1]["loss"])
    t0 = time.perf_counter()
    for _ in range(8):
        _, metrics = step(state, batch, 1e-3)
    float(metrics["loss"])
    step_s = (time.perf_counter() - t0) / 8
    out["train_step_img_s"] = TRAIN_BATCH / step_s
    out["train_step_ms"] = 1e3 * step_s
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20

    # the step's parts between CUDA events
    ema = [p.detach().clone() for p in model.parameters()]
    params = list(model.parameters())
    parts = {"forward": 0.0, "loss": 0.0, "backward": 0.0, "optimizer": 0.0, "ema": 0.0}
    reps = 5
    for i in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        model.zero_grad(set_to_none=True)
        ev[0].record()
        x = normalize_images(batch["images"], torch.bfloat16)
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            heads = model(x)
        ev[1].record()
        loss, _ = loss_fn(heads, batch)
        ev[2].record()
        loss.backward()
        ev[3].record()
        set_lr(state.optimizer, 1e-3)
        state.optimizer.step()
        ev[4].record()
        ema_update(ema, params, 100 + i)
        ev[5].record()
        ev[5].synchronize()
        if i:  # the first is a warm-up
            for name, a, b in zip(parts, ev[:-1], ev[1:]):
                parts[name] += a.elapsed_time(b) / reps
    out["step_split_ms"] = parts

    # Fit over one epoch: loader, host letterbox and H2D included
    fit_epoch = Fit(model, loss_fn, state.optimizer, DetectionLoader(
        SyntheticDetectionDataset(2 * TRAIN_IMAGES, NUM_CLASSES, seed=SEED + 3), INPUT_SIZE,
        TRAIN_BATCH, max_boxes=32, seed=SEED), epochs=1, ema_decay=0.9999,
        dtype=torch.bfloat16, schedule=constant_lr(1e-3), logger=MetricLogger(stdout=False))
    t0 = time.perf_counter()
    fit_epoch.run()
    fit_s = time.perf_counter() - t0
    out["fit_epoch_img_s"] = fit_epoch.global_step * TRAIN_BATCH / fit_s
    out["fit_epoch_steps"] = fit_epoch.global_step

    # the evaluator per validation batch: forward, NMS, host mAP
    eval_model = fit.eval_state().model.eval()
    anchors_t = torch.from_numpy(COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()).to(dev)
    vb = next(iter(train["val_loader"]))
    u8 = torch.from_numpy(vb["images"]).to(dev)
    with torch.inference_mode():
        def fwd():
            with torch.autocast(dev.type, dtype=torch.bfloat16):
                heads = eval_model(normalize_images(u8, torch.bfloat16))
            return decode_predictions(heads, anchors_t).float()

        fwd_ms = cuda_ms(fwd, reps=10)
        pred = fwd()
        nms_ms = cuda_ms(lambda: batched_non_max_suppression(pred, conf_thres=0.001,
                                                             max_det=300), reps=10)
        det = batched_non_max_suppression(pred, conf_thres=0.001, max_det=300)
    boxes, scores, classes, valid = (t.cpu().numpy() for t in det)

    def host_map():
        m = MeanAveragePrecision()
        for i in range(vb["num_real"]):
            meta, v = vb["meta"][i], valid[i]
            gt = meta["gt_pixels"]
            m.update(scale_coords(boxes[i][v], meta["scale"], meta["pad"], meta["orig_hw"]),
                     scores[i][v], classes[i][v], gt[:, 1:5], gt[:, 0])
        return m.compute()

    map_ms = 1e3 * host_s(host_map, reps=3)
    out["eval_per_val_batch_ms"] = {"batch": VAL_BATCH, "forward_decode": fwd_ms,
                                    "nms": nms_ms, "host_map": map_ms,
                                    "detections": int(valid.sum())}

    # last: the profiler may leave the host's launches slower after it
    prof = device_profile(lambda: step(state, batch, 1e-3), reps=3, top=10)
    prof["device_share_of_unprofiled_step"] = prof["device_ms"] / out["train_step_ms"]
    out["step_profile"] = prof

    fwd_flops = conv_flops_per_image(model, INPUT_SIZE)
    train_flops = 3 * fwd_flops
    out["flops_per_image"] = {"forward": fwd_flops, "train_3x_forward": train_flops}
    out["mfu"] = train_flops * out["train_step_img_s"] / PEAK_BF16_FLOPS
    out["mfu_peak"] = "989e12 dense bf16 (H100 SXM data sheet, at 700 W)"
    out["clocks_power"] = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    emit("train_times", **out)
    return out

# ---------------------------------------------------------------------------
# Faster R-CNN (VGG16, 512 px, VOC's 20 classes): the JAX package's default
# ---------------------------------------------------------------------------
FRCNN_SIZE, FRCNN_CLASSES, FRCNN_BATCH = 512, 20, 8
FRCNN_TRAIN_IMAGES, FRCNN_VAL_IMAGES = 16, 8  # per epoch of the smoke's Fit: 2 steps
# the recipe of the JAX package's cli.py::_train_faster_rcnn with the toy
# convergence run's settings (examples/toy_convergence.py): SGD, global-norm
# clip 10, step decay x0.1 every 8 epochs, score 0.05 and the config's IoU
# 0.45 for validation
FRCNN_LR, FRCNN_VAL = 1e-2, dict(score_thresh=0.05, nms_thresh=0.45)


def frcnn_model(seed: int = SEED, image_size: int = FRCNN_SIZE) -> FasterRCNN:
    return FasterRCNN(num_classes=FRCNN_CLASSES, image_size=image_size,
                      generator=torch.Generator().manual_seed(seed))


def frcnn_loader(n: int, seed: int, batch: int = FRCNN_BATCH, size: int = FRCNN_SIZE,
                 train: bool = True) -> DetectionLoader:
    return DetectionLoader(SyntheticDetectionDataset(n, FRCNN_CLASSES, seed=seed), size, batch,
                           max_boxes=16, seed=seed, train=train)


def frcnn_u8(dev: torch.device, n: int = FRCNN_BATCH, size: int = FRCNN_SIZE,
             seed: int = SEED + 20) -> torch.Tensor:
    """n letterboxed synthetic images (noise + filled rectangles), uint8 NHWC on dev."""
    return torch.from_numpy(next(iter(frcnn_loader(n, seed, n, size, train=False)))["images"]).to(dev)


def frcnn_nms_inputs(model: FasterRCNN, u8: torch.Tensor) -> dict:
    """The kernel's inputs on the main path: the RPN's top-K boxes and
    logits of a bf16 eval forward (K = 1000 at eval, 2000 as in training),
    and the head's class-offset candidates (K = 400) at the eval step's
    score threshold (0.05)."""
    model.eval()
    with torch.inference_mode():
        x = normalize_images(u8, torch.bfloat16, imagenet=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            feat = model.features(x)
            anchors, obj, deltas, proposals, valid = model.propose(feat)
            cls_logits, boxes = model.detect(feat, proposals)
        out = {}
        for k, tag in ((model.rpn_pre_nms_eval, "rpn_eval"), (model.rpn_pre_nms_train, "rpn_train")):
            boxes_k, logits_k = proposal_candidates(anchors, obj, deltas, model.image_size, k)
            out[tag] = (boxes_k.contiguous(), logits_k.contiguous(), model.rpn_nms_thresh)
        _, off, sc, _ = detection_candidates(cls_logits, boxes, valid, 0.05, 100)
        out["head"] = (off.contiguous(), sc.contiguous(), 0.3)
    return out


def phase_frcnn_kernel(dev: torch.device, model: FasterRCNN, u8: torch.Tensor) -> dict:
    """The NMS kernel against its plain version, bit-equal, on Faster
    R-CNN's own inputs and on seeded RPN-like and head-like ones."""
    main = frcnn_nms_inputs(model, u8)
    cases = dict(main)
    for k in (1000, 2000):
        cases[f"rpn_like_K{k}"] = (*(torch.from_numpy(a).to(dev)
                                     for a in rpn_nms_case(SEED + k, FRCNN_BATCH, k)), 0.7)
    cases["head_like_K400"] = (*(torch.from_numpy(a).to(dev) for a in nms_case(
        SEED + 400, FRCNN_BATCH, 400, 0.3, num_classes=FRCNN_CLASSES, clusters=30,
        ties=False, on_threshold=False)), 0.3)
    report, mismatches = {}, 0
    for tag, (boxes, scores, thr) in cases.items():
        got = suppression_mask_cuda(boxes, scores, thr)
        want = suppression_mask_plain(boxes, scores, thr)
        bad = int((got != want).sum())  # |got - want| is 1 at a mismatch, else 0
        mismatches += bad
        report[tag] = {"shape": list(scores.shape), "iou": thr, "mismatches": bad,
                       "valid": int((scores > float("-inf")).sum()), "kept": int(want.sum())}
    torch.cuda.synchronize()
    emit("frcnn_kernel", name="nms_suppression_mask", cases=len(cases), mismatches=mismatches,
         tolerance="bit-equal", by_case=report)
    check(mismatches == 0, f"nms kernel disagrees with its plain version on FRCNN inputs: {report}")
    return {"main": main, "cases": len(cases), "mismatches": mismatches,
            "max_abs_err": int(mismatches > 0)}


def phase_frcnn_eval(dev: torch.device, model: FasterRCNN, u8: torch.Tensor) -> dict:
    """The main path: make_frcnn_eval_step (bf16) on the full-width model at
    batch 8, the kernel's launches counted; then float32 card vs CPU at 256
    px (TF32 off), and selection on the card (kernel) vs the CPU (plain)
    from the card's own NMS inputs."""
    state = TrainState(model, None)
    eval_step = make_frcnn_eval_step(dtype=torch.bfloat16)
    suppression_mask_cuda.launches = 0
    det = eval_step(state, {"images": u8})
    torch.cuda.synchronize()
    launches = suppression_mask_cuda.launches
    check(launches == 2, f"the eval step launched the nms kernel {launches} times, not 2")
    boxes, scores, classes, valid = (t.cpu() for t in det)
    check(tuple(boxes.shape) == (FRCNN_BATCH, 100, 4), f"detections shape {tuple(boxes.shape)}")
    check(bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all()), "non-finite output")
    v = valid
    check(bool((boxes[v] >= 0).all() and (boxes[v] <= FRCNN_SIZE).all()), "a box lies outside")
    check(bool(((classes[v] >= 0) & (classes[v] < FRCNN_CLASSES)).all()), "class out of range")

    # --- float32 card vs CPU at 256 px, two images, the card's proposals on both
    small = frcnn_u8(dev, 2, 256, SEED + 21)
    x = normalize_images(small, torch.float32, imagenet=True)
    cpu_model = copy.deepcopy(model).cpu().eval()
    with no_tf32(), torch.inference_mode():
        feat = model.features(x)
        _, obj, deltas, proposals, _ = model.propose(feat)
        cls_logits, dboxes = model.detect(feat, proposals)
        feat_c = cpu_model.features(x.cpu())
        _, obj_c, deltas_c, _, _ = cpu_model.propose(feat_c)
        cls_c, dboxes_c = cpu_model.detect(feat_c, proposals.cpu())
    rel = {name: float((a.cpu() - b).abs().max() / b.std()) for name, a, b in (
        ("rpn_logits", obj, obj_c), ("rpn_deltas", deltas, deltas_c),
        ("cls_logits", cls_logits, cls_c), ("boxes", dboxes, dboxes_c))}
    del cpu_model
    check(max(rel.values()) <= 1e-3, f"fp32 card vs cpu: max|d|/std {rel} > 1e-3")

    # --- the card's NMS inputs: selection with the kernel vs the plain version
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
        xb = normalize_images(u8, torch.bfloat16, imagenet=True)
        feat = model.features(xb)
        anchors, obj, deltas, proposals, pvalid = model.propose(feat)
        cls_logits, dboxes = model.detect(feat, proposals)
    with torch.inference_mode():
        cand = proposal_candidates(anchors, obj, deltas, FRCNN_SIZE, model.rpn_pre_nms_eval)
        args = (model.rpn_nms_thresh, model.rpn_post_nms_eval)
        (p_card, s_card, v_card), (p_cpu, s_cpu, v_cpu) = (
            select_proposals(*cand, *args), select_proposals(*(t.cpu() for t in cand), *args))
        # proposals and valid flags equal; the scores' sigmoid differs by an
        # ulp between the card's and the CPU's implementations
        same_rpn = (torch.equal(p_card.cpu(), p_cpu) and torch.equal(v_card.cpu(), v_cpu)
                    and torch.allclose(s_card.cpu(), s_cpu, rtol=1e-6, atol=0.0))
        cand = detection_candidates(cls_logits, dboxes, pvalid, 0.05, 100)
        same_head = all(torch.equal(a.cpu(), b) for a, b in zip(
            select_detections(*cand, 0.3, 100), select_detections(*(t.cpu() for t in cand), 0.3, 100)))
    check(same_rpn and same_head, f"selection card vs cpu: rpn {same_rpn}, head {same_head}")
    emit("frcnn_eval", model="Faster R-CNN VGG16, 20 classes, 512 px, full width and depth, "
         "random weights (seed 0), bf16 autocast", batch=FRCNN_BATCH, launches=launches,
         detections_per_image=[int(n) for n in valid.sum(1)],
         fp32_card_vs_cpu_max_abs_over_std=rel, tolerance=1e-3,
         selection_card_equals_cpu={"rpn": same_rpn, "head": same_head})
    return {"launches": launches}


def phase_frcnn_train(dev: torch.device) -> dict:
    """One float32 step card vs CPU at 256 px with the same draws; a
    full-width bf16 Fit validated through the kernel; 10 steps on one batch."""
    # --- 1. one float32 SGD step, TF32 off, the same samples and dropout masks
    small = frcnn_model(SEED + 1, 256)
    small_cpu = copy.deepcopy(small)
    start = {k: v.clone() for k, v in small.state_dict().items()}
    batch = next(iter(frcnn_loader(2, SEED + 1, 2, 256)))
    draws = make_draws(torch.Generator().manual_seed(SEED), 2,
                       (256 // small.stride) ** 2 * small.base_anchors.shape[0],
                       small.rpn_post_nms_train, small.roi_pos + small.roi_neg,
                       small.head.hidden, small.head.dropout_rate)
    step32 = make_frcnn_train_step(SEED)
    with no_tf32():
        card = TrainState.create(small, build_optimizer("sgd", small, grad_clip_norm=10.0), dev)
        cpu = TrainState.create(small_cpu, build_optimizer("sgd", small_cpu, grad_clip_norm=10.0),
                                "cpu")
        _, m_card = step32(card, {k: torch.from_numpy(batch[k]).to(dev)
                                  for k in ("images", "labels")}, 1e-3,
                           draws=type(draws)(*(t.to(dev) for t in draws)))
        _, m_cpu = step32(cpu, {k: torch.from_numpy(batch[k]) for k in ("images", "labels")},
                          1e-3, draws=draws)
        torch.cuda.synchronize()
    losses_rel = {k: abs(float(m_card[k]) / float(m_cpu[k]) - 1) for k in m_cpu}
    worst = state_max_rel_diff(small.state_dict(), small_cpu.state_dict(), start)
    emit("frcnn_train_card_vs_cpu", model="Faster R-CNN VGG16, 20 classes, 256 px, batch 2, "
         "float32, TF32 off, one SGD step at lr 1e-3, clip 10", losses_rel=losses_rel,
         state_max_rel=worst, tolerances={"losses_rel": 1e-4, "kernels": 1e-3, "others": 1e-2})
    check(max(losses_rel.values()) <= 1e-4, f"frcnn train step card vs cpu: {losses_rel}")
    check(worst["kernels"][0] <= 1e-3 and worst["others"][0] <= 1e-2, f"state: {worst}")
    del small, small_cpu, card, cpu

    # --- 2. full-width Fit in bf16, validation counted through the kernel
    model = frcnn_model()
    train_loader = frcnn_loader(FRCNN_TRAIN_IMAGES, SEED)
    val_loader = frcnn_loader(FRCNN_VAL_IMAGES, SEED + 2, train=False)
    evaluate = detection_evaluator(make_frcnn_eval_step(dtype=torch.bfloat16, **FRCNN_VAL))
    val_launches = []

    def counted_evaluator(state, loader):
        suppression_mask_cuda.launches = 0
        out = evaluate(state, loader)
        torch.cuda.synchronize()
        val_launches.append(suppression_mask_cuda.launches)
        return out

    records = []

    class Log:
        def log(self, step, **kw):
            records.append({"step": step, **kw})

    epochs = 2
    step_fn = make_frcnn_train_step(SEED, torch.bfloat16)
    fit = Fit(model, None, build_optimizer("sgd", model, weight_decay=5e-4, momentum=0.937,
                                           grad_clip_norm=10.0),
              train_loader, val_loader, epochs=epochs,
              schedule=step_decay_lr(FRCNN_LR, 8 * len(train_loader)),
              evaluator=counted_evaluator, step_fn=step_fn, metric_key="map50",
              metric_mode="max", logger=Log(), device=dev)
    check(fit.device == dev, f"Fit picked {fit.device}")
    t0 = time.perf_counter()
    fit.run()
    fit_s = time.perf_counter() - t0
    per_epoch = [r for r in records if "train_loss" in r]
    check(len(per_epoch) == epochs and fit.global_step == epochs * len(train_loader),
          f"Fit ran {fit.global_step} steps over {len(per_epoch)} epochs")
    check(all(np.isfinite(r["train_loss"]) for r in per_epoch), f"train loss {per_epoch}")
    check(all(0.0 <= r["map50"] <= 1.0 and 0.0 <= r["map"] <= 1.0 for r in per_epoch),
          f"map out of range: {per_epoch}")
    check(len(val_launches) == epochs and min(val_launches) > 0,
          f"validation launched the nms kernel {val_launches} times")

    # --- 3. learning check: 10 steps on one fixed batch
    fixed = device_batch_of(train_loader, dev)
    losses = []
    for _ in range(10):
        _, m = step_fn(fit.state, fixed, FRCNN_LR)
        losses.append(m["loss"])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    # each step samples other anchors, RoIs and dropout masks: compare the
    # means of the first and last three steps
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"loss did not fall over 10 steps on one batch: {losses}")
    emit("frcnn_train", fit={
        "model": "Faster R-CNN VGG16, 20 classes, 512 px, full width and depth, bf16 autocast",
        "batch": FRCNN_BATCH, "train_images": FRCNN_TRAIN_IMAGES, "val_images": FRCNN_VAL_IMAGES,
        "epochs": epochs, "global_step": fit.global_step, "seconds_first_run": fit_s,
        "per_epoch": per_epoch, "val_nms_launches": val_launches,
        "recipe": f"SGD nesterov 0.937, wd 5e-4, clip 10, step decay from {FRCNN_LR}",
        "validation": FRCNN_VAL}, learning_check_losses=losses)
    return {"fit": fit, "step_fn": step_fn, "batch": fixed,
            "val_launches": sum(val_launches)}


def count_flops(model: torch.nn.Module, fn) -> float:
    """Multiply-adds x 2 of every conv (2-D and 3-D) and linear layer that
    ``fn()`` runs, counted from the layer shapes."""
    total = 0

    def conv(m, _, out):
        nonlocal total
        total += 2 * math.prod(m.kernel_size) * m.in_channels // m.groups * out.numel()

    def linear(m, _, out):
        nonlocal total
        total += 2 * m.in_features * out.numel()

    handles = [m.register_forward_hook(conv if isinstance(m, CONVS) else linear)
               for m in model.modules() if isinstance(m, (*CONVS, torch.nn.Linear))]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return float(total)


def roi_align_mxu_flops(b: int, n: int, h: int, w: int, c: int, o: int = 7) -> float:
    """The matmul form's two products: [N*o, H] @ [H, W*C], then [o, W] @ [W, C] per (RoI, row)."""
    return 2.0 * b * n * o * h * w * c + 2.0 * b * n * o * o * w * c


def phase_frcnn_times(dev: torch.device, model: FasterRCNN, u8: torch.Tensor, kernel: dict,
                      train: dict, smi: str) -> dict:
    """Eval images/s and its split by layer, the kernel alone in both
    regimes, the train step's images/s, peak memory, profiles and mfu."""
    out: dict = {"card": smi}
    state = TrainState(model.eval(), None)
    eval_step = make_frcnn_eval_step(dtype=torch.bfloat16)
    batch = {"images": u8}
    torch.cuda.reset_peak_memory_stats()
    prog_ms = cuda_ms(lambda: eval_step(state, batch), reps=10)
    out["eval_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["eval_device_program_ms"] = prog_ms
    out["eval_img_s"] = FRCNN_BATCH / (prog_ms / 1e3)

    # the split, each part alone between events on the previous part's output
    with torch.inference_mode():
        def backbone():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return model.features(normalize_images(u8, torch.bfloat16, imagenet=True))

        feat = backbone()

        def rpn():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return model.propose(feat)

        _, _, _, proposals, pvalid = rpn()
        nhwc = feat.permute(0, 2, 3, 1)
        roi_feats = roi_align_mxu(nhwc, proposals)

        def head():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                cls_logits, reg = model.head(roi_feats)
            return cls_logits, reg

        def detect():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return model.detect(feat, proposals)

        cls_logits, dboxes = detect()
        split = {
            "backbone_normalize_vgg16": cuda_ms(backbone, reps=10),
            "rpn_head_and_proposal_nms": cuda_ms(rpn, reps=10),
            "roi_align_mxu": cuda_ms(lambda: roi_align_mxu(nhwc, proposals), reps=10),
            "roi_align_gather": cuda_ms(lambda: roi_align(nhwc, proposals), reps=5),
            "head_mlp": cuda_ms(head, reps=10),
            "detect_roi_align_head_decode": cuda_ms(detect, reps=10),
            "postprocess_nms": cuda_ms(lambda: fastrcnn_postprocess(cls_logits, dboxes, pvalid),
                                       reps=20),
        }
    out["eval_split_ms"] = split
    out["roi_align_work"] = {"shape": [FRCNN_BATCH, proposals.shape[1], *feat.shape[2:],
                                       feat.shape[1]],
                             "mxu_flops": roi_align_mxu_flops(FRCNN_BATCH, proposals.shape[1],
                                                              feat.shape[2], feat.shape[3],
                                                              feat.shape[1])}

    # the kernel alone on the main path's inputs, both regimes
    kern = {}
    for tag in ("rpn_eval", "rpn_train", "head"):
        bx, sc, thr = kernel["main"][tag]
        keep = suppression_mask_cuda(bx, sc, thr)
        bound_ms, bound_by, work = nms_bound(bx, sc, keep)
        prof = device_profile(lambda: suppression_mask_cuda(bx, sc, thr), 20)
        kern[tag] = {
            "shape": list(sc.shape), "iou": thr,
            "ms": cuda_ms(lambda: suppression_mask_cuda(bx, sc, thr), reps=200, warmup=10),
            "graph_ms": graph_ms(lambda: suppression_mask_cuda(bx, sc, thr), reps=200),
            "device_ms": prof["device_ms"],
            "bitmask_ms": sum(v for k, v in prof["top_kernels_ms"].items()
                              if "overlap_mask_kernel" in k),
            "scan_ms": sum(v for k, v in prof["top_kernels_ms"].items()
                           if "greedy_scan_kernel" in k),
            "plain_ms": cuda_ms(lambda: suppression_mask_plain(bx, sc, thr), reps=3, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "kept": int(keep.sum()),
            "valid": int((sc > float("-inf")).sum()), **work,
        }
    out["nms_kernel"] = kern
    out["eval_profile"] = device_profile(lambda: eval_step(state, batch), 5)

    # the train step at batch 8, 512, bf16: 1 warm-up, 8 steps, one sync
    fit, step_fn, tbatch = train["fit"], train["step_fn"], train["batch"]
    tstate = fit.state
    torch.cuda.reset_peak_memory_stats()
    float(step_fn(tstate, tbatch, 1e-3)[1]["loss"])
    t0 = time.perf_counter()
    for _ in range(8):
        _, metrics = step_fn(tstate, tbatch, 1e-3)
    float(metrics["loss"])
    step_s = (time.perf_counter() - t0) / 8
    out["train_step_ms"] = 1e3 * step_s
    out["train_step_img_s"] = FRCNN_BATCH / step_s
    out["train_peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    prof = device_profile(lambda: step_fn(tstate, tbatch, 1e-3), reps=3, top=10)
    prof["device_share_of_unprofiled_step"] = prof["device_ms"] / out["train_step_ms"]
    out["train_profile"] = prof

    # FLOPs from the layer shapes (convs, linears) + RoI-align's products
    tmodel = tstate.model
    with torch.inference_mode():
        eval_flops = count_flops(model, lambda: eval_step(state, batch))
    eval_flops += out["roi_align_work"]["mxu_flops"]
    x = normalize_images(tbatch["images"], torch.bfloat16, imagenet=True)
    labels = labels_to_pixel_xyxy(tbatch["labels"].float(), FRCNN_SIZE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tmodel.train()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        train_fwd = count_flops(tmodel, lambda: tmodel(x, labels, generator=gen))
    train_fwd += roi_align_mxu_flops(FRCNN_BATCH, tmodel.roi_pos + tmodel.roi_neg,
                                     *feat.shape[2:], feat.shape[1])
    out["flops_per_image"] = {"eval_forward": eval_flops / FRCNN_BATCH,
                              "train_forward": train_fwd / FRCNN_BATCH,
                              "train_3x_forward": 3 * train_fwd / FRCNN_BATCH}
    out["eval_mfu"] = eval_flops / FRCNN_BATCH * out["eval_img_s"] / PEAK_BF16_FLOPS
    out["train_mfu"] = 3 * train_fwd / FRCNN_BATCH * out["train_step_img_s"] / PEAK_BF16_FLOPS
    out["mfu_peak"] = "989e12 dense bf16 (H100 SXM data sheet, at 700 W)"
    out["clocks_power"] = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    emit("frcnn_times", **out)
    return out


# ---------------------------------------------------------------------------
# checkpoint / resume, Detector.evaluate and the CLI
# ---------------------------------------------------------------------------
# final weights of a run cut and resumed vs one never cut. The phase runs
# under deterministic algorithms: where every op had a deterministic
# implementation the two must be bit-equal; where one had not (PyTorch
# warns), they may differ by rounding only: tolerances as the card-vs-CPU
# step's
# ---------------------------------------------------------------------------
# Classification: ResNet-50, 1000 classes, 224 px, full width (train-cls)
# ---------------------------------------------------------------------------
CLS_SIZE, CLS_CLASSES, CLS_BATCH, CLS_FOLDERS = 224, 1000, 128, 10
CLS_IMAGES = 2 * CLS_BATCH  # per split: 2 steps an epoch, 2 validation batches
CLS_HW = ((224, 224), (240, 320), (320, 180), (150, 200), (300, 260), (375, 500))
CLS_WORKERS = 4  # the config's default num_workers, worker_backend "process"
# the mix of a modern ImageNet recipe, and its SGD: momentum 0.9, wd 1e-4
CLS_MIX = dict(mixup_alpha=0.2, cutmix_alpha=1.0, smoothing=0.1)
CLS_LR = 0.05  # 0.1 per 256 images


def cls_model(seed: int = SEED) -> torch.nn.Module:
    return resnet50(num_classes=CLS_CLASSES, generator=torch.Generator().manual_seed(seed))


def cls_loss(logits, batch):
    """train-cls's loss: soft cross-entropy on the mixed targets."""
    acc = (logits.argmax(dim=-1) == batch["labels"]).float().mean()
    if "soft" in batch:
        return soft_cross_entropy(logits.float(), batch["soft"]), {"acc": acc}
    return cross_entropy(logits.float(), batch["labels"]), {"acc": acc}


def cls_step(dtype: torch.dtype = torch.bfloat16, mix: bool = True):
    return make_train_step(cls_loss, dtype, imagenet=True, transform_seed=SEED,
                           batch_transform=make_classification_mix(CLS_CLASSES, **CLS_MIX)
                           if mix else None)


def cls_loader(root: str, split: str, num_workers: int = CLS_WORKERS, train: bool = True,
               size: int = CLS_SIZE) -> ClassificationLoader:
    return ClassificationLoader(
        ClassificationDataset(root, split), size, CLS_BATCH, train=train, seed=SEED,
        augmentation=Augmentation([HorizontalFlip(p=0.5)]) if train else None,
        num_workers=num_workers, worker_backend="process")


def read_epoch(loader, epoch: int = 0) -> list[dict]:
    return [{k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in b.items()}
            for b in loader.epoch(epoch)]


def same_batches(a: list[dict], b: list[dict]) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) if isinstance(x[k], np.ndarray)
                                     else x[k] == y[k] for k in x if k != "meta")
        for x, y in zip(a, b))


def phase_cls_card_vs_cpu(dev: torch.device) -> dict:
    """One SGD step of a shallow ResNeXt with the mix, card vs CPU, and
    float32 forwards of the full-width zoo at 224 on 2 images."""
    small = ResNet(Bottleneck, (1, 1, 1, 1), num_classes=CLS_CLASSES, groups=32, base_width=4,
                   generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 7)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, CLS_FOLDERS, 8).astype(np.int32))}
    steps = {}
    # both are gated. The float32 one holds on this seeded batch, but a float32
    # step of a ReLU net with train-mode BN can take pre-activations within
    # rounding of 0 to either side on either device, and then sits up to 1e-2
    # from a float64 run (other batches, PERF.md): the float64 step is
    # the comparison that does not depend on the batch
    for dtype in (torch.float64, torch.float32):
        card_m, cpu_m = copy.deepcopy(small).to(dtype), copy.deepcopy(small).to(dtype)
        start = {k: v.clone() for k, v in cpu_m.state_dict().items()}
        step = cls_step(dtype)
        with no_tf32():
            card = TrainState.create(card_m, build_optimizer("sgd", card_m, momentum=0.9), dev)
            cpu = TrainState.create(cpu_m, build_optimizer("sgd", cpu_m, momentum=0.9), "cpu")
            _, m_card = step(card, {k: v.to(dev) for k, v in batch.items()}, 1e-2)
            _, m_cpu = step(cpu, batch, 1e-2)
            torch.cuda.synchronize()
        steps[str(dtype).split(".")[-1]] = {
            "loss_rel": abs(float(m_card["loss"]) / float(m_cpu["loss"]) - 1),
            "grad_norm_rel": abs(float(m_card["grad_norm"]) / float(m_cpu["grad_norm"]) - 1),
            "state_max_rel": state_max_rel_diff(card_m.state_dict(), cpu_m.state_dict(), start)}
    tol = {"loss_rel": 1e-4, "kernels": 1e-3, "others": 1e-2}
    for name, r in steps.items():
        check(r["loss_rel"] <= tol["loss_rel"] and r["state_max_rel"]["kernels"][0]
              <= tol["kernels"] and r["state_max_rel"]["others"][0] <= tol["others"],
              f"cls train step card vs cpu, {name}: {r}")
    del small

    fwd = {}
    u8 = np.random.default_rng(SEED + 8).integers(0, 256, (2, CLS_SIZE, CLS_SIZE, 3), np.uint8)
    x = normalize_images(torch.from_numpy(u8), torch.float32, imagenet=True)
    for name, build in (("resnet50", lambda g: resnet50(generator=g)),
                        ("vgg16", lambda g: vgg16(generator=g)),
                        ("darknet53", lambda g: darknet53(generator=g)),
                        ("vit_base_patch16", lambda g: vit_base_patch16(generator=g))):
        model = build(torch.Generator().manual_seed(SEED))
        if any(isinstance(m, BATCH_NORMS) for m in model.modules()):
            calibrate_bn_(model, x)  # statistics from these images, not (0, 1)
        model.eval()
        with no_tf32(), torch.inference_mode():
            want = model(x)
            got = model.to(dev)(x.to(dev)).cpu()
        fwd[name] = float((got - want).abs().max() / want.std())
        del model
        torch.cuda.empty_cache()
    check(max(fwd.values()) <= 1e-3, f"fp32 zoo forwards card vs cpu: {fwd}")
    emit("cls_card_vs_cpu",
         step={"model": "ResNet(Bottleneck, (1,1,1,1), groups=32, base_width=4), 1000 classes, "
                        "64 px, batch 8, mixup 0.2 + cutmix 1.0 + smoothing 0.1, one SGD step "
                        "at lr 1e-2, TF32 off", "tolerances": tol, **steps},
         forward_fp32_max_abs_over_std=fwd, forward_tolerance=1e-3,
         forward_inputs=f"2 images at {CLS_SIZE}, BN statistics from them, TF32 off")
    return {"forward": fwd, "step": steps}


def phase_cls_train(dev: torch.device, workdir: str) -> dict:
    """Full-width ResNet-50 / 224 / bf16 through Fit over a BMP folder, on
    the config's worker pools; the pooled epoch byte-equal to the serial one."""
    t0 = time.perf_counter()
    root = write_classification_dataset(os.path.join(workdir, "cls"), CLS_IMAGES,
                                        num_classes=CLS_FOLDERS, sizes=CLS_HW, seed=SEED + 9)
    write_s = time.perf_counter() - t0
    train_loader, val_loader = cls_loader(root, "train"), cls_loader(root, "val", train=False)
    t0 = time.perf_counter()
    pooled = read_epoch(train_loader)
    pooled_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = read_epoch(cls_loader(root, "train", num_workers=0))
    serial_s = time.perf_counter() - t0
    byte_equal = same_batches(pooled, serial)
    check(byte_equal, "the pooled classification epoch differs from the serial one")

    records = []

    class Log:
        def log(self, step, **kw):
            records.append({"step": step, **kw})

    val_launches: list = []
    model = cls_model()
    epochs = 2
    fit = Fit(model, cls_loss, build_optimizer("sgd", model, weight_decay=1e-4, momentum=0.9),
              train_loader, val_loader, epochs=epochs,
              schedule=warmup_cosine_lr(CLS_LR, 1e-4, epochs * len(train_loader), warmup_steps=1),
              evaluator=counted(classification_evaluator(make_eval_step(
                  dtype=torch.bfloat16, imagenet=True)), val_launches),
              step_fn=cls_step(), dtype=torch.bfloat16, metric_key="accuracy",
              metric_mode="max", logger=Log(), seed=SEED, device=dev)
    t0 = time.perf_counter()
    fit.run()
    fit_s = time.perf_counter() - t0
    per_epoch = [r for r in records if "train_loss" in r]
    check(len(per_epoch) == epochs and fit.global_step == epochs * len(train_loader),
          f"cls Fit ran {fit.global_step} steps over {len(per_epoch)} epochs")
    check(all(np.isfinite(r["train_loss"]) and 0.0 <= r["accuracy"] <= 1.0 for r in per_epoch),
          f"cls Fit: {per_epoch}")
    check(val_launches == [0] * epochs, f"classification validation launched nms {val_launches}")

    step = cls_step(mix=False)
    fixed = {k: torch.from_numpy(v).to(dev) for k, v in pooled[0].items() if k != "num_real"}
    losses = []
    for _ in range(10):
        _, m = step(fit.state, fixed, 0.05)
        losses.append(m["loss"])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    check(losses[-1] < losses[0], f"cls loss did not fall over 10 steps on one batch: {losses}")
    emit("cls_train", fit={"model": "ResNet-50, 1000 classes, full width and depth, bf16 "
                                    "autocast, channels_last",
                           "input_size": CLS_SIZE, "batch": CLS_BATCH, "epochs": epochs,
                           "images_per_split": CLS_IMAGES, "folders": CLS_FOLDERS,
                           "image_hw": [list(s) for s in CLS_HW], "bmp_write_s": write_s,
                           "recipe": {**CLS_MIX, "sgd_momentum": 0.9, "weight_decay": 1e-4,
                                      "schedule": f"warmup_cosine_lr({CLS_LR}, 1e-4)"},
                           "loader": f"ClassificationLoader(num_workers={CLS_WORKERS}, "
                                     "worker_backend='process')",
                           "global_step": fit.global_step, "seconds_first_run": fit_s,
                           "per_epoch": per_epoch, "val_nms_launches": val_launches},
         pooled_epoch_byte_equal_to_serial=byte_equal, pooled_epoch_s=pooled_s,
         serial_epoch_s=serial_s, learning_check_losses=losses)
    train_loader.close()
    val_loader.close()
    return {"fit": fit, "root": root, "batch": fixed,
            "launches": {"cls_fit_validation": sum(val_launches)}}


def phase_cls_times(dev: torch.device, cls: dict, smi: str, workdir: str) -> dict:
    """ResNet-50 train step img/s at batch 128, its split, peak memory and
    mfu; Fit and the loaders with 0 and 4 workers; the evaluator's img/s."""
    fit, batch, root = cls["fit"], cls["batch"], cls["root"]
    state, model = fit.state, fit.state.model
    step = cls_step()
    out: dict = {"card": smi}
    torch.cuda.reset_peak_memory_stats()
    float(step(state, batch, 1e-3)[1]["loss"])
    t0 = time.perf_counter()
    for _ in range(8):
        _, metrics = step(state, batch, 1e-3)
    float(metrics["loss"])
    step_s = (time.perf_counter() - t0) / 8
    out["train_step_img_s"] = CLS_BATCH / step_s
    out["train_step_ms"] = 1e3 * step_s
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20

    mix = make_classification_mix(CLS_CLASSES, **CLS_MIX)
    parts = {"mix": 0.0, "forward": 0.0, "loss": 0.0, "backward": 0.0, "optimizer": 0.0}
    reps = 5
    for i in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        model.zero_grad(set_to_none=True)
        ev[0].record()
        mixed = mix(batch, np.random.default_rng((SEED, i)))
        ev[1].record()
        x = normalize_images(mixed["images"], torch.bfloat16, imagenet=True)
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            logits = model(x)
        ev[2].record()
        loss, _ = cls_loss(logits, mixed)
        ev[3].record()
        loss.backward()
        ev[4].record()
        set_lr(state.optimizer, 1e-3)
        state.optimizer.step()
        ev[5].record()
        ev[5].synchronize()
        if i:  # the first is a warm-up
            for name, a, b in zip(parts, ev[:-1], ev[1:]):
                parts[name] += a.elapsed_time(b) / reps
    out["step_split_ms"] = parts
    prof = device_profile(lambda: step(state, batch, 1e-3), reps=3, top=8)
    prof["device_share_of_unprofiled_step"] = prof["device_ms"] / out["train_step_ms"]
    out["step_profile"] = prof

    model.eval()
    with torch.inference_mode():
        fwd_flops = count_flops(model, lambda: model(torch.zeros(
            1, CLS_SIZE, CLS_SIZE, 3, device=dev).contiguous(memory_format=torch.channels_last)))
    model.train()
    out["flops_per_image"] = {"forward": fwd_flops, "train_3x_forward": 3 * fwd_flops,
                              "counted": "conv and Linear layers"}
    out["mfu"] = 3 * fwd_flops * out["train_step_img_s"] / PEAK_BF16_FLOPS

    # at 0 and 4 workers: the loader's first epoch (a pool starts: 4 forks of
    # this process), then, steady, the loader alone, Fit over 2 epochs from
    # the files, and the evaluator
    first_s, loader_rates, fit_rates, eval_rates = {}, {}, {}, {}
    for workers in (0, CLS_WORKERS):
        loader = cls_loader(root, "train", num_workers=workers)
        t0 = time.perf_counter()
        read_epoch(loader, 10)
        first_s[workers] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = sum(b["num_real"] for e in (11, 12) for b in read_epoch(loader, e))
        loader_rates[workers] = n / (time.perf_counter() - t0)
        f = Fit(model, cls_loss, state.optimizer, loader, epochs=2, step_fn=cls_step(),
                dtype=torch.bfloat16, schedule=constant_lr(1e-3), seed=SEED,
                logger=MetricLogger(stdout=False), device=dev)
        t0 = time.perf_counter()
        f.run()
        torch.cuda.synchronize()
        fit_rates[workers] = f.global_step * CLS_BATCH / (time.perf_counter() - t0)
        loader.close()
        val = cls_loader(root, "val", num_workers=workers, train=False)
        read_epoch(val)
        evaluate = classification_evaluator(make_eval_step(dtype=torch.bfloat16, imagenet=True))
        t0 = time.perf_counter()
        evaluate(f.state, val)
        eval_rates[workers] = len(val.ds) / (time.perf_counter() - t0)
        val.close()
    out["loader_first_epoch_s_by_workers"] = first_s
    out["loader_img_s_by_workers"] = loader_rates
    out["fit_epoch_img_s_by_workers"] = fit_rates
    out["evaluator_img_s_by_workers"] = eval_rates
    out["timed_images"] = {"loader": 2 * CLS_IMAGES, "fit": 2 * CLS_IMAGES,
                           "evaluator": CLS_IMAGES}

    # the YOLOv3 train loader (mosaic 0.5, hflip, HSV) over BMP files, alone:
    # a first epoch, then one timed
    det_root = write_detection_dataset(os.path.join(workdir, "det_loader"), TRAIN_IMAGES,
                                       sizes=SIZES, seed=SEED + 10, splits=("train",))
    det_rates, det_epochs = {}, {}
    for workers in (0, CLS_WORKERS):
        loader = DetectionLoader(
            DetectionDataset(det_root, "train"), INPUT_SIZE, TRAIN_BATCH, max_boxes=32,
            seed=SEED, mosaic_prob=0.5, num_workers=workers, worker_backend="process",
            augmentation=Augmentation([HorizontalFlip(p=0.5), HSVJitter(p=0.5)]))
        read_epoch(loader)
        t0 = time.perf_counter()
        det_epochs[workers] = read_epoch(loader, 1)
        det_rates[workers] = len(det_epochs[workers]) * TRAIN_BATCH / (time.perf_counter() - t0)
        loader.close()
    det_equal = same_batches(det_epochs[0], det_epochs[CLS_WORKERS])
    check(det_equal, "the pooled YOLOv3 loader epoch differs from the serial one")
    shutil.rmtree(det_root)
    out["yolo_loader_img_s_by_workers"] = det_rates
    out["yolo_loader"] = (f"DetectionLoader {INPUT_SIZE}, batch {TRAIN_BATCH}, mosaic 0.5 + "
                          f"hflip + HSV 0.5, {TRAIN_IMAGES} BMP files of the sizes "
                          f"{[list(s) for s in SIZES]}")
    out["yolo_pooled_epoch_byte_equal_to_serial"] = det_equal
    out["host_cpus"] = os.cpu_count()
    out["clocks_power"] = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    emit("cls_times", **out)
    return out


# ---------------------------------------------------------------------------
# Video: SlowFast-R50, 400 classes (Kinetics-400), 32 frames at 224, alpha 8,
# beta 1/8 (the 4x16 R50 setting), full width (train-video)
# ---------------------------------------------------------------------------
VID_T, VID_SIZE, VID_CLASSES, VID_BATCH = 32, 224, 400, 8
VID_CLIPS = (16, 8)  # train and val clips: 2 steps an epoch, 1 validation batch
VID_FOLDERS, VID_FRAMES, VID_HW = 4, 40, (240, 320)  # BMP frame directories
VID_WORKERS = 4  # the config's default num_workers, worker_backend "process"
VID_EVAL_CLIPS = 4
VID_LR = 0.0125  # the SlowFast recipe's 0.1 per 64 clips, SGD momentum 0.9, wd 1e-4
# C3D (UCF-101's 101 classes) and the factorized 3D-ResNet-50 at 16 x 112
SMALL_VID_T, SMALL_VID_SIZE, SMALL_VID_BATCH = 16, 112, 32


def vid_model(seed: int = SEED) -> torch.nn.Module:
    return slowfast_resnet50(num_classes=VID_CLASSES, generator=torch.Generator().manual_seed(seed))


def vid_loss(logits, batch):
    """train-video's loss: cross-entropy."""
    acc = (logits.argmax(dim=-1) == batch["labels"]).float().mean()
    return cross_entropy(logits.float(), batch["labels"]), {"acc": acc}


def vid_step(dtype: torch.dtype = torch.bfloat16):
    return make_train_step(vid_loss, dtype, imagenet=True)


def vid_loader(root: str, split: str, num_workers: int = VID_WORKERS,
               train: bool = True) -> VideoClipLoader:
    return VideoClipLoader(VideoFolderDataset(root, split), num_frames=VID_T, size=VID_SIZE,
                           batch_size=VID_BATCH, strategy="average", train=train, seed=SEED,
                           num_workers=num_workers, worker_backend="process")


def vid_evaluator(sink: list | None = None):
    evaluate = video_multiclip_evaluator(make_eval_step(dtype=torch.bfloat16, imagenet=True),
                                         n_clips=VID_EVAL_CLIPS)
    return evaluate if sink is None else counted(evaluate, sink)


def phase_video_card_vs_cpu(dev: torch.device) -> dict:
    """float32 forwards (TF32 off) of full-width C3D, 3D-ResNet-50 and
    SlowFast-R50 on 2 clips, and one SGD step of a small SlowFast in float32
    and float64, card vs CPU."""
    fwd = {}
    for name, build, t, size in (
            ("c3d", lambda g: c3d(num_classes=101, generator=g), SMALL_VID_T, SMALL_VID_SIZE),
            ("resnet50_3d", lambda g: resnet50_3d(num_classes=VID_CLASSES, generator=g),
             SMALL_VID_T, SMALL_VID_SIZE),
            ("slowfast_resnet50", lambda g: vid_model(), VID_T, VID_SIZE)):
        u8 = np.random.default_rng(SEED + 20).integers(0, 256, (2, t, size, size, 3), np.uint8)
        x = normalize_images(torch.from_numpy(u8), torch.float32, imagenet=True)
        model = build(torch.Generator().manual_seed(SEED))
        if any(isinstance(m, BATCH_NORMS) for m in model.modules()):
            calibrate_bn_(model, x)  # statistics from these clips, not (0, 1)
        model.eval()
        with no_tf32(), torch.inference_mode():
            want = model(x)
            got = model.to(dev, memory_format=torch.channels_last_3d)(x.to(dev)).cpu()
        fwd[name] = float((got - want).abs().max() / want.std())
        del model
        torch.cuda.empty_cache()
    check(max(fwd.values()) <= 1e-3, f"fp32 video forwards card vs cpu: {fwd}")

    small = SlowFast((1, 1, 1, 1), num_classes=VID_CLASSES, alpha=4,
                     generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 21)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (4, 8, 64, 64, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, VID_FOLDERS, 4).astype(np.int32))}
    steps = {}
    for dtype in (torch.float64, torch.float32):
        card_m, cpu_m = copy.deepcopy(small).to(dtype), copy.deepcopy(small).to(dtype)
        start = {k: v.clone() for k, v in cpu_m.state_dict().items()}
        step = vid_step(dtype)
        with no_tf32():
            card = TrainState.create(card_m, build_optimizer("sgd", card_m, momentum=0.9), dev)
            cpu = TrainState.create(cpu_m, build_optimizer("sgd", cpu_m, momentum=0.9), "cpu")
            _, m_card = step(card, {k: v.to(dev) for k, v in batch.items()}, 1e-2)
            _, m_cpu = step(cpu, batch, 1e-2)
            torch.cuda.synchronize()
        steps[str(dtype).split(".")[-1]] = {
            "loss_rel": abs(float(m_card["loss"]) / float(m_cpu["loss"]) - 1),
            "grad_norm_rel": abs(float(m_card["grad_norm"]) / float(m_cpu["grad_norm"]) - 1),
            "state_max_rel": state_max_rel_diff(card_m.state_dict(), cpu_m.state_dict(), start)}
    tol = {"loss_rel": 1e-4, "kernels": 1e-3, "others": 1e-2}
    for name, r in steps.items():
        check(r["loss_rel"] <= tol["loss_rel"] and r["state_max_rel"]["kernels"][0]
              <= tol["kernels"] and r["state_max_rel"]["others"][0] <= tol["others"],
              f"video train step card vs cpu, {name}: {r}")
    emit("video_card_vs_cpu",
         step={"model": "SlowFast((1,1,1,1), alpha=4), 400 classes, 8 x 64, batch 4, one SGD "
                        "step at lr 1e-2, TF32 off", "tolerances": tol, **steps},
         forward_fp32_max_abs_over_std=fwd, forward_tolerance=1e-3,
         forward_inputs=(f"2 clips: c3d (101 classes) and resnet50_3d at {SMALL_VID_T} x "
                         f"{SMALL_VID_SIZE}, slowfast_resnet50 at {VID_T} x {VID_SIZE}; BN "
                         "statistics from them, TF32 off"))
    return {"forward": fwd, "step": steps}


def phase_video_train(dev: torch.device, workdir: str) -> dict:
    """Full-width SlowFast-R50 / 32 x 224 / bf16 through Fit over BMP frame
    directories on the config's worker pools, validated by the multi-clip
    evaluator; the pooled epoch byte-equal to the serial one."""
    t0 = time.perf_counter()
    root = write_video_dataset(os.path.join(workdir, "video"), VID_CLIPS,
                               num_classes=VID_FOLDERS, frames=VID_FRAMES, hw=VID_HW,
                               seed=SEED + 22)
    write_s = time.perf_counter() - t0
    train_loader, val_loader = vid_loader(root, "train"), vid_loader(root, "val", train=False)
    t0 = time.perf_counter()
    pooled = read_epoch(train_loader)
    pooled_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = read_epoch(vid_loader(root, "train", num_workers=0))
    serial_s = time.perf_counter() - t0
    byte_equal = same_batches(pooled, serial)
    check(byte_equal, "the pooled video epoch differs from the serial one")

    records = []

    class Log:
        def log(self, step, **kw):
            records.append({"step": step, **kw})

    val_launches: list = []
    model = vid_model()
    epochs = 2
    fit = Fit(model, vid_loss, build_optimizer("sgd", model, weight_decay=1e-4, momentum=0.9),
              train_loader, val_loader, epochs=epochs,
              schedule=warmup_cosine_lr(VID_LR, 1e-5, epochs * len(train_loader), warmup_steps=1),
              evaluator=vid_evaluator(val_launches), step_fn=vid_step(), dtype=torch.bfloat16,
              metric_key="accuracy", metric_mode="max", logger=Log(), seed=SEED, device=dev)
    check(model.slow_pathway.conv1[0].weight.is_contiguous(
        memory_format=torch.channels_last_3d), "SlowFast is not in channels_last_3d memory")
    t0 = time.perf_counter()
    fit.run()
    fit_s = time.perf_counter() - t0
    per_epoch = [r for r in records if "train_loss" in r]
    check(len(per_epoch) == epochs and fit.global_step == epochs * len(train_loader),
          f"video Fit ran {fit.global_step} steps over {len(per_epoch)} epochs")
    check(all(np.isfinite(r["train_loss"]) and 0.0 <= r["accuracy"] <= 1.0
              and r["n_clips"] == VID_EVAL_CLIPS for r in per_epoch), f"video Fit: {per_epoch}")
    check(val_launches == [0] * epochs, f"video validation launched nms {val_launches}")

    step = vid_step()
    fixed = {k: torch.from_numpy(v).to(dev) for k, v in pooled[0].items() if k != "num_real"}
    losses = []
    for _ in range(10):
        _, m = step(fit.state, fixed, VID_LR)
        losses.append(m["loss"])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    check(losses[-1] < losses[0], f"video loss did not fall over 10 steps on one batch: {losses}")
    emit("video_train", fit={
        "model": "SlowFast-R50 (slowfast_resnet50), 400 classes, alpha 8, beta 1/8, full width "
                 "and depth, bf16 autocast, channels_last_3d",
        "clip": [VID_T, VID_SIZE, VID_SIZE], "batch": VID_BATCH, "epochs": epochs,
        "clips_per_split": list(VID_CLIPS), "folders": VID_FOLDERS,
        "frames_per_clip_dir": VID_FRAMES, "frame_hw": list(VID_HW), "bmp_write_s": write_s,
        "recipe": {"sgd_momentum": 0.9, "weight_decay": 1e-4,
                   "schedule": f"warmup_cosine_lr({VID_LR}, 1e-5)"},
        "loader": f"VideoClipLoader(num_workers={VID_WORKERS}, worker_backend='process', "
                  "strategy='average')",
        "validation": f"video_multiclip_evaluator(n_clips={VID_EVAL_CLIPS})",
        "global_step": fit.global_step, "seconds_first_run": fit_s, "per_epoch": per_epoch,
        "val_nms_launches": val_launches},
         pooled_epoch_byte_equal_to_serial=byte_equal, pooled_epoch_s=pooled_s,
         serial_epoch_s=serial_s, learning_check_losses=losses)
    train_loader.close()
    val_loader.close()
    return {"fit": fit, "root": root, "batch": fixed,
            "launches": {"video_fit_validation": sum(val_launches)}}


def step_rate(step, state, batch, lr: float = 1e-3, reps: int = 8) -> float:
    """Seconds per train step: 1 warm-up, ``reps`` steps, one sync. The
    step gets a generator for models with dropout (C3D)."""
    rng = torch.Generator(device=state.device).manual_seed(SEED)
    float(step(state, batch, lr, rng)[1]["loss"])
    t0 = time.perf_counter()
    for _ in range(reps):
        _, metrics = step(state, batch, lr, rng)
    float(metrics["loss"])
    return (time.perf_counter() - t0) / reps


def phase_video_times(dev: torch.device, video: dict, smi: str) -> dict:
    """SlowFast-R50 train step clips/s at batch 8, its split, peak memory
    and mfu; the loader and Fit with 0 and 4 workers; the evaluator;
    VideoClassifier.predict_clip; C3D and 3D-ResNet-50 step rates."""
    fit, batch, root = video["fit"], video["batch"], video["root"]
    state, model = fit.state, fit.state.model
    step = vid_step()
    out: dict = {"card": smi}
    torch.cuda.reset_peak_memory_stats()
    step_s = step_rate(step, state, batch)
    out["train_step_clips_s"] = VID_BATCH / step_s
    out["train_step_ms"] = 1e3 * step_s
    out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20

    parts = {"forward": 0.0, "loss": 0.0, "backward": 0.0, "optimizer": 0.0}
    reps = 5
    for i in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        model.zero_grad(set_to_none=True)
        ev[0].record()
        x = normalize_images(batch["images"], torch.bfloat16, imagenet=True)
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            logits = model(x)
        ev[1].record()
        loss, _ = vid_loss(logits, batch)
        ev[2].record()
        loss.backward()
        ev[3].record()
        set_lr(state.optimizer, 1e-3)
        state.optimizer.step()
        ev[4].record()
        ev[4].synchronize()
        if i:  # the first is a warm-up
            for name, a, b in zip(parts, ev[:-1], ev[1:]):
                parts[name] += a.elapsed_time(b) / reps
    out["step_split_ms"] = parts
    prof = device_profile(lambda: step(state, batch, 1e-3), reps=3, top=10)
    prof["device_share_of_unprofiled_step"] = prof["device_ms"] / out["train_step_ms"]
    out["step_profile"] = prof

    model.eval()
    with torch.inference_mode():
        fwd_flops = count_flops(model, lambda: model(torch.zeros(
            1, VID_T, VID_SIZE, VID_SIZE, 3, device=dev)))
    model.train()
    out["flops_per_clip"] = {"forward": fwd_flops, "train_3x_forward": 3 * fwd_flops,
                             "counted": "Conv3d and Linear layers"}
    out["mfu"] = 3 * fwd_flops * out["train_step_clips_s"] / PEAK_BF16_FLOPS

    # at 0 and 4 workers: the loader's first epoch (a pool starts: 4 forks of
    # this process), then, steady, the loader alone, Fit over 2 epochs from
    # the files, and the multi-clip evaluator
    n_train, n_val = VID_CLIPS
    first_s, loader_rates, fit_rates, eval_rates = {}, {}, {}, {}
    for workers in (0, VID_WORKERS):
        loader = vid_loader(root, "train", num_workers=workers)
        t0 = time.perf_counter()
        read_epoch(loader, 10)
        first_s[workers] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = sum(b["num_real"] for e in (11, 12) for b in read_epoch(loader, e))
        loader_rates[workers] = n / (time.perf_counter() - t0)
        f = Fit(model, vid_loss, state.optimizer, loader, epochs=2, step_fn=vid_step(),
                dtype=torch.bfloat16, schedule=constant_lr(1e-3), seed=SEED,
                logger=MetricLogger(stdout=False), device=dev)
        t0 = time.perf_counter()
        f.run()
        torch.cuda.synchronize()
        fit_rates[workers] = f.global_step * VID_BATCH / (time.perf_counter() - t0)
        loader.close()
        val = vid_loader(root, "val", num_workers=workers, train=False)
        evaluate = vid_evaluator()
        evaluate(f.state, val)  # the pool's start and the eval program's first call
        t0 = time.perf_counter()
        evaluate(f.state, val)
        eval_rates[workers] = n_val * VID_EVAL_CLIPS / (time.perf_counter() - t0)
        val.close()
    out["loader_first_epoch_s_by_workers"] = first_s
    out["loader_clips_s_by_workers"] = loader_rates
    out["fit_epoch_clips_s_by_workers"] = fit_rates
    out["evaluator_clips_s_by_workers"] = eval_rates
    out["timed_clips"] = {"loader": 2 * n_train, "fit": 2 * n_train,
                          "evaluator": n_val * VID_EVAL_CLIPS}

    vc = VideoClassifier(model, num_frames=VID_T, size=VID_SIZE, device=dev)
    raw = np.random.default_rng(SEED + 23).integers(0, 256, (VID_T, *VID_HW, 3), np.uint8)
    probs = vc.predict_clip(raw)["probs"]
    check(probs.shape == (VID_CLASSES,) and np.isfinite(probs).all()
          and abs(float(probs.sum()) - 1.0) < 1e-3, "VideoClassifier.predict_clip")
    out["predict_clip_ms"] = 1e3 * host_s(lambda: vc.predict_clip(raw), reps=5)
    u8 = batch["images"][:1]
    out["predict_clip_device_ms"] = cuda_ms(lambda: vc.probabilities(u8), reps=10)
    model.train()

    # C3D (101 classes) and 3D-ResNet-50 (400) at 16 x 112, batch 32, bf16
    others = {}
    rng = np.random.default_rng(SEED + 24)
    for name, build, classes in (("c3d", c3d, 101), ("resnet50_3d", resnet50_3d, VID_CLASSES)):
        m = build(num_classes=classes, generator=torch.Generator().manual_seed(SEED))
        st = TrainState.create(m, build_optimizer("sgd", m, weight_decay=1e-4, momentum=0.9), dev)
        b = {"images": torch.from_numpy(rng.integers(
                 0, 256, (SMALL_VID_BATCH, SMALL_VID_T, SMALL_VID_SIZE, SMALL_VID_SIZE, 3),
                 dtype=np.uint8)).to(dev),
             "labels": torch.from_numpy(rng.integers(0, classes, SMALL_VID_BATCH).astype(
                 np.int32)).to(dev)}
        torch.cuda.reset_peak_memory_stats()
        sec = step_rate(vid_step(), st, b)
        m.eval()
        with torch.inference_mode():
            flops = count_flops(m, lambda: m(torch.zeros(
                1, SMALL_VID_T, SMALL_VID_SIZE, SMALL_VID_SIZE, 3, device=dev)))
        others[name] = {"train_step_clips_s": SMALL_VID_BATCH / sec, "train_step_ms": 1e3 * sec,
                        "forward_flops_per_clip": flops,
                        "mfu": 3 * flops * SMALL_VID_BATCH / sec / PEAK_BF16_FLOPS,
                        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20}
        del m, st, b
        torch.cuda.empty_cache()
    out["c3d_resnet50_3d"] = {"clip": [SMALL_VID_T, SMALL_VID_SIZE, SMALL_VID_SIZE],
                              "batch": SMALL_VID_BATCH, **others}
    out["host_cpus"] = os.cpu_count()
    out["clocks_power"] = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    emit("video_times", **out)
    return out


RESUME_TOLERANCES = {"kernels": 1e-3, "others": 1e-2}


def yolo_model(seed: int = SEED) -> YOLOv3:
    return YOLOv3(num_classes=NUM_CLASSES, generator=torch.Generator().manual_seed(seed))


def quiet_logger() -> MetricLogger:
    return MetricLogger(stdout=False)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def host_state(fit: Fit) -> dict:
    """The state a checkpoint holds, copied to the host."""
    ema = fit.ema_model
    return copy.deepcopy({
        "model": {k: v.cpu() for k, v in fit.state.model.state_dict().items()},
        "optimizer": fit.state.optimizer.state_dict(),
        "ema": {k: v.detach().cpu() for k, v in ema.named_parameters()} if ema else None,
        "step": fit.state.step})


def same_state(a, b) -> bool:
    """Bit equality of two nested states (tensors compared on the host)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_state(x, y) for x, y in zip(a, b))
    return a == b


def counted(evaluate, sink: list):
    """An evaluator that records the NMS kernel's launches of each call."""
    def run(state, loader):
        suppression_mask_cuda.launches = 0
        out = evaluate(state, loader)
        torch.cuda.synchronize()
        sink.append(suppression_mask_cuda.launches)
        return out
    return run


def yolo_resume_fit(dev, ckpt_dir: str, resume: bool, sink: list) -> Fit:
    """The train phase's full-width YOLOv3-416 bf16 Fit (EMA on), checkpointed."""
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    loss_fn, postprocess = train_parts(anchors, NUM_CLASSES)
    model = yolo_model()
    loader = DetectionLoader(SyntheticDetectionDataset(TRAIN_IMAGES, NUM_CLASSES, seed=SEED),
                             INPUT_SIZE, TRAIN_BATCH, max_boxes=32, seed=SEED)
    val = DetectionLoader(SyntheticDetectionDataset(VAL_IMAGES, NUM_CLASSES, seed=SEED + 2),
                          INPUT_SIZE, VAL_BATCH, max_boxes=32, train=False)
    return Fit(model, loss_fn, build_optimizer("sgd", model, weight_decay=5e-4, momentum=0.937),
               loader, val, epochs=2,
               schedule=warmup_cosine_lr(1e-2, 1e-4, 2 * len(loader), warmup_steps=1),
               evaluator=counted(detection_evaluator(make_eval_step(postprocess,
                                                                    dtype=torch.bfloat16)), sink),
               ema_decay=0.9999, dtype=torch.bfloat16, metric_key="map50", metric_mode="max",
               logger=quiet_logger(), ckpt_dir=ckpt_dir, resume=resume, device=dev)


def frcnn_resume_fit(dev, ckpt_dir: str, resume: bool, sink: list) -> Fit:
    """The frcnn_train phase's full-width Faster R-CNN-512 bf16 Fit, checkpointed."""
    model = frcnn_model()
    loader = frcnn_loader(FRCNN_TRAIN_IMAGES, SEED, FRCNN_BATCH, FRCNN_SIZE)
    return Fit(model, None, build_optimizer("sgd", model, weight_decay=5e-4, momentum=0.937,
                                            grad_clip_norm=10.0),
               loader, frcnn_loader(FRCNN_VAL_IMAGES, SEED + 2, FRCNN_BATCH, FRCNN_SIZE,
                                    train=False), epochs=2,
               schedule=step_decay_lr(FRCNN_LR, 8 * len(loader)),
               evaluator=counted(detection_evaluator(make_frcnn_eval_step(
                   dtype=torch.bfloat16, **FRCNN_VAL)), sink),
               step_fn=make_frcnn_train_step(SEED, torch.bfloat16), metric_key="map50",
               metric_mode="max", logger=quiet_logger(), ckpt_dir=ckpt_dir, resume=resume,
               device=dev)


def resume_case(dev, build, workdir: str) -> dict:
    """Run 1: 2 epochs, checkpointed. Run 2: the same, cut after the first
    step of epoch 2 (request_preempt). Run 3: a new Fit(resume=True) that
    finishes it. The restored state must equal the saved one bit for bit."""
    sink: list = []
    run1_dir, run2_dir = os.path.join(workdir, "run1"), os.path.join(workdir, "run2")
    fit1 = build(dev, run1_dir, False, sink)
    start = {k: v.detach().cpu().clone() for k, v in fit1.state.model.state_dict().items()}
    t0 = time.perf_counter()
    fit1.run()
    run1_s = time.perf_counter() - t0
    steps = len(fit1.train_loader)
    check(not fit1.interrupted and fit1.global_step == 2 * steps, f"run 1: {fit1.global_step}")
    save = dict(fit1.ckpt.last_save)
    ckpt_bytes = dir_bytes(os.path.join(run1_dir, str(fit1.ckpt.latest_step())))

    fit2 = build(dev, run2_dir, False, sink)
    inner, calls = fit2.step_fn, []

    def cut(state, batch, lr):
        calls.append(1)
        if len(calls) == steps + 1:
            fit2.request_preempt()
        return inner(state, batch, lr)

    fit2.step_fn = cut
    fit2.run()
    check(fit2.interrupted and fit2.global_step == steps + 1, f"run 2 stopped at {fit2.global_step}")
    at_save = host_state(fit2)
    del fit2
    t0 = time.perf_counter()
    fit3 = build(dev, run2_dir, True, sink)
    torch.cuda.synchronize()
    build_restore_s = time.perf_counter() - t0
    restored = host_state(fit3)
    bit_equal_restore = same_state(restored, at_save)
    check(bit_equal_restore, "the restored state differs from the state at the save")
    check((fit3.start_epoch, fit3.global_step, fit3.state.step) == (1, steps + 1, steps + 1),
          f"resumed at epoch {fit3.start_epoch}, global step {fit3.global_step}")
    t0 = time.perf_counter()
    fit3._restore()  # the restore alone: read the files, load model, optimizer, EMA
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(same_state(host_state(fit3), at_save), "a second restore differs")
    fit3.run()
    check(fit3.global_step == fit1.global_step, f"run 3 ended at {fit3.global_step}")
    final1, final3 = host_state(fit1), host_state(fit3)
    worst = state_max_rel_diff(final3["model"], final1["model"], start)
    # one more save, timed: the step loop's stall (host copy) and the write
    mgr = fit3.ckpt
    t0 = time.perf_counter()
    fit3._save(99, {"epoch": 99, "global_step": fit3.global_step})
    stall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.wait()
    wait_s = time.perf_counter() - t0
    out = {"steps_per_epoch": steps, "run1_s": run1_s, "bytes_on_disk_per_checkpoint": ckpt_bytes,
           "checkpoint_tensor_bytes": save["bytes"], "host_copy_s_fit_save": save["host_copy_s"],
           "save_call_stall_s": stall_s, "save_host_copy_s": mgr.last_save["host_copy_s"],
           "wait_s": wait_s, "write_gb_s": mgr.last_save["bytes"] / max(wait_s, 1e-9) / 1e9,
           "copy_gb_s": mgr.last_save["bytes"] / max(mgr.last_save["host_copy_s"], 1e-9) / 1e9,
           "restore_s": restore_s, "fit_build_and_restore_s": build_restore_s,
           "restored_bit_equal": bit_equal_restore,
           "start_epoch": fit3.start_epoch, "global_step_at_resume": steps + 1,
           "final_bit_equal_to_uncut": same_state(final1, final3),
           "final_max_rel_vs_uncut": worst, "tolerances": RESUME_TOLERANCES,
           "val_launches": sink, "checkpoints": sorted(os.listdir(run1_dir))}
    del fit1, fit3
    return out


def phase_ckpt_resume(dev: torch.device, smi: str, workdir: str) -> dict:
    """Checkpoint, preempt and resume both detectors at full width. Keeps the
    YOLOv3 run 1's checkpoints for phase_evaluate."""
    free = shutil.disk_usage(workdir).free
    print(f"free disk space under {workdir}: {free / 2**30:.1f} GiB", flush=True)
    with deterministic_algorithms() as nondeterministic:
        yolo = resume_case(dev, yolo_resume_fit, os.path.join(workdir, "yolo"))
        shutil.rmtree(os.path.join(workdir, "yolo", "run2"))
        torch.cuda.empty_cache()
        frcnn = resume_case(dev, frcnn_resume_fit, os.path.join(workdir, "frcnn"))
        shutil.rmtree(os.path.join(workdir, "frcnn"))
        torch.cuda.empty_cache()
    for name, r in (("yolov3", yolo), ("faster_rcnn", frcnn)):
        if not nondeterministic:  # every op deterministic: the resumed run repeats the uncut one
            check(r["final_bit_equal_to_uncut"], f"{name}: the resumed run's final state differs "
                  f"from the uncut run's under deterministic algorithms: {r['final_max_rel_vs_uncut']}")
        else:
            worst = r["final_max_rel_vs_uncut"]
            check(worst["kernels"][0] <= RESUME_TOLERANCES["kernels"]
                  and worst["others"][0] <= RESUME_TOLERANCES["others"],
                  f"{name}: resumed run's final weights vs the uncut run's: {worst}")
    emit("ckpt_resume", card=smi, free_disk_gib=free / 2**30,
         deterministic_algorithms={"on": True, "warn_only": True,
                                   "ops_without_deterministic_implementation": nondeterministic,
                                   "final_state_required": "tolerance" if nondeterministic
                                   else "bit-equal"},
         yolov3={"model": "YOLOv3-416 full width, bf16, EMA, batch 32", **yolo},
         faster_rcnn={"model": "Faster R-CNN VGG16-512 full width, bf16, batch 8", **frcnn})
    return {"yolo_ckpt": os.path.join(workdir, "yolo", "run1"),
            "launches": {"ckpt_resume_yolo_validation": sum(yolo["val_launches"]),
                         "ckpt_resume_frcnn_validation": sum(frcnn["val_launches"])}}


class PseudoLabelled:
    """The images of ``ds`` labelled with ``det``'s own ``k`` best
    detections, each box jittered by N(0, ``jitter``) of its size: a model
    with random weights finds nothing of the synthetic GT, so its mAP
    would be 0 whatever the matching; against these labels it is well
    above 0, and near-duplicate detections put two predictions on one GT,
    where the device and host matching rules may differ."""

    def __init__(self, ds, det: Detector, k: int = 4, jitter: float = 0.1, seed: int = SEED):
        self.images = [ds[i][0] for i in range(len(ds))]
        rng = np.random.default_rng(seed)
        self.labels = []
        for r in det.predict_batch(self.images):
            b, c = r["boxes"][:k], r["classes"][:k].astype(np.float32)
            wh = np.concatenate([b[:, 2:] - b[:, :2]] * 2, 1)
            b = b + rng.normal(0, jitter, b.shape).astype(np.float32) * wh
            self.labels.append(np.concatenate([c[:, None], b], 1).astype(np.float32))

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int):
        return self.images[i], self.labels[i], f"pseudo_{i}"


def phase_evaluate(dev: torch.device, smi: str, ckpt_dir: str) -> dict:
    """Detector(YOLOv3-416, batch 32) from the resume phase's run-1
    checkpoint (EMA weights) over EVAL_IMAGES images of assorted sizes
    labelled with its own jittered detections: device against host
    matching, the reference sweep (and two low-confidence points) against
    per-point evaluate, the NMS kernel's launches around each call."""
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    model = yolo_model()
    meta = restore_inference_weights(ckpt_dir, model)
    det = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=EVAL_BATCH, device=dev)
    ds = PseudoLabelled(SyntheticDetectionDataset(EVAL_IMAGES, NUM_CLASSES, seed=SEED + 4,
                                                  sizes=SIZES), det)
    for device_matching in (True, False):  # warm-up: cuDNN's algorithm choice, each path once
        det.evaluate(ds, max_images=EVAL_BATCH, device_matching=device_matching)

    # the kernel against its plain version on this path's own inputs: the
    # first batch's device-resident predictions, each grid point's candidates
    first = next(det._loader(ds, 1).epoch(0))
    pred = det.predecode(torch.from_numpy(first["images"]).to(dev)).float()
    kernel_vs_plain = []
    for conf, iou in EVAL_POINTS:
        _, bx, sc, _ = nms_candidates(pred, conf_thres=conf, class_offset=det.class_offset)
        bx, sc = bx.contiguous(), sc.contiguous()
        keep = suppression_mask_cuda(bx, sc, iou)
        want = suppression_mask_plain(bx, sc, iou)
        kernel_vs_plain.append({"conf": conf, "iou": iou, "shape": list(sc.shape),
                                "valid": int((sc > float("-inf")).sum()),
                                "kept": int(want.sum()), "mismatches": int((keep != want).sum())})
    check(all(r["mismatches"] == 0 for r in kernel_vs_plain),
          f"nms kernel vs plain on the evaluate path's inputs: {kernel_vs_plain}")
    check(all(any(r["valid"] for r in kernel_vs_plain if r["iou"] == iou) for iou in SWEEP_IOUS),
          f"an IoU threshold without candidates: {kernel_vs_plain}")
    del pred

    def run(fn):
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, suppression_mask_cuda.launches

    dev_res, dev_s, dev_l = run(lambda: det.evaluate(ds, device_matching=True))
    host_res, host_s, host_l = run(lambda: det.evaluate(ds, device_matching=False))
    # the two matchers differ where two same-class predictions overlap one GT
    # at >= 0.5 IoU (the host keeps the lower index, the device the higher
    # IoU; as in the JAX package): count such images, and score the host's
    # boxes with the device's rule as well
    thr = torch.from_numpy(np.linspace(0.5, 0.95, 10).astype(np.float32))
    by_rule, conflicts = MeanAveragePrecision(), 0
    for res, gt in det.predict_dataset(ds):
        pb, pc = torch.from_numpy(res["boxes"])[None], torch.from_numpy(res["classes"]).float()[None]
        tb, tcls = torch.from_numpy(gt[:, 1:5])[None], torch.from_numpy(gt[:, 0])[None]
        corr = match_predictions_device(pb, pc, torch.ones(pc.shape, dtype=torch.bool), tb, tcls,
                                        torch.ones(tcls.shape, dtype=torch.bool), thr)[0].numpy()
        host_corr = match_predictions(res["boxes"], res["classes"], gt[:, 1:5], gt[:, 0],
                                      np.linspace(0.5, 0.95, 10))
        conflicts += int(not np.array_equal(corr, host_corr))
        by_rule.update_matched(corr, res["scores"], res["classes"], gt[:, 0])
    rule = by_rule.compute()
    check(abs(dev_res["map50"] - rule.map50) <= 1e-6 and abs(dev_res["map"] - rule.map) <= 1e-6,
          f"device matching {dev_res} vs the host's boxes under the device rule "
          f"{rule.map50, rule.map}")
    if conflicts == 0:
        check(abs(dev_res["map50"] - host_res["map50"]) <= 1e-6
              and abs(dev_res["map"] - host_res["map"]) <= 1e-6,
              f"device matching {dev_res} vs host matching {host_res}")
    points = EVAL_POINTS
    sweep, sweep_s, sweep_l = run(lambda: det.evaluate_sweep(ds, points))
    per_point, per_point_s, per_point_l = [], 0.0, 0
    for conf, iou in points:
        d = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=EVAL_BATCH,
                     conf_thres=conf, iou_thres=iou, device=dev)
        r, s, n = run(lambda d=d: d.evaluate(ds, device_matching=False))
        per_point.append(r)
        per_point_s += s
        per_point_l += n
    same = all((a["map50"], a["map"]) == (b["map50"], b["map"]) for a, b in zip(sweep, per_point))
    check(same, f"sweep rows {sweep} differ from per-point evaluate {per_point}")
    check(min(dev_l, host_l, sweep_l) > 0, f"launches {dev_l, host_l, sweep_l}")
    check(dev_res["map50"] > 0 and sweep[0]["map50"] > 0, "no mAP to compare: all 0")
    emit("evaluate", card=smi, model="YOLOv3-416 full width, bf16, EMA weights of the resume "
         "phase's run 1", checkpoint_epoch=meta.get("epoch"), images=EVAL_IMAGES, batch=EVAL_BATCH,
         device_matching={**dev_res, "seconds": dev_s, "launches": dev_l},
         host_matching={**host_res, "seconds": host_s, "launches": host_l},
         host_boxes_under_device_rule={"map50": rule.map50, "map": rule.map},
         images_where_matchers_differ=conflicts,
         kernel_vs_plain_per_point={"tolerance": "bit-equal", "first_batch": kernel_vs_plain},
         labels="the detector's own 4 best boxes per image, jittered by N(0, 0.1) of their size",
         sweep={"points": len(points), "seconds": sweep_s, "launches": sweep_l,
                "img_s": EVAL_IMAGES / sweep_s, "rows": sweep},
         per_point={"seconds": per_point_s, "launches": per_point_l,
                    "img_s": EVAL_IMAGES / per_point_s},
         sweep_rows_equal_per_point=same)
    return {"launches": {"detector_evaluate_device": dev_l, "detector_evaluate_host": host_l,
                         "detector_evaluate_sweep": sweep_l},
            "mismatches": sum(r["mismatches"] for r in kernel_vs_plain)}


def phase_cli(dev: torch.device, smi: str, workdir: str, cls_root: str, video_root: str) -> dict:
    """`fastvision_tpu_torch.cli.main` in-process over BMP files, on the
    config's worker pools (4 workers, 'process'): train YOLOv3-416 (default
    recipe: mosaic 0.5, hflip, HSV; EMA) for 2 epochs, resume to 3, eval
    --sweep from the checkpoint, train Faster R-CNN-512 for 1 epoch; then
    train-cls ResNet-50-224 for 1 epoch, --resume to 2, eval --task cls;
    then train-video SlowFast-R50 (32 x 224) for 1 epoch, --resume to 2,
    eval --task video with 4 clips a video."""
    from fastvision_tpu_torch import cli

    t0 = time.perf_counter()
    root = write_detection_dataset(os.path.join(workdir, "ds"), TRAIN_IMAGES, sizes=SIZES,
                                   seed=SEED + 5, num_classes=FRCNN_CLASSES)
    write_s = time.perf_counter() - t0
    ckpt = os.path.join(workdir, "yolo_ckpt")
    common = [f"data.data_root={root}", f"data.input_size={INPUT_SIZE}",
              f"data.batch_size={TRAIN_BATCH}", "train.ema_decay=0.9999"]
    runs: dict = {}

    def run(tag, argv):
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        out = cli.main(argv)
        torch.cuda.synchronize()
        runs[tag] = {"seconds": time.perf_counter() - t0, "launches": suppression_mask_cuda.launches}
        return out

    def epochs(log_dir):
        with open(os.path.join(log_dir, "train.jsonl")) as f:
            return [r for r in map(json.loads, f) if "train_loss" in r]

    fit = run("cli_train_yolo", ["train", "train.epochs=2", f"train.ckpt_dir={ckpt}", *common])
    check(fit.global_step == 2 * len(fit.train_loader) and not fit.interrupted, "cli train")
    del fit
    fit = run("cli_train_resume", ["train", "--resume", "train.epochs=3",
                                   f"train.ckpt_dir={ckpt}", *common])
    check(fit.start_epoch == 2 and fit.global_step == 3 * len(fit.train_loader), "cli resume")
    del fit
    torch.cuda.empty_cache()
    rows = run("cli_eval_sweep", ["eval", "--ckpt", ckpt, *common, "--sweep"])
    check(len(rows) == len(REFERENCE_SWEEP) and all(r["images"] == TRAIN_IMAGES for r in rows),
          f"sweep rows {rows}")
    frcnn_ckpt = os.path.join(workdir, "frcnn_ckpt")
    fit = run("cli_train_frcnn", ["train", "model.name=faster_rcnn", "train.epochs=1",
                                  f"model.num_classes={FRCNN_CLASSES}",
                                  f"data.input_size={FRCNN_SIZE}", f"data.batch_size={FRCNN_BATCH}",
                                  f"train.ckpt_dir={frcnn_ckpt}", f"data.data_root={root}",
                                  "train.lr=1e-2"])
    check(fit.global_step == len(fit.train_loader), "cli faster_rcnn")
    check(fit.train_loader.num_workers == 4 and fit.train_loader.worker_backend == "process",
          "the detection CLI did not run on the config's worker pools")
    del fit
    torch.cuda.empty_cache()

    cls_ckpt = os.path.join(workdir, "cls_ckpt")
    cls_common = [f"data.data_root={cls_root}", "model.backbone=resnet50",
                  f"model.num_classes={CLS_CLASSES}", f"data.input_size={CLS_SIZE}",
                  f"data.batch_size={CLS_BATCH}", f"train.ckpt_dir={cls_ckpt}"]
    cls_recipe = [f"train.lr={CLS_LR}", "train.momentum=0.9", "train.weight_decay=1e-4",
                  "train.warmup_epochs=0", "train.mixup_alpha=0.2", "train.cutmix_alpha=1.0",
                  "train.label_smoothing=0.1"]
    fit = run("cli_train_cls", ["train-cls", "train.epochs=1", *cls_recipe, *cls_common])
    steps = len(fit.train_loader)
    check(fit.global_step == steps and fit.train_loader.num_workers == 4, "cli train-cls")
    del fit
    fit = run("cli_train_cls_resume", ["train-cls", "--resume", "train.epochs=2", *cls_recipe,
                                       *cls_common])
    check(fit.start_epoch == 1 and fit.global_step == 2 * steps, "cli train-cls --resume")
    del fit
    torch.cuda.empty_cache()
    cls_res = run("cli_eval_cls", ["eval", "--task", "cls", "--ckpt", cls_ckpt, *cls_common])
    check(0.0 <= cls_res["accuracy"] <= 1.0, f"eval --task cls: {cls_res}")

    vid_ckpt = os.path.join(workdir, "video_ckpt")
    vid_common = [f"data.data_root={video_root}", "model.backbone=slowfast_resnet50",
                  f"model.num_classes={VID_CLASSES}", f"data.num_frames={VID_T}",
                  f"data.input_size={VID_SIZE}", f"data.batch_size={VID_BATCH}",
                  f"data.eval_clips={VID_EVAL_CLIPS}", f"train.ckpt_dir={vid_ckpt}"]
    vid_recipe = [f"train.lr={VID_LR}", "train.momentum=0.9", "train.weight_decay=1e-4",
                  "train.warmup_epochs=0"]
    fit = run("cli_train_video", ["train-video", "train.epochs=1", *vid_recipe, *vid_common])
    steps = len(fit.train_loader)
    check(fit.global_step == steps and fit.train_loader.num_workers == 4
          and fit.train_loader.worker_backend == "process", "cli train-video")
    del fit
    fit = run("cli_train_video_resume", ["train-video", "--resume", "train.epochs=2",
                                         *vid_recipe, *vid_common])
    check(fit.start_epoch == 1 and fit.global_step == 2 * steps, "cli train-video --resume")
    del fit
    torch.cuda.empty_cache()
    vid_res = run("cli_eval_video", ["eval", "--task", "video", "--ckpt", vid_ckpt, *vid_common])
    check(0.0 <= vid_res["accuracy"] <= 1.0 and vid_res["n_clips"] == VID_EVAL_CLIPS,
          f"eval --task video: {vid_res}")
    vid_epochs = epochs(vid_ckpt)
    check(vid_res["accuracy"] == vid_epochs[-1]["accuracy"],
          f"eval --task video {vid_res} differs from the run's last validation {vid_epochs[-1]}")

    cls_epochs = epochs(cls_ckpt)
    yolo_epochs, frcnn_epochs = epochs(ckpt), epochs(frcnn_ckpt)
    check(all(np.isfinite(r["train_loss"])
              for r in yolo_epochs + frcnn_epochs + cls_epochs + vid_epochs), "cli losses")
    zero_tags = ("cli_train_cls", "cli_train_cls_resume", "cli_eval_cls", "cli_train_video",
                 "cli_train_video_resume", "cli_eval_video")
    check(all(r["launches"] > 0 for tag, r in runs.items() if tag not in zero_tags)
          and all(runs[tag]["launches"] == 0 for tag in zero_tags), f"cli launches {runs}")
    keys = ("epoch", "train_loss", "epoch_img_s")
    emit("cli", card=smi, images_per_split=TRAIN_IMAGES, image_hw=[list(s) for s in SIZES],
         bmp_write_s=write_s, workers="the config's: num_workers 4, worker_backend 'process'",
         runs=runs,
         yolo_epochs=[{k: r[k] for k in (*keys, "map50", "map")} for r in yolo_epochs],
         frcnn_epochs=[{k: r[k] for k in (*keys, "map50", "map")} for r in frcnn_epochs],
         sweep_best=max(rows, key=lambda r: r["map50"]),
         cls_epochs=[{k: r[k] for k in (*keys, "accuracy")} for r in cls_epochs],
         cls_eval={"accuracy": cls_res["accuracy"], "img_per_sec": cls_res["img_per_sec"]},
         video_epochs=[{k: r[k] for k in (*keys, "accuracy")} for r in vid_epochs],
         video_eval={"accuracy": vid_res["accuracy"], "n_clips": vid_res["n_clips"],
                     "clip_per_sec": vid_res["clip_per_sec"]})
    return {"launches": {tag: r["launches"] for tag, r in runs.items()}, "zero": zero_tags}


def main() -> int:
    # cuBLAS reads its workspace layout once; this one (of the two that
    # PyTorch documents) lets phase_ckpt_resume run its matmuls deterministically
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    device = phase_device()
    phase_build()
    kernel = phase_kernel(dev)
    e2e = phase_e2e(dev)
    times = phase_times(dev, e2e, device["smi"])
    del e2e["det"], e2e["model"]
    train = phase_train(dev)
    phase_train_times(dev, train, device["smi"])
    del train["fit"]

    frcnn = frcnn_model().to(dev, memory_format=torch.channels_last)
    u8 = frcnn_u8(dev)
    fkernel = phase_frcnn_kernel(dev, frcnn, u8)
    feval = phase_frcnn_eval(dev, frcnn, u8)
    ftrain = phase_frcnn_train(dev)
    ftimes = phase_frcnn_times(dev, frcnn, u8, fkernel, ftrain, device["smi"])
    del frcnn, ftrain["fit"], ftrain["step_fn"], ftrain["batch"]
    torch.cuda.empty_cache()

    workdir = tempfile.mkdtemp(prefix="fastvision_smoke_")
    try:
        phase_cls_card_vs_cpu(dev)
        cls = phase_cls_train(dev, workdir)
        phase_cls_times(dev, cls, device["smi"], workdir)
        del cls["fit"], cls["batch"]
        torch.cuda.empty_cache()
        phase_video_card_vs_cpu(dev)
        video = phase_video_train(dev, workdir)
        phase_video_times(dev, video, device["smi"])
        del video["fit"], video["batch"]
        torch.cuda.empty_cache()
        resume = phase_ckpt_resume(dev, device["smi"], workdir)
        evaluate = phase_evaluate(dev, device["smi"], resume["yolo_ckpt"])
        shutil.rmtree(os.path.join(workdir, "yolo"))
        cli_run = phase_cli(dev, device["smi"], workdir, cls["root"], video["root"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit("total", seconds=time.perf_counter() - t_start)

    main_nms = times["nms_kernel"]["B8_main_path"]
    regimes = {"yolo_B8_main_path": main_nms, **{
        f"frcnn_{tag}": ftimes["nms_kernel"][tag] for tag in ("rpn_eval", "rpn_train", "head")}}
    by_path = {"detector_predict_batch": e2e["launches"], "fit_validation": train["val_launches"],
               "frcnn_eval_step": feval["launches"],
               "frcnn_fit_validation": ftrain["val_launches"],
               **cls["launches"], **video["launches"], **resume["launches"],
               **evaluate["launches"], **cli_run["launches"]}
    # classification and video recognition run no NMS: their paths are
    # counted, and hold 0 launches
    zero_paths = sorted([*cls["launches"], *video["launches"], *cli_run["zero"]])
    check(all(by_path[p] == 0 for p in zero_paths),
          f"classification or video launched nms: {by_path}")
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppression_mask", "route": "cuda",
        "source": "fastvision_tpu_torch/csrc/nms.cu",
        "replaces": "fastvision_tpu/ops/nms_pallas.py:32",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "paths_expected_at_zero": zero_paths,
        "max_abs_err": max(kernel["max_abs_err"], fkernel["max_abs_err"]),
        "mismatches": kernel["mismatches"] + fkernel["mismatches"] + evaluate["mismatches"],
        "ms": main_nms["ms"], "graph_ms": main_nms["graph_ms"], "plain_ms": main_nms["plain_ms"],
        "bound_ms": main_nms["bound_ms"], "bound_by": main_nms["bound_by"], "library_ms": None,
        "regimes": {tag: {k: r[k] for k in ("shape", "ms", "graph_ms", "plain_ms", "bound_ms",
                                            "bound_by")} for tag, r in regimes.items()},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
