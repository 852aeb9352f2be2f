#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fastvision_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, with one CUDA card

Phases, each printing one JSON line ({"phase": ...}); any failure raises and
exits non-zero before a result is printed:

  1. device   the card's name, count and power limit (nvidia-smi);
  2. build    every ``csrc/*.cu`` compiled with nvcc (ptxas register and
              shared-memory report);
  3. kernel   each kernel against its plain PyTorch version on the card over
              seeded cases, clustered (trained-like) ones and K up to
              MAX_K included (keep masks must be bit-equal);
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
              ``mfu``; then the run's total seconds.

The line before the last is {"kernels": [...]}, one entry per kernel of the
port; the last line is {"ok": true, "device": {...}}. Without a CUDA card the
script exits 1 at once.
"""
from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from fastvision_tpu_torch import cuda_build
from fastvision_tpu_torch.core import MetricLogger
from fastvision_tpu_torch.data import DetectionLoader, normalize_images
from fastvision_tpu_torch.infer import Detector, decode_predictions, preprocess_batch, scale_coords
from fastvision_tpu_torch.models import FasterRCNN, YOLOv3
from fastvision_tpu_torch.models.detection import (
    detection_candidates,
    fastrcnn_postprocess,
    make_draws,
    proposal_candidates,
    select_detections,
    select_proposals,
)
from fastvision_tpu_torch.ops import (
    COCO_ANCHORS,
    MeanAveragePrecision,
    batched_non_max_suppression,
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
)
from fastvision_tpu_torch.train import (
    Fit,
    TrainState,
    YOLOv3Loss,
    build_optimizer,
    constant_lr,
    detection_evaluator,
    ema_update,
    labels_to_pixel_xyxy,
    make_eval_step,
    make_frcnn_eval_step,
    make_frcnn_train_step,
    make_train_step,
    set_lr,
    step_decay_lr,
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
SIZES = ((416, 416), (480, 640), (640, 360), (200, 300),
         (375, 500), (720, 1280), (300, 200), (416, 240))


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
        if isinstance(m, torch.nn.BatchNorm2d):
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
    ones, and K above 2048 up to the kernel's MAX_K."""
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
        k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
        total += 2 * k * out.shape[1] * out.shape[2] * out.shape[3]

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
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
    """Multiply-adds x 2 of every conv and linear layer that ``fn()`` runs,
    counted from the layer shapes."""
    total = 0

    def conv(m, _, out):
        nonlocal total
        k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
        total += 2 * k * out.numel()

    def linear(m, _, out):
        nonlocal total
        total += 2 * m.in_features * out.numel()

    handles = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d) else linear)
               for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
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


def main() -> int:
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
    emit("total", seconds=time.perf_counter() - t_start)

    main_nms = times["nms_kernel"]["B8_main_path"]
    regimes = {"yolo_B8_main_path": main_nms, **{
        f"frcnn_{tag}": ftimes["nms_kernel"][tag] for tag in ("rpn_eval", "rpn_train", "head")}}
    by_path = {"detector_predict_batch": e2e["launches"], "fit_validation": train["val_launches"],
               "frcnn_eval_step": feval["launches"],
               "frcnn_fit_validation": ftrain["val_launches"]}
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppression_mask", "route": "cuda",
        "source": "fastvision_tpu_torch/csrc/nms.cu",
        "replaces": "fastvision_tpu/ops/nms_pallas.py:32",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(kernel["max_abs_err"], fkernel["max_abs_err"]),
        "mismatches": kernel["mismatches"] + fkernel["mismatches"],
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
