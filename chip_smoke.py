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
              image with the share of the dense bf16 peak (``mfu``).

The line before the last is {"kernels": [...]}, one entry per kernel of the
port; the last line is {"ok": true, "device": {...}}. Without a CUDA card the
script exits 1 at once.
"""
from __future__ import annotations

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
from fastvision_tpu_torch.models import YOLOv3
from fastvision_tpu_torch.ops import (
    COCO_ANCHORS,
    MeanAveragePrecision,
    batched_non_max_suppression,
    nms_candidates,
)
from fastvision_tpu_torch.ops.nms_kernel import (
    MAX_K,
    suppression_mask_cuda,
    suppression_mask_plain,
)
from fastvision_tpu_torch.testing import SyntheticDetectionDataset, nms_case, state_max_rel_diff
from fastvision_tpu_torch.train import (
    Fit,
    TrainState,
    YOLOv3Loss,
    build_optimizer,
    constant_lr,
    detection_evaluator,
    ema_update,
    make_eval_step,
    make_train_step,
    set_lr,
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
        if us > 0 and ev.device_type.name == "CUDA":
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
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            heads_dev = [h.float().cpu() for h in det.model(x32[:2].to(dev))]
            heads_cpu = cpu_model(x32[:2])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
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
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = TrainState.create(small, build_optimizer("sgd", small), dev)
        cpu = TrainState.create(small_cpu, build_optimizer("sgd", small_cpu), "cpu")
        _, m_card = step32(card, {k: torch.from_numpy(batch[k]).to(dev)
                                  for k in ("images", "labels")}, 1e-2)
        _, m_cpu = step32(cpu, {k: torch.from_numpy(batch[k]) for k in ("images", "labels")},
                          1e-2)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
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
    main_nms = times["nms_kernel"]["B8_main_path"]
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppression_mask", "route": "cuda",
        "source": "fastvision_tpu_torch/csrc/nms.cu",
        "replaces": "fastvision_tpu/ops/nms_pallas.py:32",
        "launches": e2e["launches"] + train["val_launches"],
        "launches_by_path": {"detector_predict_batch": e2e["launches"],
                             "fit_validation": train["val_launches"]},
        "max_abs_err": kernel["max_abs_err"],
        "mismatches": kernel["mismatches"], "ms": main_nms["ms"],
        "graph_ms": main_nms["graph_ms"], "plain_ms": main_nms["plain_ms"],
        "bound_ms": main_nms["bound_ms"], "bound_by": main_nms["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
