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
              B = 8 clustered at K = 4096.

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
from fastvision_tpu_torch.data import normalize_images
from fastvision_tpu_torch.infer import Detector, preprocess_batch
from fastvision_tpu_torch.models import YOLOv3
from fastvision_tpu_torch.ops import COCO_ANCHORS, batched_non_max_suppression, nms_candidates
from fastvision_tpu_torch.ops.nms_kernel import (
    MAX_K,
    suppression_mask_cuda,
    suppression_mask_plain,
)
from fastvision_tpu_torch.testing import nms_case

SEED = 0
INPUT_SIZE = 416
NUM_CLASSES = 80
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
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
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type.name == "CUDA":
            kernels[ev.key[:90]] = us / 1e3 / reps
    busy_ms = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else None,
            "top_kernels_ms": dict(ranked)}


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
    main_nms = times["nms_kernel"]["B8_main_path"]
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppression_mask", "route": "cuda",
        "source": "fastvision_tpu_torch/csrc/nms.cu",
        "replaces": "fastvision_tpu/ops/nms_pallas.py:32",
        "launches": e2e["launches"], "max_abs_err": kernel["max_abs_err"],
        "mismatches": kernel["mismatches"], "ms": main_nms["ms"],
        "graph_ms": main_nms["graph_ms"], "plain_ms": main_nms["plain_ms"],
        "bound_ms": main_nms["bound_ms"], "bound_by": main_nms["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
