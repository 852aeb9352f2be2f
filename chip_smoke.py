#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fastvision_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, with one CUDA card

Phases, each printing one JSON line ({"phase": ...}); any failure raises and
exits non-zero before a result is printed:

  1. device   the card's name, count and power limit (nvidia-smi);
  2. build    every ``csrc/*.cu`` compiled with nvcc (ptxas register and
              shared-memory report) and every ``csrc/*.cpp`` (the JPEG
              decoder, the letterbox, the MPEG-4 packer and decoder) with the host
              compiler, all at once; meanwhile a child process builds them
              all into a fresh ``compile_cache`` directory
              (`core.mesh.enable_compile_cache`), then a second child finds
              every one there with ``seconds == 0.0`` (both wall times);
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
  20. codec   the port's image decoder (``data/codec.py``, JPEG through
              ``csrc/jpeg_decode.cpp``) over the committed corpus in
              ``tests/torch_codec_fixtures``: every image's decode against
              the cv2 pixels (or sha256) stored beside it, 0 differing
              bytes; the truncated file and the progressive one without
              Huffman tables must raise; then ``decode_image`` ms per
              full-size JPEG (640 x 480 to 1280 x 720) on one thread and
              images/s on 4;
  21. serve   the serving path: the serving preset's ``Detector`` built by
              the CLI's ``_detector_from_cfg`` (full-width YOLOv3-416, 80
              classes, bf16, random weights, batch 8, buckets 1 / 2 / 4,
              multi-label NMS at conf 0.001 / IoU 0.6) in ``VisionService``
              behind ``make_server`` on a loopback port: ``warmup`` timed;
              each full-size JPEG POSTed alone (equal to
              ``VisionService.predict``); 16 clients x 16 requests at once
              (requests/s, p50 / p90 / p99, the batches formed; every
              answer equal, exactly, to its image's answer at the bucket it
              ran in: a bf16 answer is fixed by the bucket alone); one
              batch of 8 split into decode, letterbox, upload + device + NMS
              and JSON; ``/predict_stream`` of 24 images; ``/healthz``; 413
              for an announced 64 MiB body; the drain (queued requests
              answered, a late one 503); the NMS kernel bit-equal to its
              plain version on this path's multi-label inputs (K = 1024),
              timed, and its launches on each path;
  22. cli     ``fastvision_tpu_torch.cli.main`` in-process over BMP files
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
              and video ones); ``python -m fastvision_tpu_torch serve`` as a
              process on a free port (``/healthz``, one JPEG, SIGTERM: it
              must drain and exit with 0);
  23. i420    bench.py's jpeg -> boxes path: ``Detector(input_format='i420',
              batch_size=32)`` (YOLOv3-416 full width, 80 classes, bf16,
              random weights, BN from the phase's images, conf 0.25 / IoU
              0.45, K = 1024) over 284 JPEGs written with
              ``testing.encode_baseline_jpeg`` (7x7-blurred seeded noise,
              4:2:0 q90: 256 at 640 x 480, 16 at 1280 x 720, 8 at 1920 x
              1080, 4 with EXIF orientation 6). The fused JPEG -> I420
              decode and the reduced RGB decode against the oracles stored
              with the codec corpus (bit-equal); ``predict_dataset(
              fast_decode=True)`` with 0 and 4 process workers (the same
              detections, GT byte-equal, 0 fallbacks) and on the RGB path,
              each with the kernel's launches counted; the i420 program in
              float32 (TF32 off) card vs CPU (the heads; the decoded boxes
              reported); the device letterbox
              card vs CPU and vs the host letterbox, and a
              ``device_letterbox`` predict_batch; ``evaluate(tta=True)`` and
              ``evaluate`` under ``reference_demo`` (pad 0) on 64 images
              labelled with the detector's own detections; the kernel
              bit-equal to its plain version on each of these paths' inputs
              (the demo's in original pixels up to 1920); the times: fused
              decode against decode + letterbox + RGB -> I420 (1 and 4
              threads), H2D of an i420 and an rgb batch of 32, device
              programs, device vs host letterbox, TTA eval images/s;
  24. int8    int8 w8a8 PTQ: ``Detector.quantize`` of a full-width
              YOLOv3-416 (bf16, batch 32, BN from the phase's images) on 8
              images, one ``predict_batch`` with the launches of the NMS
              kernel and of the int8 kernels counted: ``int8_conv``
              (``csrc/int8_conv.cu``, the implicit-GEMM conv with its
              epilogue fused) on the 71 convs it takes, 66 of them writing
              their consumer's int8 input (Darknet's residual added there
              too: no residual add runs outside it), the quantize pass on
              the other 5 (INT8_QUANTIZE_PASSES), ``csrc/int8.cu``'s
              patches and epilogue kernels on the RGB stem; at batch 32 on every
              quantized conv's own input the int32 accumulators of the card
              route bit-equal to the plain version (float64 conv), the
              patches kernel bit-equal and the epilogue kernel within
              INT8_EPILOGUE_ULPS of their plain versions, and on the 71
              ``int8_conv`` in mode (b) bit-equal to the plain accumulators
              and in mode (a) byte-equal to the GEMM route (patches,
              ``_int_mm``, epilogue) in bf16 and float32, its fused
              epilogue byte-equal to mode (a) + PyTorch's add + the
              quantize pass, and on ``testing.INT8_IMPLICIT_CASES``; the
              linked forward's heads byte-equal to the unlinked forward's;
              the stems' patches kernel (YOLOv3, VGG16, ResNet-50) byte-equal
              to its plain version and timed; float32 card vs CPU conv by
              conv on the card's inputs (INT8_LAYER_TOL) and for the whole
              model (correlation, INT8_HEADS_MIN_CORR: last-bit differences
              of silu flip int8 roundings, which random weights amplify);
              the bf16 int8 heads against the bf16 float model; the int8
              forward's profile (71 ``int8_conv`` launches, 5 quantize
              passes, one ``_int_mm`` and the 3 float pred convs a call, the
              top kernels); the int8 and bf16 device programs at batch 32
              and 256 (img/s, peak memory); the int8 convs' split at both
              batches (``int8_conv`` in each layer's linked mode, summed by
              mode, and the 5 quantize passes, against what the links took
              away and the GEMM route's three steps on the same layers,
              ``_int_mm`` alone as the library yardstick, plain versions at
              32, each with its bound); ``eval --int8`` and
              ``serve --int8 --calib-dir`` through ``cli.main`` at full
              width; Faster R-CNN-VGG16 at 512 with an int8 backbone,
              ResNet-50 (batch 128) and ResNeXt-50 32x4d (batch 32) at 224
              against bf16 (``int8_conv`` launches counted), and a small
              ResNeXt in float32 card vs CPU;
  25. export  ``torch.export`` programs (`infer.export`) of YOLOv3-416 at full
              width (80 classes, bf16, K = 1024, BN from the phase's images)
              at batch 8 and 32, float and after ``Detector.quantize``, of
              ResNet-50 (224) and SlowFast-R50 (32 x 224) at batch 8, each
              loaded in a fresh process (``run_loaded_programs``) and run
              on the phase's images under ``deterministic_algorithms``:
              outputs bit-equal to the eager programs' (Detections, or
              probabilities); the float graphs hold one
              ``fastvision::nms_suppression_mask`` node and bf16 convs, the
              int8 ones 71 ``int8_conv``, 6 ``int8_patches`` (the 5 quantize
              passes and the stem's patches) and 1 ``int8_epilogue`` node,
              the classifiers none; the loaded programs' kernel launches
              counted; export and load seconds, file bytes, node counts, and
              the loaded and the eager programs' ms in turns (eager, loaded,
              loaded, eager), between events over back-to-back calls and as
              one call captured in a CUDA graph and replayed (``graph_ms``:
              the device's time);
  26. recipe  the training recipe's options on YOLOv3-416 at full width
              (bf16, K = 1024): ``cli.main(["train", ...])`` with every
              augmentation op the process pools take (all but
              'normalization') at p < 1 and ``train.accum_steps: 2`` for 2
              epochs, the validations' NMS launches counted and their inputs
              held against the plain version; ``train-cls`` (ResNet-50-224)
              with random_crop, center_crop, resize and hflip;
              ``YOLOv3LossPerCell`` (bce_mse, ciou) one float32 step card vs
              CPU and a bf16 ``Fit`` at batch 32, the train step's img/s and
              the loss's ms beside ``YOLOv3Loss``'s; accum_steps 2 through
              ``Fit`` cut after call 3 (mid-cycle) and resumed, against the
              uncut run under deterministic algorithms; the loader's img/s at
              0 and 4 workers with the full op list against the default
              recipe (and with 'normalization' on 4 threads), each op's host
              ms on a 640 x 480 image;
  27. decode  the decode leftovers: the corpus's progressive (cv2, PIL, every
              sampling, restarts, EOB runs, successive approximation, a
              script stopping at Al = 1 and one of DC scans only: block
              smoothing), CMYK, YCCK, table-less and Adam7 files against the
              stored cv2 pixels at full size and at 1/2, 1/4, 1/8, the fused
              I420 decode against the JAX package's stored outputs (None on
              CMYK / YCCK), and the Motion-JPEG AVIs (cv2's frame counts, each
              frame's ``cv2.imdecode`` pixels); bench.py's jpeg -> boxes
              corpus (DECODE_SHAPES) encoded twice by
              ``testing.encode_progressive_jpeg`` from the same quantized
              coefficients, progressive and sequential: every decode (full,
              fused I420 at 416, reduced) of the pair bit-equal; the times of
              both (1 and 4 threads, the fused decode); a 640 x 480, 64-frame
              MJPEG AVI (every other frame without DHT) read by ``load_clip``,
              ``VideoFolderDataset`` and a ``VideoClipLoader`` epoch (4 process
              workers) feeding the full-width SlowFast-R50 (32 x 224, bf16)
              eval step (NMS launches counted: 0), and
              ``Detector.predict_video`` with full-width YOLOv3-416 (80
              classes, bf16, batch 8, K = 1024, BN from the smoke's images):
              each frame's result bit-equal to ``predict_batch`` on the same
              frames decoded one by one, the NMS kernel's launches counted
              and each keep mask bit-equal to the plain version, the kernel
              timed on this path's inputs; demux + decode and predict_video
              frames/s; then ``predict_video(out_path=)`` (the port's MPEG-4
              encoder and MP4 muxer: no cv2 here), its NMS launches counted
              and held, the file's own ``moov`` read back (frame count, fps,
              ``stsz`` summing to the ``mdat`` payload), its samples equal
              to the encoder's bytes of the drawn frames, each frame's
              reconstruction within 1 level of the 4:2:0 round trip's own
              loss, and the file decoded by the port (each frame's planes
              within 1 level of the encoder's reconstruction); encode ms and
              bytes a frame, frames/s with out_path; then MPEG-4 Part 2
              with ``import cv2`` blocked (``mpeg4``): every committed fixture of
              ``tests/torch_video_fixtures`` (XviD / DivX / mp4v in AVI, MP4
              and MOV, B-frames, 4MV, quarter-pel, interlacing, ...) decoded
              to FFmpeg's planes (SHA-256 per frame) with cv2's counts and
              seek landings, decode frames/s at 1 and 4 threads (320 x 240
              XviD, 640 x 480 mp4v), the fixtures as a folder through
              ``VideoClipLoader`` (4 process workers) into SlowFast-R50's
              eval step (NMS launches counted: 0), and ``predict_video`` on
              the 320 x 240 XviD clip, equal to ``predict_batch`` on its
              frames, the NMS kernel's launches counted under
              ``detector_predict_video_mpeg4`` and held bit-equal to the
              plain version;
  28. parallel  data parallel over a process group, in subprocesses
              (``chip_smoke.py --parallel-child ...``, each a fresh TCP
              port): world size 1 over NCCL at full width, ``cli.main(["train",
              ..., "multihost=true", "data.host_shard=auto", "mesh_data=1"])``
              (YOLOv3-416, bf16, batch 32, 2 epochs over 64 BMP images,
              validated by the sharded ``detection_evaluator``, the NMS
              kernel's launches counted and its keep masks held against the
              plain version) under DDP and with ``fsdp=true``; one float32
              step under DDP bit-equal to the plain ``Fit`` step, under FSDP
              within 1e-5 of each tensor's std, the FSDP checkpoint restored
              in this process bit-equal to the gathered state; two ranks on
              the one card (gloo with CUDA tensors) against one process on
              the global batch; train img/s plain, DDP and FSDP, the global
              BN against plain BN over Darknet-53's layers, the evaluator
              sharded and not; the mesh's model and time axes (PR 17); the
              GPipe pipeline (`parallel.pipeline`): at world size 1 over NCCL
              ``pipeline_apply`` bit-equal to the chain, and the two gloo
              ranks as a 2-stage model axis: ViT-B/16 (224, 1000 classes)
              through ``pipeline_vit_apply`` at batch 8 in 4 microbatches,
              float32 with TF32 off, logits and every gradient within 1e-5 of
              each tensor's std of the plain model in the same process,
              ResNet-50 through ``resnet_stage_split`` (logits, same limit),
              a small float64 ViT trunk and ResNet within 1e-12 (logits and
              gradients), each rank's seconds and img/s (gloo's host
              staging);
  29. doctor  ``cli.main(["doctor"])``: the card, nvcc, ``compile_cache``, the
              builds, a bf16 matmul chain's TFLOP/s; then the run's total
              seconds.

``python3 chip_smoke.py --only i420`` (or ``--only int8``, ``--only export``,
``--only recipe``, ``--only decode``, ``--only parallel``) runs the device
and build phases and the i420 (int8; doctor and export; recipe; decode;
parallel) phases alone (a quick check of this path; the full run takes no
arguments).

The line before the last is {"kernels": [...]}, one entry per kernel of the
port: the NMS kernel with its launches on every path (the data-parallel
``train`` runs' validations among them; the classification and video paths
counted and required at 0: they run no NMS), then the int8
kernels (``int8_conv``, its quantize pass, the patches and epilogue
kernels) with their launches on the int8 main path and the exported int8
programs; the last line is
{"ok": true, "device": {...}}. Without a CUDA card the script exits 1 at
once.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import functools
import hashlib
import importlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from fastvision_tpu_torch import cuda_build
from fastvision_tpu_torch.core import (CheckpointManager, MetricLogger,
                                      restore_inference_weights)
from fastvision_tpu_torch.data import (
    Augmentation,
    ClassificationDataset,
    ClassificationLoader,
    DetectionDataset,
    DetectionLoader,
    OP_REGISTRY,
    HorizontalFlip,
    HSVJitter,
    VideoClipLoader,
    VideoFolderDataset,
    build_augmentation,
    normalize_images,
)
from fastvision_tpu_torch.data import avi
from fastvision_tpu_torch.data.codec import decode_image, decode_jpeg_i420, decode_jpeg_reduced
from fastvision_tpu_torch.data.video_sampler import count_real_frames, load_clip, sample_indices
from fastvision_tpu_torch.data.dataset import imread_rgb_scaled, letterbox, resize_bilinear
from fastvision_tpu_torch.infer import (
    REFERENCE_SWEEP,
    Detector,
    VideoClassifier,
    decode_predictions,
    preprocess_batch,
    scale_coords,
)
from fastvision_tpu_torch.infer.export import (
    classifier_program,
    detector_program,
    export_program,
    load_exported,
    load_program,
    node_count,
    op_counts,
)
from fastvision_tpu_torch.infer.postprocess import reference_demo_unscale
from fastvision_tpu_torch.infer.predictor import _Subset
from fastvision_tpu_torch.infer.quantize import link_int8, quant_state, quantize_model
from fastvision_tpu_torch.models import FasterRCNN, YOLOv3
from fastvision_tpu_torch.models.classification import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ViT,
    darknet53,
    resnet50,
    resnext50_32x4d,
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
from fastvision_tpu_torch.nn.layers import (BatchNorm, Int8Conv, conv_bn_pairs,
                                            memory_format_for)
from fastvision_tpu_torch.ops.image import (
    i420_packed_to_rgb,
    letterbox_batch,
    pack_canvas,
    rgb_batch_to_i420_packed,
)
from fastvision_tpu_torch.ops.int8 import (
    ACTIVATIONS,
    add_residual,
    epilogue_cuda,
    epilogue_plain,
    gemm_weight,
    implicit_gemm_eligible,
    int8_conv2d,
    int8_conv2d_plain,
    int8_conv_cuda,
    int8_conv_plain,
    int8_gemm,
    out_hw,
    quantize_activation,
    quantize_activation_cuda,
    quantize_patches_cuda,
    quantize_patches_plain,
)
from fastvision_tpu_torch.ops.nms_kernel import (
    MAX_K,
    suppression_mask_cuda,
    suppression_mask_plain,
)
from fastvision_tpu_torch.testing import (
    INT8_IMPLICIT_CASES,
    SyntheticDetectionDataset,
    blurred_noise,
    encode_lossless_jpeg,
    encode_progressive_jpeg,
    mjpeg_avi,
    standard_jpeg_tables,
    with_exif_orientation,
    int8_conv_case,
    quantize_tie_cases,
    nms_case,
    rpn_nms_case,
    state_max_rel_diff,
    write_classification_dataset,
    write_detection_dataset,
    write_jpeg_detection_dataset,
    write_video_dataset,
)
from fastvision_tpu_torch.train import (
    Fit,
    TrainState,
    YOLOv3Loss,
    YOLOv3LossPerCell,
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
from fastvision_tpu_torch.train.optim import MultiSteps

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


# a fresh process that builds (or finds) every csrc source in the compile_cache argv[1]
CACHE_CHILD = """import json, sys, time
t0 = time.perf_counter()
from fastvision_tpu_torch import cuda_build
from fastvision_tpu_torch.core import enable_compile_cache
enable_compile_cache(sys.argv[1])
builds = cuda_build.build_all()
print(json.dumps({"wall_s": time.perf_counter() - t0,
                  "builds": {b.name: [b.seconds, b.path] for b in builds}}))
"""


def cache_child(cache: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", CACHE_CHILD, cache], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def cache_result(proc: subprocess.Popen, t0: float) -> dict:
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"compile_cache child exited {proc.returncode}: {err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    res["process_wall_s"] = time.perf_counter() - t0
    return res


def phase_build() -> None:
    """Every csrc source built at once into ``_build/``; meanwhile a child
    process builds them all into a fresh ``compile_cache`` directory
    (`core.mesh.enable_compile_cache`), then a second child finds every one
    there (``seconds == 0.0``, the same paths)."""
    cache = tempfile.mkdtemp(prefix="fastvision_cache_")
    try:
        t_first = time.perf_counter()
        first = cache_child(cache)
        t0 = time.perf_counter()
        builds = cuda_build.build_all()
        seconds = time.perf_counter() - t0
        first = cache_result(first, t_first)
        t_second = time.perf_counter()
        second = cache_result(cache_child(cache), t_second)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    names = sorted(cuda_build.sources())
    check(sorted(first["builds"]) == names and all(
        sec > 0 and os.path.dirname(path) == cache for sec, path in first["builds"].values()),
        f"compile_cache, first process: {first}")
    check(sorted(second["builds"]) == names and all(
        sec == 0.0 and path == first["builds"][n][1] for n, (sec, path) in
        second["builds"].items()), f"compile_cache, second process: {second}")
    report = []
    for b in builds:
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        report.append({"source": b.source, "compile_s": round(b.seconds, 3), "ptxas": ptxas})
    emit("build", seconds=round(seconds, 3), builds=report, compile_cache={
        "sources": len(names),
        "first_process": {"wall_s": first["wall_s"], "process_wall_s": first["process_wall_s"],
                          "compile_s": {n: v[0] for n, v in first["builds"].items()}},
        "second_process": {"wall_s": second["wall_s"],
                           "process_wall_s": second["process_wall_s"],
                           "all_found": True}})


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
    # reported: the decode (wh = (2 sigmoid)^2 anchor) amplifies their rounding
    dec_dev = decode_predictions(heads_dev, torch.from_numpy(anchors), det.strides, "v5")
    dec_cpu = decode_predictions(heads_cpu, torch.from_numpy(anchors), det.strides, "v5")
    decoded_rel = {k: float((dec_dev[..., sl] - dec_cpu[..., sl]).abs().max()
                            / dec_cpu[..., sl].std())
                   for k, sl in (("xy", slice(0, 2)), ("wh", slice(2, 4)), ("obj", slice(4, 5)),
                                 ("cls", slice(5, None)))}

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
         decoded_max_abs_over_field_std=decoded_rel,
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
    # tolerances: see tests/test_torch_gpu.py::test_train_step_on_card_equals_cpu
    card_vs_cpu = {"model": "YOLOv3 stage_sizes (1,1,1,1,1), 80 classes, 256 px, batch 4, "
                            "float32, TF32 off, one SGD step at lr 1e-2",
                   **card_vs_cpu_step(dev, loss_fn)}
    emit("train_card_vs_cpu", **card_vs_cpu)
    check(card_vs_cpu["within"], f"train step card vs cpu: {card_vs_cpu}")

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


def step_rate(step, state, batch, lr: float = 1e-3, reps: int = 8, warmup: int = 1) -> float:
    """Seconds per train step: ``warmup`` steps, ``reps`` steps, one sync.
    The step gets a generator for models with dropout (C3D)."""
    rng = torch.Generator(device=state.device).manual_seed(SEED)
    for _ in range(warmup):
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


def yolo_resume_fit(dev, ckpt_dir: str, resume: bool, sink: list, accum_steps: int = 1) -> Fit:
    """The train phase's full-width YOLOv3-416 bf16 Fit (EMA on), checkpointed;
    ``accum_steps`` > 1 averages that many calls' gradients per update."""
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    loss_fn, postprocess = train_parts(anchors, NUM_CLASSES)
    model = yolo_model()
    loader = DetectionLoader(SyntheticDetectionDataset(TRAIN_IMAGES, NUM_CLASSES, seed=SEED),
                             INPUT_SIZE, TRAIN_BATCH, max_boxes=32, seed=SEED)
    val = DetectionLoader(SyntheticDetectionDataset(VAL_IMAGES, NUM_CLASSES, seed=SEED + 2),
                          INPUT_SIZE, VAL_BATCH, max_boxes=32, train=False)
    return Fit(model, loss_fn, build_optimizer("sgd", model, weight_decay=5e-4, momentum=0.937,
                                               accum_steps=accum_steps),
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
           "optimizer_mini_step_at_save": at_save["optimizer"].get("mini_step"),
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


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_codec_fixtures")
SERVE_THREADS, SERVE_PER_THREAD, STREAM_IMAGES = 16, 16, 24
def codec_fixtures() -> tuple[list[dict], dict]:
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    for e in manifest:
        with open(os.path.join(FIXTURES, e["file"]), "rb") as f:
            e["data"] = f.read()
    with np.load(os.path.join(FIXTURES, "cv2_decodes.npz")) as stored:
        pixels = {k: stored[k] for k in stored.files}
    return manifest, pixels


def full_size_jpegs() -> list[bytes]:
    return [e["data"] for e in codec_fixtures()[0] if e["file"].startswith("full_")]


def phase_codec(smi: str) -> dict:
    """The port's decoder against cv2's pixels stored with the corpus (0
    differing bytes), the files that must raise, then decode_image's time
    on the full-size JPEGs on one thread and on 4."""
    manifest, pixels = codec_fixtures()
    differing, raised, checked = 0, [], 0
    for e in manifest:
        if "video" in e:  # the Motion-JPEG AVIs: phase_decode
            continue
        if "raises" in e:
            try:
                decode_image(e["data"])
            except ValueError as err:
                check(e["raises"] in str(err), f"{e['file']}: raised {err!r}")
                raised.append(e["file"])
                continue
            raise SmokeFailure(f"{e['file']} decoded; it must raise {e['raises']!r}")
        got = decode_image(e["data"])
        check(list(got.shape) == e["shape"], f"{e['file']}: shape {got.shape} != {e['shape']}")
        if e["file"] in pixels:
            differing += int((got != pixels[e["file"]]).sum())
        check(hashlib.sha256(got.tobytes()).hexdigest() == e["sha256"],
              f"{e['file']}: the decode's sha256 differs from cv2's")
        checked += 1
    check(differing == 0, f"the decoder differs from cv2 in {differing} bytes")
    full = [e for e in manifest if e["file"].startswith("full_")]
    times = {}
    for e in full:
        decode_image(e["data"])
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            out = decode_image(e["data"])
        ms = 1e3 * (time.perf_counter() - t0) / reps
        times[e["file"]] = {"ms": ms, "out_mb_s": out.nbytes / 1e6 / (ms / 1e3),
                            "in_bytes": len(e["data"])}
    from concurrent.futures import ThreadPoolExecutor

    datas = [e["data"] for e in full] * 16
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(decode_image, datas[:8]))
        t0 = time.perf_counter()
        outs = list(pool.map(decode_image, datas))
        dt = time.perf_counter() - t0
    threads4 = {"images": len(datas), "img_s": len(datas) / dt,
                "out_mb_s": sum(o.nbytes for o in outs) / 1e6 / dt}
    emit("codec", card=smi, files=len(manifest), checked=checked, differing_bytes=differing,
         raised=raised, full_size_1_thread=times, full_size_4_threads=threads4,
         host_cpus=os.cpu_count())
    return {"differing": differing}


def _http(port: int, method: str, path: str, body: bytes | None = None, timeout: float = 120):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request(method, path, body=body)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_detector(dev: torch.device) -> Detector:
    """The serving preset's Detector, built by the CLI's own code: full-width
    YOLOv3-416, 80 classes, bf16, random weights (train.seed 0), batch 8,
    buckets (1, 2, 4), multi-label NMS at conf 0.001 / IoU 0.6; BN
    statistics calibrated on the full-size corpus images."""
    from fastvision_tpu_torch import cli

    args, _ = cli.make_parser().parse_known_args(["serve"])
    cfg = cli._load_config(args, list(cli.SERVE_PRESET))
    det = cli._detector_from_cfg(cfg, "", dev, batch_buckets=cli.SERVE_BUCKETS)
    batch, _ = preprocess_batch([decode_image(b) for b in full_size_jpegs()], INPUT_SIZE)
    calibrate_bn_(det.model, normalize_images(torch.from_numpy(batch), torch.float32).to(dev))
    return det


def phase_serve(dev: torch.device, smi: str) -> dict:
    """VisionService + make_server with the serving preset on the card:
    warmup, sequential and concurrent /predict, one batch's split,
    /predict_stream, /healthz, 413, the drain; the NMS kernel against its
    plain version on this path's own multi-label inputs, and its launches
    on each path."""
    import base64
    import http.client
    import threading

    from fastvision_tpu_torch.infer import VisionService, make_server
    from fastvision_tpu_torch.ops import multilabel_candidates

    det = serve_detector(dev)
    check(det.multi_label and det.batch_buckets == (1, 2, 4, 8) and det.conf_thres == 0.001
          and det.iou_thres == 0.6 and det.dtype == torch.bfloat16, "the serving preset")
    service = VisionService(det)
    jpegs = full_size_jpegs()
    launches: dict = {}

    def counted(tag, fn):
        torch.cuda.synchronize()
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[tag] = suppression_mask_cuda.launches
        return out, time.perf_counter() - t0

    _, warmup_s = counted("serve_warmup", service.warmup)
    batches: list[list[bytes]] = []
    predict_many = service.predict_many

    def recording(payloads):  # the batches the batcher forms
        batches.append(list(payloads))
        return predict_many(payloads)

    service.predict_many = recording
    port = free_port()
    server = make_server(service, "127.0.0.1", port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        # sequential: each image alone, against VisionService.predict
        def sequential():
            out, lat = [], []
            for b in jpegs:
                t0 = time.perf_counter()
                status, body = _http(port, "POST", "/predict", b)
                lat.append(time.perf_counter() - t0)
                check(status == 200, f"/predict: {status} {body[:200]}")
                out.append(json.loads(body))
            return out, lat

        (seq, seq_lat), _ = counted("serve_sequential", sequential)
        # each image's answer at each bucket: in bf16 an answer is fixed by
        # the bucket (batch size) it runs in, whatever shares the batch,
        # and differs between buckets (other cuDNN algorithms), so every
        # concurrent answer is held, exactly, to its image's at its bucket
        ref = {b: [predict_many([j] * b)[0] for j in jpegs] for b in det.batch_buckets}
        check(seq == ref[1], "a sequential /predict answer differs from VisionService.predict")
        n_det = [len(r["detection_scores"]) for r in seq]
        check(min(n_det) > 0, f"no detections: {n_det}")
        same_as = {(k, b): (k, next(b0 for b0 in det.batch_buckets if ref[b0][k] == ref[b][k]))
                   for k in range(len(jpegs)) for b in det.batch_buckets}

        # concurrent: SERVE_THREADS clients x SERVE_PER_THREAD requests
        batches.clear()
        results: list = []
        lock = threading.Lock()

        def client(t):
            for i in range(SERVE_PER_THREAD):
                k = (t + i) % len(jpegs)
                t0 = time.perf_counter()
                status, body = _http(port, "POST", "/predict", jpegs[k])
                with lock:
                    results.append((k, status, time.perf_counter() - t0, body))

        def concurrent():
            threads = [threading.Thread(target=client, args=(t,)) for t in range(SERVE_THREADS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            check(not any(th.is_alive() for th in threads), "a client thread hangs")

        _, conc_s = counted("serve_concurrent", concurrent)
        n_req = SERVE_THREADS * SERVE_PER_THREAD
        check(len(results) == n_req and all(r[1] == 200 for r in results),
              f"concurrent: {sorted({r[1] for r in results})}")
        index = {b: k for k, b in enumerate(jpegs)}
        expected = collections.Counter(
            same_as[(index[p], next(b for b in det.batch_buckets if b >= len(batch)))]
            for batch in batches for p in batch)
        answered: collections.Counter = collections.Counter()
        for k, _, _, body in results:
            got = json.loads(body)
            at = [b for b in det.batch_buckets if ref[b][k] == got]
            check(at, f"a concurrent answer for image {k} equals its answer at no bucket")
            answered[same_as[(k, at[0])]] += 1
        check(answered == expected, f"answers by (image, bucket) {dict(answered)} differ from "
              f"the batches formed {dict(expected)}")
        lat = np.array([r[2] for r in results]) * 1e3
        sizes = [len(b) for b in batches]
        formed = dict(sorted({b: sizes.count(b) for b in sizes}.items()))

        # one batch of 8 split into its parts (predict_many's own steps)
        payloads = [jpegs[i % len(jpegs)] for i in range(8)]
        split = {"decode": [], "letterbox": [], "upload_device_nms": [], "json": []}
        for _ in range(6):
            t0 = time.perf_counter()
            imgs = [decode_image(b) for b in payloads]
            t1 = time.perf_counter()
            batch, metas = preprocess_batch(imgs, INPUT_SIZE)
            t2 = time.perf_counter()
            d = det.infer(torch.from_numpy(batch).to(dev))
            boxes, scores, classes, valid = (t.cpu().numpy() for t in d)
            t3 = time.perf_counter()
            for i in range(8):
                v = valid[i]
                service._to_json({"boxes": scale_coords(boxes[i][v], metas[i]["scale"],
                                                        metas[i]["pad"], metas[i]["orig_hw"]),
                                  "scores": scores[i][v], "classes": classes[i][v]})
            t4 = time.perf_counter()
            for key, v in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                split[key].append(1e3 * v)
        split_ms = {k: float(np.median(v[1:])) for k, v in split.items()}
        u8 = torch.from_numpy(batch).to(dev)
        split_ms["device_program_alone"] = cuda_ms(lambda: det.infer(u8), reps=10)

        # the kernel against its plain version on this path's inputs
        pred = det.predecode(u8).float()
        _, nb, ns, _ = multilabel_candidates(pred, det.conf_thres, class_offset=det.class_offset)
        nb, ns = nb.contiguous(), ns.contiguous()
        keep = suppression_mask_cuda(nb, ns, det.iou_thres)
        want = suppression_mask_plain(nb, ns, det.iou_thres)
        kernel_mismatches = int((keep != want).sum())
        check(kernel_mismatches == 0, f"nms kernel vs plain on the serving inputs: {kernel_mismatches}")
        bound_ms, bound_by, work = nms_bound(nb, ns, keep)
        prof = device_profile(lambda: suppression_mask_cuda(nb, ns, det.iou_thres), 20)
        kernel = {
            "shape": list(ns.shape), "iou_thres": det.iou_thres,
            "valid": int((ns > float("-inf")).sum()), "kept": int(keep.sum()),
            "ms": cuda_ms(lambda: suppression_mask_cuda(nb, ns, det.iou_thres), reps=200, warmup=10),
            "graph_ms": graph_ms(lambda: suppression_mask_cuda(nb, ns, det.iou_thres), reps=200),
            "device_ms": prof["device_ms"],
            "plain_ms": cuda_ms(lambda: suppression_mask_plain(nb, ns, det.iou_thres), reps=3,
                                warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "mismatches": kernel_mismatches, **work}
        nms_ms = cuda_ms(lambda: det.nms(pred), reps=10)
        cand_ms = cuda_ms(lambda: multilabel_candidates(pred, det.conf_thres,
                                                        class_offset=det.class_offset), reps=10)

        # /predict_stream: STREAM_IMAGES images, equal to predict_many per batch
        stream_payloads = [jpegs[i % len(jpegs)] for i in range(STREAM_IMAGES)]
        body = "\n".join(json.dumps({"image": base64.b64encode(b).decode()})
                         for b in stream_payloads).encode()
        (status, out), stream_s = counted("serve_stream", lambda: _http(
            port, "POST", "/predict_stream", body))
        lines = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
        want_lines = [r for i in range(0, STREAM_IMAGES, det.batch_size)
                      for r in predict_many(stream_payloads[i:i + det.batch_size])]
        check(status == 200 and lines == want_lines,
              f"/predict_stream: {status}, {len(lines)} lines")

        status, health = _http(port, "GET", "/healthz")
        health = json.loads(health)
        check(status == 200 and health == {"status": "ok", "warmed_buckets": [1, 2, 4, 8],
                                           "queue_depth": 0}, f"/healthz {health}")

        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.putrequest("POST", "/predict")
        c.putheader("Content-Length", str(64 << 20))  # announced, never sent
        c.endheaders()
        r = c.getresponse()
        too_big = (r.status, json.loads(r.read()))
        c.close()
        check(too_big[0] == 413, f"a 64 MiB body: {too_big}")

        # the drain: requests queue behind a busy device, shutdown answers each
        drain: list = []

        def post(k):
            status, body = _http(port, "POST", "/predict", jpegs[k % len(jpegs)])
            with lock:
                drain.append(status)

        def drain_run():
            threads = [threading.Thread(target=post, args=(k,)) for k in range(24)]
            for th in threads:
                th.start()
            deadline = time.monotonic() + 5
            while server.batcher.queue_depth() == 0 and time.monotonic() < deadline:
                time.sleep(0.0005)
            depth = server.batcher.queue_depth()
            drained = server.batcher.shutdown()
            for th in threads:
                th.join(120)
            return depth, drained

        (depth, drained), _ = counted("serve_drain", drain_run)
        late = _http(port, "POST", "/predict", jpegs[0])[0]
        after = json.loads(_http(port, "GET", "/healthz")[1])
        check(drained and depth > 0 and len(drain) == 24 and set(drain) <= {200, 503}
              and drain.count(200) >= depth and late == 503 and after["status"] == "draining",
              f"drain: depth {depth}, drained {drained}, answers {drain}, late {late}")
    finally:
        server.batcher.shutdown()
        server.shutdown()
        server.server_close()
    check(all(v > 0 for v in launches.values()), f"serving paths without nms launches: {launches}")
    emit("serve", card=smi, model="YOLOv3-416 full width, 80 classes, bf16, random weights "
         "(seed 0) with BN statistics from the full-size corpus images",
         preset={"multi_label": True, "conf_thres": det.conf_thres, "iou_thres": det.iou_thres,
                 "batch": det.batch_size, "buckets": list(det.batch_buckets),
                 "max_det": det.max_det},
         warmup_s=warmup_s, images=[list(decode_image(b).shape) for b in jpegs],
         sequential={"latency_ms": [1e3 * v for v in seq_lat], "detections": n_det},
         concurrent={"clients": SERVE_THREADS, "requests": n_req, "seconds": conc_s,
                     "req_s": n_req / conc_s, "p50_ms": float(np.percentile(lat, 50)),
                     "p90_ms": float(np.percentile(lat, 90)),
                     "p99_ms": float(np.percentile(lat, 99)), "batches_formed": formed,
                     "answers_by_image_bucket": {f"{k}@{b}": n for (k, b), n in
                                                 sorted(answered.items())},
                     "distinct_answers_by_bucket": sorted({b for _, b in same_as.values()})},
         batch8_split_ms=split_ms, nms_multilabel_ms={"total": nms_ms, "candidates": cand_ms},
         stream={"images": STREAM_IMAGES, "seconds": stream_s, "lines": len(lines)},
         healthz=health, healthz_after_drain=after,
         body_cap=too_big, drain={"queued_at_shutdown": depth, "answers": drain, "late": late},
         kernel=kernel, launches=launches)
    return {"launches": launches, "kernel": kernel, "mismatches": kernel_mismatches}


def cli_serve(ckpt: str, log_path: str) -> dict:
    """``python -m fastvision_tpu_torch serve --ckpt ...`` as its own
    process on a free port, its output in ``log_path``: it must answer
    /healthz (every bucket warmed) and a POSTed JPEG, then drain on SIGTERM
    and exit with 0."""
    port = free_port()
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "fastvision_tpu_torch", "serve", "--ckpt", ckpt,
             "--host", "127.0.0.1", "--port", str(port), f"data.input_size={INPUT_SIZE}"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 180
        while True:
            if proc.poll() is not None:
                with open(log_path) as f:
                    raise SmokeFailure(f"serve exited early ({proc.returncode}):\n"
                                       f"{f.read()[-3000:]}")
            try:
                status, health = _http(port, "GET", "/healthz", timeout=5)
                break
            except OSError:
                if time.monotonic() > deadline:
                    with open(log_path) as f:
                        raise SmokeFailure(f"serve never answered /healthz:\n"
                                           f"{f.read()[-3000:]}") from None
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        health = json.loads(health)
        t1 = time.perf_counter()
        status_post, body = _http(port, "POST", "/predict", full_size_jpegs()[0])
        post_s = time.perf_counter() - t1
        answer = json.loads(body)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        out = f.read()
    check(status == 200 and health["warmed_buckets"] == [1, 2, 4, 8], f"serve /healthz {health}")
    check(status_post == 200 and "detection_scores" in answer, f"serve /predict {answer}")
    check(proc.returncode == 0 and "drained" in out,
          f"serve after SIGTERM: exit {proc.returncode}\n{out[-3000:]}")
    return {"up_s": up_s, "post_s": post_s, "exit": proc.returncode,
            "detections": len(answer["detection_scores"]), "seconds": time.perf_counter() - t0,
            "log": out.strip().splitlines()[-4:]}


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

    serve = cli_serve(ckpt, os.path.join(workdir, "serve.log"))
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
                     "clip_per_sec": vid_res["clip_per_sec"]},
         serve=serve)
    return {"launches": {tag: r["launches"] for tag, r in runs.items()}, "zero": zero_tags}


# the i420 phase: bench.py's jpeg -> boxes path (fused decode, packed I420,
# device colour decode), the device letterbox, TTA and reference_demo
I420_BATCH = 32
I420_SHAPES = [(480, 640)] * 256 + [(720, 1280)] * 16 + [(1080, 1920)] * 8 + [(480, 640)] * 4
I420_ORIENTATIONS = [1] * 280 + [6] * 4
I420_EVAL_IMAGES = 64
I420_WORKERS = 4
LETTERBOX_BATCH, CANVAS_HW = 8, (640, 640)


def check_native_oracles() -> dict:
    """The fused JPEG -> I420 decode and the reduced RGB decode on this host
    against the JAX package's and cv2's outputs stored with the corpus
    (sha256 of the bytes; scale, pads and dims exactly)."""
    with open(os.path.join(FIXTURES, "native_oracles.json")) as f:
        oracles = json.load(f)
    data = {e["file"]: e["data"] for e in codec_fixtures()[0]}
    fused = reduced = 0
    for e in oracles["fused_i420"]:
        packed, scale, pads, orig, dec = decode_jpeg_i420(
            data[e["file"]], e["size"], oracles["i420_pad_value"], e["reduce_target"])
        got = [hashlib.sha256(packed.tobytes()).hexdigest(), float(np.float32(scale)), list(pads),
               list(orig), list(dec)]
        check(got == [e["sha256"], e["scale"], e["pads"], e["orig_hw"], e["decoded_hw"]],
              f"fused decode differs from the stored oracle: {e}, got {got}")
        fused += 1
    refused = 0
    for e in oracles["fused_i420_raises"]:  # lossless: the JAX package's decode refuses it too
        try:
            decode_jpeg_i420(data[e["file"]], e["size"], oracles["i420_pad_value"],
                             e["reduce_target"])
        except ValueError:
            refused += 1
            continue
        raise SmokeFailure(f"the fused decode took {e}; it must raise as the JAX package's does")
    for e in oracles["cv2_reduced"]:
        rgb = decode_jpeg_reduced(data[e["file"]], e["factor"])
        check([list(rgb.shape), hashlib.sha256(rgb.tobytes()).hexdigest()]
              == [e["shape"], e["sha256"]], f"reduced decode differs from cv2's: {e}")
        reduced += 1
    factors = sorted({next(f for f in (1, 2, 4, 8)
                           if -(-max(e["orig_hw"]) // f) == max(e["decoded_hw"]))
                      for e in oracles["fused_i420"]})
    return {"fused_i420_cases": fused, "fused_i420_refused": refused,
            "reduced_rgb_cases": reduced, "factors": factors, "differing": 0}


def kernel_vs_plain_on(pred: torch.Tensor, conf: float, iou: float, class_offset: float,
                       **kw) -> dict:
    """The NMS kernel against its plain version on one path's candidates."""
    _, bx, sc, _ = nms_candidates(pred, conf_thres=conf, class_offset=class_offset, **kw)
    bx, sc = bx.contiguous(), sc.contiguous()
    keep = suppression_mask_cuda(bx, sc, iou)
    want = suppression_mask_plain(bx, sc, iou)
    return {"shape": list(sc.shape), "valid": int((sc > float("-inf")).sum()),
            "kept": int(want.sum()), "mismatches": int((keep != want).sum())}


def counted_launches(fn):
    """-> (fn(), seconds, NMS kernel launches), the count reset just before."""
    suppression_mask_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, suppression_mask_cuda.launches


def same_detections(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        ra["id"] == rb["id"] and all(np.array_equal(ra[k], rb[k])
                                     for k in ("boxes", "scores", "classes"))
        and np.array_equal(ga, gb) for (ra, ga), (rb, gb) in zip(a, b))


def phase_i420(dev: torch.device, smi: str, workdir: str) -> dict:
    """bench.py's jpeg -> boxes Detector (YOLOv3-416 full width, bf16,
    input_format='i420', batch 32, fast_decode) over JPEG files: the fused
    decode against the stored oracles; predict_dataset with 0 and 4 process
    workers (the same detections, GT byte-equal, 0 fallbacks), the kernel's
    launches counted; float32 card vs CPU of the i420 program; the device
    letterbox card vs CPU and vs the host's; evaluate with TTA and under
    reference_demo on 64 images; the kernel bit-equal on each path's inputs;
    then the times."""
    t_phase = time.perf_counter()
    oracles = check_native_oracles()
    root = os.path.join(workdir, "i420")
    t0 = time.perf_counter()
    write_jpeg_detection_dataset(root, I420_SHAPES, seed=SEED + 9, num_classes=NUM_CLASSES,
                                 orientations=I420_ORIENTATIONS, workers=os.cpu_count() or 1)
    data_s = time.perf_counter() - t0
    ds = DetectionDataset(root, "val")
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    model = yolo_model()
    first = [ds[i][0] for i in range(8)]
    calibrate_bn_(model.to(dev), normalize_images(
        torch.from_numpy(preprocess_batch(first, INPUT_SIZE)[0]), torch.float32).to(dev))
    det = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=I420_BATCH,
                   input_format="i420", device=dev)
    det_rgb = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=I420_BATCH, device=dev)
    head = _Subset(ds, I420_BATCH)
    for d in (det, det_rgb):  # warm-up: cuDNN's choices, the decode library
        list(d.predict_dataset(head, fast_decode=True))

    # --- the main path, counted: predict_dataset on 0 and 4 workers
    runs = {}
    for tag, d, workers in (("i420_predict_dataset_w0", det, 0),
                            ("i420_predict_dataset_w4", det, I420_WORKERS),
                            ("rgb_predict_dataset_w4", det_rgb, I420_WORKERS)):
        d.i420_fallbacks = 0
        out, s, launches = counted_launches(lambda d=d, w=workers: list(
            d.predict_dataset(ds, fast_decode=True, num_workers=w)))
        runs[tag] = {"results": out, "seconds": s, "img_s": len(ds) / s, "launches": launches,
                     "fallbacks": d.i420_fallbacks}
    w0, w4 = runs["i420_predict_dataset_w0"], runs["i420_predict_dataset_w4"]
    check(same_detections(w0["results"], w4["results"]),
          "predict_dataset with 4 workers differs from 0 workers on the i420 path")
    check(w0["fallbacks"] == w4["fallbacks"] == 0, f"fused-decode fallbacks: {w0['fallbacks']}")
    check(all(r["launches"] > 0 for r in runs.values()),
          f"a predict_dataset run never launched the kernel: "
          f"{ {k: r['launches'] for k, r in runs.items()} }")
    n_boxes = [len(r["boxes"]) for r, _ in w0["results"]]
    check(sum(n_boxes) > 0, "no detections on the i420 path")
    check(all(np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()
              for r, _ in w0["results"]), "non-finite detections")
    turned = [i for i, o in enumerate(I420_ORIENTATIONS) if o >= 5]
    check(all((w0["results"][i][0]["boxes"][:, [0, 2]] <= I420_SHAPES[i][0]).all()
              and (w0["results"][i][0]["boxes"][:, [1, 3]] <= I420_SHAPES[i][1]).all()
              for i in turned), "a box of an EXIF-turned image lies outside its turned frame")
    rgb_vs_i420 = {"images": len(ds), "i420_boxes": sum(n_boxes),
                   "rgb_boxes": sum(len(r["boxes"]) for r, _ in runs["rgb_predict_dataset_w4"]
                                    ["results"])}

    # --- float32, TF32 off: the i420 program on the card vs the CPU, pre-NMS
    batch = next(det._loader(ds, 1).epoch(0))
    packed = torch.from_numpy(batch["images"][:2])
    d32 = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=2, input_format="i420",
                   dtype=torch.float32, device=dev)
    cpu32 = Detector(copy.deepcopy(model).cpu(), anchors, input_size=INPUT_SIZE, batch_size=2,
                     input_format="i420", dtype=torch.float32, device="cpu")
    # the raw heads (pre-decode, pre-NMS), each to its own std, as e2e holds
    # them; the decoded fields are reported: wh = (2 sigmoid)^2 anchor of a
    # random-weight model amplifies the float32 rounding (e2e reports the
    # same for its RGB images) while the heads agree
    with no_tf32(), torch.inference_mode():
        h_card = [h.float().cpu() for h in d32.model(normalize_images(packed.to(dev),
                                                                      torch.float32))]
        p_card = d32.predecode(packed.to(dev)).float().cpu()
        h_cpu = cpu32.model(normalize_images(packed, torch.float32))
    p_cpu = cpu32.predecode(packed).float()
    head_rel = [float((a - b).abs().max() / b.std()) for a, b in zip(h_card, h_cpu)]
    decoded_rel = {k: float((p_card[..., sl] - p_cpu[..., sl]).abs().max() / p_cpu[..., sl].std())
                   for k, sl in (("xy", slice(0, 2)), ("wh", slice(2, 4)), ("obj", slice(4, 5)),
                                 ("cls", slice(5, None)))}
    check(max(head_rel) <= 1e-3, f"i420 program fp32 card vs cpu: heads max|d|/std {head_rel}")
    del cpu32, h_card, h_cpu, p_card, p_cpu

    # --- the device letterbox: card vs CPU, and vs the host letterbox
    # two images of each kind: 640 x 480, 720p, 1080p (reduced), EXIF-turned
    kinds = [[i for i, (hw, o) in enumerate(zip(I420_SHAPES, I420_ORIENTATIONS))
              if (hw, o >= 5) == (shape, turn)][:2]
             for shape, turn in dict.fromkeys(zip(I420_SHAPES, [o >= 5 for o in
                                                               I420_ORIENTATIONS]))]
    lb_picks = [i for k in kinds for i in k][:LETTERBOX_BATCH]
    arrs = [imread_rgb_scaled(ds.image_path(i), INPUT_SIZE)[0] for i in lb_picks]
    canvas, sizes = (torch.from_numpy(a) for a in pack_canvas(arrs, *CANVAS_HW))
    c_dev, s_dev = canvas.to(dev), sizes.to(dev)
    lb_card = letterbox_batch(c_dev, s_dev, INPUT_SIZE)
    lb_cpu = letterbox_batch(canvas, sizes, INPUT_SIZE)
    lb_card_vs_cpu = float((lb_card[0].cpu() - lb_cpu[0]).abs().max())
    check(lb_card_vs_cpu <= 1e-3 and all(torch.equal(a.cpu(), b)
                                         for a, b in zip(lb_card[1:], lb_cpu[1:])),
          f"device letterbox card vs cpu: {lb_card_vs_cpu}")
    host = np.stack([letterbox(a, INPUT_SIZE)[0] for a in arrs])
    lb_vs_host = float((lb_card[0].cpu() - torch.from_numpy(host).float()).abs().max())
    check(lb_vs_host <= 1.0 + 1e-3, f"device letterbox vs the host's: max|d| {lb_vs_host}")
    det_lb = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=LETTERBOX_BATCH,
                      device_letterbox=True, canvas_hw=CANVAS_HW, device=dev)
    lb_paths = [ds.image_path(i) for i in lb_picks]
    det_lb.predict_batch(lb_paths)
    lb_res, _, lb_launches = counted_launches(lambda: det_lb.predict_batch(lb_paths))
    check(lb_launches > 0 and sum(len(r["boxes"]) for r in lb_res) > 0,
          "device_letterbox predict_batch found nothing or never launched the kernel")

    # --- evaluate with TTA and under reference_demo (pad 0), 64 images (the
    # 24 large ones first, so that the demo's first batch holds boxes in
    # original pixels up to 1920) labelled with the i420 detector's own
    # jittered detections
    ev_root = os.path.join(workdir, "i420_eval")
    rng = np.random.default_rng(SEED)
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(ev_root, "val", sub), exist_ok=True)
    large = [i for i, (hw, o) in enumerate(zip(I420_SHAPES, I420_ORIENTATIONS))
             if max(hw) > 640 and o == 1]
    picks = large + [i for i in range(len(I420_SHAPES)) if i not in large][
        : I420_EVAL_IMAGES - len(large)]
    for k, i in enumerate(picks):
        r = w0["results"][i][0]
        shutil.copy(ds.image_path(i), os.path.join(ev_root, "val", "images", f"{k:05d}.jpg"))
        b = r["boxes"][:4]
        wh = np.concatenate([b[:, 2:] - b[:, :2]] * 2, 1)
        b = b + rng.normal(0, 0.1, b.shape) * wh
        with open(os.path.join(ev_root, "val", "labels", f"{k:05d}.txt"), "w") as f:
            f.writelines(f"{int(c)} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f}\n"
                         for c, (x1, y1, x2, y2) in zip(r["classes"][:4], b))
    ev_ds = DetectionDataset(ev_root, "val")
    det_demo = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=I420_BATCH,
                        postprocess_mode="reference_demo", pad_value=0, device=dev)
    det.evaluate(_Subset(ev_ds, I420_BATCH), tta=True)  # warm-up of the [2B] program
    det_demo.evaluate(_Subset(ev_ds, I420_BATCH))
    tta, tta_s, tta_l = counted_launches(lambda: det.evaluate(ev_ds, tta=True))
    plain, plain_s, plain_l = counted_launches(lambda: det.evaluate(ev_ds))
    demo, demo_s, demo_l = counted_launches(lambda: det_demo.evaluate(ev_ds))
    check(min(tta_l, demo_l) > 0 and tta["map50"] > 0 and demo["map50"] > 0,
          f"evaluate tta {tta} ({tta_l} launches), demo {demo} ({demo_l})")

    # --- the kernel bit-equal on each path's own inputs
    packed_dev = torch.from_numpy(batch["images"]).to(dev)
    pred = det.predecode(packed_dev).float()
    pred_tta = det.predecode_tta(packed_dev).float()
    demo_batch = next(det_demo._loader(ev_ds, 1).epoch(0))
    metas = demo_batch["meta"]
    ratios, pads, ori_wh = det_demo._demo_inputs(metas, I420_BATCH)
    pred_demo = reference_demo_unscale(
        det_demo.predecode(torch.from_numpy(demo_batch["images"]).to(dev)).float(), ratios,
        pads[:, 0], pads[:, 1], ori_wh[:, 0], ori_wh[:, 1], min_wh=det_demo.min_box_px)
    vs_plain = {
        "i420_batch32": kernel_vs_plain_on(pred, det.conf_thres, det.iou_thres, det.class_offset),
        "tta_batch64": kernel_vs_plain_on(pred_tta, det.conf_thres, det.iou_thres,
                                       det.class_offset),
        "reference_demo_batch32": kernel_vs_plain_on(pred_demo, det.conf_thres, det.iou_thres,
                                                  det.class_offset, box_format="xyxy",
                                                  score_mode="obj"),
    }
    mismatches = sum(r["mismatches"] for r in vs_plain.values())
    check(mismatches == 0 and all(r["valid"] for r in vs_plain.values()),
          f"nms kernel vs plain on the i420 phase's inputs: {vs_plain}")
    demo_max_px = float(pred_demo[..., :4].max())
    check(demo_max_px > 3 * INPUT_SIZE,
          f"the reference_demo inputs reach {demo_max_px} px, not original 1920-px pixels")

    # --- times (each with the card's name and power limit in `card`)
    datas = []
    for i in range(min(64, len(ds))):  # 640 x 480 files
        with open(ds.image_path(i), "rb") as f:
            datas.append(f.read())

    def fused(data):
        return decode_jpeg_i420(data, INPUT_SIZE, 114, reduce_target=INPUT_SIZE)

    def plain_chain(data):
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out = letterbox(decode_image(data), INPUT_SIZE)[0]
            return rgb_batch_to_i420_packed(out[None])
        finally:
            torch.set_num_threads(n)

    from concurrent.futures import ThreadPoolExecutor

    decode_times = {}
    for name, fn in (("fused_jpeg_to_i420", fused), ("decode_letterbox_rgb_to_i420", plain_chain)):
        fn(datas[0])
        t0 = time.perf_counter()
        for data in datas:
            fn(data)
        one = len(datas) / (time.perf_counter() - t0)
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(fn, datas[:8]))
            t0 = time.perf_counter()
            list(pool.map(fn, datas * 2))
            four = 2 * len(datas) / (time.perf_counter() - t0)
        decode_times[name] = {"img_s_1_thread": one, "img_s_4_threads": four}
    u8 = torch.from_numpy(np.stack([letterbox(a, INPUT_SIZE)[0] for a in first] * 4))
    h2d = {}
    for tag, host_batch in (("i420_batch32", torch.from_numpy(batch["images"])),
                            ("rgb_batch32", u8)):
        pinned = host_batch.pin_memory()
        ms = cuda_ms(lambda p=pinned: p.to(dev, non_blocking=True), reps=20)
        h2d[tag] = {"bytes": pinned.numel(), "bytes_per_image": pinned.numel() // I420_BATCH,
                    "ms": ms, "mb_s": pinned.numel() / 1e3 / ms}
    u8_dev = u8.to(dev)
    program_ms = {"i420": cuda_ms(lambda: det.infer(packed_dev), reps=10),
                  "rgb": cuda_ms(lambda: det_rgb.infer(u8_dev), reps=10),
                  "i420_to_rgb_decode": cuda_ms(
                      lambda: i420_packed_to_rgb(packed_dev, det.dtype), reps=20)}
    letterbox_ms = {
        "device_batch8_canvas640": cuda_ms(lambda: letterbox_batch(c_dev, s_dev, INPUT_SIZE,
                                                                   dtype=det.dtype), reps=20),
        "host_batch8": 1e3 * host_s(lambda: [letterbox(a, INPUT_SIZE) for a in arrs], reps=5)}
    emit("i420", card=smi, model="YOLOv3 Darknet-53, 80 classes, full width, bf16, random "
         "weights (seed 0), BN from 8 of the phase's images", input_size=INPUT_SIZE,
         batch=I420_BATCH, data={"jpegs": len(ds), "shapes": "256 x 480x640, 16 x 720x1280, "
                                 "8 x 1080x1920, 4 x 480x640 with EXIF orientation 6",
                                 "recipe": "7x7-blurred seeded noise, baseline 4:2:0 q90",
                                 "encode_s": data_s},
         native_oracles=oracles,
         predict_dataset={k: {f: r[f] for f in ("seconds", "img_s", "launches", "fallbacks")}
                          for k, r in runs.items()},
         w0_equals_w4=True, boxes=rgb_vs_i420,
         fp32_card_vs_cpu={"head_max_abs_over_std": head_rel, "head_tolerance": 1e-3,
                           "decoded_max_abs_over_field_std": decoded_rel},
         device_letterbox={"card_vs_cpu_max_abs": lb_card_vs_cpu, "vs_host_max_abs": lb_vs_host,
                           "predict_batch_launches": lb_launches, "ms": letterbox_ms},
         evaluate={"tta": {**tta, "seconds": tta_s, "launches": tta_l},
                   "plain_i420": {**plain, "seconds": plain_s, "launches": plain_l},
                   "reference_demo_pad0": {**demo, "seconds": demo_s, "launches": demo_l}},
         kernel_vs_plain=vs_plain, reference_demo_max_coordinate_px=demo_max_px,
         decode=decode_times, h2d=h2d, device_program_ms=program_ms,
         phase_seconds=time.perf_counter() - t_phase)
    return {"launches": {k: r["launches"] for k, r in runs.items()}
            | {"i420_device_letterbox": lb_launches, "i420_evaluate_tta": tta_l,
               "i420_evaluate": plain_l, "i420_evaluate_reference_demo": demo_l},
            "mismatches": mismatches}


# ---------------------------------------------------------------------------
# int8 w8a8 post-training quantization (Detector.quantize, eval / serve --int8)
# ---------------------------------------------------------------------------
INT8_CALIB = 8  # the CLI's calibration images
INT8_BATCHES = (32, 256)  # bench.py's int8 lane runs batch 256
# float32 card vs CPU, int8 model. Each quantized conv on the card's own
# input: the CPU's output within 1e-6 of the output's max (silu's exp
# differs by an ulp between the card and the CPU; the int32 sums and the
# rest of the epilogue are exact). The whole model: such an ulp flips an
# activation's int8 rounding now and then, the flip is one int8 step and
# random weights amplify it down 72 layers, so the heads are held by
# their correlation (>= 0.98) and their max|d|/std reported.
INT8_LAYER_TOL = 1e-6
# the epilogue kernel against its plain version on the card: silu's expf
# may round its last bit apart from PyTorch's build, which can move the
# bfloat16 result by one ulp; everything else rounds identically
INT8_EPILOGUE_ULPS = 1.0
INT8_HEADS_MIN_CORR = 0.98
INT8_SMALL_TOL = 1e-2  # the small ResNeXt (ReLU, 17 convs): max|d|/std of its logits
INT8_CLI_IMAGES = 16
PEAK_INT8_OPS = 1979e12  # dense int8 tensor cores (H100 SXM data sheet, at 700 W)
# YOLOv3's int8 convs whose input no producer's epilogue writes: the first
# downsample conv (after the RGB stem, which runs off the implicit GEMM), the
# first conv of the P4 and P3 blocks (a concat's input) and the two laterals
INT8_QUANTIZE_PASSES = 5


def differing_bytes(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of two same-shaped tensors whose bytes differ."""
    as_int = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return int((a.view(as_int) != b.view(as_int)).sum())


def fused_vs_composed(xk: torch.Tensor, mat: torch.Tensor, n: int, k: int, stride: int,
                      scale: torch.Tensor, bias: torch.Tensor, act: str, residual,
                      out_scale: torch.Tensor) -> dict:
    """``int8_conv`` with the residual add and its consumer's quantize fused
    into the epilogue, against the composed route on the same card: the
    kernel in mode (a), PyTorch's add, `quantize_activation_cuda` at
    ``out_scale``; ``residual(dtype, y)`` gives the residual, [M, n]
    contiguous. -> {"bf16" | "f32": {fused mode: bytes that differ, the
    float and the int8 output summed}}."""
    def quantized(t):
        return quantize_activation_cuda(t.view(1, t.shape[0], 1, n), out_scale).view(t.shape)

    out = {}
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        y, _ = int8_conv_cuda(xk, mat, n, k, stride, scale, bias, act, dt)
        res = residual(dt, y)
        total = res + y
        q_y, q_s = quantized(y), quantized(total)
        row = {}
        for mode, r, keep in (("int8_only", None, False), ("dual", None, True),
                              ("int8_only_residual", res, False), ("dual_residual", res, True)):
            got, q = int8_conv_cuda(xk, mat, n, k, stride, scale, bias, act, dt, r, out_scale, keep)
            want = y if r is None else total
            row[mode] = differing_bytes(q, q_y if r is None else q_s) + (
                differing_bytes(got, want) if keep else int(got is not None))
        out[tag] = row
    return out


def sum_fused(rows: list) -> dict:
    return {tag: {mode: sum(r[tag][mode] for r in rows) for mode in rows[0][tag]}
            for tag in rows[0]} if rows else {}


def held_accumulators(model: torch.nn.Module, x: torch.Tensor, dtype: torch.dtype) -> dict:
    """One forward of ``model`` on ``x`` (under ``dtype`` autocast), with its
    int8 links off so that each quantized conv sees its float input (and its
    residual), with, on each: the int32 accumulators of the card route
    (`int8_conv2d`: the implicit GEMM in mode (b) where it takes the shape,
    else the patches kernel and ``_int_mm``) against the plain version
    (float64 conv); the patches kernel on the float input against
    `quantize_patches_plain` (bytes); the epilogue kernel against
    `epilogue_plain` on that conv's accumulators (max |d|, elements that
    differ, the worst in output-dtype ulps of the value). On each conv that
    `implicit_gemm_eligible` takes: the quantize pass against
    `quantize_activation` (bytes), ``int8_conv`` in mode (b) against the
    plain accumulators and in mode (a), in bfloat16 and float32, against
    the GEMM route (patches kernel, ``_int_mm``, epilogue kernel) byte for
    byte; and its fused epilogue (`fused_vs_composed`) at the input scale
    of the conv its link feeds (its own where it has none), with the
    residual the model adds there (the mode (a) output shifted by a row
    where it adds none). The links are put back after."""
    held, implicit, fused = [], [], []
    links = {m: m.link for m in model.modules() if isinstance(m, Int8Conv) and m.link}

    def hold(mod, args):
        inp, act = args[:2]
        model_res = args[2] if len(args) > 2 else None
        n, k = mod.w_q.shape[0], mod.w_q.shape[-1]
        with torch.autocast("cuda", enabled=False):
            xq = quantize_activation(inp, mod.in_scale)
            card = int8_conv2d(xq, mod.w_q, mod.stride, mod.padding, mod.groups, mod.w_mat)
            plain = int8_conv2d_plain(xq, mod.w_q, mod.stride, mod.padding, mod.groups)
            nhwc = inp.permute(0, 2, 3, 1).contiguous()
            a = quantize_patches_cuda(nhwc, mod.in_scale, k, mod.stride, mod.padding,
                                      mod.w_mat.shape[1])
            a_plain = quantize_patches_plain(nhwc, mod.in_scale, k, mod.stride, mod.padding,
                                             mod.w_mat.shape[1])
            acc = int8_gemm(a, mod.w_mat)
            y = epilogue_cuda(acc, n, mod.scale, mod.bias, act, dtype).float()
            y_plain = epilogue_plain(acc, n, mod.scale, mod.bias, act, dtype).float()
            d = (y - y_plain).abs()
            ulp = torch.finfo(dtype).eps * y_plain.abs().clamp_min(torch.finfo(dtype).tiny)
            held.append((int((card != plain).sum()), int(card.abs().max()),
                         int((a != a_plain).sum()), float(d.max()), int((d > 0).sum()),
                         float((d / ulp).max())))
            if implicit_gemm_eligible(nhwc.shape[3], n, k, mod.stride, mod.padding, mod.groups):
                xk = quantize_activation_cuda(nhwc, mod.in_scale)
                mode_b, _ = int8_conv_cuda(xk, mod.w_mat, n, k, mod.stride)
                row = [differing_bytes(xk, quantize_activation(nhwc, mod.in_scale)),
                       int((mode_b != plain.permute(0, 2, 3, 1).reshape(-1, n)).sum())]
                for dt in (torch.bfloat16, torch.float32):
                    new, _ = int8_conv_cuda(xk, mod.w_mat, n, k, mod.stride, mod.scale, mod.bias,
                                            act, dt)
                    old = epilogue_cuda(acc, n, mod.scale, mod.bias, act, dt)
                    row += [differing_bytes(new, old),
                            float((new.float() - old.float()).abs().max())]
                implicit.append(row)

                def residual(dt, y_dt):
                    if model_res is None:
                        return y_dt.roll(1, 0).contiguous()
                    return model_res.permute(0, 2, 3, 1).reshape(-1, n).to(dt).contiguous()

                to = links.get(mod)
                fused.append(fused_vs_composed(
                    xk, mod.w_mat, n, k, mod.stride, mod.scale, mod.bias, act, residual,
                    mod.in_scale if to is None else to[0].in_scale))

    hooks = [m.register_forward_pre_hook(hold) for m in model.modules()
             if isinstance(m, Int8Conv)]
    link_int8(model, enabled=False)
    try:
        with torch.inference_mode(), torch.autocast("cuda", dtype=dtype,
                                                    enabled=dtype != torch.float32):
            model(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
        link_int8(model)
    return {"convs": len(held), "mismatches": sum(h[0] for h in held),
            "max_abs_accumulator": max(h[1] for h in held),
            "patches_kernel_mismatching_bytes": sum(h[2] for h in held),
            "epilogue_kernel_max_abs_err": max(h[3] for h in held),
            "epilogue_kernel_differing": sum(h[4] for h in held),
            "epilogue_kernel_max_ulps": max(h[5] for h in held),
            "implicit_gemm_convs": len(implicit),
            "quantize_pass_mismatching_bytes": sum(r[0] for r in implicit),
            "int8_conv_mode_b_mismatches": sum(r[1] for r in implicit),
            "int8_conv_mode_a_differing": {"bf16": sum(r[2] for r in implicit),
                                           "f32": sum(r[4] for r in implicit)},
            "int8_conv_mode_a_max_abs_err": max([r[3] for r in implicit]
                                                + [r[5] for r in implicit] + [0.0]),
            "fused_epilogue_convs": len(fused),
            "fused_epilogue_differing": sum_fused(fused)}


def fused_clean(differing: dict) -> bool:
    return bool(differing) and all(v == 0 for row in differing.values() for v in row.values())


def int8_conv_edge_cases(dev: torch.device) -> dict:
    """`testing.INT8_IMPLICIT_CASES` on the card: ``int8_conv`` in mode (b)
    against `int8_conv_plain`, in mode (a), in every activation and both
    output types, against the GEMM route on the same int8 input (patches
    kernel, ``_int_mm``, epilogue kernel), and its fused epilogue in every
    activation against the composed route (`fused_vs_composed`, a seeded
    residual), byte for byte; the quantize pass against `quantize_activation`
    on `testing.quantize_tie_cases` (values at and around half-integer
    multiples of the scale, where only the IEEE division's rounding gives
    the plain version's integer)."""
    out = {"cases": [], "mode_b_mismatches": 0, "mode_a_differing": 0, "fused_differing": 0}
    for case in INT8_IMPLICIT_CASES:
        name, _, _, _, _, n, k, stride, _ = case
        x, w = (torch.from_numpy(a) for a in int8_conv_case(case))
        xq = x.permute(0, 2, 3, 1).contiguous().to(dev)
        mat = gemm_weight(w).to(dev)
        acc, _ = int8_conv_cuda(xq, mat, n, k, stride)
        bad_b = int((acc != int8_conv_plain(xq, mat, n, k, stride)[0]).sum())
        g = torch.Generator().manual_seed(n)
        scale = (torch.rand(n, generator=g) * 2e-5 + 1e-6).to(dev)
        bias = torch.randn(n, generator=g).to(dev)
        y0, _ = int8_conv_cuda(xq, mat, n, k, stride, scale, bias, "none", torch.float32)
        spread = float(y0.std())  # a residual and a consumer's scale of the output's size
        res = (torch.randn(acc.shape, generator=g) * spread).to(dev)
        out_scale = torch.tensor(spread / 40, device=dev)
        acc10 = int8_gemm(quantize_patches_cuda(xq, None, k, stride, k // 2, mat.shape[1]), mat)
        bad_a = sum(differing_bytes(
            int8_conv_cuda(xq, mat, n, k, stride, scale, bias, act, dt)[0],
            epilogue_cuda(acc10, n, scale, bias, act, dt))
            for dt in (torch.bfloat16, torch.float32) for act in ACTIVATIONS)
        fused = sum_fused([fused_vs_composed(xq, mat, n, k, stride, scale, bias, act,
                                             lambda dt, _y: res.to(dt).contiguous(),
                                             out_scale)
                           for act in ACTIVATIONS])
        bad_f = sum(v for row in fused.values() for v in row.values())
        out["cases"].append({"case": name, "M": acc.shape[0], "N": n, "K": mat.shape[1],
                             "max_abs_accumulator": int(acc.abs().max()),
                             "mode_b_mismatches": bad_b, "mode_a_differing": bad_a,
                             "fused_differing": bad_f})
        out["mode_b_mismatches"] += bad_b
        out["mode_a_differing"] += bad_a
        out["fused_differing"] += bad_f
    # the quantize's reciprocal product against the division, at and around
    # the half-integer multiples of 24 scales, float32 and bfloat16 inputs
    values, scales = quantize_tie_cases()
    out["quantize_tie_values"] = values.size
    out["quantize_ties_differing"] = 0
    for row, sc in zip(torch.from_numpy(values), torch.from_numpy(scales)):
        s_dev = sc.to(dev)
        for dt in (torch.float32, torch.bfloat16):
            v = row.to(dev, dt).view(1, 1, -1, 8)
            out["quantize_ties_differing"] += differing_bytes(quantize_activation_cuda(v, s_dev),
                                                              quantize_activation(v, s_dev))
    torch.cuda.synchronize()
    return out


def layerwise_card_vs_cpu(model: torch.nn.Module, cpu_model: torch.nn.Module,
                          x: torch.Tensor) -> dict:
    """float32 (TF32 off): each quantized conv of ``model`` on the input (and
    residual) it gets in a card forward of ``x`` with the links off, against
    the same conv of ``cpu_model`` (the plain route) on that input. -> the
    worst max|d| / max|out|."""
    names = {m: n for n, m in model.named_modules() if isinstance(m, Int8Conv)}
    cpu_mods = dict(cpu_model.named_modules())
    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out: seen.append(
        (names[mod], [a.cpu() if torch.is_tensor(a) else a for a in args], out.cpu())))
        for m in names]
    worst, differing = 0.0, 0
    for m in (model, cpu_model):  # each conv's float input (and residual) and output
        link_int8(m, enabled=False)
    try:
        with no_tf32(), torch.inference_mode():
            model(x)
            for name, args, out in seen:
                ref = cpu_mods[name](*args)
                worst = max(worst, float((out - ref).abs().max() / ref.abs().max()))
                differing += int((out != ref).sum())
    finally:
        for h in hooks:
            h.remove()
        for m in (model, cpu_model):
            link_int8(m)
    return {"convs": len(seen), "max_abs_over_max": worst, "differing_elements": differing,
            "tolerance": INT8_LAYER_TOL}


def heads_vs(a: list, b: list) -> dict:
    """max|a - b| / std(b) per head, and the correlation of all heads."""
    fa = torch.cat([h.float().flatten().cpu() for h in a])
    fb = torch.cat([h.float().flatten().cpu() for h in b])
    return {"max_abs_over_std": [float((x.float().cpu() - y.float().cpu()).abs().max()
                                       / y.float().cpu().std()) for x, y in zip(a, b)],
            "corr": float(torch.corrcoef(torch.stack([fa, fb]))[0, 1])}


def int8_profile(fn, reps: int = 3, top: int = 12) -> dict:
    """torch.profiler over ``reps`` calls of ``fn``: the top device kernels
    (ms per call; ``int8_gemm`` marks those launched under ``aten::_int_mm``),
    the int8 GEMMs' share of device time, per call the ``_int_mm`` and
    float convolution ops, and the launches of the port's int8 kernels by
    name (``int8_conv_kernel``, ``patches8_kernel`` (the quantize pass, and
    the patches of a conv whose C is a multiple of 8), ``patches_line_kernel``
    (an RGB stem's patches), the two epilogue kernels) and their device ms,
    as the profiler's device records give them, and PyTorch's adds a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    gemm = {k.name for e in events if e.name == "aten::_int_mm" for k in e.kernels}
    kernels, counts = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type.name == "CUDA" and not _is_range(ev):
            kernels[ev.key] = us / 1e3 / reps
            counts[ev.key] = ev.count / reps
    total = sum(kernels.values())
    ours = {tag: {"launches": sum(c for k, c in counts.items() if tag in k),
                  "ms": sum(v for k, v in kernels.items() if tag in k)}
            for tag in ("int8_conv_kernel", "patches8_kernel", "patches_line_kernel",
                        "epilogue8_kernel", "::epilogue_kernel")}
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"device_ms": total,
            "top_kernels": [{"name": k[:100], "ms": v, "int8_gemm": k in gemm}
                            for k, v in ranked[:top]],
            "int8_gemm_kernels": sorted(k[:100] for k in gemm),
            "int8_gemm_share": (sum(v for k, v in kernels.items() if k in gemm) / total
                                if total else None),
            "top_kernel_is_int8_gemm": bool(ranked) and ranked[0][0] in gemm,
            "int8_kernels_per_call": ours,
            "int_mm_per_call": sum(e.name == "aten::_int_mm" for e in events) / reps,
            "adds_per_call": sum(e.name in ("aten::add", "aten::add_") for e in events) / reps,
            "convolutions_per_call": sum(e.name == "aten::convolution" for e in events) / reps}


def int8_split(model: torch.nn.Module, x: torch.Tensor, plain: bool) -> dict:
    """The int8 convs of one bf16 forward of ``model`` on ``x``, timed layer
    by layer on each layer's own input inside a forward pre-hook (the links
    off for the forward, so that each layer sees its float input; ms between
    CUDA events, summed over the layers). On the convs that
    `implicit_gemm_eligible` takes, the path's route: ``int8_conv`` in the
    mode the link plan gives the layer (its consumer's int8 output, the
    float output kept or not, Darknet's residual added; ``fused_modes``
    sums them by mode) and the quantize pass on the layers whose input no
    producer writes (``quantize``); beside it, what the links took away
    (``quantize_linked_away``: the pass on the other layers;
    ``int8_conv_unfused``: the kernel's float-only launch, also by mode;
    ``residual_add``: PyTorch's add of the skip) and on the same layers the
    GEMM route's three steps (the patches kernel, ``_int_mm``, the epilogue
    kernel). On the others (YOLOv3's RGB stem) the GEMM route, which the
    path runs there (keys ``other_*``). With ``plain``, each kernel's plain
    version too. Each step's bound: the bytes it must move (inputs read
    once, outputs written once) over HBM's rate against its operations over
    the peak for their type (int8 tensor-core ones, 2 M N K, for
    ``int8_conv`` and ``_int_mm``; float32 ones, 4 an input element
    quantized, 7 an epilogue output, 1 an add, for the others)."""
    steps: dict = {}
    modes: dict = {}
    n_layers = {"implicit": 0, "other": 0}
    links = {m: m.link for m in model.modules() if isinstance(m, Int8Conv) and m.link}
    consumers = {id(link[0]) for link in links.values()}

    def add(key, fn, n_bytes, ops, peak, plain_fn=None) -> dict:
        bytes_ms, ops_ms = 1e3 * n_bytes / PEAK_BYTES_S, 1e3 * ops / peak
        layer = {"ms": cuda_ms(fn, reps=5), "bytes": n_bytes, "ops": ops, "bytes_ms": bytes_ms,
                 "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms)}
        st = steps.setdefault(key, {"layers": 0, **dict.fromkeys(layer, 0.0)})
        st["layers"] += 1
        for f, v in layer.items():
            st[f] += v
        if plain_fn is not None:
            st["plain_ms"] = st.get("plain_ms", 0.0) + cuda_ms(plain_fn, reps=1, warmup=1)
        return layer

    def timed(mod, args):
        inp, act = args[:2]
        res_nchw = args[2] if len(args) > 2 else None
        n, k = mod.w_q.shape[0], mod.w_q.shape[-1]
        sc, stride, pad, k_pad = mod.in_scale, mod.stride, mod.padding, mod.w_mat.shape[1]
        bf = torch.bfloat16
        with torch.autocast("cuda", enabled=False):
            nhwc = inp.permute(0, 2, 3, 1).contiguous()
            elems, in_bytes = nhwc.numel(), nhwc.numel() * nhwc.element_size()
            eligible = implicit_gemm_eligible(nhwc.shape[3], n, k, stride, pad, mod.groups)
            pre = "" if eligible else "other_"
            n_layers["implicit" if eligible else "other"] += 1
            if eligible:
                xk = quantize_activation_cuda(nhwc, sc)
                ho, wo = out_hw(xk.shape[1], xk.shape[2], k, stride, pad)
                m = xk.shape[0] * ho * wo
                add("quantize_linked_away" if id(mod) in consumers else "quantize",
                    lambda: quantize_activation_cuda(nhwc, sc), in_bytes + elems,
                    4 * elems, PEAK_FP32_FLOPS,
                    (lambda: quantize_activation(nhwc, sc)) if plain else None)
                to, keep = links.get(mod, (None, True))
                out_scale = None if to is None else to.in_scale
                res = (None if res_nchw is None
                       else res_nchw.permute(0, 2, 3, 1).reshape(-1, n).contiguous())
                mode = ("float_only" if out_scale is None else "dual" if keep else "int8_only") \
                    + ("" if res is None else "_residual")
                fixed = elems + mod.w_mat.numel() + 8 * n
                out_bytes = (2 * m * n if keep else 0) + (0 if out_scale is None else m * n) \
                    + (0 if res is None else 2 * m * n)
                conv_ops = 2.0 * m * n * k_pad
                fused = (xk, mod.w_mat, n, k, stride, mod.scale, mod.bias, act, bf, res,
                         out_scale, keep)
                layer = add("int8_conv", lambda: int8_conv_cuda(*fused), fixed + out_bytes,
                            conv_ops, PEAK_INT8_OPS,
                            (lambda: int8_conv_plain(*fused)) if plain else None)
                unfused = (xk, mod.w_mat, n, k, stride, mod.scale, mod.bias, act, bf)
                before = add("int8_conv_unfused", lambda: int8_conv_cuda(*unfused),
                             fixed + 2 * m * n, conv_ops, PEAK_INT8_OPS)
                md = modes.setdefault(mode, {"layers": 0, "ms": 0.0, "bound_ms": 0.0,
                                             "unfused_ms": 0.0})
                md["layers"] += 1
                md["ms"] += layer["ms"]
                md["bound_ms"] += layer["bound_ms"]
                md["unfused_ms"] += before["ms"]
                if res is not None:
                    y = int8_conv_cuda(*unfused)[0]
                    add("residual_add", lambda: res + y, 6 * m * n, m * n, PEAK_FP32_FLOPS)
                    del y
            a = quantize_patches_cuda(nhwc, sc, k, stride, pad, k_pad)
            acc = int8_gemm(a, mod.w_mat)
            m, n_pad = acc.shape
            add(pre + "patches", lambda: quantize_patches_cuda(nhwc, sc, k, stride, pad, k_pad),
                in_bytes + a.numel(), 4 * elems, PEAK_FP32_FLOPS,
                (lambda: quantize_patches_plain(nhwc, sc, k, stride, pad, k_pad))
                if plain else None)
            add(pre + "gemm", lambda: int8_gemm(a, mod.w_mat),
                a.numel() + mod.w_mat.numel() + 4 * acc.numel(), 2.0 * m * k_pad * n_pad,
                PEAK_INT8_OPS)
            add(pre + "epilogue", lambda: epilogue_cuda(acc, n, mod.scale, mod.bias, act, bf),
                4 * acc.numel() + 8 * n + 2 * m * n, 7.0 * m * n, PEAK_FP32_FLOPS,
                (lambda: epilogue_plain(acc, n, mod.scale, mod.bias, act, bf))
                if plain else None)
            del a, acc

    hooks = [m.register_forward_pre_hook(timed) for m in model.modules()
             if isinstance(m, Int8Conv)]
    link_int8(model, enabled=False)
    try:
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            model(x)
    finally:
        for h in hooks:
            h.remove()
        link_int8(model)
    for st in steps.values():
        st["bound_by"] = "bytes" if st["bytes_ms"] >= st["ops_ms"] else "operations"

    def total(keys):
        return {f: sum(steps[k][f] for k in keys if k in steps) for f in ("ms", "bound_ms")}

    return {"batch": x.shape[0], "layers": n_layers, "steps": steps, "fused_modes": modes,
            "path_route": total(("quantize", "int8_conv")),
            "unlinked_route": total(("quantize", "quantize_linked_away", "int8_conv_unfused",
                                     "residual_add")),
            "gemm_route_same_layers": total(("patches", "gemm", "epilogue"))}


def stem_patches(dev: torch.device, yolo_x: torch.Tensor, yolo_scale: torch.Tensor) -> dict:
    """The patches kernel's line kernel on the RGB stems it serves, against
    its plain version on the card (bytes that differ, float32 and bfloat16
    inputs) and timed in bfloat16 (ms between CUDA events; the plain
    version's; the bound: the input read once and the patches written once
    over HBM's rate, against 4 float32 operations an input element): the
    YOLOv3-416 stem at batch 32 on the phase's own normalized images and
    stem scale, the VGG16 (Faster R-CNN) stem at 512 and batch 8, the
    ResNet-50 7 x 7 stride-2 stem at 224 and batch 128, on normalized noise
    images."""
    g = torch.Generator().manual_seed(SEED + 55)
    cases = (("yolov3_416_b32", yolo_x, yolo_scale, 3, 1, 32),
             (f"vgg16_{FRCNN_SIZE}_b{FRCNN_BATCH}",
              torch.randn(FRCNN_BATCH, FRCNN_SIZE, FRCNN_SIZE, 3, generator=g), None, 3, 1, 32),
             (f"resnet50_{CLS_SIZE}_b{CLS_BATCH}",
              torch.randn(CLS_BATCH, CLS_SIZE, CLS_SIZE, 3, generator=g), None, 7, 2, 152))
    out = {"differing": 0}
    for name, x, scale, k, stride, k_pad in cases:
        x = x.to(dev, torch.bfloat16).contiguous()
        if scale is None:
            scale = (x.float().abs().amax() / 127).reshape(())
        row = {"k": k, "stride": stride, "k_pad": k_pad, "differing": 0}
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = quantize_patches_cuda(xd, scale, k, stride, k // 2, k_pad)
            row["differing"] += differing_bytes(
                got, quantize_patches_plain(xd, scale, k, stride, k // 2, k_pad))
            del got
        ho, wo = out_hw(x.shape[1], x.shape[2], k, stride, k // 2)
        n_bytes = x.numel() * x.element_size() + x.shape[0] * ho * wo * k_pad
        bytes_ms, ops_ms = 1e3 * n_bytes / PEAK_BYTES_S, 1e3 * 4 * x.numel() / PEAK_FP32_FLOPS
        row.update(ms=cuda_ms(lambda: quantize_patches_cuda(x, scale, k, stride, k // 2, k_pad),
                              reps=10),
                   plain_ms=cuda_ms(lambda: quantize_patches_plain(x, scale, k, stride, k // 2,
                                                                   k_pad), reps=2, warmup=1),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        out[name] = row
        out["differing"] += row["differing"]
        del x
        torch.cuda.empty_cache()
    return out


def int8_cli(dev: torch.device, workdir: str, n_int8: int) -> dict:
    """``eval --int8`` over a BMP dataset and ``serve --int8 --calib-dir``
    answering a few requests, through ``cli.main`` in this process at full
    width (YOLOv3-416, 80 classes, bf16, random weights), launches counted."""
    import threading

    from fastvision_tpu_torch import cli
    from fastvision_tpu_torch.infer import serving

    root = write_detection_dataset(os.path.join(workdir, "int8_ds"), INT8_CLI_IMAGES,
                                   seed=SEED + 52)
    out = {}
    suppression_mask_cuda.launches = 0
    t0 = time.perf_counter()
    res = cli.main(["eval", "--int8", f"data.data_root={root}", "data.num_workers=0"])
    out["eval_int8"] = {"seconds": time.perf_counter() - t0, "images": res["images"],
                        "map50": res["map50"], "launches": suppression_mask_cuda.launches}
    check(res["images"] == INT8_CLI_IMAGES and out["eval_int8"]["launches"] >= 1,
          f"eval --int8: {out['eval_int8']}")

    servers, services, port = [], [], free_port()
    real_make_server = serving.make_server

    def capture(service, *a, **kw):
        services.append(service)
        servers.append(real_make_server(service, *a, **kw))
        return servers[-1]

    serving.make_server = capture
    calib = os.path.join(root, "val", "images")
    argv = ["serve", "--int8", "--calib-dir", calib, "--host", "127.0.0.1", "--port", str(port)]
    thread = threading.Thread(target=cli.main, args=(argv,), daemon=True)
    suppression_mask_cuda.launches = 0
    t0 = time.perf_counter()
    thread.start()
    try:
        deadline = time.monotonic() + 300
        while True:
            check(time.monotonic() < deadline and thread.is_alive(), "serve --int8 never came up")
            if servers:
                try:
                    if _http(port, "GET", "/healthz")[0] == 200:
                        break
                except ConnectionRefusedError:
                    pass
            time.sleep(0.1)
        up_s = time.perf_counter() - t0
        answers = []
        for body in full_size_jpegs():
            status, reply = _http(port, "POST", "/predict", body)
            check(status == 200, f"serve --int8 answered {status}")
            answers.append(len(json.loads(reply)["detection_scores"]))
    finally:
        serving.make_server = real_make_server
        if servers:
            servers[0].batcher.shutdown()
            servers[0].shutdown()
        thread.join(60)
    check(not thread.is_alive(), "serve --int8 did not stop")
    out["serve_int8"] = {"up_s": up_s, "requests": len(answers), "detections": answers,
                         "launches": suppression_mask_cuda.launches,
                         "int8_convs": len(quant_state(services[0].detector.model))}
    check(suppression_mask_cuda.launches >= len(answers)
          and out["serve_int8"]["int8_convs"] == n_int8,
          f"serve --int8: {out['serve_int8']}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def int8_other_models(dev: torch.device) -> dict:
    """Faster R-CNN-VGG16 at 512 (batch 8): an eval step with the backbone
    quantized (RPN and heads float) against float; ResNet-50 and
    ResNeXt-50 32x4d at 224 (batch 128 / 32): int8 forwards against bf16
    and their images/s; a small ResNeXt (32 groups) in float32 card vs CPU
    with its grouped convs' accumulators held."""
    out = {}
    # --- Faster R-CNN, backbone int8
    model = frcnn_model().to(dev, memory_format=torch.channels_last).eval()
    u8 = frcnn_u8(dev)
    x = normalize_images(u8, torch.float32, imagenet=True)
    state = TrainState(model, None)
    eval_step = make_frcnn_eval_step(dtype=torch.bfloat16)
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
        feat_f = model.features(x.to(torch.bfloat16))
    det_f = [t.cpu() for t in eval_step(state, {"images": u8})]
    float_ms = cuda_ms(lambda: eval_step(state, {"images": u8}), reps=5)
    quantize_model(model, [x])
    names = sorted(quant_state(model))
    check(names and all(n.startswith("backbone.") for n in names),
          f"Faster R-CNN quantized outside its backbone: {names}")
    suppression_mask_cuda.launches = int8_conv_cuda.launches = 0
    det_q = [t.cpu() for t in eval_step(state, {"images": u8})]
    torch.cuda.synchronize()
    launches, conv_launches = suppression_mask_cuda.launches, int8_conv_cuda.launches
    check(launches == 2, f"the int8 eval step launched the nms kernel {launches} times")
    check(conv_launches == len(names) - 1,  # all but the RGB stem on the implicit GEMM
          f"the int8 eval step launched int8_conv {conv_launches} times, {len(names)} convs")
    check(bool(torch.isfinite(det_q[0]).all() and torch.isfinite(det_q[1]).all()),
          "int8 Faster R-CNN: non-finite output")
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
        feat_q = model.features(x.to(torch.bfloat16))
    out["faster_rcnn_vgg16_512_b8"] = {
        "int8_convs": len(names), "launches": launches, "int8_conv_launches": conv_launches,
        "backbone_features_vs_bf16": heads_vs([feat_q], [feat_f]),
        "detections": {"bf16": int(det_f[3].sum()), "int8": int(det_q[3].sum())},
        "eval_step_ms": {"bf16": float_ms,
                         "int8": cuda_ms(lambda: eval_step(state, {"images": u8}), reps=5)}}
    del model, state, u8, x, feat_f, feat_q
    torch.cuda.empty_cache()

    # --- ResNet-50 and ResNeXt-50 32x4d: int8 against bf16
    for tag, make, bs in ((f"resnet50_{CLS_SIZE}_b{CLS_BATCH}", resnet50, CLS_BATCH),
                          (f"resnext50_32x4d_{CLS_SIZE}_b{EVAL_BATCH}", resnext50_32x4d,
                           EVAL_BATCH)):
        model = make(num_classes=CLS_CLASSES, generator=torch.Generator().manual_seed(SEED))
        model = model.to(dev, memory_format=torch.channels_last)
        u8 = torch.from_numpy(np.stack([letterbox(a, CLS_SIZE)[0]
                                        for a in images(SEED + 53, bs)])).to(dev)
        x32 = normalize_images(u8, torch.float32, imagenet=True)
        calibrate_bn_(model, x32[:EVAL_BATCH])
        float_model = copy.deepcopy(model).eval()
        quantize_model(model, [x32[:INT8_CALIB]])
        model.eval()

        def logits(m):
            with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                return m(normalize_images(u8, torch.bfloat16, imagenet=True))

        int8_conv_cuda.launches = 0
        lq, lf = logits(model), logits(float_model)
        n_implicit = sum(q.on_implicit_gemm for q in model.modules() if isinstance(q, Int8Conv))
        check(int8_conv_cuda.launches == n_implicit > 0,
              f"{tag}: int8_conv launched {int8_conv_cuda.launches} times, {n_implicit} convs")
        out[tag] = {"int8_convs": len(quant_state(model)), "int8_conv_launches": n_implicit,
                    **heads_vs([lq], [lf]),
                    "top1_agreement": float((lq.argmax(1) == lf.argmax(1)).float().mean()),
                    "img_s": {"bf16": bs / cuda_ms(lambda: logits(float_model), reps=5) * 1e3,
                              "int8": bs / cuda_ms(lambda: logits(model), reps=5) * 1e3}}
        del model, float_model, u8, x32
        torch.cuda.empty_cache()

    # --- a small ResNeXt: the group path, float32 card vs CPU
    small = ResNet(Bottleneck, (1, 1, 1, 1), num_classes=10, groups=32, base_width=4,
                   generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    x = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(SEED)).to(dev)
    calibrate_bn_(small, x)
    quantize_model(small, [x])
    held = held_accumulators(small, x, torch.float32)
    cpu = copy.deepcopy(small).cpu()
    with no_tf32(), torch.inference_mode():
        rel = heads_vs([small(x)], [cpu(x.cpu())])
    out["resnext_small_64_b4"] = {"accumulators": held, "fp32_card_vs_cpu": rel,
                                  "tolerance": INT8_SMALL_TOL}
    check(held["mismatches"] == 0, f"grouped int8 accumulators card vs plain: {held}")
    check(max(rel["max_abs_over_std"]) <= INT8_SMALL_TOL,
          f"small ResNeXt int8 fp32 card vs cpu: {rel}")
    return out


def linked_vs_unlinked(model: torch.nn.Module, x: torch.Tensor, dtype: torch.dtype) -> dict:
    """The heads of ``model`` on ``x`` (under ``dtype`` autocast) with its
    int8 links and without them: bytes that differ, and the quantize passes
    each forward launched."""
    def heads():
        before = quantize_activation_cuda.launches
        with torch.inference_mode(), torch.autocast("cuda", dtype=dtype,
                                                    enabled=dtype != torch.float32):
            out = model(x)
        return out, quantize_activation_cuda.launches - before

    linked, n_linked = heads()
    link_int8(model, enabled=False)
    try:
        unlinked, n_unlinked = heads()
    finally:
        link_int8(model)
    return {"differing": sum(differing_bytes(a, b) for a, b in zip(linked, unlinked)),
            "elements": sum(a.numel() for a in linked),
            "quantize_launches": {"linked": n_linked, "unlinked": n_unlinked}}


def phase_int8(dev: torch.device, smi: str, workdir: str) -> dict:
    """int8 w8a8 PTQ on the card: ``Detector.quantize`` of a full-width
    YOLOv3-416 (80 classes, random weights, BN from the phase's images),
    the main path counted (every kernel's launches: ``int8_conv`` on the 71
    convs `implicit_gemm_eligible` takes, each writing its consumer's int8
    input where the link plan says (66), the quantize pass on the other 5,
    the GEMM route's patches and epilogue kernels on the RGB stem, and no
    residual add outside ``int8_conv``), (a) at batch 32, on every quantized
    conv's own input, the int32 accumulators card route vs plain version
    (bit-equal), the GEMM route's kernels vs their plain versions, and on the
    71: ``int8_conv`` mode (b) vs the plain accumulators and mode (a) vs PR
    10's route in bf16 and float32, its fused epilogue (int8 only, int8 and
    float, each with a residual and without) vs mode (a) + PyTorch's add +
    the quantize pass (byte-equal); ``int8_conv`` on the seeded edge cases;
    the linked forward's heads vs the unlinked forward's (byte-equal, bf16
    at 32 and float32 at 2); the stems' patches kernel vs its plain version
    and its time (YOLOv3, VGG16, ResNet-50), (b) the float32 int8 model card
    vs CPU (plain route) and the
    bf16 int8 model against the float one, (c) the int8 forward's profile
    (71 ``int8_conv`` launches, one ``_int_mm``), (d) device-program
    images/s at batch 32 and 256 (int8 and bf16), peak memory, and the int8
    convs' split at both batches (the path's route against the GEMM route on the
    same layers, ``_int_mm`` the library yardstick), (e) ``eval --int8`` and
    ``serve --int8 --calib-dir`` through the CLI, (f) Faster R-CNN,
    ResNet-50, ResNeXt-50 and a small ResNeXt."""
    t_phase = time.perf_counter()
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    model = yolo_model().to(dev)
    calib_imgs = images(SEED + 50, INT8_CALIB)
    batch, _ = preprocess_batch(calib_imgs, INPUT_SIZE)
    x8 = normalize_images(torch.from_numpy(batch), torch.float32).to(dev)
    calibrate_bn_(model, x8)
    float_model = copy.deepcopy(model)
    det = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=EVAL_BATCH)
    det_f = Detector(float_model, anchors, input_size=INPUT_SIZE, batch_size=EVAL_BATCH)
    t0 = time.perf_counter()
    det.quantize(calib_imgs)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    n_int8 = len(quant_state(det.model))
    n_pairs = sum(1 for _ in conv_bn_pairs(det.model))  # YOLOv3: 72 (Darknet-53 52, neck 20)
    check(n_int8 == n_pairs, f"{n_int8} quantized convs of {n_pairs} ConvBNs")
    n_implicit = sum(q.on_implicit_gemm for q in det.model.modules() if isinstance(q, Int8Conv))
    check(n_implicit == n_int8 - 1, f"{n_implicit} convs on the implicit GEMM, want all but "
                                    f"the RGB stem of {n_int8}")
    plan = link_int8(det.model)  # what Detector.quantize installed, read back
    n_quantize = n_implicit - len(plan)  # convs whose int8 input no producer writes
    check(n_quantize == INT8_QUANTIZE_PASSES,
          f"the link plan leaves {n_quantize} quantize passes of {n_implicit}, want "
          f"{INT8_QUANTIZE_PASSES}")

    # --- the main path, counted
    imgs = images(SEED + 51, 8)
    int8_kernels = {"patches": quantize_patches_cuda, "epilogue": epilogue_cuda,
                    "int8_conv": int8_conv_cuda, "quantize": quantize_activation_cuda}
    suppression_mask_cuda.launches = add_residual.runs = 0
    for f in int8_kernels.values():
        f.launches = 0
    results = det.predict_batch(imgs)
    launches = suppression_mask_cuda.launches
    int8_launches = {k: f.launches for k, f in int8_kernels.items()}
    residual_adds = add_residual.runs
    check(launches >= 1, "the int8 predict_batch never launched the nms kernel")
    n_fwd = -(-len(imgs) // det.batch_size)  # a launch of each a conv a forward
    want = {"patches": (n_int8 - n_implicit) * n_fwd, "epilogue": (n_int8 - n_implicit) * n_fwd,
            "int8_conv": n_implicit * n_fwd, "quantize": n_quantize * n_fwd}
    check(int8_launches == want, f"the int8 predict_batch launched {int8_launches}, not {want}")
    check(residual_adds == 0, f"the int8 predict_batch ran {residual_adds} residual adds outside "
                              "int8_conv's epilogue, want 0 (Darknet's 23 are fused)")
    for r, im in zip(results, imgs):
        h, w = im.shape[:2]
        bx = r["boxes"]
        check(np.isfinite(bx).all() and np.isfinite(r["scores"]).all(), "int8: non-finite output")
        check((bx >= 0).all() and (bx[:, [0, 2]] <= w).all() and (bx[:, [1, 3]] <= h).all(),
              "int8: a box lies outside its image")

    # --- (a) accumulators, card route vs plain, every quantized conv at batch 32
    u8_8 = torch.from_numpy(preprocess_batch(imgs, INPUT_SIZE)[0]).to(dev)
    u8_32 = torch.from_numpy(np.concatenate([batch, preprocess_batch(
        images(SEED + 54, EVAL_BATCH - INT8_CALIB), INPUT_SIZE)[0]])).to(dev)
    acc = held_accumulators(det.model, normalize_images(u8_32, torch.bfloat16), torch.bfloat16)
    check(acc["convs"] == n_int8 and acc["mismatches"] == 0
          and acc["patches_kernel_mismatching_bytes"] == 0,
          f"int8 accumulators or patches, kernel vs plain version: {acc}")
    check(acc["epilogue_kernel_max_ulps"] <= INT8_EPILOGUE_ULPS,
          f"int8 epilogue kernel vs plain version: {acc}")
    check(acc["implicit_gemm_convs"] == n_implicit and acc["quantize_pass_mismatching_bytes"] == 0
          and acc["int8_conv_mode_b_mismatches"] == 0
          and acc["int8_conv_mode_a_differing"] == {"bf16": 0, "f32": 0},
          f"int8_conv vs the plain accumulators or the GEMM route: {acc}")
    check(acc["fused_epilogue_convs"] == n_implicit and fused_clean(acc["fused_epilogue_differing"]),
          f"int8_conv's fused epilogue vs mode (a) + add + the quantize pass: {acc}")
    edges = int8_conv_edge_cases(dev)
    check(edges["mode_b_mismatches"] == 0 and edges["mode_a_differing"] == 0
          and edges["fused_differing"] == 0 and edges["quantize_ties_differing"] == 0,
          f"int8_conv on the edge cases: {edges}")
    x32 = normalize_images(u8_32, torch.bfloat16)
    links = {"bf16_batch32": linked_vs_unlinked(det.model, x32, torch.bfloat16),
             "f32_batch2": linked_vs_unlinked(det.model, x8[:2], torch.float32)}
    check(all(r["differing"] == 0 and r["quantize_launches"] == {
        "linked": n_quantize, "unlinked": n_implicit} for r in links.values()),
        f"the linked int8 forward against the unlinked one: {links}")
    stems = stem_patches(dev, x32, det.model.backbone.conv0.conv.quant.in_scale)
    check(stems["differing"] == 0, f"the stems' patches kernel vs its plain version: {stems}")

    # --- (b) float32 card vs CPU, layer by layer and whole; bf16 int8 vs bf16 float
    cpu_model = copy.deepcopy(det.model).cpu()
    layers = layerwise_card_vs_cpu(det.model, cpu_model, x8[:2])
    check(layers["convs"] == n_int8 and layers["max_abs_over_max"] <= INT8_LAYER_TOL,
          f"int8 convs fp32 card vs cpu on the same input: {layers}")
    with no_tf32(), torch.inference_mode():
        heads_dev = det.model(x8[:2])
        heads_cpu = cpu_model(x8[:2].cpu())
    del cpu_model
    fp32 = {**heads_vs(heads_dev, heads_cpu), "min_corr": INT8_HEADS_MIN_CORR, "layers": layers}
    check(fp32["corr"] >= INT8_HEADS_MIN_CORR, f"int8 fp32 heads card vs cpu: {fp32}")
    x_bf = normalize_images(u8_8, torch.bfloat16)
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
        bf16_vs_float = heads_vs(det.model(x_bf), det_f.model(x_bf))

    # --- (c) profile of the int8 device program at batch 32 (4 calls: a warm-up and 3
    # profiled). int8_conv's launches are read from its wrapper's count: late in a long
    # process the profiler's device records of a run can come back short
    before = (int8_conv_cuda.launches, quantize_activation_cuda.launches, add_residual.runs)
    prof = int8_profile(lambda: det.infer(u8_32), reps=3)
    prof["int8_conv_launches_per_call"] = (int8_conv_cuda.launches - before[0]) / 4
    prof["quantize_launches_per_call"] = (quantize_activation_cuda.launches - before[1]) / 4
    prof["residual_adds_per_call"] = (add_residual.runs - before[2]) / 4
    check(prof["int_mm_per_call"] == n_int8 - n_implicit and prof["convolutions_per_call"] == 3
          and prof["int8_conv_launches_per_call"] == n_implicit
          and prof["quantize_launches_per_call"] == n_quantize
          and prof["residual_adds_per_call"] == 0,
          f"int8 forward: {prof['int_mm_per_call']} int8 GEMMs, "
          f"{prof['int8_conv_launches_per_call']} int8_conv launches, "
          f"{prof['quantize_launches_per_call']} quantize passes, "
          f"{prof['residual_adds_per_call']} residual adds and "
          f"{prof['convolutions_per_call']} float convs per call (want {n_int8 - n_implicit}, "
          f"{n_implicit}, {n_quantize}, 0 and the 3 pred convs)")
    check(bool(prof["int8_gemm_kernels"]), "no device kernel ran under aten::_int_mm")

    # --- (d) device-program images/s, the split, peak memory
    times, split = {}, {}
    for bs in INT8_BATCHES:
        u8 = u8_32.repeat(bs // EVAL_BATCH, 1, 1, 1)
        row = {}
        for tag, d in (("int8", det), ("bf16", det_f)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda d=d: d.infer(u8), reps=10 if bs <= 32 else 3)
            row[tag] = {"ms": ms, "img_s": bs / ms * 1e3,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        row["int8_over_bf16"] = row["int8"]["img_s"] / row["bf16"]["img_s"]
        times[f"batch{bs}"] = row
        split[f"batch{bs}"] = int8_split(det.model, normalize_images(u8, torch.bfloat16),
                                         plain=bs == EVAL_BATCH)
        del u8
        torch.cuda.empty_cache()
    emit("int8", card=smi, model="YOLOv3 Darknet-53, 80 classes, full width, random weights "
         "(seed 0), BN from 8 of the phase's images, Detector.quantize on those 8",
         input_size=INPUT_SIZE, int8_convs=n_int8, quantize_s=quantize_s,
         implicit_gemm_convs=n_implicit,
         link_plan={"edges": len(plan), "int8_only": sum(not k for *_, k in plan),
                    "int8_and_float": sum(k for *_, k in plan), "quantize_passes": n_quantize},
         predict_batch_launches={"nms": launches, **int8_launches},
         predict_batch_residual_adds=residual_adds,
         accumulators_and_kernels_batch32=acc, int8_conv_edge_cases=edges,
         linked_vs_unlinked=links, stem_patches=stems, fp32_card_vs_cpu=fp32,
         bf16_int8_vs_bf16_float=bf16_vs_float, profile_batch32=prof,
         device_program=times, fused_epilogue_split={
             b: sp["fused_modes"] for b, sp in split.items()}, int8_conv_split=split)

    # --- (e) the CLI, (f) other models
    del det, det_f, model, float_model
    torch.cuda.empty_cache()
    cli_out = int8_cli(dev, workdir, n_int8)
    torch.cuda.empty_cache()
    others = int8_other_models(dev)
    emit("int8_cli_and_models", card=smi, cli=cli_out, models=others,
         phase_seconds=time.perf_counter() - t_phase)
    return {"launches": {"int8_detector_predict_batch": launches,
                         "int8_cli_eval": cli_out["eval_int8"]["launches"],
                         "int8_cli_serve": cli_out["serve_int8"]["launches"],
                         "int8_frcnn_eval_step": others["faster_rcnn_vgg16_512_b8"]["launches"]},
            "mismatches": acc["mismatches"], "kernels": int8_kernel_entries(
                int8_launches, acc, split[f"batch{EVAL_BATCH}"], stems)}


EXPORT_BATCHES = (8, 32)
EXPORT_REPS = 10
# the graph's op names of the port's custom ops
NMS_OP = "fastvision.nms_suppression_mask.default"
INT8_OPS = {"int8_conv": "fastvision.int8_conv.default",
            "patches": "fastvision.int8_patches.default",
            "epilogue": "fastvision.int8_epilogue.default"}
CONV_OPS = ("aten.conv2d.default", "aten.conv3d.default", "aten.convolution.default")
# the int8 kernels' entries of the kernels line -> their launch counters' keys
INT8_ENTRY_KEYS = {"int8_conv": "int8_conv", "int8_quantize_activation": "quantize",
                   "int8_quantize_patches": "patches", "int8_epilogue": "epilogue"}


def _program_kernels() -> dict:
    return {"nms": suppression_mask_cuda, "int8_conv": int8_conv_cuda,
            "quantize": quantize_activation_cuda, "patches": quantize_patches_cuda,
            "epilogue": epilogue_cuda}


def conv_dtypes(program) -> dict:
    """Output dtype -> conv nodes of a program's graphs (its autocast
    regions included)."""
    out: dict = collections.Counter()
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for n in gm.graph.nodes:
                if n.op == "call_function" and str(n.target) in CONV_OPS:
                    out[str(n.meta["val"].dtype).replace("torch.", "")] += 1
    return dict(out)


def run_loaded_programs(spec_path: str) -> None:
    """The fresh process of phase_export: for each entry of the JSON list at
    ``spec_path`` ({path, inputs, outputs, graph}), `load_exported` the program,
    read its graph, run it once on the saved inputs under
    ``deterministic_algorithms`` with every kernel's launches counted, save
    its outputs, and time it (``cuda_ms``, ``graph_ms``); prints one JSON
    list of the results."""
    torch.cuda.set_device(0)
    with open(spec_path) as f:
        spec = json.load(f)
    kernels = _program_kernels()
    results = []
    for item in spec:
        t0 = time.perf_counter()
        exported = load_exported(item["path"])
        program = exported.module()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        x = torch.load(item["inputs"]).cuda()
        before = {k: f.launches for k, f in kernels.items()}
        with deterministic_algorithms() as found, torch.inference_mode():
            out = program(x)
            torch.cuda.synchronize()
        launches = {k: f.launches - before[k] for k, f in kernels.items()}
        torch.save({k: v.cpu() for k, v in out.items()}, item["outputs"])
        with torch.inference_mode():
            ms = cuda_ms(lambda: program(x), reps=EXPORT_REPS)
            device_ms = (graph_ms(lambda: program(x), reps=2 * EXPORT_REPS)
                         if item["graph"] else None)
        counts = op_counts(exported)
        results.append({
            "path": item["path"], "load_s": load_s, "ms": ms, "graph_ms": device_ms,
            "launches": launches,
            "nondeterministic_ops": found, "nodes": node_count(exported),
            "custom_op_nodes": {k: v for k, v in counts.items() if k.startswith("fastvision.")},
            "select_nodes": counts.get("aten.select.int", 0), "conv_dtypes": conv_dtypes(exported)})
        del exported, program, out
        torch.cuda.empty_cache()
    print(json.dumps(results), flush=True)


def load_in_fresh_process(items: list[dict], workdir: str) -> list[dict]:
    """`run_loaded_programs` in a new Python process on the card."""
    spec = os.path.join(workdir, "programs.json")
    with open(spec, "w") as f:
        json.dump(items, f)
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.run_loaded_programs({spec!r})"],
        cwd=here, capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"the fresh process that loads the programs failed "
                                f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_export(dev: torch.device, smi: str, workdir: str) -> dict:
    """The export path: YOLOv3-416 (full width, 80 classes, bf16, K = 1024,
    BN from 8 of the phase's images) through `detector_program` at batch 8
    and 32, float and after ``Detector.quantize`` on 8 images, ResNet-50 at
    224 and SlowFast-R50 at 32 x 224 through `classifier_program` at batch 8,
    each exported to a ``.pt2``, loaded and run in a fresh process; eager and
    loaded outputs compared bit for bit, both under ``deterministic_algorithms``."""
    t_phase = time.perf_counter()
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    model = yolo_model(SEED + 60).to(dev)
    batch, _ = preprocess_batch(images(SEED + 60, INT8_CALIB), INPUT_SIZE)
    calibrate_bn_(model, normalize_images(torch.from_numpy(batch), torch.float32).to(dev))
    det = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=max(EXPORT_BATCHES))
    u8 = torch.from_numpy(preprocess_batch(images(SEED + 61, max(EXPORT_BATCHES)),
                                           INPUT_SIZE)[0]).to(dev)
    programs: list[dict] = []  # path, inputs, outputs, and the eager side's numbers

    def export(tag: str, fn, eager, x: torch.Tensor, graph: bool = True) -> None:
        path = os.path.join(workdir, f"{tag}.pt2")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_program(fn, [torch.zeros_like(x)], path)
        export_s = time.perf_counter() - t0
        with deterministic_algorithms() as found, torch.inference_mode():
            want = {k: v.cpu() for k, v in eager(x).items()}
        inputs = os.path.join(workdir, f"{tag}_inputs.pt")
        torch.save(x.cpu(), inputs)
        # eager and the loaded program in turns (eager, loaded, loaded, eager):
        # ms between events over back-to-back calls, and with ``graph`` one
        # call captured as a CUDA graph and replayed (the device's time, no
        # host cost; the eager classifiers copy the ImageNet mean and std to
        # the card each call, which a capture refuses)
        loaded = load_program(path)
        timing: dict = collections.defaultdict(list)
        with torch.inference_mode():
            for who, f in (("eager", eager), ("loaded", loaded), ("loaded", loaded),
                           ("eager", eager)):
                timing[f"{who}_ms"].append(cuda_ms(lambda: f(x), reps=EXPORT_REPS))
                if graph:
                    timing[f"{who}_graph_ms"].append(graph_ms(lambda: f(x),
                                                              reps=2 * EXPORT_REPS))
        del loaded
        programs.append({"tag": tag, "path": path, "inputs": inputs, "graph": graph,
                         "outputs": os.path.join(workdir, f"{tag}_outputs.pt"), "want": want,
                         "export_s": export_s, "bytes": os.path.getsize(path),
                         "in_turns": dict(timing), "eager_nondeterministic_ops": found})

    def det_eager(x):
        return det.infer(x)._asdict()

    for bs in EXPORT_BATCHES:
        export(f"yolov3_float_b{bs}", detector_program(det), det_eager, u8[:bs])
    t0 = time.perf_counter()
    det.quantize(images(SEED + 50, INT8_CALIB))
    quantize_s = time.perf_counter() - t0
    for bs in EXPORT_BATCHES:
        export(f"yolov3_int8_b{bs}", detector_program(det), det_eager, u8[:bs])
    del det, model
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(SEED + 62)
    for tag, build, shape in (
            ("resnet50_b8", lambda: resnet50(num_classes=CLS_CLASSES, generator=torch.Generator(
                ).manual_seed(SEED)), (8, CLS_SIZE, CLS_SIZE, 3)),
            ("slowfast_r50_b8", lambda: slowfast_resnet50(
                num_classes=VID_CLASSES, generator=torch.Generator().manual_seed(SEED)),
             (VID_BATCH, VID_T, VID_SIZE, VID_SIZE, 3))):
        net = build()
        net = net.to(dev, memory_format=memory_format_for(net)).eval()
        fn = classifier_program(net, torch.bfloat16)
        export(tag, fn, fn, torch.randint(0, 256, shape, generator=g, dtype=torch.uint8).to(dev),
               graph=False)
        del net, fn
        torch.cuda.empty_cache()

    loaded = load_in_fresh_process(
        [{k: p[k] for k in ("path", "inputs", "outputs", "graph")} for p in programs], workdir)
    rows, launches = {}, {}
    int8_launches: dict = {key: {} for key in INT8_ENTRY_KEYS.values()}
    for p, r in zip(programs, loaded):
        got = torch.load(p["outputs"])
        differing = {k: int((got[k] != v).sum()) for k, v in p["want"].items()}
        tag = p["tag"]
        rows[tag] = {**{k: v for k, v in p.items() if k not in ("want", "path", "inputs",
                                                                  "outputs", "graph")},
                     **{k: v for k, v in r.items() if k != "path"}, "differing": differing}
        check(sorted(got) == sorted(p["want"]) and sum(differing.values()) == 0,
              f"{tag}: the loaded program differs from eager: {differing}")
        nodes = r["custom_op_nodes"]
        if tag.startswith("yolov3"):
            int8 = "int8" in tag
            want_nodes = {NMS_OP: 1, **({INT8_OPS["int8_conv"]: 71, INT8_OPS["patches"]: 6,
                                         INT8_OPS["epilogue"]: 1} if int8 else {})}
            want_launches = {"nms": 1, "int8_conv": 71 if int8 else 0,
                             "quantize": INT8_QUANTIZE_PASSES if int8 else 0,
                             "patches": int(int8), "epilogue": int(int8)}
            launches[f"export_{tag}"] = r["launches"]["nms"]
            if int8:
                for key, by_path in int8_launches.items():
                    by_path[f"export_{tag}"] = r["launches"][key]
            else:
                check(set(r["conv_dtypes"]) == {"bfloat16"},
                      f"{tag}: the program's convs are {r['conv_dtypes']}, not bf16")
        else:
            want_nodes, want_launches = {}, {k: 0 for k in r["launches"]}
            launches[f"export_{tag}"] = r["launches"]["nms"]
        check(nodes == want_nodes, f"{tag}: custom-op nodes {nodes}, want {want_nodes}")
        check(r["launches"] == want_launches,
              f"{tag}: the loaded program launched {r['launches']}, want {want_launches}")
        check(r["select_nodes"] < 100, f"{tag}: {r['select_nodes']} select nodes: an unrolled "
                                       "loop in the graph")
    emit("export", card=smi, model="YOLOv3 Darknet-53 (80 classes, 416, bf16, random weights "
         "seed 60, BN from 8 of the phase's images; int8: Detector.quantize on 8), ResNet-50 "
         "(1000 classes, 224, bf16), SlowFast-R50 (400 classes, 32 x 224, bf16)",
         quantize_s=quantize_s, programs=rows, phase_seconds=time.perf_counter() - t_phase)
    zero = [p for p in launches if not p.startswith("export_yolov3")]
    return {"launches": launches, "zero": zero, "int8_launches": int8_launches}


# the recipe phase: the training recipe's options at full width. Every
# augmentation op the detection loader takes on the config's process pools,
# at p < 1 (the ops with draws too); 'normalization', whose float32 output
# the process pools refuse, runs in the loader readings on threads.
RECIPE_DET_OPS = [
    "bgr2rgb:0.5", {"op": "jitter", "ratio": 0.3, "p": 0.5},
    {"op": "resize_by_max", "size": 512, "p": 0.5}, {"op": "padding", "size": 512, "p": 0.5},
    {"op": "random_crop", "size": 448, "p": 0.5}, {"op": "center_crop", "size": 416, "p": 0.5},
    {"op": "resize", "size": 416, "p": 0.3}, "hflip:0.5", "vflip:0.5", "hsv:0.5",
    "hist_equalize:0.5", {"op": "blur", "kind": "box", "p": 0.3},
    {"op": "blur", "kind": "gaussian", "ksize": 5, "p": 0.3},
    {"op": "blur", "kind": "median", "ksize": 5, "p": 0.3}, "channel_shuffle:0.5"]
RECIPE_CLS_OPS = [{"op": "random_crop", "size": 240}, {"op": "center_crop", "size": 224},
                  {"op": "resize", "size": CLS_SIZE}, "hflip:0.5"]
RECIPE_ACCUM = 2
RECIPE_OP_HW = (480, 640)
RECIPE_WORKERS = (0, 4)


@contextlib.contextmanager
def recorded_nms_inputs():
    """Records (boxes, scores, iou) of every NMS kernel call the block's
    paths make, for holding the kernel against its plain version after."""
    nms_mod = importlib.import_module("fastvision_tpu_torch.ops.nms")
    real, sink = nms_mod.nms_suppression_mask, []

    def recording(boxes, scores, iou_thres):
        sink.append((boxes.clone(), scores.clone(), iou_thres))
        return real(boxes, scores, iou_thres)

    nms_mod.nms_suppression_mask = recording
    try:
        yield sink
    finally:
        nms_mod.nms_suppression_mask = real


def kernel_vs_plain_recorded(recorded: list) -> dict:
    """The NMS kernel against its plain version on recorded inputs."""
    mismatches = 0
    for boxes, scores, iou in recorded:
        keep = suppression_mask_cuda(boxes, scores, iou)
        mismatches += int((keep != suppression_mask_plain(boxes, scores, iou)).sum())
    return {"calls": len(recorded), "shapes": sorted({tuple(s.shape) for _, s, _ in recorded}),
            "mismatches": mismatches}


def small_step(dev, loss_fn, dtype: torch.dtype = torch.float32) -> tuple[dict, dict, dict]:
    """One SGD step (lr 1e-2, TF32 off) of a shallow YOLOv3 (80 classes,
    256 px, batch 4, seeded) in ``dtype`` on ``dev``: (start state, state
    after, metrics)."""
    model = YOLOv3(num_classes=NUM_CLASSES, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(SEED)).to(dtype)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = next(iter(DetectionLoader(SyntheticDetectionDataset(4, NUM_CLASSES, seed=SEED + 1),
                                      256, 4, max_boxes=16, seed=SEED)))
    with no_tf32():
        state = TrainState.create(model, build_optimizer("sgd", model), dev)
        _, metrics = make_train_step(loss_fn, dtype=dtype)(
            state, {k: torch.from_numpy(batch[k]).to(dev) for k in ("images", "labels")}, 1e-2)
        metrics = {k: float(v) for k, v in metrics.items()}
    return start, {k: v.cpu() for k, v in model.state_dict().items()}, metrics


def step_diff(a: tuple, b: tuple) -> dict:
    """Two `small_step` results: relative loss and grad-norm differences, and
    `state_max_rel_diff` of the states (b the reference)."""
    return {"loss_rel": abs(a[2]["loss"] / b[2]["loss"] - 1),
            "grad_norm_rel": abs(a[2]["grad_norm"] / b[2]["grad_norm"] - 1),
            "state_max_rel": state_max_rel_diff(a[1], b[1], b[0])}


def card_vs_cpu_step(dev: torch.device, loss_fn) -> dict:
    """One float32 step (`small_step`), the card against the CPU: loss, grad
    norm and state, within phase_train's tolerances (``within``)."""
    out = {**step_diff(small_step(dev, loss_fn), small_step("cpu", loss_fn)),
           "tolerances": {"loss_rel": 1e-4, "kernels": 1e-3, "others": 1e-2}}
    out["within"] = (out["loss_rel"] <= 1e-4 and out["state_max_rel"]["kernels"][0] <= 1e-3
                     and out["state_max_rel"]["others"][0] <= 1e-2)
    return out


def card_vs_cpu_per_cell(dev: torch.device, loss_fn) -> dict:
    """`YOLOv3LossPerCell`'s step card vs CPU. Its one-step update is up to
    ~4 times the kernels' std (bce_mse's MSE on raw wh logits; YOLOv3Loss's
    ~0.3), and phase_train's tolerances are relative to the tensors' std:
    the CPU's float32 step, whose train-mode BN backward rounds to ~1e-3
    of the update, sits 6e-3 of the std from the CPU's float64 step. So the
    reference is the CPU in float64 (the loss itself computes in float32
    in both): the card's float32 and float64 states within phase_train's
    tolerances of it, the float32 loss within 1e-4 of the CPU's float32
    loss. The CPU's own float32 distance is reported beside them."""
    cpu64 = small_step("cpu", loss_fn, torch.float64)
    card32, cpu32 = small_step(dev, loss_fn), small_step("cpu", loss_fn)
    out = {"float32": step_diff(card32, cpu32),
           "card_float32_vs_cpu_float64": step_diff(card32, cpu64),
           "float64": step_diff(small_step(dev, loss_fn, torch.float64), cpu64),
           "cpu_float32_vs_cpu_float64": step_diff(cpu32, cpu64),
           "tolerances": {"loss_rel": 1e-4, "kernels": 1e-3, "others": 1e-2}}
    out["within"] = out["float32"]["loss_rel"] <= 1e-4 and all(
        out[k]["loss_rel"] <= 1e-4 and out[k]["state_max_rel"]["kernels"][0] <= 1e-3
        and out[k]["state_max_rel"]["others"][0] <= 1e-2
        for k in ("card_float32_vs_cpu_float64", "float64"))
    return out


def per_cell_parts(anchors: np.ndarray, box_loss: str):
    loss = YOLOv3LossPerCell(anchors, num_classes=NUM_CLASSES, box_loss=box_loss)

    def loss_fn(heads, batch):
        out = loss(heads, batch["labels"])
        return out.total, {"box": out.box, "obj": out.obj, "cls": out.cls}

    return loss_fn


def loader_img_s(root: str, specs, workers: int, backend: str = "process") -> dict:
    """A DetectionLoader over the phase's BMP files (416, batch 32, mosaic
    0.5 as the CLI's): one epoch to start the pool, one timed."""
    loader = DetectionLoader(DetectionDataset(root, "train"), INPUT_SIZE, TRAIN_BATCH,
                             max_boxes=32, train=True, seed=SEED, mosaic_prob=0.5,
                             augmentation=build_augmentation(specs), num_workers=workers,
                             worker_backend=backend)
    try:
        dtypes = {str(b["images"].dtype) for b in loader.epoch(0)}
        t0 = time.perf_counter()
        n = sum(b["num_real"] for b in loader.epoch(1))
        return {"workers": workers, "backend": backend, "img_s": n / (time.perf_counter() - t0),
                "batch_dtypes": sorted(dtypes)}
    finally:
        loader.close()


def op_host_ms(reps: int = 5) -> dict:
    """Each augmentation op applied (p = 1) to one 640 x 480 image of the
    synthetic set: median host ms over ``reps`` on one thread."""
    image, labels, _ = SyntheticDetectionDataset(1, NUM_CLASSES, seed=SEED + 7,
                                                 sizes=(RECIPE_OP_HW,))[0]
    specs = {"bgr2rgb": {}, "jitter": {"ratio": 0.3}, "resize_by_max": {"size": 512},
             "padding": {"size": 704}, "random_crop": {"size": 448}, "center_crop": {"size": 416},
             "resize": {"size": 416}, "hflip": {}, "vflip": {}, "hsv": {}, "hist_equalize": {},
             "blur_box_3": {"kind": "box"}, "blur_gaussian_5": {"kind": "gaussian", "ksize": 5},
             "blur_median_3": {"kind": "median"}, "blur_median_5": {"kind": "median", "ksize": 5},
             "channel_shuffle": {}, "normalization": {}}
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the loaders run them
    try:
        for tag, kw in specs.items():
            op = OP_REGISTRY[tag.split("_")[0] if tag.startswith("blur") else tag](**kw)
            times = []
            for i in range(reps):
                decision = op.sample(np.random.default_rng(i), image)
                t0 = time.perf_counter()
                out_image, _ = op.apply(image, labels, decision)
                np.ascontiguousarray(out_image)
                times.append(1e3 * (time.perf_counter() - t0))
            out[tag] = float(np.median(times))
    finally:
        torch.set_num_threads(threads)
    return out


def phase_recipe(dev: torch.device, smi: str, workdir: str) -> dict:
    """The training recipe's options at full width (YOLOv3-416, Darknet-53,
    80 classes, bf16, channels_last, K = 1024): (a) ``cli.main(["train",
    ...])`` with every augmentation op at p < 1 and ``train.accum_steps:
    2`` for 2 epochs on the process pools, validated each epoch (the NMS
    kernel's launches counted, its inputs recorded and held against the
    plain version), then ``train-cls`` (ResNet-50-224) with random_crop,
    center_crop, resize and hflip; (b) ``YOLOv3LossPerCell`` (bce_mse,
    ciou): one float32 step card vs CPU, a bf16 ``Fit`` at batch 32, and
    the train step's img/s and the loss's ms beside ``YOLOv3Loss``'s;
    (c) accum_steps = 2 through ``Fit``, cut after an odd call and resumed,
    against the uncut run; (d) the loader's img/s with the full op list
    against the default recipe at 0 and 4 workers, and each op's host ms."""
    from fastvision_tpu_torch import cli

    t_phase = time.perf_counter()
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    launches: dict = {}
    report: dict = {"card": smi}

    # --- (a) the CLI: train with every op and accum_steps 2, train-cls with the cls ops
    root = write_detection_dataset(os.path.join(workdir, "recipe_ds"), TRAIN_IMAGES,
                                   sizes=SIZES, seed=SEED + 11, num_classes=NUM_CLASSES)
    cfg = os.path.join(workdir, "recipe.yaml")
    with open(cfg, "w") as f:
        json.dump({"data": {"augment": RECIPE_DET_OPS},
                   "train": {"accum_steps": RECIPE_ACCUM}}, f)  # JSON is YAML
    ckpt = os.path.join(workdir, "recipe_ckpt")
    with recorded_nms_inputs() as recorded:
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        fit = cli.main(["train", "--config", cfg, f"data.data_root={root}",
                        f"data.input_size={INPUT_SIZE}", f"data.batch_size={TRAIN_BATCH}",
                        "train.epochs=2", f"train.ckpt_dir={ckpt}", "train.ema_decay=0.9999"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches["recipe_cli_train"] = suppression_mask_cuda.launches
    opt = fit.state.optimizer
    check(isinstance(opt, MultiSteps) and opt.every_k == RECIPE_ACCUM and opt.mini_step == 0,
          f"cli train: optimizer {type(opt).__name__}")
    check(fit.global_step == 2 * len(fit.train_loader) and not fit.interrupted, "cli train steps")
    check(len(fit.train_loader.augmentation.ops) == len(RECIPE_DET_OPS)
          and fit.train_loader.worker_backend == "process", "cli train augmentation")
    with open(os.path.join(ckpt, "train.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "train_loss" in r]
    check(len(epochs) == 2 and all(np.isfinite(r["train_loss"]) for r in epochs),
          f"cli train epochs {epochs}")
    held = kernel_vs_plain_recorded(recorded)
    del fit, opt, recorded
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()
    check(launches["recipe_cli_train"] > 0 and held["calls"] == launches["recipe_cli_train"],
          f"cli train: {launches['recipe_cli_train']} launches, {held['calls']} recorded")
    report["cli_train"] = {
        "argv": "train --config recipe.yaml (data.augment: 15 specs, the 13 ops but "
                "normalization, blur in its 3 kinds; train.accum_steps: 2) at 416, batch 32, "
                "2 epochs",
        "seconds": cli_s, "epochs": [{k: r[k] for k in ("epoch", "train_loss", "epoch_img_s",
                                                          "map50")} for r in epochs],
        "nms_launches": launches["recipe_cli_train"], "nms_vs_plain": held}

    cls_root = write_classification_dataset(os.path.join(workdir, "recipe_cls"), CLS_IMAGES,
                                            num_classes=CLS_FOLDERS, sizes=CLS_HW,
                                            seed=SEED + 12)
    cls_cfg = os.path.join(workdir, "recipe_cls.yaml")
    with open(cls_cfg, "w") as f:
        json.dump({"data": {"augment": RECIPE_CLS_OPS}}, f)
    suppression_mask_cuda.launches = 0
    t0 = time.perf_counter()
    fit = cli.main(["train-cls", "--config", cls_cfg, f"data.data_root={cls_root}",
                    "model.backbone=resnet50", f"model.num_classes={CLS_CLASSES}",
                    f"data.input_size={CLS_SIZE}", f"data.batch_size={CLS_BATCH}",
                    "train.epochs=1", f"train.lr={CLS_LR}", "train.warmup_epochs=0",
                    f"train.ckpt_dir={os.path.join(workdir, 'recipe_cls_ckpt')}"])
    torch.cuda.synchronize()
    launches["recipe_cli_train_cls"] = suppression_mask_cuda.launches
    check([type(op).__name__ for op in fit.train_loader.augmentation.ops]
          == ["RandomCrop", "CenterCrop", "Resize", "HorizontalFlip"]
          and fit.global_step == len(fit.train_loader), "cli train-cls with the cls ops")
    report["cli_train_cls"] = {"seconds": time.perf_counter() - t0,
                               "global_step": fit.global_step}
    del fit
    shutil.rmtree(os.path.join(workdir, "recipe_cls_ckpt"))
    torch.cuda.empty_cache()

    # --- (b) YOLOv3LossPerCell: card vs CPU, a bf16 Fit at batch 32, step rates
    loss_fns = {"yolov3_loss": train_parts(anchors)[0],
                **{f"per_cell_{m}": per_cell_parts(anchors, m) for m in ("bce_mse", "ciou")}}
    postprocess = train_parts(anchors)[1]
    per_cell = {}
    for tag in ("per_cell_bce_mse", "per_cell_ciou"):
        cmp = card_vs_cpu_per_cell(dev, loss_fns[tag])
        emit("recipe_card_vs_cpu", loss=tag, **cmp)
        check(cmp["within"], f"{tag} card vs cpu: {cmp}")
        sink: list = []
        model = yolo_model(SEED + 13)
        fit = Fit(model, loss_fns[tag], build_optimizer("sgd", model, weight_decay=5e-4,
                                                        momentum=0.937),
                  DetectionLoader(SyntheticDetectionDataset(TRAIN_IMAGES, NUM_CLASSES, seed=SEED),
                                  INPUT_SIZE, TRAIN_BATCH, max_boxes=32, seed=SEED),
                  DetectionLoader(SyntheticDetectionDataset(VAL_IMAGES, NUM_CLASSES,
                                                            seed=SEED + 2),
                                  INPUT_SIZE, VAL_BATCH, max_boxes=32, train=False),
                  epochs=1, schedule=constant_lr(1e-2), ema_decay=0.9999,
                  evaluator=counted(detection_evaluator(make_eval_step(
                      postprocess, dtype=torch.bfloat16)), sink),
                  dtype=torch.bfloat16, metric_key="map50", metric_mode="max",
                  logger=quiet_logger(), device=dev)
        fit.run()
        check(fit.global_step == len(fit.train_loader) and sink and min(sink) > 0,
              f"{tag} Fit: {fit.global_step} steps, validation launches {sink}")
        launches[f"recipe_{tag}_fit_validation"] = sum(sink)
        per_cell[tag] = {"card_vs_cpu": cmp, "fit_global_step": fit.global_step}
        del fit, model
        torch.cuda.empty_cache()
    model = yolo_model(SEED + 14).to(dev, memory_format=torch.channels_last)
    state = TrainState(model, build_optimizer("sgd", model, weight_decay=5e-4, momentum=0.937))
    batch = device_batch_of(DetectionLoader(
        SyntheticDetectionDataset(TRAIN_BATCH, NUM_CLASSES, seed=SEED + 3), INPUT_SIZE,
        TRAIN_BATCH, max_boxes=32, seed=SEED), dev)
    with torch.autocast(dev.type, dtype=torch.bfloat16):
        heads = [h.detach() for h in model(normalize_images(batch["images"], torch.bfloat16))]
    rates = {}
    for tag, loss_fn in loss_fns.items():
        step_s = step_rate(make_train_step(loss_fn, dtype=torch.bfloat16), state, batch)
        leaves = [h.clone().requires_grad_() for h in heads]

        def loss_and_backward():
            loss_fn(leaves, batch)[0].backward()

        rates[tag] = {"train_step_img_s": TRAIN_BATCH / step_s, "train_step_ms": 1e3 * step_s,
                      "loss_forward_backward_ms": cuda_ms(loss_and_backward, reps=10)}
    report["per_cell"] = per_cell
    report["bf16_batch32"] = rates
    del model, state, batch, heads
    torch.cuda.empty_cache()

    # --- (c) accum_steps 2 through Fit, cut after an odd call and resumed
    with deterministic_algorithms() as nondeterministic:
        accum = resume_case(dev, functools.partial(yolo_resume_fit, accum_steps=RECIPE_ACCUM),
                            os.path.join(workdir, "recipe_accum"))
        shutil.rmtree(os.path.join(workdir, "recipe_accum"))
    torch.cuda.empty_cache()
    check(accum["optimizer_mini_step_at_save"] == 1, f"not cut mid-cycle: {accum}")
    if not nondeterministic:
        check(accum["final_bit_equal_to_uncut"], "accum_steps 2: the resumed run's final state "
              f"differs from the uncut run's: {accum['final_max_rel_vs_uncut']}")
    else:
        worst = accum["final_max_rel_vs_uncut"]
        check(worst["kernels"][0] <= RESUME_TOLERANCES["kernels"]
              and worst["others"][0] <= RESUME_TOLERANCES["others"],
              f"accum_steps 2: resumed run's final weights vs the uncut run's: {worst}")
    launches["recipe_accum_resume_validation"] = sum(accum["val_launches"])
    report["accum_resume"] = {
        "model": "YOLOv3-416 full width, bf16, EMA, batch 32, SGD, accum_steps 2", **accum,
        "deterministic_algorithms": {"ops_without_deterministic_implementation":
                                     nondeterministic}}

    # --- (d) the loader with the full op list against the default recipe, each op's host ms
    default = ["hflip:0.5", "hsv:0.5"]
    full = RECIPE_DET_OPS + [{"op": "normalization", "p": 0.5}]
    loaders = {f"{tag}_w{w}": loader_img_s(root, specs, w)
               for tag, specs in (("default", default), ("full", RECIPE_DET_OPS))
               for w in RECIPE_WORKERS}
    loaders["full_with_normalization_threads_w4"] = loader_img_s(root, full, 4, "thread")
    check("float32" in loaders["full_with_normalization_threads_w4"]["batch_dtypes"],
          f"normalization gave no float32 batch: {loaders}")
    report["loader_img_s"] = loaders
    report["op_host_ms_640x480"] = op_host_ms()
    shutil.rmtree(root)
    shutil.rmtree(cls_root)
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit("recipe", **report)
    return {"launches": launches, "zero": ["recipe_cli_train_cls"],
            "mismatches": held["mismatches"]}


# ---------------------------------------------------------------------------
# The decode leftovers: progressive / CMYK / YCCK / table-less JPEG, Adam7
# PNG, Motion-JPEG AVI files without cv2, Detector.predict_video
# ---------------------------------------------------------------------------
DECODE_SHAPES, DECODE_ORIENTATIONS = I420_SHAPES, I420_ORIENTATIONS  # bench.py's corpus recipe
DECODE_AVI_FRAMES, DECODE_AVI_HW, DECODE_AVI_FPS = 64, (480, 640), 25.0
DECODE_BATCH = 8
DECODE_SMOOTHED = ("prog_own_al1.jpg", "prog_cv2_dc_only.jpg")


def _decode_twins(job):
    """(h, w, seed, orientation) -> the same quantized coefficients of a
    `blurred_noise` image as a sequential and a progressive JPEG (4:2:0,
    libjpeg's q90 tables)."""
    h, w, seed, orientation = job
    img, (dqt, dht) = blurred_noise(h, w, seed), standard_jpeg_tables(90)
    pair = (encode_progressive_jpeg(img, dqt, dht, progressive=False),
            encode_progressive_jpeg(img, dqt, dht))
    return tuple(with_exif_orientation(b, orientation) if orientation > 1 else b for b in pair)


def _avi_frame(job) -> bytes:
    """(t, (h, w)) -> frame ``t`` of the phase's MJPEG AVI: a sequential
    JPEG, odd frames without DHT (the Motion-JPEG convention)."""
    t, hw = job
    dqt, dht = standard_jpeg_tables(85)
    return encode_progressive_jpeg(blurred_noise(*hw, SEED + 7000 + t), dqt, dht,
                                   progressive=False, tables=t % 2 == 0)


def _pool_map(fn, jobs: list, chunksize: int = 4) -> list:
    """``fn`` over ``jobs`` on a worker per core (spawned: this process has
    CUDA and intra-op threads)."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(os.cpu_count() or 1) as pool:
        return pool.map(fn, jobs, chunksize=chunksize)


def check_decode_corpus() -> dict:
    """The corpus's progressive, CMYK / YCCK, table-less, Adam7 and AVI
    files on every path: full and reduced decodes against cv2's stored
    pixels and digests, the fused decode against the JAX package's stored
    outputs (check_native_oracles), None on CMYK / YCCK, the AVIs against
    cv2's counts and frame digests."""
    manifest, pixels = codec_fixtures()
    with open(os.path.join(FIXTURES, "native_oracles.json")) as f:
        reduced = {(e["file"], e["factor"]): e for e in json.load(f)["cv2_reduced"]}
    kinds = ("prog", "cmyk", "ycck", "tableless", "png_adam7", "png_interlaced", "video",
             "progressive", "arith", "lossless")
    differing, files, by_kind = 0, 0, collections.Counter()
    for e in manifest:
        name = e["file"]
        if not name.startswith(kinds) or "raises" in e:
            continue
        files += 1
        by_kind[name.split("_")[0]] += 1
        if "video" in e:
            want = e["video"]
            path = os.path.join(FIXTURES, name)
            video = avi.open_video(path)
            check(isinstance(video, avi.MJPEGAvi), f"{name}: not read as Motion-JPEG")
            got = [video.frame_count, count_real_frames(path), avi.open_video(path).walk_count(),
                   video.fps]
            check(got == [want["frame_count"], want["real_frames"], want["read_loop_frames"],
                          want["fps"]], f"{name}: counts {got} != cv2's {want}")
            digests = [hashlib.sha256(f.tobytes()).hexdigest() for f in video.frames()]
            check(digests == want["frames_sha256"], f"{name}: a frame differs from cv2.imdecode's")
            continue
        got = decode_image(e["data"])
        if name in pixels:
            differing += int((got != pixels[name]).sum())
        check(hashlib.sha256(got.tobytes()).hexdigest() == e["sha256"],
              f"{name}: the decode's sha256 differs from cv2's")
        if name.endswith(".jpg"):
            for f in (2, 4, 8):
                r = decode_jpeg_reduced(e["data"], f)
                check([list(r.shape), hashlib.sha256(r.tobytes()).hexdigest()] ==
                      [reduced[(name, f)]["shape"], reduced[(name, f)]["sha256"]],
                      f"{name}: the 1/{f} decode differs from cv2's")
            if name.startswith(("cmyk", "ycck", "arith_seq_cmyk", "arith_prog_ycck")):
                check(decode_jpeg_i420(e["data"], 416) is None, f"{name}: fused decode not None")
            if name.startswith("lossless"):
                check(raises_value_error(lambda: decode_jpeg_i420(e["data"], 416)),
                      f"{name}: the fused decode took a lossless file")
    check(differing == 0, f"the decoder differs from cv2 in {differing} bytes")
    return {"files": files, "by_kind": dict(by_kind), "differing_bytes": differing,
            "native_oracles": check_native_oracles()}


def mp4_boxes(data: bytes, start: int = 0, end: int | None = None) -> dict:
    """ISO BMFF boxes -> {type: [payload]}, through moov / trak / mdia /
    minf / stbl (the file's own index, read without any decoder)."""
    end = len(data) if end is None else end
    out: dict = {}
    while start < end:
        size, kind = int.from_bytes(data[start:start + 4], "big"), data[start + 4:start + 8]
        head = 8
        if size == 1:
            size, head = int.from_bytes(data[start + 8:start + 16], "big"), 16
        out.setdefault(kind.decode(), []).append(data[start + head:start + size])
        if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
            for k, v in mp4_boxes(data, start + head, start + size).items():
                out.setdefault(k, []).extend(v)
        start += size
    return out


def predict_video_writer(det: Detector, clip: str, out_path: str) -> dict:
    """``Detector.predict_video(out_path=)`` (no cv2 on this machine: the
    port's MPEG-4 encoder and MP4 muxer) with the NMS kernel's launches
    counted and every keep mask held against the plain version; the file's
    own ``moov`` read back (frame count, fps, the ``stsz`` sizes summing to
    the ``mdat`` payload), its samples equal to the encoder's bytes of the
    drawn frames, each frame's encoder reconstruction within 1 level (mean
    |d|) of what 4:2:0 alone keeps of the drawn frame (the clip is blurred
    noise, whose chroma no 4:2:0 writer keeps: ~3.5 levels), and within
    the CPU tests' bound of 3 where that floor is below 2; encode ms and
    bytes a frame, frames/s with ``out_path`` (and, from the phase,
    without)."""
    from fastvision_tpu_torch.data.mpeg4 import (Mpeg4Encoder, rgb_to_yuv420,
                                                 yuv420_to_rgb)
    from fastvision_tpu_torch.viz import draw_detections

    seen = []
    with recorded_nms_inputs() as recorded:
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        n = det.predict_video(clip, out_path, frame_callback=lambda rgb, res: seen.append(
            (rgb, res)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = suppression_mask_cuda.launches
    held = kernel_vs_plain_recorded(recorded)
    check(held["mismatches"] == 0
          and launches == held["calls"] == DECODE_AVI_FRAMES // DECODE_BATCH,
          f"predict_video(out_path): {launches} launches, {held}")
    with open(out_path, "rb") as f:
        data = f.read()
    boxes = mp4_boxes(data)
    sizes = np.frombuffer(boxes["stsz"][0][12:], ">u4")
    count, delta = np.frombuffer(boxes["stts"][0][8:16], ">u4")
    timescale = int.from_bytes(boxes["mdhd"][0][12:16], "big")
    mdat = boxes["mdat"][0]
    check(n == len(seen) == DECODE_AVI_FRAMES == len(sizes) == count
          and timescale / delta == DECODE_AVI_FPS and int(sizes.sum()) == len(mdat),
          f"the annotated video's index: {len(sizes)} samples, {count} x {delta} / {timescale}")
    h, w = seen[0][0].shape[:2]
    enc = Mpeg4Encoder(w, h, DECODE_AVI_FPS)
    drawn = [draw_detections(rgb, r["boxes"], r["scores"], r["classes"], det.class_names)
             for rgb, r in seen]
    t0 = time.perf_counter()
    samples = [enc.encode(f) for f in drawn]
    encode_ms = 1e3 * (time.perf_counter() - t0) / len(drawn)
    check(b"".join(samples) == mdat, "the annotated video's samples != the encoder's bytes")
    errs, floors = [], []
    for f in drawn:
        errs.append(float(np.abs(enc.reconstruct(enc.levels(f)).astype(np.int16) - f).mean()))
        floors.append(float(np.abs(yuv420_to_rgb(*rgb_to_yuv420(f), h, w)
                                   .astype(np.int16) - f).mean()))
        check(errs[-1] <= floors[-1] + 1 and (floors[-1] >= 2 or errs[-1] <= 3),
              f"encoder reconstruction {errs[-1]} vs the drawn frame (4:2:0 alone {floors[-1]})")
    from fastvision_tpu_torch.data.mpeg4 import Mpeg4Video
    back = avi.open_video(out_path)  # the port's own .mp4 read back by the port's decoder
    check(isinstance(back, Mpeg4Video) and back.frame_count == back.walk_count() == n
          and back.fps == DECODE_AVI_FPS, "the annotated video read back: its count")
    back_err = 0
    for k, f in enumerate(drawn):
        got = back.planes(k)
        for a, b in zip(got[:3], enc.reconstruct_planes(enc.levels(f))):
            back_err = max(back_err, int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()))
    back.release()
    check(back_err <= 1, f"the annotated video read back: {back_err} levels from the encoder's "
          "reconstruction")
    report = {"read_back_max_abs_vs_reconstruction": back_err,
              "frames": n, "hw": [h, w], "fps": timescale / delta, "bytes": len(data),
              "bytes_per_frame": float(sizes.mean()), "encode_ms_per_frame": encode_ms,
              "reconstruction_mean_abs": {"max": max(errs), "mean": float(np.mean(errs))},
              "yuv420_alone_mean_abs": {"max": max(floors), "mean": float(np.mean(floors))},
              "predict_video_out_path_s": seconds,
              "predict_video_out_path_fps": n / seconds, "nms_vs_plain": held}
    return {"report": report, "launches": launches, "mismatches": held["mismatches"]}


VIDEO_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                              "torch_video_fixtures")
MPEG4_UCF = "xvid_cv2_320x240.avi"  # UCF-101's shape: XVID, 320 x 240, 25 fps
MPEG4_VGA = "mp4v_cv2_640x480.mp4"


def video_fixtures() -> list[dict]:
    with open(os.path.join(VIDEO_FIXTURES, "manifest.json")) as f:
        return json.load(f)["fixtures"]


@contextlib.contextmanager
def cv2_blocked():
    """``import cv2`` raises ImportError inside the block (as on a machine
    without it), whether or not this machine has cv2."""
    saved = sys.modules.get("cv2", False)
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is False:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def check_mpeg4_fixtures() -> dict:
    """Every committed MPEG-4 fixture decoded without cv2: the frame count,
    each frame's Y / Cb / Cr SHA-256 equal to FFmpeg's (the manifest), the
    decoder's tool counts, and cv2's seek landings read ascending and
    descending on one reader."""
    from fastvision_tpu_torch.data.mpeg4 import Mpeg4Video

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    frames = landings = 0
    for e in video_fixtures():
        path = os.path.join(VIDEO_FIXTURES, e["file"])
        video = avi.open_video(path)
        check(isinstance(video, Mpeg4Video), f"{e['file']}: not read as MPEG-4")
        check([video.frame_count, video.fps, video.walk_count()]
              == [e["frame_count"], e["fps"], e["frames"]], f"{e['file']}: counts")
        planes = [video.planes(i) for i in range(e["frames"])]
        check([[sha(f.y), sha(f.cb), sha(f.cr)] for f in planes] == e["sha256"],
              f"{e['file']}: a frame's planes differ from FFmpeg's")
        check(video.stats == e["stats"], f"{e['file']}: the stream's tools {video.stats}")
        video.release()
        frames += len(planes)
        if e["landings"] is None:
            continue
        digests = [sha(f.y) for f in planes]
        for order in (range(len(e["landings"])), reversed(range(len(e["landings"])))):
            video = avi.open_video(path)
            for i in order:
                got, want = video.read_at(i), e["landings"][i]
                check((got is None) == (want is None), f"{e['file']}: read_at({i})")
                if got is not None:
                    check(sha(video.planes(want).y) == digests[want], f"{e['file']}: read_at({i})")
                landings += 1
            video.release()
    return {"fixtures": len(video_fixtures()), "frames": frames, "landings_read": landings,
            "planes_differing": 0}


def _decode_all(path: str) -> int:
    video = avi.open_video(path)
    n = sum(1 for _ in video.frames())
    video.release()
    return n


def mpeg4_decode_speed() -> dict:
    """Demux + decode + RGB frames/s of the UCF-101-sized XviD fixture and
    the 640 x 480 one: one reader, and 4 readers on 4 threads (the decoder
    releases the interpreter's lock); planes alone on one reader."""
    from concurrent.futures import ThreadPoolExecutor

    out = {}
    for name in (MPEG4_UCF, MPEG4_VGA):
        path = os.path.join(VIDEO_FIXTURES, name)
        n = _decode_all(path)  # warm: the build, the page cache
        t0 = time.perf_counter()
        for _ in range(3):
            _decode_all(path)
        one = 3 * n / (time.perf_counter() - t0)
        video = avi.open_video(path)
        t0 = time.perf_counter()
        for i in range(n):
            video.planes(i)
        planes_fps = n / (time.perf_counter() - t0)
        video.release()
        with ThreadPoolExecutor(4) as pool:
            t0 = time.perf_counter()
            total = sum(pool.map(_decode_all, [path] * 8))
            four = total / (time.perf_counter() - t0)
        e = next(x for x in video_fixtures() if x["file"] == name)
        out[name] = {"hw": [e["height"], e["width"]], "frames": n, "fps_1_thread": one,
                     "planes_only_fps_1_thread": planes_fps, "fps_4_threads": four}
    return out


def mpeg4_slowfast(slowfast, dev, eval_step, workdir: str) -> dict:
    """A folder of the MPEG-4 fixtures (AVI, MP4, MOV; every tool), three
    copies of each, through VideoFolderDataset and a VideoClipLoader (4
    process workers) into the full-width SlowFast-R50's eval step (bf16, 32
    x 224), the NMS kernel's launches counted (0: it runs no NMS); the
    loader's clips/s alone over its second epoch (the first starts the
    pool)."""
    root = os.path.join(workdir, "mpeg4_video")
    for k, e in enumerate(video_fixtures()):
        d = os.path.join(root, "val", f"class_{k % 4:03d}")
        os.makedirs(d, exist_ok=True)
        for copy in range(3):
            shutil.copy(os.path.join(VIDEO_FIXTURES, e["file"]), os.path.join(d, f"{copy}_{e['file']}"))
    ds = VideoFolderDataset(root, "val")
    state = type("State", (), {"model": slowfast})()
    ld = VideoClipLoader(ds, num_frames=VID_T, size=VID_SIZE, batch_size=VID_BATCH,
                         strategy="average", train=False, seed=SEED, num_workers=4,
                         worker_backend="process")
    try:
        t0 = time.perf_counter()
        clips = sum(int(b["num_real"]) for b in ld.epoch(0))
        first_epoch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        clips2 = sum(int(b["num_real"]) for b in ld.epoch(1))
        loader_s = time.perf_counter() - t0
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        batches = [{k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
                    for k, v in b.items()} for b in ld.epoch(2)]
        logits = [eval_step(state, b) for b in batches]
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = suppression_mask_cuda.launches
    finally:
        ld.close()
    check(clips == clips2 == len(ds) == sum(int(b["num_real"]) for b in batches)
          and all(tuple(x.shape) == (VID_BATCH, VID_CLASSES) and bool(torch.isfinite(x.float()).all())
                  for x in logits), "SlowFast eval on the MPEG-4 clips")
    return {"clips": clips, "loader_clips_s": clips / loader_s, "loader_s": loader_s,
            "first_epoch_s": first_epoch_s, "loader_eval_clips_s": clips / eval_s,
            "loader_eval_s": eval_s, "batches": len(batches), "launches": launches}


def mpeg4_predict_video(det: Detector) -> dict:
    """``Detector.predict_video`` (YOLOv3-416) on the UCF-101-sized XviD
    fixture: each frame's result equal to ``predict_batch`` on the same
    frames decoded one by one, the NMS kernel's launches counted and each
    keep mask held against the plain version, the kernel timed on this
    path's inputs; frames/s."""
    path = os.path.join(VIDEO_FIXTURES, MPEG4_UCF)
    frames = list(avi.open_video(path).frames())
    seen = []
    with recorded_nms_inputs() as recorded:
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        n = det.predict_video(path, frame_callback=lambda rgb, res: seen.append(res))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = suppression_mask_cuda.launches
    check(n == len(seen) == len(frames), f"predict_video processed {n} of {len(frames)} frames")
    want = [r for i in range(0, n, DECODE_BATCH) for r in det.predict_batch(frames[i:i + DECODE_BATCH])]
    check(all(all(np.array_equal(a[k], b[k]) for k in ("boxes", "scores", "classes"))
              for a, b in zip(seen, want)),
          "predict_video's results on the MPEG-4 file differ from predict_batch")
    held = kernel_vs_plain_recorded(recorded)
    check(held["mismatches"] == 0 and launches == held["calls"] == -(-n // DECODE_BATCH),
          f"predict_video (MPEG-4): {launches} launches, {held}")
    boxes, scores, iou = recorded[-1]
    keep = suppression_mask_cuda(boxes, scores, iou)
    bound_ms, bound_by, work = nms_bound(boxes, scores, keep)
    kernel = {"shape": list(scores.shape),
              "ms": cuda_ms(lambda: suppression_mask_cuda(boxes, scores, iou), reps=50),
              "plain_ms": cuda_ms(lambda: suppression_mask_plain(boxes, scores, iou), reps=3),
              "bound_ms": bound_ms, "bound_by": bound_by, **work}
    return {"frames": n, "predict_video_fps": n / seconds, "predict_video_s": seconds,
            "detections": sum(len(r["boxes"]) for r in seen), "nms_vs_plain": held,
            "nms_kernel": kernel, "launches": launches, "mismatches": held["mismatches"]}


# ---------------------------------------------------------------------------
# The rare JPEG kinds without cv2: arithmetic-coded (SOF9, SOF10) and
# lossless (SOF3) files on the decode routes, the loaders, predict_dataset,
# the i420 path and serving
# ---------------------------------------------------------------------------
RARE_SHAPES = [(480, 640)] * 26 + [(720, 1280)] * 4 + [(480, 640)] * 2
RARE_ORIENTATIONS = [1] * 30 + [6] * 2
RARE_WORKERS = 4


def raises_value_error(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _rare_encode(job):
    """("twin", h, w, seed, orientation, coding, kind) -> a `blurred_noise`
    image's quantized coefficients (4:2:0, libjpeg's q90 tables) as a
    Huffman- or arithmetic-coded, sequential or progressive JPEG; or
    ("lossless", h, w, seed, predictor, cmyk) -> (the source, its lossless
    JPEG with a restart every 16 rows; CMYK adds a fourth plane)."""
    if job[0] == "lossless":
        _, h, w, seed, predictor, cmyk = job
        src = blurred_noise(h, w, seed)
        if cmyk:
            src = np.concatenate([src, blurred_noise(h, w, seed + 1)[..., :1]], -1)
        return src, encode_lossless_jpeg(src, predictor, 0, 16, cmyk=cmyk)
    _, h, w, seed, orientation, coding, kind = job
    data = encode_progressive_jpeg(blurred_noise(h, w, seed), *standard_jpeg_tables(90),
                                   progressive=kind == "progressive",
                                   arithmetic=coding == "arithmetic")
    return with_exif_orientation(data, orientation) if orientation > 1 else data


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """The plain version of the CMYK decode: OpenCV's icvCvt_CMYK2BGR on
    libjpeg's CMYK samples, as RGB."""
    c = cmyk.astype(np.int32)
    k = c[..., 3:]
    return (k - ((255 - c[..., :3]) * k >> 8)).astype(np.uint8)


def rare_jpeg(dev: torch.device, det: Detector, model: YOLOv3, anchors: np.ndarray,
              workdir: str) -> dict:
    """The arithmetic-coded and lossless JPEG kinds, with ``import cv2``
    blocked. (a) Full-size twins (sequential and progressive, Huffman and
    arithmetic, from the same coefficients) of each of DECODE_SHAPES' kinds
    bit-equal on the full, reduced 1/2 - 1/8 and fused I420 routes; lossless
    RGB and CMYK at full size equal to their plain versions (the source;
    OpenCV's CMYK conversion of it), full size on the reduced routes, refused
    by the fused one. (b) Decode ms of each kind against its Huffman twin.
    (c) A detection dataset written four ways (baseline, arithmetic,
    lossless, BMP) through ``imread_rgb``, the DetectionLoader on the
    DecodePool's process workers (img/s) and ``predict_dataset`` (YOLOv3-416,
    bf16, batch 8): arithmetic equal to baseline, lossless equal to BMP;
    the i420 path (fused decode) on the arithmetic files equal to the
    baseline's; ``VisionService`` answering 200 for an arithmetic and a
    lossless request (equal to ``predict_batch`` on the decoded image) and
    400 for a YCbCr-tagged lossless one. Every NMS launch on these paths is
    counted and held against the plain version."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from fastvision_tpu_torch.data.dataset import imread_rgb
    from fastvision_tpu_torch.infer import VisionService, make_server

    t_block = time.perf_counter()
    kinds = list(dict.fromkeys(zip(DECODE_SHAPES, DECODE_ORIENTATIONS)))
    jobs = [(h, w, SEED * 100003 + 50000 + i, o) for i, ((h, w), o) in enumerate(kinds)]
    names = [f"{coding}_{kind}" for coding in ("huffman", "arithmetic")
             for kind in ("sequential", "progressive")]
    lossless_jobs = [("lossless", 480, 640, SEED + 61, 1, False),
                     ("lossless", 720, 1280, SEED + 62, 7, False),
                     ("lossless", 480, 640, SEED + 63, 4, True)]
    work = [("twin", *job, *name.split("_")) for job in jobs for name in names] + lossless_jobs
    order = sorted(range(len(work)), key=lambda i: -work[i][1] * work[i][2])  # largest first
    t0 = time.perf_counter()
    encoded = dict(zip(order, _pool_map(_rare_encode, [work[i] for i in order], chunksize=1)))
    encode_s = time.perf_counter() - t0
    twins = [{name: encoded[4 * k + n] for n, name in enumerate(names)} for k in range(len(jobs))]
    lossless = [encoded[4 * len(jobs) + n] for n in range(len(lossless_jobs))]
    checks = collections.Counter()
    for files, (h, w, _, o) in zip(twins, jobs):
        ref = files["huffman_sequential"]
        full, fused = decode_image(ref), decode_jpeg_i420(ref, INPUT_SIZE, 114, INPUT_SIZE)
        reduced = {f: decode_jpeg_reduced(ref, f) for f in (2, 4, 8)}
        for name, data in files.items():
            check(np.array_equal(decode_image(data), full),
                  f"{name} {h}x{w} decodes otherwise than its Huffman sequential twin")
            check(all(np.array_equal(decode_jpeg_reduced(data, f), r) for f, r in reduced.items()),
                  f"{name} {h}x{w}: a reduced decode differs")
            got = decode_jpeg_i420(data, INPUT_SIZE, 114, INPUT_SIZE)
            check(np.array_equal(got[0], fused[0]) and got[1:] == fused[1:],
                  f"{name} {h}x{w}: the fused decode differs")
            checks["full_reduced_fused"] += 1
    for src, data in lossless:
        want = cmyk_to_rgb(src) if src.shape[2] == 4 else src
        check(np.array_equal(decode_image(data), want),
              f"lossless {src.shape} differs from its plain version")
        check(all(np.array_equal(decode_jpeg_reduced(data, f), want) for f in (2, 4, 8)),
              "a reduced lossless decode is not the full image")
        check(raises_value_error(lambda: decode_jpeg_i420(data, INPUT_SIZE, 114, INPUT_SIZE)),
              "the fused decode took a lossless file")
        checks["lossless_full_reduced_fused"] += 1

    # (b) decode ms at full size, each kind against its Huffman twin (1 thread)
    times = {}
    for files, (h, w, _, o) in zip(twins, jobs):
        if o == 1:
            times[f"{h}x{w}"] = {f"{k}_ms": 1e3 * host_s(lambda d=d: decode_image(d), reps=5)
                                 for k, d in files.items()}
    for src, data in lossless:
        key = f"{src.shape[0]}x{src.shape[1]}"
        tag = "lossless_cmyk_ms" if src.shape[2] == 4 else "lossless_rgb_ms"
        times.setdefault(key, {})[tag] = 1e3 * host_s(lambda d=data: decode_image(d), reps=5)
        times[key][tag.replace("_ms", "_bytes")] = len(data)
    del twins

    # (c) the detection dataset, four ways
    t0 = time.perf_counter()
    roots = {}
    for enc in ("baseline", "arithmetic", "lossless", "bmp"):
        roots[enc] = write_jpeg_detection_dataset(
            os.path.join(workdir, f"rare_{enc}"), RARE_SHAPES, seed=SEED + 21,
            num_classes=NUM_CLASSES, workers=os.cpu_count() or 1, encoding=enc,
            orientations=RARE_ORIENTATIONS if enc in ("baseline", "arithmetic") else None)
    data_s = time.perf_counter() - t0
    ds = {enc: DetectionDataset(r, "val") for enc, r in roots.items()}
    for a, b in (("arithmetic", "baseline"), ("lossless", "bmp")):
        check(all(np.array_equal(imread_rgb(ds[a].image_path(i)),
                                 imread_rgb(ds[b].image_path(i))) for i in range(len(ds[a]))),
              f"imread_rgb: the {a} files differ from the {b} ones")
    checks["imread_rgb"] = 2 * len(RARE_SHAPES)
    decode_img_s = {}
    for enc in ("baseline", "arithmetic", "lossless"):
        datas = [open(ds[enc].image_path(i), "rb").read() for i in range(len(ds[enc]))]
        t0 = time.perf_counter()
        for d in datas:
            decode_image(d)
        decode_img_s[f"{enc}_1_thread"] = len(datas) / (time.perf_counter() - t0)
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(decode_image, datas[:8]))
            t0 = time.perf_counter()
            list(pool.map(decode_image, datas))
            decode_img_s[f"{enc}_4_threads"] = len(datas) / (time.perf_counter() - t0)
    loader_img_s = {}
    for enc, d in ds.items():  # the loader alone: predict_dataset's, at fast_decode
        fast = copy.copy(d)
        fast.decode_size = INPUT_SIZE
        loader = det._loader(fast, 1, RARE_WORKERS, "process")
        try:
            t0 = time.perf_counter()
            n = sum(b["num_real"] for b in loader.epoch(0))
            loader_img_s[enc] = n / (time.perf_counter() - t0)
        finally:
            loader.close()
    runs, launches = {}, {}
    with recorded_nms_inputs() as recorded:
        for tag, enc in (("rare_jpeg_predict_dataset_arith", "arithmetic"),
                         ("rare_jpeg_predict_dataset_lossless", "lossless"),
                         ("baseline", "baseline"), ("bmp", "bmp")):
            out, sec, n = counted_launches(lambda e=enc: list(det.predict_dataset(
                ds[e], fast_decode=True, num_workers=RARE_WORKERS)))
            runs[tag] = {"results": out, "img_s": len(out) / sec}
            if tag.startswith("rare_"):
                launches[tag] = n
        check(same_detections(runs["rare_jpeg_predict_dataset_arith"]["results"],
                              runs["baseline"]["results"]),
              "predict_dataset on the arithmetic files differs from the baseline files'")
        check(same_detections(runs["rare_jpeg_predict_dataset_lossless"]["results"],
                              runs["bmp"]["results"]),
              "predict_dataset on the lossless files differs from the BMP files'")
        n_boxes = sum(len(r["boxes"])
                      for r, _ in runs["rare_jpeg_predict_dataset_arith"]["results"])
        check(n_boxes > 0 and all(np.isfinite(r["boxes"]).all() for tag in runs
                                  for r, _ in runs[tag]["results"]), "no or non-finite detections")
        # the jpeg -> boxes i420 path (fused decode) on the arithmetic files
        det_i420 = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=DECODE_BATCH,
                            input_format="i420", device=dev)
        list(det_i420.predict_dataset(_Subset(ds["baseline"], DECODE_BATCH), fast_decode=True))
        i420 = {}
        for enc in ("arithmetic", "baseline"):
            det_i420.i420_fallbacks = 0
            out, sec, n = counted_launches(lambda e=enc: list(det_i420.predict_dataset(
                ds[e], fast_decode=True, num_workers=RARE_WORKERS)))
            i420[enc] = {"results": out, "img_s": len(out) / sec,
                         "fallbacks": det_i420.i420_fallbacks}
            if enc == "arithmetic":
                launches["rare_jpeg_i420_predict_dataset_arith"] = n
        check(same_detections(i420["arithmetic"]["results"], i420["baseline"]["results"])
              and i420["arithmetic"]["fallbacks"] == 0,
              "the i420 path on the arithmetic files differs from the baseline files'")
        del det_i420
        # serving: an arithmetic, a lossless and a YCbCr-tagged lossless request
        bodies = {"arithmetic": open(ds["arithmetic"].image_path(1), "rb").read(),
                  "lossless": open(ds["lossless"].image_path(2), "rb").read(),
                  "lossless_ycbcr": open(os.path.join(FIXTURES, "lossless_ycbcr_p1_21x30.jpg"),
                                         "rb").read()}
        service = VisionService(det)
        port = free_port()
        server = make_server(service, "127.0.0.1", port)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            answers, _, launches["rare_jpeg_serve"] = counted_launches(
                lambda: {k: _http(port, "POST", "/predict", b) for k, b in bodies.items()})
        finally:
            server.batcher.shutdown()
            server.shutdown()
            server.server_close()
        statuses = {k: a[0] for k, a in answers.items()}
        check(statuses == {"arithmetic": 200, "lossless": 200, "lossless_ycbcr": 400},
              f"serving answered {statuses}")
        for k in ("arithmetic", "lossless"):
            # on a thread of its own, as the batcher runs it: OpenMP's intra-op
            # thread count is each thread's, and the host letterbox's float
            # resize rounds some pixels otherwise on another count
            img, want = decode_image(bodies[k]), []
            ref = threading.Thread(target=lambda: want.append(
                service._to_json(det.predict_batch([img])[0])))
            ref.start()
            ref.join()
            check(json.loads(answers[k][1]) == want[0] and len(want[0]["detection_scores"]) > 0,
                  f"serving's {k} answer differs from predict_batch on the decoded image")
        fresh: list = []
        probe = threading.Thread(target=lambda: fresh.append(torch.get_num_threads()))
        probe.start()
        probe.join()
        intra_op = {"main_thread": torch.get_num_threads(), "fresh_thread": fresh[0]}
    kernel = kernel_vs_plain_recorded(recorded)
    check(all(n > 0 for n in launches.values()), f"a rare-JPEG path launched no NMS: {launches}")
    return {"twins": {"kinds": [list(k[0]) + [k[1]] for k in kinds], "encode_s": encode_s,
                      "checks": dict(checks)},
            "decode_ms_1_thread": times, "dataset_decode_img_s": decode_img_s,
            "dataset": {"images": len(RARE_SHAPES), "write_s": data_s,
                        "loader_img_s_4_process_workers": loader_img_s,
                        "predict_dataset_img_s": {k: r["img_s"] for k, r in runs.items()},
                        "i420_predict_dataset_img_s": {k: r["img_s"] for k, r in i420.items()},
                        "detections": n_boxes},
            "serve_statuses": statuses, "intra_op_threads": intra_op, "launches": launches,
            "kernel_vs_plain": kernel,
            "seconds": time.perf_counter() - t_block}


# ---------------------------------------------------------------------------
# Every image and video read as the JAX package's cv2 calls read them, with
# cv2 importable: the committed cv2-parity files on each route, the loaders,
# predict_dataset (rgb and i420), serving; the videos the port hands to cv2
# through load_clip, the video loader into SlowFast and predict_video
# ---------------------------------------------------------------------------
CV2_IMAGES = os.path.join(FIXTURES, "cv2_parity")
CV2_VIDEOS = os.path.join(VIDEO_FIXTURES, "cv2")
CV2_WORKERS = 4
CV2_PREDICT_VIDEO = "x264_kinetics_340x256.mp4"


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _cv2_image_routes(path: str, data: bytes, target: int, size: int) -> dict:
    """The port's image on each route: an array, (array, orig) on the
    reduced route, the fused tuple / None, or the exception raised."""
    from fastvision_tpu_torch.data.dataset import imread_rgb

    def call(fn):
        try:
            return fn()
        except (ValueError, NotImplementedError) as e:
            return e

    return {"memory": call(lambda: decode_image(data)), "file": call(lambda: imread_rgb(path)),
            "reduced": call(lambda: imread_rgb_scaled(path, target)),
            "fused": call(lambda: decode_jpeg_i420(data, size, 114, size))}


def check_cv2_parity_images(cv2) -> dict:
    """(a) The 32 committed cv2-parity files on the memory, file, reduced
    and fused routes. The port's own decoders (JPEG, BMP, PNG) must give
    the digests the JAX package's calls gave where its manifest was written,
    and raise where those gave no image; the files handed to cv2 must equal
    this machine's ``cv2.imdecode`` / ``cv2.imread`` (their digests against
    the manifest are counted, not gated: the card's cv2 build may differ).
    With ``import cv2`` blocked the own kinds give the same pixels and the
    others raise NotImplementedError naming item 11. Then decode ms per
    image by kind and route on one thread."""
    with open(os.path.join(CV2_IMAGES, "manifest.json")) as f:
        manifest = json.load(f)
    target, size = manifest["reduce_target"], manifest["fused_size"]
    checked, cv2_match, cv2_differ = collections.Counter(), [], []
    for e in manifest["files"]:
        path = os.path.join(CV2_IMAGES, e["file"])
        with open(path, "rb") as f:
            data = f.read()
        got = _cv2_image_routes(path, data, target, size)
        for route in ("memory", "file", "reduced"):
            want, out = e["routes"][route], got[route]
            if want is None:
                check(isinstance(out, ValueError), f"{e['file']} {route}: {out!r} (JAX: None)")
                continue
            check(not isinstance(out, Exception), f"{e['file']} {route}: {out!r}")
            img = out[0] if route == "reduced" else out
            if e["kind"] == "cv2":
                ref = (cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
                       if route == "memory" else cv2.imread(path, cv2.IMREAD_COLOR))
                check(np.array_equal(img, ref[..., ::-1]), f"{e['file']} {route}: not cv2's")
                (cv2_match if _sha(img) == want["sha256"] else cv2_differ).append(
                    f"{e['file']}:{route}")
            else:
                check([list(img.shape), _sha(img)] == [want["shape"], want["sha256"]],
                      f"{e['file']} {route}: the pixels differ from the JAX call's")
                if route == "reduced":
                    check(list(out[1]) == want["orig"], f"{e['file']}: reduced original size")
            checked[route] += 1
        want, out = e["routes"]["fused"], got["fused"]
        if want is None:
            check(isinstance(out, ValueError), f"{e['file']} fused: {out!r} (JAX raises)")
        elif want == "fallback":
            check(out is None, f"{e['file']} fused: not the plain chain's")
        else:
            check((_sha(out[0]), out[1], list(out[2]), list(out[3]), list(out[4])) == (
                want["sha256"], want["scale"], want["pads"], want["orig"], want["decoded"]),
                f"{e['file']} fused: differs from the JAX package's")
        checked["fused"] += 1
        with cv2_blocked():
            blocked = _cv2_image_routes(path, data, target, size)
        for route in ("memory", "file", "reduced"):
            b, out = blocked[route], got[route]
            if e["kind"] == "cv2":
                check(isinstance(b, NotImplementedError) and "item 11" in str(b),
                      f"{e['file']} {route} without cv2: {b!r}")
            elif isinstance(out, Exception):
                check(type(b) is type(out), f"{e['file']} {route} without cv2: {b!r}")
            else:
                pair = zip(b, out) if route == "reduced" else [(b, out)]
                check(all(np.array_equal(x, y) for x, y in pair),
                      f"{e['file']} {route}: other pixels without cv2")
        checked["without_cv2"] += 1
    from fastvision_tpu_torch.data.dataset import imread_rgb

    times = collections.defaultdict(dict)
    for kind in ("jpeg", "bmp", "png", "cv2"):
        files = [e for e in manifest["files"] if e["kind"] == kind]
        for route in ("memory", "file"):
            paths = [os.path.join(CV2_IMAGES, e["file"]) for e in files
                     if e["routes"][route] is not None]
            datas = [open(path, "rb").read() for path in paths]
            fn = (lambda: [decode_image(d) for d in datas]) if route == "memory" else \
                (lambda: [imread_rgb(path) for path in paths])
            times[kind][f"{route}_ms_per_image"] = 1e3 * host_s(fn, reps=5) / max(len(paths), 1)
    return {"files": len(manifest["files"]), "checked": dict(checked),
            "cv2_kinds_equal_to_manifest": len(cv2_match), "cv2_kinds_other_than_manifest":
            cv2_differ, "decode_ms_1_thread": dict(times)}


def _cv2_parity_dataset(root: str, exclude=()) -> DetectionDataset:
    """The cv2-parity files as a detection dataset (one box each): JPEG,
    BMP and PNG under their names, the formats only cv2 decodes under
    ``.jpg`` (misnamed, as scraped files often are)."""
    with open(os.path.join(CV2_IMAGES, "manifest.json")) as f:
        manifest = json.load(f)
    images, labels = os.path.join(root, "val", "images"), os.path.join(root, "val", "labels")
    os.makedirs(images)
    os.makedirs(labels)
    for k, e in enumerate(manifest["files"]):
        if e["file"] in exclude:
            continue
        stem, ext = os.path.splitext(e["file"])
        shutil.copy(os.path.join(CV2_IMAGES, e["file"]),
                    os.path.join(images, stem + (ext if e["kind"] != "cv2" else ".jpg")))
        with open(os.path.join(labels, stem + ".txt"), "w") as f:
            f.write(f"{k % NUM_CLASSES} 2 3 20 18\n")
    return DetectionDataset(root, "val")


def cv2_parity_images(dev, det: Detector, model: YOLOv3, anchors: np.ndarray,
                      workdir: str) -> dict:
    """(b) The cv2-parity files as a dataset: the DetectionLoader on 4
    process workers byte-equal to the serial loader (img/s), YOLOv3-416
    ``predict_dataset`` (bf16, batch 8) equal to the same pixels written as
    BMP, the i420 route (the fused decode; the other formats through their
    plain chain, counted as fallbacks) on the files its JAX counterpart
    decodes, and ``VisionService`` answering 200 where cv2.imdecode gives
    an image (equal to ``predict_batch`` on it) and 400 where it gives
    None. Every NMS launch counted and held against the plain version."""
    import threading

    from fastvision_tpu_torch.data.dataset import imread_rgb, write_bmp
    from fastvision_tpu_torch.infer import VisionService, make_server

    with open(os.path.join(CV2_IMAGES, "manifest.json")) as f:
        manifest = json.load(f)
    ds = _cv2_parity_dataset(os.path.join(workdir, "cv2_parity"))
    bmp_root = os.path.join(workdir, "cv2_parity_bmp")
    os.makedirs(os.path.join(bmp_root, "val", "images"))
    shutil.copytree(ds.labels_dir, os.path.join(bmp_root, "val", "labels"))
    for i in range(len(ds)):
        write_bmp(os.path.join(bmp_root, "val", "images", ds.ids[i] + ".bmp"),
                  imread_rgb(ds.image_path(i)))
    bmp = DetectionDataset(bmp_root, "val")
    serial = [b["images"] for b in det._loader(ds, 1, 0).epoch(0)]
    pooled_loader = det._loader(ds, 1, CV2_WORKERS, "process")
    try:
        pooled = [b["images"] for b in pooled_loader.epoch(0)]
        t0 = time.perf_counter()
        n = sum(b["num_real"] for b in pooled_loader.epoch(1))
        loader_img_s = n / (time.perf_counter() - t0)
    finally:
        pooled_loader.close()
    check(len(serial) == len(pooled) and all(np.array_equal(a, b) for a, b in zip(serial, pooled)),
          "the pooled DetectionLoader differs from the serial one on the cv2-parity files")
    launches = {}
    with recorded_nms_inputs() as recorded:
        runs = {}
        for tag, d in (("cv2_parity_predict_dataset", ds), ("bmp", bmp)):
            out, sec, nl = counted_launches(lambda d=d: list(det.predict_dataset(
                d, fast_decode=True, num_workers=CV2_WORKERS)))
            runs[tag] = {"results": out, "img_s": len(out) / sec}
            if tag != "bmp":
                launches[tag] = nl
        check(len(runs["bmp"]["results"]) == len(ds) and same_detections(
            runs["cv2_parity_predict_dataset"]["results"], runs["bmp"]["results"]),
            "predict_dataset on the cv2-parity files differs from the same pixels as BMP")
        fused_raises = [e["file"] for e in manifest["files"] if e["routes"]["fused"] is None]
        i420_ds = _cv2_parity_dataset(os.path.join(workdir, "cv2_parity_i420"), fused_raises)
        det_i420 = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=DECODE_BATCH,
                            input_format="i420", device=dev)
        det_i420.i420_fallbacks = 0
        out, sec, launches["cv2_parity_i420_predict_dataset"] = counted_launches(
            lambda: list(det_i420.predict_dataset(i420_ds, fast_decode=True,
                                                  num_workers=CV2_WORKERS)))
        fallbacks = det_i420.i420_fallbacks
        want_fallbacks = sum(1 for e in manifest["files"] if e["routes"]["fused"] == "fallback")
        check(len(out) == len(i420_ds) and fallbacks == want_fallbacks
              and all(np.isfinite(r["boxes"]).all() for r, _ in out),
              f"the i420 route on the cv2-parity files: {len(out)} results, {fallbacks} fallbacks")
        i420 = {"images": len(out), "img_s": len(out) / sec, "fallbacks": fallbacks,
                "left_out_as_the_jax_fused_decode_raises": fused_raises}
        del det_i420
        bodies = {e["file"]: open(os.path.join(CV2_IMAGES, e["file"]), "rb").read()
                  for e in manifest["files"]}
        service = VisionService(det)
        port = free_port()
        server = make_server(service, "127.0.0.1", port)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            answers, _, launches["cv2_parity_serve"] = counted_launches(
                lambda: {k: _http(port, "POST", "/predict", b) for k, b in bodies.items()})
        finally:
            server.batcher.shutdown()
            server.shutdown()
            server.server_close()
        statuses = {e["file"]: answers[e["file"]][0] for e in manifest["files"]}
        want_status = {e["file"]: 200 if e["routes"]["memory"] else 400 for e in manifest["files"]}
        check(statuses == want_status, f"serving answered {statuses}")
        for name in [n for n, st in statuses.items() if st == 200][::8]:
            img, want = decode_image(bodies[name]), []
            ref = threading.Thread(target=lambda: want.append(
                service._to_json(det.predict_batch([img])[0])))
            ref.start()
            ref.join()
            check(json.loads(answers[name][1]) == want[0],
                  f"serving's {name} answer differs from predict_batch on the decoded image")
    kernel = kernel_vs_plain_recorded(recorded)
    check(all(nl > 0 for nl in launches.values()), f"a cv2-parity path launched no NMS: {launches}")
    return {"images": len(ds), "loader_img_s_4_process_workers": loader_img_s,
            "predict_dataset_img_s": runs["cv2_parity_predict_dataset"]["img_s"],
            "detections": sum(len(r["boxes"]) for r, _ in runs["bmp"]["results"]),
            "i420": i420, "serve_statuses": collections.Counter(statuses.values()),
            "launches": launches, "kernel_vs_plain": kernel}


def _cv2_frames(cv2, path: str) -> list[np.ndarray]:
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(bgr[..., ::-1]))
    cap.release()
    return frames


def _cv2_clip(cv2, path: str, rng) -> np.ndarray:
    """load_clip's rule on this machine's VideoCapture directly: the
    sampled frames by seek + read, a frame that does not read repeating the
    last, resized by ``resize_bilinear``."""
    cap = cv2.VideoCapture(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    frames, last = [], None
    for i in np.sort(sample_indices(total, VID_T, "average", rng)):
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, bgr = cap.read()
        frame = resize_bilinear(np.ascontiguousarray(bgr[..., ::-1]), VID_SIZE, VID_SIZE) \
            if ok else last
        frames.append(frame)
        last = frame
    cap.release()
    return np.stack(frames)


def cv2_parity_videos(cv2, slowfast, dev, eval_step, det: Detector, workdir: str) -> dict:
    """(c) The videos the port hands to cv2 (the refused MPEG-4 files;
    H.264 at Kinetics' shape, XviD in Matroska, VP9 in WebM): ``reader``
    printed, every frame equal to this machine's ``cv2.VideoCapture`` read
    loop (digests against the manifest counted, not gated), ``load_clip``
    (32 x 224) equal to its rule run on VideoCapture directly, the files as
    a folder through ``VideoClipLoader`` (4 process workers) into the
    full-width SlowFast-R50 eval step (NMS launches: 0), and
    ``predict_video`` (YOLOv3-416) on the H.264 clip equal to
    ``predict_batch`` on VideoCapture's frames, its NMS launches counted
    and held against the plain version."""
    with open(os.path.join(CV2_VIDEOS, "manifest.json")) as f:
        videos = json.load(f)["videos"]
    readers, digests_equal, frames_total = {}, 0, 0
    for e in videos:
        path = os.path.join(CV2_VIDEOS, e["file"])
        video = avi.open_video(path)
        readers[e["file"]] = video.reader
        got, want = list(video.frames()), _cv2_frames(cv2, path)
        video.release()
        check(video.reader == "cv2" and len(got) == len(want) > 0
              and all(np.array_equal(a, b) for a, b in zip(got, want)),
              f"{e['file']}: the frames differ from VideoCapture's")
        digests_equal += [_sha(f) for f in got] == e["rgb_sha256"]
        frames_total += len(got)
        check(np.array_equal(load_clip(path, VID_T, "average", VID_SIZE, np.random.default_rng(SEED)),
                             _cv2_clip(cv2, path, np.random.default_rng(SEED))),
              f"{e['file']}: load_clip differs from VideoCapture's seeks")
    root = os.path.join(workdir, "cv2_videos")
    for k, e in enumerate(videos):
        d = os.path.join(root, "val", f"class_{k % 4:03d}")
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(CV2_VIDEOS, e["file"]), os.path.join(d, e["file"]))
    ds = VideoFolderDataset(root, "val")
    state = type("State", (), {"model": slowfast})()
    ld = VideoClipLoader(ds, num_frames=VID_T, size=VID_SIZE, batch_size=VID_BATCH,
                         strategy="average", train=False, seed=SEED, num_workers=CV2_WORKERS,
                         worker_backend="process")
    try:
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        batches = [{k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
                    for k, v in b.items()} for b in ld.epoch(0)]
        logits = [eval_step(state, b) for b in batches]
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        slowfast_launches = suppression_mask_cuda.launches
    finally:
        ld.close()
    check(sum(int(b["num_real"]) for b in batches) == len(ds) and all(
        tuple(x.shape) == (VID_BATCH, VID_CLASSES) and bool(torch.isfinite(x.float()).all())
        for x in logits), "SlowFast eval on the cv2 videos")
    path = os.path.join(CV2_VIDEOS, CV2_PREDICT_VIDEO)
    frames, seen = _cv2_frames(cv2, path), []
    with recorded_nms_inputs() as recorded:
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        n = det.predict_video(path, frame_callback=lambda rgb, res: seen.append(res))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = suppression_mask_cuda.launches
    check(n == len(seen) == len(frames), f"predict_video processed {n} of {len(frames)} frames")
    want = [r for i in range(0, n, DECODE_BATCH) for r in det.predict_batch(frames[i:i + DECODE_BATCH])]
    check(all(all(np.array_equal(a[k], b[k]) for k in ("boxes", "scores", "classes"))
              for a, b in zip(seen, want)),
          "predict_video's results on the H.264 clip differ from predict_batch")
    held = kernel_vs_plain_recorded(recorded)
    check(held["mismatches"] == 0 and launches == held["calls"] == -(-n // DECODE_BATCH),
          f"predict_video (H.264): {launches} launches, {held}")
    return {"videos": len(videos), "readers": readers, "frames": frames_total,
            "videos_equal_to_manifest_digests": digests_equal,
            "slowfast": {"clips": len(ds), "loader_eval_s": eval_s, "launches": slowfast_launches},
            "predict_video": {"file": CV2_PREDICT_VIDEO, "frames": n, "fps": n / seconds,
                              "launches": launches, "nms_vs_plain": held},
            "launches": {"cv2_parity_predict_video": launches,
                         "video_clip_loader_slowfast_eval_cv2": slowfast_launches},
            "mismatches": held["mismatches"]}


def cv2_parity(dev, det: Detector, model: YOLOv3, anchors: np.ndarray, slowfast, eval_step,
               workdir: str) -> dict:
    """Every image and video read as the JAX package's cv2 calls read them,
    with cv2 importable (the card's host has it): (a) - (c) above."""
    t0 = time.perf_counter()
    try:
        import cv2
    except ImportError:
        check(False, "cv2 does not import on this machine: the cv2-parity block needs it")
    images = check_cv2_parity_images(cv2)
    paths = cv2_parity_images(dev, det, model, anchors, workdir)
    videos = cv2_parity_videos(cv2, slowfast, dev, eval_step, det, workdir)
    return {"cv2": cv2.__version__, "images": images, "dataset": paths, "videos": videos,
            "launches": {**paths["launches"], **videos["launches"]},
            "mismatches": paths["kernel_vs_plain"]["mismatches"] + videos["mismatches"],
            "seconds": time.perf_counter() - t0}


def phase_decode(dev: torch.device, smi: str, workdir: str) -> dict:
    """The decode leftovers, with no cv2 call: the corpus, the
    progressive twins of bench.py's JPEG corpus, their times, and a
    640 x 480 MJPEG AVI through load_clip, VideoFolderDataset, a
    VideoClipLoader feeding SlowFast-R50's eval step and
    Detector.predict_video (YOLOv3-416), without and with ``out_path``
    (`predict_video_writer`, whose file the port reads back); then MPEG-4
    Part 2: the committed fixtures against FFmpeg, decode frames/s,
    SlowFast-R50 on the MPEG-4 clips and predict_video on the XviD one."""
    t_phase = time.perf_counter()
    corpus = check_decode_corpus()

    # (b) bench.py's corpus recipe, progressive and sequential from the same coefficients
    t0 = time.perf_counter()
    jobs = [(h, w, SEED * 100003 + i, o)
            for i, ((h, w), o) in enumerate(zip(DECODE_SHAPES, DECODE_ORIENTATIONS))]
    twins = _pool_map(_decode_twins, jobs)
    encode_s = time.perf_counter() - t0
    pair_checks = collections.Counter()
    for (base, prog), (h, w, _, o) in zip(twins, jobs):
        check(prog[prog.index(b"\xff\xc2"):][:2] == b"\xff\xc2", "not a progressive file")
        check(np.array_equal(decode_image(prog), decode_image(base)),
              f"progressive {h}x{w} decodes otherwise than its sequential twin")
        a, b = decode_jpeg_i420(prog, INPUT_SIZE, 114, INPUT_SIZE), \
            decode_jpeg_i420(base, INPUT_SIZE, 114, INPUT_SIZE)
        check(np.array_equal(a[0], b[0]) and a[1:] == b[1:], f"fused decode differs at {h}x{w}")
        pair_checks["full_and_fused"] += 1
        if max(h, w) > 640:
            for f in (2, 4, 8):
                check(np.array_equal(decode_jpeg_reduced(prog, f), decode_jpeg_reduced(base, f)),
                      f"1/{f} decode differs at {h}x{w}")
            pair_checks["reduced_2_4_8"] += 1

    # (c) progressive against sequential decode times (full size, 1 and 4 threads)
    from concurrent.futures import ThreadPoolExecutor

    manifest = {e["file"]: e["data"] for e in codec_fixtures()[0]}
    times = {}
    for h, w in ((480, 640), (640, 480), (375, 500), (720, 1280)):
        row = {}
        for kind, name in (("sequential", f"full_{h}x{w}.jpg"), ("progressive", f"prog_full_{h}x{w}.jpg")):
            data = manifest[name]
            row[f"{kind}_ms"] = 1e3 * host_s(lambda: decode_image(data), reps=20)
            row[f"{kind}_fused_i420_ms"] = 1e3 * host_s(
                lambda: decode_jpeg_i420(data, INPUT_SIZE, 114, INPUT_SIZE), reps=20)
            row[f"{kind}_bytes"] = len(data)
        times[f"{h}x{w}"] = row
    threads4 = {}
    for kind, k in (("sequential", 0), ("progressive", 1)):
        datas = [t[k] for t in twins]
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(decode_image, datas[:8]))
            t0 = time.perf_counter()
            list(pool.map(decode_image, datas))
            threads4[f"{kind}_img_s"] = len(datas) / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for d in datas[:64]:
            decode_image(d)
        threads4[f"{kind}_1_thread_img_s"] = 64 / (time.perf_counter() - t0)
    del twins

    # (d) a 640 x 480, 64-frame MJPEG AVI
    t0 = time.perf_counter()
    frames_jpeg = _pool_map(_avi_frame, [(t, DECODE_AVI_HW) for t in range(DECODE_AVI_FRAMES)])
    clip_dir = os.path.join(workdir, "decode_video", "val", "class_000")
    os.makedirs(clip_dir)
    path = os.path.join(clip_dir, "clip.avi")
    with open(path, "wb") as f:
        f.write(mjpeg_avi(frames_jpeg, DECODE_AVI_HW[1], DECODE_AVI_HW[0], DECODE_AVI_FPS))
    write_s = time.perf_counter() - t0
    video = avi.open_video(path)
    check(isinstance(video, avi.MJPEGAvi) and video.frame_count == DECODE_AVI_FRAMES
          and video.walk_count() == DECODE_AVI_FRAMES, "the AVI's frame count")
    t0 = time.perf_counter()
    frames = list(avi.open_video(path).frames())
    demux_decode_fps = len(frames) / (time.perf_counter() - t0)
    one_by_one = [decode_image(b) for b in frames_jpeg]
    check(all(np.array_equal(a, b) for a, b in zip(frames, one_by_one)), "AVI frames differ")
    idx = sample_indices(DECODE_AVI_FRAMES, VID_T, "average", np.random.default_rng(SEED))
    clip = load_clip(path, VID_T, "average", VID_SIZE, np.random.default_rng(SEED))
    want = np.stack([resize_bilinear(one_by_one[i], VID_SIZE, VID_SIZE) for i in np.sort(idx)])
    check(np.array_equal(clip, want), "load_clip differs from the frames decoded one by one")
    ds = VideoFolderDataset(os.path.join(workdir, "decode_video"), "val")
    check(ds.clip_length(0) == DECODE_AVI_FRAMES, "VideoFolderDataset's clip length")
    ds_clip, _ = ds.load_clip(0, VID_T, "average", VID_SIZE, np.random.default_rng(SEED))
    check(np.array_equal(ds_clip, clip), "VideoFolderDataset's clip differs from load_clip's")
    loader = VideoClipLoader(ds, num_frames=VID_T, size=VID_SIZE, batch_size=VID_BATCH,
                             strategy="average", train=False, seed=SEED, num_workers=4,
                             worker_backend="process")
    slowfast = vid_model()
    slowfast = slowfast.to(dev, memory_format=memory_format_for(slowfast))
    eval_step = make_eval_step(dtype=torch.bfloat16, imagenet=True)
    state = type("State", (), {"model": slowfast})()
    suppression_mask_cuda.launches = 0
    try:
        t0 = time.perf_counter()
        batches = [{k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
                    for k, v in b.items()} for b in loader.epoch(0)]
        logits = [eval_step(state, b) for b in batches]
        torch.cuda.synchronize()
        loader_eval_s = time.perf_counter() - t0
    finally:
        loader.close()
    slowfast_launches = suppression_mask_cuda.launches
    check(len(batches) == 1 and batches[0]["num_real"] == 1
          and tuple(logits[0].shape) == (VID_BATCH, VID_CLASSES)
          and bool(torch.isfinite(logits[0].float()).all()), "SlowFast eval on the AVI")
    del batches, logits
    # (e) MPEG-4 Part 2 without cv2: the fixtures against FFmpeg, decode speed,
    # SlowFast on the MPEG-4 clips (and predict_video below)
    t_mpeg4 = time.perf_counter()
    with cv2_blocked():
        mpeg4 = {"fixtures": check_mpeg4_fixtures(), "decode_speed": mpeg4_decode_speed(),
                 "slowfast": mpeg4_slowfast(slowfast, dev, eval_step, workdir),
                 "cv2_importable": False}
    mpeg4_s = time.perf_counter() - t_mpeg4

    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    model = yolo_model()
    calibrate_bn_(model.to(dev), normalize_images(
        torch.from_numpy(preprocess_batch(images(SEED, DECODE_BATCH), INPUT_SIZE)[0]),
        torch.float32).to(dev))
    det = Detector(model, anchors, input_size=INPUT_SIZE, batch_size=DECODE_BATCH, device=dev)
    det.predict_video(path, max_frames=DECODE_BATCH)  # warm-up: cuDNN's choices
    seen = []
    with recorded_nms_inputs() as recorded:
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        n = det.predict_video(path, frame_callback=lambda rgb, res: seen.append(res))
        torch.cuda.synchronize()
        predict_video_s = time.perf_counter() - t0
        video_launches = suppression_mask_cuda.launches
    check(n == len(seen) == DECODE_AVI_FRAMES, f"predict_video processed {n} frames")
    want = [r for i in range(0, DECODE_AVI_FRAMES, DECODE_BATCH)
            for r in det.predict_batch(one_by_one[i:i + DECODE_BATCH])]
    same = all(all(np.array_equal(a[k], b[k]) for k in ("boxes", "scores", "classes"))
               for a, b in zip(seen, want))
    check(same, "predict_video's results differ from predict_batch on the same frames")
    kernel = kernel_vs_plain_recorded(recorded)
    check(kernel["mismatches"] == 0, f"nms kernel vs plain on predict_video's inputs: {kernel}")
    check(video_launches == DECODE_AVI_FRAMES // DECODE_BATCH,
          f"predict_video launched the NMS kernel {video_launches} times")
    writer = predict_video_writer(det, path, os.path.join(workdir, "annotated.mp4"))
    t_mpeg4 = time.perf_counter()
    with cv2_blocked():
        mpeg4["predict_video"] = mpeg4_predict_video(det)
    mpeg4["seconds"] = mpeg4_s + time.perf_counter() - t_mpeg4
    with cv2_blocked():
        rare = rare_jpeg(dev, det, model, anchors, workdir)
    parity = cv2_parity(dev, det, model, anchors, slowfast, eval_step, workdir)
    del slowfast
    torch.cuda.empty_cache()
    boxes, scores, iou = recorded[-1]
    keep = suppression_mask_cuda(boxes, scores, iou)
    bound_ms, bound_by, work = nms_bound(boxes, scores, keep)
    nms = {"shape": list(scores.shape),
           "ms": cuda_ms(lambda: suppression_mask_cuda(boxes, scores, iou), reps=50),
           "graph_ms": graph_ms(lambda: suppression_mask_cuda(boxes, scores, iou), reps=50),
           "plain_ms": cuda_ms(lambda: suppression_mask_plain(boxes, scores, iou), reps=3),
           "bound_ms": bound_ms, "bound_by": bound_by, **work}
    detections = sum(len(r["boxes"]) for r in seen)
    out = {"corpus": corpus, "twins": {"images": len(jobs), "checks": dict(pair_checks),
                                       "encode_s": encode_s},
           "decode_times_1_thread": times, "decode_corpus_img_s": threads4,
           "avi": {"frames": DECODE_AVI_FRAMES, "hw": list(DECODE_AVI_HW), "write_s": write_s,
                   "bytes": os.path.getsize(path), "demux_decode_fps": demux_decode_fps,
                   "slowfast_loader_eval_s": loader_eval_s,
                   "predict_video_fps": DECODE_AVI_FRAMES / predict_video_s,
                   "predict_video_s": predict_video_s, "detections": detections},
           "annotated_video": writer["report"], "mpeg4": mpeg4, "rare_jpeg": rare,
           "cv2_parity": parity,
           "nms_kernel_predict_video": nms, "kernel_vs_plain": kernel,
           "launches": {"detector_predict_video": video_launches,
                        "detector_predict_video_out_path": writer["launches"],
                        "detector_predict_video_mpeg4": mpeg4["predict_video"]["launches"],
                        "video_clip_loader_slowfast_eval": slowfast_launches,
                        "video_clip_loader_slowfast_eval_mpeg4": mpeg4["slowfast"]["launches"],
                        **rare["launches"], **parity["launches"]},
           "host_cpus": os.cpu_count(), "seconds": time.perf_counter() - t_phase}
    emit("decode", card=smi, **out)
    del det, model
    torch.cuda.empty_cache()
    return {"launches": out["launches"],
            "zero": ["video_clip_loader_slowfast_eval", "video_clip_loader_slowfast_eval_mpeg4",
                     "video_clip_loader_slowfast_eval_cv2"],
            "mismatches": (kernel["mismatches"] + writer["mismatches"]
                           + mpeg4["predict_video"]["mismatches"]
                           + rare["kernel_vs_plain"]["mismatches"] + parity["mismatches"]),
            "kernel": nms}


PAR_VAL_IMAGES = 32  # one validation batch of 32 per epoch
PAR_EQ_BATCH = 8  # the float32 equality steps at 416
PAR_SMALL_SIZE, PAR_SMALL_BATCH = 256, 8  # (b): a global batch of 8 split 2 ways
PAR_REPS = 6
PAR_TIMEOUT_S = 600
# (d) Faster R-CNN: full width at world size 1 (VOC's 20 classes, 512 px, bf16,
# batch 8, one epoch of 2 steps, one validation batch), and a small float64
# model (the CPU tests' configuration) over two ranks on a global batch of 4
PAR_FRCNN_IMAGES, PAR_FRCNN_VAL, PAR_FRCNN_SIZE, PAR_FRCNN_CLASSES = 16, 8, 512, 20
SMALL_FRCNN = dict(num_classes=3, image_size=128, anchor_scales=(2, 4, 6),
                   rpn_pre_nms_train=128, rpn_post_nms_train=32, rpn_pre_nms_eval=128,
                   rpn_post_nms_eval=16, roi_pos=4, roi_neg=12)
# (e) tensor parallel: YOLOv3-416 at mesh_model=2 (bf16, batch 8, 2 steps, one
# validation batch of 8)
PAR_TP_IMAGES, PAR_TP_VAL, PAR_TP_BATCH = 16, 8, 8
# (f) time sharding: SlowFast-R50 at 32 x 224, 400 classes, mesh_time=2 (bf16,
# batch 2, 2 steps, one validation batch); a small float64 SlowFast at 16 x 64
PAR_VIDEO_CLIPS, PAR_VIDEO_FRAMES, PAR_VIDEO_SIZE, PAR_VIDEO_BATCH = (4, 2), 32, 224, 2
SMALL_SLOWFAST = dict(alpha=4, beta_inv=4, expansion=1, num_classes=5)


def run_children(roles: list, port: int, workdir: str) -> list[dict]:
    """``chip_smoke.py --parallel-child <role> <port> <workdir>`` for each
    role at once; every child must exit 0 (else the smoke fails with its
    stderr). -> each child's result (its JSON file)."""
    procs = []
    for role in roles:
        log = open(os.path.join(workdir, f"{role}.log"), "w")
        procs.append((role, log, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-child", role, str(port),
             workdir], stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    try:
        for role, log, p in procs:
            try:
                rc = p.wait(timeout=PAR_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    failed.append(f"{role} exited {rc}:\n{f.read()[-3000:]}")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(not failed, "parallel child failed: " + "\n".join(failed))
    out = []
    for role in roles:
        with open(os.path.join(workdir, f"{role}.json")) as f:
            out.append(json.load(f))
    return out


def par_loss_parts():
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    return train_parts(anchors)


def par_batch(size: int, n: int, seed: int, dev) -> dict:
    batch = next(iter(DetectionLoader(SyntheticDetectionDataset(n, NUM_CLASSES, seed=seed),
                                      size, n, max_boxes=32, seed=seed)))
    return {k: torch.from_numpy(batch[k]).to(dev) for k in ("images", "labels")}


def par_fit(model, loss_fn, kind: str | None, dtype=torch.float32, ckpt_dir=None) -> Fit:
    """A Fit of ``model`` placed plain (``kind`` None), under DDP or FSDP
    over the process group."""
    from fastvision_tpu_torch.core import create_mesh

    opt = build_optimizer("sgd", model, weight_decay=5e-4, momentum=0.937)
    return Fit(model, loss_fn, opt, None, mesh=create_mesh() if kind else None,
               fsdp=kind == "fsdp", dtype=dtype, ckpt_dir=ckpt_dir, logger=quiet_logger())


def par_state(fit: Fit) -> tuple[dict, dict]:
    """(model state, optimizer state) on the host in the one-process format
    (FSDP's and tensor parallel's gathered)."""
    from fastvision_tpu_torch.parallel import full_state, tensor_shard
    from fastvision_tpu_torch.train.steps import parallel_kind, unwrap

    model = unwrap(fit.state.model)
    if parallel_kind(model) == "fsdp":
        return full_state(model, fit.state.optimizer)
    if tensor_shard.is_tensor_parallel(model):
        model_sd, opt_sd = tensor_shard.full_state(model, fit.state.optimizer)
        return _host_copy_state(model_sd), _host_copy_state(opt_sd)
    return ({k: v.detach().cpu() for k, v in model.state_dict().items()},
            _host_copy_state(fit.state.optimizer.state_dict()))


def _host_copy_state(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _host_copy_state(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_host_copy_state(v) for v in obj]
    return obj


def max_rel_to_std(got: dict, want: dict) -> float:
    """The largest max|got - want| / std(want) over the tensors of ``want``
    (a tensor of zero spread counts its max|d| against 1)."""
    worst = 0.0
    for k, w in want.items():
        if not torch.is_tensor(w) or not w.is_floating_point() or w.numel() < 2:
            continue
        d = float((got[k].double() - w.double()).abs().max())
        worst = max(worst, d / (float(w.double().std()) or 1.0))
    return worst


def darknet_bn_inputs(model: YOLOv3, dev, batch: int) -> list[tuple]:
    """The shape of every BN input of Darknet-53 at INPUT_SIZE and ``batch``."""
    shapes = []
    hooks = [m.register_forward_pre_hook(lambda m, a: shapes.append(tuple(a[0].shape)))
             for m in model.backbone.modules() if isinstance(m, BATCH_NORMS)]
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        model.backbone(torch.zeros(batch, 3, INPUT_SIZE, INPUT_SIZE, device=dev).to(
            memory_format=torch.channels_last))
    for h in hooks:
        h.remove()
    return shapes


def global_bn_times(model: YOLOv3, dev) -> dict:
    """The BN forward + backward over Darknet-53's layers at batch 32, bf16
    input, channels_last: the plain train-mode BN (cuDNN) against
    `GlobalBatchNorm` (its two all-reduces over the one-rank group)."""
    from fastvision_tpu_torch.nn.layers import GlobalBatchNorm

    shapes = darknet_bn_inputs(model, dev, TRAIN_BATCH)
    g = torch.Generator(device=dev).manual_seed(SEED)
    tot = {"plain_ms": 0.0, "global_ms": 0.0}
    for shape in shapes:
        x = torch.randn(shape, device=dev, generator=g).to(
            torch.bfloat16, memory_format=torch.channels_last).requires_grad_(True)
        dy = torch.randn(shape, device=dev, generator=g).to(
            torch.bfloat16, memory_format=torch.channels_last)
        bn = BatchNorm(shape[1]).to(dev).train()

        def plain():
            bn(x).backward(dy)

        def global_bn():
            GlobalBatchNorm.apply(x, bn.weight, bn.bias, bn.eps)[0].backward(dy)

        tot["plain_ms"] += cuda_ms(plain, reps=PAR_REPS)
        tot["global_ms"] += cuda_ms(global_bn, reps=PAR_REPS)
    return {"layers": len(shapes), "batch": TRAIN_BATCH, **tot}


def parallel_world1(port: str, workdir: str) -> dict:
    """The child of (a) and (c): world size 1 over NCCL, full width."""
    from fastvision_tpu_torch import cli
    from fastvision_tpu_torch.core import create_mesh

    os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                      LOCAL_RANK="0")
    dev = torch.device("cuda", 0)
    res: dict = {"launches": {}, "cli": {}}
    mismatches = 0
    root = os.path.join(workdir, "det")
    for kind in ("ddp", "fsdp"):
        ckpt = os.path.join(workdir, f"cli_{kind}")
        with recorded_nms_inputs() as recorded:
            suppression_mask_cuda.launches = 0
            t0 = time.perf_counter()
            fit = cli.main(["train", f"data.data_root={root}", f"data.input_size={INPUT_SIZE}",
                            f"data.batch_size={TRAIN_BATCH}", "train.epochs=2",
                            f"train.ckpt_dir={ckpt}", "multihost=true", "data.host_shard=auto",
                            "mesh_data=1", *(["fsdp=true"] if kind == "fsdp" else [])])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = suppression_mask_cuda.launches
        from fastvision_tpu_torch.train.steps import parallel_kind

        held = kernel_vs_plain_recorded(recorded)
        mismatches += held["mismatches"]
        check(torch.distributed.get_backend() == "nccl"
              and torch.distributed.get_world_size() == 1, "world size 1 over NCCL")
        check(parallel_kind(fit.state.model) == kind, f"cli train placed {kind}?")
        check(fit.train_loader.host_count == 1 and fit.train_loader.host_shard == "auto",
              "host_shard=auto")
        check(fit.global_step == 2 * len(fit.train_loader), f"cli {kind} steps")
        with open(os.path.join(ckpt, "train.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "train_loss" in r]
        check(len(epochs) == 2 and all(np.isfinite(r["train_loss"]) and 0 <= r["map50"] <= 1
                                       for r in epochs), f"cli {kind} epochs {epochs}")
        check(launches > 0 and held["calls"] == launches,
              f"cli {kind}: {launches} launches, {held['calls']} recorded")
        res["launches"][f"parallel_cli_train_{kind}"] = launches
        res["cli"][kind] = {"seconds": seconds, "nms_vs_plain": held, "epochs": [
            {k: r[k] for k in ("epoch", "train_loss", "epoch_img_s", "map50")} for r in epochs]}
        del fit
        shutil.rmtree(ckpt)
        torch.cuda.empty_cache()
    res["mismatches"] = mismatches
    frcnn = par_cli_frcnn(workdir)
    res["launches"]["parallel_cli_train_frcnn"] = frcnn.pop("launches")
    res["mismatches"] += frcnn["nms_vs_plain"]["mismatches"]
    res["cli"]["frcnn"] = frcnn

    # --- the float32 equality checks, TF32 off, deterministic algorithms
    loss_fn, postprocess = par_loss_parts()
    batch = par_batch(INPUT_SIZE, PAR_EQ_BATCH, SEED + 31, dev)
    states = {}
    with no_tf32(), deterministic_algorithms() as nondeterministic:
        for kind in (None, "ddp", "fsdp"):
            ckpt = os.path.join(workdir, "fsdp_ckpt") if kind == "fsdp" else None
            fit = par_fit(yolo_model(), loss_fn, kind, ckpt_dir=ckpt)
            fit.state, m = fit.step_fn(fit.state, batch, 1e-2)
            states[kind] = par_state(fit) + (float(m["loss"]),)
            if kind == "fsdp":
                fit._save(0, {"epoch": 0, "global_step": 1})
                fit.ckpt.wait()
                torch.save(states[kind][:2], os.path.join(workdir, "fsdp_gathered.pt"))
            del fit
            torch.cuda.empty_cache()
    plain, ddp, fsdp = states[None], states["ddp"], states["fsdp"]
    res["equality"] = {
        "model": f"YOLOv3-{INPUT_SIZE}, 80 classes, full width, float32, TF32 off, "
                 f"deterministic, batch {PAR_EQ_BATCH}, one SGD step at lr 1e-2",
        "ddp_bit_equal": same_state(ddp[0], plain[0]) and same_state(ddp[1], plain[1]),
        "ddp_loss": ddp[2], "plain_loss": plain[2], "fsdp_loss": fsdp[2],
        "fsdp_max_rel_to_std": max(max_rel_to_std(fsdp[0], plain[0]), max_rel_to_std(
            {i: s["momentum_buffer"] for i, s in fsdp[1]["state"].items()},
            {i: s["momentum_buffer"] for i, s in plain[1]["state"].items()})),
        "nondeterministic_ops": nondeterministic}
    check(res["equality"]["ddp_bit_equal"], f"DDP step != plain step: {res['equality']}")
    check(res["equality"]["fsdp_max_rel_to_std"] <= 1e-5, f"FSDP step: {res['equality']}")

    # --- (c) times at batch 32, bf16
    times: dict = {}
    batch = par_batch(INPUT_SIZE, TRAIN_BATCH, SEED + 32, dev)
    for kind in (None, "ddp", "fsdp"):
        fit = par_fit(yolo_model(), loss_fn, kind, dtype=torch.bfloat16)
        # 3 warm-ups: DDP rebuilds its buckets in its second step
        s = step_rate(fit.step_fn, fit.state, batch, reps=PAR_REPS, warmup=3)
        times[f"train_img_s_{kind or 'plain'}"] = TRAIN_BATCH / s
        times[f"peak_gb_{kind or 'plain'}"] = torch.cuda.max_memory_allocated() / 1e9
        if kind is None:
            times["global_bn"] = global_bn_times(fit.state.model, dev)  # plain: unwrapped
            val = DetectionLoader(SyntheticDetectionDataset(2 * TRAIN_BATCH, NUM_CLASSES,
                                                            seed=SEED + 33),
                                  INPUT_SIZE, TRAIN_BATCH, max_boxes=32, train=False)
            step = make_eval_step(postprocess, dtype=torch.bfloat16)
            for name, mesh in (("unsharded", None), ("sharded", create_mesh())):
                evaluate = detection_evaluator(step, mesh=mesh)
                evaluate(fit.state, val)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                evaluate(fit.state, val)
                times[f"eval_img_s_{name}"] = 2 * TRAIN_BATCH / (time.perf_counter() - t0)
        del fit
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    res["times"] = times
    res["pipeline"] = pipeline_world1(dev)
    return res


def par_cli_frcnn(workdir: str) -> dict:
    """(d) ``cli.main(["train", "model.name=faster_rcnn", ... "multihost=true",
    "mesh_data=1"])`` at full width (this child's NCCL world of 1): the NMS
    kernel's launches counted and each keep mask held against the plain
    version."""
    from fastvision_tpu_torch import cli
    from fastvision_tpu_torch.train.steps import parallel_kind

    ckpt = os.path.join(workdir, "cli_frcnn")
    with recorded_nms_inputs() as recorded:
        suppression_mask_cuda.launches = 0
        t0 = time.perf_counter()
        fit = cli.main(["train", "model.name=faster_rcnn",
                        f"data.data_root={os.path.join(workdir, 'frcnn')}",
                        f"data.input_size={PAR_FRCNN_SIZE}", f"data.batch_size={TRAIN_BATCH // 4}",
                        f"model.num_classes={PAR_FRCNN_CLASSES}", "train.epochs=1",
                        f"train.ckpt_dir={ckpt}", "multihost=true", "data.host_shard=auto",
                        "mesh_data=1"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = suppression_mask_cuda.launches
    held = kernel_vs_plain_recorded(recorded)
    with open(os.path.join(ckpt, "train.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "train_loss" in r]
    check(parallel_kind(fit.state.model) == "ddp" and fit.global_step == 2,
          f"cli frcnn: {parallel_kind(fit.state.model)}, {fit.global_step} steps")
    check(len(epochs) == 1 and np.isfinite(epochs[0]["train_loss"])
          and 0 <= epochs[0]["map50"] <= 1, f"cli frcnn epochs {epochs}")
    check(launches > 0 and held["calls"] == launches,
          f"cli frcnn: {launches} launches, {held['calls']} recorded")
    del fit
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()
    return {"model": f"FasterRCNN VGG16, {PAR_FRCNN_CLASSES} classes, {PAR_FRCNN_SIZE} px, "
                     f"bf16, batch {TRAIN_BATCH // 4}, {PAR_FRCNN_IMAGES} images, 1 epoch",
            "seconds": seconds, "launches": launches, "nms_vs_plain": held,
            "epochs": [{k: r[k] for k in ("train_loss", "epoch_img_s", "map50")}
                       for r in epochs]}


GLOO_PROBE_OPS = ("all_reduce", "broadcast", "all_gather_into_tensor", "all_gather",
                  "send_recv", "reduce_scatter_tensor")


def gloo_probe(name: str, rank: int, port: str, workdir: str) -> None:
    """A child of `probe_gloo_on_cuda` (role ``probe:<op>:<rank>``): collective
    ``name`` over gloo on CUDA tensors (two ranks on the one card, float32):
    'ok' with a right result, else the error's first line, into
    ``probe_<op>_<rank>.json``. A collective that gloo runs on a device
    pointer can abort the process from gloo's own thread, hence one pair of
    processes per collective."""
    import datetime

    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=20))
    x = torch.full((4,), float(rank + 1), device=dev)
    gather = torch.tensor([1.0] * 4 + [2.0] * 4, device=dev)

    def ar():
        y = x.clone()
        dist.all_reduce(y)
        return y

    def bc():
        y = x.clone()
        dist.broadcast(y, 0)
        return y

    def ag_into():
        y = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(y, x)
        return y

    def ag():
        parts = [torch.empty(4, device=dev) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def sendrecv():
        y = x.clone()
        if rank == 0:
            dist.send(x, 1)
            dist.recv(y, 1)
        else:
            dist.recv(y, 0)
            dist.send(x, 0)
        return y

    def rs():
        y = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(y, torch.arange(4.0, device=dev) + rank)
        return y

    fn, want = {
        "all_reduce": (ar, torch.full((4,), 3.0, device=dev)),
        "broadcast": (bc, torch.full((4,), 1.0, device=dev)),
        "all_gather_into_tensor": (ag_into, gather), "all_gather": (ag, gather),
        "send_recv": (sendrecv, torch.full((4,), float(2 - rank), device=dev)),
        # [0, 1, 2, 3] + [1, 2, 3, 4], halved
        "reduce_scatter_tensor": (rs, torch.tensor([1.0, 3.0], device=dev) + 4.0 * rank),
    }[name]
    try:
        got = fn()
        torch.cuda.synchronize()
        result = "ok" if torch.equal(got, want) else f"wrong result {got.tolist()}"
    except Exception as e:  # noqa: BLE001 - the probe reports what the backend refuses
        result = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    with open(os.path.join(workdir, f"probe_{name}_{rank}.json"), "w") as f:
        json.dump({"result": result}, f)
    sys.stdout.flush()
    os._exit(0)  # a refused collective can leave the group unable to shut down


def probe_gloo_on_cuda(workdir: str) -> dict:
    """Which collectives gloo takes on CUDA tensors: every `GLOO_PROBE_OPS`
    entry in a pair of processes of its own, all pairs at once. ->
    {op: {rank0: ..., rank1: ...}}, a process that died reported with its
    exit code and last line of output."""
    procs = []
    for name in GLOO_PROBE_OPS:
        port = free_port()
        for r in (0, 1):
            log = open(os.path.join(workdir, f"probe_{name}_{r}.log"), "w")
            procs.append((name, r, log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel-child",
                 f"probe:{name}:{r}", str(port), workdir], stdout=log,
                stderr=subprocess.STDOUT)))
    res: dict = {}
    try:
        for name, r, log, p in procs:
            try:
                rc = p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = f"killed after 120 s ({p.wait()})"
            log.close()
            path = os.path.join(workdir, f"probe_{name}_{r}.json")
            if rc == 0 and os.path.exists(path):
                with open(path) as f:
                    res.setdefault(name, {})[f"rank{r}"] = json.load(f)["result"]
            else:
                with open(log.name) as f:
                    lines = [ln for ln in f.read().splitlines() if ln.strip()]
                res.setdefault(name, {})[f"rank{r}"] = (
                    f"process ended {rc}: {lines[-1][:200] if lines else ''}")
    finally:
        for _, _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def mesh_fit(model, loss_fn, mesh, dtype, step_fn=None, **kw) -> Fit:
    opt = kw.pop("optimizer", None) or build_optimizer("sgd", model, weight_decay=5e-4,
                                                       momentum=0.937)
    return Fit(model, loss_fn, opt, None, mesh=mesh, dtype=dtype, step_fn=step_fn,
               logger=quiet_logger(), **kw)


def small_frcnn_step(batch: dict, mesh, dev) -> tuple[dict, dict]:
    """(d) One float64 SGD step (momentum 0.9, clip 10) of the small Faster
    R-CNN, seeded, the step's own draws: (state, metrics)."""
    from fastvision_tpu_torch.core import shard_batch

    model = FasterRCNN(**SMALL_FRCNN, generator=torch.Generator().manual_seed(SEED)).double()
    opt = build_optimizer("sgd", model, momentum=0.9, grad_clip_norm=10.0)
    with no_tf32():
        fit = mesh_fit(model, None, mesh, torch.float64, device=dev, optimizer=opt,
                       step_fn=make_frcnn_train_step(seed=SEED, dtype=torch.float64))
        local = shard_batch(batch, mesh) if mesh is not None else batch
        fit.state, m = fit.step_fn(fit.state, local, 1e-2)
    return par_state(fit)[0], {k: float(v) for k, v in m.items()}


def small_slowfast_step(batch: dict, mesh, dev) -> tuple[dict, dict, torch.Tensor]:
    """(f) One float64 SGD step of the small SlowFast, its frames sharded
    over the time axis when ``mesh`` has one, and its eval forward after:
    (state, metrics, logits)."""
    model = SlowFast((1, 1, 1, 1), **SMALL_SLOWFAST, generator=torch.Generator().manual_seed(
        SEED), time_axis="time" if mesh is not None else None).double()

    def loss_fn(logits, b):
        return cross_entropy(logits, b["labels"]), {}

    with no_tf32():
        fit = mesh_fit(model, loss_fn, mesh, torch.float64, device=dev,
                       step_fn=make_train_step(loss_fn, torch.float64, imagenet=True))
        fit.state, m = fit.step_fn(fit.state, batch, 1e-2)
        logits = make_eval_step(dtype=torch.float64, imagenet=True)(fit.eval_state(), batch)
    return par_state(fit)[0], {k: float(v) for k, v in m.items()}, logits.cpu()


def small_parallel_batches(dev) -> dict:
    """The float64 steps' global batches: 4 images at 128 px for the small
    Faster R-CNN, 2 clips of 16 x 64 x 64 for the small SlowFast."""
    det = next(iter(DetectionLoader(SyntheticDetectionDataset(4, SMALL_FRCNN["num_classes"],
                                                              seed=SEED + 36),
                                    SMALL_FRCNN["image_size"], 4, max_boxes=8, seed=SEED)))
    g = np.random.default_rng(SEED + 37)
    return {"frcnn": {k: torch.from_numpy(det[k]).to(dev) for k in ("images", "labels")},
            "video": {"images": torch.from_numpy(g.integers(0, 256, (2, 16, 64, 64, 3),
                                                            dtype=np.uint8)).to(dev),
                      "labels": torch.tensor([1, 3], device=dev)}}


@contextlib.contextmanager
def logged_records():
    """Every record a `MetricLogger` logs in the block, on every rank (rank 0
    alone writes the file)."""
    real, sink = MetricLogger.log, []

    def log(self, step, **metrics):
        sink.append({"step": step, **{k: float(v) if isinstance(v, (int, float, torch.Tensor))
                                      else v for k, v in metrics.items()}})
        real(self, step, **metrics)

    MetricLogger.log = log
    try:
        yield sink
    finally:
        MetricLogger.log = real


def rank_cli_runs(rank: int, workdir: str) -> dict:
    """(e) ``train`` of YOLOv3-416 at ``mesh_model=2`` and (f) ``train-video``
    of SlowFast-R50 at ``mesh_time=2`` on this rank: NMS launches counted
    (the video path's must be 0) and each keep mask held."""
    from fastvision_tpu_torch import cli
    from fastvision_tpu_torch.parallel import tensor_shard
    from fastvision_tpu_torch.train.steps import unwrap

    res = {}
    for name, args in (
            ("tp", ["train", f"data.data_root={os.path.join(workdir, 'tp')}",
                    f"data.input_size={INPUT_SIZE}", f"data.batch_size={PAR_TP_BATCH}",
                    "mesh_model=2"]),
            ("time", ["train-video", f"data.data_root={os.path.join(workdir, 'video')}",
                      "model.backbone=slowfast_resnet50", "model.num_classes=400",
                      f"data.num_frames={PAR_VIDEO_FRAMES}",
                      f"data.input_size={PAR_VIDEO_SIZE}",
                      f"data.batch_size={PAR_VIDEO_BATCH}", "mesh_time=2"])):
        ckpt = os.path.join(workdir, f"cli_{name}_rank{rank}")
        with recorded_nms_inputs() as recorded, logged_records() as records:
            suppression_mask_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit = cli.main([*args, "train.epochs=1", f"train.ckpt_dir={ckpt}",
                            "data.num_workers=0", "multihost=true"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = suppression_mask_cuda.launches
        held = kernel_vs_plain_recorded(recorded)
        epochs = [r for r in records if "train_loss" in r]
        model = unwrap(fit.state.model)
        check(fit.global_step == 2 and len(epochs) == 1 and np.isfinite(epochs[0]["train_loss"]),
              f"cli {name} on rank {rank}: {fit.global_step} steps, {epochs}")
        check(held["calls"] == launches, f"cli {name}: {launches} launches, {held}")
        if name == "tp":
            check(tensor_shard.is_tensor_parallel(model) and launches > 0,
                  f"cli tp: sharded {tensor_shard.is_tensor_parallel(model)}, "
                  f"{launches} NMS launches")
        else:
            check(model.time_axis == "time" and launches == 0,
                  f"cli time: {model.time_axis}, {launches} NMS launches")
        res[name] = {"seconds": seconds, "launches": launches, "nms_vs_plain": held,
                     "epochs": [{k: r.get(k) for k in ("train_loss", "epoch_img_s", "map50",
                                                       "accuracy")} for r in epochs],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del fit, model
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return res


PIPE_BATCH, PIPE_MICRO, PIPE_REPS = 8, 4, 3  # pipeline runs: 2 stages, 4 microbatches of 2


def pipeline_world1(dev: torch.device) -> dict:
    """(g) at world size 1 over NCCL (the model axis of one rank):
    `pipeline_apply` of a 4-layer tanh chain (one stage, its layers stacked)
    on 8 microbatches bit-equal to the chain applied to each."""
    from fastvision_tpu_torch.core.mesh import Mesh, use_mesh
    from fastvision_tpu_torch.parallel import pipeline_apply

    use_mesh(Mesh(1, 1, 1))
    suppression_mask_cuda.launches = 0
    g = torch.Generator().manual_seed(SEED)
    c = 512
    stacked = {"w": (torch.randn(1, 4, c, c, generator=g) / c ** 0.5).to(dev),
               "b": (0.1 * torch.randn(1, 4, c, generator=g)).to(dev)}
    mbs = torch.randn(8, 64, c, generator=g).to(dev)

    def chain(p, x):
        for w, b in zip(p["w"], p["b"]):
            x = torch.tanh(x @ w + b)
        return x

    y = pipeline_apply(chain, stacked, mbs)
    want = torch.stack([chain({k: v[0] for k, v in stacked.items()}, x) for x in mbs])
    res = {"shape": list(y.shape), "bit_equal": bool(torch.equal(y, want)),
           "backend": torch.distributed.get_backend(),
           "nms_launches": suppression_mask_cuda.launches}
    check(res["bit_equal"] and res["backend"] == "nccl", f"pipeline at world size 1: {res}")
    return res


def _grads(model: torch.nn.Module) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}


def _timed(fn, reps: int) -> float:
    """Seconds a call of ``fn`` (after one warm-up), synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def pipeline_rank(rank: int, dev: torch.device) -> dict:
    """(g) this rank as one stage of a 2-stage model axis (mesh 1 x 2 x 1,
    gloo with CUDA tensors), against this process's plain forward and
    backward of the same model on the same batch:

      - ViT-B/16 at full width (224, 1000 classes, batch 8 in 4
        microbatches) through `pipeline_vit_apply`: in float64 (its trunk,
        ``including_top=False``, with a float64 head: the model's own head
        runs in float32) the tokens' logits and every gradient this rank
        holds (its 6 blocks, the prefix, the final norm) within 1e-12 of
        each tensor's std; in float32 with TF32 off the classifier's
        logits within 1e-5, and its gradients held to the float64
        classifier (float64 trunk, its float32 head) no farther than
        max(1e-5, twice the plain float32 step's own distance);
      - ResNet-50 (BN from the images) through `resnet_stage_split` +
        `pipeline_hetero_apply`, float32, its logits within 1e-5;
      - a small float64 ResNet (BasicBlock, 64 px), logits and gradients
        within 1e-12.

    Each number is max |d| / std of the reference; the pipelined calls'
    seconds and img/s (two ranks sharing the card: gloo's host staging)."""
    from fastvision_tpu_torch.core.mesh import Mesh, use_mesh
    from fastvision_tpu_torch.parallel import (pipeline_hetero_apply, pipeline_vit_apply,
                                               resnet_stage_split)

    mesh = use_mesh(Mesh(1, 2, 1))
    suppression_mask_cuda.launches = 0  # the classifiers' pipelines run no NMS
    g = torch.Generator().manual_seed(SEED + 60)
    res: dict = {"mesh": "1 x 2 x 1 (two gloo ranks on one card)", "rank": rank}
    ce = torch.nn.functional.cross_entropy

    def seeded(factory, **kw):
        return factory(generator=torch.Generator().manual_seed(SEED), **kw)

    def vit_case(model, images, labels, loss_of):
        """-> (max rel of the outputs and the gradients, the pipelined and
        the plain gradients)."""
        loss_of(model(images), labels).backward()
        plain = _grads(model)
        with torch.no_grad():
            plain_out = model(images)
        model.zero_grad(set_to_none=True)
        out = pipeline_vit_apply(model, images, mesh, n_micro=PIPE_MICRO)
        loss_of(out, labels).backward()
        got = _grads(model)
        model.zero_grad(set_to_none=True)
        return ({"out_max_rel": max_rel_to_std({"o": out.detach()}, {"o": plain_out}),
                 "grads_max_rel": max_rel_to_std(got, {n: plain[n] for n in got}),
                 "grads_held": len(got), "grads_in_model": len(plain)}, got, plain)

    images = torch.randn(PIPE_BATCH, 224, 224, 3, generator=g).to(dev)
    labels = torch.randint(0, 1000, (PIPE_BATCH,), generator=g).to(dev)
    trunk = seeded(vit_base_patch16, including_top=False).double().to(dev)
    head = {"w": (0.03 * torch.randn(trunk.dim, 1000, generator=g, dtype=torch.float64)).to(dev),
            "b": (0.1 * torch.randn(1000, generator=g, dtype=torch.float64)).to(dev)}
    r, _, _ = vit_case(trunk, images.double().permute(0, 3, 1, 2).contiguous(), labels,
                       lambda t, lab: ce(t[:, 0] @ head["w"] + head["b"], lab))
    res["vit_b16_trunk_float64"] = r
    del trunk
    # the float64 classifier's gradients (float64 trunk, the model's float32 head)
    ref_model = seeded(vit_base_patch16).double().to(dev)
    ref_model.head.float()
    ce(ref_model(images.double()), labels).backward()
    ref = _grads(ref_model)
    del ref_model
    torch.cuda.empty_cache()
    with no_tf32():
        vit = seeded(vit_base_patch16).to(dev)
        r, got, plain = vit_case(vit, images, labels, ce)
        worst = 0.0
        for n in got:
            pipe_err = max_rel_to_std({n: got[n]}, {n: ref[n]})
            plain_err = max_rel_to_std({n: plain[n]}, {n: ref[n]})
            worst = max(worst, pipe_err / max(1e-5, 2 * plain_err))
        r["vs_float64"] = {"pipelined": max_rel_to_std(got, {n: ref[n] for n in got}),
                           "plain": max_rel_to_std(plain, ref),
                           "worst_over_limit": worst}

        def vit_step():
            ce(pipeline_vit_apply(vit, images, mesh, n_micro=PIPE_MICRO), labels).backward()
            vit.zero_grad(set_to_none=True)

        s = _timed(vit_step, PIPE_REPS)
        res["vit_b16_float32"] = {**r, "fwd_bwd_s": s, "img_s": PIPE_BATCH / s}
        del vit, got, plain, ref
        r50 = seeded(resnet50).to(dev)
        calibrate_bn_(r50, images)
        fns, params = resnet_stage_split(r50, 2)

        def r50_forward():
            return pipeline_hetero_apply(fns, params, images.reshape(
                PIPE_MICRO, -1, *images.shape[1:]), mesh).reshape(PIPE_BATCH, -1)

        with torch.no_grad():
            out = r50_forward()
            want = r50(images)
            s = _timed(r50_forward, PIPE_REPS)
        res["resnet50_float32"] = {"out_max_rel": max_rel_to_std({"o": out}, {"o": want}),
                                   "forward_s": s, "img_s": PIPE_BATCH / s}
        del r50, fns, params
        torch.cuda.empty_cache()
    rn = seeded(ResNet, block_cls=BasicBlock, stage_sizes=(1, 1, 1, 1), num_classes=5)
    rn = rn.double().to(dev)
    x = torch.randn(PIPE_BATCH, 64, 64, 3, generator=g, dtype=torch.float64).to(dev)
    calibrate_bn_(rn, x)
    fns, params = resnet_stage_split(rn, 2)
    out = pipeline_hetero_apply(fns, params, x.reshape(PIPE_MICRO, -1, *x.shape[1:]),
                                mesh).reshape(PIPE_BATCH, -1)
    (out ** 2).sum().backward()
    got = _grads(rn)
    rn.zero_grad(set_to_none=True)
    want = rn(x)
    (want ** 2).sum().backward()
    plain = _grads(rn)
    res["small_resnet_float64"] = {
        "out_max_rel": max_rel_to_std({"o": out.detach()}, {"o": want.detach()}),
        "grads_max_rel": max_rel_to_std(got, {n: plain[n] for n in got}),
        "grads_held": len(got)}
    res["nms_launches"] = suppression_mask_cuda.launches
    torch.cuda.empty_cache()
    return res


def parallel_rank(rank: int, port: str, workdir: str) -> dict:
    """A child of (b): rank ``rank`` of 2 on the one card, gloo with CUDA
    tensors (NCCL refuses two ranks on one device): one float32 step of a
    shallow YOLOv3 on its half of the global batch under DDP."""
    dev = torch.device("cuda", 0)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         rank=rank, world_size=2)
    loss_fn, _ = par_loss_parts()
    from fastvision_tpu_torch.core import create_mesh, shard_batch

    batch_global = par_batch(PAR_SMALL_SIZE, PAR_SMALL_BATCH, SEED + 34, dev)
    batch = shard_batch(batch_global, create_mesh())
    out = {"local_batch": int(batch["images"].shape[0]),
           "backend": torch.distributed.get_backend()}
    for dtype in (torch.float32, torch.float64):
        with no_tf32():
            model = small_yolo(dtype)
            fit = par_fit(model, loss_fn, "ddp", dtype=dtype)
            check(fit.device == dev, f"rank {rank} on {fit.device}")
            fit.state, m = fit.step_fn(fit.state, batch, 1e-2)
        name = str(dtype).split(".")[-1]
        out[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        if rank == 0:
            torch.save(par_state(fit)[0], os.path.join(workdir, f"two_ranks_{name}.pt"))
    del fit, model
    torch.cuda.empty_cache()

    # (d), (e), (f) in float64 against this process's one-process steps
    from fastvision_tpu_torch.core import create_mesh

    batches = small_parallel_batches(dev)
    state, m = small_frcnn_step(batches["frcnn"], create_mesh(2, 1, 1), dev)
    out["frcnn_float64"] = m
    with no_tf32():
        fit = mesh_fit(small_yolo(torch.float64), loss_fn, create_mesh(1, 2, 1), torch.float64)
        fit.state, mt = fit.step_fn(fit.state, batch_global, 1e-2)
    out["tp_float64"] = {"loss": float(mt["loss"]), "grad_norm": float(mt["grad_norm"])}
    tp_state = par_state(fit)[0]
    del fit
    sf_state, ms, logits = small_slowfast_step(batches["video"], create_mesh(1, 1, 2), dev)
    out["time_float64"] = ms
    if rank == 0:
        torch.save({"frcnn": state, "tp": tp_state, "time": sf_state, "time_logits": logits},
                   os.path.join(workdir, "mesh_float64.pt"))
    torch.cuda.empty_cache()
    out["pipeline"] = pipeline_rank(rank, dev)
    out["cli"] = rank_cli_runs(rank, workdir)
    torch.distributed.destroy_process_group()
    return out


def small_yolo(dtype: torch.dtype) -> YOLOv3:
    return YOLOv3(num_classes=NUM_CLASSES, stage_sizes=(1, 1, 1, 1, 1),
                  generator=torch.Generator().manual_seed(SEED)).to(dtype)


def parallel_child(role: str, port: str, workdir: str) -> int:
    torch.cuda.set_device(0)
    if role.startswith("probe:"):
        _, name, rank = role.split(":")
        gloo_probe(name, int(rank), port, workdir)
    out = (parallel_world1(port, workdir) if role == "world1"
           else parallel_rank(int(role[len("rank"):]), port, workdir))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    with open(os.path.join(workdir, f"{role}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_parallel(dev: torch.device, smi: str, workdir: str) -> dict:
    """Data parallel over a process group, in subprocesses (each a fresh TCP
    port): (a) world size 1 over NCCL at full width: ``cli.main(["train",
    ... "multihost=true", "data.host_shard=auto", "mesh_data=1"])``
    (YOLOv3-416, 80 classes, bf16, batch 32, 2 epochs over 64 images,
    validated by the sharded ``detection_evaluator`` with the NMS kernel's
    launches counted and every keep mask held against the plain version),
    once under DDP and once with ``fsdp=true``; one float32 step (TF32 off,
    deterministic) under DDP bit-equal to the plain ``Fit`` step, under
    FSDP within 1e-5 of each tensor's std, and the FSDP checkpoint restored
    here (a process without a group) bit-equal to the gathered state;
    (b) two ranks on the one card (gloo with CUDA tensors): one float32 step
    of a shallow YOLOv3 (80 classes, 256 px) on a global batch of 8 split 2
    ways, in float64 against this process's float64 step on the whole batch
    within 1e-5 (kernels of their std, the tensors that start constant, BN
    running statistics included, of max(std, their update)), and in float32
    against the same float64 step within phase train's card-vs-CPU limits
    (float32's own distance from float64, ~1e-5 of a kernel's std, is at the
    1e-5 limit; the one-process float32 step's is reported beside it);
    (c) times at world
    size 1 (bf16, batch 32): train img/s plain, DDP and FSDP, the global BN's
    forward + backward against the plain BN's over Darknet-53's layers, and
    the evaluator's img/s sharded and unsharded."""
    t_phase = time.perf_counter()
    root = os.path.join(workdir, "parallel")
    write_detection_dataset(os.path.join(root, "det"), TRAIN_IMAGES, sizes=SIZES,
                            seed=SEED + 30, num_classes=NUM_CLASSES, splits=("train",))
    write_detection_dataset(os.path.join(root, "det"), PAR_VAL_IMAGES, sizes=SIZES,
                            seed=SEED + 35, num_classes=NUM_CLASSES, splits=("val",))
    for name, n, val, classes in (("frcnn", PAR_FRCNN_IMAGES, PAR_FRCNN_VAL, PAR_FRCNN_CLASSES),
                                  ("tp", PAR_TP_IMAGES, PAR_TP_VAL, NUM_CLASSES)):
        write_detection_dataset(os.path.join(root, name), n, sizes=SIZES, seed=SEED + 38,
                                num_classes=classes, splits=("train",))
        write_detection_dataset(os.path.join(root, name), val, sizes=SIZES, seed=SEED + 39,
                                num_classes=classes, splits=("val",))
    write_video_dataset(os.path.join(root, "video"), PAR_VIDEO_CLIPS, num_classes=4,
                        frames=PAR_VIDEO_FRAMES, seed=SEED + 40)
    torch.cuda.empty_cache()
    (a,) = run_children(["world1"], free_port(), root)
    emit("parallel_world1", card=smi, **a)

    # the FSDP checkpoint, restored in this process (no group), against the gathered state
    gathered_model, gathered_opt = torch.load(os.path.join(root, "fsdp_gathered.pt"),
                                              weights_only=False)
    restored = CheckpointManager(os.path.join(root, "fsdp_ckpt")).restore(0)
    model = yolo_model()
    model.load_state_dict(restored["state"]["model"])
    opt = build_optimizer("sgd", model, weight_decay=5e-4, momentum=0.937)
    opt.load_state_dict(restored["state"]["optimizer"])
    a["fsdp_checkpoint_bit_equal"] = (same_state(model.state_dict(), gathered_model)
                                      and same_state(opt.state_dict(), gathered_opt))
    check(a["fsdp_checkpoint_bit_equal"], "FSDP checkpoint != the gathered state")
    del model, opt, restored, gathered_model, gathered_opt

    # (b) two ranks on the one card, against this process's step on the global batch
    probe = probe_gloo_on_cuda(root)
    ranks = run_children(["rank0", "rank1"], free_port(), root)
    ranks[0]["gloo_probe"] = probe
    loss_fn, _ = par_loss_parts()
    batch = par_batch(PAR_SMALL_SIZE, PAR_SMALL_BATCH, SEED + 34, dev)
    one, start = {}, {k: v.double() for k, v in small_yolo(torch.float32).state_dict().items()}
    for dtype in (torch.float32, torch.float64):
        with no_tf32():
            model = small_yolo(dtype)
            fit = par_fit(model, loss_fn, None, dtype=dtype)
            fit.state, m = fit.step_fn(fit.state, batch, 1e-2)
        one[dtype] = ({k: v.detach().cpu() for k, v in model.state_dict().items()},
                      float(m["loss"]), float(m["grad_norm"]))
    got = {d: torch.load(os.path.join(root, f"two_ranks_{str(d).split('.')[-1]}.pt"),
                         weights_only=False) for d in (torch.float32, torch.float64)}
    # kernels against their std; the tensors that start constant (BN scale
    # and shift, biases, running statistics), whose std one update makes,
    # against max(std, the update). In float64 the ranks must give the
    # one-process step; in float32 both sit at float32's own distance from
    # float64 (train-mode BN amplifies rounding through the backward), so
    # each is held to the float64 step with phase train's card-vs-CPU limits
    f64 = torch.float64
    two = {"model": f"YOLOv3 stage_sizes (1,1,1,1,1), 80 classes, {PAR_SMALL_SIZE} px, TF32 "
                    f"off, global batch {PAR_SMALL_BATCH} split 2 ways, one SGD step",
           "backend": ranks[0]["backend"], "local_batch": ranks[0]["local_batch"],
           "float64": {"state_max_rel": state_max_rel_diff(got[f64], one[f64][0], start),
                       "loss": [r["float64"]["loss"] for r in ranks],
                       "one_process_loss": one[f64][1]},
           "float32": {"vs_one_process_float32": state_max_rel_diff(
                           got[torch.float32], one[torch.float32][0], start),
                       "vs_one_process_float64": state_max_rel_diff(
                           got[torch.float32], one[f64][0], start),
                       "one_process_float32_vs_float64": state_max_rel_diff(
                           one[torch.float32][0], one[f64][0], start),
                       "loss": [r["float32"]["loss"] for r in ranks],
                       "one_process_loss": one[torch.float32][1]},
           "tolerances": {"float64": {"loss_rel": 1e-5, "kernels": 1e-5, "others": 1e-5},
                          "float32_vs_float64": {"loss_rel": 1e-4, "kernels": 1e-3,
                                                 "others": 1e-2}}}
    for name in ("float64", "float32"):
        r = two[name]
        r["loss_rel"] = abs(r["loss"][0] / r["one_process_loss"] - 1)
    emit("parallel_two_ranks", **two)
    w64, w32 = two["float64"]["state_max_rel"], two["float32"]["vs_one_process_float64"]
    check(w64["kernels"][0] <= 1e-5 and w64["others"][0] <= 1e-5
          and two["float64"]["loss_rel"] <= 1e-5 and w32["kernels"][0] <= 1e-3
          and w32["others"][0] <= 1e-2 and two["float32"]["loss_rel"] <= 1e-4
          and all(len(set(two[n]["loss"])) == 1 for n in ("float32", "float64")),
          f"two ranks on one card: {two}")
    del fit, model
    torch.cuda.empty_cache()
    mesh_runs = parallel_mesh_results(ranks, root, dev, one[f64], start)
    pipe = {"world1_nccl": a["pipeline"], "ranks": [r["pipeline"] for r in ranks],
            "tolerances": {"float32": 1e-5, "float64": 1e-12, "float32_grads_vs_float64":
                           "max(1e-5, 2 x the plain float32 step's)"},
            "times": "two gloo ranks sharing the card: gloo's host staging sets these times"}
    emit("parallel_pipeline", card=smi, **pipe)
    for r in pipe["ranks"]:
        for name, key, tol in (("vit_b16_trunk_float64", "out_max_rel", 1e-12),
                               ("vit_b16_trunk_float64", "grads_max_rel", 1e-12),
                               ("vit_b16_float32", "out_max_rel", 1e-5),
                               ("resnet50_float32", "out_max_rel", 1e-5),
                               ("small_resnet_float64", "out_max_rel", 1e-12),
                               ("small_resnet_float64", "grads_max_rel", 1e-12)):
            check(r[name][key] <= tol, f"pipeline {name} {key} on rank {r['rank']}: {r[name]}")
        check(r["vit_b16_float32"]["vs_float64"]["worst_over_limit"] <= 1,
              f"pipeline ViT-B float32 gradients vs float64: {r['vit_b16_float32']}")
    launches = {**a["launches"], "parallel_tp_train": ranks[0]["cli"]["tp"]["launches"],
                "parallel_time_train_video": ranks[0]["cli"]["time"]["launches"],
                "parallel_pipeline": pipe["world1_nccl"]["nms_launches"] + sum(
                    r["nms_launches"] for r in pipe["ranks"])}
    mismatches = a["mismatches"] + sum(r["cli"][n]["nms_vs_plain"]["mismatches"]
                                       for r in ranks for n in ("tp", "time"))
    emit("parallel", card=smi, cli=a["cli"], equality=a["equality"],
         fsdp_checkpoint_bit_equal=a["fsdp_checkpoint_bit_equal"], two_ranks_one_card=two,
         mesh=mesh_runs, pipeline=pipe, times=a["times"], nms_launches=launches,
         mismatches=mismatches, seconds=time.perf_counter() - t_phase)
    return {"launches": launches, "mismatches": mismatches,
            "zero": ["parallel_time_train_video", "parallel_pipeline"]}


def parallel_mesh_results(ranks: list, root: str, dev, yolo_f64: tuple, yolo_start: dict) -> dict:
    """(d)-(f) read back: each two-rank float64 step against this process's
    one-process step on the global batch (within 1e-5: the losses relative,
    kernels of their std, the tensors that start constant of max(std, their
    update)), the ranks' losses equal, the CLI runs' seconds and losses on
    both ranks (gloo on one card: its host staging sets these times)."""
    got = torch.load(os.path.join(root, "mesh_float64.pt"), weights_only=False)
    batches = small_parallel_batches(dev)
    frcnn_state, frcnn_m = small_frcnn_step(batches["frcnn"], None, dev)
    frcnn_start = {k: v.double() for k, v in FasterRCNN(
        **SMALL_FRCNN, generator=torch.Generator().manual_seed(SEED)).state_dict().items()}
    sf_state, sf_m, sf_logits = small_slowfast_step(batches["video"], None, dev)
    sf_start = {k: v.double() for k, v in SlowFast(
        (1, 1, 1, 1), **SMALL_SLOWFAST, generator=torch.Generator().manual_seed(SEED)
    ).state_dict().items()}
    res = {
        "frcnn": {"model": f"FasterRCNN {SMALL_FRCNN}, float64, TF32 off, a global batch of 4 "
                           "split 2 ways (data axis), one SGD step, the step's own draws",
                  "state_max_rel": state_max_rel_diff(got["frcnn"], frcnn_state, frcnn_start),
                  "loss": [r["frcnn_float64"]["loss"] for r in ranks],
                  "one_process_loss": frcnn_m["loss"]},
        "tp": {"model": f"YOLOv3 stage_sizes (1,1,1,1,1), 80 classes, {PAR_SMALL_SIZE} px, "
                        f"float64, mesh_model=2, batch {PAR_SMALL_BATCH}, one SGD step",
               "state_max_rel": state_max_rel_diff(got["tp"], yolo_f64[0], yolo_start),
               "loss": [r["tp_float64"]["loss"] for r in ranks],
               "one_process_loss": yolo_f64[1]},
        "time": {"model": f"SlowFast (1,1,1,1) {SMALL_SLOWFAST}, 2 clips of 16 x 64 x 64, "
                          "float64, mesh_time=2, one SGD step and the eval forward after",
                 "state_max_rel": state_max_rel_diff(got["time"], sf_state, sf_start),
                 "loss": [r["time_float64"]["loss"] for r in ranks],
                 "one_process_loss": sf_m["loss"],
                 "logits_max_rel": float((got["time_logits"] - sf_logits).abs().max()
                                         / sf_logits.abs().max())},
        "gloo_probe_cuda": ranks[0]["gloo_probe"],
        "cli": {name: {"rank0": ranks[0]["cli"][name], "rank1": ranks[1]["cli"][name]}
                for name in ("tp", "time")},
        "tolerance": 1e-5}
    for name in ("frcnn", "tp", "time"):
        r = res[name]
        r["loss_rel"] = abs(r["loss"][0] / r["one_process_loss"] - 1)
        w = r["state_max_rel"]
        check(w["kernels"][0] <= 1e-5 and w["others"][0] <= 1e-5 and r["loss_rel"] <= 1e-5
              and len(set(r["loss"])) == 1, f"{name} two ranks vs one process: {r}")
    check(res["time"]["logits_max_rel"] <= 1e-5, f"time-sharded forward: {res['time']}")
    for name in ("tp", "time"):
        losses = [ranks[i]["cli"][name]["epochs"][0]["train_loss"] for i in (0, 1)]
        check(losses[0] == losses[1], f"cli {name}: the ranks' losses differ: {losses}")
        check(ranks[0]["cli"][name]["launches"] == ranks[1]["cli"][name]["launches"],
              f"cli {name}: the ranks' NMS launches differ")
    return res


def main_only_parallel(dev: torch.device, device: dict, t_start: float) -> int:
    workdir = tempfile.mkdtemp(prefix="fastvision_smoke_")
    try:
        par = phase_parallel(dev, device["smi"], workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit("total", seconds=time.perf_counter() - t_start)
    check(par["mismatches"] == 0, "kernel mismatches")
    check(all(par["launches"][p] == 0 for p in par["zero"]),
          f"the video path launched nms: {par['launches']}")
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppression_mask", "route": "cuda",
        "source": "fastvision_tpu_torch/csrc/nms.cu",
        "replaces": "fastvision_tpu/ops/nms_pallas.py:32",
        "launches": sum(par["launches"].values()), "launches_by_path": par["launches"],
        "paths_expected_at_zero": par["zero"], "mismatches": par["mismatches"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0


def phase_doctor() -> dict:
    """``cli.main(["doctor"])`` on the card: its report."""
    from fastvision_tpu_torch import cli

    report = cli.main(["doctor"])
    check(report["cuda_devices"] and report["matmul_tflops_bf16"] > 0,
          f"doctor: {report}")
    emit("doctor", **report)
    return report


def int8_kernel_entries(launches: dict, held: dict, split: dict, stems: dict) -> list:
    """The int8 path's kernels as the smoke's last-but-one line lists them:
    launches on the main path (one int8 predict_batch), the error against
    the plain version (for ``int8_conv`` the larger of mode (a) against the
    GEMM route and the fused epilogue's bytes that differ from mode (a) + add
    + the quantize pass) over every layer of a forward at batch 32, and the
    times of one forward's worth of launches at batch 32 (the split), each
    on the layers the path gives it: ``int8_conv`` in its linked modes on
    the 71 implicit-GEMM convs (its float-only launches beside it), the
    quantize pass on the 5 whose input no producer writes (the 66 the links
    took away beside it), the GEMM route's kernels on the stem (their time
    on the 71, where they ran before, beside it; the patches kernel on the
    three stems it serves too). ``int8_conv``'s library yardstick is
    ``torch._int_mm`` of the same [M, K] x [K, N] products alone (the GEMM
    route's product)."""
    steps = split["steps"]
    shape = (f"one int8 YOLOv3-{INPUT_SIZE} forward at batch {split['batch']}: "
             f"{split['layers']['implicit']} implicit-GEMM convs, "
             f"{split['layers']['other']} other (the stem)")
    xla = "fastvision_tpu/nn/layers.py:{} (XLA, no Pallas kernel)"
    fused_bytes = sum(v for row in held["fused_epilogue_differing"].values() for v in row.values())
    entries = []
    for name, source, key, replaces, err, library in (
            ("int8_conv", "int8_conv.cu", "int8_conv", xla.format("100-122"),
             max(held["int8_conv_mode_a_max_abs_err"], float(fused_bytes)), steps["gemm"]["ms"]),
            ("int8_quantize_activation", "int8.cu", "quantize", xla.format(110),
             held["quantize_pass_mismatching_bytes"], None),
            ("int8_quantize_patches", "int8.cu", "other_patches", xla.format(110),
             max(held["patches_kernel_mismatching_bytes"], stems["differing"]), None),
            ("int8_epilogue", "int8.cu", "other_epilogue", xla.format(120),
             held["epilogue_kernel_max_abs_err"], None)):
        st = steps[key]
        entry = {"name": name, "route": "cuda", "source": f"fastvision_tpu_torch/csrc/{source}",
                 "replaces": replaces, "launches": launches[key.replace("other_", "")],
                 "max_abs_err": err, "ms": st["ms"], "plain_ms": st["plain_ms"],
                 "bound_ms": st["bound_ms"], "bound_by": st["bound_by"], "library_ms": library,
                 "layers": st["layers"], "shape": shape}
        if key.startswith("other_"):
            entry["on_the_implicit_gemm_layers"] = {
                f: steps[key[len("other_"):]][f] for f in ("ms", "plain_ms", "bound_ms")}
        entries.append(entry)
    entries[0]["fused_modes"] = split["fused_modes"]
    entries[0]["unfused"] = {f: steps["int8_conv_unfused"][f] for f in ("ms", "bound_ms")}
    entries[1]["linked_away"] = {f: steps["quantize_linked_away"][f]
                                 for f in ("layers", "ms", "bound_ms")}
    entries[2]["stems"] = {k: v for k, v in stems.items() if k != "differing"}
    return entries


def main_only_int8(dev: torch.device, device: dict, t_start: float) -> int:
    workdir = tempfile.mkdtemp(prefix="fastvision_smoke_")
    try:
        int8 = phase_int8(dev, device["smi"], workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit("total", seconds=time.perf_counter() - t_start)
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppression_mask", "route": "cuda",
        "source": "fastvision_tpu_torch/csrc/nms.cu",
        "replaces": "fastvision_tpu/ops/nms_pallas.py:32",
        "launches": sum(int8["launches"].values()), "launches_by_path": int8["launches"]},
        *int8["kernels"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0


def with_export_launches(entries: list, export: dict) -> list:
    """The int8 kernels' entries with the exported int8 programs' launches
    added: ``launches`` over both, ``launches_by_path`` each."""
    out = []
    for e in entries:
        key = INT8_ENTRY_KEYS[e["name"]]
        by_path = {"int8_detector_predict_batch": e["launches"], **export["int8_launches"][key]}
        out.append({**e, "launches": sum(by_path.values()), "launches_by_path": by_path})
    return out


def main_only_export(dev: torch.device, device: dict, t_start: float) -> int:
    phase_doctor()
    workdir = tempfile.mkdtemp(prefix="fastvision_smoke_")
    try:
        export = phase_export(dev, device["smi"], workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit("total", seconds=time.perf_counter() - t_start)
    check(all(export["launches"][p] == 0 for p in export["zero"]),
          f"a classifier program launched nms: {export['launches']}")
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppression_mask", "route": "cuda",
        "source": "fastvision_tpu_torch/csrc/nms.cu",
        "replaces": "fastvision_tpu/ops/nms_pallas.py:32",
        "launches": sum(export["launches"].values()), "launches_by_path": export["launches"],
        "paths_expected_at_zero": export["zero"]}, *[{
            "name": name, "route": "cuda",
            "source": f"fastvision_tpu_torch/csrc/{'int8_conv' if key == 'int8_conv' else 'int8'}.cu",
            "launches": sum(export["int8_launches"][key].values()),
            "launches_by_path": export["int8_launches"][key]}
            for name, key in INT8_ENTRY_KEYS.items()]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0


def main_only_recipe(dev: torch.device, device: dict, t_start: float) -> int:
    workdir = tempfile.mkdtemp(prefix="fastvision_smoke_")
    try:
        recipe = phase_recipe(dev, device["smi"], workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit("total", seconds=time.perf_counter() - t_start)
    check(all(recipe["launches"][p] == 0 for p in recipe["zero"]),
          f"train-cls launched nms: {recipe['launches']}")
    check(recipe["mismatches"] == 0, "kernel mismatches")
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppression_mask", "route": "cuda",
        "source": "fastvision_tpu_torch/csrc/nms.cu",
        "replaces": "fastvision_tpu/ops/nms_pallas.py:32",
        "launches": sum(recipe["launches"].values()), "launches_by_path": recipe["launches"],
        "paths_expected_at_zero": recipe["zero"], "mismatches": recipe["mismatches"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0


def main_only_decode(dev: torch.device, device: dict, t_start: float) -> int:
    workdir = tempfile.mkdtemp(prefix="fastvision_smoke_")
    try:
        decode = phase_decode(dev, device["smi"], workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit("total", seconds=time.perf_counter() - t_start)
    check(all(decode["launches"][p] == 0 for p in decode["zero"]),
          f"video recognition launched nms: {decode['launches']}")
    check(decode["mismatches"] == 0, "kernel mismatches")
    k = decode["kernel"]
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppression_mask", "route": "cuda",
        "source": "fastvision_tpu_torch/csrc/nms.cu",
        "replaces": "fastvision_tpu/ops/nms_pallas.py:32",
        "launches": sum(decode["launches"].values()), "launches_by_path": decode["launches"],
        "paths_expected_at_zero": decode["zero"], "mismatches": decode["mismatches"],
        "max_abs_err": int(decode["mismatches"] > 0), "ms": k["ms"], "graph_ms": k["graph_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0


def main_only_i420(dev: torch.device, device: dict, t_start: float) -> int:
    workdir = tempfile.mkdtemp(prefix="fastvision_smoke_")
    try:
        i420 = phase_i420(dev, device["smi"], workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit("total", seconds=time.perf_counter() - t_start)
    check(i420["mismatches"] == 0, "kernel mismatches")
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppression_mask", "route": "cuda",
        "source": "fastvision_tpu_torch/csrc/nms.cu",
        "replaces": "fastvision_tpu/ops/nms_pallas.py:32",
        "launches": sum(i420["launches"].values()), "launches_by_path": i420["launches"],
        "mismatches": i420["mismatches"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0


def main() -> int:
    # cuBLAS reads its workspace layout once; this one (of the two that
    # PyTorch documents) lets phase_ckpt_resume run its matmuls deterministically
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if sys.argv[1:2] == ["--parallel-child"] and torch.cuda.is_available():
        return parallel_child(*sys.argv[2:5])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    device = phase_device()
    phase_build()
    if sys.argv[1:] == ["--only", "i420"]:
        return main_only_i420(dev, device, t_start)
    if sys.argv[1:] == ["--only", "int8"]:
        return main_only_int8(dev, device, t_start)
    if sys.argv[1:] == ["--only", "export"]:
        return main_only_export(dev, device, t_start)
    if sys.argv[1:] == ["--only", "recipe"]:
        return main_only_recipe(dev, device, t_start)
    if sys.argv[1:] == ["--only", "decode"]:
        return main_only_decode(dev, device, t_start)
    if sys.argv[1:] == ["--only", "parallel"]:
        return main_only_parallel(dev, device, t_start)
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
        torch.cuda.empty_cache()
        codec = phase_codec(device["smi"])
        serve = phase_serve(dev, device["smi"])
        torch.cuda.empty_cache()
        cli_run = phase_cli(dev, device["smi"], workdir, cls["root"], video["root"])
        torch.cuda.empty_cache()
        i420 = phase_i420(dev, device["smi"], workdir)
        torch.cuda.empty_cache()
        decode = phase_decode(dev, device["smi"], workdir)
        torch.cuda.empty_cache()
        int8 = phase_int8(dev, device["smi"], workdir)
        torch.cuda.empty_cache()
        export = phase_export(dev, device["smi"], workdir)
        torch.cuda.empty_cache()
        recipe = phase_recipe(dev, device["smi"], workdir)
        torch.cuda.empty_cache()
        par = phase_parallel(dev, device["smi"], workdir)
        torch.cuda.empty_cache()
        phase_doctor()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit("total", seconds=time.perf_counter() - t_start)

    main_nms = times["nms_kernel"]["B8_main_path"]
    regimes = {"yolo_B8_main_path": main_nms, "yolo_serve_multilabel_B8": serve["kernel"],
               "yolo_predict_video_B8": decode["kernel"], **{
        f"frcnn_{tag}": ftimes["nms_kernel"][tag] for tag in ("rpn_eval", "rpn_train", "head")}}
    by_path = {"detector_predict_batch": e2e["launches"], "fit_validation": train["val_launches"],
               "frcnn_eval_step": feval["launches"],
               "frcnn_fit_validation": ftrain["val_launches"],
               **cls["launches"], **video["launches"], **resume["launches"],
               **evaluate["launches"], **serve["launches"], **cli_run["launches"],
               **i420["launches"], **decode["launches"], **int8["launches"],
               **export["launches"], **recipe["launches"], **par["launches"]}
    # classification and video recognition run no NMS: their paths are
    # counted, and hold 0 launches
    zero_paths = sorted([*cls["launches"], *video["launches"], *cli_run["zero"],
                         *export["zero"], *recipe["zero"], *decode["zero"], *par["zero"]])
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
        "mismatches": (kernel["mismatches"] + fkernel["mismatches"] + evaluate["mismatches"]
                       + serve["mismatches"] + i420["mismatches"] + recipe["mismatches"]
                       + decode["mismatches"] + par["mismatches"]),
        "ms": main_nms["ms"], "graph_ms": main_nms["graph_ms"], "plain_ms": main_nms["plain_ms"],
        "bound_ms": main_nms["bound_ms"], "bound_by": main_nms["bound_by"], "library_ms": None,
        "regimes": {tag: {k: r[k] for k in ("shape", "ms", "graph_ms", "plain_ms", "bound_ms",
                                            "bound_by")} for tag, r in regimes.items()},
    }, *with_export_launches(int8["kernels"], export)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
