"""CLI of the port: train / eval / infer / serve / export for YOLOv3 and
Faster R-CNN, train-cls / eval --task cls for the classification zoo and
train-video / eval --task video for the video zoo, and the host tools
convert / anchors / generate / doctor (port of fastvision_tpu/cli.py).

    python -m fastvision_tpu_torch train --config cfg.yaml
    python -m fastvision_tpu_torch train --config cfg.yaml --resume
    python -m fastvision_tpu_torch train --config cfg.yaml model.name=faster_rcnn \\
        data.input_size=512
    python -m fastvision_tpu_torch eval  --config cfg.yaml --ckpt ckpts/ [--sweep]
    python -m fastvision_tpu_torch eval  --config cfg.yaml --ckpt ckpts/ --int8 [--int8-percentile]
    python -m fastvision_tpu_torch infer --config cfg.yaml --ckpt ckpts/ --source img_or_dir
    python -m fastvision_tpu_torch infer --config cfg.yaml --ckpt ckpts/ --source clip.avi
    python -m fastvision_tpu_torch train-cls model.backbone=resnet50 model.num_classes=1000 \\
        data.input_size=224 data.data_root=imagenet/ [--resume]
    python -m fastvision_tpu_torch eval --task cls --ckpt ckpts/ model.backbone=resnet50 ...
    python -m fastvision_tpu_torch train-video model.backbone=slowfast_resnet50 \\
        model.num_classes=400 data.num_frames=32 data.input_size=224 data.data_root=k400/
    python -m fastvision_tpu_torch eval --task video --ckpt ckpts/ data.eval_clips=4 ...
    python -m fastvision_tpu_torch serve --config cfg.yaml --ckpt ckpts/ --port 8080
    python -m fastvision_tpu_torch serve --config cfg.yaml --ckpt ckpts/ --int8 --calib-dir imgs/
    python -m fastvision_tpu_torch export --config cfg.yaml --ckpt ckpts/ --out det.pt2 [--int8]
    python -m fastvision_tpu_torch export --task cls --ckpt ckpts/ --out cls.pt2 model.backbone=...
    python -m fastvision_tpu_torch convert --kind coco --ann ann.json --images imgs/ --out data/
    python -m fastvision_tpu_torch anchors --config cfg.yaml -k 9 [--plot anchors.png]
    python -m fastvision_tpu_torch generate --out project/
    python -m fastvision_tpu_torch doctor

Config = dataclass tree <- YAML <- dotted overrides (`core.config`); dataset
descriptors use the reference's flat YAML schema. Every command runs on
CUDA; ``--device cpu`` runs it on the CPU. The loaders run on the config's
worker pools (``data.num_workers``, ``data.worker_backend``; 0 is serial).
``train``, ``train-cls`` and ``train-video`` checkpoint into
``train.ckpt_dir`` every epoch, and on SIGTERM (``train.preempt_save``)
save and stop; ``--resume`` continues from the newest checkpoint there.
``eval`` / ``infer`` load a run's EMA weights when it kept them.

Classification data is folder-per-class (``<data_root>/<train_dir>/<class>/
<image>``), video data too, each clip a video file or a directory of
frames (``data.num_frames`` drawn by ``data.frame_strategy``; ``eval
--task video`` with ``data.eval_clips`` > 1 scores ``eval_clips``
windows per video); detection data is ``<split>/images`` +
``<split>/labels``. Images and frames are JPEG (baseline), PNG or BMP
files, read by the port's own decoder (`data.codec`), so no command needs
cv2 for them, nor for Motion-JPEG AVIs (`data.avi`); other video codecs
need cv2. ``serve`` answers HTTP requests
(`infer.serving`) with the JAX package's serving preset: multi-label NMS at
conf 0.001 / IoU 0.6 unless ``nms.*`` is given, batch buckets (1, 2, 4)
below the batch size, micro-batched concurrent requests; SIGTERM drains
the queue and exits. ``data.i420=true`` sends packed YUV 4:2:0 batches to the
card (train and eval loaders, the detector of ``eval`` / ``infer`` /
``serve``); ``eval --tta`` adds horizontal-flip test-time augmentation;
``--fast-decode`` decodes JPEGs at least 2x larger than the input reduced.
``eval --int8`` and ``serve --int8`` run the detector in int8
(`Detector.quantize`, calibrated on the first 8 val images, or on the first
8 image files of ``--calib-dir`` for ``serve``); ``eval --task cls|video``
refuses ``--int8``, which the JAX package ignores there; ``train.accum_steps``
> 1 (gradients averaged over that many batches per update) drives the
YOLOv3 ``train`` only, and the Faster R-CNN ``train``, ``train-cls`` and
``train-video``, whose JAX counterparts ignore it, refuse it. ``export`` writes a
``torch.export`` program with its weights (`infer.export`: ``--stablehlo``
or an ``--out`` ending in ``.pt2`` or ``.stablehlo``, the JAX package's
StableHLO artifact's counterpart): the detector's normalize + forward +
decode + NMS on uint8 NHWC (``--int8``: quantized first, as ``eval --int8``),
or with ``--task cls|video`` a zoo model's normalize + forward + softmax;
a SavedModel or ``--tflite`` (jax2tf and TensorFlow in the JAX package)
exits naming why. ``doctor`` reports the CUDA card, nvcc, ``compile_cache``
and the native libraries found there, the kernels' builds and a bf16
matmul rate, and exits non-zero without a card. ``infer`` on a video
writes ``--out``/annotated.mp4 with the port's own MPEG-4 (Simple Profile,
intra-only) encoder and MP4 muxer (`data.mp4`), with or without cv2.
``compile_cache=<dir>`` builds the native libraries (``csrc/``) into and
loads them from ``<dir>`` (`core.mesh.enable_compile_cache`), so a
restarted run or another rank compiles nothing.

Parallelism: ``multihost=true`` joins the process group torchrun sets up
(NCCL on CUDA, gloo with ``--device cpu``) and fails when it cannot form.
The mesh is ``mesh_data x mesh_model x mesh_time`` ranks (`core.mesh`;
``mesh_data`` 0 takes every rank the other two leave) and must cover the
world. ``mesh_model`` > 1 shards every conv's and linear's output channels
(tensor parallel, `parallel.tensor_shard`; it wins over ``fsdp=true``, as
in the JAX package); else ``fsdp=true`` shards the parameters and
optimizer state (`parallel.fsdp`); ``mesh_time`` > 1 shards a SlowFast
clip's frames (``train-video``, `parallel.time_shard`; another backbone
exits). ``data.host_shard=auto`` has each data index's train loader decode
its own share of every epoch, ``data.batch_size`` then being per data
index; without it the batch size is the global one, split over the data
axis. The train commands (Faster R-CNN's too) and ``eval --task
cls|video`` run over the group:

    torchrun --nproc_per_node 8 -m fastvision_tpu_torch train --config cfg.yaml \
        multihost=true data.host_shard=auto [fsdp=true]
    torchrun --nproc_per_node 4 -m fastvision_tpu_torch train-cls ... multihost=true \
        mesh_data=2 mesh_model=2
    torchrun --nproc_per_node 2 -m fastvision_tpu_torch train-video \
        model.backbone=slowfast_resnet50 ... multihost=true mesh_time=2
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

# the serving preset (the reference's competition recipe, customize_service.py:453),
# applied ahead of the user's overrides, and the batch sizes serving warms
# below the batch size, so that a lone request runs a batch of 1
SERVE_PRESET = ("nms.multi_label=true", "nms.conf_thres=0.001", "nms.iou_thres=0.6")
SERVE_BUCKETS = (1, 2, 4)

def _mesh_from_cfg(cfg, device):
    """The (data, model, time) mesh the config asks for
    (`core.mesh.create_mesh`). ``multihost=true`` first joins the process
    group (torchrun's environment; NCCL on CUDA, gloo with ``--device
    cpu``), before any seeding or CUDA call of the command, and raises when
    it cannot form; ``mesh_data`` 0 takes every rank that ``mesh_model x
    mesh_time`` leaves, and the three must multiply to the world size."""
    from .core.distributed import initialize_multihost
    from .core.mesh import create_mesh

    if cfg.multihost:
        initialize_multihost(device=device)
    return create_mesh(cfg.mesh_data or None, cfg.mesh_model, cfg.mesh_time)


def _load_config(args, overrides):
    from .core.config import Config, apply_overrides, from_yaml

    if args.config:
        cfg = from_yaml(Config, args.config, overrides)
    else:
        cfg = apply_overrides(Config(), overrides)
    if cfg.compile_cache:
        from .core.mesh import enable_compile_cache

        enable_compile_cache(cfg.compile_cache)
    return cfg


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.train.bf16 else torch.float32


def _anchors(cfg) -> np.ndarray:
    from .ops.anchors import COCO_ANCHORS

    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].astype(np.float32)
    if cfg.model.scale_anchors_with_input:
        anchors = anchors * np.float32(cfg.data.input_size / 416.0)
    return np.ascontiguousarray(anchors)


def _maybe_import_pretrained(cfg, model: torch.nn.Module, task: str = "detect") -> None:
    """Load ``model.pretrained`` (a torch checkpoint in any naming scheme
    that `models.import_torch.state_dict_for_port` routes for ``task``: a
    detector, a Darknet-53 / VGG16 classifier for a detector's trunk, a
    classifier of the zoo, or a video model) into the fresh model with a
    shape-filtered partial load: heads of another shape keep their
    initialisation. Raises when no tensor of the checkpoint fits the model."""
    if not cfg.model.pretrained:
        return
    from .core.checkpoint import load_torch_state, partial_load
    from .models.import_torch import state_dict_for_port

    state = load_torch_state(cfg.model.pretrained)
    if "rpn.conv3x3.weight" in state and not cfg.model.reference_compat:
        print("[import] WARNING: this looks like a reference Faster_Rcnn checkpoint but "
              "model.reference_compat is false — its weights assume integer-grid anchors "
              "and h-from-dw decoding; set model.reference_compat=true or boxes will be "
              "degraded")
    loaded, _ = partial_load(model, state_dict_for_port(state, task))
    if not loaded:
        name = cfg.model.name if task == "detect" else cfg.model.backbone
        raise ValueError(f"model.pretrained={cfg.model.pretrained}: no tensor of it matches a "
                         f"name and shape of the {name} model")


def _build_yolo(cfg):
    from .models import YOLOv3

    model = YOLOv3(num_classes=cfg.model.num_classes,
                   generator=torch.Generator().manual_seed(cfg.train.seed))
    _maybe_import_pretrained(cfg, model)
    return model


def _build_zoo_model(cfg, task: str = "cls", **extra) -> torch.nn.Module:
    """A zoo model of ``model.backbone`` with ``model.num_classes``, its
    weights seeded by ``train.seed``: for ``task='cls'`` a classifier
    (resnet18 ... resnext101_32x8d, vgg11 ... vgg19_bn, darknet53,
    vit_*_patch16), for ``'video'`` a video model (c3d, c3d_bn,
    resnet18_3d ... resnet152_3d, slowfast_resnet18 ...
    slowfast_resnet152). ``extra``: further arguments of the factory."""
    if task == "video":
        from .models import video as zoo
    else:
        from .models import classification as zoo

    factory = getattr(zoo, cfg.model.backbone, None)
    if factory is None or not cfg.model.backbone.islower():
        raise SystemExit(f"unknown {task} model {cfg.model.backbone!r} (available: "
                         f"{[n for n in zoo.__all__ if n.islower()]})")
    kw = {"image_size": cfg.data.input_size} if cfg.model.backbone.startswith("vit") else {}
    return factory(num_classes=cfg.model.num_classes,
                   generator=torch.Generator().manual_seed(cfg.train.seed), **kw, **extra)


def _run_closing(fit, *loaders):
    """``fit.run()``, then stop the loaders' worker pools. -> ``fit``."""
    try:
        fit.run()
    finally:
        for loader in loaders:
            loader.close()
    return fit


def _preempt_signals(cfg):
    """SIGTERM -> checkpoint and stop (train.preempt_save=false disables)."""
    import signal

    return (signal.SIGTERM,) if cfg.train.preempt_save else ()


def _refuse_accum_steps(cfg, command: str) -> None:
    """The JAX package applies ``train.accum_steps`` in the YOLOv3 ``train``
    alone and ignores it elsewhere: refuse it there rather than train
    otherwise than it does, or silently not at all."""
    if cfg.train.accum_steps > 1:
        raise SystemExit(
            f"{command}: train.accum_steps={cfg.train.accum_steps} accumulates gradients in the "
            "YOLOv3 train only; the JAX package ignores it here, so the port refuses it "
            "(set train.accum_steps=1; train.microbatch splits each batch instead)")


def cmd_train(args, overrides):
    """-> the finished (or preempted) `train.Fit`."""
    cfg = _load_config(args, overrides)
    mesh = _mesh_from_cfg(cfg, args.device)
    if cfg.model.name == "faster_rcnn":
        return _train_faster_rcnn(cfg, args, mesh)
    from .core import MetricLogger, set_random_seeds, trainable_mask
    from .data import (
        Augmentation,
        DetectionDataset,
        DetectionLoader,
        HorizontalFlip,
        HSVJitter,
        build_augmentation,
    )
    from .infer.decode import decode_predictions
    from .ops.nms import batched_non_max_suppression
    from .train import (
        Fit,
        YOLOv3Loss,
        build_optimizer,
        detection_evaluator,
        make_eval_step,
        make_train_step,
        warmup_cosine_lr,
    )

    set_random_seeds(cfg.train.seed)
    model, anchors, dtype = _build_yolo(cfg), _anchors(cfg), _dtype(cfg)
    d = cfg.data
    train_ds = DetectionDataset(d.data_root, d.train_dir, d.cache)
    val_ds = DetectionDataset(d.data_root, d.val_dir, d.cache)
    aug = (build_augmentation(d.augment)
           or Augmentation([HorizontalFlip(p=0.5), HSVJitter(p=0.5)]))
    workers = dict(num_workers=d.num_workers, worker_backend=d.worker_backend,
                   emit="i420" if d.i420 else "rgb")
    # host_shard: the train loaders only; every rank reads the whole val batch
    train_loader = DetectionLoader(train_ds, d.input_size, d.batch_size, d.max_boxes,
                                   train=True, augmentation=aug, mosaic_prob=0.5,
                                   seed=cfg.train.seed, on_corrupt=d.on_corrupt,
                                   host_shard=d.host_shard or None, **workers)
    val_loader = DetectionLoader(val_ds, d.input_size, d.batch_size, d.max_boxes, train=False,
                                 **workers)  # eval stays strict (on_corrupt)
    no_aug_loader = DetectionLoader(train_ds, d.input_size, d.batch_size, d.max_boxes,
                                    train=True, seed=cfg.train.seed, on_corrupt=d.on_corrupt,
                                    host_shard=d.host_shard or None, **workers)
    loss_obj = YOLOv3Loss(anchors, num_classes=cfg.model.num_classes,
                          neighbor_cells=cfg.train.neighbor_cells)

    def loss_fn(heads, batch):
        out = loss_obj(heads, batch["labels"])
        return out.total, {"box": out.box, "obj": out.obj, "cls": out.cls}

    optimizer = build_optimizer(
        cfg.train.optimizer, model, weight_decay=cfg.train.weight_decay,
        momentum=cfg.train.momentum, nesterov=cfg.train.nesterov,
        grad_clip_norm=cfg.train.grad_clip_norm,
        trainable=trainable_mask(model, cfg.model.freeze) if cfg.model.freeze else None,
        accum_steps=cfg.train.accum_steps)
    anchors_t = torch.from_numpy(anchors)

    def postprocess(heads, batch):
        pred = decode_predictions(heads, anchors_t.to(heads[0].device), (32, 16, 8), "v5")
        return batched_non_max_suppression(
            pred.float(), conf_thres=cfg.nms.conf_thres, iou_thres=cfg.nms.iou_thres,
            max_det=cfg.nms.max_det, pre_nms_top_k=cfg.nms.pre_nms_top_k)

    steps_per_epoch = max(len(train_loader), 1)
    step_fn = None  # Fit's default step unless microbatches or remat ask for one
    if cfg.train.microbatch > 1 or cfg.train.remat:
        step_fn = make_train_step(loss_fn, dtype, accum_steps=cfg.train.microbatch,
                                  remat=cfg.train.remat)
    fit = Fit(
        model, loss_fn, optimizer, train_loader, val_loader, epochs=cfg.train.epochs,
        schedule=warmup_cosine_lr(cfg.train.lr, cfg.train.final_lr,
                                  cfg.train.epochs * steps_per_epoch,
                                  warmup_steps=cfg.train.warmup_epochs * steps_per_epoch),
        evaluator=detection_evaluator(make_eval_step(postprocess, dtype), mesh=mesh),
        mesh=mesh, fsdp=cfg.fsdp,
        ckpt_dir=cfg.train.ckpt_dir, save_every_epoch=cfg.train.save_every_epoch,
        eval_every=cfg.train.eval_every, no_aug_epochs=cfg.train.no_aug_epochs,
        no_aug_loader=no_aug_loader, no_aug_lr=cfg.train.final_lr,
        logger=MetricLogger(cfg.train.ckpt_dir), start_epoch=cfg.train.start_epoch,
        resume=args.resume, metric_key="map50", metric_mode="max",
        ema_decay=cfg.train.ema_decay, step_fn=step_fn,
        multiscale=cfg.train.multiscale or None, preempt_signals=_preempt_signals(cfg),
        dtype=dtype, device=args.device)
    return _run_closing(fit, train_loader, val_loader, no_aug_loader)


def _train_faster_rcnn(cfg, args, mesh):
    """The two-stage recipe: SGD with global-norm clip 10, step decay x0.1
    every 8 epochs, imagenet-standardized inputs; over the mesh as the
    other train commands (each data rank draws the global batch's samples
    and keeps its rows, `train.frcnn_steps`)."""
    from .core import MetricLogger, set_random_seeds
    from .data import DetectionDataset, DetectionLoader, build_augmentation
    from .models import FasterRCNN
    from .train import (
        Fit,
        build_optimizer,
        detection_evaluator,
        make_frcnn_eval_step,
        make_frcnn_train_step,
        step_decay_lr,
    )

    _refuse_accum_steps(cfg, "train (faster_rcnn)")
    set_random_seeds(cfg.train.seed)
    d, dtype = cfg.data, _dtype(cfg)
    model = FasterRCNN(
        num_classes=cfg.model.num_classes, image_size=d.input_size,
        reference_compat=cfg.model.reference_compat,
        generator=torch.Generator().manual_seed(cfg.train.seed),
        **({"anchor_scales": tuple(cfg.model.anchor_scales)} if cfg.model.anchor_scales else {}))
    _maybe_import_pretrained(cfg, model)
    optimizer = build_optimizer(cfg.train.optimizer, model, weight_decay=cfg.train.weight_decay,
                                momentum=cfg.train.momentum,
                                grad_clip_norm=cfg.train.grad_clip_norm or 10.0)
    workers = dict(num_workers=d.num_workers, worker_backend=d.worker_backend,
                   emit="i420" if d.i420 else "rgb")
    train_loader = DetectionLoader(
        DetectionDataset(d.data_root, d.train_dir, d.cache), d.input_size, d.batch_size,
        d.max_boxes, train=True, seed=cfg.train.seed, on_corrupt=d.on_corrupt,
        augmentation=build_augmentation(d.augment), host_shard=d.host_shard or None, **workers)
    val_loader = DetectionLoader(
        DetectionDataset(d.data_root, d.val_dir, d.cache), d.input_size, d.batch_size,
        d.max_boxes, train=False, **workers)
    steps_per_epoch = max(len(train_loader), 1)
    fit = Fit(
        model, None, optimizer, train_loader, val_loader, epochs=cfg.train.epochs,
        schedule=step_decay_lr(cfg.train.lr, 8 * steps_per_epoch),
        evaluator=detection_evaluator(make_frcnn_eval_step(
            score_thresh=cfg.nms.conf_thres, nms_thresh=cfg.nms.iou_thres, dtype=dtype),
            mesh=mesh),
        mesh=mesh, fsdp=cfg.fsdp, ckpt_dir=cfg.train.ckpt_dir, eval_every=cfg.train.eval_every,
        logger=MetricLogger(cfg.train.ckpt_dir), start_epoch=cfg.train.start_epoch,
        resume=args.resume, metric_key="map50", metric_mode="max",
        step_fn=make_frcnn_train_step(cfg.train.seed, dtype),
        preempt_signals=_preempt_signals(cfg), dtype=dtype, device=args.device)
    return _run_closing(fit, train_loader, val_loader)


def cmd_train_cls(args, overrides):
    """Classification training (the JAX package's ``train-cls``): ImageNet
    standardization, hflip by default, mixup / cutmix / label smoothing
    when configured, SGD or Adam with ``warmup_cosine_lr``, validation
    top-1 as the best-checkpoint metric. -> the finished (or preempted)
    `train.Fit`."""
    cfg = _load_config(args, overrides)
    mesh = _mesh_from_cfg(cfg, args.device)
    from .core import MetricLogger, set_random_seeds
    from .data import (
        Augmentation,
        ClassificationDataset,
        ClassificationLoader,
        HorizontalFlip,
        build_augmentation,
    )
    from .train import (
        Fit,
        build_optimizer,
        classification_evaluator,
        cross_entropy,
        make_classification_mix,
        make_eval_step,
        make_train_step,
        soft_cross_entropy,
        warmup_cosine_lr,
    )

    _refuse_accum_steps(cfg, "train-cls")
    set_random_seeds(cfg.train.seed)
    d, t, dtype = cfg.data, cfg.train, _dtype(cfg)
    model = _build_zoo_model(cfg)
    _maybe_import_pretrained(cfg, model, task="cls")

    def loss_fn(logits, batch):
        acc = (logits.argmax(dim=-1) == batch["labels"]).float().mean()
        if "soft" in batch:  # mixup / cutmix / smoothing targets (train.mix)
            return soft_cross_entropy(logits.float(), batch["soft"]), {"acc": acc}
        return cross_entropy(logits.float(), batch["labels"]), {"acc": acc}

    mix = None
    if t.mixup_alpha > 0 or t.cutmix_alpha > 0 or t.label_smoothing > 0:
        mix = make_classification_mix(cfg.model.num_classes, mixup_alpha=t.mixup_alpha,
                                      cutmix_alpha=t.cutmix_alpha, smoothing=t.label_smoothing)
    optimizer = build_optimizer(t.optimizer, model, weight_decay=t.weight_decay,
                                momentum=t.momentum)
    workers = dict(num_workers=d.num_workers, worker_backend=d.worker_backend)
    cats = d.categories or None
    train_loader = ClassificationLoader(
        ClassificationDataset(d.data_root, d.train_dir, cats), d.input_size, d.batch_size,
        augmentation=build_augmentation(d.augment) or Augmentation([HorizontalFlip(p=0.5)]),
        seed=t.seed, on_corrupt=d.on_corrupt, host_shard=d.host_shard or None, **workers)
    val_loader = ClassificationLoader(ClassificationDataset(d.data_root, d.val_dir, cats),
                                      d.input_size, d.batch_size, train=False, **workers)
    steps_per_epoch = max(len(train_loader), 1)
    fit = Fit(
        model, loss_fn, optimizer, train_loader, val_loader, epochs=t.epochs,
        schedule=warmup_cosine_lr(t.lr, t.final_lr, t.epochs * steps_per_epoch,
                                  warmup_steps=t.warmup_epochs * steps_per_epoch),
        evaluator=classification_evaluator(make_eval_step(dtype=dtype, imagenet=True),
                                           mesh=mesh),
        mesh=mesh, fsdp=cfg.fsdp,
        ckpt_dir=t.ckpt_dir, logger=MetricLogger(t.ckpt_dir), resume=args.resume,
        metric_key="accuracy", metric_mode="max",
        step_fn=make_train_step(loss_fn, dtype, accum_steps=t.microbatch, remat=t.remat,
                                batch_transform=mix, transform_seed=t.seed, imagenet=True),
        preempt_signals=_preempt_signals(cfg), dtype=dtype, device=args.device, seed=t.seed)
    return _run_closing(fit, train_loader, val_loader)


def _video_loader(cfg, split: str, train: bool):
    from .data import VideoClipLoader, VideoFolderDataset

    d = cfg.data
    return VideoClipLoader(
        VideoFolderDataset(d.data_root, split, d.categories or None), num_frames=d.num_frames,
        size=d.input_size, batch_size=d.batch_size, strategy=d.frame_strategy, train=train,
        num_workers=d.num_workers, worker_backend=d.worker_backend,
        # eval draws from seed 0 and stays strict, as in the JAX package
        **({"seed": cfg.train.seed, "on_corrupt": d.on_corrupt,
            "host_shard": d.host_shard or None} if train else {}))


def _video_evaluator(cfg, mesh=None):
    """``data.eval_clips`` > 1: the multi-clip protocol, else one clip per
    video (top-1 over the loader's clips), imagenet-standardized."""
    from .train import classification_evaluator, make_eval_step, video_multiclip_evaluator

    step = make_eval_step(dtype=_dtype(cfg), imagenet=True)
    if cfg.data.eval_clips > 1:
        return video_multiclip_evaluator(step, n_clips=cfg.data.eval_clips, mesh=mesh)
    return classification_evaluator(step, mesh=mesh)


def cmd_train_video(args, overrides):
    """Video recognition training (the JAX package's ``train-video``): C3D,
    the 3D-ResNet or SlowFast over folder-per-class clips of
    ``data.num_frames`` frames at ``data.input_size``, cross-entropy,
    imagenet standardization, SGD or Adam with ``warmup_cosine_lr``,
    validation top-1 as the best-checkpoint metric. -> the finished (or
    preempted) `train.Fit`."""
    cfg = _load_config(args, overrides)
    mesh = _mesh_from_cfg(cfg, args.device)
    from .core import MetricLogger, set_random_seeds
    from .train import Fit, build_optimizer, cross_entropy, make_train_step, warmup_cosine_lr

    _refuse_accum_steps(cfg, "train-video")
    set_random_seeds(cfg.train.seed)
    t, dtype = cfg.train, _dtype(cfg)
    extra = {}
    if cfg.mesh_time > 1:
        import inspect

        from .core.mesh import TIME_AXIS
        from .models import video as zoo

        factory = getattr(zoo, cfg.model.backbone, None)
        if factory is not None and "time_axis" not in inspect.signature(factory).parameters:
            raise SystemExit(
                f"mesh_time={cfg.mesh_time} needs a time-shardable model "
                f"(slowfast_*); {cfg.model.backbone!r} has no time_axis")
        extra["time_axis"] = TIME_AXIS
    model = _build_zoo_model(cfg, task="video", **extra)
    _maybe_import_pretrained(cfg, model, task="video")

    def loss_fn(logits, batch):
        acc = (logits.argmax(dim=-1) == batch["labels"]).float().mean()
        return cross_entropy(logits.float(), batch["labels"]), {"acc": acc}

    optimizer = build_optimizer(t.optimizer, model, weight_decay=t.weight_decay,
                                momentum=t.momentum)
    train_loader = _video_loader(cfg, cfg.data.train_dir, train=True)
    val_loader = _video_loader(cfg, cfg.data.val_dir, train=False)
    steps_per_epoch = max(len(train_loader), 1)
    fit = Fit(
        model, loss_fn, optimizer, train_loader, val_loader, epochs=t.epochs,
        schedule=warmup_cosine_lr(t.lr, t.final_lr, t.epochs * steps_per_epoch,
                                  warmup_steps=t.warmup_epochs * steps_per_epoch),
        evaluator=_video_evaluator(cfg, mesh), mesh=mesh, fsdp=cfg.fsdp,
        ckpt_dir=t.ckpt_dir, logger=MetricLogger(t.ckpt_dir),
        resume=args.resume, metric_key="accuracy", metric_mode="max", eval_every=t.eval_every,
        save_every_epoch=t.save_every_epoch,
        step_fn=make_train_step(loss_fn, dtype, accum_steps=t.microbatch, remat=t.remat,
                                imagenet=True),
        preempt_signals=_preempt_signals(cfg), dtype=dtype, device=args.device, seed=t.seed)
    return _run_closing(fit, train_loader, val_loader)


def _detector_from_cfg(cfg, ckpt: str, device, batch_buckets=(), fast_decode: bool = False):
    from .core.checkpoint import restore_inference_weights
    from .infer import Detector

    if cfg.model.name == "faster_rcnn":
        raise ValueError("eval and infer take YOLOv3 runs; a Faster R-CNN run is scored by "
                         "its train command's validation (detection_evaluator)")
    model = _build_yolo(cfg)
    if ckpt:
        restore_inference_weights(ckpt, model)
    return Detector(model, _anchors(cfg), input_size=cfg.data.input_size,
                    conf_thres=cfg.nms.conf_thres, iou_thres=cfg.nms.iou_thres,
                    max_det=cfg.nms.max_det, class_names=cfg.data.categories or None,
                    dtype=_dtype(cfg), multi_label=cfg.nms.multi_label,
                    input_format="i420" if cfg.data.i420 else "rgb", fast_decode=fast_decode,
                    batch_buckets=batch_buckets, device=device)


def _eval_classifier(cfg, args) -> dict:
    """``eval --task cls|video --ckpt dir``: top-1 over the val split of a
    train-cls / train-video run's weights (EMA when it kept them), with the
    evaluator the train loop uses (for video with ``data.eval_clips`` > 1
    the multi-clip protocol); prints it with the images (clips) per second."""
    import time

    from .core.checkpoint import restore_inference_weights
    from .data import ClassificationDataset, ClassificationLoader
    from .train import TrainState, classification_evaluator, make_eval_step

    if not args.ckpt:
        raise SystemExit(f"eval --task {args.task} needs --ckpt")
    mesh = _mesh_from_cfg(cfg, args.device)
    model = _build_zoo_model(cfg, args.task)
    restore_inference_weights(args.ckpt, model)
    d = cfg.data
    if args.task == "video":
        loader = _video_loader(cfg, d.val_dir, train=False)
        evaluate = _video_evaluator(cfg, mesh)
    else:
        loader = ClassificationLoader(
            ClassificationDataset(d.data_root, d.val_dir, d.categories or None), d.input_size,
            d.batch_size, train=False, num_workers=d.num_workers, worker_backend=d.worker_backend)
        evaluate = classification_evaluator(make_eval_step(dtype=_dtype(cfg), imagenet=True),
                                            mesh=mesh)
    state = TrainState.create(model, None, args.device)
    if mesh.model > 1:  # tensor parallel, as the train commands place it
        from .parallel.tensor_shard import shard_module

        shard_module(model, mesh)
    try:
        t0 = time.perf_counter()
        res = evaluate(state, loader)
        dt = time.perf_counter() - t0
    finally:
        loader.close()
    n, unit = len(loader.ds) * res.get("n_clips", 1), "clip" if args.task == "video" else "img"
    res[f"{unit}_per_sec"] = n / dt
    extra = f" ({res['n_clips']}-clip protocol)" if "n_clips" in res else ""
    print(f"top-1 accuracy {res['accuracy']:.4f}{extra}  ({n} {unit}s, {n / dt:.1f} {unit}/s)")
    return res


def _quantize_detector(det, ds, n_calib: int = 8, percentile: bool = False) -> None:
    """int8 PTQ with activation calibration on the first val images."""
    imgs = [ds[i][0] for i in range(min(n_calib, len(ds)))]
    det.quantize(imgs, percentile=percentile)
    kind = "99.9th-percentile" if percentile else "absmax"
    print(f"int8: quantized with {len(imgs)} calibration images ({kind})")


def cmd_eval(args, overrides):
    """-> the evaluate result, or the sweep's rows."""
    if args.task in ("cls", "video") and (args.int8 or args.int8_percentile):
        raise SystemExit(f"eval --task {args.task}: --int8 quantizes the detector only "
                         "(the JAX package ignores it here)")
    cfg = _load_config(args, overrides)
    if args.task in ("cls", "video"):
        return _eval_classifier(cfg, args)
    from .data import DetectionDataset
    from .infer.predictor import REFERENCE_SWEEP

    det = _detector_from_cfg(cfg, args.ckpt, args.device, fast_decode=args.fast_decode)
    ds = DetectionDataset(cfg.data.data_root, cfg.data.val_dir)
    if args.int8:
        _quantize_detector(det, ds, percentile=args.int8_percentile)
    if args.sweep:
        points = (REFERENCE_SWEEP if args.sweep == "reference"
                  else [tuple(map(float, p.split(":"))) for p in args.sweep.split(",")])
        rows = det.evaluate_sweep(ds, points, metric_file=args.metric_file or None,
                                  max_images=args.max_images)
        for r in rows:
            print(f"conf {r['conf']:.2f} iou {r['iou']:.2f}  "
                  f"mAP@0.5 {r['map50']:.4f}  mAP@0.5:0.95 {r['map']:.4f}")
        best = max(rows, key=lambda r: r["map50"])
        print(f"best mAP@0.5: {best['map50']:.4f} at conf {best['conf']:.2f} "
              f"iou {best['iou']:.2f}")
        return rows
    res = det.evaluate(
        ds, metric_file=args.metric_file or None,
        config_note=f"conf {cfg.nms.conf_thres} iou {cfg.nms.iou_thres} "
                    f"size {cfg.data.input_size}" + (" tta" if args.tta else ""),
        max_images=args.max_images, tta=args.tta, save_json=args.save_json or None,
        coco_ids=args.coco_ids)
    print(f"mAP@0.5 {res['map50']:.4f}  mAP@0.5:0.95 {res['map']:.4f}  "
          f"({res['images']} imgs, {res['img_per_sec']:.1f} img/s)")
    if args.save_json:
        print(f"detections JSON -> {args.save_json}")
    return res


def cmd_infer(args, overrides):
    """Draw the detections of an image or a directory into ``--out``
    (same file names), or of a video into ``--out``/annotated.mp4 (the
    port's MPEG-4 encoder and muxer, `data.mp4`). -> {path: result}, or the
    video's frames processed."""
    video = args.source.lower().endswith((".mp4", ".avi", ".mov", ".mkv"))
    cfg = _load_config(args, overrides)
    from .data.dataset import imread_rgb, imwrite_rgb
    from .viz import draw_detections

    det = _detector_from_cfg(cfg, args.ckpt, args.device, fast_decode=args.fast_decode)
    os.makedirs(args.out, exist_ok=True)
    if video:
        n = det.predict_video(args.source, os.path.join(args.out, "annotated.mp4"))
        print(f"{n} frames -> {args.out}/annotated.mp4")
        return n
    if os.path.isdir(args.source):
        results = dict(det.predict_dir(args.source))
    else:
        results = {args.source: det.predict_image(args.source)}
    for path, res in results.items():
        drawn = draw_detections(imread_rgb(path), res["boxes"], res["scores"],
                                res["classes"], det.class_names)
        out_path = os.path.join(args.out, os.path.basename(path))
        imwrite_rgb(out_path, drawn)
        print(f"{path}: {len(res['boxes'])} detections -> {out_path}")
    return results


def cmd_serve(args, overrides):
    """Serve YOLOv3 over HTTP until SIGTERM / SIGINT (`infer.serving.serve`),
    with `SERVE_PRESET` ahead of the user's overrides (multi-label NMS at
    conf 0.001 / IoU 0.6) and `SERVE_BUCKETS`. ``--int8`` quantizes the
    detector first, calibrated on the first 8 sorted image files of
    ``--calib-dir``, or on the val split's first 8 images without it."""
    cfg = _load_config(args, [*SERVE_PRESET, *overrides])
    from .infer.serving import VisionService, serve

    det = _detector_from_cfg(cfg, args.ckpt, args.device, batch_buckets=SERVE_BUCKETS,
                             fast_decode=args.fast_decode)
    if args.int8:
        if args.calib_dir:
            from .data.dataset import IMG_EXTS

            paths = sorted(os.path.join(args.calib_dir, f) for f in os.listdir(args.calib_dir)
                           if f.lower().endswith(IMG_EXTS))[:8]
            if not paths:
                raise SystemExit(f"--calib-dir {args.calib_dir!r} contains no images")
            det.quantize(paths)
            print(f"int8: quantized with {len(paths)} calibration images")
        else:
            from .data import DetectionDataset

            try:
                ds = DetectionDataset(cfg.data.data_root, cfg.data.val_dir)
            except FileNotFoundError as e:
                raise SystemExit(
                    "int8 serving needs calibration images: the training dataset "
                    f"({cfg.data.data_root}/{cfg.data.val_dir}) is not on this host — pass "
                    "--calib-dir DIR with a few representative images instead") from e
            _quantize_detector(det, ds)
    window = args.batch_window if args.batch_window == "adaptive" else float(args.batch_window)
    serve(VisionService(det), host=args.host, port=args.port, batch_window_ms=window)


def cmd_convert(args, overrides):
    """COCO JSON or a VOC devkit -> the fastvision layout (`data.converters`).
    -> the number of images converted."""
    from .data.converters import coco_to_fastvision, voc_to_fastvision

    if args.kind == "coco":
        n = coco_to_fastvision(args.ann, args.images, args.out, split=args.split)
    else:
        n = voc_to_fastvision(args.voc_root, args.out, image_set=args.split)
    print(f"converted {n} images -> {args.out}")
    return n


def cmd_anchors(args, overrides):
    """k-means anchors over the train split's boxes (`ops.anchors`), with
    ``--plot`` the (w, h) scatter by cluster. -> anchors [k, 2]."""
    cfg = _load_config(args, overrides)
    from .data import DetectionDataset
    from .ops.anchors import AnchorGenerator, kmeans_anchors

    ds = DetectionDataset(cfg.data.data_root, cfg.data.train_dir)
    gen = AnchorGenerator(datasets=[ds], k=args.k, cache_dir=args.cache_dir, init=args.init)
    if args.plot:
        from .core.plots import plot_anchors

        wh = gen._scan_wh()
        anchors, assign = kmeans_anchors(wh, k=args.k, init=args.init)
        print(f"anchor plot -> {plot_anchors(wh, anchors, assign, args.plot)}")
    else:
        anchors = gen.get_anchors()
    print("anchors (w, h), area-ascending:")
    for w, h in anchors:
        print(f"  {w:.1f} {h:.1f}")
    return anchors


def _export_classifier(cfg, args) -> str:
    """``export --task cls|video``: a zoo model's program (uint8 images or
    clips -> {"probs"}, `infer.export.classifier_program`), weights from
    ``--ckpt`` where given, else seeded by ``train.seed``."""
    from .core.checkpoint import restore_inference_weights
    from .device import resolve_device
    from .infer.export import classifier_program, export_program
    from .nn.layers import memory_format_for

    model = _build_zoo_model(cfg, args.task)
    if args.ckpt:
        restore_inference_weights(args.ckpt, model)
    dev = resolve_device(args.device)
    model = model.to(dev, memory_format=memory_format_for(model)).eval()
    s = cfg.data.input_size
    shape = ((args.batch, cfg.data.num_frames, s, s, 3) if args.task == "video"
             else (args.batch, s, s, 3))
    example = torch.zeros(shape, dtype=torch.uint8, device=dev)
    path = export_program(classifier_program(model, _dtype(cfg)), [example], args.out)
    print(f"torch.export program ({cfg.model.backbone}, {'x'.join(map(str, shape))} uint8 in, "
          f"probs [B,{cfg.model.num_classes}] out) -> {path}")
    return path


def cmd_export(args, overrides):
    """Export the detector's program (normalize + forward + decode + NMS;
    ``--int8``: quantized on the first 8 val images first) or, with
    ``--task cls|video``, a zoo model's, as a ``torch.export`` program with
    its weights (`infer.export.export_program`). -> the file written."""
    tflite = args.tflite or args.out.endswith(".tflite")
    program = args.stablehlo or args.out.endswith((".pt2", ".stablehlo"))
    if tflite and program:
        raise SystemExit("export: --tflite and --stablehlo (or conflicting --out suffixes) are "
                         "mutually exclusive — pick one format")
    if tflite:
        raise SystemExit("export --tflite: the JAX package writes TFLite through jax2tf and "
                         "TensorFlow's converter; the port has no route from PyTorch to it — "
                         "pass --stablehlo (or an --out ending in .pt2) for a torch.export "
                         "program")
    if not program:
        raise SystemExit(f"export --out {args.out}: the JAX package writes a SavedModel through "
                         "jax2tf and TensorFlow; the port has no route from PyTorch to it — pass "
                         "--stablehlo (or an --out ending in .pt2) for a torch.export program")
    if args.task != "detect" and args.int8:
        raise SystemExit("export --int8 is detector-only (w8a8 ConvBN path)")
    cfg = _load_config(args, overrides)
    if args.task != "detect":
        return _export_classifier(cfg, args)
    from .infer.export import detector_program, export_program

    det = _detector_from_cfg(cfg, args.ckpt, args.device)
    if args.int8:
        from .data import DetectionDataset

        _quantize_detector(det, DetectionDataset(cfg.data.data_root, cfg.data.val_dir))
    s = cfg.data.input_size
    example = torch.zeros((args.batch, s, s, 3), dtype=torch.uint8, device=det.device)
    path = export_program(detector_program(det), [example], args.out)
    print(f"torch.export program (batch {args.batch}, {s}px, uint8 NHWC in, "
          f"boxes/scores/classes/valid out{', int8' if args.int8 else ''}) -> {path}")
    return path


_GENERATED_TRAIN = """\
\"\"\"Training entry for this project; edit freely. The CLI equivalent is
`python -m fastvision_tpu_torch train --config cfg.yaml`.\"\"\"
import sys

from fastvision_tpu_torch.cli import main

if __name__ == "__main__":
    main(["train", "--config", "cfg.yaml", *sys.argv[1:]])
"""

_GENERATED_README = """\
# {name}: a fastvision_tpu_torch project

1. Put your dataset at `data.data_root` from `cfg.yaml`
   (`<root>/{{train,val}}/images/*.jpg` + `labels/*.txt`,
   one `cls xmin ymin xmax ymax` pixel-coord line per object), or build it:

       python -m fastvision_tpu_torch convert --kind coco --ann ann.json \\
           --images imgs/ --out data/ --split train

2. Edit `cfg.yaml` (every field is the framework default; any key can
   also be overridden on the command line as `section.key=value`).

3. Run:

       python train.py                    # or: python -m fastvision_tpu_torch train --config cfg.yaml
       python -m fastvision_tpu_torch anchors --config cfg.yaml -k 9
       python -m fastvision_tpu_torch eval   --config cfg.yaml --ckpt checkpoints/
       python -m fastvision_tpu_torch infer  --config cfg.yaml --ckpt checkpoints/ --source img/
       python -m fastvision_tpu_torch serve  --config cfg.yaml --ckpt checkpoints/ --port 8080
       python -m fastvision_tpu_torch export --config cfg.yaml --ckpt checkpoints/ --out det.pt2
"""


def cmd_generate(args, overrides):
    """Scaffold a project directory: ``cfg.yaml`` (the whole defaulted
    config, with ``model.name`` and the overrides), ``train.py`` calling
    this CLI, a README. Needs PyYAML. -> the directory."""
    import yaml

    from .core.config import Config, apply_overrides, to_dict

    cfg = apply_overrides(Config(), [f"model.name={args.model}", *overrides])
    out = args.out
    os.makedirs(out, exist_ok=True)
    cfg_path = os.path.join(out, "cfg.yaml")
    if os.path.exists(cfg_path) and not args.force:
        raise SystemExit(f"{cfg_path} exists — pass --force to overwrite")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)
    with open(os.path.join(out, "train.py"), "w") as f:
        f.write(_GENERATED_TRAIN)
    with open(os.path.join(out, "README.md"), "w") as f:
        f.write(_GENERATED_README.format(name=os.path.basename(os.path.abspath(out))))
    print(f"project scaffold -> {out}/ (cfg.yaml, train.py, README.md)")
    return out


def _ptxas_summary(log: str) -> dict:
    """A ``-Xptxas -v`` report -> the kernels' count, their largest register
    count and spill stores."""
    import re

    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "max_spill_store_bytes": max(spills, default=0)}


def cmd_doctor(args, overrides):
    """Environment triage of a host for the port: Python and PyTorch, the
    optional packages (cv2, PyYAML, matplotlib), the loaders' start method,
    ``compile_cache`` (the config's value; the directory the native
    libraries are built into and loaded from, and the libraries found
    there), the host libraries (``csrc/*.cpp``) built there, the CUDA
    devices (name and power limit from nvidia-smi), nvcc, every CUDA
    library built (seconds, ptxas registers and spills, the path), and the
    bf16 rate of a chain of 4096^3 matmuls. One line a check, then one JSON
    line. Exits non-zero without a CUDA card or nvcc. -> the report."""
    import importlib.util
    import json
    import platform
    import shutil
    import subprocess
    import time

    from . import cuda_build
    from .data.pipeline import parse_worker_backend

    cfg = _load_config(args, overrides)
    report: dict = {}

    def line(key, value, hint=""):
        report[key] = value
        print(f"[doctor] {key:<22} {value}" + (f"   ({hint})" if hint else ""))

    line("python", platform.python_version())
    line("cores", os.cpu_count())
    line("torch", torch.__version__, f"CUDA {torch.version.cuda}")
    for mod in ("cv2", "yaml", "matplotlib"):
        line(f"has_{mod}", importlib.util.find_spec(mod) is not None)
    backend = cfg.data.worker_backend
    line("worker_start_method", parse_worker_backend(backend)[1],
         f"data.worker_backend={backend!r}; 'process:spawn' or 'process:forkserver' to change")
    from .core.distributed import process_info

    info = process_info()
    line("world_size", info["process_count"],
         f"rank {info['process_index']}, backend {info['backend'] or 'none'}; torchrun + "
         "multihost=true forms a group (NCCL on CUDA)")
    line("nccl", torch.distributed.is_available() and torch.distributed.is_nccl_available())

    line("compile_cache", cfg.compile_cache or "(unset)",
         "compile_cache=<dir>: native builds kept across restarts and ranks")
    line("build_dir", cuda_build.build_dir())
    line("build_dir_cached", cuda_build.cached(), "libraries found there before this run")

    def built(builds):
        for b in builds:
            line(f"build_{b.name}", {"seconds": round(b.seconds, 2), "path": b.path,
                                     **_ptxas_summary(b.log)}, b.source)

    built(cuda_build.build_all([n for n in cuda_build.sources()
                                if cuda_build.kind(n) == "host"]))

    def fail(why: str):
        print(json.dumps(report))
        raise SystemExit(f"doctor: {why}")

    if not torch.cuda.is_available():
        line("cuda_devices", 0)
        fail("no CUDA card is visible (torch.cuda.is_available() is False); the port's entry "
             "points need one (or --device cpu)")
    line("cuda_devices", [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())])
    smi = shutil.which("nvidia-smi")
    line("nvidia_smi", subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
        text=True, check=False).stdout.strip().splitlines() if smi else "not found",
        "name, power limit")
    try:
        nvcc = cuda_build.nvcc()
    except RuntimeError as e:
        line("nvcc", "not found")
        fail(str(e))
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=False)
    line("nvcc", nvcc, version.stdout.strip().splitlines()[-1] if version.stdout else "")
    t0 = time.perf_counter()
    built(cuda_build.build_all([n for n in cuda_build.sources()
                                if cuda_build.kind(n) == "cuda"]))
    line("build_all_s", round(time.perf_counter() - t0, 2),
         "every CUDA source, at once (seconds 0: found in the build directory)")

    iters, n = 128, 4096
    dev = torch.device("cuda", torch.cuda.current_device())
    a = torch.full((n, n), 0.5, dtype=torch.bfloat16, device=dev)

    def chain(x):
        for _ in range(iters):  # rescaled each round: data-dependent, finite in bf16
            x = (x @ x) * 1e-4
        return x

    chain(a)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    chain(a)
    torch.cuda.synchronize(dev)
    line("matmul_tflops_bf16", round(iters * 2 * n ** 3 / (time.perf_counter() - t0) / 1e12, 1),
         "H100 SXM dense bf16 peak 989 at 700 W (NVIDIA data sheet)")
    print(json.dumps(report))
    return report


def make_parser() -> argparse.ArgumentParser:
    """The JAX package's CLI surface, every subcommand and flag, plus
    ``--device``; unknown key=value arguments are dotted config overrides."""
    parser = argparse.ArgumentParser("fastvision_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--config", default="", help="YAML config file")
        p.add_argument("--device", default=None,
                       help="torch device (default: cuda; 'cpu' runs on the CPU)")
        return p

    p = common(sub.add_parser("train"))
    p.add_argument("--resume", action="store_true")
    p = common(sub.add_parser("train-cls"))
    p.add_argument("--resume", action="store_true")
    p = common(sub.add_parser("train-video", help="video recognition over folder-per-class clips"))
    p.add_argument("--resume", action="store_true")
    p = common(sub.add_parser("eval"))
    p.add_argument("--task", choices=["detect", "cls", "video"], default="detect",
                   help="detect: mAP over a detection val split (default); cls: top-1 "
                        "accuracy over a folder-per-class val split; video: top-1 over a "
                        "folder-per-class split of clips (data.eval_clips windows per clip)")
    p.add_argument("--ckpt", default="")
    p.add_argument("--metric-file", default="")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--tta", action="store_true",
                   help="horizontal-flip test-time augmentation")
    p.add_argument("--int8", action="store_true",
                   help="int8 w8a8 PTQ inference (calibrated on the first 8 val images)")
    p.add_argument("--int8-percentile", action="store_true",
                   help="with --int8: calibrate at the 99.9th percentile of |x|")
    p.add_argument("--fast-decode", action="store_true",
                   help="reduced JPEG decode for >=2x oversized images")
    p.add_argument("--sweep", nargs="?", const="reference", default=None,
                   metavar="C:I,C:I,...",
                   help="conf:iou threshold sweep in one data pass; bare --sweep runs the "
                        "reference's 9-point grid")
    p.add_argument("--save-json", default="", metavar="PATH",
                   help="write detections as COCO results JSON")
    p.add_argument("--coco-ids", action="store_true",
                   help="with --save-json: map the 80 contiguous classes back to COCO "
                        "annotation category ids 1..90")
    p = common(sub.add_parser("infer"))
    p.add_argument("--ckpt", default="")
    p.add_argument("--source", required=True)
    p.add_argument("--out", default="./outputs")
    p.add_argument("--fast-decode", action="store_true",
                   help="reduced JPEG decode for >=2x oversized images")
    p = common(sub.add_parser(
        "serve", help="HTTP serving: POST /predict (an image body), POST /predict_stream "
                      "(NDJSON), GET /healthz; multi-label NMS at conf 0.001 / IoU 0.6 "
                      "unless nms.* is given"))
    p.add_argument("--ckpt", default="")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-window", default="adaptive",
                   help="'adaptive' (flush after an idle 2 ms, at most 20 ms) or a fixed "
                        "window in ms")
    p.add_argument("--int8", action="store_true", help="int8 w8a8 PTQ serving")
    p.add_argument("--calib-dir", default="",
                   help="with --int8: calibrate on the first 8 images of this directory "
                        "(default: the val split)")
    p.add_argument("--fast-decode", action="store_true",
                   help="reduced JPEG decode for >=2x oversized images")
    p = sub.add_parser("doctor", help="environment triage: the CUDA card, nvcc, "
                                      "compile_cache, the native builds, a bf16 matmul rate")
    p.add_argument("--config", default="", help="YAML config file")
    p = sub.add_parser("convert")
    p.add_argument("--kind", choices=["coco", "voc"], required=True)
    p.add_argument("--ann", default="")
    p.add_argument("--images", default="")
    p.add_argument("--voc-root", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--split", default="train")
    p = common(sub.add_parser("anchors"))
    p.add_argument("-k", type=int, default=9)
    p.add_argument("--cache-dir", default="./cache")
    p.add_argument("--init", choices=["random", "++"], default="random")
    p.add_argument("--plot", default="")
    p = common(sub.add_parser("export"))
    p.add_argument("--ckpt", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--task", choices=["detect", "cls", "video"], default="detect")
    p.add_argument("--int8", action="store_true",
                   help="quantize the detector first (int8 w8a8, calibrated on the first 8 "
                        "val images)")
    p.add_argument("--tflite", action="store_true",
                   help="a TFLite flatbuffer: not available in the port (jax2tf / TensorFlow)")
    p.add_argument("--stablehlo", action="store_true",
                   help="write a torch.export program with its weights (.pt2; load with "
                        "infer.load_program); also taken from an --out ending in .pt2 or "
                        ".stablehlo")
    p = sub.add_parser("generate", help="scaffold a new project dir (cfg.yaml + train.py + "
                                        "README)")
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="yolov3", choices=["yolov3", "faster_rcnn"])
    p.add_argument("--force", action="store_true")
    return parser


def main(argv=None):
    """Run one subcommand; -> what it returns (a Fit, an eval result, ...)."""
    parser = make_parser()
    args, overrides = parser.parse_known_args(argv)
    overrides = [o for o in overrides if "=" in o]
    return {"train": cmd_train, "train-cls": cmd_train_cls, "train-video": cmd_train_video,
            "eval": cmd_eval, "infer": cmd_infer, "serve": cmd_serve, "convert": cmd_convert,
            "anchors": cmd_anchors, "export": cmd_export, "generate": cmd_generate,
            "doctor": cmd_doctor}[args.cmd](args, overrides)


if __name__ == "__main__":
    main()
