"""CLI of the port: train / eval / infer for YOLOv3 and Faster R-CNN,
train-cls / eval --task cls for the classification zoo and train-video /
eval --task video for the video zoo (port of fastvision_tpu/cli.py).

    python -m fastvision_tpu_torch train --config cfg.yaml
    python -m fastvision_tpu_torch train --config cfg.yaml --resume
    python -m fastvision_tpu_torch train --config cfg.yaml model.name=faster_rcnn \\
        data.input_size=512
    python -m fastvision_tpu_torch eval  --config cfg.yaml --ckpt ckpts/ [--sweep]
    python -m fastvision_tpu_torch infer --config cfg.yaml --ckpt ckpts/ --source img_or_dir
    python -m fastvision_tpu_torch train-cls model.backbone=resnet50 model.num_classes=1000 \\
        data.input_size=224 data.data_root=imagenet/ [--resume]
    python -m fastvision_tpu_torch eval --task cls --ckpt ckpts/ model.backbone=resnet50 ...
    python -m fastvision_tpu_torch train-video model.backbone=slowfast_resnet50 \\
        model.num_classes=400 data.num_frames=32 data.input_size=224 data.data_root=k400/
    python -m fastvision_tpu_torch eval --task video --ckpt ckpts/ data.eval_clips=4 ...

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
``<split>/labels``. Without cv2 the images and frames must be ``.bmp``
files (read with numpy) and video files cannot be read.
Subcommands and flags the port does not have yet exit naming their ROADMAP
item.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

# ROADMAP Queue 1 items of the JAX package's subcommands that are not ported
_NOT_PORTED_COMMANDS = {"serve": 16, "convert": 11,
                        "anchors": 2, "export": 16, "generate": 10, "doctor": 10}


def _exit_not_ported(what: str, item: int) -> SystemExit:
    return SystemExit(f"fastvision_tpu_torch: {what} is not ported yet "
                      f"(ROADMAP Queue 1, item {item})")


def _check_ported(cfg) -> None:
    """Config values of work the port does not have raise here."""
    for bad, what, item in (
            (cfg.mesh_data not in (0, 1) or cfg.mesh_model != 1 or cfg.mesh_time != 1,
             "meshes (mesh_data / mesh_model / mesh_time)", 17),
            (cfg.fsdp, "fsdp", 17),
            (cfg.multihost, "multihost", 17),
            (bool(cfg.data.host_shard), "data.host_shard", 17),
            (cfg.data.i420, "data.i420 (packed YUV 4:2:0 batches)", 6),
            (cfg.nms.multi_label, "nms.multi_label (multi-label NMS)", 5),
            (bool(cfg.compile_cache), "compile_cache (the JAX package's XLA cache)", 10)):
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, item {item})")


def _load_config(args, overrides):
    from .core.config import Config, apply_overrides, from_yaml

    if args.config:
        cfg = from_yaml(Config, args.config, overrides)
    else:
        cfg = apply_overrides(Config(), overrides)
    _check_ported(cfg)
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


def _build_zoo_model(cfg, task: str = "cls") -> torch.nn.Module:
    """A zoo model of ``model.backbone`` with ``model.num_classes``, its
    weights seeded by ``train.seed``: for ``task='cls'`` a classifier
    (resnet18 ... resnext101_32x8d, vgg11 ... vgg19_bn, darknet53,
    vit_*_patch16), for ``'video'`` a video model (c3d, c3d_bn,
    resnet18_3d ... resnet152_3d, slowfast_resnet18 ...
    slowfast_resnet152)."""
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
                   generator=torch.Generator().manual_seed(cfg.train.seed), **kw)


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


def cmd_train(args, overrides):
    """-> the finished (or preempted) `train.Fit`."""
    cfg = _load_config(args, overrides)
    if cfg.model.name == "faster_rcnn":
        return _train_faster_rcnn(cfg, args)
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
    workers = dict(num_workers=d.num_workers, worker_backend=d.worker_backend)
    train_loader = DetectionLoader(train_ds, d.input_size, d.batch_size, d.max_boxes,
                                   train=True, augmentation=aug, mosaic_prob=0.5,
                                   seed=cfg.train.seed, on_corrupt=d.on_corrupt, **workers)
    val_loader = DetectionLoader(val_ds, d.input_size, d.batch_size, d.max_boxes, train=False,
                                 **workers)  # eval stays strict (on_corrupt)
    no_aug_loader = DetectionLoader(train_ds, d.input_size, d.batch_size, d.max_boxes,
                                    train=True, seed=cfg.train.seed, on_corrupt=d.on_corrupt,
                                    **workers)
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
        evaluator=detection_evaluator(make_eval_step(postprocess, dtype)),
        ckpt_dir=cfg.train.ckpt_dir, save_every_epoch=cfg.train.save_every_epoch,
        eval_every=cfg.train.eval_every, no_aug_epochs=cfg.train.no_aug_epochs,
        no_aug_loader=no_aug_loader, no_aug_lr=cfg.train.final_lr,
        logger=MetricLogger(cfg.train.ckpt_dir), start_epoch=cfg.train.start_epoch,
        resume=args.resume, metric_key="map50", metric_mode="max",
        ema_decay=cfg.train.ema_decay, step_fn=step_fn,
        multiscale=cfg.train.multiscale or None, preempt_signals=_preempt_signals(cfg),
        dtype=dtype, device=args.device)
    return _run_closing(fit, train_loader, val_loader, no_aug_loader)


def _train_faster_rcnn(cfg, args):
    """The two-stage recipe: SGD with global-norm clip 10, step decay x0.1
    every 8 epochs, imagenet-standardized inputs."""
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
    workers = dict(num_workers=d.num_workers, worker_backend=d.worker_backend)
    train_loader = DetectionLoader(
        DetectionDataset(d.data_root, d.train_dir, d.cache), d.input_size, d.batch_size,
        d.max_boxes, train=True, seed=cfg.train.seed, on_corrupt=d.on_corrupt,
        augmentation=build_augmentation(d.augment), **workers)
    val_loader = DetectionLoader(
        DetectionDataset(d.data_root, d.val_dir, d.cache), d.input_size, d.batch_size,
        d.max_boxes, train=False, **workers)
    steps_per_epoch = max(len(train_loader), 1)
    fit = Fit(
        model, None, optimizer, train_loader, val_loader, epochs=cfg.train.epochs,
        schedule=step_decay_lr(cfg.train.lr, 8 * steps_per_epoch),
        evaluator=detection_evaluator(make_frcnn_eval_step(
            score_thresh=cfg.nms.conf_thres, nms_thresh=cfg.nms.iou_thres, dtype=dtype)),
        ckpt_dir=cfg.train.ckpt_dir, eval_every=cfg.train.eval_every,
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
                                momentum=t.momentum, accum_steps=t.accum_steps)
    workers = dict(num_workers=d.num_workers, worker_backend=d.worker_backend)
    cats = d.categories or None
    train_loader = ClassificationLoader(
        ClassificationDataset(d.data_root, d.train_dir, cats), d.input_size, d.batch_size,
        augmentation=build_augmentation(d.augment) or Augmentation([HorizontalFlip(p=0.5)]),
        seed=t.seed, on_corrupt=d.on_corrupt, **workers)
    val_loader = ClassificationLoader(ClassificationDataset(d.data_root, d.val_dir, cats),
                                      d.input_size, d.batch_size, train=False, **workers)
    steps_per_epoch = max(len(train_loader), 1)
    fit = Fit(
        model, loss_fn, optimizer, train_loader, val_loader, epochs=t.epochs,
        schedule=warmup_cosine_lr(t.lr, t.final_lr, t.epochs * steps_per_epoch,
                                  warmup_steps=t.warmup_epochs * steps_per_epoch),
        evaluator=classification_evaluator(make_eval_step(dtype=dtype, imagenet=True)),
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
        **({"seed": cfg.train.seed, "on_corrupt": d.on_corrupt} if train else {}))


def _video_evaluator(cfg):
    """``data.eval_clips`` > 1: the multi-clip protocol, else one clip per
    video (top-1 over the loader's clips), imagenet-standardized."""
    from .train import classification_evaluator, make_eval_step, video_multiclip_evaluator

    step = make_eval_step(dtype=_dtype(cfg), imagenet=True)
    if cfg.data.eval_clips > 1:
        return video_multiclip_evaluator(step, n_clips=cfg.data.eval_clips)
    return classification_evaluator(step)


def cmd_train_video(args, overrides):
    """Video recognition training (the JAX package's ``train-video``): C3D,
    the 3D-ResNet or SlowFast over folder-per-class clips of
    ``data.num_frames`` frames at ``data.input_size``, cross-entropy,
    imagenet standardization, SGD or Adam with ``warmup_cosine_lr``,
    validation top-1 as the best-checkpoint metric. -> the finished (or
    preempted) `train.Fit`."""
    cfg = _load_config(args, overrides)
    from .core import MetricLogger, set_random_seeds
    from .train import Fit, build_optimizer, cross_entropy, make_train_step, warmup_cosine_lr

    set_random_seeds(cfg.train.seed)
    t, dtype = cfg.train, _dtype(cfg)
    model = _build_zoo_model(cfg, task="video")
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
        evaluator=_video_evaluator(cfg), ckpt_dir=t.ckpt_dir, logger=MetricLogger(t.ckpt_dir),
        resume=args.resume, metric_key="accuracy", metric_mode="max", eval_every=t.eval_every,
        save_every_epoch=t.save_every_epoch,
        step_fn=make_train_step(loss_fn, dtype, accum_steps=t.microbatch, remat=t.remat,
                                imagenet=True),
        preempt_signals=_preempt_signals(cfg), dtype=dtype, device=args.device, seed=t.seed)
    return _run_closing(fit, train_loader, val_loader)


def _detector_from_cfg(cfg, ckpt: str, device):
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
                    dtype=_dtype(cfg), device=device)


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
    model = _build_zoo_model(cfg, args.task)
    restore_inference_weights(args.ckpt, model)
    d = cfg.data
    if args.task == "video":
        loader, evaluate = _video_loader(cfg, d.val_dir, train=False), _video_evaluator(cfg)
    else:
        loader = ClassificationLoader(
            ClassificationDataset(d.data_root, d.val_dir, d.categories or None), d.input_size,
            d.batch_size, train=False, num_workers=d.num_workers, worker_backend=d.worker_backend)
        evaluate = classification_evaluator(make_eval_step(dtype=_dtype(cfg), imagenet=True))
    state = TrainState.create(model, None, args.device)
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


def cmd_eval(args, overrides):
    """-> the evaluate result, or the sweep's rows."""
    for flag, item in (("int8", 15), ("int8_percentile", 15), ("tta", 6), ("fast_decode", 6)):
        if getattr(args, flag):
            raise _exit_not_ported("--" + flag.replace("_", "-"), item)
    cfg = _load_config(args, overrides)
    if args.task in ("cls", "video"):
        return _eval_classifier(cfg, args)
    from .data import DetectionDataset
    from .infer.predictor import REFERENCE_SWEEP

    det = _detector_from_cfg(cfg, args.ckpt, args.device)
    ds = DetectionDataset(cfg.data.data_root, cfg.data.val_dir)
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
                    f"size {cfg.data.input_size}",
        max_images=args.max_images, save_json=args.save_json or None, coco_ids=args.coco_ids)
    print(f"mAP@0.5 {res['map50']:.4f}  mAP@0.5:0.95 {res['map']:.4f}  "
          f"({res['images']} imgs, {res['img_per_sec']:.1f} img/s)")
    if args.save_json:
        print(f"detections JSON -> {args.save_json}")
    return res


def cmd_infer(args, overrides):
    """Draw the detections of an image or a directory into ``--out``
    (same file names). -> {path: result}."""
    if args.fast_decode:
        raise _exit_not_ported("--fast-decode", 6)
    if args.source.lower().endswith((".mp4", ".avi", ".mov", ".mkv")):
        raise _exit_not_ported("infer on a video (Detector.predict_video)", 6)
    cfg = _load_config(args, overrides)
    from .data.dataset import imread_rgb, imwrite_rgb
    from .viz import draw_detections

    det = _detector_from_cfg(cfg, args.ckpt, args.device)
    os.makedirs(args.out, exist_ok=True)
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
                   help="horizontal-flip test-time augmentation (not ported)")
    p.add_argument("--int8", action="store_true", help="int8 w8a8 PTQ inference (not ported)")
    p.add_argument("--int8-percentile", action="store_true",
                   help="calibrate at the 99.9th percentile of |x| (not ported)")
    p.add_argument("--fast-decode", action="store_true",
                   help="reduced JPEG decode for >=2x oversized images (not ported)")
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
                   help="reduced JPEG decode for >=2x oversized images (not ported)")
    p = common(sub.add_parser("serve"))
    p.add_argument("--ckpt", default="")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-window", default="adaptive")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--calib-dir", default="")
    p.add_argument("--fast-decode", action="store_true")
    sub.add_parser("doctor", help="environment triage (not ported)")
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
    p.add_argument("--int8", action="store_true")
    p.add_argument("--tflite", action="store_true")
    p.add_argument("--stablehlo", action="store_true")
    p = sub.add_parser("generate", help="scaffold a new project dir (not ported)")
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="yolov3", choices=["yolov3", "faster_rcnn"])
    p.add_argument("--force", action="store_true")
    return parser


def main(argv=None):
    """Run one subcommand; -> what it returns (a Fit, an eval result, ...)."""
    parser = make_parser()
    args, overrides = parser.parse_known_args(argv)
    overrides = [o for o in overrides if "=" in o]
    if args.cmd in _NOT_PORTED_COMMANDS:
        raise _exit_not_ported(f"the {args.cmd!r} subcommand", _NOT_PORTED_COMMANDS[args.cmd])
    return {"train": cmd_train, "train-cls": cmd_train_cls, "train-video": cmd_train_video,
            "eval": cmd_eval, "infer": cmd_infer}[args.cmd](args, overrides)


if __name__ == "__main__":
    main()
