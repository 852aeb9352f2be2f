"""Training: losses, optimizers, schedules, EMA, the mix transform, the train
/ eval steps and the Fit harness with its detection, classification and
multi-clip video evaluators (names as in fastvision_tpu.train)."""
from .ema import ema_update, make_ema_update
from .fit import (
    Fit,
    classification_evaluator,
    detection_evaluator,
    multiclip_windows,
    video_multiclip_evaluator,
)
from .frcnn_steps import labels_to_pixel_xyxy, make_frcnn_eval_step, make_frcnn_train_step
from .losses import (
    YOLOv3Loss,
    YoloLossOutput,
    binary_cross_entropy,
    binary_focal_loss,
    cross_entropy,
    focal_loss,
    smooth_l1,
    soft_cross_entropy,
)
from .mix import MixDraws, cutmix, make_classification_mix, mixup, smooth_labels
from .optim import build_optimizer, decay_mask, get_lr, set_lr
from .schedulers import (
    SCHEDULES,
    PlateauScheduler,
    constant_lr,
    cosine_lr,
    exponential_lr,
    linear_lr,
    step_decay_lr,
    warmup_cosine_lr,
)
from .steps import TrainState, device_batch, make_eval_step, make_train_step

__all__ = [
    "ema_update", "make_ema_update", "Fit", "classification_evaluator", "detection_evaluator",
    "labels_to_pixel_xyxy", "make_frcnn_eval_step", "make_frcnn_train_step", "YOLOv3Loss", "YoloLossOutput",
    "binary_cross_entropy", "binary_focal_loss", "cross_entropy", "focal_loss", "smooth_l1",
    "soft_cross_entropy", "MixDraws", "cutmix", "make_classification_mix", "mixup",
    "smooth_labels", "build_optimizer", "decay_mask", "get_lr",
    "set_lr", "SCHEDULES", "PlateauScheduler", "constant_lr", "cosine_lr", "exponential_lr",
    "linear_lr", "step_decay_lr", "warmup_cosine_lr", "TrainState", "device_batch",
    "make_eval_step", "make_train_step", "multiclip_windows", "video_multiclip_evaluator",
]
