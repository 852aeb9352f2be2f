"""Hierarchical config: dataclass tree <- YAML file <- CLI dotted overrides
(port of fastvision_tpu/core/config.py, same fields and defaults).

PyYAML is imported only where a YAML text is parsed: `from_yaml` and a
bracketed override value (``data.augment=[hflip:0.5]``). Without it those
raise ImportError; scalar overrides need nothing. Fields of work the port
does not have yet (meshes, FSDP, multi-host, the XLA compile cache, packed
I420, host sharding) parse as in the JAX package; the command that meets a
non-default value raises (`cli.py`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Sequence


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("PyYAML is needed to read YAML configs and bracketed override "
                          "values ([...], {...}); it is not installed") from e
    return yaml


def _coerce(value: str, target_type: Any) -> Any:
    """Parse a CLI string into the annotated type."""
    if target_type in (int, "int"):
        return int(value)
    if target_type in (float, "float"):
        return float(value)
    if target_type in (bool, "bool"):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(value, str) and value.startswith(("[", "{", "(")):
        return _yaml().safe_load(value)
    return value


def update_dataclass(obj: Any, updates: dict) -> Any:
    """Return a copy of a (nested) dataclass with dict updates applied."""
    kwargs = {}
    names = {f.name: f for f in fields(obj)}
    for key, val in updates.items():
        if key not in names:
            raise KeyError(f"{type(obj).__name__} has no field {key!r}")
        cur = getattr(obj, key)
        if is_dataclass(cur) and isinstance(val, dict):
            kwargs[key] = update_dataclass(cur, val)
        else:
            kwargs[key] = val
    return dataclasses.replace(obj, **kwargs)


def apply_overrides(obj: Any, overrides: Sequence[str]) -> Any:
    """Apply 'a.b.c=value' dotted CLI overrides to a dataclass tree."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key=value")
        path, raw = item.split("=", 1)
        keys = path.lstrip("-").split(".")
        node: Any = obj
        for k in keys[:-1]:
            node = getattr(node, k)
        f = {f.name: f for f in fields(node)}[keys[-1]]
        nested: dict = {keys[-1]: _coerce(raw, f.type)}
        for k in reversed(keys[:-1]):
            nested = {k: nested}
        obj = update_dataclass(obj, nested)
    return obj


def to_dict(obj: Any) -> Any:
    if is_dataclass(obj):
        return {f.name: to_dict(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [to_dict(x) for x in obj]
    return obj


def from_yaml(cls, path: str, overrides: Sequence[str] = ()) -> Any:
    """Load a dataclass config from YAML, then apply CLI overrides.

    Accepts the reference's FLAT dataset descriptors (data_root / train_dir
    / val_dir / test_dir / num_classes / categories at top level): top-level
    keys that are not fields of ``cls`` but are fields of DataConfig go under
    ``data``, and a flat ``num_classes`` also seeds ``model.num_classes``
    unless the file sets it. An explicit nested ``data:`` section wins over
    flat keys."""
    with open(path) as f:
        data = _yaml().safe_load(f) or {}
    cls_fields = {f.name for f in fields(cls)} if is_dataclass(cls) else set()
    stray = {k: v for k, v in data.items() if k not in cls_fields}
    if stray and "data" in cls_fields:
        data_fields = {f.name for f in fields(DataConfig)}
        if set(stray) <= data_fields:
            data = {k: v for k, v in data.items() if k in cls_fields}
            data["data"] = {**stray, **data.get("data", {})}
            if "num_classes" in data["data"] and "model" in cls_fields:
                # seeded from the merged data section, so that the head
                # cannot disagree with the pipeline's class count
                model = dict(data.get("model", {}))
                model.setdefault("num_classes", data["data"]["num_classes"])
                data["model"] = model
    obj = update_dataclass(cls(), data)
    return apply_overrides(obj, overrides)


@dataclass
class DataConfig:
    data_root: str = ""
    train_dir: str = "train"
    val_dir: str = "val"
    test_dir: str = "test"
    num_classes: int = 80
    categories: list = field(default_factory=list)
    input_size: int = 416
    batch_size: int = 32
    max_boxes: int = 120  # fixed label padding
    num_workers: int = 4
    worker_backend: str = "process"
    # train-time augmentation (data/augment.py::build_augmentation):
    # 'name' / 'name:p' strings or {op: name, **kwargs} dicts; empty keeps
    # the command's default recipe
    augment: list = field(default_factory=list)
    cache: bool = False
    # packed YUV 4:2:0 batches (half the host -> device bytes), decoded on
    # the card; eval reads JPEGs with the fused JPEG -> I420 decode
    i420: bool = False
    num_frames: int = 16
    frame_strategy: str = "average"
    # corrupt-file policy for TRAIN loaders ('skip' | 'raise'); val and
    # eval loaders always raise
    on_corrupt: str = "skip"
    eval_clips: int = 1
    # 'auto' / 'i/n': each rank's train loader decodes its strided share of
    # every epoch and batch_size is per rank (data/pipeline.py::resolve_host_shard)
    host_shard: str = ""


@dataclass
class TrainConfig:
    epochs: int = 100
    lr: float = 1e-4
    final_lr: float = 1e-6
    optimizer: str = "sgd"  # 'sgd' | 'adam'
    momentum: float = 0.937
    weight_decay: float = 5e-4
    nesterov: bool = True
    scheduler: str = "warmup_cosine"
    warmup_epochs: int = 3
    grad_clip_norm: float = 0.0  # 0 disables
    accum_steps: int = 1  # optimizer-level accumulation (MultiSteps)
    microbatch: int = 1  # in-step accumulation over N microbatches per batch
    remat: bool = False  # recompute the forward in backward (activation memory)
    multiscale: list = field(default_factory=list)  # per-epoch train sizes
    ema_decay: float = 0.0  # > 0 enables EMA weights for eval / checkpoint
    label_smoothing: float = 0.0
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    neighbor_cells: bool = False
    no_aug_epochs: int = 0
    seed: int = 0
    bf16: bool = True
    start_epoch: int = 0
    ckpt_dir: str = "./checkpoints"
    save_every_epoch: bool = True
    eval_every: int = 1
    # checkpoint-and-exit on SIGTERM; resume then finishes the interrupted epoch
    preempt_save: bool = True


@dataclass
class ModelConfig:
    name: str = "yolov3"
    backbone: str = "darknet53"
    num_classes: int = 80
    pretrained: str = ""  # a torch checkpoint path
    freeze: list = field(default_factory=list)  # parameter-name substrings
    # True: COCO anchors scale with data.input_size / 416; False keeps the
    # canonical pixel anchors at any input size (checkpoint-parity eval)
    scale_anchors_with_input: bool = True
    anchor_scales: list = field(default_factory=list)  # faster_rcnn; [] = default
    # faster_rcnn: the reference checkpoint's anchor / decode / clip semantics
    reference_compat: bool = False


@dataclass
class NMSConfig:
    conf_thres: float = 0.25
    iou_thres: float = 0.45
    max_det: int = 300
    pre_nms_top_k: int = 1024
    multi_label: bool = False


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    nms: NMSConfig = field(default_factory=NMSConfig)
    # the mesh over the process group (core/mesh.py): mesh_data (0 = every
    # rank that the other axes leave) x mesh_model (tensor parallel) x
    # mesh_time (time sharding) must equal the world size. fsdp=true shards
    # parameters and optimizer state 1/N
    # (parallel/fsdp.py). multihost=true joins torchrun's process group
    # (NCCL on CUDA, gloo on the CPU) and fails when it cannot form
    mesh_data: int = 0
    mesh_model: int = 1
    mesh_time: int = 1
    fsdp: bool = False
    multihost: bool = False
    # a directory for the native libraries' builds, kept across restarts
    # (core.mesh.enable_compile_cache; the JAX package keeps XLA's there)
    compile_cache: str = ""
