"""One rank of the port's parallelism checks on the CPU (gloo).

    python tests/torch_dist_worker.py <scenario> <rank> <world> <port> <workdir>

Started by tests/test_torch_distributed.py (scenario ``dp``),
tests/test_torch_fsdp.py (``fsdp``), tests/test_torch_tensor_shard.py
(``tp2``: a 1 x 2 x 1 mesh, ``tp4``: 2 x 2 x 1), tests/test_torch_time_shard.py
(``time2``: 1 x 1 x 2), tests/test_torch_frcnn_distributed.py
(``frcnn2``: 2 x 1 x 1) and tests/test_torch_pipeline.py (``pipe4``: 4
ranks, 1 x 4 x 1 then 2 x 2 x 1), once per rank, on inputs the
test wrote into ``workdir``; each rank saves what it computed to
``workdir/<scenario>_rank<rank>.pt`` for the test to compare (the ranks
but 0 save large tensors as digests). Imports no
JAX: the JAX side of each comparison runs in the test.
"""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)


def _load(workdir, name):
    return torch.load(os.path.join(workdir, name), weights_only=False)


def _fit(model, loss_fn, optimizer, mesh=None, dtype=torch.float64, **kw):
    from fastvision_tpu_torch.train import Fit, make_train_step

    step = kw.pop("step_fn", None) or make_train_step(loss_fn, dtype)
    return Fit(model, loss_fn, optimizer, None, mesh=mesh, step_fn=step, device="cpu", **kw)


def _plain_state(state):
    """A TrainState's (model state, optimizer state) in the single-process
    format (on rank 0; a collective under FSDP)."""
    from fastvision_tpu_torch.parallel import full_state
    from fastvision_tpu_torch.train.steps import parallel_kind, unwrap

    from fastvision_tpu_torch.parallel import tensor_shard

    model = unwrap(state.model)
    if parallel_kind(model) == "fsdp":
        return full_state(model, state.optimizer)
    if tensor_shard.is_tensor_parallel(model):
        return tensor_shard.full_state(model, state.optimizer)
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            state.optimizer.state_dict())


def _equal_to_file(workdir, model_sd, opt_sd, name="plain_ckpt") -> bool | None:
    """The gathered state bit-equal to the one-process checkpoint's (None
    on ranks that hold no gathered state)."""
    from fastvision_tpu_torch.core import CheckpointManager

    if not model_sd:
        return None
    plain = CheckpointManager(os.path.join(workdir, name)).restore(0)["state"]
    return (all(torch.equal(model_sd[k], v) for k, v in plain["model"].items())
            and all(torch.equal(opt_sd["state"][i]["momentum_buffer"], s["momentum_buffer"])
                    for i, s in plain["optimizer"]["state"].items()))


def max_rel_to_std(got: dict, want: dict) -> float:
    """max over the float tensors of max|got - want| / std(want) (1 for a
    tensor of no spread)."""
    worst = 0.0
    for k, w in want.items():
        if w.is_floating_point() and w.numel() > 1:
            d = float((got[k].double() - w.double()).abs().max())
            worst = max(worst, d / (float(w.double().std()) or 1.0))
    return worst


def digest(t: torch.Tensor) -> str:
    import hashlib

    t = t.detach().cpu().contiguous()
    return f"{t.dtype}{tuple(t.shape)}" + hashlib.sha1(t.numpy().tobytes()).hexdigest()


def _digest_large(obj):
    """``obj`` with every tensor of more than 10^4 elements replaced by its
    `digest` (what ranks other than 0 save: enough to hold them bit-equal
    to rank 0)."""
    if isinstance(obj, torch.Tensor) and obj.numel() > 10_000:
        return digest(obj)
    if isinstance(obj, dict):
        return {k: _digest_large(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_digest_large(v) for v in obj)
    return obj


def same(a: torch.Tensor, b) -> bool:
    """Rank 0's tensor ``a`` bit-equal to another rank's ``b`` (a tensor or
    its `digest`)."""
    return digest(a) == b if isinstance(b, str) else torch.equal(a, b)


def _yolo(workdir, num_classes):
    from fastvision_tpu_torch.models import YOLOv3

    model = YOLOv3(num_classes=num_classes, stage_sizes=(1, 1, 1, 1, 1))
    model.load_state_dict(_load(workdir, "yolo_init.pt"))
    return model.double()


def _resnet(state=None, k=10):
    from fastvision_tpu_torch.models import classification as tz

    model = tz.ResNet(tz.Bottleneck, (1, 1, 1, 1), num_classes=k, groups=4, base_width=4,
                      generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    return model.double()


def _batches(arrays, mesh):
    from fastvision_tpu_torch.core import shard_batch

    return [shard_batch({k: torch.from_numpy(v[i]) for k, v in arrays.items()}, mesh)
            for i in range(len(next(iter(arrays.values()))))]


def check_global_bn(rank, world, out):
    """Global BN on this rank's slice vs one process on the global batch."""
    from fastvision_tpu_torch.core.distributed import data_parallel
    from fastvision_tpu_torch.nn.layers import BatchNorm

    g = np.random.default_rng(7)
    # the ranks' slices have different statistics
    x = g.normal(0, 1, (4, 6, 5, 5)) * np.array([1, 1, 4, 4])[:, None, None, None] + \
        np.array([0, 0, 3, 3])[:, None, None, None]
    dy = g.normal(0, 1, x.shape)
    w, b = g.normal(1, 0.2, 6), g.normal(0, 0.2, 6)

    def run(xs, dys, dp):
        bn = BatchNorm(6).double()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(w))
            bn.bias.copy_(torch.from_numpy(b))
        xt = torch.from_numpy(xs).requires_grad_(True)
        with data_parallel() if dp else torch.enable_grad():
            for _ in range(2):  # the running statistics move twice
                y = bn(xt)
        (y * torch.from_numpy(dys)).sum().backward()
        return {"y": y.detach(), "dx": xt.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
                "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}

    s = slice(rank * 4 // world, (rank + 1) * 4 // world)
    out["bn_full"] = run(x, dy, False)
    local = run(x[s], dy[s], True)
    for k in ("dw", "db"):  # the ranks' shares sum to the global gradient
        torch.distributed.all_reduce(local[k])
    out["bn_local"] = local
    out["bn_slice"] = (s.start, s.stop)


def check_yolo_accum(workdir, mesh, out):
    """The YOLOv3 loss under DDP with MultiSteps(2): two calls, one update;
    then one step of 2 microbatches."""
    from fastvision_tpu_torch.train import YOLOv3Loss, build_optimizer, make_train_step

    inputs = _load(workdir, "yolo_inputs.pt")
    model = _yolo(workdir, inputs["num_classes"])
    loss_obj = YOLOv3Loss(inputs["anchors"], num_classes=inputs["num_classes"])

    def loss_fn(heads, batch):
        o = loss_obj(heads, batch["labels"])
        return o.total, {"box": o.box, "obj": o.obj, "cls": o.cls}

    fit = _fit(model, loss_fn, build_optimizer("sgd", model, accum_steps=2), mesh)
    metrics = []
    for batch, lr in zip(_batches(inputs["batches"], mesh), inputs["lrs"]):
        fit.state, m = fit.step_fn(fit.state, batch, lr)
        metrics.append({k: float(v) for k, v in m.items()})
    out["yolo"] = {"metrics": metrics, "state": _plain_state(fit.state)[0],
                   "positives": [int((b["labels"][..., 0] >= 0).sum())
                                 for b in _batches(inputs["batches"], mesh)]}
    # in-step microbatches: one step of 2 over the first global batch
    model = _yolo(workdir, inputs["num_classes"])
    fit = _fit(model, loss_fn, build_optimizer("sgd", model), mesh,
               step_fn=make_train_step(loss_fn, torch.float64, accum_steps=2))
    fit.state, m = fit.step_fn(fit.state, _batches(inputs["batches"], mesh)[0], inputs["lrs"][0])
    out["yolo_micro"] = {"metrics": {k: float(v) for k, v in m.items()},
                         "state": _plain_state(fit.state)[0]}


def check_cls_mix(workdir, mesh, out):
    """A classifier step with mixup, then one with cutmix, under DDP."""
    from fastvision_tpu_torch.train import (build_optimizer, make_classification_mix,
                                            make_train_step, soft_cross_entropy)

    inputs = _load(workdir, "cls_inputs.pt")
    model = _resnet(inputs["state"])
    mix = make_classification_mix(inputs["k"], **inputs["mix"])
    draws = inputs["draws"]
    fit = None

    def transform(batch, rng):
        return mix(batch, draws=draws[fit.state.step])

    def loss_fn(logits, batch):
        return soft_cross_entropy(logits, batch["soft"]), {}

    step = make_train_step(loss_fn, torch.float64, imagenet=True, batch_transform=transform)
    fit = _fit(model, loss_fn, build_optimizer("sgd", model), mesh, step_fn=step)
    metrics, states = [], []
    for batch in _batches(inputs["batches"], mesh):
        fit.state, m = fit.step_fn(fit.state, batch, 1e-2)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_plain_state(fit.state)[0])
    out["cls"] = {"metrics": metrics, "states": states,
                  "buffers_equal": _buffers_agree(fit.state.model)}


def check_preempt(rank, workdir, mesh, out):
    """Rank 1 asks to stop during the second of an epoch's 3 steps, after
    the epoch's only agreement (before step 0): both ranks must stop at
    the epoch's end, before validation, and rank 0 write one checkpoint."""
    from fastvision_tpu_torch.core.distributed import all_gather_cat
    from fastvision_tpu_torch.nn.layers import BatchNorm
    from fastvision_tpu_torch.train import Fit, build_optimizer, cross_entropy, make_train_step

    g = np.random.default_rng(2)

    class Loader:
        batches = [{"images": torch.from_numpy(g.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)),
                    "labels": torch.from_numpy(g.integers(0, 4, 4))} for _ in range(3)]

        def epoch(self, e, start_batch=0):
            return iter(self.batches[start_batch:])

    def loss_fn(logits, batch):
        return cross_entropy(logits, batch["labels"]), {}

    inner = make_train_step(loss_fn, torch.float64)
    fit = None

    def step(state, batch, lr):
        if rank == 1 and fit.global_step == 1:
            fit.request_preempt()
        return inner(state, batch, lr)

    def evaluator(state, loader):  # a collective, as the evaluators run
        return {"ranks": float(all_gather_cat(torch.ones(1, dtype=torch.float64)).sum())}

    class Tiny(torch.nn.Module):  # NHWC in, as the zoo's models
        def __init__(self):
            super().__init__()
            self.body = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1), BatchNorm(4),
                                            torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
                                            torch.nn.Linear(4, 4))

        def forward(self, x):
            return self.body(x.permute(0, 3, 1, 2))

    model = Tiny().double()
    ckpt = os.path.join(workdir, "preempt_ckpt")
    fit = Fit(model, loss_fn, build_optimizer("sgd", model), Loader(), val_loader=Loader(),
              evaluator=evaluator, epochs=2, mesh=mesh, step_fn=step, ckpt_dir=ckpt,
              device="cpu")
    fit.run()
    out["preempt"] = {"interrupted": fit.interrupted, "global_step": fit.global_step}


def _buffers_agree(model) -> bool:
    """Every BN buffer is the same on every rank (DDP broadcasts none)."""
    from fastvision_tpu_torch.core.distributed import all_gather_cat

    for b in model.buffers():
        both = all_gather_cat(b.detach().reshape(1, -1).double())
        if not torch.equal(both[0], both[-1]):
            return False
    return True


def check_loaders(workdir, out):
    """Each loader's host-sharded epochs ('auto': from the group)."""
    from fastvision_tpu_torch.data import (ClassificationDataset, ClassificationLoader,
                                           DetectionDataset, DetectionLoader, VideoClipLoader,
                                           VideoFolderDataset)
    from fastvision_tpu_torch.data.augment import Augmentation, HorizontalFlip, HSVJitter

    root = os.path.join(workdir, "data")
    loaders = {
        "det": DetectionLoader(
            DetectionDataset(os.path.join(root, "det"), "train"), 64, 2, 8, train=True,
            augmentation=Augmentation([HorizontalFlip(p=0.5), HSVJitter(p=0.5)]),
            mosaic_prob=0.5, seed=3, host_shard="auto", num_workers=2),
        "cls": ClassificationLoader(
            ClassificationDataset(os.path.join(root, "cls"), "train"), 32, 2,
            augmentation=Augmentation([HorizontalFlip(p=0.5)]), seed=3, host_shard="auto"),
        "video": VideoClipLoader(
            VideoFolderDataset(os.path.join(root, "video"), "train"), num_frames=4, size=16,
            batch_size=1, seed=3, host_shard="auto", num_workers=2,
            worker_backend="process"),
    }
    res = {}
    for name, loader in loaders.items():
        res[name] = {"len": len(loader), "host": (loader.host_index, loader.host_count),
                     "epochs": [[{"images": b["images"], "labels": b["labels"]}
                                 for b in loader.epoch(e)] for e in (0, 1)]}
        loader.close()
    out["loaders"] = res


def check_evaluators(workdir, mesh, out):
    """The three evaluators with the mesh (each rank its share of every
    batch) and without (this process alone, every batch whole)."""
    from fastvision_tpu_torch.data import (ClassificationDataset, ClassificationLoader,
                                           DetectionDataset, DetectionLoader, VideoClipLoader,
                                           VideoFolderDataset)
    from fastvision_tpu_torch.infer import decode_predictions
    from fastvision_tpu_torch.models.video import SlowFast
    from fastvision_tpu_torch.ops import batched_non_max_suppression
    from fastvision_tpu_torch.train import (TrainState, classification_evaluator,
                                            detection_evaluator, make_eval_step,
                                            video_multiclip_evaluator)

    root = os.path.join(workdir, "data")
    inputs = _load(workdir, "yolo_inputs.pt")
    anchors = torch.from_numpy(inputs["anchors"])

    def postprocess(heads, batch):
        pred = decode_predictions(heads, anchors, (32, 16, 8), "v5")
        return batched_non_max_suppression(pred.float(), conf_thres=0.3, iou_thres=0.45,
                                           max_det=20, pre_nms_top_k=64)

    det_loader = DetectionLoader(DetectionDataset(os.path.join(root, "det"), "val"), 64, 4, 8,
                                 train=False)
    cls_loader = ClassificationLoader(ClassificationDataset(os.path.join(root, "cls"), "val"),
                                      32, 4, train=False)
    vid_loader = VideoClipLoader(VideoFolderDataset(os.path.join(root, "video"), "val"),
                                 num_frames=4, size=16, batch_size=4, train=False)
    g = torch.Generator().manual_seed(1)
    vid = SlowFast((1, 1, 1, 1), alpha=4, beta_inv=4, expansion=1, num_classes=4,
                   generator=g).double()
    cases = {
        "det": (lambda m: detection_evaluator(make_eval_step(postprocess, torch.float64),
                                              mesh=m),
                _yolo(workdir, inputs["num_classes"]), det_loader),
        "cls": (lambda m: classification_evaluator(
                    make_eval_step(dtype=torch.float64, imagenet=True), mesh=m),
                _resnet(k=4), cls_loader),
        "video": (lambda m: video_multiclip_evaluator(
                      make_eval_step(dtype=torch.float64, imagenet=True), n_clips=2, mesh=m),
                  vid, vid_loader),
    }
    res = {}
    for name, (build, model, loader) in cases.items():
        state = TrainState.create(model, None, "cpu")
        res[name] = {"mesh": build(mesh)(state, loader), "alone": build(None)(state, loader)}
        loader.close()
    out["evaluators"] = res


def check_fsdp(rank, workdir, mesh, out):
    """FSDP vs DDP: two SGD + momentum steps of a small ResNet, the bytes
    each rank holds, a many-unit sharding of a YOLOv3, and checkpoints."""
    from fastvision_tpu_torch.parallel import fsdp_shard_module, fsdp_spec
    from fastvision_tpu_torch.train import build_optimizer, cross_entropy

    inputs = _load(workdir, "fsdp_inputs.pt")

    def loss_fn(logits, batch):
        return cross_entropy(logits, batch["labels"]), {}

    res = {}
    for kind in ("ddp", "fsdp"):
        model = _resnet(inputs["state"])
        opt = build_optimizer("sgd", model, momentum=0.9)
        fit = _fit(model, loss_fn, opt, mesh, fsdp=kind == "fsdp",
                   ckpt_dir=os.path.join(workdir, f"ckpt_{kind}"))
        metrics = []
        for batch in _batches(inputs["batches"], mesh):
            fit.state, m = fit.step_fn(fit.state, batch, 1e-2)
            metrics.append({k: float(v) for k, v in m.items()})
        if kind == "fsdp":
            local = sharded = full = 0
            for p in fit.state.model.parameters():
                full += p.numel() * p.element_size()
                if fsdp_spec(p, mesh.data) is not None:
                    sharded += p.numel() * p.element_size()
                    local += p.to_local().numel() * p.element_size()
            res["bytes"] = {"local": local, "sharded": sharded, "full": full,
                            "placements": {n: str(p.placements[0]) for n, p in
                                           fit.state.model.named_parameters()}}
        fit._save(0, {"epoch": 0, "global_step": 2})
        model_sd, opt_sd = _plain_state(fit.state)
        res[kind] = {"metrics": metrics, "state": model_sd, "optimizer": opt_sd}
        # the reverse direction: a one-process checkpoint resumed under this placement
        model = _resnet(inputs["state"])
        fit = _fit(model, loss_fn, build_optimizer("sgd", model, momentum=0.9), mesh,
                   fsdp=kind == "fsdp", ckpt_dir=os.path.join(workdir, "plain_ckpt"),
                   resume=True)
        model_sd, opt_sd = _plain_state(fit.state)
        res[f"{kind}_resumed"] = {"epoch": fit.start_epoch,
                                  "equal_to_file": _equal_to_file(workdir, model_sd, opt_sd)}

    # many units (each ConvBN / block its own all-gather): the step equals DDP's
    from fastvision_tpu_torch.train import YOLOv3Loss, make_train_step

    yin = _load(workdir, "yolo_inputs.pt")
    loss_obj = YOLOv3Loss(yin["anchors"], num_classes=yin["num_classes"])

    def yolo_loss(heads, batch):
        return loss_obj(heads, batch["labels"]).total, {}

    from fastvision_tpu_torch.parallel import rebind_optimizer
    from fastvision_tpu_torch.train import TrainState

    batch = _batches({k: v[:1] for k, v in yin["batches"].items()}, mesh)[0]
    got = {}
    for kind in ("ddp", "units"):
        model = _yolo(workdir, yin["num_classes"])
        opt = build_optimizer("sgd", model, momentum=0.9)
        if kind == "ddp":
            state = _fit(model, yolo_loss, opt, mesh).state
        else:
            state = TrainState.create(model, opt, "cpu")
            names = fsdp_shard_module(model, mesh.data, unit_numel=2000)
            rebind_optimizer(opt, names, model)
            got["n_units"] = sum(1 for m in model.modules()
                                 if type(m).__name__.startswith("FSDP"))
        state, m = make_train_step(yolo_loss, torch.float64)(state, batch, 1e-2)
        got[kind] = {"loss": float(m["loss"]), "state": _plain_state(state)[0]}
    if rank == 0:  # the gathered state is rank 0's
        got["max_rel_to_std"] = max_rel_to_std(got["units"].pop("state"),
                                               got["ddp"].pop("state"))
    res["units"] = got

    # microbatches: every backward but the last skips the reduction (DDP's
    # no_sync, FSDP's set_requires_gradient_sync)
    micro = {}
    for kind in ("ddp", "fsdp"):
        model = _resnet(inputs["state"])
        fit = _fit(model, loss_fn, build_optimizer("sgd", model, momentum=0.9), mesh,
                   fsdp=kind == "fsdp",
                   step_fn=make_train_step(loss_fn, torch.float64, accum_steps=2))
        for batch in _batches(inputs["batches"], mesh):
            fit.state, m = fit.step_fn(fit.state, batch, 1e-2)
        micro[kind] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                       "state": _plain_state(fit.state)[0]}
    res["microbatch"] = micro
    out["fsdp"] = res


def check_cli_fsdp(workdir, out):
    """``train-cls ... mesh_data=2 fsdp=true multihost=true`` on this rank."""
    import json

    from fastvision_tpu_torch import cli

    cli._build_zoo_model = lambda cfg, task="cls": _resnet(k=cfg.model.num_classes).float()
    ckpt = os.path.join(workdir, "cli_ckpt")
    fit = cli.main([
        "train-cls", f"data.data_root={os.path.join(workdir, 'data', 'cls')}",
        "data.input_size=32", "data.batch_size=4", "data.num_workers=0",
        "model.num_classes=4", f"train.ckpt_dir={ckpt}", "train.epochs=2",
        "train.warmup_epochs=0", "train.bf16=false", "train.mixup_alpha=0.2",
        "mesh_data=2", "fsdp=true", "multihost=true", "data.host_shard=auto",
        "--device", "cpu"])
    recs = []
    if os.path.exists(os.path.join(ckpt, "train.jsonl")):
        with open(os.path.join(ckpt, "train.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    out["cli"] = {"records": recs, "kind": type(fit.state.model).__name__,
                  "steps": fit.global_step}


# (data, model, time) of each scenario's mesh (the others: every rank on data)
MESHES = {"tp2": (1, 2, 1), "tp4": (2, 2, 1), "time2": (1, 1, 2), "frcnn2": (2, 1, 1),
          "pipe4": (1, 4, 1)}


def _tiny_det_loss(inputs):
    from fastvision_tpu_torch.train import YOLOv3Loss

    loss_obj = YOLOv3Loss(inputs["anchors"], num_classes=inputs["num_classes"])

    def loss_fn(heads, batch):
        o = loss_obj(heads, batch["labels"])
        return o.total, {"box": o.box, "obj": o.obj, "cls": o.cls}

    return loss_fn


def _shallow_yolo(inputs):
    from fastvision_tpu_torch.models import YOLOv3

    model = YOLOv3(num_classes=inputs["num_classes"], stage_sizes=(1, 1, 1, 1, 1)).double()
    model.load_state_dict(inputs["state"])  # a float64 state stays exact
    return model


def check_tp_yolo(workdir, mesh, out):
    """One SGD step (momentum 0.9, clip 10) of a shallow YOLOv3 with its
    channels sharded over the model axis, every rank on the global batch;
    an eval forward against this process's unsharded model; Fit's
    placement with fsdp=True on a model axis (tensor parallel wins)."""
    from fastvision_tpu_torch.parallel import tensor_shard
    from fastvision_tpu_torch.train import TrainState, build_optimizer, make_train_step
    from fastvision_tpu_torch.train.steps import parallel_kind

    inputs = _load(workdir, "tp_yolo_inputs.pt")
    loss_fn = _tiny_det_loss(inputs)
    model = _shallow_yolo(inputs)
    fit = _fit(model, loss_fn, build_optimizer("sgd", model, momentum=0.9, grad_clip_norm=10.0),
               mesh, fsdp=True, ckpt_dir=os.path.join(workdir, "tp_ckpt"), ema_decay=0.9)
    local = {n: tuple(p.shape) for n, p in model.named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    fit.state, m = fit.step_fn(fit.state, batch, inputs["lr"])
    res = {"metrics": {k: float(v) for k, v in m.items()}, "state": _plain_state(fit.state)[0],
           "local_shapes": local, "kind": parallel_kind(fit.state.model),
           "tensor_parallel": tensor_shard.is_tensor_parallel(fit.state.model)}
    # eval forward: the sharded model (after the step) against the same weights whole
    whole = _shallow_yolo({**inputs, "state": res["state"]})
    from fastvision_tpu_torch.train import make_eval_step

    step = make_eval_step(dtype=torch.float64)
    got = step(fit.state, batch)
    want = step(TrainState.create(whole, None, "cpu"), batch)
    res["eval_max_rel"] = max(float((g - w).abs().max() / w.std()) for g, w in zip(got, want))
    out["tp_yolo"] = res
    return fit


def check_tp_checkpoints(workdir, mesh, out, fit):
    """``fit`` (at mesh_model=2, after its step) saves the one-process
    format (with the EMA and the momentum), and a one-process checkpoint
    resumes at mesh_model=2 (the reverse)."""
    from fastvision_tpu_torch.train import build_optimizer

    inputs = _load(workdir, "tp_yolo_inputs.pt")
    loss_fn = _tiny_det_loss(inputs)
    fit._ema_update(*fit._ema_pairs, fit.state.step)
    fit._save(0, {"epoch": 0, "global_step": 1})
    fit.ckpt.wait()
    model_sd, opt_sd = _plain_state(fit.state)
    from fastvision_tpu_torch.parallel import tensor_shard

    ema = tensor_shard.full_state(fit.ema_model)[0]
    res = {"state": model_sd, "optimizer": opt_sd,
           "ema": {k: ema[k] for k, _ in fit.ema_model.named_parameters()}}
    model = _shallow_yolo(inputs)
    fit = _fit(model, loss_fn, build_optimizer("sgd", model, momentum=0.9), mesh,
               ckpt_dir=os.path.join(workdir, "plain_tp_ckpt"), resume=True)
    model_sd, opt_sd = _plain_state(fit.state)
    res["resumed_epoch"] = fit.start_epoch
    res["resumed_equal_to_file"] = _equal_to_file(workdir, model_sd, opt_sd,
                                                  name="plain_tp_ckpt")
    out["tp_ckpt"] = res


def check_loaders_by_data_index(workdir, out):
    """host_shard='auto' on a data x model mesh: the data index's share."""
    from fastvision_tpu_torch.data import ClassificationDataset, ClassificationLoader

    loader = ClassificationLoader(
        ClassificationDataset(os.path.join(workdir, "data", "cls"), "train"), 32, 2, seed=3,
        host_shard="auto")
    out["loader"] = {"host": (loader.host_index, loader.host_count),
                     "labels": [b["labels"] for b in loader.epoch(0)],
                     "images": [b["images"] for b in loader.epoch(0)]}
    loader.close()


def check_tp_resnet(workdir, mesh, out):
    """One SGD step of ResNet-18 over a 2 x 2 (data x model) mesh."""
    from fastvision_tpu_torch.models import classification as tz
    from fastvision_tpu_torch.train import build_optimizer, cross_entropy, make_train_step

    inputs = _load(workdir, "tp_resnet_inputs.pt")
    model = tz.resnet18(num_classes=inputs["k"])
    model.load_state_dict(inputs["state"])
    model.double()

    def loss_fn(logits, batch):
        return cross_entropy(logits, batch["labels"]), {}

    fit = _fit(model, loss_fn, build_optimizer("sgd", model), mesh,
               step_fn=make_train_step(loss_fn, torch.float64, imagenet=True))
    (batch,) = _batches({k: v[None] for k, v in inputs["batch"].items()}, mesh)
    fit.state, m = fit.step_fn(fit.state, batch, inputs["lr"])
    out["tp_resnet"] = {"metrics": {k: float(v) for k, v in m.items()},
                        "state": _plain_state(fit.state)[0],
                        "local_batch": int(batch["images"].shape[0]),
                        "buffers_equal": _buffers_agree(fit.state.model)}


def check_cli_tp(workdir, out):
    """``train-cls ... mesh_data=2 mesh_model=2 multihost=true`` on 4 ranks,
    then ``eval --task cls`` of its checkpoint at mesh_model=2."""
    import json

    from fastvision_tpu_torch import cli

    cli._build_zoo_model = lambda cfg, task="cls", **kw: _resnet(k=cfg.model.num_classes).float()
    ckpt = os.path.join(workdir, "cli_tp_ckpt")
    common = [f"data.data_root={os.path.join(workdir, 'data', 'cls')}", "data.input_size=32",
              "data.batch_size=4", "data.num_workers=0", "model.num_classes=4",
              "train.bf16=false", "mesh_data=2", "mesh_model=2", "multihost=true",
              "--device", "cpu"]
    fit = cli.main(["train-cls", f"train.ckpt_dir={ckpt}", "train.epochs=2",
                    "train.warmup_epochs=0", "fsdp=true", *common])
    recs = []
    if os.path.exists(os.path.join(ckpt, "train.jsonl")):
        with open(os.path.join(ckpt, "train.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    from fastvision_tpu_torch.parallel import tensor_shard

    res = cli.main(["eval", "--task", "cls", "--ckpt", ckpt, *common])
    out["cli"] = {"records": recs, "steps": fit.global_step,
                  "tensor_parallel": tensor_shard.is_tensor_parallel(fit.state.model),
                  "eval": res["accuracy"]}


def _temporal_conv_valid(x, kernel):
    k = len(kernel)
    return sum(x[:, i:x.shape[1] - (k - 1 - i)] * kernel[i] for i in range(k))


def check_time_sharded_conv(workdir, out):
    """`time_sharded_conv` on tests/test_time_shard.py's case and its
    gradient (this rank's share of the clip's)."""
    from fastvision_tpu_torch.parallel import time_sharded_conv

    inputs = _load(workdir, "time_conv_inputs.pt")
    clip = inputs["clip"].clone().requires_grad_(True)
    y = time_sharded_conv(lambda x: _temporal_conv_valid(x, inputs["kernel"]), clip, halo=1)
    (y * inputs["cotangent"]).sum().backward()
    out["time_conv"] = {"y": y.detach(), "grad": clip.grad}


def _small_slowfast(inputs, time_axis=None, dtype=torch.float64):
    from fastvision_tpu_torch.models.video import SlowFast

    model = SlowFast((1, 1, 1, 1), **inputs["kw"], time_axis=time_axis)
    model.load_state_dict(inputs["state"])
    return model.to(dtype)


def check_time_slowfast(workdir, mesh, out):
    """One SGD step of a small SlowFast with the clip's frames sharded over
    the time axis; its float32 eval forward."""
    from fastvision_tpu_torch.train import (TrainState, build_optimizer, cross_entropy,
                                            make_eval_step, make_train_step)

    inputs = _load(workdir, "time_inputs.pt")
    model = _small_slowfast(inputs, "time")

    def loss_fn(logits, batch):
        return cross_entropy(logits, batch["labels"]), {}

    fit = _fit(model, loss_fn, build_optimizer("sgd", model, weight_decay=1e-4, momentum=0.9),
               mesh, step_fn=make_train_step(loss_fn, torch.float64, imagenet=True))
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    fit.state, m = fit.step_fn(fit.state, batch, 1e-2)
    res = {"metrics": {k: float(v) for k, v in m.items()}, "state": _plain_state(fit.state)[0],
           "buffers_equal": _buffers_agree(fit.state.model)}
    eval32 = TrainState.create(_small_slowfast(inputs, "time", torch.float32), None, "cpu")
    res["eval32"] = make_eval_step(dtype=torch.float32, imagenet=True)(eval32, batch)
    try:
        bad = {"images": batch["images"][:, :6]}
        make_eval_step(dtype=torch.float32, imagenet=True)(eval32, bad)
    except ValueError as e:
        res["uneven"] = str(e)
    out["time_slowfast"] = res


def check_cli_time(workdir, out):
    """``train-video ... mesh_time=2 multihost=true`` on a small SlowFast,
    then the refusal of a backbone without time_axis."""
    import json

    from fastvision_tpu_torch import cli
    from fastvision_tpu_torch.models import video as zoo

    inputs = _load(workdir, "time_inputs.pt")
    build = cli._build_zoo_model
    cli._build_zoo_model = lambda cfg, task="cls", **kw: zoo.SlowFast(
        (1, 1, 1, 1), **{**inputs["kw"], "num_classes": cfg.model.num_classes}, **kw)
    ckpt = os.path.join(workdir, "cli_time_ckpt")
    common = [f"data.data_root={os.path.join(workdir, 'data', 'video')}", "data.input_size=32",
              "data.num_frames=8", "data.batch_size=2", "data.num_workers=0",
              "model.num_classes=4", "model.backbone=slowfast_resnet18", "train.bf16=false",
              "mesh_time=2", "multihost=true", "--device", "cpu"]
    fit = cli.main(["train-video", f"train.ckpt_dir={ckpt}", "train.epochs=1",
                    "train.warmup_epochs=0", *common])
    with open(os.path.join(ckpt, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    res = cli.main(["eval", "--task", "video", "--ckpt", ckpt, *common])
    from fastvision_tpu_torch.train.steps import unwrap

    out["cli"] = {"records": recs, "steps": fit.global_step, "eval": res["accuracy"],
                  "time_axis": unwrap(fit.state.model).time_axis}
    cli._build_zoo_model = build
    try:
        cli.main(["train-video", f"train.ckpt_dir={ckpt}_c3d", *common,
                  "model.backbone=c3d"])
    except SystemExit as e:
        out["cli"]["c3d"] = str(e)


def check_frcnn_step(workdir, mesh, out):
    """One SGD step (momentum 0.9, clip 10) of a small Faster R-CNN, each
    rank on its half of the global batch, with the global batch's draws."""
    from fastvision_tpu_torch.models import FasterRCNN
    from fastvision_tpu_torch.models.detection.faster_rcnn import Draws
    from fastvision_tpu_torch.train import build_optimizer, make_frcnn_train_step

    inputs = _load(workdir, "frcnn_inputs.pt")
    model = FasterRCNN(**inputs["cfg"])
    model.load_state_dict(inputs["state"])
    model.double()
    fit = _fit(model, None, build_optimizer("sgd", model, momentum=0.9, grad_clip_norm=10.0),
               mesh, step_fn=make_frcnn_train_step(seed=0, dtype=torch.float64))
    (batch,) = _batches({k: v[None] for k, v in inputs["batch"].items()}, mesh)
    draws = Draws(*(torch.from_numpy(d) for d in inputs["draws"]))
    fit.state, m = fit.step_fn(fit.state, batch, 1e-2, draws=draws)
    res = {"metrics": {k: float(v) for k, v in m.items()}, "state": _plain_state(fit.state)[0],
           "local_batch": int(batch["images"].shape[0])}
    # the same step under FSDP (data axis) and tensor parallel (a 1 x 2 x 1
    # mesh: every rank on the global batch)
    from fastvision_tpu_torch.core import create_mesh
    from fastvision_tpu_torch.train.steps import parallel_kind

    whole = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    for name, place, step_batch in (("fsdp", dict(mesh=mesh, fsdp=True), batch),
                                    ("tp", dict(mesh=create_mesh(1, 2, 1)), whole)):
        model = FasterRCNN(**inputs["cfg"])
        model.load_state_dict(inputs["state"])
        model.double()
        fit = _fit(model, None, build_optimizer("sgd", model, momentum=0.9,
                                                grad_clip_norm=10.0),
                   step_fn=make_frcnn_train_step(seed=0, dtype=torch.float64), **place)
        fit.state, m = fit.step_fn(fit.state, step_batch, 1e-2, draws=draws)
        res[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "state": _plain_state(fit.state)[0], "kind": parallel_kind(fit.state.model)}
    mesh = create_mesh(2, 1, 1)
    # the step's own draws (from its generator): this rank's rows of the global batch's
    model = FasterRCNN(**inputs["cfg"])
    model.load_state_dict(inputs["state"])
    model.double()
    fit = _fit(model, None, build_optimizer("sgd", model, momentum=0.9, grad_clip_norm=10.0),
               mesh, step_fn=make_frcnn_train_step(seed=0, dtype=torch.float64))
    fit.state, m = fit.step_fn(fit.state, batch, 1e-2)
    res["generator"] = {"metrics": {k: float(v) for k, v in m.items()},
                        "state": _plain_state(fit.state)[0]}
    out["frcnn"] = res


def check_cli_frcnn(workdir, out):
    """``train model.name=faster_rcnn mesh_data=2 multihost=true``."""
    import functools
    import json

    import fastvision_tpu_torch.models as models
    from fastvision_tpu_torch import cli

    inputs = _load(workdir, "frcnn_inputs.pt")
    cfg = {k: v for k, v in inputs["cfg"].items() if k not in ("num_classes", "image_size")}
    models.FasterRCNN = functools.partial(models.FasterRCNN, **cfg)
    ckpt = os.path.join(workdir, "cli_frcnn_ckpt")
    fit = cli.main(["train", "model.name=faster_rcnn",
                    f"data.data_root={os.path.join(workdir, 'data', 'det')}",
                    "data.input_size=64", "data.batch_size=2",
                    "data.num_workers=0", f"model.num_classes={inputs['cfg']['num_classes']}",
                    f"train.ckpt_dir={ckpt}", "train.epochs=1", "train.bf16=false",
                    "mesh_data=2", "multihost=true", "data.host_shard=auto", "--device", "cpu"])
    with open(os.path.join(ckpt, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    from fastvision_tpu_torch.train.steps import parallel_kind

    out["cli"] = {"records": recs, "steps": fit.global_step,
                  "kind": parallel_kind(fit.state.model),
                  "host": (fit.train_loader.host_index, fit.train_loader.host_count)}


def chain_stage(p, x):
    """tests/test_pipeline.py's homogeneous stage."""
    return torch.tanh(x @ p["w"] + p["b"])


def hetero_stage_fns() -> list:
    """tests/test_pipeline.py's heterogeneous dense stages (stage 2 has a
    ``gain``)."""
    return [chain_stage, chain_stage, lambda p, x: chain_stage(p, x) * p["gain"], chain_stage]


def vit_trunk_loss(tokens, head, labels):
    """A float64 head (``tokens[:, 0] @ w + b``) and the mean cross-entropy."""
    logits = tokens[:, 0] @ head["w"] + head["b"]
    return torch.nn.functional.cross_entropy(logits, labels)


def _named_grads(params: dict) -> dict:
    return {k: p.grad.clone() for k, p in params.items() if p.grad is not None}


def check_pipeline(workdir, out):
    """The GPipe schedule on a 4-stage model axis (1 x 4 x 1) and a 2-stage
    one (2 x 2 x 1): forwards and gradients of the tanh chain (8 and 2
    microbatches), the heterogeneous dense chain, a ViT trunk with a float64
    head and the ViT classifier (float32 head), and a ResNet split at its
    residual stages (in train mode: the split must run it in inference
    mode and leave its BN buffers and mode as they were)."""
    from fastvision_tpu_torch.core.mesh import Mesh, use_mesh
    from fastvision_tpu_torch.models.classification import BasicBlock, ResNet, ViT
    from fastvision_tpu_torch.parallel import (pipeline_apply, pipeline_hetero_apply,
                                               pipeline_vit_apply, resnet_stage_split)

    inputs = _load(workdir, "pipe_inputs.pt")
    for mesh in (Mesh(1, 4, 1), Mesh(2, 2, 1)):
        use_mesh(mesh)
        res = {}
        if mesh.model == 4:
            for n in (8, 2):
                stacked = {k: inputs["chain"][k].clone().requires_grad_(True) for k in ("w", "b")}
                y = pipeline_apply(chain_stage, stacked, inputs["chain"][f"mbs{n}"], mesh)
                (y ** 2).sum().backward()
                res[f"chain{n}"] = {"y": y.detach(), "w": stacked["w"].grad,
                                    "b": stacked["b"].grad}
            params = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
                      for p in inputs["hetero"]["params"]]
            y = pipeline_hetero_apply(hetero_stage_fns(), params, inputs["hetero"]["mbs"], mesh)
            (y ** 2).sum().backward()
            res["hetero"] = {"y": y.detach(), "grads": [{k: v.grad for k, v in p.items()}
                                                         for p in params]}
            errors = {}
            try:
                pipeline_hetero_apply(hetero_stage_fns()[:3], inputs["hetero"]["params"][:3],
                                      inputs["hetero"]["mbs"], mesh)
            except ValueError as e:
                errors["stage_count"] = str(e)
            try:
                pipeline_apply(chain_stage, {k: inputs["chain"][k][:2] for k in ("w", "b")},
                               inputs["chain"]["mbs8"], mesh)
            except ValueError as e:
                errors["stacked"] = str(e)
            res["errors"] = errors
        vi = inputs["vit"]
        trunk = ViT(**vi["kw"], including_top=False).double()
        trunk.load_state_dict(vi["trunk"])
        head = {k: v.clone().requires_grad_(True) for k, v in vi["head"].items()}
        tokens = pipeline_vit_apply(trunk, vi["images"].permute(0, 3, 1, 2), mesh, n_micro=4)
        vit_trunk_loss(tokens, head, vi["labels"]).backward()
        res["vit_trunk"] = {"tokens": tokens.detach(), "head": _named_grads(head),
                            "grads": _named_grads(dict(trunk.named_parameters()))}
        cls = ViT(**vi["kw"]).double()
        cls.load_state_dict(vi["cls"])
        cls.head.float()
        logits = pipeline_vit_apply(cls, vi["images"], mesh, n_micro=4)
        torch.nn.functional.cross_entropy(logits, vi["labels"]).backward()
        res["vit_cls"] = {"logits": logits.detach(),
                          "grads": _named_grads(dict(cls.named_parameters()))}
        rn = inputs["resnet"]
        model = ResNet(BasicBlock, (1, 1, 1, 1), num_classes=5).double()
        model.load_state_dict(rn["state"])
        model.train()
        buffers = {k: v.clone() for k, v in model.named_buffers()}
        fns, params = resnet_stage_split(model, mesh.model)
        images = rn["images"]
        y = pipeline_hetero_apply(fns, params, images.reshape(4, 2, *images.shape[1:]), mesh)
        logits = y.reshape(images.shape[0], -1)
        (logits ** 2).sum().backward()
        res["resnet"] = {"logits": logits.detach(),
                         "grads": _named_grads(dict(model.named_parameters())),
                         "buffers_unchanged": all(torch.equal(v, buffers[k])
                                                  for k, v in model.named_buffers()),
                         "still_training": all(m.training for m in model.modules())}
        out[f"stages{mesh.model}"] = res


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_ranks(scenario: str, workdir: str, world: int = 2, timeout: float = 300):
    """Start ``scenario`` on ``world`` ranks (one process each, a fresh TCP
    port). -> ``collect()``, which waits for them and returns what each rank
    saved, or raises with a failed rank's stderr."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r),
                               str(world), str(port), workdir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
             for r in range(world)]
    return lambda: _collect(procs, scenario, workdir, timeout)


def _collect(procs, scenario, workdir, timeout):
    world = len(procs)
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [torch.load(os.path.join(workdir, f"{scenario}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main():
    scenario, rank, world, port, workdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port, LOCAL_RANK=str(rank))
    from fastvision_tpu_torch.core import create_mesh, initialize_multihost

    initialize_multihost(device="cpu", timeout_s=120)
    mesh = create_mesh(*MESHES.get(scenario, ()))
    out = {"coords": mesh.coords()}
    if scenario == "dp":
        check_global_bn(rank, world, out)
        check_yolo_accum(workdir, mesh, out)
        check_cls_mix(workdir, mesh, out)
        check_loaders(workdir, out)
        check_evaluators(workdir, mesh, out)
        check_preempt(rank, workdir, mesh, out)
    elif scenario == "fsdp":
        check_fsdp(rank, workdir, mesh, out)
        check_cli_fsdp(workdir, out)
    elif scenario == "tp2":
        check_tp_checkpoints(workdir, mesh, out, check_tp_yolo(workdir, mesh, out))
    elif scenario == "tp4":
        check_loaders_by_data_index(workdir, out)
        check_tp_resnet(workdir, mesh, out)
        check_cli_tp(workdir, out)
    elif scenario == "time2":
        check_time_sharded_conv(workdir, out)
        check_time_slowfast(workdir, mesh, out)
        check_cli_time(workdir, out)
    elif scenario == "frcnn2":
        check_frcnn_step(workdir, mesh, out)
        check_cli_frcnn(workdir, out)
    elif scenario == "pipe4":
        check_pipeline(workdir, out)
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    # the pipeline's ranks each hold other stages' gradients: saved whole
    torch.save(out if rank == 0 or scenario == "pipe4" else _digest_large(out),
               os.path.join(workdir, f"{scenario}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
