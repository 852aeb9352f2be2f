"""Port's Fit harness: end to end against the JAX package's Fit (same
weights, same JPEGs, Adam, EMA, validation every epoch through
detection_evaluator), and the harness's own behaviours on the CPU.

Tolerances: global_step equal; per-epoch train loss rtol 1e-4 (float32
gradients of the two packages differ at ~5e-5 of the largest one, see
test_torch_train_step.py, and Adam turns that into slightly different
trajectories); map50 and map within 1e-3 absolute. The images are written
at the input size, so both letterboxes copy them unchanged and the two
packages see the same pixels.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.data as jd
import fastvision_tpu.train as jt
import fastvision_tpu_torch.train as tt
from fastvision_tpu.infer.decode import decode_predictions as jax_decode
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu.ops.nms import batched_non_max_suppression as jax_bnms
from fastvision_tpu_torch.data import DetectionDataset, DetectionLoader
from fastvision_tpu_torch.infer import decode_predictions
from fastvision_tpu_torch.models import YOLOv3, yolov3_state_dict_from_jax
from fastvision_tpu_torch.ops import batched_non_max_suppression
from fastvision_tpu_torch.testing import SyntheticDetectionDataset

torch.set_num_threads(2)
C, S = 3, 128
# every level's anchors near the objects' sizes, so that an untrained
# model's boxes already match some GTs and the mAP comparison has content
ANCHORS = (np.array([[[48, 48], [64, 40], [40, 64]]] * 3, np.float32)
           / np.array([1, 1.6, 2.5], np.float32)[:, None, None])


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


class RecordingLogger:
    def __init__(self):
        self.records = []

    def log(self, step, **metrics):
        self.records.append({"step": step, **metrics})

    def epochs(self):
        return [r for r in self.records if "train_loss" in r]


@pytest.fixture(scope="module")
def fit_root(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("torch_fit")
    ds = SyntheticDetectionDataset(24, C, seed=5, sizes=((S, S),), max_objects=3)
    for split, ids in (("train", range(16)), ("val", range(16, 24))):
        os.makedirs(root / split / "images")
        os.makedirs(root / split / "labels")
        for i in ids:
            img, lab, _ = ds[i]
            # PNG: lossless, so the GT rectangles keep their exact colours
            cv2.imwrite(str(root / split / "images" / f"im{i:02d}.png"), img[..., ::-1])
            (root / split / "labels" / f"im{i:02d}.txt").write_text(
                "".join(f"{int(r[0])} {r[1]} {r[2]} {r[3]} {r[4]}\n" for r in lab))
    return str(root)


def _jax_fit(root, variables, logger):
    model = JaxYOLOv3(num_classes=C,
                      backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
    loss = jt.YOLOv3Loss(ANCHORS, num_classes=C)

    def apply_fn(v, images, **kw):
        return model.apply(v, jd.normalize_images(images), **kw)

    def loss_fn(heads, batch):
        out = loss(heads, batch["labels"])
        return out.total, {"box": out.box}

    def post(heads, batch):
        pred = jax_decode(heads, jnp.asarray(ANCHORS), (32, 16, 8), "v5")
        return jax_bnms(pred, conf_thres=0.001, max_det=100)

    fit = jt.Fit(
        apply_fn, loss_fn, jt.build_optimizer("adam", variables["params"]), variables,
        jd.DetectionLoader(jd.DetectionDataset(root, "train"), S, 8, max_boxes=6, seed=1),
        jd.DetectionLoader(jd.DetectionDataset(root, "val"), S, 3, max_boxes=6, train=False),
        epochs=2, schedule=jt.warmup_cosine_lr(2e-4, 1e-5, 4, warmup_steps=1,
                                               warmup_init_lr=1e-4),
        evaluator=jt.detection_evaluator(jt.make_eval_step(apply_fn, post)),
        ema_decay=0.999, eval_every=1, logger=logger, log_every=1)
    fit.run()
    return fit


def _port_fit(root, model, logger, **kw):
    loss = tt.YOLOv3Loss(ANCHORS, num_classes=C)
    anchors = torch.from_numpy(ANCHORS)

    def loss_fn(heads, batch):
        out = loss(heads, batch["labels"])
        return out.total, {"box": out.box}

    def post(heads, batch):
        return batched_non_max_suppression(decode_predictions(heads, anchors).float(),
                                           conf_thres=0.001, max_det=100)

    args = dict(
        epochs=2, schedule=tt.warmup_cosine_lr(2e-4, 1e-5, 4, warmup_steps=1,
                                               warmup_init_lr=1e-4),
        evaluator=tt.detection_evaluator(tt.make_eval_step(post)),
        ema_decay=0.999, eval_every=1, logger=logger, log_every=1, device="cpu")
    args.update(kw)
    return tt.Fit(
        model, loss_fn, tt.build_optimizer("adam", model),
        DetectionLoader(DetectionDataset(root, "train"), S, 8, max_boxes=6, seed=1),
        DetectionLoader(DetectionDataset(root, "val"), S, 3, max_boxes=6, train=False),
        **args)


def test_fit_end_to_end_matches_jax(fit_root):
    jax_model = JaxYOLOv3(num_classes=C,
                          backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
    init = jax.jit(lambda key, x: jax_model.init(key, x, train=True))
    variables = jax.device_get(init(jax.random.key(0), jnp.zeros((2, S, S, 3))))
    jlog, tlog = RecordingLogger(), RecordingLogger()
    jfit = _jax_fit(fit_root, variables, jlog)
    model = YOLOv3(num_classes=C, stage_sizes=(1, 1, 1, 1, 1))
    model.load_state_dict(yolov3_state_dict_from_jax(variables))
    fit = _port_fit(fit_root, model, tlog)
    fit.run()
    assert fit.global_step == jfit.global_step == 4 and fit.state.step == 4
    got, want = tlog.epochs(), jlog.epochs()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-4)
        assert abs(g["map50"] - w["map50"]) <= 1e-3 and abs(g["map"] - w["map"]) <= 1e-3
    steps = [r for r in tlog.records if "loss" in r]
    assert [r["lr"] for r in steps] == [r["lr"] for r in jlog.records if "loss" in r]
    assert got[-1]["map50"] > 0  # the evaluator saw detections that match


@pytest.fixture()
def tiny(tmp_path):
    def make(**kw):
        model = YOLOv3(num_classes=C, stage_sizes=(1, 1, 1, 1, 1),
                       generator=torch.Generator().manual_seed(0))
        loss = tt.YOLOv3Loss(ANCHORS, num_classes=C)
        log = RecordingLogger()

        def loss_fn(heads, batch):
            return loss(heads, batch["labels"]).total, {}

        train = DetectionLoader(SyntheticDetectionDataset(4, C, seed=2, sizes=((64, 80),)),
                                64, 2, max_boxes=4, seed=0)
        args = dict(epochs=2, logger=log, device="cpu")
        args.update(kw)
        return tt.Fit(model, loss_fn, tt.build_optimizer("sgd", model), train, **args), log
    return make


def test_fit_multiscale_no_aug_and_plateau(tiny):
    sizes = []
    plateau = tt.PlateauScheduler(patience=1, gamma=0.5)

    def recording_step(state, batch, lr):
        sizes.append((batch["images"].shape[1], lr))
        return state, {"loss": torch.tensor(float(len(sizes)))}  # rising: plateau trips

    fit, log = tiny(epochs=4, multiscale=(64, 96), no_aug_epochs=1, no_aug_lr=1e-5,
                    step_fn=recording_step, plateau=plateau,
                    schedule=tt.constant_lr(1e-2))
    fit.run()
    per_epoch = [sizes[i * 2][0] for i in range(4)]
    assert sorted(per_epoch[:2]) == [64, 96] and per_epoch[3] == 64
    assert per_epoch[:3] == [fit.epoch_input_size(e) for e in range(3)]
    assert [lr for _, lr in sizes[6:]] == [1e-5, 1e-5]
    assert fit.train_loader.input_size == 64
    assert plateau.scale < 1.0
    assert [r["train_loss"] for r in log.epochs()] == [1.5, 3.5, 5.5, 7.5]
    with pytest.raises(ValueError, match="multiples of 32"):
        tiny(multiscale=(64, 100))


def test_fit_ema_eval_state_and_preempt(tiny):
    seen = []

    def evaluator(state, loader):
        seen.append(state)
        return {"map50": 0.5}

    fit, log = tiny(epochs=3, ema_decay=0.9, evaluator=evaluator, eval_every=2, val_loader=[],
                    schedule=tt.constant_lr(1e-2))
    steps = []
    inner = fit.step_fn

    def counting(state, batch, lr):
        steps.append(lr)
        if len(steps) == 5:
            fit.request_preempt()
        return inner(state, batch, lr)

    fit.step_fn = counting
    fit.run()
    assert fit.interrupted and fit.global_step == 5
    assert len(seen) == 1 and seen[0].model is fit.ema_model  # epoch 1 (eval_every=2)
    for e, p in zip(fit.ema_model.buffers(), fit.state.model.buffers()):
        if e.dtype.is_floating_point:
            assert not torch.equal(e, torch.zeros_like(e))
    ema = dict(fit.ema_model.named_parameters())
    assert any(not torch.equal(ema[k], p) for k, p in fit.state.model.named_parameters())
    assert all(not p.requires_grad for p in fit.ema_model.parameters())
    eval_state = fit.eval_state()
    for e, p in zip(eval_state.model.buffers(), fit.state.model.buffers()):
        assert torch.equal(e, p)  # live BN statistics with the EMA weights
    assert log.records[-1]["preempted"] is True


def test_fit_rejects_what_is_not_ported(tiny, tmp_path):
    for kw in (dict(mesh=object()), dict(fsdp=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tiny(**kw)
    with pytest.raises(NotImplementedError):
        tt.detection_evaluator(lambda s, b: None, mesh=object())

    class Empty:
        input_size = 64

        def epoch(self, e):
            return iter(())

    fit, _ = tiny()
    fit.train_loader = Empty()
    with pytest.raises(ValueError, match="zero batches"):
        fit.run()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tiny(device=None)
