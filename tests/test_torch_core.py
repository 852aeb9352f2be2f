"""The port's core layers on the CPU: config, seeding, checkpoints and resume,
device-side mAP matching, BMP decode, mosaic and HSV jitter; against the
JAX package where it has a counterpart.

Tolerances: config trees, correct-matrices and generator draws equal; mAP
within 1e-6; mosaic canvases within +-1 per pixel (the port resizes with
torch's bilinear, the JAX package with cv2's fixed-point one) and labels
within 1e-4 px; HSV jitter within +-1 per channel (RGB -> HSV equals cv2's
for all 2^24 colours; cv2's HSV -> RGB truncates in its vector path and
rounds in its scalar path, so 0.1% of channels differ by 1, measured over
a 333 x 417 image); BMP decode equal to cv2's. A resumed `Fit` is
bit-equal to an uninterrupted one (model, optimizer and EMA state), for a
shallow, narrow-necked YOLOv3 and a Faster R-CNN with a narrow head.
"""
import copy
import functools
import importlib
import json
import os
import subprocess
import sys
import threading

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.core.config as jc
import fastvision_tpu.data as jd
import fastvision_tpu_torch.core.config as tc
import fastvision_tpu_torch.train as tt
from fastvision_tpu.data.mosaic import mosaic4 as jax_mosaic4
from fastvision_tpu.ops import map as jax_map
from fastvision_tpu_torch.core import (
    CheckpointManager,
    load_torch_state,
    partial_load,
    restore_inference_weights,
    set_random_seeds,
    trainable_mask,
)
from fastvision_tpu_torch.data import (
    Augmentation,
    DetectionDataset,
    DetectionLoader,
    HorizontalFlip,
    HSVJitter,
    build_augmentation,
    mosaic4,
    read_bmp,
    write_bmp,
)
from fastvision_tpu_torch.models import FasterRCNN, YOLOv3
from fastvision_tpu_torch.models.detection.faster_rcnn import FastHead
from fastvision_tpu_torch.ops import map as port_map
from fastvision_tpu_torch.testing import SyntheticDetectionDataset, write_detection_dataset

torch.set_num_threads(2)
THRESHOLDS = np.linspace(0.5, 0.95, 10)


# ---------------------------------------------------------------------------
# config and seeding
# ---------------------------------------------------------------------------
def test_config_defaults_match_jax():
    assert tc.to_dict(tc.Config()) == jc.to_dict(jc.Config())
    for ours, theirs in ((tc.Config, jc.Config), (tc.DataConfig, jc.DataConfig),
                         (tc.TrainConfig, jc.TrainConfig), (tc.ModelConfig, jc.ModelConfig),
                         (tc.NMSConfig, jc.NMSConfig)):
        assert [(f.name, f.type) for f in tc.fields(ours)] == \
               [(f.name, f.type) for f in jc.fields(theirs)]


@pytest.mark.parametrize("overrides", [
    ["train.lr=1e-3", "data.batch_size=4", "train.bf16=false", "model.name=faster_rcnn"],
    ["data.augment=[hflip:0.5, {op: hsv, p: 0.5}]", "train.multiscale=[320, 416]",
     "--nms.conf_thres=0.1", "mesh_model=2"],
])
def test_config_overrides_match_jax(overrides):
    got = tc.apply_overrides(tc.Config(), overrides)
    assert tc.to_dict(got) == jc.to_dict(jc.apply_overrides(jc.Config(), overrides))
    for bad in (["train.lrr=1"], ["nms.iou=0.5"]):
        with pytest.raises(KeyError):
            jc.apply_overrides(jc.Config(), bad)
        with pytest.raises(KeyError):
            tc.apply_overrides(tc.Config(), bad)
    with pytest.raises(ValueError, match="key=value"):
        tc.apply_overrides(tc.Config(), ["train.lr"])


def test_config_flat_descriptor_yaml_matches_jax(tmp_path):
    flat = tmp_path / "voc.yaml"
    flat.write_text("data_root: /data/voc\ntrain_dir: train2012\nnum_classes: 20\n"
                    "categories: [aeroplane, bicycle]\ntrain:\n  lr: 0.01\n")
    nested = tmp_path / "nested.yaml"
    nested.write_text("num_classes: 20\ndata:\n  num_classes: 5\nmodel:\n  name: faster_rcnn\n")
    for path in (flat, nested):
        got = tc.from_yaml(tc.Config, str(path), ["train.epochs=3"])
        assert tc.to_dict(got) == jc.to_dict(jc.from_yaml(jc.Config, str(path), ["train.epochs=3"]))
    got = tc.from_yaml(tc.Config, str(flat))
    assert got.data.num_classes == got.model.num_classes == 20 and got.train.lr == 0.01
    assert tc.from_yaml(tc.Config, str(nested)).model.num_classes == 5


def test_config_without_pyyaml(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    assert tc.apply_overrides(tc.Config(), ["train.lr=0.5"]).train.lr == 0.5
    with pytest.raises(ImportError, match="PyYAML"):
        tc.apply_overrides(tc.Config(), ["data.augment=[hflip]"])
    (tmp_path / "c.yaml").write_text("train:\n  lr: 0.1\n")
    with pytest.raises(ImportError, match="PyYAML"):
        tc.from_yaml(tc.Config, str(tmp_path / "c.yaml"))


def test_port_imports_neither_yaml_nor_cv2():
    """PyYAML and cv2 are imported only inside the functions that need
    them: importing every module of the port, and chip_smoke.py, loads
    neither (the card's machine has no cv2 and may lack PyYAML)."""
    code = ("import importlib, pkgutil, sys\n"
            "import fastvision_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'fastvision_tpu_torch.')]\n"
            "for m in mods + ['chip_smoke']: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('yaml', 'cv2'))\n"
            "assert not bad, bad\n"
            "print(len(mods))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 50


def test_set_random_seeds():
    gen = set_random_seeds(7)
    a = (np.random.rand(), torch.rand(2), torch.rand(2, generator=gen))
    gen = set_random_seeds(7)
    b = (np.random.rand(), torch.rand(2), torch.rand(2, generator=gen))
    assert a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert os.environ["PYTHONHASHSEED"] == "7"


# ---------------------------------------------------------------------------
# device-side mAP matching
# ---------------------------------------------------------------------------
def _padded_cases(rng, quantize, b=16, p=24, g=12, n_cls=3):
    def boxes(n):
        xy = rng.uniform(0, 80, (n, 2))
        wh = rng.uniform(4, 40, (n, 2))
        out = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        return np.round(out) if quantize else out  # quantized: IoU ties

    out = {k: [] for k in ("pb", "pc", "pv", "tb", "tc", "tv")}
    for _ in range(b):
        n_pred, n_gt = int(rng.integers(0, p + 1)), int(rng.integers(0, g + 1))
        gt, gt_cls = boxes(g), rng.integers(0, n_cls, g)
        pred, pred_cls = boxes(p), rng.integers(0, n_cls, p)
        # half the predictions are jittered copies of GTs, mostly of their class
        src = rng.integers(0, max(n_gt, 1), p)
        near = (rng.uniform(size=p) < 0.5) & (n_gt > 0)
        jitter = rng.normal(0, 3, (p, 4))
        pred = np.where(near[:, None], gt[src] + (np.round(jitter) if quantize else jitter), pred)
        pred_cls = np.where(near & (rng.uniform(size=p) < 0.8), gt_cls[src], pred_cls)
        out["pb"].append(pred)
        out["pc"].append(pred_cls)
        out["pv"].append(np.arange(p) < n_pred)
        out["tb"].append(gt)
        out["tc"].append(np.where(np.arange(g) < n_gt, gt_cls, -1))
        out["tv"].append(np.arange(g) < n_gt)
    cast = {"pb": np.float32, "pc": np.float32, "tb": np.float32, "tc": np.float32}
    return [np.stack(out[k]).astype(cast.get(k, bool)) for k in ("pb", "pc", "pv", "tb", "tc", "tv")]


_jax_match_device = jax.jit(jax_map.match_predictions_device)


@pytest.mark.parametrize("quantize", [False, True])
def test_match_predictions_device_matches_jax(quantize):
    args = _padded_cases(np.random.default_rng(3 + quantize), quantize)
    thr = THRESHOLDS.astype(np.float32)
    want = np.asarray(_jax_match_device(*map(jnp.asarray, args), jnp.asarray(thr)))
    got = port_map.match_predictions_device(*map(torch.from_numpy, args), torch.from_numpy(thr))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not got.numpy()[~args[2]].any()  # padded rows never match


def test_device_and_host_matchers_differ_as_in_jax():
    """Two same-class predictions over one GT: the host matcher (the
    reference's greedy dedup, which keeps the smaller prediction index among
    a GT's candidates) gives the GT to the first at IoU 0.5 and to the
    second at 0.95; the device matcher gives it to the higher IoU at every
    threshold. Both packages behave so; the port keeps both rules."""
    gt, pred = np.array([[0, 0, 10, 10]], np.float32), np.array([[0, 0, 10, 8], [0, 0, 10, 10]],
                                                                np.float32)
    cls0, thr = np.zeros(2, np.float32), THRESHOLDS.astype(np.float32)
    host = port_map.match_predictions(pred, cls0, gt, cls0[:1], THRESHOLDS)
    np.testing.assert_array_equal(host, jax_map.match_predictions(pred, cls0, gt, cls0[:1],
                                                                  THRESHOLDS))
    assert host[0, 0] and not host[1, 0] and host[1, -1]
    args = (pred[None], cls0[None], np.ones((1, 2), bool), gt[None], cls0[None, :1],
            np.ones((1, 1), bool))
    dev = port_map.match_predictions_device(*map(torch.from_numpy, args), torch.from_numpy(thr))
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jax_map.match_predictions_device(
        *map(jnp.asarray, args), jnp.asarray(thr))))
    assert not dev[0, 0].any() and dev[0, 1].all()


def test_update_matched_map_matches_jax():
    rng = np.random.default_rng(5)
    pb, pc, pv, tb, tcls, tv = _padded_cases(rng, False, b=12)
    correct = port_map.match_predictions_device(*map(torch.from_numpy, (pb, pc, pv, tb, tcls, tv)),
                                                torch.from_numpy(THRESHOLDS.astype(np.float32)))
    scores = rng.uniform(0.05, 1.0, pc.shape).astype(np.float32)
    ours, theirs = port_map.MeanAveragePrecision(), jax_map.MeanAveragePrecision()
    for i in range(len(pb)):
        for m in (ours, theirs):
            m.update_matched(correct[i].numpy(), scores[i], pc[i], tcls[i], pred_valid=pv[i],
                             gt_valid=tv[i])
    got, want = ours.compute(), theirs.compute()
    assert got.map > 0
    np.testing.assert_allclose(got.map_per_iou, want.map_per_iou, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.ap_per_class_per_iou, want.ap_per_class_per_iou, atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _tensors_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tensors_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_checkpoint_manager_round_trip(tmp_path, monkeypatch):
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(2, 3, 8, 8)).sum().backward()
    opt.step()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    ema = {k: v + 1 for k, v in model.named_parameters()}
    for step, metric in ((0, 0.5), (1, 0.7), (2, 0.6)):
        mgr.save(step, model.state_dict(), opt.state_dict(), ema=ema,
                 extra={"epoch": step}, metric=metric, higher_is_better=True)
        saved_w = model[0].weight.detach().clone()
        with torch.no_grad():
            model[0].weight.add_(1.0)  # the save holds a copy, not the live tensor
    mgr.wait()
    assert mgr.all_steps() == [1, 2] and mgr.latest_step() == 2  # max_to_keep
    assert mgr.available_items() == {"model", "optimizer", "ema", "meta"}
    assert mgr.last_save["bytes"] > 0 and mgr.last_save["host_copy_s"] >= 0
    r = mgr.restore()
    assert r["meta"]["epoch"] == 2 and r["meta"]["step"] == 2
    assert torch.equal(r["state"]["model"]["0.weight"], saved_w)
    assert _tensors_equal(r["state"]["optimizer"], opt.state_dict())
    assert set(r["state"]["ema"]) == {"0.weight", "0.bias", "1.weight", "1.bias"}
    best = mgr.restore(best=True)  # step 1 had the best metric (0.7)
    assert best["meta"]["step"] == 1 and os.listdir(tmp_path / "ck" / "best") == ["1"]
    assert json.loads((tmp_path / "ck" / "best.json").read_text()) == {"step": 1, "metric": 0.7}
    assert set(mgr.restore(1, items=("model",))["state"]) == {"model"}
    # a second manager reads the best metric back: 0.65 does not beat it
    mgr2 = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    mgr2.save(2, model.state_dict(), extra={"epoch": 9}, metric=0.65)  # overwrites step 2
    mgr2.wait()
    assert mgr2.restore()["meta"]["epoch"] == 9 and mgr2.restore(best=True)["meta"]["step"] == 1
    assert mgr2.available_items(2) == {"model", "meta"}

    # a write that fails half-way leaves no step, and the error surfaces
    real_save = torch.save

    def failing(obj, path, *a, **k):
        if path.endswith("optimizer.pt"):
            raise OSError("disk full")
        return real_save(obj, path, *a, **k)

    monkeypatch.setattr(torch, "save", failing)
    mgr2.save(3, model.state_dict(), opt.state_dict())
    with pytest.raises(OSError, match="disk full"):
        mgr2.wait()
    assert mgr2.all_steps() == [1, 2]
    assert not [n for n in os.listdir(tmp_path / "ck") if n.startswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_restore_leaves_a_write_in_flight_alone(tmp_path, monkeypatch):
    """eval / infer restoring from the directory of a run that is still
    training: the trainer's write in flight goes on and completes, and a
    restore from a path that does not exist creates nothing."""
    def net():
        return torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))

    model, ck = net(), str(tmp_path / "ck")
    mgr = CheckpointManager(ck)
    mgr.save(0, model.state_dict(), ema=dict(model.named_parameters()), extra={"epoch": 0})
    mgr.wait()
    real_save, started, release = torch.save, threading.Event(), threading.Event()

    def held(obj, path, *a, **k):  # the write stops after its first file
        real_save(obj, path, *a, **k)
        started.set()
        assert release.wait(30)

    monkeypatch.setattr(torch, "save", held)
    mgr.save(1, model.state_dict(), extra={"epoch": 1})
    assert started.wait(30)
    in_flight = [n for n in os.listdir(ck) if n.startswith(".tmp-1-")]
    assert len(in_flight) == 1
    other = net()
    assert restore_inference_weights(ck, other)["step"] == 0
    assert torch.equal(other[0].weight, model[0].weight)
    assert [n for n in os.listdir(ck) if n.startswith(".tmp-1-")] == in_flight
    release.set()
    mgr.wait()
    assert mgr.all_steps() == [0, 1] and CheckpointManager(ck).restore()["meta"]["epoch"] == 1
    with pytest.raises(FileNotFoundError):
        restore_inference_weights(str(tmp_path / "typo"), other)
    assert not (tmp_path / "typo").exists()


def test_partial_load_masks_and_torch_state(tmp_path):
    src = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 5))
    dst = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))  # other head
    torch.save({"model": {"module." + k: v for k, v in src.state_dict().items()}},
               tmp_path / "a.pt")
    torch.save(src, tmp_path / "b.pt")  # a pickled module, as ultralytics saves
    for path in ("a.pt", "b.pt"):
        state = load_torch_state(str(tmp_path / path))
        assert set(state) == {"0.weight", "0.bias", "1.weight", "1.bias"}
        keep = copy.deepcopy(dst[1].weight)
        loaded, kept = partial_load(dst, state, verbose=False)
        assert loaded == ["0.weight", "0.bias"] and kept == ["1.weight", "1.bias"]
        assert torch.equal(dst[0].weight, src[0].weight) and torch.equal(dst[1].weight, keep)
    assert trainable_mask(dst, ["0."]) == {"0.weight": False, "0.bias": False,
                                           "1.weight": True, "1.bias": True}


# ---------------------------------------------------------------------------
# Fit: preempted and resumed == uninterrupted, bit for bit
# ---------------------------------------------------------------------------
C = 3
ANCHORS = (np.array([[[48, 48], [64, 40], [40, 64]]] * 3, np.float32)
           / np.array([1, 1.6, 2.5], np.float32)[:, None, None])
FRCNN_CFG = dict(num_classes=C, image_size=64, anchor_scales=(2, 4, 6), rpn_pre_nms_train=128,
                 rpn_post_nms_train=32, rpn_pre_nms_eval=64, rpn_post_nms_eval=16, roi_pos=4,
                 roi_neg=12)


class _Log:
    def __init__(self):
        self.records = []

    def log(self, step, **kw):
        self.records.append({"step": step, **kw})


@pytest.fixture(scope="module")
def base_models():
    # one block per Darknet stage and a narrow neck: checkpoints of ~0.1 GB
    yolo = YOLOv3(num_classes=C, channels=(128, 64, 32), stage_sizes=(1, 1, 1, 1, 1),
                  generator=torch.Generator().manual_seed(0))
    # a narrow head: checkpoints of MBs, not of the 4096-wide MLP's 0.4 GB
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(importlib.import_module("fastvision_tpu_torch.models.detection.faster_rcnn"),
                   "FastHead", functools.partial(FastHead, hidden=64))
        frcnn = FasterRCNN(**FRCNN_CFG, generator=torch.Generator().manual_seed(0))
    return {"yolov3": yolo, "faster_rcnn": frcnn}


def _fit(kind, base, ckpt_dir=None, resume=False, preempt_after=None):
    model = copy.deepcopy(base)
    ds = SyntheticDetectionDataset(4, C, seed=2, sizes=((64, 64), (48, 80)))
    aug = Augmentation([HorizontalFlip(p=0.5), HSVJitter(p=0.5)])
    loader = DetectionLoader(ds, 64, 2, max_boxes=4, seed=1, augmentation=aug, mosaic_prob=0.5)
    if kind == "yolov3":
        loss = tt.YOLOv3Loss(ANCHORS, num_classes=C)
        loss_fn, step_fn = (lambda heads, batch: (loss(heads, batch["labels"]).total, {})), None
    else:
        loss_fn, step_fn = None, tt.make_frcnn_train_step(seed=3)
    log = _Log()
    fit = tt.Fit(model, loss_fn, tt.build_optimizer("sgd", model, grad_clip_norm=10.0), loader,
                 epochs=2, schedule=tt.warmup_cosine_lr(1e-2, 1e-4, 4, warmup_steps=2),
                 ema_decay=0.9, step_fn=step_fn, ckpt_dir=ckpt_dir, resume=resume, logger=log,
                 device="cpu")
    if preempt_after is not None:
        inner, calls = fit.step_fn, []

        def counting(state, batch, lr):
            calls.append(1)
            if len(calls) == preempt_after:
                fit.request_preempt()
            return inner(state, batch, lr)

        fit.step_fn = counting
    return fit, log


def _state(fit) -> dict:
    return copy.deepcopy({"model": fit.state.model.state_dict(),
                          "optimizer": fit.state.optimizer.state_dict(),
                          "ema": dict(fit.ema_model.named_parameters()),
                          "step": fit.state.step})


@pytest.mark.parametrize("kind", ["yolov3", "faster_rcnn"])
def test_fit_preempted_and_resumed_equals_uninterrupted(kind, base_models, tmp_path):
    ckpt = str(tmp_path / "ck")
    fit1, log1 = _fit(kind, base_models[kind])
    fit1.run()
    fit2, _ = _fit(kind, base_models[kind], ckpt, preempt_after=3)  # epoch 1, batch 1 done
    fit2.run()
    assert fit2.interrupted and fit2.global_step == 3
    saved = _state(fit2)
    meta = CheckpointManager(ckpt).restore()["meta"]
    assert (meta["epoch"], meta["global_step"], meta["epoch_batches_done"], meta["state_step"],
            meta["preempted"]) == (0, 2, 1, 3, True)
    fit3, log3 = _fit(kind, base_models[kind], ckpt, resume=True)
    assert (fit3.start_epoch, fit3.global_step) == (1, 3)
    assert _tensors_equal(_state(fit3), saved)  # the restored state is the saved one
    fit3.run()
    assert fit3.global_step == fit1.global_step == 4
    assert _tensors_equal(_state(fit3), _state(fit1))
    # the resumed epoch's logged loss is the whole epoch's, as without the cut
    assert [r["train_loss"] for r in log3.records if "train_loss" in r] == \
           [r["train_loss"] for r in log1.records if "train_loss" in r][1:]
    assert CheckpointManager(ckpt).latest_step() == 1


# ---------------------------------------------------------------------------
# data: BMP, mosaic, HSV, augmentation specs
# ---------------------------------------------------------------------------
def test_bmp_decode_matches_cv2(tmp_path):
    rng = np.random.default_rng(0)
    for w in (1, 2, 3, 5, 6, 7, 13):  # row padding 3, 2, 1, 1, 2, 3, 1 bytes
        img = rng.integers(0, 256, (9, w, 3), dtype=np.uint8)
        path = str(tmp_path / f"cv{w}.bmp")
        cv2.imwrite(path, img[..., ::-1])
        np.testing.assert_array_equal(read_bmp(path), img)
        write_bmp(str(tmp_path / f"np{w}.bmp"), img)
        want = cv2.cvtColor(cv2.imread(str(tmp_path / f"np{w}.bmp")), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(read_bmp(str(tmp_path / f"np{w}.bmp")), want)
        np.testing.assert_array_equal(want, img)
    cv2.imwrite(str(tmp_path / "a.bmp"), rng.integers(0, 256, (5, 7, 4), dtype=np.uint8))
    np.testing.assert_array_equal(read_bmp(str(tmp_path / "a.bmp")), cv2.cvtColor(
        cv2.imread(str(tmp_path / "a.bmp")), cv2.COLOR_BGR2RGB))  # 32-bit BITFIELDS
    # a 32-bit BI_RGB top-down file, written by hand
    img = rng.integers(0, 256, (4, 3, 3), dtype=np.uint8)
    px = np.concatenate([img[..., ::-1], np.zeros((4, 3, 1), np.uint8)], -1).tobytes()
    hdr = (b"BM" + (54 + len(px)).to_bytes(4, "little") + bytes(4) + (54).to_bytes(4, "little")
           + (40).to_bytes(4, "little") + (3).to_bytes(4, "little")
           + (-4).to_bytes(4, "little", signed=True) + (1).to_bytes(2, "little")
           + (32).to_bytes(2, "little") + bytes(24))
    (tmp_path / "td.bmp").write_bytes(hdr + px)
    np.testing.assert_array_equal(read_bmp(str(tmp_path / "td.bmp")), img)
    (tmp_path / "bad.bmp").write_bytes(hdr[:40])
    with pytest.raises(ValueError):
        read_bmp(str(tmp_path / "bad.bmp"))
    # a written dataset reads back as the in-memory one, by both packages
    root = write_detection_dataset(str(tmp_path / "ds"), 3, sizes=((37, 53), (30, 61)), seed=4,
                                   num_classes=5)
    ref = SyntheticDetectionDataset(6, 5, 4, ((37, 53), (30, 61)))
    ours, theirs = DetectionDataset(root, "val"), jd.DetectionDataset(root, "val")
    for i in range(3):
        (gi, gl, gid), (wi, wl, wid) = ours[i], theirs[i]
        np.testing.assert_array_equal(gi, ref[3 + i][0])
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, ref[3 + i][1])
        np.testing.assert_array_equal(gl, wl)
        assert gid == wid == f"val_{3 + i:06d}"


def test_mosaic4_matches_jax():
    ds = SyntheticDetectionDataset(12, C, seed=6, sizes=((64, 64), (48, 80), (90, 50)))
    worst = 0
    for seed in range(4):
        samples = [ds[4 * (seed % 3) + k][:2] for k in range(4)]
        got_img, got_lab = mosaic4(samples, 64, np.random.default_rng(seed))
        want_img, want_lab = jax_mosaic4(samples, 64, np.random.default_rng(seed))
        worst = max(worst, int(np.abs(got_img.astype(int) - want_img).max()))
        np.testing.assert_allclose(got_lab, want_lab, atol=1e-4, rtol=0)
    assert worst <= 1
    with pytest.raises(ValueError):
        mosaic4(samples[:3], 64, np.random.default_rng(0))


def test_hsv_jitter_matches_jax():
    img = np.random.default_rng(0).integers(0, 256, (333, 417, 3), dtype=np.uint8)
    ours, theirs = HSVJitter(), jd.HSVJitter()
    for seed in range(3):
        d = ours.sample(np.random.default_rng(seed), img)
        assert d == theirs.sample(np.random.default_rng(seed), img)
        got, _ = ours.apply(img, None, d)
        want, _ = theirs.apply(img, None, d)
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_loader_mosaic_and_start_batch_match_jax():
    ds = SyntheticDetectionDataset(10, C, seed=8, sizes=((64, 64), (48, 80), (90, 50)))
    kw = dict(input_size=64, batch_size=2, max_boxes=8, seed=3, mosaic_prob=0.5)
    ours = DetectionLoader(ds, augmentation=Augmentation([HorizontalFlip(p=0.5)]), **kw)
    theirs = jd.DetectionLoader(ds, augmentation=jd.Augmentation([jd.HorizontalFlip(p=0.5)]), **kw)
    got, want = list(ours.epoch(1)), list(theirs.epoch(1))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["labels"], w["labels"], atol=1e-6, rtol=0)
        assert np.abs(g["images"].astype(int) - w["images"]).max() <= 1
    tail = list(ours.epoch(1, start_batch=3))  # a resumed epoch: the same last 2 batches
    assert len(tail) == 2
    for g, w in zip(tail, got[3:]):
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["labels"], w["labels"])


def test_build_augmentation():
    aug = build_augmentation(["hflip:0.5", {"op": "hsv", "p": 0.3, "s_gain": 0.6}, "VFLIP"])
    assert [type(op).__name__ for op in aug.ops] == ["HorizontalFlip", "HSVJitter",
                                                     "VerticalFlip"]
    assert aug.ops[0].p == 0.5 and aug.ops[1].gains[1] == 0.6 and aug.ops[2].p == 1.0
    assert build_augmentation([]) is None
    with pytest.raises(NotImplementedError, match="item 11"):
        build_augmentation(["blur"])
    with pytest.raises(ValueError):
        build_augmentation(["nope"])
    with pytest.raises(ValueError):
        build_augmentation([{"p": 0.5}])
