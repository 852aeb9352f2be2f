"""The port's Detector.evaluate / evaluate_sweep / COCO JSON against the JAX
package's Detector with the same weights, and the port's CLI end to end,
on the CPU.

The JAX model gets the port's random weights through the JAX package's own
torch importer (`yolov3_from_torch` + `apply_import`). The images are
``.bmp`` files from `testing.write_detection_dataset` whose long side is
the input size, so both letterboxes pad without resizing and both packages
see the same pixels.

Tolerances: mAP within 1e-4 (float32 heads differ by ~1e-5 of their std
between the packages), metric-file rows equal (4 decimals), COCO boxes
within 2e-3 px and scores within 1e-4, the same entries and ids. Sweep rows
equal the per-point `evaluate` with host matching exactly (the sweep
matches on the host). The CLI runs a small YOLOv3 (one block per Darknet
stage, a narrow neck) and a Faster R-CNN with a 64-wide head at 64 px;
``model.pretrained`` loads a Darknet-53 and a VGG16 classifier into their
trunks exactly.
"""
import functools
import importlib
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.data as jd
import fastvision_tpu_torch.cli as cli
import fastvision_tpu_torch.models as tmodels
from fastvision_tpu.infer import Detector as JaxDetector
from fastvision_tpu.infer import predictor as jax_predictor
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu.models.import_torch import apply_import, yolov3_from_torch
from fastvision_tpu_torch.core import CheckpointManager
from fastvision_tpu_torch.data import DetectionDataset
from fastvision_tpu_torch.infer import REFERENCE_SWEEP, Detector, detections_to_coco
from fastvision_tpu_torch.models import FasterRCNN, YOLOv3
from fastvision_tpu_torch.models.detection.faster_rcnn import FastHead
from fastvision_tpu_torch.testing import write_detection_dataset

torch.set_num_threads(2)
C, SIZE = 3, 64
SIZES = ((64, 64), (48, 64), (64, 40))
# anchors near the objects' sizes, so that the untrained model's boxes
# already match some GTs and mAP has content
ANCHORS = (np.array([[[32, 32], [40, 24], [24, 40]]] * 3, np.float32)
           / np.array([1, 1.6, 2.5], np.float32)[:, None, None])


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


@pytest.fixture(scope="module")
def detectors():
    tm = YOLOv3(num_classes=C, stage_sizes=(1, 1, 1, 1, 1),
                generator=torch.Generator().manual_seed(0))
    jm = JaxYOLOv3(num_classes=C,
                   backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((1, SIZE, SIZE, 3))))
    shapes = jax.device_get(init(jax.random.key(0)))
    zeros = jax.tree_util.tree_map(np.zeros_like,
                                   {c: shapes[c] for c in ("params", "batch_stats")})
    variables = apply_import(zeros, yolov3_from_torch(
        {k: v.numpy() for k, v in tm.state_dict().items()}), verbose=False)
    kw = dict(input_size=SIZE, batch_size=2, conf_thres=0.05)
    return (Detector(tm, ANCHORS, device="cpu", dtype=torch.float32, **kw),
            JaxDetector(jm, variables, ANCHORS, dtype=jnp.float32, **kw))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_detection_dataset(str(tmp_path_factory.mktemp("eval_cli")), 5, sizes=SIZES,
                                   seed=3, num_classes=C)


@pytest.mark.parametrize("device_matching", [True, False], ids=["device", "host"])
def test_evaluate_matches_jax(detectors, root, tmp_path, device_matching):
    tdet, jdet = detectors
    ours, theirs = DetectionDataset(root, "val"), jd.DetectionDataset(root, "val")
    mode = {"device_matching": True} if device_matching else {}  # the port's default: host
    got = tdet.evaluate(ours, metric_file=str(tmp_path / "t.txt"), config_note="conf .05", **mode)
    want = jdet.evaluate(theirs, metric_file=str(tmp_path / "j.txt"), config_note="conf .05",
                         device_matching=device_matching)
    assert got["images"] == want["images"] == 5 and got["map50"] > 0
    assert abs(got["map50"] - want["map50"]) <= 1e-4 and abs(got["map"] - want["map"]) <= 1e-4
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    part = tdet.evaluate(ours, max_images=3, device_matching=device_matching)
    assert part["images"] == 3
    assert abs(part["map"] - jdet.evaluate(theirs, max_images=3,
                                           device_matching=device_matching)["map"]) <= 1e-4


def test_evaluate_sweep_matches_jax_and_per_point(detectors, root, tmp_path):
    tdet, jdet = detectors
    assert REFERENCE_SWEEP == jax_predictor.REFERENCE_SWEEP
    points = [(0.05, 0.45), (0.3, 0.25), (0.5, 0.6)]
    ours = DetectionDataset(root, "val")
    got = tdet.evaluate_sweep(ours, points, metric_file=str(tmp_path / "t.txt"))
    want = jdet.evaluate_sweep(jd.DetectionDataset(root, "val"), points,
                               metric_file=str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert (tmp_path / "t.txt").read_text().count("# sweep input_size 64 conf_thres") == 3
    for g, w, (conf, iou) in zip(got, want, points):
        assert (g["conf"], g["iou"], g["images"]) == (w["conf"], w["iou"], w["images"])
        assert abs(g["map50"] - w["map50"]) <= 1e-4 and abs(g["map"] - w["map"]) <= 1e-4
        per_point = Detector(tdet.model, ANCHORS, input_size=SIZE, batch_size=2, conf_thres=conf,
                             iou_thres=iou, device="cpu", dtype=torch.float32)
        ref = per_point.evaluate(ours, device_matching=False)
        assert (g["map50"], g["map"]) == (ref["map50"], ref["map"])
    assert got[0]["map50"] > 0
    assert [r["images"] for r in tdet.evaluate_sweep(ours, points[:1], max_images=2)] == [2]


def test_save_json_and_detections_to_coco_match_jax(detectors, root, tmp_path):
    tdet, jdet = detectors
    for coco_ids in (False, True):
        tdet.evaluate(DetectionDataset(root, "val"), save_json=str(tmp_path / "t.json"),
                      coco_ids=coco_ids)
        jdet.evaluate(jd.DetectionDataset(root, "val"), save_json=str(tmp_path / "j.json"),
                      coco_ids=coco_ids)
        got = json.loads((tmp_path / "t.json").read_text())
        want = json.loads((tmp_path / "j.json").read_text())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=2e-3, rtol=0)
            assert abs(g["score"] - w["score"]) <= 1e-4
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 50, (4, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    scores, classes = rng.uniform(0, 1, 4).astype(np.float32), np.array([0, 5, 79, 11])
    for image_id in ("000000000139", "not_numeric"):
        for coco_ids in (False, True):
            assert detections_to_coco(image_id, boxes, scores, classes, coco_ids) == \
                jax_predictor.detections_to_coco(image_id, boxes, scores, classes, coco_ids)
    with pytest.raises(ValueError, match="save_json"):
        tdet.evaluate(DetectionDataset(root, "val"), save_json=str(tmp_path / "x.json"),
                      device_matching=True)


def test_detector_rejects_what_is_not_ported(detectors, root):
    tdet, _ = detectors
    with pytest.raises(NotImplementedError, match="item 6"):
        tdet.evaluate(DetectionDataset(root, "val"), tta=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        next(tdet.predict_dataset(DetectionDataset(root, "val"), fast_decode=True))
    with pytest.raises(NotImplementedError, match="item 6"):
        Detector(tdet.model, ANCHORS, postprocess_mode="reference_demo", device="cpu")
    with pytest.raises(ValueError):
        Detector(tdet.model, ANCHORS, postprocess_mode="other", device="cpu")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def _small_yolo(cfg):
    """`cli._build_yolo` at a small size."""
    model = YOLOv3(num_classes=cfg.model.num_classes, channels=(128, 64, 32),
                   stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(cfg.train.seed))
    cli._maybe_import_pretrained(cfg, model)
    return model


def _narrow_frcnn(**kw):
    """FasterRCNN built with a 64-wide head MLP (the 4096-wide one holds
    0.4 GB and takes seconds to initialise)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(importlib.import_module("fastvision_tpu_torch.models.detection.faster_rcnn"),
                   "FastHead", functools.partial(FastHead, hidden=64))
        return FasterRCNN(**kw)


VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)  # torchvision's features.N
VGG16_CHANNELS = (3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)


def _classifier_checkpoints(tmp_path, yolo) -> tuple[str, str, dict]:
    """A reference Darknet-53 classifier holding ``yolo``'s backbone and a
    seeded torchvision VGG16 with a 64-wide MLP, each with its 1000-way top,
    saved as their sources save them. -> their paths, and the tensors of the
    port's FasterRCNN that the VGG16 must become."""
    darknet = {k[len("backbone."):]: v for k, v in yolo.state_dict().items()
               if k.startswith("backbone.")}
    darknet["fc.weight"], darknet["fc.bias"] = torch.zeros(1000, 1024), torch.zeros(1000)
    gen, want, vgg = torch.Generator().manual_seed(8), {}, {}
    for i, n in enumerate(VGG16_CONVS):
        w = torch.randn(VGG16_CHANNELS[i + 1], VGG16_CHANNELS[i], 3, 3, generator=gen)
        b = torch.randn(VGG16_CHANNELS[i + 1], generator=gen)
        want[f"backbone.conv{i}.conv.weight"] = vgg[f"features.{n}.weight"] = w
        want[f"backbone.conv{i}.conv.bias"] = vgg[f"features.{n}.bias"] = b
    for name, shape in (("fc1", (64, 7 * 7 * 512)), ("fc2", (64, 64))):
        want[f"head.{name}.weight"] = torch.randn(*shape, generator=gen)
        want[f"head.{name}.bias"] = torch.randn(64, generator=gen)
    w1 = want["head.fc1.weight"]  # the port's (7, 7, C) input columns -> torchvision's (C, 7, 7)
    vgg["classifier.0.weight"] = w1.reshape(64, 7, 7, 512).permute(0, 3, 1, 2).reshape(64, -1)
    vgg["classifier.0.bias"] = want["head.fc1.bias"]
    vgg["classifier.3.weight"], vgg["classifier.3.bias"] = want["head.fc2.weight"], want["head.fc2.bias"]
    vgg["classifier.6.weight"], vgg["classifier.6.bias"] = torch.zeros(1000, 64), torch.zeros(1000)
    paths = str(tmp_path / "darknet53.pth"), str(tmp_path / "vgg16.pth")
    torch.save(darknet, paths[0])
    torch.save(vgg, paths[1])
    return (*paths, want)


def test_cli_train_resume_eval_infer(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cli, "_build_yolo", _small_yolo)
    monkeypatch.setattr(tmodels, "FasterRCNN", _narrow_frcnn)
    ckmod = importlib.import_module("fastvision_tpu_torch.core.checkpoint")
    real_load, loads = ckmod.partial_load, []

    def recording(model, state, verbose=True):  # what model.pretrained put into the model
        out = real_load(model, state, verbose)
        loads.append((out[0], {k: v.clone() for k, v in model.state_dict().items()}))
        return out

    monkeypatch.setattr(ckmod, "partial_load", recording)
    src_yolo = YOLOv3(num_classes=C, channels=(128, 64, 32), stage_sizes=(1, 1, 1, 1, 1),
                      generator=torch.Generator().manual_seed(7))
    darknet, vgg, want_frcnn = _classifier_checkpoints(tmp_path, src_yolo)
    ckpt = str(tmp_path / "ck")
    root = write_detection_dataset(str(tmp_path / "ds"), 4, sizes=SIZES, seed=5, num_classes=C)
    common = [f"data.data_root={root}", "data.num_workers=0", f"data.input_size={SIZE}",
              "data.batch_size=2", f"model.num_classes={C}", "data.max_boxes=8",
              "train.bf16=false", "train.ema_decay=0.9", "train.warmup_epochs=1",
              "--device", "cpu"]
    fit = cli.main(["train", "train.epochs=1", f"train.ckpt_dir={ckpt}",
                    f"model.pretrained={darknet}", *common])
    assert fit.global_step == 2 and CheckpointManager(ckpt).all_steps() == [0]
    # the Darknet-53 classifier filled the whole backbone and nothing else
    (loaded, got), = loads
    want = {k: v for k, v in src_yolo.state_dict().items() if k.startswith("backbone.")}
    assert sorted(loaded) == sorted(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    fit = cli.main(["train", "--resume", "train.epochs=2", f"train.ckpt_dir={ckpt}", *common])
    assert fit.start_epoch == 1 and fit.global_step == 4
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [0, 1] and mgr.available_items() == {"model", "optimizer", "ema",
                                                                   "meta"}
    assert os.path.exists(os.path.join(ckpt, "best.json"))
    lines = [json.loads(x) for x in open(os.path.join(ckpt, "train.jsonl"))]
    assert [r["epoch"] for r in lines if "train_loss" in r] == [0, 1]

    # eval --ckpt restores the EMA weights
    det = cli._detector_from_cfg(cli._load_config(cli.make_parser().parse_args(
        ["eval"]), common[:-2]), ckpt, "cpu")
    for name, p in det.model.named_parameters():
        assert torch.equal(p, dict(fit.ema_model.named_parameters())[name]), name
    res = cli.main(["eval", "--ckpt", ckpt, "--metric-file", str(tmp_path / "m.txt"),
                    "--save-json", str(tmp_path / "d.json"), "nms.conf_thres=0.01", *common])
    assert res["images"] == 4 and (tmp_path / "m.txt").exists() and (tmp_path / "d.json").exists()
    rows = cli.main(["eval", "--ckpt", ckpt, "--max-images", "3", *common, "--sweep"])
    assert [(r["conf"], r["iou"]) for r in rows] == REFERENCE_SWEEP and rows[0]["images"] == 3
    rows = cli.main(["eval", "--ckpt", ckpt, "--sweep", "0.01:0.5,0.2:0.3", *common])
    assert [(r["conf"], r["iou"]) for r in rows] == [(0.01, 0.5), (0.2, 0.3)]
    out = cli.main(["infer", "--ckpt", ckpt, "--source", os.path.join(root, "val", "images"),
                    "--out", str(tmp_path / "out"), *common])
    assert len(out) == 4 and len(os.listdir(tmp_path / "out")) == 4
    single = os.path.join(root, "val", "images", sorted(os.listdir(
        os.path.join(root, "val", "images")))[0])
    assert len(cli.main(["infer", "--source", single, "--out", str(tmp_path / "o1"),
                         *common])) == 1
    assert "best mAP@0.5" in capsys.readouterr().out

    # Faster R-CNN through the same command
    fit = cli.main(["train", "model.name=faster_rcnn", "train.epochs=1", "model.anchor_scales=[2, 4]",
                    f"train.ckpt_dir={tmp_path / 'fr'}", f"model.pretrained={vgg}", *common])
    assert fit.global_step == 2 and CheckpointManager(str(tmp_path / "fr")).all_steps() == [0]
    assert tuple(fit.state.model.rpn.cls.weight.shape[:1]) == (6,)  # 2 scales x 3 ratios
    # the VGG16 filled the 13 trunk convs and the head's MLP, and nothing else
    (loaded, got), = loads[1:]
    assert sorted(loaded) == sorted(want_frcnn) and len(want_frcnn) == 2 * 13 + 4
    assert all(torch.equal(got[k], v) for k, v in want_frcnn.items())


def test_cli_train_saves_on_sigterm_and_resumes(tmp_path, monkeypatch):
    """SIGTERM during the first step: the step finishes, the checkpoint is
    saved, the command returns; --resume finishes the run."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers are installed from the main thread only")
    fit_mod = importlib.import_module("fastvision_tpu_torch.train.fit")
    real = fit_mod.make_train_step

    def sigterm_after_first_step(*args, **kw):
        step, calls = real(*args, **kw), []

        def wrapped(state, batch, lr):
            out = step(state, batch, lr)
            calls.append(1)
            if len(calls) == 1:
                signal.raise_signal(signal.SIGTERM)
            return out

        return wrapped

    monkeypatch.setattr(cli, "_build_yolo", _small_yolo)
    monkeypatch.setattr(fit_mod, "make_train_step", sigterm_after_first_step)
    root = write_detection_dataset(str(tmp_path / "ds"), 4, sizes=SIZES, seed=6, num_classes=C)
    args = ["train", "train.epochs=2", f"train.ckpt_dir={tmp_path / 'ck'}",
            f"data.data_root={root}", "data.num_workers=0", f"data.input_size={SIZE}",
            "data.batch_size=2", f"model.num_classes={C}", "data.max_boxes=8", "train.bf16=false",
            "--device", "cpu"]
    before = signal.getsignal(signal.SIGTERM)
    fit = cli.main(args)
    assert fit.interrupted and fit.global_step == 1 and signal.getsignal(signal.SIGTERM) == before
    meta = CheckpointManager(str(tmp_path / "ck")).restore()["meta"]
    assert meta["preempted"] and meta["epoch"] == -1 and meta["epoch_batches_done"] == 1
    monkeypatch.setattr(fit_mod, "make_train_step", real)
    fit = cli.main([*args, "--resume"])
    assert not fit.interrupted and (fit.start_epoch, fit.global_step) == (0, 4)


def test_cli_rejects_what_is_not_ported(root, tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_build_yolo", _small_yolo)
    for state, match in (({"stem.weight": torch.zeros(1)}, "naming scheme"),
                         ({"backbone.conv0.conv.weight": torch.zeros(1)}, "no tensor")):
        torch.save(state, tmp_path / "pretrained.pth")
        with pytest.raises(ValueError, match=match):
            cli.main(["train", f"model.pretrained={tmp_path / 'pretrained.pth'}",
                      f"data.data_root={root}", "data.num_workers=0", "--device", "cpu"])
    for argv, item in ((["serve"], 16), (["export", "--task", "video", "--out", "x"], 16),
                       (["export", "--out", "x"], 16), (["anchors"], 2), (["doctor"], 10),
                       (["generate", "--out", "x"], 10),
                       (["convert", "--kind", "coco", "--out", "x"], 11),
                       (["eval", "--tta"], 6), (["eval", "--int8"], 15),
                       (["eval", "--fast-decode"], 6), (["infer", "--source", "a.mp4"], 6)):
        with pytest.raises(SystemExit, match=f"item {item}\\)"):
            cli.main(argv)
    common = [f"data.data_root={root}", "--device", "cpu"]
    for override, item in (("mesh_model=2", 17), ("fsdp=true", 17), ("data.i420=true", 6),
                           ("nms.multi_label=true", 5), ("data.host_shard=auto", 17)):
        with pytest.raises(NotImplementedError, match=f"item {item}\\)"):
            cli.main(["eval", override, *common])
    with pytest.raises(ValueError, match="YOLOv3"):
        cli.main(["eval", "model.name=faster_rcnn", *common])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["eval", f"data.data_root={root}"])
