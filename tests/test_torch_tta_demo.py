"""The port's Detector input paths against the JAX package's Detector with
the same weights, on the CPU in float32: packed I420 input
(``input_format='i420'``), the device letterbox, ``fast_decode``, test-time
augmentation (predict and evaluate) and the ``reference_demo`` postprocess
(pad 0, as the demo pads).

The JAX model gets the port's random weights through the JAX package's own
torch importer (`yolov3_from_torch` + `apply_import`). The images are JPEGs
whose decoded long side is the input size (directly, or at 1/2, 1/4, 1/8
with fast_decode) and arrays of that size, so both letterboxes only pad,
and both packages see the same pixels; labels are the port's own jittered
detections, so mAP has content.

Tolerances: pre-NMS predictions max|d| / std <= 1e-3; kept boxes within
1e-2 px after unscale (scores within 1e-4, the same classes); mAP equal to
1e-6.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.data as jd
import fastvision_tpu.ops.image as jimage
from fastvision_tpu.infer import Detector as JaxDetector
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu.models.import_torch import apply_import, yolov3_from_torch
from fastvision_tpu_torch.data import DetectionDataset, DetectionLoader
from fastvision_tpu_torch.infer import Detector
from fastvision_tpu_torch.models import YOLOv3
from fastvision_tpu_torch.ops.image import letterbox_batch, pack_canvas
from test_torch_fast_decode import _write, jax_native_jpeg  # noqa: F401 (a fixture)

torch.set_num_threads(2)
C, SIZE = 3, 64
ANCHORS = (np.array([[[32, 32], [40, 24], [24, 40]]] * 3, np.float32)
           / np.array([1, 1.6, 2.5], np.float32)[:, None, None])
KW = dict(input_size=SIZE, batch_size=2, conf_thres=0.05)


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


@pytest.fixture(scope="module")
def models():
    tm = YOLOv3(num_classes=C, stage_sizes=(1, 1, 1, 1, 1),
                generator=torch.Generator().manual_seed(0))
    jm = JaxYOLOv3(num_classes=C,
                   backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   {c: shapes[c] for c in ("params", "batch_stats")})
    variables = apply_import(zeros, yolov3_from_torch(
        {k: v.numpy() for k, v in tm.state_dict().items()}), verbose=False)
    return tm, jm, variables


def pair(models, **kw):
    tm, jm, variables = models
    return (Detector(tm, ANCHORS, device="cpu", dtype=torch.float32, **KW, **kw),
            JaxDetector(jm, variables, ANCHORS, dtype=jnp.float32, **KW, **kw))


@pytest.fixture(scope="module")
def root(tmp_path_factory, models):
    """The fast-decode test's JPEG + BMP split, labelled with the port's own
    detections (jittered), class by class."""
    root = _write(str(tmp_path_factory.mktemp("tta_demo")))
    tdet = Detector(models[0], ANCHORS, device="cpu", dtype=torch.float32, **KW)
    rng = np.random.default_rng(5)
    ds = DetectionDataset(root, "val")
    for res, _ in tdet.predict_dataset(ds):
        keep = res["scores"].argsort()[::-1][:4]
        with open(os.path.join(root, "val", "labels", res["id"] + ".txt"), "w") as f:
            for b, c in zip(res["boxes"][keep], res["classes"][keep]):
                b = b + rng.uniform(-1.5, 1.5, 4)
                f.write(f"{int(c)} {b[0]:.3f} {b[1]:.3f} {b[2]:.3f} {b[3]:.3f}\n")
    return root


def _arrays(n=3):
    rng = np.random.default_rng(7)
    import cv2

    return [cv2.GaussianBlur(rng.integers(0, 256, hw + (3,), dtype=np.uint8), (5, 5), 0)
            for hw in ((64, 48), (40, 64), (64, 64))[:n]]


def same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g["boxes"]) == len(w["boxes"]) > 0
        np.testing.assert_array_equal(g["classes"], np.asarray(w["classes"]))
        assert np.abs(g["boxes"] - np.asarray(w["boxes"])).max() <= 1e-2
        assert np.abs(g["scores"] - np.asarray(w["scores"])).max() <= 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / b.std())


def test_i420_matches_jax(models, root, jax_native_jpeg):
    tdet, jdet = pair(models, input_format="i420")
    ds, jds = DetectionDataset(root, "val"), jd.DetectionDataset(root, "val")
    batch = next(iter(DetectionLoader(ds, SIZE, 2, train=False, emit="i420").epoch(0)))
    got = tdet.predecode(torch.from_numpy(batch["images"])).numpy()
    want = jax.jit(jdet._predecode)(jdet.variables, jnp.asarray(batch["images"]))
    assert rel(got, want) <= 1e-3
    g = [r for r, _ in tdet.predict_dataset(ds)]
    w = [r for r, _ in jdet.predict_dataset(jds)]
    same_results(g, w)
    assert tdet.i420_fallbacks == 2  # the 4:1:1 JPEG and the BMP
    # in-memory arrays: the host converts the letterboxed batch to I420
    same_results(tdet.predict_batch(_arrays()), jdet.predict_batch(_arrays()))


def test_device_letterbox_matches_jax(models):
    tdet, jdet = pair(models, device_letterbox=True, canvas_hw=(80, 72))
    arrs = _arrays()
    canvas, sizes = pack_canvas(arrs, 80, 72)
    x = letterbox_batch(torch.from_numpy(canvas), torch.from_numpy(sizes), SIZE)[0]
    jx = jimage.letterbox_batch(jnp.asarray(canvas), jnp.asarray(sizes), SIZE)[0]
    assert np.abs(x.numpy() - np.asarray(jx)).max() <= 1e-3
    got = tdet.predecode(x).numpy()
    want = jax.jit(jdet._predecode)(jdet.variables, jx)
    assert rel(got, want) <= 1e-3
    same_results(tdet.predict_batch(arrs), jdet.predict_batch(arrs))


def test_fast_decode_and_tta_match_jax(models, root):
    tdet, jdet = pair(models, fast_decode=True)
    paths = sorted(os.path.join(root, "val", "images", f)
                   for f in os.listdir(os.path.join(root, "val", "images")))
    same_results(tdet.predict_batch(paths), jdet.predict_batch(paths))
    same_results(tdet.predict_batch(_arrays(), tta=True), jdet.predict_batch(_arrays(), tta=True))


def test_reference_demo_matches_jax(models, root):
    tdet, jdet = pair(models, postprocess_mode="reference_demo", pad_value=0)
    same_results(tdet.predict_batch(_arrays()), jdet.predict_batch(_arrays()))
    paths = [os.path.join(root, "val", "images", "000.jpg")]
    same_results(tdet.predict_batch(paths), jdet.predict_batch(paths))


@pytest.mark.parametrize("mode", ["tta", "reference_demo", "i420_device_matching"])
def test_evaluate_matches_jax(models, root, tmp_path, mode, jax_native_jpeg):
    kw = {"tta": dict(), "reference_demo": dict(postprocess_mode="reference_demo", pad_value=0),
          "i420_device_matching": dict(input_format="i420")}[mode]
    tdet, jdet = pair(models, **kw)
    # JPEGs decoded to a long side of SIZE (the JAX package resizes with cv2,
    # the port with torch: the letterbox must only pad), no BMP
    split = str(tmp_path / "split")
    shutil.copytree(root, split)
    os.remove(os.path.join(split, "val", "images", "006.bmp"))
    ds = DetectionDataset(split, "val", decode_size=SIZE)
    jds = jd.DetectionDataset(split, "val", decode_size=SIZE)
    ev = dict(tta=True) if mode == "tta" else {}
    match = mode == "i420_device_matching"
    got = tdet.evaluate(ds, device_matching=match, **ev)
    want = jdet.evaluate(jds, device_matching=match, **ev)
    assert got["images"] == want["images"] == 6 and got["map50"] > 0
    assert abs(got["map50"] - want["map50"]) <= 1e-6 and abs(got["map"] - want["map"]) <= 1e-6


def test_cli_i420_tta_and_fast_decode(tmp_path, monkeypatch):
    """``data.i420=true`` trains and evaluates through the CLI; ``eval --tta``,
    ``eval`` / ``infer`` / ``serve --fast-decode`` run (a small YOLOv3)."""
    import fastvision_tpu_torch.cli as cli
    import fastvision_tpu_torch.infer.serving as serving

    def small_yolo(cfg):
        return YOLOv3(num_classes=cfg.model.num_classes, channels=(128, 64, 32),
                      stage_sizes=(1, 1, 1, 1, 1),
                      generator=torch.Generator().manual_seed(cfg.train.seed))

    monkeypatch.setattr(cli, "_build_yolo", small_yolo)
    root = str(tmp_path / "ds")
    _write(root, "train")
    _write(root, "val")
    ckpt = str(tmp_path / "ck")
    common = [f"data.data_root={root}", "data.num_workers=0", f"data.input_size={SIZE}",
              "data.batch_size=2", f"model.num_classes={C}", "data.max_boxes=8",
              "train.bf16=false", "--device", "cpu"]
    fit = cli.main(["train", "data.i420=true", "train.epochs=1", f"train.ckpt_dir={ckpt}",
                    *common])
    assert fit.global_step == 3 and fit.train_loader.emit == fit.val_loader.emit == "i420"
    for flags in (["--tta"], ["--fast-decode"], ["--tta", "data.i420=true"]):
        res = cli.main(["eval", "--ckpt", ckpt, "nms.conf_thres=0.01", *flags, *common])
        assert res["images"] == 7 and 0 <= res["map50"] <= 1
    out = cli.main(["infer", "--ckpt", ckpt, "--fast-decode", "data.i420=true",
                    "--source", os.path.join(root, "val", "images"),
                    "--out", str(tmp_path / "out"), *common])
    assert len(out) == 7 and len(os.listdir(tmp_path / "out")) == 7
    served = []
    monkeypatch.setattr(serving, "serve", lambda service, **kw: served.append(service))
    cli.main(["serve", "--fast-decode", "data.i420=true", *common])
    det = served[0].detector
    assert det.fast_decode and det.input_format == "i420" and det.multi_label
