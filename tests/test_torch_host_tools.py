"""The port's host tools against the JAX package's, on the same inputs:
anchor k-means and ``AnchorGenerator`` (fastvision_tpu/ops/anchors.py),
the COCO / VOC converters (data/converters.py, on tests/test_converters.py's
fixtures: byte-equal trees), the class-name tables (data/class_names.py),
the VOC submission writer (infer/voc_submit.py, byte-equal files), the
plots (core/plots.py), ``trace`` (core/telemetry.py), and the CLI's
``convert``, ``anchors``, ``generate`` and ``doctor``.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

import fastvision_tpu.cli as jcli
import fastvision_tpu.data.class_names as jnames
import fastvision_tpu.data.converters as jconv
import fastvision_tpu.ops.anchors as janchors
import fastvision_tpu_torch.cli as cli
import fastvision_tpu_torch.data.class_names as tnames
import fastvision_tpu_torch.data.converters as tconv
import fastvision_tpu_torch.ops.anchors as tanchors
from fastvision_tpu.infer.voc_submit import write_voc_submission as jax_write_voc
from fastvision_tpu_torch.core import span, trace
from fastvision_tpu_torch.core.config import Config, to_dict
from fastvision_tpu_torch.core.plots import plot_anchors, plot_metrics, plot_pr_curves
from fastvision_tpu_torch.core.telemetry import MetricLogger
from fastvision_tpu_torch.infer.voc_submit import write_voc_submission
from fastvision_tpu_torch.ops.map import MAPResult
from fastvision_tpu_torch.testing import write_detection_dataset
from test_anchors import three_cluster_wh
from test_converters import coco_fixture, voc_fixture  # noqa: F401 (fixtures)


def _tree(root: str) -> dict[str, bytes]:
    """Relative path -> bytes of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ---------------------------------------------------------------- anchors
@pytest.mark.parametrize("init", ["random", "++"])
@pytest.mark.parametrize("seed", [0, 7])
def test_kmeans_anchors_identical_to_jax(init, seed):
    wh = three_cluster_wh(np.random.default_rng(seed + 100))
    got = tanchors.kmeans_anchors(wh, k=3, iters=40, seed=seed, init=init)
    want = janchors.kmeans_anchors(wh, k=3, iters=40, seed=seed, init=init)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="init"):
        tanchors.kmeans_anchors(wh, k=3, init="kmeans")
    with pytest.raises(ValueError, match="at least k=9"):
        tanchors.kmeans_anchors(wh[:5])
    np.testing.assert_array_equal(tanchors.COCO_ANCHORS, janchors.COCO_ANCHORS)


def test_anchor_generator_identical_to_jax(tmp_path):
    rng = np.random.default_rng(3)
    labels = np.zeros((300, 5), np.float32)
    labels[:, 1:3] = rng.uniform(0, 50, (300, 2))
    labels[:, 3:5] = labels[:, 1:3] + three_cluster_wh(rng)
    ds = [(None, labels[i:i + 2]) for i in range(0, 300, 2)]
    kw = dict(k=3, iters=30, init="++")
    got = tanchors.AnchorGenerator([ds], cache_dir=str(tmp_path / "t"), **kw)
    want = janchors.AnchorGenerator([ds], cache_dir=str(tmp_path / "j"), **kw)
    np.testing.assert_array_equal(got._scan_wh(), want._scan_wh())
    a = got.get_anchors()
    np.testing.assert_array_equal(a, want.get_anchors())
    with open(tmp_path / "t" / "anchors.json", "rb") as f, \
            open(tmp_path / "j" / "anchors.json", "rb") as g:
        assert f.read() == g.read()
    cached = tanchors.AnchorGenerator(cache_dir=str(tmp_path / "t"), use_cache=True).get_anchors()
    np.testing.assert_array_equal(cached, a)


def test_cli_anchors_matches_jax(tmp_path, capsys):
    root = write_detection_dataset(str(tmp_path / "ds"), 12, sizes=((64, 64), (48, 80)), seed=4,
                                   num_classes=3)
    plot = str(tmp_path / "anchors.png")
    got = cli.main(["anchors", f"data.data_root={root}", "-k", "4", "--cache-dir",
                    str(tmp_path / "c"), "--plot", plot])
    out = capsys.readouterr().out
    jcli.main(["anchors", f"data.data_root={root}", "-k", "4", "--cache-dir",
               str(tmp_path / "jc"), "--plot", str(tmp_path / "janchors.png")])
    jout = capsys.readouterr().out
    assert out.split("anchors (w, h)")[1] == jout.split("anchors (w, h)")[1]
    assert got.shape == (4, 2) and os.path.getsize(plot) > 1000
    got = cli.main(["anchors", f"data.data_root={root}", "-k", "4", "--cache-dir",
                    str(tmp_path / "c")])
    jcli.main(["anchors", f"data.data_root={root}", "-k", "4", "--cache-dir",
               str(tmp_path / "jc")])
    assert _tree(str(tmp_path / "c")) == _tree(str(tmp_path / "jc"))


# ---------------------------------------------------------------- converters and class names
def test_coco_to_fastvision_byte_equal_to_jax(coco_fixture, tmp_path):  # noqa: F811
    ann, imgs, _ = coco_fixture
    for copy_images in (True, False):
        t, j = str(tmp_path / f"t{copy_images}"), str(tmp_path / f"j{copy_images}")
        assert tconv.coco_to_fastvision(ann, imgs, t, split="val", copy_images=copy_images) \
            == jconv.coco_to_fastvision(ann, imgs, j, split="val", copy_images=copy_images) == 2
        assert _tree(t) == _tree(j)
        assert os.path.islink(os.path.join(t, "val", "images", "img0.jpg")) != copy_images
    assert tconv.coco_90_to_80_map() == jconv.coco_90_to_80_map()
    assert tconv.coco_80_to_91_ids() == jconv.coco_80_to_91_ids()


def test_voc_to_fastvision_byte_equal_to_jax(voc_fixture, tmp_path):  # noqa: F811
    root, _ = voc_fixture
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    assert tconv.voc_to_fastvision(root, t, image_set="train", copy_images=True) \
        == jconv.voc_to_fastvision(root, j, image_set="train", copy_images=True) == 1
    assert _tree(t) == _tree(j)


def test_cli_convert_byte_equal_to_jax(coco_fixture, voc_fixture, tmp_path, capsys):  # noqa: F811
    ann, imgs, _ = coco_fixture
    voc_root, _ = voc_fixture
    for kind, args in (("coco", ["--ann", ann, "--images", imgs]),
                       ("voc", ["--voc-root", voc_root])):
        t, j = str(tmp_path / f"t_{kind}"), str(tmp_path / f"j_{kind}")
        n = cli.main(["convert", "--kind", kind, *args, "--out", t])
        jcli.main(["convert", "--kind", kind, *args, "--out", j])
        assert n == (2 if kind == "coco" else 1)
        assert _tree(t) == _tree(j)  # the images symlinked, read through the links
    out = capsys.readouterr().out
    assert "converted 2 images" in out and "converted 1 images" in out


def test_class_names_equal_to_jax(tmp_path):
    assert tnames.DATASETS == jnames.DATASETS
    for name in tnames.DATASETS:
        assert tnames.categories_for(name) == jnames.categories_for(name)
    got = tnames.make_descriptor("kinetics400", "/data/k400", str(tmp_path / "t.yaml"), 224)
    want = jnames.make_descriptor("kinetics400", "/data/k400", str(tmp_path / "j.yaml"), 224)
    assert got == want
    assert (tmp_path / "t.yaml").read_bytes() == (tmp_path / "j.yaml").read_bytes()
    with pytest.raises(KeyError, match="unknown dataset"):
        tnames.categories_for("mnist")


def test_write_voc_submission_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(6)
    dets = {}
    for i in range(4):
        n = int(rng.integers(0, 6))
        xy = rng.uniform(0, 300, (n, 2))
        dets[f"2012_{i:06d}"] = {
            "boxes": np.concatenate([xy, xy + rng.uniform(1, 80, (n, 2))], 1).astype(np.float32),
            "scores": rng.uniform(0, 1, n).astype(np.float32),
            "classes": rng.integers(0, 21, n)}  # 20 is no VOC class: left out
    names = tnames.VOC_CLASSES
    got = write_voc_submission(dets, names, str(tmp_path / "t"))
    want = jax_write_voc(dets, names, str(tmp_path / "j"))
    assert os.path.relpath(got, tmp_path / "t") == os.path.relpath(want, tmp_path / "j")
    assert _tree(got) == _tree(want) and len(_tree(got)) == 20


# ---------------------------------------------------------------- plots and telemetry
def test_plots_write_pngs(tmp_path):
    logger = MetricLogger(str(tmp_path), stdout=False)
    for step in range(5):
        logger.log(step, loss=1.0 / (step + 1), lr=0.01)
    logger.close()
    paths = [plot_metrics(str(tmp_path / "train.jsonl"), str(tmp_path / "curves.png"))]
    rng = np.random.default_rng(0)
    wh = rng.uniform(5, 100, (50, 2))
    paths.append(plot_anchors(wh, np.array([[10, 10], [80, 80]], np.float32),
                              (wh[:, 0] > 40).astype(int), str(tmp_path / "a" / "anchors.png")))
    res = MAPResult(map_per_iou=np.linspace(0.8, 0.2, 10),
                    ap_per_class_per_iou=rng.uniform(0, 1, (3, 10)), classes=[0, 1, 2],
                    precision=np.array([0.8, 0.7, 0.9]), recall=np.array([0.6, 0.5, 0.7]),
                    iou_thresholds=np.linspace(0.5, 0.95, 10))
    paths += plot_pr_curves(res, str(tmp_path / "pr"), ["a", "b", "c"])
    assert len(paths) == 4
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        assert os.path.getsize(p) > 1000
    (tmp_path / "empty.jsonl").write_text("")
    with pytest.raises(ValueError, match="no records"):
        plot_metrics(str(tmp_path / "empty.jsonl"), str(tmp_path / "x.png"))


def test_step_timer_trace_and_flops(tmp_path):
    """``trace``: a Chrome trace of the region's operations and spans, in
    the directory it yields."""
    with trace(str(tmp_path / "trace")) as d:
        with span("fit.step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == str(tmp_path / "trace")
    with open(os.path.join(d, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"fit.step", "aten::mm"} <= names


# ---------------------------------------------------------------- generate and doctor
@pytest.mark.parametrize("model", ["yolov3", "faster_rcnn"])
def test_cli_generate_matches_jax(tmp_path, model):
    extra = ["train.epochs=3", "data.input_size=320"]
    out = cli.main(["generate", "--out", str(tmp_path / "t"), "--model", model, *extra])
    jcli.main(["generate", "--out", str(tmp_path / "j"), "--model", model, *extra])
    with open(os.path.join(out, "cfg.yaml")) as f:
        got = yaml.safe_load(f)
    with open(tmp_path / "j" / "cfg.yaml") as f:
        want = yaml.safe_load(f)
    assert got == want
    assert got["model"]["name"] == model and got["train"]["epochs"] == 3
    assert to_dict(Config()).keys() == got.keys()
    with open(os.path.join(out, "train.py")) as f:
        assert "from fastvision_tpu_torch.cli import main" in f.read()
    with pytest.raises(SystemExit, match="exists"):
        cli.main(["generate", "--out", out])


def test_cli_doctor_exits_nonzero_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(SystemExit, match="no CUDA card") as e:
        cli.main(["doctor"])
    assert e.value.code != 0
    out = capsys.readouterr().out
    assert "[doctor] cuda_devices           0" in out and '"has_matplotlib": true' in out
