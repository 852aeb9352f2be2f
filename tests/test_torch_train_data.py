"""Port's training data path and mAP vs the JAX package on the CPU: the
detection dataset and loader over JPEGs written with cv2, the numpy
augmentations, prefetch_to_device, the host mAP evaluator, and the metric
logger.

Tolerances: labels, num_real, meta, epoch order and flips equal; images
within +-1 per pixel (the port letterboxes with torch's bilinear resize,
the JAX package with cv2's fixed-point one); mAP equal to 1e-12 (the same
numpy code on the same inputs).
"""
import json
import os

import numpy as np
import pytest
import torch

import fastvision_tpu.data as jd
from fastvision_tpu.ops import map as jax_map
from fastvision_tpu_torch.core import MetricLogger
from fastvision_tpu_torch.data import (
    Augmentation,
    DetectionDataset,
    DetectionLoader,
    HorizontalFlip,
    Op,
    VerticalFlip,
    boxes_to_normalized_xywh,
    pad_labels,
    prefetch_to_device,
    read_label_file,
)
from fastvision_tpu_torch.ops.map import MeanAveragePrecision, compute_ap, match_predictions
from fastvision_tpu_torch.testing import SyntheticDetectionDataset

SIZES = [(96, 128), (120, 90), (64, 64), (150, 100), (80, 140), (100, 100), (70, 50)]


@pytest.fixture(scope="module")
def det_root(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("torch_train_data")
    rng = np.random.default_rng(11)
    for split, n in (("train", 11), ("val", 7)):
        os.makedirs(root / split / "images")
        os.makedirs(root / split / "labels")
        for i in range(n):
            h, w = SIZES[i % len(SIZES)]
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            lines = []
            for _ in range(int(rng.integers(0, 4))):  # some images have no boxes
                bw, bh = int(rng.integers(8, w // 2)), int(rng.integers(8, h // 2))
                x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                img[y1 : y1 + bh, x1 : x1 + bw] = 200
                lines.append(f"{int(rng.integers(0, 3))} {x1} {y1} {x1 + bw} {y1 + bh}")
            cv2.imwrite(str(root / split / "images" / f"im{i:02d}.jpg"), img)
            if lines:
                (root / split / "labels" / f"im{i:02d}.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def _loaders(root, split, train, augmentation_fn=None, **kw):
    ours = DetectionLoader(DetectionDataset(root, split), train=train,
                           augmentation=augmentation_fn(Augmentation, HorizontalFlip)
                           if augmentation_fn else None, **kw)
    theirs = jd.DetectionLoader(jd.DetectionDataset(root, split), train=train,
                                augmentation=augmentation_fn(jd.Augmentation, jd.HorizontalFlip)
                                if augmentation_fn else None, **kw)
    return ours, theirs


def _assert_batches_match(ours, theirs, epoch):
    got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
    assert len(got) == len(want) == len(ours) == len(theirs)
    for g, w in zip(got, want):
        assert g["images"].shape == w["images"].shape and g["images"].dtype == np.uint8
        diff = np.abs(g["images"].astype(np.int16) - w["images"].astype(np.int16))
        assert diff.max() <= 1
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert g["num_real"] == w["num_real"]
        assert len(g["meta"]) == len(w["meta"]) == g["num_real"]
        for mg, mw in zip(g["meta"], w["meta"]):
            assert (mg["id"], mg["scale"], mg["pad"], tuple(mg["orig_hw"])) == \
                (mw["id"], mw["scale"], mw["pad"], tuple(mw["orig_hw"]))
            np.testing.assert_array_equal(mg["gt_pixels"], mw["gt_pixels"])
    return got


@pytest.mark.parametrize("epoch", [0, 3])
def test_train_loader_matches_jax(det_root, epoch):
    ours, theirs = _loaders(det_root, "train", True, input_size=96, batch_size=4, max_boxes=5,
                            seed=7)
    got = _assert_batches_match(ours, theirs, epoch)
    assert len(got) == 2  # 11 images, drop_last
    order = [m["id"] for b in got for m in b["meta"]]
    assert order == [m["id"] for b in theirs.epoch(epoch) for m in b["meta"]]


def test_val_loader_ragged_last_batch_matches_jax(det_root):
    ours, theirs = _loaders(det_root, "val", False, input_size=128, batch_size=3, max_boxes=4)
    got = _assert_batches_match(ours, theirs, 0)
    assert [b["num_real"] for b in got] == [3, 3, 1]
    last = got[-1]
    np.testing.assert_array_equal(last["images"][1], last["images"][0])
    assert (last["labels"][1:] == -1).all()
    ours.input_size = 64  # multi-scale: the loader follows a new size
    assert next(iter(ours))["images"].shape == (3, 64, 64, 3)


def test_augmented_flips_match_jax(det_root):
    ours, theirs = _loaders(det_root, "train", True,
                            augmentation_fn=lambda A, H: A([H(p=0.5)]),
                            input_size=96, batch_size=4, max_boxes=5, seed=3)
    _assert_batches_match(ours, theirs, 1)
    flips = [d is not None for d in ours.augmentation._last]
    assert flips == [d is not None for d in theirs.augmentation._last]


def test_augmentation_ops_and_replay_match_jax():
    rng_img = np.random.default_rng(0)
    img = rng_img.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    lab = np.array([[1, 2, 3, 12, 9], [0, 10, 5, 29, 19]], np.float32)
    ours = Augmentation([HorizontalFlip(p=0.5), VerticalFlip(p=0.5)])
    theirs = jd.Augmentation([jd.HorizontalFlip(p=0.5), jd.VerticalFlip(p=0.5)])
    for seed in range(6):
        gi, gl = ours(img, lab, np.random.default_rng(seed))
        wi, wl = theirs(img, lab, np.random.default_rng(seed))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        ri, rl = ours.replay(img, lab)
        np.testing.assert_array_equal(ri, gi)
        np.testing.assert_array_equal(rl, gl)
    with pytest.raises(RuntimeError):
        Augmentation([VerticalFlip()]).replay(img, lab)
    with pytest.raises(NotImplementedError):
        Op().apply(img, lab, {})


def test_dataset_and_label_helpers_match_jax(det_root, tmp_path):
    ours, theirs = DetectionDataset(det_root, "val"), jd.DetectionDataset(det_root, "val")
    assert ours.ids == theirs.ids and len(ours) == 7
    for i in range(len(ours)):
        gi, gl, gid = ours[i]
        wi, wl, wid = theirs[i]
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        assert gid == wid
    cached = DetectionDataset(det_root, "train", cache=True)
    with open(os.path.join(det_root, "train", ".samples.json")) as f:
        assert json.load(f) == cached.ids
    (tmp_path / "l.txt").write_text("0 1 2 3 4\nbad line\n2 5.5 6 7 8 extra\n")
    np.testing.assert_array_equal(read_label_file(str(tmp_path / "l.txt")),
                                  jd.dataset.read_label_file(str(tmp_path / "l.txt")))
    assert read_label_file(str(tmp_path / "missing.txt")).shape == (0, 5)
    boxes = np.array([[10, 20, 50, 60], [0, 0, 100, 80]], np.float32)
    np.testing.assert_array_equal(boxes_to_normalized_xywh(boxes, 80, 100),
                                  jd.dataset.boxes_to_normalized_xywh(boxes, 80, 100))
    xywhn = boxes_to_normalized_xywh(boxes, 80, 100)
    np.testing.assert_array_equal(pad_labels(np.array([1, 2]), xywhn, 4),
                                  jd.dataset.pad_labels(np.array([1, 2]), xywhn, 4))
    assert DetectionDataset(det_root, "val", decode_size=64).decode_size == 64  # ported


def test_loader_rejects_what_is_not_ported():
    ds = SyntheticDetectionDataset(4, 3)
    # host sharding is ported: a malformed spec is refused
    for spec in ("2/2", "x", (0, 0)):
        with pytest.raises(ValueError, match="host_shard"):
            DetectionLoader(ds, host_shard=spec)
    assert len(DetectionLoader(ds, batch_size=1, host_shard="1/2")) == 2
    # use_native and emit='i420' are ported; refused as the JAX package refuses
    for kw in (dict(emit="bgr"), dict(emit="i420", native_jpeg=True),
               dict(emit="rgb", native_jpeg=True, train=False)):
        with pytest.raises(ValueError):
            DetectionLoader(ds, **kw)
    # the worker pools are ported: the config's default builds, bad backends raise
    DetectionLoader(ds, num_workers=4, worker_backend="process").close()
    for kw in (dict(on_corrupt="ignore"), dict(num_workers=2, worker_backend="process:greenlet")):
        with pytest.raises(ValueError):
            DetectionLoader(ds, **kw)


def test_corrupt_samples_skip_policy():
    class Flaky(SyntheticDetectionDataset):
        def __getitem__(self, idx):
            if idx == 1:
                raise OSError("corrupt")
            return super().__getitem__(idx)

    ds = Flaky(4, 3, sizes=((40, 40),))
    with pytest.raises(OSError):
        list(DetectionLoader(ds, 32, 2, train=False).epoch(0))
    with pytest.warns(UserWarning, match="substituted index 2"):
        batches = list(DetectionLoader(ds, 32, 2, train=False, on_corrupt="skip").epoch(0))
    assert [m["id"] for m in batches[0]["meta"]] == ["synthetic_0", "synthetic_2"]


def test_synthetic_dataset_is_seeded():
    ds = SyntheticDetectionDataset(6, num_classes=5, seed=3)
    a, b = ds[4], SyntheticDetectionDataset(6, num_classes=5, seed=3)[4]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    img, lab, sid = ds[1]
    assert img.dtype == np.uint8 and img.shape == (480, 640, 3) and sid == "synthetic_1"
    assert lab.shape[1] == 5 and ((lab[:, 0] >= 0) & (lab[:, 0] < 5)).all()
    assert (lab[:, 3] <= 640).all() and (lab[:, 4] <= 480).all()
    with pytest.raises(IndexError):
        ds[6]


def test_prefetch_to_device_on_the_cpu():
    ds = SyntheticDetectionDataset(5, 3, sizes=((40, 60),))
    loader = DetectionLoader(ds, 32, 2, train=False)
    got = list(prefetch_to_device(loader.epoch(0), device="cpu"))
    want = list(loader.epoch(0))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert isinstance(g["images"], torch.Tensor) and isinstance(g["labels"], torch.Tensor)
        np.testing.assert_array_equal(g["images"].numpy(), w["images"])
        assert g["num_real"] == w["num_real"]
        assert [m["id"] for m in g["meta"]] == [m["id"] for m in w["meta"]]

    def failing():
        yield next(loader.epoch(0))
        raise KeyError("decode failed")

    it = prefetch_to_device(failing(), device="cpu")
    next(it)
    with pytest.raises(KeyError, match="decode failed"):
        next(it)
    early = prefetch_to_device(loader.epoch(0), device="cpu", buffer_size=1)
    next(early)
    early.close()  # an early stop winds the threads down
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(prefetch_to_device(loader.epoch(0)))


def _map_inputs(seed, n_images=12, num_classes=4):
    rng = np.random.default_rng(seed)
    images = []
    for _ in range(n_images):
        n_gt = int(rng.integers(0, 6))
        xy = rng.uniform(0, 200, (n_gt, 2))
        gt = np.concatenate([xy, xy + rng.uniform(10, 80, (n_gt, 2))], 1).astype(np.float32)
        gcls = rng.integers(0, num_classes, n_gt)
        # predictions: jittered copies of GTs (some wrong class) + clutter
        jit = gt + rng.normal(0, 6, gt.shape).astype(np.float32)
        pcls = np.where(rng.uniform(size=n_gt) < 0.8, gcls, rng.integers(0, num_classes, n_gt))
        clutter_xy = rng.uniform(0, 200, (3, 2))
        clutter = np.concatenate([clutter_xy, clutter_xy + 30], 1).astype(np.float32)
        boxes = np.concatenate([jit, clutter])
        classes = np.concatenate([pcls, rng.integers(0, num_classes, 3)])
        scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
        images.append((boxes, scores, classes, gt, gcls))
    return images


@pytest.mark.parametrize("method", ["coco", "voc2007", "voc2009"])
def test_map_matches_jax(method):
    ours = MeanAveragePrecision(method=method)
    theirs = jax_map.MeanAveragePrecision(method=method)
    for boxes, scores, classes, gt, gcls in _map_inputs(1):
        ours.update(boxes, scores, classes, gt, gcls)
        theirs.update(boxes, scores, classes, gt, gcls)
    got, want = ours.compute(), theirs.compute()
    assert 0 < got.map50 < 1
    assert got.map50 == pytest.approx(want.map50, abs=1e-12)
    assert got.map == pytest.approx(want.map, abs=1e-12)
    np.testing.assert_allclose(got.ap_per_class_per_iou, want.ap_per_class_per_iou, atol=1e-12)
    np.testing.assert_allclose(got.precision, want.precision, atol=1e-12)
    np.testing.assert_allclose(got.recall, want.recall, atol=1e-12)
    assert got.classes == want.classes


def test_map_pieces_and_edge_cases_match_jax():
    boxes, scores, classes, gt, gcls = _map_inputs(2)[3]
    thr = np.linspace(0.5, 0.95, 10)
    np.testing.assert_array_equal(match_predictions(boxes, classes, gt, gcls, thr),
                                  jax_map.match_predictions(boxes, classes, gt, gcls, thr))
    rec = np.array([0.1, 0.4, 0.4, 0.8])
    prec = np.array([1.0, 0.7, 0.6, 0.5])
    for method in ("coco", "voc2007", "voc2009"):
        assert compute_ap(rec, prec, method) == jax_map.compute_ap(rec, prec, method)
    with pytest.raises(ValueError):
        compute_ap(rec, prec, "voc2012")
    empty = MeanAveragePrecision()
    empty.update(np.zeros((0, 4)), np.zeros(0), np.zeros(0), gt[:1], gcls[:1])
    assert empty.compute().map50 == 0.0
    masked = MeanAveragePrecision()
    masked.update(boxes, scores, classes, gt, gcls, pred_valid=scores > 0.5,
                  true_valid=np.ones(len(gt), bool))
    ref = jax_map.MeanAveragePrecision()
    ref.update(boxes, scores, classes, gt, gcls, pred_valid=scores > 0.5,
               true_valid=np.ones(len(gt), bool))
    assert masked.compute().map == ref.compute().map


def test_metric_logger(tmp_path, capsys):
    log = MetricLogger(str(tmp_path / "logs"), name="fit")
    log.log(3, loss=torch.tensor(1.5), lr=0.01, epoch=1, note="warm")
    log.close()
    rec = json.loads((tmp_path / "logs" / "fit.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 1.5 and rec["note"] == "warm"
    assert "[fastvision] step=3 loss=1.5 lr=0.01 epoch=1 note=warm" in capsys.readouterr().out
