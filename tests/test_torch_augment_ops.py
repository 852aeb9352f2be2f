"""Port's augmentation ops vs the JAX package's on the CPU, same image, same
seed, same decision.

Tolerances: the numpy ops of both packages (bgr2rgb, padding, the crops,
channel_shuffle, normalization) byte-equal; the median blur byte-equal to
cv2's; the resizes (`dataset.resize_bilinear` against cv2's INTER_LINEAR)
within 1 per pixel, exact on >= 80% of the values; CLAHE and the box and
Gaussian blurs within 1 per pixel, exact on >= 99.9% (equal on every image
tried with this cv2); the exact share is printed. Labels equal; draws equal,
the generator left in the same state.

The JAX ops that call cv2 import it inside `apply`: the tests that run them
import cv2 first (`pytest.importorskip`), the others need no cv2.
"""
import numpy as np
import pytest

import fastvision_tpu.data.augment as J
import fastvision_tpu_torch.data.augment as T
from fastvision_tpu_torch.data import (
    ClassificationDataset,
    ClassificationLoader,
    DetectionDataset,
    DetectionLoader,
)
from fastvision_tpu_torch.testing import write_classification_dataset, write_detection_dataset

NUMPY_OPS = [("bgr2rgb", {}), ("padding", {"size": 300}), ("padding", {"size": 40}),
             ("padding", {"size": 300, "position": "lefttop", "pad_value": 0}),
             ("center_crop", {"size": 120}), ("center_crop", {"size": 400}),
             ("random_crop", {"size": 120}), ("random_crop", {"size": 400}),
             ("channel_shuffle", {}), ("normalization", {}),
             ("normalization", {"mean": (0.5, 0.5, 0.5), "std": (0.25, 0.5, 1.0)})]
RESIZE_OPS = [("resize", {"size": 96}), ("resize", {"size": (150, 250)}),
              ("resize_by_max", {"size": 128}), ("resize_by_max", {"size": 300}),
              ("jitter", {"ratio": 0.3}), ("jitter", {"ratio": 0.5})]
FILTER_OPS = [("hist_equalize", {}), ("hist_equalize", {"clip_limit": 4.0}),
              ("hist_equalize", {"clip_limit": 0.0}), ("blur", {}), ("blur", {"ksize": 5}),
              ("blur", {"kind": "gaussian"}), ("blur", {"kind": "gaussian", "ksize": 9}),
              ("blur", {"kind": "median"}), ("blur", {"kind": "median", "ksize": 5})]
SHAPES = [(160, 200), (97, 131)]  # one a multiple of CLAHE's 8 x 8 grid, one not


def _image(shape, seed=0):
    """Smooth structure plus noise: CLAHE and the blurs see real contrast."""
    h, w = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 110 + 70 * np.sin(xx / 13.0)[..., None] * np.cos(yy / 9.0)[..., None]
    return np.clip(base * (1 + 0.3 * np.arange(3)) / 1.3 + rng.normal(0, 18, (h, w, 3)),
                   0, 255).astype(np.uint8)


def _labels(shape):
    h, w = shape
    return np.array([[0, 5, 8, w * 0.4, h * 0.5], [3, w * 0.3, h * 0.2, w - 2, h - 3],
                     [1, w - 20, h - 20, w - 19.5, h - 1]], np.float32)


def _both(name, kw, image, labels, seed=5):
    """One decision drawn by each package's op from one seed, then applied."""
    j, t = J.OP_REGISTRY[name](**kw), T.OP_REGISTRY[name](**kw)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    dj, dt = j.sample(rj, image), t.sample(rt, image)
    assert dj == dt and rj.bit_generator.state == rt.bit_generator.state
    return j.apply(image, labels, dj), t.apply(image, labels, dt)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,kw", NUMPY_OPS)
def test_numpy_ops_byte_equal_to_jax(name, kw, shape):
    image, labels = _image(shape), _labels(shape)
    (ij, lj), (it, lt) = _both(name, kw, image, labels)
    assert it.dtype == ij.dtype and np.array_equal(it, ij)
    assert lt.dtype == lj.dtype and np.array_equal(lt, lj)


def _compare(name, kw, shape, min_exact):
    cv2 = pytest.importorskip("cv2")  # the JAX op's own reference
    image, labels = _image(shape, seed=1), _labels(shape)
    (ij, lj), (it, lt) = _both(name, kw, image, labels)
    assert it.shape == ij.shape and it.dtype == ij.dtype == np.uint8
    diff = np.abs(it.astype(np.int16) - ij)
    exact = float((diff == 0).mean())
    print(f"{name} {kw} {shape}: exact share {exact:.6f}, max |diff| {diff.max()} "
          f"(cv2 {cv2.__version__})")
    assert diff.max() <= 1 and exact >= min_exact
    assert np.array_equal(lt, lj)
    return exact


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,kw", RESIZE_OPS)
def test_resize_ops_within_one_of_cv2(name, kw, shape):
    _compare(name, kw, shape, 0.8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,kw", FILTER_OPS)
def test_clahe_and_blurs_against_cv2(name, kw, shape):
    exact = _compare(name, kw, shape, 0.999)
    if kw.get("kind") == "median":
        assert exact == 1.0


def test_float_images_through_the_float_capable_ops():
    """After 'normalization' the image is float32: the blurs (box and
    Gaussian in float64 sums, the median by comparisons) and the resizes
    keep float32 and stay within float rounding of cv2; CLAHE refuses it,
    as cv2's does."""
    pytest.importorskip("cv2")
    image = T.Normalization().apply(_image((48, 64), seed=2), None, {})[0]
    for name, kw, atol in (("blur", {}, 1e-6), ("blur", {"kind": "gaussian", "ksize": 5}, 1e-6),
                           ("blur", {"kind": "median"}, 0.0), ("resize", {"size": 40}, 1e-5),
                           ("padding", {"size": 70}, 0.0), ("hflip", {}, 0.0)):
        (ij, _), (it, _) = _both(name, kw, image, None)
        assert it.dtype == ij.dtype == np.float32
        np.testing.assert_allclose(it, ij, rtol=0, atol=atol, err_msg=name)
    with pytest.raises(ValueError, match="uint8"):
        T.HistEqualize().apply(image, None, {})


def test_crops_drop_boxes_of_one_pixel_or_less():
    labels = np.array([[0, 10, 10, 50, 50], [1, 0, 0, 10.5, 30], [2, 0, 0, 11.5, 30],
                       [3, 70, 70, 90, 90]], np.float32)
    image = _image((100, 100))
    (_, lj), (_, lt) = _both("center_crop", {"size": 80}, image, labels)
    assert np.array_equal(lt, lj) and lt[:, 0].tolist() == [0.0, 2.0, 3.0]


PIPELINE = ["bgr2rgb:0.5", {"op": "jitter", "ratio": 0.3, "p": 0.7},
            {"op": "resize_by_max", "size": 256, "p": 0.8}, {"op": "padding", "size": 240, "p": 0.5},
            {"op": "random_crop", "size": 200}, {"op": "center_crop", "size": 180, "p": 0.5},
            {"op": "resize", "size": [160, 176], "p": 0.5}, "hflip:0.5", "vflip:0.5",
            {"op": "hsv", "p": 0.5, "s_gain": 0.6}, {"op": "hist_equalize", "p": 0.5},
            {"op": "blur", "kind": "median", "p": 0.5}, "channel_shuffle:0.5",
            {"op": "normalization", "p": 0.5}]


def test_pipeline_of_every_op_draws_and_replays_as_jax():
    """A 14-op pipeline from string and dict specs, through both packages
    with one seed per sample: the same decisions, the same labels and image
    shapes and dtypes; the pixels differ by the resizes' +-1 carried through
    the later ops. ``replay`` repeats each package's own call exactly."""
    pytest.importorskip("cv2")
    pj, pt = J.build_augmentation(PIPELINE), T.build_augmentation(PIPELINE)
    assert {type(op) for op in pt.ops} == set(T.OP_REGISTRY.values())  # all 14
    assert [type(op).__name__ for op in pt.ops] == [type(op).__name__ for op in pj.ops]
    applied = np.zeros(len(PIPELINE), int)
    for seed in range(12):
        shape = ((240, 320), (300, 200), (97, 131))[seed % 3]
        image, labels = _image(shape, seed), _labels(shape)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        ij, lj = pj(image, labels, rj)
        it, lt = pt(image, labels, rt)
        assert pt._last == pj._last and rj.bit_generator.state == rt.bit_generator.state
        applied += [d is not None for d in pt._last]
        assert it.shape == ij.shape and it.dtype == ij.dtype
        np.testing.assert_allclose(lt, lj, rtol=1e-6)
        scale = 1 / (255 * 0.224) if it.dtype == np.float32 else 1
        assert np.abs(it.astype(np.float64) - ij).mean() <= 4 * scale
        again, lab_again = pt.replay(image, labels)
        assert np.array_equal(again, it) and np.array_equal(lab_again, lt)
    assert applied.min() > 0  # every op ran at least once


def test_build_augmentation_has_every_jax_op():
    assert set(T.OP_REGISTRY) == set(J.OP_REGISTRY)
    for name in J.OP_REGISTRY:
        assert type(T.build_augmentation([name if name not in (
            "resize", "resize_by_max", "padding", "center_crop", "random_crop")
            else {"op": name, "size": 8}]).ops[0]).__name__ == J.OP_REGISTRY[name].__name__
    with pytest.raises(ValueError, match="unknown augment op"):
        T.build_augmentation(["sharpen"])
    assert T.build_augmentation([]) is None


@pytest.fixture(scope="module")
def det_root(tmp_path_factory):
    return write_detection_dataset(str(tmp_path_factory.mktemp("aug_det")), 4,
                                   sizes=((64, 64),), seed=3, num_classes=3)


def test_detection_loader_emits_float_batches_after_normalization(det_root):
    """A pipeline ending in 'normalization' gives float32 batches, equal to
    the JAX loader's on its serial path (64 px images: no resize); the
    process pool, whose slots are uint8, refuses it (the JAX package's
    pool casts it into uint8 unchecked)."""
    from fastvision_tpu.data import pipeline as jp
    from fastvision_tpu.data.dataset import DetectionDataset as JaxDetectionDataset

    specs = ["hflip:0.5", "normalization"]
    common = dict(input_size=64, batch_size=2, max_boxes=8, train=True, mosaic_prob=0.0, seed=1)
    jb = next(iter(jp.DetectionLoader(JaxDetectionDataset(det_root, "train"),
                                      augmentation=J.build_augmentation(specs), **common)))
    loader = DetectionLoader(DetectionDataset(det_root, "train"),
                             augmentation=T.build_augmentation(specs), **common)
    tb = next(iter(loader))
    assert tb["images"].dtype == jb["images"].dtype == np.float32
    assert np.array_equal(tb["images"], jb["images"])
    assert np.array_equal(tb["labels"], jb["labels"])
    pooled = DetectionLoader(DetectionDataset(det_root, "train"), num_workers=2,
                             worker_backend="process",
                             augmentation=T.build_augmentation(specs), **common)
    try:
        with pytest.raises(RuntimeError, match="slots hold uint8"):
            next(iter(pooled))
    finally:
        pooled.close()
    with pytest.raises(ValueError, match="emit='i420' takes uint8"):
        next(iter(DetectionLoader(DetectionDataset(det_root, "train"), emit="i420",
                                  augmentation=T.build_augmentation(specs), **common)))


def test_classification_loader_with_the_cls_recipe_matches_jax(tmp_path):
    """random_crop, center_crop, resize and hflip (the classification
    recipe) then 'normalization': the port's batches against the JAX
    loader's on the serial path, float32 (the final resize to the input
    size is an identity here: resize already gave 32 x 32)."""
    from fastvision_tpu.data import pipeline as jp
    from fastvision_tpu.data.dataset import ClassificationDataset as JaxClassificationDataset

    pytest.importorskip("cv2")
    root = write_classification_dataset(str(tmp_path), 8, num_classes=2,
                                        sizes=((48, 40), (36, 52)), seed=4)
    specs = [{"op": "random_crop", "size": 36}, {"op": "center_crop", "size": 34},
             {"op": "resize", "size": 32}, "hflip:0.5"]
    for tail in ([], ["normalization"]):
        common = dict(input_size=32, batch_size=4, train=True, seed=2)
        jb = next(iter(jp.ClassificationLoader(JaxClassificationDataset(root, "train"),
                                               augmentation=J.build_augmentation(specs + tail),
                                               **common)))
        tb = next(iter(ClassificationLoader(ClassificationDataset(root, "train"),
                                            augmentation=T.build_augmentation(specs + tail),
                                            **common)))
        assert tb["images"].dtype == jb["images"].dtype
        assert np.array_equal(tb["labels"], jb["labels"])
        step = 1 / (255 * 0.224) if tail else 1  # one uint8 step after normalization
        assert np.abs(tb["images"].astype(np.float64) - jb["images"]).max() <= step * 1.0001
