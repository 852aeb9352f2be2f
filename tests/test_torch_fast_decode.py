"""The port's reduced decode and I420 data path against the JAX package's, on
the CPU: `imread_rgb_scaled`, ``DetectionDataset(decode_size=)`` and its
label rescale, ``sample_i420``, `preprocess_image(fast_decode=True)`'s meta,
and ``DetectionLoader(emit='i420')`` eval batches (fused decode, and the
plain chain for the files it does not take) on the serial and the process
backends, plus ``use_native``.

The tests that hold the port against the JAX package's native JPEG -> I420
decode take the `jax_native_jpeg` fixture: it builds that library into the
worker's own temporary directory where this process's first build fell back
to the letterbox-only one (the JAX package's concurrent first builds share
one temporary file name, and a worker that loses keeps the fallback).

The data: JPEGs written by cv2 at sizes whose decoded long side is the input
size or a power-of-two multiple of it (so the RGB letterbox only pads and
both packages' pixels agree), a 4:1:1 JPEG and a BMP (the plain chain), and
labels in original pixels. Everything compared is byte-equal, labels and
metas included; the letterboxed RGB of `preprocess_image` within 1 (the
port resizes with torch, the JAX package with cv2).
"""
import os
import tempfile

import cv2
import numpy as np
import pytest

import fastvision_tpu.data as jd
import fastvision_tpu.native as jnative
from fastvision_tpu.infer import preprocess as jpre
from fastvision_tpu_torch.data import DetectionDataset, DetectionLoader
from fastvision_tpu_torch.data import dataset as tds
from fastvision_tpu_torch.infer import preprocess as tpre
from fastvision_tpu_torch.ops.image import rgb_batch_to_i420_packed

SIZE = 64
# (h, w, sampling): decoded at 1/1, 1/2, 1/4, 1/8 at SIZE
FILES = ((64, 48, "420"), (128, 100, "420"), (90, 256, "422"), (512, 300, "444"),
         (60, 64, "440"), (40, 64, "411"))


def _write(root: str, split: str = "val") -> str:
    rng = np.random.default_rng(0)
    img_dir, lab_dir = (os.path.join(root, split, d) for d in ("images", "labels"))
    os.makedirs(img_dir)
    os.makedirs(lab_dir)
    samp = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    shapes = [(h, w) for h, w, _ in FILES] + [(64, 50)]
    for i, (h, w) in enumerate(shapes):
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 0)
        if i < len(FILES):
            cv2.imwrite(os.path.join(img_dir, f"{i:03d}.jpg"), img,
                        [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         samp[FILES[i][2]]])
        else:
            cv2.imwrite(os.path.join(img_dir, f"{i:03d}.bmp"), img)
        with open(os.path.join(lab_dir, f"{i:03d}.txt"), "w") as f:
            for k in range(1 + i % 3):
                x1, y1 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
                f.write(f"{k % 3} {x1:.2f} {y1:.2f} {x1 + w / 3:.2f} {y1 + h / 3:.2f}\n")
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("fast_decode")))


@pytest.fixture(scope="module")
def jax_native_jpeg(tmp_path_factory):
    """The JAX package's native JPEG -> I420 decode, loaded in this process.
    Where its first build lost the race for the shared temporary file and
    fell back to the letterbox-only library, build it again, alone, in a
    directory of this worker's own; skip only on a host without libjpeg."""
    if not jnative.jpeg_i420_available():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tempfile, "gettempdir",
                       lambda d=str(tmp_path_factory.mktemp("jax_native")): d)
            jnative._TRIED, jnative._LIB, jnative._HAS_JPEG = False, None, False
            jnative._build_and_load()
    if not jnative.jpeg_i420_available():
        pytest.skip("native jpeg kernel unavailable")


def _paths(root):
    d = os.path.join(root, "val", "images")
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]


def test_imread_rgb_scaled_matches_jax(root):
    for path in _paths(root):
        for target in (SIZE, 32, 200):
            img, orig = tds.imread_rgb_scaled(path, target)
            jimg, jorig = jd.dataset.imread_rgb_scaled(path, target)
            np.testing.assert_array_equal(img, jimg)
            assert tuple(orig) == tuple(jorig)


def test_dataset_decode_size_and_sample_i420_match_jax(root, jax_native_jpeg):
    for decode_size in (None, SIZE):
        ds = DetectionDataset(root, "val", decode_size=decode_size)
        jds = jd.DetectionDataset(root, "val", decode_size=decode_size)
        for i in range(len(ds)):
            (img, lab, sid), (jimg, jlab, jsid) = ds[i], jds[i]
            np.testing.assert_array_equal(img, jimg)
            np.testing.assert_array_equal(lab, jlab)
            assert sid == jsid
            got, want = ds.sample_i420(i, SIZE), jds.sample_i420(i, SIZE)
            if want is None:
                assert got is None
                continue
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_preprocess_fast_decode_meta_matches_jax(root):
    for path in _paths(root):
        for fast in (False, True):
            out, meta = tpre.preprocess_image(path, SIZE, fast_decode=fast)
            jout, jmeta = jpre.preprocess_image(path, SIZE, fast_decode=fast)
            assert np.abs(out.astype(int) - jout).max() <= 1
            assert meta["pad"] == jmeta["pad"] and tuple(meta["orig_hw"]) == tuple(jmeta["orig_hw"])
            np.testing.assert_array_equal(np.asarray(meta["scale"]), np.asarray(jmeta["scale"]))


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert g["num_real"] == w["num_real"]
        for gm, wm in zip(g["meta"], w["meta"]):
            assert gm["id"] == wm["id"] and gm["pad"] == tuple(wm["pad"])
            assert tuple(gm["orig_hw"]) == tuple(wm["orig_hw"])
            np.testing.assert_array_equal(np.asarray(gm["scale"]), np.asarray(wm["scale"]))
            np.testing.assert_array_equal(gm["gt_pixels"], wm["gt_pixels"])


@pytest.mark.parametrize("decode_size", [None, SIZE])
def test_i420_eval_batches_byte_equal_to_jax(root, decode_size, jax_native_jpeg):
    ds = DetectionDataset(root, "val", decode_size=decode_size)
    jds = jd.DetectionDataset(root, "val", decode_size=decode_size)
    want = list(jd.DetectionLoader(jds, SIZE, 3, max_boxes=5, train=False, emit="i420").epoch(0))
    assert want[0]["images"].shape == (3, SIZE * 3 // 2, SIZE)
    for kw in (dict(), dict(num_workers=2, worker_backend="process")):
        loader = DetectionLoader(ds, SIZE, 3, max_boxes=5, train=False, emit="i420", **kw)
        assert loader.native_jpeg
        try:
            got = list(loader.epoch(0))
        finally:
            loader.close()
        _same_batches(got, want)
        # the 4:1:1 JPEG and the BMP took the plain chain, counted
        assert loader.fallbacks == 2
        assert [m["i420_fallback"] for b in got for m in b["meta"]] == [False] * 5 + [True] * 2
    plain = DetectionLoader(ds, SIZE, 3, max_boxes=5, train=False, emit="i420", native_jpeg=False)
    jplain = jd.DetectionLoader(jds, SIZE, 3, max_boxes=5, train=False, emit="i420",
                                native_jpeg=False)
    assert not plain.native_jpeg
    if decode_size:  # each decoded long side is SIZE: the RGB letterbox only pads
        _same_batches(list(plain.epoch(0)), list(jplain.epoch(0)))


def test_train_i420_and_use_native(root):
    ds = DetectionDataset(root, "val")
    kw = dict(train=True, mosaic_prob=0.5, seed=3, max_boxes=5)
    rgb = list(DetectionLoader(ds, SIZE, 2, **kw).epoch(1))
    i420 = list(DetectionLoader(ds, SIZE, 2, emit="i420", **kw).epoch(1))
    for r, p in zip(rgb, i420):  # train batches: converted after mosaic
        np.testing.assert_array_equal(p["images"], rgb_batch_to_i420_packed(r["images"]))
        np.testing.assert_array_equal(p["labels"], r["labels"])
    jds = jd.DetectionDataset(root, "val")
    want = list(jd.DetectionLoader(jds, SIZE, 3, max_boxes=5, train=False, use_native=True).epoch(0))
    got = list(DetectionLoader(ds, SIZE, 3, max_boxes=5, train=False, use_native=True).epoch(0))
    _same_batches(got, want)
