"""The port's video data path on the CPU against the JAX package's:
``normalize_images`` on NDHWC clips, the frame samplers, ``load_clip`` over
video files, ``VideoFolderDataset`` and ``VideoClipLoader``; and the
loader's serial = thread = process epochs, its ``epoch(start_batch=)``,
its corrupt-clip policy, and the missing-cv2 error.

Tolerances: frame indices, class lists, sample lists, labels, ``num_real``
and epoch order equal; pixels within +-1 of the JAX package's (the port
resizes with torch's bilinear interpolation, the JAX package with cv2's
fixed-point one); normalized clips to float32 rounding. Pooled epochs are
BYTE-equal to the serial one: every clip's draws are seeded by (seed,
epoch, position).

The port reads a Motion-JPEG AVI without cv2 (`data.avi`) and decodes each
frame as ``cv2.imdecode`` does (libjpeg-turbo), where the JAX package's
``cv2.VideoCapture`` decodes with FFmpeg and converts with swscale (ROADMAP
Queue 3 gives that departure's bound, which tests/test_torch_avi.py
asserts). So the JAX side here reads through `ImdecodeCapture`: cv2's own
``VideoCapture`` for the counts, seeks and reads, each frame's pixels
``cv2.imdecode``'s of the bytes it read.
"""
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.data as jd
from fastvision_tpu.data import video_sampler as jsampler
from fastvision_tpu_torch.data import VideoClipLoader, VideoFolderDataset, normalize_images
from fastvision_tpu_torch.data import avi
from fastvision_tpu_torch.data import video_sampler as tsampler
from fastvision_tpu_torch.testing import write_video_dataset
from test_torch_cls_data import _assert_same, _collect, _multithreaded_torch_op

torch.set_num_threads(2)
T, S = 4, 16
_CAPTURE = cv2.VideoCapture


class ImdecodeCapture:
    """``cv2.VideoCapture`` with libjpeg's pixels: the frame it reads,
    decoded by ``cv2.imdecode`` from the file's bytes for that frame."""

    def __init__(self, path, *args):
        self._cap, self._avi = _CAPTURE(path, *args), avi.MJPEGAvi(path)

    def read(self):
        ok, frame = self._cap.read()
        if ok:
            i = int(self._cap.get(cv2.CAP_PROP_POS_FRAMES)) - 1
            frame = cv2.imdecode(np.frombuffer(self._avi.frame_bytes(i), np.uint8), cv2.IMREAD_COLOR)
        return ok, frame

    def __getattr__(self, name):
        return getattr(self._cap, name)


@pytest.fixture
def imdecode_capture(monkeypatch):
    monkeypatch.setattr(cv2, "VideoCapture", ImdecodeCapture)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Frame-directory clips (.bmp) of 3 classes, plus one video file."""
    root = str(tmp_path_factory.mktemp("video"))
    write_video_dataset(root, (10, 7), num_classes=3, frames=9, hw=(24, 30), seed=1)
    rng = np.random.default_rng(2)
    w = cv2.VideoWriter(os.path.join(root, "train", "class_001", "zz_clip.avi"),
                        cv2.VideoWriter_fourcc(*"MJPG"), 10, (40, 32))
    for _ in range(12):
        w.write(rng.integers(0, 255, (32, 40, 3), np.uint8))
    w.release()
    return root


def test_normalize_images_takes_clips_as_jax_does():
    clips = np.random.default_rng(0).integers(0, 256, (2, 3, 5, 6, 3), np.uint8)
    for imagenet in (False, True):
        want = np.asarray(jd.normalize_images(jnp.asarray(clips), jnp.float32, imagenet=imagenet))
        got = normalize_images(torch.from_numpy(clips), torch.float32, imagenet=imagenet).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for bad in ((4, 5, 3), (2, 3, 5, 6, 4), (1, 2, 3, 4, 5, 3)):
        with pytest.raises(ValueError, match="NDHWC"):
            normalize_images(torch.zeros(bad, dtype=torch.uint8))


@pytest.mark.parametrize("strategy", ["consecutive", "random", "average", "clip_random"])
def test_sample_indices_draw_for_draw(strategy):
    for seed in range(6):
        for total in (0, 1, 3, 7, 16, 17, 50, 301):
            for num in (1, 4, 16):
                a = jsampler.sample_indices(total, num, strategy, np.random.default_rng(seed))
                b = tsampler.sample_indices(total, num, strategy, np.random.default_rng(seed))
                np.testing.assert_array_equal(a, b)
                assert b.dtype == np.int64 and b.shape == (num,)
    frames = np.arange(20)[:, None, None, None] * np.ones((1, 2, 2, 3), np.uint8)
    np.testing.assert_array_equal(
        tsampler.sample_clip_from_array(frames, 5, strategy, np.random.default_rng(1)),
        jsampler.sample_clip_from_array(frames, 5, strategy, np.random.default_rng(1)))
    with pytest.raises(ValueError, match="unknown strategy"):
        tsampler.sample_indices(5, 2, "nearest")


def test_load_clip_from_a_video_file(root, imdecode_capture):
    path = os.path.join(root, "train", "class_001", "zz_clip.avi")
    for kw in (dict(strategy="average"), dict(indices=np.array([0, 5, 11, 30]))):
        want = jsampler.load_clip(path, T, size=S, rng=np.random.default_rng(3), **kw)
        got = tsampler.load_clip(path, T, size=S, rng=np.random.default_rng(3), **kw)
        assert got.shape == want.shape == (T, S, S, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert tsampler.count_real_frames(path) == jsampler.count_real_frames(path) == 12


def test_video_files_without_cv2_raise_naming_item_11(root, tmp_path, monkeypatch):
    """Without cv2 the Motion-JPEG AVI reads as it reads with cv2, and so
    does an XVID (MPEG-4 Part 2) AVI; a video of a codec the port does not
    decode (MS-MPEG4, FourCC DIV3) raises naming item 11 and its FourCC,
    and a loader never skips it as corrupt."""
    ds = VideoFolderDataset(root, "train")
    vid = next(i for i, (p, _) in enumerate(ds.samples) if p.endswith(".avi"))
    with_cv2 = (ds.load_clip(vid, T, "average", S, np.random.default_rng(0)), ds.clip_length(vid),
                tsampler.count_real_frames(ds.samples[vid][0]))
    xvid = str(tmp_path / "xvid.avi")
    w = cv2.VideoWriter(xvid, cv2.VideoWriter_fourcc(*"XVID"), 10, (40, 32))
    for _ in range(3):
        w.write(np.zeros((32, 40, 3), np.uint8))
    w.release()
    xvid_clip = tsampler.load_clip(xvid, T)
    div3 = str(tmp_path / "div3.avi")
    with open(xvid, "rb") as f, open(div3, "wb") as g:
        g.write(f.read().replace(b"XVID", b"DIV3").replace(b"FMP4", b"DIV3"))
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    clip, length, real = (ds.load_clip(vid, T, "average", S, np.random.default_rng(0)),
                          ds.clip_length(vid), tsampler.count_real_frames(ds.samples[vid][0]))
    np.testing.assert_array_equal(clip[0], with_cv2[0][0])
    assert (length, real) == with_cv2[1:] == (12, 12)
    np.testing.assert_array_equal(tsampler.load_clip(xvid, T), xvid_clip)
    assert tsampler.count_real_frames(xvid) == 3
    for call in (lambda: tsampler.load_clip(div3, T), lambda: tsampler.count_real_frames(div3)):
        with pytest.raises(NotImplementedError, match=r"'DIV3' video .*item 11"):
            call()
    clip, _ = ds.load_clip(0, T, "average", S, np.random.default_rng(0))  # BMP frames: numpy
    assert clip.shape == (T, S, S, 3)
    os.makedirs(tmp_path / "train" / "class_000")
    os.replace(div3, tmp_path / "train" / "class_000" / "div3.avi")
    loader = VideoClipLoader(VideoFolderDataset(str(tmp_path), "train"), T, S, batch_size=1,
                             train=False, on_corrupt="skip")
    with pytest.raises(NotImplementedError, match="item 11"):  # never skipped as corrupt
        next(iter(loader))


def test_video_folder_dataset_matches_jax(root, imdecode_capture):
    for split in ("train", "val"):
        port, jax_ds = VideoFolderDataset(root, split), jd.VideoFolderDataset(root, split)
        assert port.classes == jax_ds.classes == [f"class_{c:03d}" for c in range(3)]
        assert port.samples == jax_ds.samples
        assert [port.clip_length(i) for i in range(len(port))] == \
            [jax_ds.clip_length(i) for i in range(len(jax_ds))]
    port, jax_ds = VideoFolderDataset(root, "train"), jd.VideoFolderDataset(root, "train")
    for i in (0, 3, len(port) - 1):  # frame directories and the video file
        for kw in ({}, {"indices": np.array([8, 2, 40, 0])}):
            got, lab = port.load_clip(i, T, "random", S, np.random.default_rng(i), **kw)
            want, jlab = jax_ds.load_clip(i, T, "random", S, np.random.default_rng(i), **kw)
            assert lab == jlab and got.shape == want.shape == (T, S, S, 3)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    cats = ["class_002", "class_000", "class_001"]
    assert VideoFolderDataset(root, "val", cats).samples == \
        jd.VideoFolderDataset(root, "val", cats).samples
    with pytest.raises(ValueError, match="not in categories"):
        VideoFolderDataset(root, "val", ["class_000"])


@pytest.mark.parametrize("train", [True, False])
def test_video_clip_loader_matches_jax(root, train, imdecode_capture):
    kw = dict(num_frames=T, size=S, batch_size=4, train=train, seed=5, strategy="clip_random")
    port = VideoClipLoader(VideoFolderDataset(root, "train"), **kw)
    jax_loader = jd.VideoClipLoader(jd.VideoFolderDataset(root, "train"), **kw)
    assert len(port) == len(jax_loader) == (2 if train else 3)  # 11 clips
    for epoch in (0, 1):
        got, want = _collect(port, epoch), list(jax_loader.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["num_real"] == w["num_real"]
            np.testing.assert_array_equal(g["labels"], w["labels"])
            assert g["images"].dtype == np.uint8 and g["images"].shape == w["images"].shape
            assert np.abs(g["images"].astype(int) - w["images"].astype(int)).max() <= 1
    if not train:
        assert got[-1]["num_real"] == 3  # 11 = 2 x 4 + 3: padded with the last clip
        np.testing.assert_array_equal(got[-1]["images"][3], got[-1]["images"][2])
        assert got[-1]["labels"][3] == got[-1]["labels"][2]


@pytest.mark.parametrize("train", [True, False])
def test_video_backends_byte_equal_and_start_batch(root, train):
    ds = VideoFolderDataset(root, "train")
    kw = dict(num_frames=T, size=S, batch_size=3, train=train, seed=2)
    serial = [_collect(VideoClipLoader(ds, **kw), e) for e in (0, 1)]
    _multithreaded_torch_op()
    for backend in ("thread", "process"):
        loader = VideoClipLoader(ds, num_workers=3, worker_backend=backend, **kw)
        try:
            for e in (0, 1):  # the pool is reused across epochs
                _assert_same(_collect(loader, e), serial[e])
            _assert_same(_collect(loader, 1, start_batch=2), serial[1][2:])
            assert loader._decode_pool is None or loader._decode_pool.slot_shape == (T, S, S, 3)
        finally:
            loader.close()
    if train:  # another epoch, another shuffle and other frames
        assert any(not np.array_equal(a["images"], b["images"])
                   for a, b in zip(serial[0], serial[1]))


def test_corrupt_frame_raises_then_skips(tmp_path):
    write_video_dataset(str(tmp_path), 3, num_classes=1, frames=4, hw=(8, 8), seed=3,
                        splits=("train",))
    bad = tmp_path / "train" / "class_000" / "train_000001" / "f0002.bmp"
    bad.write_bytes(b"not a bitmap")
    ds = VideoFolderDataset(str(tmp_path), "train")
    with pytest.raises(ValueError, match="cannot decode frame"):
        ds.load_clip(1, 4, "consecutive", 8, np.random.default_rng(0))
    strict = VideoClipLoader(ds, 4, 8, batch_size=3, train=False)
    with pytest.raises(ValueError, match="cannot decode frame"):
        list(strict.epoch(0))
    lax = VideoClipLoader(ds, 4, 8, batch_size=3, train=False, on_corrupt="skip")
    with pytest.warns(UserWarning, match="corrupt"):
        batches = list(lax.epoch(0))
    assert batches[0]["images"].shape == (3, 4, 8, 8, 3)
    np.testing.assert_array_equal(batches[0]["images"][1], batches[0]["images"][2])  # clip 2
    empty = tmp_path / "train" / "class_000" / "train_000009"
    os.makedirs(empty)
    with pytest.raises(ValueError, match="no images"):
        VideoFolderDataset(str(tmp_path), "train").load_clip(3, 4, "average", 8,
                                                             np.random.default_rng(0))
    # host sharding is ported: a malformed spec is refused
    with pytest.raises(ValueError, match="host_shard"):
        VideoClipLoader(ds, host_shard="2/2")
    assert len(VideoClipLoader(ds, batch_size=1, host_shard="0/2")) == len(ds) // 2
