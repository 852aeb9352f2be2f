"""The port's ``Detector.predict_video`` against the JAX package's, and
against its own ``predict_batch``, on the CPU.

The JAX package's detector (a YOLOv3 with one block per Darknet stage, 4
classes, 96 px, float32) runs ``predict_video`` over a Motion-JPEG AVI with
a ``frame_callback`` that records each frame (cv2's ``VideoCapture``
pixels) and its result; the port's detector, with the same weights through
the bridge, runs ``predict_batch`` on those very frames. Tolerances as
tests/test_torch_detector.py's (and its weights and noise inputs): the same
classes in the same order and the same count, boxes within 0.1 px, scores
within 1e-4 relative. The port's
``predict_video`` (frames read without cv2, `data.avi`) must be bit-equal,
frame by frame and in order, to ``predict_batch`` on the same frames in the
same batches, with ``max_frames``, a ragged last batch and an early stop;
with ``out_path`` it writes the annotated video without cv2 (`data.mp4`;
the writer's own tests are tests/test_torch_mp4_writer.py).
"""
import os
import sys
import threading

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvision_tpu.infer import Detector as JaxDetector
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu_torch.data import avi
from fastvision_tpu_torch.infer import Detector
from fastvision_tpu_torch.models import YOLOv3, yolov3_state_dict_from_jax
from fastvision_tpu_torch.testing import _scene, mjpeg_avi

torch.set_num_threads(2)
SIZE = 96
ANCHORS = np.asarray([[[60, 50], [70, 60], [80, 70]], [[40, 35], [50, 40], [55, 45]],
                      [[20, 18], [28, 24], [34, 30]]], np.float32)
FRAMES = 7


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


@pytest.fixture(scope="module")
def detectors():
    jm = JaxYOLOv3(num_classes=4,
                   backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
    variables = jax.device_get(jm.init(jax.random.key(3), jnp.zeros((1, SIZE, SIZE, 3))))
    variables = {c: variables[c] for c in ("params", "batch_stats")}
    tm = YOLOv3(num_classes=4, stage_sizes=(1, 1, 1, 1, 1))
    tm.load_state_dict(yolov3_state_dict_from_jax(variables))
    kw = dict(input_size=SIZE, batch_size=3, conf_thres=0.3)
    return (Detector(tm, ANCHORS, device="cpu", dtype=torch.float32, **kw),
            JaxDetector(jm, variables, ANCHORS, dtype=jnp.float32, **kw))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A cv2-written MJPEG AVI of FRAMES seeded noise frames at 72 x 96, 8
    fps (tests/test_torch_detector.py's inputs: noise spreads the random
    detector's scores)."""
    path = str(tmp_path_factory.mktemp("video") / "clip.avi")
    rng = np.random.default_rng(0)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 8, (96, 72))
    for _ in range(FRAMES):
        w.write(rng.integers(0, 256, (72, 96, 3), dtype=np.uint8))
    w.release()
    return path


def same_result(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in ("boxes", "scores", "classes"))


def test_predict_video_matches_jax_on_its_frames(detectors, clip):
    tdet, jdet = detectors
    seen = []
    n = jdet.predict_video(clip, frame_callback=lambda rgb, res: seen.append((rgb.copy(), res)))
    assert n == len(seen) == FRAMES
    got = tdet.predict_batch([rgb for rgb, _ in seen])
    total = 0
    for (_, want), res in zip(seen, got):
        np.testing.assert_array_equal(res["classes"], np.asarray(want["classes"]))
        np.testing.assert_allclose(res["boxes"], np.asarray(want["boxes"]), atol=0.1)
        np.testing.assert_allclose(res["scores"], np.asarray(want["scores"]), rtol=1e-4)
        total += len(res["boxes"])
    assert total > 0


@pytest.mark.parametrize("max_frames", [None, 5, 1])
def test_predict_video_equals_predict_batch(detectors, clip, max_frames, monkeypatch):
    """Without cv2: each frame's result bit-equal to predict_batch on the
    same frames in batches of 3 (7 frames: a ragged last batch), in order."""
    tdet, _ = detectors
    frames = list(avi.open_video(clip).frames())[:max_frames or FRAMES]
    want = [r for i in range(0, len(frames), 3) for r in tdet.predict_batch(frames[i:i + 3])]
    monkeypatch.setitem(sys.modules, "cv2", None)
    seen = []
    n = tdet.predict_video(clip, frame_callback=lambda rgb, res: seen.append((rgb, res)),
                           max_frames=max_frames)
    assert n == len(seen) == len(frames)
    for (rgb, res), frame, w in zip(seen, frames, want):
        np.testing.assert_array_equal(rgb, frame)
        assert same_result(res, w)


def test_predict_video_stops_early_and_releases_its_reader(detectors, clip):
    """A callback that raises stops the loop: the error reaches the caller
    and the reader thread ends."""
    tdet, _ = detectors
    before, calls = threading.active_count(), []

    def stop_after_four(rgb, res):
        calls.append(1)
        if len(calls) == 4:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        tdet.predict_video(clip, frame_callback=stop_after_four)
    assert len(calls) == 4 and threading.active_count() == before


def test_predict_video_writes_the_annotated_video(detectors, clip, tmp_path, monkeypatch):
    """Without cv2: every frame drawn and written by the port's MPEG-4
    encoder and muxer (`data.mp4`) at the source's fps; cv2, back, reads the
    file: the frame count, the fps and the frame size."""
    tdet, _ = detectors
    out = str(tmp_path / "annotated.mp4")
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        assert tdet.predict_video(clip, out) == FRAMES
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == FRAMES and cap.get(cv2.CAP_PROP_FPS) == 8
    assert cap.read()[1].shape == (72, 96, 3)
    cap.release()
    decoded = []
    real_decode = avi.MJPEGAvi.decode
    monkeypatch.setattr(avi.MJPEGAvi, "decode", lambda self, i: decoded.append(i) or real_decode(self, i))
    assert tdet.predict_video(clip, max_frames=2) == 2 and decoded == [0, 1]


def test_a_frame_that_does_not_decode_raises(detectors, tmp_path):
    """A corrupt frame raises ValueError naming the frame, after the frames
    before it were processed; it is never skipped or returned black."""
    tdet, _ = detectors
    jpegs = [cv2.imencode(".jpg", _scene(72, 96, t))[1].tobytes() for t in range(5)]
    jpegs[3] = jpegs[3][:len(jpegs[3]) // 2]
    path = str(tmp_path / "corrupt.avi")
    with open(path, "wb") as f:
        f.write(mjpeg_avi(jpegs, 96, 72, 10))
    seen = []
    with pytest.raises(ValueError, match="cannot decode frame 3"):
        tdet.predict_video(path, frame_callback=lambda rgb, res: seen.append(rgb))
    assert len(seen) == 3
