"""Motion-JPEG AVIs without cv2 (fastvision_tpu_torch.data.avi) against
``cv2.VideoCapture`` (cv2 5.0, FFmpeg backend) and the JAX package's
``video_sampler``, on the CPU.

Tolerances: frame counts and the frames each read lands on equal to cv2's
(frames are told apart by their content, each a different seeded scene);
``count_real_frames`` and ``load_clip``'s sampled frames equal to the JAX
package's. Pixels: each frame bit-equal to ``cv2.imdecode`` of its bytes
(tests/test_torch_codec.py holds the committed AVIs to that); against
``VideoCapture`` (FFmpeg's MJPEG decoder, swscale's chroma) within the
bound measured on the committed fixtures (ROADMAP Queue 3): at the source
size max 83, mean 3.24 levels; after the loaders' resize (the port's
`resize_bilinear`, the JAX package's ``cv2.resize``) max 79, mean 2.96.
Departures pinned here: the JAX package's ``load_clip`` converts a frame it
repeats past the real end from BGR to RGB again (its channels reversed at
every repeat), the port repeats it as read. A file whose first frame chunk
is empty (cv2 seeks to other frames than asked there) goes to cv2 whole
while cv2 imports; without it the port refuses to seek there (ValueError
naming item 11). The files the port's readers refuse (a fragmented MP4, an
edit list that cuts frames, the FourCCs UMP4 and XVIX, tests/
torch_video_fixtures/cv2) go to cv2 while it imports: their clips equal the
JAX package's.
"""
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest
import torch
from torch import nn

from fastvision_tpu.data import video_sampler as jsampler
from fastvision_tpu.data import video_dataset as jvideo
from fastvision_tpu_torch.data import avi
from fastvision_tpu_torch.data import video_sampler as tsampler
from fastvision_tpu_torch.data.dataset import resize_bilinear
from fastvision_tpu_torch.data.mpeg4 import Mpeg4Video
from fastvision_tpu_torch.data.video_dataset import VideoFolderDataset
from fastvision_tpu_torch.infer import VideoClassifier
from fastvision_tpu_torch.testing import _scene, mjpeg_avi

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_codec_fixtures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    AVIS = [e for e in json.load(_f)["files"] if "video" in e]
# the departure from VideoCapture's pixels, measured on the committed AVIs
SOURCE_MAX, SOURCE_MEAN = 83, 3.24
RESIZED_MAX, RESIZED_MEAN = 79, 2.96
H, W = 32, 48
SCENES = [_scene(H, W, 500 + t) for t in range(10)]
JPEGS = [cv2.imencode(".jpg", f[..., ::-1])[1].tobytes() for f in SCENES]


def which(frame: np.ndarray, scenes=SCENES) -> tuple[int, bool]:
    """(the scene an RGB frame shows, whether its channels are reversed)."""
    d = [(np.abs(frame.astype(int) - g.astype(int)).mean(), k, rev)
         for k, s in enumerate(scenes) for rev, g in ((False, s), (True, s[..., ::-1]))]
    _, k, rev = min(d)
    return k, rev


def capture_frames(path: str) -> list[np.ndarray]:
    cap, out = cv2.VideoCapture(path), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return out


def assert_clips_agree(path: str, scenes, seed: int = 0, **kw) -> None:
    """The port's and the JAX package's ``load_clip`` (each drawing from a
    Generator seeded with ``seed``) land on the same frames, or both raise;
    a frame the JAX package repeats past the end is channel-reversed at
    each repeat, the port's is the frame as read."""
    try:
        want = jsampler.load_clip(path, rng=np.random.default_rng(seed), **kw)
    except ValueError:
        with pytest.raises(ValueError):
            tsampler.load_clip(path, rng=np.random.default_rng(seed), **kw)
        return
    got = tsampler.load_clip(path, rng=np.random.default_rng(seed), **kw)
    assert got.shape == want.shape
    g, w = [which(f, scenes) for f in got], [which(f, scenes) for f in want]
    assert [k for k, _ in g] == [k for k, _ in w], (g, w)
    assert not any(rev for _, rev in g)
    for k in range(1, len(got)):  # the JAX package's repeats alternate their channels
        if w[k][1] != w[k - 1][1]:
            np.testing.assert_array_equal(got[k], got[k - 1])


@pytest.mark.parametrize("entry", AVIS, ids=[e["file"] for e in AVIS])
def test_committed_avis_count_and_sample_as_jax(entry):
    """The committed AVIs (cv2's MJPG writer, the same with a dropped frame,
    headers over- and under-counting): the header count, count_real_frames
    and every strategy's sampled frames as the JAX package's, with and
    without verify_frames."""
    path = os.path.join(FIXTURES, entry["file"])
    scenes = list(avi.open_video(path).frames())
    cap = cv2.VideoCapture(path)
    header = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    assert avi.open_video(path).frame_count == header == entry["video"]["frame_count"]
    assert tsampler.count_real_frames(path) == jsampler.count_real_frames(path) == \
        entry["video"]["real_frames"]
    for strategy in ("consecutive", "random", "average", "clip_random"):
        for seed in range(3):
            for verify in (False, True):
                for num in (3, 8):
                    assert_clips_agree(path, scenes, seed, num_frames=num, strategy=strategy,
                                       verify_frames=verify)
    assert_clips_agree(path, scenes, num_frames=12, indices=np.arange(12))


@pytest.mark.parametrize("entry", AVIS, ids=[e["file"] for e in AVIS])
def test_departure_from_videocapture_bounded(entry):
    """VideoCapture's pixels against the port's (libjpeg's) on the same
    frames, at the source size and after the loaders' resize (16, 112,
    224): within the measured bound."""
    path = os.path.join(FIXTURES, entry["file"])
    caps, ours = capture_frames(path), list(avi.open_video(path).frames())
    assert len(caps) == len(ours) == entry["video"]["read_loop_frames"]
    d = np.stack([np.abs(a.astype(int) - b.astype(int)) for a, b in zip(ours, caps)])
    assert d.max() <= SOURCE_MAX and d.mean() <= SOURCE_MEAN and d.max() > 0
    for s in (16, 112, 224):
        r = np.stack([np.abs(resize_bilinear(a, s, s).astype(int) - cv2.resize(b, (s, s)).astype(int))
                      for a, b in zip(ours, caps)])
        assert r.max() <= RESIZED_MAX and r.mean() <= RESIZED_MEAN, s


def _crafted(rng, t):
    n = int(rng.integers(1, 10))
    frames = list(JPEGS[:n])
    for _ in range(int(rng.integers(0, 3))):
        frames.insert(int(rng.integers(1, len(frames) + 1)), b"")
    header = [None, int(rng.integers(0, 14)), int(rng.integers(0, 3))][t % 3]
    kw = dict(header_frames=header, index=bool(t % 3), junk=t % 5 == 0, rec_lists=t % 7 == 0)
    return mjpeg_avi(frames, W, H, 10, **kw), (n, kw)


def test_crafted_avis_read_as_cv2(tmp_path):
    """Seeded files: 1-9 frames, zero-length chunks after the first, header
    counts from 0 to 13 (0 and 1: cv2 does not seek), idx1 or a walk of
    movi, JUNK and LIST rec: the header count, what the frame reads land on,
    count_real_frames and load_clip as cv2 and the JAX package."""
    rng = np.random.default_rng(0)
    for t in range(30):
        data, what = _crafted(rng, t)
        path = str(tmp_path / f"c{t}.avi")
        with open(path, "wb") as f:
            f.write(data)
        cap = cv2.VideoCapture(path)
        assert avi.open_video(path).frame_count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), what
        cap.release()
        assert [which(f)[0] for f in avi.open_video(path).frames()] == \
            [which(f)[0] for f in capture_frames(path)], what
        assert tsampler.count_real_frames(path) == jsampler.count_real_frames(path), what
        for verify in (False, True):
            assert_clips_agree(path, SCENES, num_frames=5, indices=np.arange(0, 14, 2),
                               verify_frames=verify)
            assert_clips_agree(path, SCENES, t, num_frames=4, strategy="random",
                               verify_frames=verify)


def test_first_chunk_empty_refuses_to_seek(tmp_path, monkeypatch):
    """cv2 numbers the frames from 1 when the first frame chunk is empty and
    lands elsewhere than asked (a fresh capture's seek to 0 reads frame 1).
    While cv2 imports, the file goes to it whole: the counts and clips are
    the JAX package's. Without cv2 the port raises naming item 11 rather
    than guess, and reads the file from the start as cv2 does."""
    path = str(tmp_path / "first_empty.avi")
    with open(path, "wb") as f:
        f.write(mjpeg_avi([b""] + JPEGS[:5], W, H, 10))
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
    assert which(cv2.cvtColor(cap.read()[1], cv2.COLOR_BGR2RGB))[0] == 1
    cap.release()
    assert avi.open_video(path).reader == "cv2"
    assert tsampler.count_real_frames(path) == jsampler.count_real_frames(path)
    np.testing.assert_array_equal(
        tsampler.load_clip(path, 2, "average", rng=np.random.default_rng(2)),
        jsampler.load_clip(path, 2, "average", rng=np.random.default_rng(2)))
    frames = [which(f)[0] for f in capture_frames(path)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert avi.open_video(path).reader == "port"
    for call in (lambda: avi.open_video(path).read_at(0), lambda: tsampler.count_real_frames(path),
                 lambda: tsampler.load_clip(path, 2)):
        with pytest.raises(ValueError, match="first frame chunk is empty.*item 11"):
            call()
    assert [which(f)[0] for f in avi.open_video(path).frames()] == frames == [0, 1, 2, 3, 4]


def test_opendml_avix_parts_read_as_cv2(tmp_path):
    """An OpenDML file continues in RIFF AVIX parts (their movi lists
    walked after the first part's idx1): the count, the read loop and every
    seek as cv2's."""
    def chunk(fcc, body):
        return fcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    for header in (4, 7, 10):
        movi = b"movi" + b"".join(chunk(b"00dc", j) for j in JPEGS[4:10])
        avix = b"RIFF" + struct.pack("<I", 4 + 8 + len(movi)) + b"AVIX" + chunk(b"LIST", movi)
        path = str(tmp_path / f"avix{header}.avi")
        with open(path, "wb") as f:
            f.write(mjpeg_avi(JPEGS[:4], W, H, 10, header_frames=header) + avix)
        assert [which(f)[0] for f in avi.open_video(path).frames()] == list(range(10)) == \
            [which(f)[0] for f in capture_frames(path)]
        for i in range(12):
            cap = cv2.VideoCapture(path)
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            ok, f = cap.read()
            cap.release()
            got = avi.open_video(path).read_at(i)
            assert (got is None) == (not ok), (header, i)
            if ok:
                assert which(got)[0] == which(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))[0], (header, i)
        assert tsampler.count_real_frames(path) == jsampler.count_real_frames(path)


def test_writer_checked_against_cv2(tmp_path):
    """`testing.mjpeg_avi` on its own output: cv2 reads its count, fps and
    frames (JPEGs with and without DHT), and the reader gives imdecode's."""
    from fastvision_tpu_torch.testing import encode_progressive_jpeg, standard_jpeg_tables

    dqt, dht = standard_jpeg_tables(90)
    frames = [encode_progressive_jpeg(s, dqt, dht, progressive=False, tables=bool(k % 2))
              for k, s in enumerate(SCENES[:5])]
    for fps in (25.0, 29.97, 12.5):
        path = str(tmp_path / "w.avi")
        with open(path, "wb") as f:
            f.write(mjpeg_avi(frames, W, H, fps))
        cap = cv2.VideoCapture(path)
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
        assert abs(cap.get(cv2.CAP_PROP_FPS) - fps) < 1e-9 and avi.open_video(path).fps == fps
        cap.release()
        assert [which(f)[0] for f in capture_frames(path)] == list(range(5))
        for k, f in enumerate(avi.open_video(path).frames()):
            np.testing.assert_array_equal(
                f, cv2.imdecode(np.frombuffer(frames[k], np.uint8), cv2.IMREAD_COLOR)[..., ::-1])


def test_other_codecs_through_cv2_or_raise(tmp_path, monkeypatch):
    """An mp4v .mp4 and an XVID .avi (cv2's writer: MPEG-4 Part 2) are read
    by the port, cv2 or not: the same count and frames as the JAX
    package's (cv2), and the same frames again with cv2 unimportable. An
    H.264 .mp4 (libx264) and a .mkv go to cv2 while it is installed and
    without it raise naming item 11 and their codec; a missing file raises
    FileNotFoundError."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import make_torch_video_fixtures as maker

    paths, clips = {}, {}
    for name, fourcc in (("clip.mp4", "mp4v"), ("xvid.avi", "XVID"), ("clip.mkv", "XVID")):
        paths[name] = str(tmp_path / name)
        w = cv2.VideoWriter(paths[name], cv2.VideoWriter_fourcc(*fourcc), 10, (W, H))
        for s in SCENES[:6]:
            w.write(np.ascontiguousarray(s[..., ::-1]))
        w.release()
    paths["avc.mp4"] = str(tmp_path / "avc.mp4")
    maker.write_lib(paths["avc.mp4"], "mp4", "libx264", None, 10,
                    [np.ascontiguousarray(s[..., ::-1]) for s in SCENES[:6]], {"g": "6"})
    for name in paths:
        video = avi.open_video(paths[name])
        assert isinstance(video, Mpeg4Video) == (name in ("clip.mp4", "xvid.avi"))
        assert video.reader == ("port" if name in ("clip.mp4", "xvid.avi") else "cv2")
        assert video.frame_count == 6
        assert tsampler.count_real_frames(paths[name]) == jsampler.count_real_frames(paths[name])
        clips[name] = tsampler.load_clip(paths[name], 4, "average", rng=np.random.default_rng(1))
        want = jsampler.load_clip(paths[name], 4, "average", rng=np.random.default_rng(1))
        np.testing.assert_array_equal(clips[name], want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name in ("clip.mp4", "xvid.avi"):
        assert tsampler.count_real_frames(paths[name]) == 6
        np.testing.assert_array_equal(
            tsampler.load_clip(paths[name], 4, "average", rng=np.random.default_rng(1)),
            clips[name])
    with pytest.raises(NotImplementedError, match=r"'avc1' video .*item 11"):
        tsampler.load_clip(paths["avc.mp4"], 4)
    with pytest.raises(NotImplementedError, match=r"'\?' video .*item 11"):
        tsampler.count_real_frames(paths["clip.mkv"])
    with pytest.raises(FileNotFoundError):
        avi.open_video(str(tmp_path / "missing.avi"))


CV2_VIDEOS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_video_fixtures",
                          "cv2")
with open(os.path.join(CV2_VIDEOS, "manifest.json")) as _f:
    REFUSED = [e for e in json.load(_f)["videos"] if e["file"].startswith("refused_")]


@pytest.mark.parametrize("entry", REFUSED, ids=[e["file"] for e in REFUSED])
def test_refused_files_read_through_cv2(entry, monkeypatch):
    """A file the port's readers refuse goes to cv2 whole while it imports:
    ``reader`` is "cv2", the frames are the manifest's (cv2's read loop),
    and the count and clips equal the JAX package's (but for its channel
    swap of a frame it repeats, the departure pinned above). Without cv2 it raises
    as before: NotImplementedError naming item 11 where the headers show
    the refusal, ValueError at the first seek in an AVI whose first chunk is
    empty."""
    import hashlib

    path = os.path.join(CV2_VIDEOS, entry["file"])
    video = avi.open_video(path)
    assert video.reader == "cv2" and video.frame_count == entry["frame_count"]
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in video.frames()] == entry["rgb_sha256"]
    assert tsampler.count_real_frames(path) == jsampler.count_real_frames(path)
    for strategy, seed in (("average", 0), ("random", 3)):
        got = tsampler.load_clip(path, 8, strategy, rng=np.random.default_rng(seed))
        want = jsampler.load_clip(path, 8, strategy, rng=np.random.default_rng(seed))
        for t in range(len(want)):  # a frame cv2's seek does not read repeats the last one
            assert np.array_equal(got[t], want[t]) or (  # (the JAX package's channels reversed)
                t > 0 and np.array_equal(got[t], got[t - 1])
                and np.array_equal(want[t], want[t - 1][..., ::-1])), (strategy, t)
    monkeypatch.setitem(sys.modules, "cv2", None)
    if "first_chunk_empty" in entry["file"]:
        with pytest.raises(ValueError, match="first frame chunk is empty.*item 11"):
            tsampler.load_clip(path, 8)
    else:
        with pytest.raises(NotImplementedError, match="item 11"):
            avi.open_video(path)


def test_mpeg4_tool_met_mid_file_switches_to_cv2(monkeypatch):
    """A tool the MPEG-4 decoder does not port that only the picture data
    shows (the fixture writers' encoders make none: DivX interlaced half-pel
    chroma is interlaced, which cv2 5.0 returns no image for, and libxvid
    writes no out-of-range GMC or GMC packets with a header extension) is stood in for
    by a decoder that refuses from the 9th sample on: the reader goes on
    through cv2 from that read, with the port's frames bit for bit and
    ``reader`` "cv2"; without cv2 that read raises NotImplementedError."""
    from fastvision_tpu_torch.data import mpeg4

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_video_fixtures",
                        "xvid_cv2_320x240.avi")
    whole = list(avi.open_video(path).frames())
    real = mpeg4.Mpeg4Decoder.decode

    def refusing(self, vop, tag=0, parse_only=False):
        if tag >= 8 and not parse_only:
            raise NotImplementedError("decoding a stand-in tool is not ported (item 11)")
        return real(self, vop, tag, parse_only)

    monkeypatch.setattr(mpeg4.Mpeg4Decoder, "decode", refusing)
    video = avi.open_video(path)
    assert video.reader == "port"
    frames = list(video.frames())
    assert video.reader == "cv2" and len(frames) == len(whole)
    assert all(np.array_equal(a, b) for a, b in zip(frames, whole))
    np.testing.assert_array_equal(avi.open_video(path).read_at(len(whole) - 3), whole[-3])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(NotImplementedError, match="item 11"):
        list(avi.open_video(path).frames())


class _TinyVideoNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(3, 4)
        torch.manual_seed(0)
        nn.init.normal_(self.fc.weight)

    def forward(self, x):  # NDHWC
        return self.fc(x.mean((1, 2, 3)))


def test_video_classifier_and_dataset_without_cv2(tmp_path, monkeypatch):
    """VideoClassifier.predict_video and VideoFolderDataset read the MJPEG
    AVI without cv2, with the results they give with it; the dataset's clip
    length is the JAX package's."""
    root = tmp_path / "ds"
    os.makedirs(root / "val" / "a")
    path = str(root / "val" / "a" / "clip.avi")
    with open(path, "wb") as f:
        f.write(mjpeg_avi(JPEGS[:7], W, H, 10, header_frames=9))
    clf = VideoClassifier(_TinyVideoNet(), num_frames=4, size=16, strategy="average",
                          device="cpu", dtype=torch.float32)
    with_cv2 = clf.predict_video(path, rng=np.random.default_rng(2))
    ds = VideoFolderDataset(str(root), "val")
    clip, label = ds.load_clip(0, 4, "consecutive", 16, np.random.default_rng(3))
    assert ds.clip_length(0) == jvideo.VideoFolderDataset(str(root), "val").clip_length(0) == 9
    monkeypatch.setitem(sys.modules, "cv2", None)
    without = clf.predict_video(path, rng=np.random.default_rng(2))
    np.testing.assert_array_equal(without["probs"], with_cv2["probs"])
    np.testing.assert_array_equal(ds.load_clip(0, 4, "consecutive", 16, np.random.default_rng(3))[0],
                                  clip)
    assert ds.clip_length(0) == 9 and label == 0
