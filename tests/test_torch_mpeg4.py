"""MPEG-4 Part 2 video without cv2 (fastvision_tpu_torch.data.mpeg4, the
AVI / MP4 / MOV readers in data.avi and data.mp4) against FFmpeg, on the
CPU.

The committed fixtures (tests/torch_video_fixtures, written by
tests/make_torch_video_fixtures.py: cv2's and the system FFmpeg 5.1's
encoders, XviD- and libavcodec-tagged, I/P/B-VOPs, packed B-frames, N-VOPs,
4MV, quarter-pel, MPEG quantisation with loaded matrices, dquant, AC
prediction, resync packets, data partitioning, interlacing, GMC, AVI / MP4
/ MOV) carry libavcodec 59's decode of every frame (SHA-256 of its Y, Cb, Cr
planes), cv2's frame count, fps and the frame each seek lands on.

Tolerances: every plane bit-equal to libavcodec's, and Y bit-equal to cv2
5.0's own ``VideoCapture`` (``CAP_PROP_CONVERT_RGB`` 0); RGB against
``VideoCapture`` within the bound the manifest records (0 levels on every
fixture cv2 gives an image for; cv2 5.0 gives none for interlaced MPEG-4,
its swscale refusing interlaced frames); frame counts, fps and seek
landings equal to cv2's; ``count_real_frames``, ``load_clip`` and
``VideoFolderDataset`` equal to the JAX package's; the port's own MP4
within 1 level of its encoder's reconstruction (a float IDCT there, the
integer one here).
"""
import hashlib
import json
import os
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest

from fastvision_tpu.data import video_dataset as jvideo
from fastvision_tpu.data import video_sampler as jsampler
from fastvision_tpu_torch.data import avi, mp4, mpeg4
from fastvision_tpu_torch.data import video_sampler as tsampler
from fastvision_tpu_torch.data.video_dataset import VideoFolderDataset

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_video_fixtures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["fixtures"]
WITH_CV2_FRAMES = [e for e in MANIFEST if e["landings"] is not None]
_ids = lambda e: e["file"]


def path_of(entry) -> str:
    return os.path.join(FIXTURES, entry["file"])


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("entry", MANIFEST, ids=_ids)
def test_fixture_planes_equal_ffmpeg(entry):
    """Every frame's Y, Cb and Cr planes bit-equal to libavcodec 59's, the
    stream's tools as the manifest lists them, and Y equal to cv2's live
    decode where cv2 gives one."""
    video = avi.open_video(path_of(entry))
    assert isinstance(video, mpeg4.Mpeg4Video)
    assert (video.width, video.height) == (entry["width"], entry["height"])
    n = video.walk_count()
    assert n == entry["frames"]
    planes = [video.planes(i) for i in range(n)]
    assert [[sha(f.y), sha(f.cb), sha(f.cr)] for f in planes] == entry["sha256"]
    assert video.stats == entry["stats"]
    video.release()
    cap = cv2.VideoCapture(path_of(entry), cv2.CAP_FFMPEG)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == entry["frame_count"]
    if entry["walk"] is None:  # cv2 gives no image for interlaced frames
        return
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    for f in planes:
        ok, y = cap.read()
        assert ok
        np.testing.assert_array_equal(y.reshape(-1)[:f.y.size].reshape(f.y.shape), f.y)
    assert not cap.read()[0]


@pytest.mark.parametrize("entry", WITH_CV2_FRAMES, ids=_ids)
def test_rgb_against_videocapture(entry):
    """The port's RGB frames against cv2's ``VideoCapture`` (BGR reversed)
    within the manifest's bound (0 levels: swscale's converter reproduced)."""
    bound = entry["rgb_vs_videocapture"]
    assert bound == {"max": 0, "mean": 0.0}
    cap = cv2.VideoCapture(path_of(entry), cv2.CAP_FFMPEG)
    for rgb in avi.open_video(path_of(entry)).frames():
        ok, bgr = cap.read()
        assert ok
        assert int(np.abs(rgb.astype(int) - bgr[..., ::-1].astype(int)).max()) <= bound["max"]


@pytest.mark.parametrize("entry", WITH_CV2_FRAMES, ids=_ids)
def test_counts_and_seek_landings_as_cv2(entry):
    """Frame count, fps, the read loop and every ``read_at`` landing as
    cv2's: from fresh readers, ascending, descending and in a seeded
    random order on one reader (onto B-frames, after N-VOPs, past the
    end)."""
    frames = list(avi.open_video(path_of(entry)).frames())
    assert len(frames) == len(entry["walk"])
    count = entry["frame_count"]
    for order in (range(count + 2), reversed(range(count + 2)),
                  np.random.default_rng(0).permutation(count + 2)):
        video = avi.open_video(path_of(entry))
        assert video.frame_count == count and video.fps == entry["fps"]
        for i in order:
            got, want = video.read_at(int(i)), entry["landings"][int(i)]
            if want is None:
                assert got is None, i
            else:
                np.testing.assert_array_equal(got, frames[want])
        video.release()
    for i in (0, count // 2, count + 1):  # a fresh reader per seek
        video = avi.open_video(path_of(entry))
        got = video.read_at(i)
        assert (got is None) == (entry["landings"][i] is None)
    assert tsampler.count_real_frames(path_of(entry)) == len(entry["walk"])


@pytest.mark.parametrize("name", ["xvid_cv2_320x240.avi", "libxvid_qpel_bframes_176x144.avi",
                                  "lavc_bframes_ctts.mp4", "nvop_cv2_96x64.avi"])
def test_sampler_and_dataset_as_jax(name, tmp_path):
    """count_real_frames, load_clip (every strategy, seeded) and
    VideoFolderDataset's clip length equal to the JAX package's (cv2)."""
    path = os.path.join(FIXTURES, name)
    assert tsampler.count_real_frames(path) == jsampler.count_real_frames(path)
    # verify_frames: draws over the real frames (the JAX package reverses the
    # channels of a frame it repeats past an over-counting header's end,
    # test_torch_avi pins that departure)
    for k, strategy in enumerate(("consecutive", "random", "average", "clip_random")):
        got = tsampler.load_clip(path, 8, strategy, rng=np.random.default_rng(k),
                                 verify_frames=True)
        want = jsampler.load_clip(path, 8, strategy, rng=np.random.default_rng(k),
                                  verify_frames=True)
        np.testing.assert_array_equal(got, want)
    got = tsampler.load_clip(path, 4, size=32, rng=np.random.default_rng(9))
    want = jsampler.load_clip(path, 4, size=32, rng=np.random.default_rng(9))
    assert got.shape == want.shape == (4, 32, 32, 3)
    os.makedirs(tmp_path / "val" / "a")
    os.symlink(path, tmp_path / "val" / "a" / name)
    ours = VideoFolderDataset(str(tmp_path), "val")
    assert ours.clip_length(0) == jvideo.VideoFolderDataset(str(tmp_path), "val").clip_length(0)
    clip, label = ours.load_clip(0, 4, "consecutive", 24, np.random.default_rng(3))
    assert clip.shape == (4, 24, 24, 3) and label == 0


def test_same_results_without_cv2(monkeypatch):
    """With cv2 unimportable the readers give the same frames and counts."""
    paths = [path_of(e) for e in MANIFEST]
    with_cv2 = [(tsampler.count_real_frames(p),
                 tsampler.load_clip(p, 6, "average", rng=np.random.default_rng(4))) for p in paths]
    monkeypatch.setitem(sys.modules, "cv2", None)
    for p, (count, clip) in zip(paths, with_cv2):
        assert tsampler.count_real_frames(p) == count
        np.testing.assert_array_equal(
            tsampler.load_clip(p, 6, "average", rng=np.random.default_rng(4)), clip)


def _crafted_vol(sprite: bool) -> bytes:
    """VOS / VO / VOL headers (verid 2) of a 64 x 48 stream; ``sprite``:
    GMC with 2 warping points, which no encoder here writes and the port
    does not decode (XviD's 3-point GMC it does)."""
    bits = []

    def put(v, n):
        bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    put(0x000001B0, 32), put(0xF5, 8), put(0x000001B5, 32), put(0, 1), put(1, 4), put(0, 1)
    put(0b01, 2)  # next_start_code() stuffing
    put(0x00000100, 32), put(0x00000120, 32)
    put(0, 1), put(17, 8), put(1, 1), put(2, 4), put(1, 3), put(1, 4)  # ASP, verid 2
    put(0, 1), put(0, 2), put(1, 1), put(25, 16), put(1, 1), put(0, 1)
    put(1, 1), put(64, 13), put(1, 1), put(48, 13), put(1, 1), put(0, 1), put(1, 1)
    put(2 if sprite else 0, 2)  # sprite_enable: GMC
    if sprite:
        put(2, 6), put(3, 2), put(0, 1)  # warping points, accuracy, brightness change
    put(0, 1), put(0, 1), put(0, 1), put(1, 1), put(1, 1), put(0, 1)  # ..., resync off
    put(0, 1), put(0, 1), put(0, 1)  # newpred, reduced resolution, scalability
    put(0, 1)
    while len(bits) % 8:
        put(1, 1)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def test_unsupported_streams_raise_item_11(tmp_path, monkeypatch):
    """Without cv2: an H.264 (avc1) MP4 from libx264, a DIV3 (MS-MPEG4)
    AVI and a Matroska file raise naming item 11 and the codec; a GMC VOL
    raises naming item 11 and the feature in the decoder, with cv2 or
    without; a fragmented MP4 and an edit list that cuts frames go to cv2
    while it imports and raise naming item 11 without it."""
    sys.path.insert(0, HERE)
    import make_torch_video_fixtures as maker

    avc = str(tmp_path / "avc.mp4")
    maker.write_lib(avc, "mp4", "libx264", None, 25, maker.scene(6, 64, 48, 1), {"g": "6"})
    div3 = str(tmp_path / "div3.avi")
    with open(path_of(MANIFEST[0]), "rb") as f:
        data = f.read()
    with open(div3, "wb") as f:
        f.write(data.replace(b"XVID", b"DIV3").replace(b"xvid", b"div3"))
    mkv = str(tmp_path / "clip.mkv")
    w = cv2.VideoWriter(mkv, cv2.VideoWriter_fourcc(*"XVID"), 25, (64, 48))
    for f in maker.scene(5, 64, 48, 2):
        w.write(f)
    w.release()
    assert avi.open_video(avc).frame_count == 6  # cv2 reads them while it is installed
    with pytest.raises(NotImplementedError, match=r"GMC.*item 11"):
        mpeg4.Mpeg4Decoder(_crafted_vol(sprite=True))
    assert mpeg4.Mpeg4Decoder(_crafted_vol(sprite=False)).size == (64, 48)
    fragmented = str(tmp_path / "frag.mp4")
    with open(path_of(next(e for e in MANIFEST if e["file"].endswith(".mp4"))), "rb") as f:
        mp4_data = f.read()
    with open(fragmented, "wb") as f:
        f.write(mp4_data + mp4.box(b"moof", mp4.full_box(b"mfhd", 0, 0, struct.pack(">I", 1))))
    assert avi.open_video(fragmented).reader == "cv2"
    with pytest.raises(NotImplementedError, match=r"fragmented.*item 11"):
        mp4.open_mp4(fragmented)
    ctts = path_of(next(e for e in MANIFEST if e["file"] == "lavc_bframes_ctts.mp4"))
    with open(ctts, "rb") as f:
        ctts_data = f.read()
    at = ctts_data.find(b"elst")
    cut = bytearray(ctts_data)
    struct.pack_into(">i", cut, at + 4 + 4 + 4 + 4, 10 ** 6)  # media_time past every frame
    cut_path = str(tmp_path / "cut.mp4")
    with open(cut_path, "wb") as f:
        f.write(bytes(cut))
    assert avi.open_video(cut_path).reader == "cv2"
    monkeypatch.setitem(sys.modules, "cv2", None)
    for path, what in ((fragmented, "fragmented"), (cut_path, "edit lists")):
        with pytest.raises(NotImplementedError, match=rf"{what}.*item 11"):
            avi.open_video(path)
    for path, codec in ((avc, "avc1"), (div3, "DIV3"), (mkv, r"\?|XVID")):
        with pytest.raises(NotImplementedError, match=rf"'({codec})' video .*item 11"):
            avi.open_video(path)


def test_mp4_reader_tables():
    """The B-frame MP4's tables as FFmpeg wrote them: one sync sample per
    I-VOP, composition times that put the frames in display order, an edit
    starting at the first frame shown; the MOV's QuickTime layout reads
    the same way."""
    entry = next(e for e in MANIFEST if e["file"] == "lavc_bframes_ctts.mp4")
    f = mp4.Mp4File(path_of(entry))
    assert f.codec == "mp4v" and f.object_type == 0x20 and f.frame_count == entry["frame_count"]
    starts = [k for k in range(f.frame_count) if mpeg4.vop_types(
        f._data[f.samples[k][0]:sum(f.samples[k])]).startswith("I")]
    assert f.sync == starts
    assert len(f.edits) == 1 and f.edits[0][0] == min(f.pts)
    assert sorted(f.pts) != f.pts  # B-VOPs: decode order is not display order
    video = mp4.open_mp4(path_of(entry))
    shown = [video._order[i] for i in range(video.walk_count())]
    assert [f.pts[t] for t in shown] == sorted(f.pts)
    mov = mp4.Mp4File(path_of(next(e for e in MANIFEST if e["file"].endswith(".mov"))))
    assert mov.codec == "mp4v" and mov.config.startswith(b"\x00\x00\x01\xb0")


def test_decoder_calls_and_packed_tags():
    """Mpeg4Decoder over an AVI's chunks: one frame at most per sample, the
    last at flush, tags naming the sample (plus 2**32 for a packed
    chunk's second VOP), reset for a seek, stats counting packed B-VOPs."""
    entry = next(e for e in MANIFEST if e["file"].startswith("libxvid"))
    f = avi.AviFile(path_of(entry))
    samples = [f._data[o:o + s] for o, s in f.chunks]
    dec = mpeg4.Mpeg4Decoder(f.extradata, f.codec)
    tags = []
    for k, s in enumerate(samples):
        out = dec.decode(s, k)
        assert len(out) <= 1
        tags += [x.tag for x in out]
    tags += [x.tag for x in dec.flush()]
    assert len(tags) == entry["frames"] and any(t >= 2 ** 32 for t in tags)
    assert dec.stats["packed_b_vops"] > 0 and dec.stats["xvid_idct"] == 1
    dec.reset()
    assert dec.flush() == []
    assert mpeg4.stream_config(samples[0]).startswith(b"\x00\x00\x01\xb0")


def test_port_mp4_read_back(tmp_path):
    """The port's own writer (`mp4.VideoWriter`, intra-only, fixed
    quantiser) read back by the port: the frame count, fps and each
    frame's planes within 1 level of `Mpeg4Encoder.reconstruct_planes`."""
    rng = np.random.default_rng(5)
    frames = [np.clip(rng.normal(128, 40, (48, 64, 3)), 0, 255).astype(np.uint8)
              for _ in range(5)]
    path = str(tmp_path / "out.mp4")
    with mp4.VideoWriter(path, 25, (64, 48)) as w:
        for fr in frames:
            w.write(fr)
    video = avi.open_video(path)
    assert video.frame_count == video.walk_count() == 5 and video.fps == 25
    enc = mpeg4.Mpeg4Encoder(64, 48, 25)
    for k, fr in enumerate(frames):
        got = video.planes(k)
        for a, b in zip(got[:3], enc.reconstruct_planes(enc.levels(fr))):
            assert a.shape == b.shape and int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1


def test_planes_to_rgb_matches_its_numpy_form():
    """`planes_to_rgb` is swscale's fixed point: held against a numpy
    transcription on random planes, odd sizes included."""
    rng = np.random.default_rng(6)
    for h, w in ((7, 9), (16, 16), (33, 18)):
        y = rng.integers(0, 256, (h, w), np.uint8)
        cb, cr = (rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), np.uint8) for _ in range(2))
        U = np.repeat(np.repeat(cb, 2, 0), 2, 1)[:h, :w].astype(np.int64) * 8 - 1024
        V = np.repeat(np.repeat(cr, 2, 0), 2, 1)[:h, :w].astype(np.int64) * 8 - 1024
        Y = ((y.astype(np.int64) * 8 - 128) * 9539) >> 16
        want = np.stack([Y + ((V * 13075) >> 16),
                         Y + ((U * -3209) >> 16) + ((V * -6660) >> 16),
                         Y + ((U * 16525) >> 16)], -1)
        np.testing.assert_array_equal(mpeg4.planes_to_rgb(y, cb, cr),
                                      np.clip(want, 0, 255).astype(np.uint8))


_MUTATE = r"""
import sys
import numpy as np
from fastvision_tpu_torch.data import avi, mpeg4

paths, n = sys.argv[1:-1], int(sys.argv[-1])
rng = np.random.default_rng(11)
outcomes = {"decoded": 0, "ValueError": 0, "NotImplementedError": 0}
for t in range(n):
    f = avi.AviFile(paths[t % len(paths)])
    samples = [bytearray(f._data[o:o + s]) for o, s in f.chunks if s]
    k = int(rng.integers(0, len(samples)))
    s = samples[k]
    if t % 3 == 0:
        del s[int(rng.integers(0, len(s))):]
    else:
        for _ in range(int(rng.integers(1, 8))):
            i = int(rng.integers(0, len(s)))
            s[i] ^= 1 << int(rng.integers(0, 8))
    try:
        dec = mpeg4.Mpeg4Decoder(f.extradata, f.codec)
        for j, x in enumerate(samples):
            dec.decode(bytes(x), j)
        dec.flush()
        outcomes["decoded"] += 1
    except (ValueError, NotImplementedError) as e:
        outcomes[type(e).__name__] += 1
print(outcomes)
"""


def test_corrupt_streams_raise_or_decode():
    """Truncated and bit-flipped samples (300 seeded mutations over the
    AVI fixtures) raise ValueError (or NotImplementedError where the flip
    names an unported tool) or decode; never crash. Run in a subprocess
    so that a crash fails this test alone."""
    paths = [path_of(e) for e in MANIFEST if e["file"].endswith(".avi")]
    root = os.path.dirname(HERE)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", _MUTATE, *paths, "300"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    outcomes = eval(run.stdout.strip().splitlines()[-1])
    assert sum(outcomes.values()) == 300 and outcomes["ValueError"] > 0
