"""The port's annotated-video writer on the CPU: `data.mpeg4` (an MPEG-4
Part 2 Simple Profile intra encoder, its bit packing in
``csrc/mpeg4_encode.cpp``) and `data.mp4` (the ``.mp4`` muxer), as
`Detector.predict_video(out_path=)` and ``infer --source <video>`` use them.

Without cv2 (most of the file):

  - the boxes, parsed back by a small ISO BMFF reader written here: ``ftyp``,
    one ``mdat`` whose payload is the ``stsz`` sizes' sum from the ``stco``
    offset, ``mvhd`` / ``tkhd`` / ``mdhd`` durations, ``stts`` = one entry
    of every frame at the rate's denominator over a timescale of its
    numerator (25, 8, 5 and 30000/1001 fps), ``stss`` = every frame,
    ``stsc`` one chunk, the ``mp4v`` entry's size and its ``esds`` carrying
    the encoder's headers;
  - the VOS / VO / VOL headers byte-equal to what FFmpeg's mpeg4 encoder
    (cv2's ``mp4v`` writer) writes for 64 x 48 at 25 fps, up to its user
    data and ``random_accessible_vol`` (1 here: every VOP is intra);
  - the library's levels (colour conversion, DCT, quantisation) against a
    numpy version of the same steps (a level on a rounding boundary may
    differ by 1, in at most 1e-3 of them);
  - each I-VOP parsed back by a bit reader written here (the MCBPC and
    CBPY codes, escape type 3 codes with their markers, the stuffing): the
    library's levels in zigzag order with the DC prediction computed here;
  - the encoder's reconstruction (a float IDCT of its levels, chroma
    repeated 2 x 2) within max 6 / mean 1.5 levels of smooth frames, at 96
    x 72, 64 x 48 and 100 x 60 (not a multiple of 16);
  - the same frames give the same bytes; a frame of the wrong shape and a
    frame size outside the VOL's 13 bits raise;
  - ``predict_video(out_path=)`` with ``sys.modules["cv2"] = None``: the
    file's samples are the encoder's bytes of the drawn frames.

With cv2 (its FFmpeg decoder; those tests skip where cv2 is absent):

  - ``cv2.VideoCapture`` reads back the exact frame count and fps (25, 8,
    5.0, 30000/1001) and every frame, within mean 1.5 and max 8 levels of
    the smooth input (the decoder's integer YUV -> RGB adds up to ~1.5
    levels of bias to the reconstruction's error);
  - on a detector's drawn frames (a shallow YOLOv3 on a Motion-JPEG clip
    of seeded scenes, its 5 best boxes a frame), mean |d| at most 3 levels
    of the drawn frames, and
    at most 1 level worse than cv2's own ``mp4v`` writer on the same
    frames (both printed).
"""
import os
import struct
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from fastvision_tpu_torch.data import mpeg4
from fastvision_tpu_torch.data.mp4 import VideoWriter
from fastvision_tpu_torch.data.mpeg4 import (DCT, Mpeg4Encoder, dc_scalers, frame_rate,
                                             rgb_to_yuv420)
from fastvision_tpu_torch.infer import Detector
from fastvision_tpu_torch.models import YOLOv3
from fastvision_tpu_torch.testing import (_scene, encode_baseline_jpeg, mjpeg_avi,
                                          standard_jpeg_tables)
from fastvision_tpu_torch.viz import draw_detections

torch.set_num_threads(2)
CASES = [(25, (96, 72)), (8, (64, 48)), (5.0, (100, 60)), (30000 / 1001, (96, 72))]
ANCHORS = np.asarray([[[60, 50], [70, 60], [80, 70]], [[40, 35], [50, 40], [55, 45]],
                      [[20, 18], [28, 24], [34, 30]]], np.float32)
# FFmpeg's VOS / VO / VOL for 64 x 48 at 25 fps (cv2 5.0's mp4v writer), before its user data
FFMPEG_VOL_64x48_25 = bytes.fromhex(
    "000001b001000001b58913000001000000012000c48d8800cd0204061463")


def smooth_frames(w: int, h: int, n: int, seed: int) -> list[np.ndarray]:
    """Gradients of spatial period 40-120 px, amplitude 60, drifting."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    scales = rng.uniform(40, 120, (3, 2))
    return [np.clip(np.stack([128 + 60 * np.sin(x / sx + 0.2 * t + c) * np.cos(y / sy)
                              for c, (sx, sy) in enumerate(scales)], -1), 0, 255)
            .astype(np.uint8) for t in range(n)]


def write(path, frames, fps, size):
    with VideoWriter(str(path), fps, size) as w:
        for f in frames:
            w.write(f)


def read_boxes(data: bytes, start: int = 0, end: int | None = None) -> dict:
    """ISO BMFF boxes -> {type: [(payload offset, payload bytes)]}, the
    containers walked (an ``mp4v`` entry from its child boxes on)."""
    end = len(data) if end is None else end
    out: dict = {}
    while start < end:
        size, kind = struct.unpack(">I4s", data[start:start + 8])
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", data[start + 8:start + 16])[0], 16
        kind = kind.decode()
        body = start + head
        out.setdefault(kind, []).append((body, data[body:start + size]))
        if kind in ("moov", "trak", "mdia", "minf", "dinf", "stbl"):
            for k, v in read_boxes(data, body, start + size).items():
                out.setdefault(k, []).extend(v)
        elif kind == "stsd":
            for k, v in read_boxes(data, body + 8, start + size).items():
                out.setdefault(k, []).extend(v)
        elif kind == "mp4v":
            for k, v in read_boxes(data, body + 78, start + size).items():
                out.setdefault(k, []).extend(v)
        start += size
    return out


def descriptors(data: bytes) -> dict:
    """MPEG-4 systems descriptors (tag -> body), nested ones flattened."""
    out, i = {}, 0
    while i < len(data):
        tag, i, n = data[i], i + 1, 0
        while True:
            b, i = data[i], i + 1
            n = (n << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        body = data[i:i + n]
        out[tag] = body
        if tag == 0x03:
            out.update(descriptors(body[3:]))
        elif tag == 0x04:
            out.update(descriptors(body[13:]))
        i += n
    return out


@pytest.mark.parametrize("fps,size", CASES)
def test_boxes_parse_back(tmp_path, fps, size):
    w, h = size
    frames = smooth_frames(w, h, 5, 0)
    path = tmp_path / "v.mp4"
    write(path, frames, fps, size)
    data = path.read_bytes()
    boxes = read_boxes(data)
    assert data[4:8] == b"ftyp" and boxes["ftyp"][0][1][:4] == b"isom"
    rate = frame_rate(fps)
    assert rate == {25: Fraction(25), 8: Fraction(8), 5.0: Fraction(5),
                    30000 / 1001: Fraction(30000, 1001)}[fps]
    (off, mdat), = boxes["mdat"]
    sizes = list(struct.unpack(">5I", boxes["stsz"][0][1][12:]))
    assert struct.unpack(">II", boxes["stsz"][0][1][4:12]) == (0, 5)
    assert struct.unpack(">II", boxes["stco"][0][1][4:12]) == (1, off)
    assert len(mdat) == sum(sizes)
    assert struct.unpack(">4I", boxes["stts"][0][1][:16]) == (0, 1, 5, rate.denominator)
    assert struct.unpack(">7I", boxes["stss"][0][1]) == (0, 5, 1, 2, 3, 4, 5)
    assert struct.unpack(">5I", boxes["stsc"][0][1]) == (0, 1, 1, 5, 1)
    mdhd = struct.unpack(">IIIII", boxes["mdhd"][0][1][:20])
    assert mdhd[3:] == (rate.numerator, 5 * rate.denominator)
    assert Fraction(mdhd[3], mdhd[4] // 5) == rate  # timescale over the sample delta
    mvhd = struct.unpack(">IIIII", boxes["mvhd"][0][1][:20])
    assert mvhd[3] == 1000 and mvhd[4] == round(5000 * rate.denominator / rate.numerator)
    assert struct.unpack(">II", boxes["tkhd"][0][1][-8:]) == (w << 16, h << 16)
    assert boxes["hdlr"][0][1][8:12] == b"vide"
    entry = boxes["mp4v"][0][1]
    assert struct.unpack(">HH", entry[24:28]) == (w, h)
    desc = descriptors(boxes["esds"][0][1][4:])
    assert desc[0x04][:2] == bytes([0x20, 0x11])  # MPEG-4 Visual, a video stream
    assert desc[0x05] == Mpeg4Encoder(w, h, fps).config and desc[0x06] == b"\x02"
    enc = Mpeg4Encoder(w, h, fps)
    assert mdat == b"".join(enc.encode(f) for f in frames)


def test_headers_are_ffmpegs():
    ours = bytearray(Mpeg4Encoder(64, 48, 25).config)
    ours[19] &= 0x7F  # random_accessible_vol: FFmpeg writes 0
    assert bytes(ours) == FFMPEG_VOL_64x48_25


class _BitReader:
    def __init__(self, data: bytes):
        self.bits = "".join(f"{b:08b}" for b in data)
        self.pos = 0

    def read(self, n: int) -> int:
        v = int(self.bits[self.pos:self.pos + n], 2)
        self.pos += n
        return v

    def code(self, table: dict) -> int:
        for n in range(1, 10):
            key = self.bits[self.pos:self.pos + n]
            if key in table:
                self.pos += n
                return table[key]
        raise AssertionError(f"no code at bit {self.pos}")


MCBPC = {"1": 0, "001": 1, "010": 2, "011": 3}
CBPY = {c: i for i, c in enumerate(["0011", "00101", "00100", "1001", "00011", "0111", "000010",
                                    "1011", "00010", "000011", "0101", "1010", "0100", "1000",
                                    "0110", "11"])}


def parse_vop(vop: bytes, n_mb: int, time_bits: int) -> tuple[dict, np.ndarray]:
    """One of the encoder's I-VOPs -> (header fields, levels [n_mb, 6, 64])."""
    r = _BitReader(vop)
    assert r.read(32) == 0x1B6 and r.read(2) == 0
    seconds = 0
    while r.read(1):
        seconds += 1
    assert r.read(1) == 1
    head = {"seconds": seconds, "time_increment": r.read(time_bits)}
    assert r.read(1) == 1 and r.read(1) == 1  # marker, vop_coded
    head.update(intra_dc_vlc_thr=r.read(3), quant=r.read(5))
    levels = np.zeros((n_mb, 6, 64), np.int64)
    for mb in range(n_mb):
        cbpc = r.code(MCBPC)
        assert r.read(1) == 0  # ac_pred_flag
        cbp = (r.code(CBPY) << 2) | cbpc
        for b in range(6):
            if not cbp >> (5 - b) & 1:
                continue
            i, last = -1, 0
            while not last:
                assert r.read(7) == 3 and r.read(2) == 3  # ESCAPE, type 3
                last, run = r.read(1), r.read(6)
                assert r.read(1) == 1
                level = r.read(12)
                assert r.read(1) == 1
                i += run + 1
                levels[mb, b, i] = level - 4096 if level >= 2048 else level
                assert levels[mb, b, i] != 0
    assert r.read(1) == 0  # next_start_code(): a 0, then 1s to the byte
    assert r.bits[r.pos:] == "1" * ((-r.pos) % 8), "not the stuffing, or bytes after it"
    return head, levels


ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
    44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def reference_planes(rgb: np.ndarray) -> tuple[np.ndarray, ...]:
    """The encoder's step 1 in numpy: BT.601 4:2:0 planes, the frame padded
    to whole macroblocks, the library's double arithmetic in its order."""
    h, w = rgb.shape[:2]
    mb_h, mb_w = -(-h // 16), -(-w // 16)
    x = np.pad(rgb, ((0, 16 * mb_h - h), (0, 16 * mb_w - w), (0, 0)), mode="edge")
    r, g, b = (x[..., i].astype(np.float64) for i in range(3))

    def dot(k):
        return k[0] / 255 * r + k[1] / 255 * g + k[2] / 255 * b

    def byte(p):
        return np.clip(np.rint(p), 0, 255)

    def pool(p):
        return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]) * 0.25 + 128

    return (byte(dot((65.481, 128.553, 24.966)) + 16), byte(pool(dot((-37.797, -74.203, 112.0)))),
            byte(pool(dot((112.0, -93.786, -18.214)))))


def reference_levels(rgb: np.ndarray, quant: int) -> np.ndarray:
    """The encoder's steps 1-3 in numpy (BT.601 4:2:0, the DCT, H.263
    quantisation) -> levels [n_mb, 6, 8, 8]."""
    y, cb, cr = reference_planes(rgb)
    mb_h, mb_w = cb.shape[0] // 8, cb.shape[1] // 8
    luma = y.reshape(mb_h, 2, 8, mb_w, 2, 8).transpose(0, 3, 1, 4, 2, 5).reshape(-1, 4, 8, 8)
    chroma = [c.reshape(mb_h, 8, mb_w, 8).transpose(0, 2, 1, 3).reshape(-1, 1, 8, 8)
              for c in (cb, cr)]
    coefs = DCT @ np.concatenate([luma, *chroma], axis=1) @ DCT.T
    mag = np.abs(coefs)
    levels = np.minimum(np.floor(mag * (1 / (2 * quant))), 2047)
    levels[(levels == 0) & (mag >= 1.5 * quant)] = 1
    levels = np.copysign(levels, coefs)
    scaler = np.array([dc_scalers(quant)[0]] * 4 + [dc_scalers(quant)[1]] * 2)
    levels[:, :, 0, 0] = np.clip(np.floor(coefs[:, :, 0, 0] / scaler + 0.5), 0, 2047 // scaler)
    return levels.astype(np.int64)


def reference_scan(levels: np.ndarray, mb_h: int, mb_w: int, quant: int) -> np.ndarray:
    """Levels -> [n_mb, 6, 64] in zigzag order, each DC replaced by its
    difference from the DC prediction (7.4.3: the left (A) or upper (C)
    neighbour's dequantised DC, C where |A - B| < |B - C|, 1024 outside)."""
    ys, cs = dc_scalers(quant)
    dc = levels[:, :, 0, 0].astype(np.int64)
    grids = [dc[:, :4].reshape(mb_h, mb_w, 2, 2).transpose(0, 2, 1, 3).reshape(2 * mb_h, -1),
             dc[:, 4].reshape(mb_h, mb_w), dc[:, 5].reshape(mb_h, mb_w)]
    preds = []
    for grid, scaler in zip(grids, (ys, cs, cs)):
        p = np.pad(grid * scaler, ((1, 0), (1, 0)), constant_values=1024)
        a, b, c = p[1:, :-1], p[:-1, :-1], p[:-1, 1:]
        preds.append((np.where(np.abs(a - b) < np.abs(b - c), c, a) + scaler // 2) // scaler)
    luma = preds[0].reshape(mb_h, 2, mb_w, 2).transpose(0, 2, 1, 3).reshape(-1, 4)
    pred = np.concatenate([luma, preds[1].reshape(-1, 1), preds[2].reshape(-1, 1)], axis=1)
    out = levels.reshape(levels.shape[0], 6, 64)[:, :, ZIGZAG].astype(np.int64)
    out[:, :, 0] = dc - pred
    return out


@pytest.mark.parametrize("size", [(96, 72), (100, 60)])
def test_levels_match_the_numpy_reference(size):
    """The library's colour conversion (bit-equal: the same double
    arithmetic in the same order), then its DCT and quantisation against
    numpy's (another summation order: a level on a rounding boundary may
    differ by 1)."""
    w, h = size
    enc = Mpeg4Encoder(w, h, 25)
    for f in smooth_frames(w, h, 2, 5) + [_scene(h, w, 4)]:
        for got, want in zip(rgb_to_yuv420(f), reference_planes(f)):
            np.testing.assert_array_equal(got, want)
        got, want = enc.levels(f).astype(np.int64), reference_levels(f, mpeg4.QUANT)
        d = np.abs(got - want)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_vops_parse_back_to_the_levels():
    w, h = 100, 60
    enc = Mpeg4Encoder(w, h, 30000 / 1001)
    frames = smooth_frames(w, h, 3, 1) + [_scene(h, w, 3)]
    for k, f in enumerate(frames):
        want = reference_scan(enc.levels(f), enc.mb_h, enc.mb_w, enc.quant)
        head, levels = parse_vop(enc.encode(f), enc.mb_w * enc.mb_h, enc.time_bits)
        assert head == {"seconds": 0, "time_increment": (k * 1001) % 30000,
                        "intra_dc_vlc_thr": 7, "quant": mpeg4.QUANT}
        np.testing.assert_array_equal(levels, want)


def test_time_stamps_cross_seconds():
    enc = Mpeg4Encoder(16, 16, 5.0)
    stamps = [parse_vop(enc.encode(np.zeros((16, 16, 3), np.uint8)), 1, enc.time_bits)[0]
              for _ in range(7)]
    assert [(s["seconds"], s["time_increment"]) for s in stamps] == [
        (0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (1, 0), (0, 1)]


@pytest.mark.parametrize("size", [(96, 72), (64, 48), (100, 60)])
def test_reconstruction_is_within_bounds(size):
    w, h = size
    enc = Mpeg4Encoder(w, h, 25)
    for f in smooth_frames(w, h, 3, 2):
        d = np.abs(enc.reconstruct(enc.levels(f)).astype(int) - f)
        assert d.max() <= 6 and d.mean() <= 1.5, (d.max(), d.mean())


def test_same_frames_same_bytes(tmp_path):
    frames = smooth_frames(96, 72, 3, 3) + [_scene(72, 96, 0)]
    write(tmp_path / "a.mp4", frames, 25, (96, 72))
    write(tmp_path / "b.mp4", frames, 25, (96, 72))
    assert (tmp_path / "a.mp4").read_bytes() == (tmp_path / "b.mp4").read_bytes()


def test_bad_inputs_raise():
    enc = Mpeg4Encoder(16, 16, 25)
    with pytest.raises(ValueError, match="uint8 \\[16, 16, 3\\]"):
        enc.encode(np.zeros((16, 17, 3), np.uint8))
    with pytest.raises(ValueError, match="13-bit"):
        Mpeg4Encoder(8192, 16, 25)
    assert frame_rate(29.97) == frame_rate(2997 / 100) and frame_rate(29.97).numerator == 2997


@pytest.fixture(scope="module")
def drawn_clip(tmp_path_factory):
    """A shallow YOLOv3 (seeded weights, 4 classes, conf 0.3, its 5 best
    boxes a frame: the random head scores hundreds of boxes over 0.3) on a
    Motion-JPEG AVI of 8 seeded 360 x 480 scenes at 10 fps, written without
    cv2; -> (detector, clip path, the frames' drawn images)."""
    root = tmp_path_factory.mktemp("drawn")
    model = YOLOv3(num_classes=4, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(0))
    det = Detector(model, ANCHORS, device="cpu", dtype=torch.float32, input_size=96,
                   batch_size=3, conf_thres=0.3, max_det=5)
    tables = standard_jpeg_tables(95)
    jpegs = [encode_baseline_jpeg(_scene(360, 480, 10 + t), *tables) for t in range(8)]
    clip = str(root / "clip.avi")
    with open(clip, "wb") as f:
        f.write(mjpeg_avi(jpegs, 480, 360, 10.0))
    drawn = []
    det.predict_video(clip, frame_callback=lambda rgb, res: drawn.append(draw_detections(
        rgb, res["boxes"], res["scores"], res["classes"], det.class_names)))
    return det, clip, drawn


def test_predict_video_writes_without_cv2(drawn_clip, tmp_path, monkeypatch):
    """(Without cv2 the boxes are drawn without their labels.)"""
    det, clip, _ = drawn_clip
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = tmp_path / "annotated.mp4"
    drawn = []
    assert det.predict_video(clip, str(out), frame_callback=lambda rgb, res: drawn.append(
        draw_detections(rgb, res["boxes"], res["scores"], res["classes"]))) == len(drawn) == 8
    data = out.read_bytes()
    boxes = read_boxes(data)
    enc = Mpeg4Encoder(480, 360, 10.0)
    assert boxes["mdat"][0][1] == b"".join(enc.encode(f) for f in drawn)
    assert struct.unpack(">IIII", boxes["stts"][0][1][:16]) == (0, 1, 8, 1)
    assert struct.unpack(">I", boxes["mdhd"][0][1][12:16]) == (10,)


def _decode(path) -> tuple[int, float, list[np.ndarray]]:
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(str(path))
    n, fps = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr[..., ::-1])
    cap.release()
    return n, fps, frames


@pytest.mark.parametrize("fps,size", CASES)
def test_cv2_reads_count_fps_and_frames(tmp_path, fps, size):
    pytest.importorskip("cv2")
    w, h = size
    frames = smooth_frames(w, h, 6, 4)
    write(tmp_path / "v.mp4", frames, fps, size)
    n, got_fps, got = _decode(tmp_path / "v.mp4")
    assert n == len(got) == 6 and got_fps == fps
    d = np.stack([np.abs(g.astype(int) - f) for g, f in zip(got, frames)])
    assert d.max() <= 8 and d.mean() <= 1.5, (d.max(), d.mean())


def test_drawn_frames_against_cv2s_writer(drawn_clip, tmp_path):
    cv2 = pytest.importorskip("cv2")
    det, clip, drawn = drawn_clip
    out = tmp_path / "ours.mp4"
    det.predict_video(clip, str(out))
    theirs = str(tmp_path / "cv2.mp4")
    w = cv2.VideoWriter(theirs, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (480, 360))
    for f in drawn:
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()
    errs = {}
    for name, path in (("ours", out), ("cv2", theirs)):
        n, fps, got = _decode(path)
        assert n == len(got) == len(drawn) and fps == 10.0
        errs[name] = float(np.mean([np.abs(g.astype(int) - f).mean()
                                    for g, f in zip(got, drawn)]))
    print(f"drawn frames, mean |d| against them: ours {errs['ours']:.3f}, "
          f"cv2's mp4v writer {errs['cv2']:.3f}; {os.path.getsize(out) // len(drawn)} "
          "bytes a frame")
    assert errs["ours"] <= 3 and errs["ours"] <= errs["cv2"] + 1
