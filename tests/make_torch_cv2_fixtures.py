"""Writes the cv2-parity fixtures and their manifests (not collected by
pytest: run it by hand, from the repo root):

    JAX_PLATFORMS=cpu python tests/make_torch_cv2_fixtures.py

Images, into ``tests/torch_codec_fixtures/cv2_parity/``: the 32 files of
`testing.cv2_parity_images` (corrupt and truncated JPEG, every BMP kind,
EXIF PNGs, the formats only cv2 decodes), the non-JPEG, non-PNG, non-BMP
ones under their own extensions. ``manifest.json`` holds, per file and per
route, the SHA-256 of what the JAX package's call returns (null where
it raises or returns None): ``memory`` is ``VisionService._decode_bytes``
(cv2.imdecode), ``file`` ``data.dataset.imread_rgb`` (cv2.imread),
``reduced`` ``imread_rgb_scaled(path, REDUCE_TARGET)`` (with its original
size), ``fused`` ``native.decode_jpeg_i420(data, FUSED_SIZE, 114,
FUSED_SIZE)`` ("fallback" where it returns None).

Videos, into ``tests/torch_video_fixtures/cv2/``, through
``make_torch_video_fixtures.write_lib`` (libavformat 59): the files the
port's readers refuse (a fragmented MP4, an MP4 whose edit list cuts its
first frames, one XviD stream under the FourCCs UMP4 and XVIX, an MPEG-4 AVI
whose first chunk is empty) and the three clips of other codecs the card
runs (libx264 High profile with CABAC and B-frames at Kinetics' 340 x 256
and 30 fps, 64 frames; XviD in Matroska; VP9 in WebM). ``manifest.json``
holds cv2's frame count, fps and each frame of its read loop's RGB SHA-256.

It needs cv2 5.x, the system FFmpeg 5.1 libraries (see
make_torch_video_fixtures.py), and the JAX package with its native build.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

IMAGES = os.path.join(HERE, "torch_codec_fixtures", "cv2_parity")
VIDEOS = os.path.join(HERE, "torch_video_fixtures", "cv2")
REDUCE_TARGET = 24  # 72 x 96 files decode at 1/2; the BMP and PNG ones at full size
FUSED_SIZE = 416  # the card's YOLOv3-416 i420 route (fast_decode: reduce_target 416)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def jax_routes(path: str, data: bytes) -> dict:
    """What the JAX package's call on each route gives for one file."""
    from fastvision_tpu import native
    from fastvision_tpu.data import dataset
    from fastvision_tpu.infer.serving import VisionService

    def image(fn):
        try:
            img = fn()
        except Exception:  # noqa: BLE001 - cv2's None, as each call raises it
            return None
        return {"shape": list(img.shape), "sha256": sha(img)}

    out = {"memory": image(lambda: VisionService._decode_bytes(None, data)),
           "file": image(lambda: dataset.imread_rgb(path))}
    try:
        img, orig = dataset.imread_rgb_scaled(path, REDUCE_TARGET)
        out["reduced"] = {"shape": list(img.shape), "sha256": sha(img), "orig": list(orig)}
    except Exception:  # noqa: BLE001
        out["reduced"] = None
    try:
        r = native.decode_jpeg_i420(data, FUSED_SIZE, 114, FUSED_SIZE)
    except ValueError:
        r = None
    else:
        r = "fallback" if r is None else {
            "sha256": sha(r[0]), "scale": r[1], "pads": list(r[2]), "orig": list(r[3]),
            "decoded": list(r[4])}
    out["fused"] = r
    return out


def write_images() -> None:
    from fastvision_tpu import native

    from fastvision_tpu_torch import testing

    native._build_and_load()
    if not native.jpeg_i420_available():
        raise RuntimeError("the JAX package's native JPEG build is unavailable")
    os.makedirs(IMAGES, exist_ok=True)
    entries = []
    for name, kind, data in testing.cv2_parity_images(0):
        path = os.path.join(IMAGES, name)
        with open(path, "wb") as f:
            f.write(data)
        entries.append({"file": name, "kind": kind, "bytes": len(data),
                        "routes": jax_routes(path, data)})
    import cv2

    manifest = {"cv2": cv2.__version__, "reduce_target": REDUCE_TARGET,
                "fused_size": FUSED_SIZE, "files": entries}
    with open(os.path.join(IMAGES, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"{len(entries)} images, {sum(e['bytes'] for e in entries)} bytes")


def insert_empty_chunk(avi: bytes) -> bytes:
    """An AVI with a zero-length ``00dc`` chunk (a dropped frame) before its
    first frame: the RIFF and movi sizes, idx1 (a new first entry, the
    others' offsets moved), ``strh.dwLength`` and ``avih``'s count follow."""
    movi = next(i for i in range(len(avi))
                if avi[i:i + 4] == b"LIST" and avi[i + 8:i + 12] == b"movi")
    at = movi + 12
    out = bytearray(avi[:at] + b"00dc" + struct.pack("<I", 0) + avi[at:])
    for p in (4, movi + 4):
        struct.pack_into("<I", out, p, struct.unpack_from("<I", out, p)[0] + 8)
    idx = out.index(b"idx1", at + 8)
    n = struct.unpack_from("<I", out, idx + 4)[0] // 16
    for e in range(n):
        p = idx + 8 + 16 * e
        struct.pack_into("<I", out, p + 8, struct.unpack_from("<I", out, p + 8)[0] + 8)
    out[idx + 8:idx + 8] = b"00dc" + struct.pack("<III", 0, 4, 0)
    struct.pack_into("<I", out, idx + 4, (n + 1) * 16)
    struct.pack_into("<I", out, 4, struct.unpack_from("<I", out, 4)[0] + 16)
    for fcc, field in ((b"strh", 32), (b"avih", 16)):  # dwLength, dwTotalFrames
        p = out.index(fcc) + 8 + field
        struct.pack_into("<I", out, p, struct.unpack_from("<I", out, p)[0] + 1)
    return bytes(out)


def cut_edit_list(mp4: bytes, frames: int, frame_ticks: int) -> bytes:
    """An MP4 whose (one-entry) edit list starts ``frames`` frames later in
    the media: its first frames are cut from the presentation."""
    out = bytearray(mp4)
    at = out.index(b"elst")
    t = struct.unpack_from(">i", out, at + 16)[0]
    struct.pack_into(">i", out, at + 16, t + frames * frame_ticks)
    return bytes(out)


def videos() -> list[tuple[str, str, callable]]:
    """(file, what, writer) of each video fixture."""
    import make_torch_video_fixtures as mk

    small = mk.scene(24, 176, 144, 41)

    def lib(path, fmt, enc, tag, fps, frames, opts, **kw):
        mk.write_lib(path, fmt, enc, tag, fps, frames, opts, **kw)

    def refused_avi(tag):
        return lambda p: lib(p, "avi", "mpeg4", tag, 25, small, {"g": "12"})

    def first_empty(p):
        with tempfile.TemporaryDirectory() as d:
            lib(os.path.join(d, "x.avi"), "avi", "mpeg4", "XVID", 25, small, {"g": "12"})
            with open(os.path.join(d, "x.avi"), "rb") as f:
                data = insert_empty_chunk(f.read())
        with open(p, "wb") as f:
            f.write(data)

    def edit_list(p):
        with tempfile.TemporaryDirectory() as d:
            lib(os.path.join(d, "x.mp4"), "mp4", "mpeg4", None, 25, small, {"bf": "2", "g": "12"})
            with open(os.path.join(d, "x.mp4"), "rb") as f:
                data = cut_edit_list(f.read(), 3, 512)  # 25 fps at the muxer's 12800 ticks/s
        with open(p, "wb") as f:
            f.write(data)

    return [
        ("refused_fragmented.mp4", "mp4v with B-VOPs, fragmented (frag_keyframe+empty_moov)",
         lambda p: lib(p, "mp4", "mpeg4", None, 25, small, {"bf": "2", "g": "12"},
                       muxer_opts={"movflags": "frag_keyframe+empty_moov"})),
        ("refused_edit_list.mp4", "mp4v with B-VOPs, its edit list cutting the first 3 frames",
         edit_list),
        ("refused_ump4.avi", "an mpeg4 stream under the FourCC UMP4", refused_avi("UMP4")),
        ("refused_xvix.avi", "the same stream under the FourCC XVIX", refused_avi("XVIX")),
        ("refused_first_chunk_empty.avi", "an XVID AVI whose first chunk is empty", first_empty),
        ("x264_kinetics_340x256.mp4", "libx264 High profile, CABAC, 3 B-frames, 30 fps, 64 frames",
         lambda p: lib(p, "mp4", "libx264", None, 30, mk.scene(64, 340, 256, 43),
                       {"profile": "high", "coder": "cabac", "bf": "3", "crf": "30"})),
        ("xvid_160x120.mkv", "libxvid with B-VOPs in Matroska",
         lambda p: lib(p, "matroska", "libxvid", None, 25, mk.scene(24, 160, 120, 44),
                       {"g": "12", "bf": "1"})),
        ("vp9_160x120.webm", "libvpx-vp9 in WebM",
         lambda p: lib(p, "webm", "libvpx-vp9", None, 25, mk.scene(24, 160, 120, 45),
                       {"crf": "40", "b": "0", "deadline": "realtime", "cpu-used": "8"})),
    ]


def write_videos() -> None:
    import cv2

    os.makedirs(VIDEOS, exist_ok=True)
    entries = []
    for name, what, make in videos():
        path = os.path.join(VIDEOS, name)
        make(path)
        cap = cv2.VideoCapture(path)
        count, fps = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), float(cap.get(cv2.CAP_PROP_FPS))
        frames = []
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(sha(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)))
        cap.release()
        h, w = cv2.VideoCapture(path).read()[1].shape[:2]
        entries.append({"file": name, "what": what, "bytes": os.path.getsize(path),
                        "height": h, "width": w, "frame_count": count, "fps": fps,
                        "rgb_sha256": frames})
        print(f"{name}: {os.path.getsize(path)} bytes, {len(frames)} frames, count {count}")
    with open(os.path.join(VIDEOS, "manifest.json"), "w") as f:
        json.dump({"cv2": cv2.__version__, "videos": entries}, f, indent=1)


if __name__ == "__main__":
    write_images()
    write_videos()
